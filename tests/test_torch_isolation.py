"""d3fields_tpu_torch stands alone: it imports neither JAX nor d3fields_tpu,
nor transformers, OpenCV, matplotlib or PIL.

Importing any d3fields_tpu module runs d3fields_tpu/__init__.py, which
imports JAX, so the port keeps its own copies of what it needs. Only the
parity tests import both packages, and they alone build the huggingface
oracles. OpenCV, matplotlib and PIL, which the JAX package uses for
erosion, colour maps and image resizing, are not the port's to need
either: it carries its own numpy and torch versions of what it uses.
"""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "d3fields_tpu_torch")
BANNED_ROOTS = {"jax", "jaxlib", "flax", "optax", "transformers", "cv2", "matplotlib", "PIL"}


def _is_reference(module: str) -> bool:
    # exactly d3fields_tpu or below it; d3fields_tpu_torch is the port itself
    return module == "d3fields_tpu" or module.startswith("d3fields_tpu.")


def _port_files():
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py", "kernel_ab.py",
                                             "bf16_fault_readings.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    code = (
        "import pkgutil, sys, importlib\n"
        "import d3fields_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'd3fields_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r\n"
        "             or m == 'd3fields_tpu' or m.startswith('d3fields_tpu.'))\n"
        "print(len(mods), bad)\n" % (BANNED_ROOTS,)
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    n, bad = r.stdout.strip().split(" ", 1)
    assert int(n) >= 78, r.stdout
    assert bad == "[]", bad


def test_no_port_source_imports_jax_or_the_reference():
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                if m.split(".")[0] in BANNED_ROOTS or _is_reference(m):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {m}")
    assert len(_port_files()) > 10
    assert not offenders, offenders


def test_training_and_image_modules_are_among_the_checked():
    """XMem training, its data pipeline, the JPEG decoder, the OpenCV
    equivalents and the interactive tools are discovered by the checks
    above (they walk the package)."""
    files = {os.path.relpath(p, PORT) for p in _port_files()}
    for rel in ("models/xmem/trainer.py", "models/xmem/data.py", "apps/train_xmem.py",
                "utils/jpeg.py", "utils/imgwarp.py", "utils/png.py",
                "interact/__init__.py", "interact/overlays.py", "interact/session.py",
                "models/fbrs/__init__.py", "models/fbrs/hrnet.py", "models/fbrs/model.py",
                "models/fbrs/predictor.py", "models/s2m/__init__.py", "models/s2m/model.py",
                "models/s2m/controller.py", "apps/interactive.py", "apps/click_track.py"):
        assert rel in files, rel
    for src in ("jpeg.cpp", "imgwarp.cpp", "png.cpp"):
        assert os.path.exists(os.path.join(PORT, "native", src)), src


def test_parallel_modules_are_among_the_checked():
    """The multi-device modules are discovered by the checks above."""
    files = {os.path.relpath(p, PORT) for p in _port_files()}
    for rel in ("parallel/__init__.py", "parallel/mesh.py", "parallel/ops.py",
                "parallel/sharded.py"):
        assert rel in files, rel
