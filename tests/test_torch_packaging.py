"""Distribution of d3fields_tpu_torch: the native-source lookup, the
library directories, and the wheel's contents and console scripts.

Mirrors tests/test_packaging.py for the port. An installed port finds the
repository root's C++ sources (isosurface, point cloud) in its own
``_native_src/`` (setup.py's build hook copies them there) and writes the
libraries it compiles to a per-user cache when it is not a writable
checkout.
"""

import ctypes
import os
import subprocess
import sys
import types
import zipfile

import pytest

from d3fields_tpu_torch import _build, native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = ("d3f-torch-vis-repr", "d3f-torch-vis-tracking", "d3f-torch-precompute-pca",
                "d3f-torch-train-xmem", "d3f-torch-eval-xmem", "d3f-torch-merge-scores",
                "d3f-torch-click-track", "d3f-torch-interactive")


def test_find_source_checkout_layout():
    p = native_build.find_source("isosurface")
    assert p == os.path.join(REPO, "native", "isosurface.cpp")
    assert native_build.find_source("png", native_build.PORT_NATIVE_DIR).endswith(
        os.path.join("d3fields_tpu_torch", "native", "png.cpp"))
    with pytest.raises(FileNotFoundError, match="nope.cpp"):
        native_build.find_source("nope")


def test_find_source_falls_back_to_the_packaged_copy(tmp_path, monkeypatch):
    """Without the checkout's native/ (an installed wheel), the root's
    sources come from the package's _native_src/; a port-native source is
    looked up in its own directory only."""
    packaged = tmp_path / "_native_src"
    packaged.mkdir()
    (packaged / "isosurface.cpp").write_text("// packaged\n")
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(tmp_path / "absent"))
    monkeypatch.setattr(native_build, "PKG_SRC_DIR", str(packaged))
    assert native_build.find_source("isosurface") == str(packaged / "isosurface.cpp")
    with pytest.raises(FileNotFoundError):
        native_build.find_source("isosurface", str(tmp_path / "absent"))


def test_lib_dir_checkout_stays_under_build():
    assert native_build.lib_dir("native") == os.path.join(REPO, "build", "native")
    assert os.path.dirname(native_build.lib_path("png", native_build.PORT_NATIVE_DIR)) == \
        os.path.join(REPO, "build", "native")
    assert os.path.dirname(_build.lib_path("fused_interp")) == os.path.join(
        REPO, "build", "torch_kernels")


def test_lib_dir_installed_or_read_only_falls_back_to_the_cache(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv("D3F_NATIVE_CACHE", str(cache))
    site = tmp_path / "site"  # an install: no native/ beside the package
    site.mkdir()
    assert native_build.lib_dir("native", str(site)) == str(cache / "native")
    assert native_build.lib_dir("torch_kernels", str(site)) == str(cache / "torch_kernels")
    checkout = tmp_path / "checkout"
    (checkout / "native").mkdir(parents=True)
    assert native_build.lib_dir("native", str(checkout)) == str(checkout / "build" / "native")
    # a checkout this user may not write (os.access, since root may write anything)
    real_access = os.access
    monkeypatch.setattr(native_build.os, "access",
                        lambda p, mode: False if p == str(checkout) else real_access(p, mode))
    assert native_build.lib_dir("native", str(checkout)) == str(cache / "native")
    monkeypatch.delenv("D3F_NATIVE_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert native_build.lib_dir("native", str(site)) == str(
        tmp_path / "home" / ".cache" / "d3fields_tpu_torch" / "native")


def test_load_native_builds_a_packaged_source_into_the_cache(tmp_path, monkeypatch):
    """An installed layout end to end: the source comes from _native_src/,
    the library is compiled into $D3F_NATIVE_CACHE and loaded."""
    packaged = tmp_path / "pkg" / "_native_src"
    packaged.mkdir(parents=True)
    (packaged / "d3f_probe.cpp").write_text(
        'extern "C" int d3f_probe(int x) { return 3 * x + 1; }\n')
    monkeypatch.setattr(native_build, "_REPO_ROOT", str(tmp_path / "site"))
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(tmp_path / "site" / "native"))
    monkeypatch.setattr(native_build, "PKG_SRC_DIR", str(packaged))
    monkeypatch.setenv("D3F_NATIVE_CACHE", str(tmp_path / "cache"))

    def declare(lib):
        lib.d3f_probe.argtypes = [ctypes.c_int]
        lib.d3f_probe.restype = ctypes.c_int

    lib = native_build.load_native("d3f_probe", declare)
    assert lib.d3f_probe(4) == 13
    built = os.listdir(tmp_path / "cache" / "native")
    assert len(built) == 1 and built[0].startswith("libd3f_probe-") and built[0].endswith(".so")
    assert not (tmp_path / "site").exists()


@pytest.mark.parametrize("suffix", [".cu", ".cpp"])
def test_repeated_loads_declare_a_library_once(suffix, monkeypatch):
    """A CUDA kernel's and a host source's library alike: the first load
    builds it (stubbed here) and applies its declare; later loads return
    the same handle and declare nothing again."""
    built, declared = [], []
    monkeypatch.setattr(native_build, "_libs", {})
    monkeypatch.setattr(native_build, "build", lambda srcs, flags: built.append(tuple(srcs)))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: types.SimpleNamespace(path=path))
    if suffix == ".cu":
        libs = [_build.load("sam_attention", declared.append) for _ in range(3)]
        want = _build.lib_path("sam_attention")
    else:
        libs = [native_build.load_native("png", declared.append, native_build.PORT_NATIVE_DIR)
                for _ in range(3)]
        want = native_build.lib_path("png", native_build.PORT_NATIVE_DIR)
    assert len(built) == 1 and declared == [libs[0]]
    assert all(lib is libs[0] for lib in libs) and libs[0].path == want


@pytest.mark.slow
def test_installed_wheel_builds_the_port_native_libraries(tmp_path):
    """A wheel of the checkout, installed with ``pip install --no-deps
    --target`` and imported from outside the checkout: the port finds the
    root's sources in its _native_src/, builds isosurface and pointcloud
    into the cache, and the wheel declares the port's console scripts.
    The JAX package's entries stay as tests/test_packaging.py pins them."""
    wheels, site = tmp_path / "wheels", tmp_path / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--wheel-dir", str(wheels), REPO], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    (whl,) = [f for f in os.listdir(wheels) if f.endswith(".whl")]
    with zipfile.ZipFile(wheels / whl) as z:
        names = z.namelist()
        eps = z.read(next(n for n in names if n.endswith("entry_points.txt"))).decode()
    for src in ("isosurface.cpp", "pointcloud.cpp"):
        assert f"d3fields_tpu_torch/_native_src/{src}" in names
        assert f"d3fields_tpu/_native_src/{src}" in names
    assert "d3fields_tpu_torch/csrc/fused_interp.cu" in names
    assert "d3fields_tpu_torch/native/png.cpp" in names
    assert not any(n.endswith(".so") for n in names)
    for script in PORT_SCRIPTS + ("d3f-vis-repr", "d3f-interactive"):
        assert script in eps, eps
    r = subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps", "--no-index",
                        "--target", str(site), str(wheels / whl)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    code = (
        "import os, numpy as np\n"
        "import d3fields_tpu_torch.native_build as nb\n"
        "from d3fields_tpu_torch.mesh import _native\n"
        "from d3fields_tpu_torch.ops import pointcloud_native as pc\n"
        "assert nb.__file__.startswith(os.environ['SITE']), nb.__file__\n"
        "g = np.linspace(-1, 1, 12, dtype=np.float32)\n"
        "vol = np.sqrt((g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None] ** 2)) - 0.6\n"
        "v, t = _native.marching_tetrahedra(vol)\n"
        "assert len(v) > 0 and len(t) > 0\n"
        "pc._load()\n"
        "print(sorted(os.listdir(os.path.join(os.environ['D3F_NATIVE_CACHE'], 'native'))))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(site), "SITE": str(site),
           "D3F_NATIVE_CACHE": str(tmp_path / "cache")}
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "libisosurface-" in r.stdout and "libpointcloud-" in r.stdout, r.stdout
    assert not os.path.exists(site / "build")
