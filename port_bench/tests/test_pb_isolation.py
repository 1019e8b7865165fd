"""The harness loads nothing of JAX, Flax or the JAX package, and the
reference nothing of the program; a run refuses to go on without CUDA or
without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from port_bench import harness

PB = harness.HERE
PORT = "d3fields_tpu_torch"


def imported_top_names(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def sources(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        bad = set(imported_top_names(path)) & set(harness.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = set(imported_top_names(path))
        assert PORT not in names and not names & set(harness.FORBIDDEN), path
        assert PORT not in open(path).read().replace(f"``{PORT}``", ""), path


def test_a_tiny_run_loads_no_forbidden_module():
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import tiny_spec\n"
        "from port_bench import harness\n"
        "spec = tiny_spec('vitl14-f32.query-1m')\n"
        "res = harness.run_cell(spec, 5, 0.2, False, 'cpu', time.perf_counter())\n"
        "print(harness.forbidden_loaded(), 'jax' in sys.modules)\n"
        % (harness.ROOT, os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] False"


def _load_fake_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))


@pytest.mark.parametrize("where", ["check", "reader"])
def test_a_module_of_jax_loaded_after_the_window_leaves_no_result(where, monkeypatch, capsys):
    """The reference's check and the metric readers run after the window; a
    JAX module that either loads still keeps the run from printing."""
    from conftest import tiny_spec

    from port_bench.drivers import query

    if where == "check":
        check = query.Cell.check

        def loading_check(self):
            _load_fake_jax(monkeypatch)
            return check(self)

        monkeypatch.setattr(query.Cell, "check", loading_check)
    else:
        reader = harness.reader

        def loading_reader(metric):
            _load_fake_jax(monkeypatch)
            return reader(metric)

        monkeypatch.setattr(harness, "reader", loading_reader)
    res = harness.run_cell(tiny_spec("vitl14-f32.query-1m"), 6, 0.2, False, "cpu",
                           time.perf_counter())
    assert res is None
    assert "['jax']" in capsys.readouterr().err


def test_forbidden_names_are_compared_whole():
    sys.modules["d3fields_tpu_pretend"] = sys.modules[__name__]
    try:
        assert "d3fields_tpu_pretend" not in harness.forbidden_loaded()
    finally:
        del sys.modules["d3fields_tpu_pretend"]


def test_run_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "vitl14-f32.query-1m", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    """A checkout of only BENCHMARK.json and port_bench/ prints no result."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PB, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "sys.path = [p for p in sys.path if p != %r]\n"
            "from port_bench import harness\n"
            "res = harness.run_cell(harness.Spec('vitl14-f32.query-1m'), 1, 1, False, 'cpu', 0.0)\n"
            "print(__import__('json').dumps(res))\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and "No module named 'd3fields_tpu_torch'" in out.stderr
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "vitl14-f32.query-1m", "--seed", "3", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
