"""``correct`` separates: a sound run passes, the control (the reference one
precision step down, in the program's place) fails, and so does a run with
the timed path broken underneath, once for each fault a cell can have. At a
tiny size on the CPU; the readings at the cells' own sizes on the card,
from ``port_bench/calibrate.py``, are in PERF.md."""

import time

import pytest
import torch
from conftest import tiny_spec

from port_bench import calibrate, harness
from port_bench.reference.precision import CONTROL

CPU = torch.device("cpu")
CELLS = ["vitl14-f32.query-1m", "vitl14-bf16.query-1m"]


def run(workload: str, seed: int = 21) -> dict:
    return harness.run_cell(tiny_spec(workload), seed, 1.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, counted_kernel):
    res = run(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    spec = tiny_spec(workload)
    readings = calibrate.query_control(spec, 22, CONTROL[spec.config["compute_dtype"]], CPU)
    failed = [k for k, lim in spec.limits.items() if k in readings and readings[k] > lim]
    assert failed, readings


def _stale_update(monkeypatch):
    """Fusion.update keeps the first observation's state."""
    from d3fields_tpu_torch.fields.fusion import Fusion

    update = Fusion.update
    monkeypatch.setattr(Fusion, "update",
                        lambda self, obs: update(self, obs) if self.state is None else self.state)


def _half_the_views(monkeypatch):
    """Every view after the first half counts as behind the camera: the
    fusion's means are taken over the rest."""
    from d3fields_tpu_torch.fields import geometry

    project = geometry.project_points

    def half(pts, pose, K, **kw):
        xy, front, depth = project(pts, pose, K, **kw)
        front = front.clone()
        front[pose.shape[0] // 2:] = False
        return xy, front, depth

    monkeypatch.setattr(geometry, "project_points", half)


def _altered_query_answers(monkeypatch):
    """Every 97th row of each tile's interpolated descriptors is off by one."""
    from d3fields_tpu_torch.fields import kernels

    inner = kernels.fused_weighted_interp

    def altered(*args, **kw):
        out = inner(*args, **kw)
        out[::97] += 1.0
        return out

    altered.launches = altered.launches_bf16 = 1 << 30
    monkeypatch.setattr(kernels, "fused_weighted_interp", altered)


QUERY_FAULTS = {"stale_state": _stale_update, "half_the_views": _half_the_views,
                "altered_answers": _altered_query_answers}


@pytest.mark.parametrize("fault", sorted(QUERY_FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_query_is_not_correct(workload, fault, counted_kernel, monkeypatch):
    QUERY_FAULTS[fault](monkeypatch)
    res = run(workload)
    assert not res["correct"], res["checks"]
