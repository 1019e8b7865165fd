"""The port's two headline apps end to end on the CPU, held to the JAX
package's committed goldens at tests/test_golden.py's tolerances:
``vis_repr --synthetic --step 0.015`` against tests/golden/vis_repr.npz and
``vis_tracking --synthetic --frames 2 --num_kypts 8 --iters 10`` against
tests/golden/vis_tracking_fast.npz.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from tools.gen_golden import VIS_REPR_ARGS, VIS_TRACKING_FAST_ARGS
from d3fields_tpu_torch.apps import vis_repr, vis_tracking

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The apps run ~10^6 small torch ops (vis_tracking's keypoint grid
    has 36M points). Where pytest-xdist runs several workers on the same
    cores, each worker's default thread pool spends that time waiting on
    the others; one thread per worker keeps the run short."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vis_repr_reproduces_golden(tmp_path):
    dump = str(tmp_path / "arrays.npz")
    out = tmp_path / "out"
    assert vis_repr.main(VIS_REPR_ARGS + ["--out", str(out), "--dump_arrays", dump],
                         device="cpu") == 0
    got = np.load(dump)
    want = np.load(os.path.join(GOLDEN, "vis_repr.npz"))
    np.testing.assert_allclose(got["dist"], want["dist"], atol=1e-4)
    assert got["triangles"].shape == want["triangles"].shape
    np.testing.assert_array_equal(got["triangles"], want["triangles"])
    np.testing.assert_allclose(got["vertices"], want["vertices"], atol=1e-3)
    np.testing.assert_allclose(got["mask"], want["mask"], atol=1e-4)
    np.testing.assert_allclose(got["color"], want["color"], atol=1e-3)
    np.testing.assert_allclose(got["desc_pca"], want["desc_pca"], atol=1e-3)
    for name in ("instance_mesh.ply", "descriptor_mesh.ply", "color_mesh.ply"):
        assert (out / name).read_bytes()[:3] == b"ply"


def _tracking_outputs(out, frames):
    match, losses = [], []
    for t in range(frames):
        with open(os.path.join(out, f"match_pts_{t:06d}.pkl"), "rb") as f:
            match.append(np.stack(pickle.load(f)).astype(np.float32))
        with open(os.path.join(out, f"loss_hist_{t:06d}.pkl"), "rb") as f:
            losses.append(np.asarray(pickle.load(f), np.float32))
    with open(os.path.join(out, "src_feats.pkl"), "rb") as f:
        info = pickle.load(f)
    src_pts = np.stack([info[k]["src_pts"] for k in sorted(info)]).astype(np.float32)
    return np.stack(match), src_pts, np.stack(losses)


def test_vis_tracking_reproduces_fast_golden(tmp_path):
    """With two frames of host-visible lag (--pipeline_depth 2), which
    changes when the pickles are written and nothing else."""
    out = str(tmp_path / "track")
    assert vis_tracking.main(VIS_TRACKING_FAST_ARGS + ["--out", out, "--pipeline_depth", "2"],
                             device="cpu") == 0
    match, src_pts, losses = _tracking_outputs(out, 2)
    want = np.load(os.path.join(GOLDEN, "vis_tracking_fast.npz"))
    np.testing.assert_allclose(src_pts, want["src_pts"], atol=1e-6)
    np.testing.assert_allclose(match, want["match_pts"], atol=5e-4)
    np.testing.assert_allclose(losses, want["loss_history"], atol=1e-5)


@pytest.mark.parametrize("app, argv, message", [
    (vis_repr, ["--scene", "mug"], "only --synthetic"),
    (vis_tracking, ["--data_path", "x"], "only --synthetic"),
    # the JAX app's reasons (d3fields_tpu/apps/vis_tracking.py:143-152)
    (vis_tracking, ["--synthetic", "--fused"], "--fused requires the XMem video tracker"),
    (vis_tracking, ["--synthetic", "--fused", "--segment", "4"],
     "--fused requires the XMem video tracker"),
    (vis_tracking, ["--synthetic", "--segment", "4"], "add --fused"),
])
def test_unported_paths_exit_with_a_message(app, argv, message):
    with pytest.raises(SystemExit, match=message):
        app.main(argv, device="cpu")


def test_apps_run_on_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vis_repr.main(VIS_REPR_ARGS + ["--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vis_tracking.main(VIS_TRACKING_FAST_ARGS + ["--out", str(tmp_path)])
