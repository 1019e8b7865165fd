"""Port parity: the auxiliary modules of d3fields_tpu_torch (profiling,
seeding, metrics, correspondence and image ops, the XMem video layouts, the
uint8 resize) against d3fields_tpu and OpenCV.

Tolerances are those of the JAX package's own tests of each function
(``tests/test_aux.py``): correspondence rtol 1e-4 / atol 1e-6, distance
maps 1e-5, normals 1e-5, DAVIS J&F 1e-12; the disk dilation and the resize
equal OpenCV's exactly, the video layouts the JAX lists.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from d3fields_tpu.models.xmem import data as jdata
from d3fields_tpu.ops import corr as jcorr
from d3fields_tpu.ops import image as jimage
from d3fields_tpu.utils import metrics as jmetrics
from d3fields_tpu_torch.models.resize import linear_resize_u8
from d3fields_tpu_torch.models.xmem import data as tdata
from d3fields_tpu_torch.ops import corr as tcorr
from d3fields_tpu_torch.ops import image as timage
from d3fields_tpu_torch.utils import metrics as tmetrics
from d3fields_tpu_torch.utils import profiling


def test_stage_timer_and_throughput():
    """tests/test_aux.py:16-30's assertions on Throughput; the JAX
    package's StageTimer has no counterpart here (the port's spans are
    ``profiling.tracer``'s, tests/test_torch_tracing.py)."""
    x = torch.arange(1024.0)
    tp = profiling.Throughput()
    tp.start()
    tp.stop(units=1024, result_tree=x + 1)
    assert tp.per_second > 0 and tp.total_units == 1024
    profiling.sync({"a": (x, [x]), "b": 3})


def test_metrics_and_jsonl(tmp_path):
    """tests/test_aux.py:33-60's assertions."""
    m = tmetrics.AverageMeter()
    m.update(1.0)
    m.update(3.0)
    assert m.avg == 2.0
    path = str(tmp_path / "log.jsonl")
    logger = tmetrics.JsonlLogger(path, "test")
    integ = tmetrics.Integrator(logger)
    integ.add_dict({"loss": 2.0})
    integ.add_dict({"loss": 4.0})
    assert integ.finalize("train", 10)["loss"] == 3.0
    logger.close()
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[0]["event"] == "start" and lines[0]["run"] == "test"
    assert lines[1]["loss"] == 3.0 and lines[1]["prefix"] == "train" and lines[1]["it"] == 10
    tee_path = str(tmp_path / "tee.txt")
    with tmetrics.Tee(tee_path):
        print("hello-tee")
    assert "hello-tee" in open(tee_path).read()


def test_set_seed_seeds_python_numpy_and_torch():
    import random

    from d3fields_tpu_torch.utils.seeding import set_seed

    draws = []
    for _ in range(2):
        set_seed(7)
        draws.append((random.random(), np.random.rand(), torch.rand(1).item()))
    assert draws[0] == draws[1]


def test_correspondence_matches_jax():
    """tests/test_aux.py:63-79's inputs, tiles of 64 (a ragged last one)."""
    rs = np.random.RandomState(0)
    src = rs.randn(7, 16).astype(np.float32)
    tgt = rs.randn(333, 16).astype(np.float32)
    pts = rs.randn(333, 3).astype(np.float32)
    got = tcorr.similarity_softmax(torch.from_numpy(src), torch.from_numpy(tgt), 0.5, tile=64)
    want = jcorr.similarity_softmax(jnp.asarray(src), jnp.asarray(tgt), scale=0.5, tile=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    d = np.linalg.norm(src[:, None] - tgt[None], axis=-1)
    e = np.exp(-0.5 * d - (-0.5 * d).max(axis=1, keepdims=True))
    np.testing.assert_allclose(got.numpy(), e / e.sum(axis=1, keepdims=True), rtol=1e-4, atol=1e-6)
    match, dist = tcorr.best_matches(*(torch.from_numpy(a) for a in (src, tgt, pts)), tile=64)
    jmatch, jdist = jcorr.best_matches(*(jnp.asarray(a) for a in (src, tgt, pts)), tile=64)
    np.testing.assert_array_equal(match.numpy(), np.asarray(jmatch))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-5)
    np.testing.assert_allclose(match.numpy(), pts[d.argmin(axis=1)], rtol=1e-5)


def test_image_ops_match_jax():
    """seed_distance_maps and depth_to_normal at tests/test_aux.py:82-103's
    inputs, and the normals of a tilted plane and a random surface."""
    seeds = np.array([[2.0, 3.0], [10.0, 12.0], [0.0, 0.0]], np.float32)
    valid = np.array([True, True, False])
    got = timage.seed_distance_maps(torch.from_numpy(seeds), torch.from_numpy(valid), (16, 20))
    want = jimage.seed_distance_maps(jnp.asarray(seeds), jnp.asarray(valid), (16, 20))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert got[2, 3] == 0.0
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], np.float32)
    ys, xs = np.mgrid[:48, :64]
    rs = np.random.RandomState(0)
    for depth in (np.full((48, 64), 2.0, np.float32),
                  (1.5 + 0.01 * xs + 0.004 * ys).astype(np.float32),
                  (2.0 + 0.05 * rs.rand(48, 64)).astype(np.float32)):
        n = timage.depth_to_normal(torch.from_numpy(depth), torch.from_numpy(K))
        np.testing.assert_allclose(n.numpy(), np.asarray(jimage.depth_to_normal(
            jnp.asarray(depth), jnp.asarray(K))), rtol=1e-5, atol=1e-5)
    n = timage.depth_to_normal(torch.full((48, 64), 2.0), torch.from_numpy(K))
    np.testing.assert_allclose(n[5:-5, 5:-5, 2].numpy(), -1.0, atol=1e-5)


def _blobs(rs, H, W):
    m = np.zeros((H, W), np.uint8)
    for label in (1, 2):
        for _ in range(rs.randint(1, 3)):
            cy, cx, r = rs.randint(H), rs.randint(W), rs.randint(4, 14)
            yy, xx = np.mgrid[:H, :W]
            m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = label
    return m


def test_davis_jf_matches_jax():
    """tests/test_aux.py:213-308's cases (shifted, missing, restricted
    objects) and random blobby masks, at 1e-12."""
    gt = np.zeros((64, 64), np.uint8)
    gt[10:30, 10:30] = 1
    gt[40:55, 40:60] = 2
    shifted = np.zeros_like(gt)
    shifted[11:31, 10:30] = 1
    shifted[40:55, 40:60] = 2
    missing = np.zeros_like(gt)
    missing[10:30, 10:30] = 1
    cases = [(gt, gt, {}), (shifted, gt, {}), (missing, gt, {}), (missing, gt, {"objects": [1]}),
             (missing, np.zeros_like(gt), {"num_objects": 2}), (gt, gt, {"objects": []})]
    rs = np.random.RandomState(7)
    for _ in range(6):
        H, W = rs.randint(40, 90), rs.randint(40, 90)
        cases.append((_blobs(rs, H, W), _blobs(rs, H, W), {"num_objects": 2}))
    for k, (pred, g, kw) in enumerate(cases):
        got, want = tmetrics.davis_jf(pred, g, **kw), jmetrics.davis_jf(pred, g, **kw)
        for key in ("J", "F", "JF"):
            assert got[key] == pytest.approx(want[key], abs=1e-12), (k, key)
    m = tmetrics.davis_jf(missing, gt)
    assert m["J"] == pytest.approx(0.5, abs=0.01) and m["F"] == pytest.approx(0.5, abs=0.01)


@pytest.mark.parametrize("rad", [1, 2, 5, 8])
def test_disk_dilation_equals_cv2(rad):
    rs = np.random.RandomState(rad)
    yy, xx = np.mgrid[-rad:rad + 1, -rad:rad + 1]
    kernel = ((yy * yy + xx * xx) <= rad * rad).astype(np.uint8)
    for _ in range(4):
        m = rs.rand(37, 51) < 0.03
        m[0, 5] = m[-1, -1] = m[20, 0] = True
        np.testing.assert_array_equal(tmetrics.dilate_disk(m, rad),
                                      cv2.dilate(m.astype(np.uint8), kernel) > 0)


def test_video_layouts_and_splits_match_jax(tmp_path):
    """resolve_video_dirs on the generic, DAVIS and YouTube-VOS layouts and
    load_split's two formats (tests/test_apps.py:371-403, 509-545)."""
    gen = tmp_path / "generic"
    (gen / "vidA" / "frames").mkdir(parents=True)
    (gen / "vidA" / "masks").mkdir()
    (gen / "notavideo").mkdir()
    davis = tmp_path / "DAVIS"
    for vid in ("bear", "dogs", "soapbox"):
        (davis / "JPEGImages" / "480p" / vid).mkdir(parents=True)
        (davis / "Annotations" / "480p" / vid).mkdir(parents=True)
    (davis / "ImageSets" / "2017").mkdir(parents=True)
    (davis / "ImageSets" / "2017" / "train.txt").write_text("bear\ndogs\n")
    (davis / "ImageSets" / "2017" / "val.txt").write_text("soapbox\n")
    yt = tmp_path / "ytvos"
    (yt / "JPEGImages" / "0a2f2bd294").mkdir(parents=True)
    (yt / "Annotations" / "0a2f2bd294").mkdir(parents=True)
    open(yt / "JPEGImages" / "0a2f2bd294" / "00000.png", "wb").close()
    d16 = tmp_path / "D16" / "ImageSets" / "480p"
    d16.mkdir(parents=True)
    (d16 / "train.txt").write_text(
        "/JPEGImages/480p/bear/00000.jpg /Annotations/480p/bear/00000.png\n\n"
        "/JPEGImages/480p/dogs/00000.jpg /Annotations/480p/dogs/00000.png\n")
    for root, subset in ((gen, None), (davis, None), (davis, "train"), (davis, "val"), (yt, None)):
        got = list(tdata.resolve_video_dirs(str(root), subset=subset))
        assert got == list(jdata.resolve_video_dirs(str(root), subset=subset)) and got
    assert [v for v, _, _ in tdata.resolve_video_dirs(str(davis), "train")] == ["bear", "dogs"]
    for root, subset in ((davis, "train"), (tmp_path / "D16", "train"), (davis, "testdev")):
        assert tdata.load_split(str(root), subset) == jdata.load_split(str(root), subset)
    with pytest.warns(UserWarning, match="using ALL videos"):
        got = [v for v, _, _ in tdata.resolve_video_dirs(str(davis), subset="testdev")]
    assert got == ["bear", "dogs", "soapbox"]
    assert tdata.IMAGE_EXTS == jdata.IMAGE_EXTS


@pytest.mark.parametrize("src,dst", [((60, 80), (1050, 1050)), ((37, 53), (80, 70)),
                                     ((120, 160), (60, 80)), ((41, 43), (19, 29)),
                                     ((7, 5), (3, 9))])
def test_linear_resize_u8_equals_cv2(src, dst):
    """precompute_pca's resize: cv2.resize's default INTER_LINEAR on uint8,
    exactly, up and down, colour and grey."""
    rs = np.random.RandomState(src[0])
    img = rs.randint(0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(linear_resize_u8(img, dst), cv2.resize(img, dst[::-1]))
    np.testing.assert_array_equal(linear_resize_u8(img[..., 0], dst),
                                  cv2.resize(img[..., 0], dst[::-1]))
