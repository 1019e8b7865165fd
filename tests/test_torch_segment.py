"""Port parity for the whole segmentation slice: ``GroundedSAMBackend``
(tiny GroundingDINO + tiny SAM) of d3fields_tpu_torch against d3fields_tpu.

Both backends get the same huggingface-layout weights and a 2-view 72×96
rig. The tiny random SAM emits ~1e-5-sized mask logits, so the SAM state
dict's hypernetwork output layers are scaled by 1e4 (for both packages):
the logits become O(0.1) and the knife edge below is meaningful. Labels
equal, confidences at rtol 1e-4 / atol 1e-4 (the detector's tolerance,
tests/test_torch_groundingdino.py), masks equal except where the JAX mask
logit lies within 1e-4 of 0.
"""

import zlib

import numpy as np
import pytest

import jax.numpy as jnp

from d3fields_tpu.models.groundingdino import model as jgd
from d3fields_tpu.models.groundingdino.detector import GroundingDinoDetector as JDetector
from d3fields_tpu.models.sam import model as jsam
from d3fields_tpu.models.sam import predictor as jpred
from d3fields_tpu.seg.grounded_sam import GroundedSAMBackend as JBackend
from d3fields_tpu_torch.models.groundingdino import model as tgd
from d3fields_tpu_torch.models.groundingdino.detector import GroundingDinoDetector as TDetector
from d3fields_tpu_torch.models.sam import model as tsam
from d3fields_tpu_torch.models.sam.predictor import SamPredictor as TPredictor
from d3fields_tpu_torch.seg.backends import PrecomputedMaskBackend, with_background
from d3fields_tpu_torch.seg.grounded_sam import GroundedSAMBackend as TBackend

QUERIES = ["mug", "red can"]
KNIFE_EDGE = 1e-4


def toy_tokenizer(text):
    return [200 + zlib.crc32(w.encode()) % 1000 for w in text.split()]


@pytest.fixture(scope="module")
def backends():
    gcfg = jgd.GroundingDinoConfig.tiny_test()
    gsd = jgd.build_random_hf(gcfg, seed=0).state_dict()
    scfg = jsam.SamConfig.tiny_test()
    ssd = {k: v.detach().clone() for k, v in jsam.build_random_hf(scfg, seed=0).state_dict().items()}
    for k in ssd:
        if "output_hypernetworks_mlps" in k and ".proj_out." in k:
            ssd[k] *= 1e4
    jg = jgd.convert_hf_state_dict({k: v.numpy() for k, v in gsd.items()}, gcfg)
    js = jsam.convert_hf_state_dict({k: v.numpy() for k, v in ssd.items()}, scfg)
    kw = dict(tokenize=toy_tokenizer, short_side=64, max_side=96)
    jax_backend = JBackend(JDetector(jg, gcfg, **kw), jpred.SamPredictor(js, scfg))
    gd = tgd.GroundingDino(tgd.GroundingDinoConfig.tiny_test(), device="cpu")
    gd.load_state_dict(gsd, strict=True)
    sam = tsam.Sam(tsam.SamConfig.tiny_test(), device="cpu")
    sam.load_state_dict(ssd, strict=True)
    port = TBackend(TDetector(gd, device="cpu", **kw), TPredictor(sam, device="cpu"))
    return jax_backend, port, js, scfg


@pytest.fixture(scope="module")
def rig():
    return np.random.RandomState(7).randint(0, 255, (2, 72, 96, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_views(backends, rig):
    """The JAX backend's segment_views of the rig and, per view, its mask
    logits before the threshold (the best mask of each box)."""
    jax_backend, _, js, scfg = backends
    views = jax_backend.segment_views(rig, QUERIES, [0.3])
    dets = jax_backend.detector.predict_with_classes_batch(rig, QUERIES, 0.3)
    pred = jax_backend.sam.set_images(rig)
    (H, W), (rh, rw) = pred._orig_hw, pred._resized_hw
    logits = []
    for v, det in enumerate(dets):
        boxes = det.xyxy * np.asarray([rw / W, rh / H, rw / W, rh / H], np.float32)
        low, iou = jsam.sam_decode_boxes(js, pred._image_embs[v], jnp.asarray(boxes), scfg)
        lg = np.asarray(jpred._postprocess_jit(low, scfg.image_size, (rh, rw), (H, W)))
        logits.append(lg[np.arange(len(boxes)), np.asarray(iou).argmax(1)])
    return views, logits


def _check_view(got, ref, logits):
    assert got.labels == ref.labels
    np.testing.assert_allclose(got.confidences, ref.confidences, rtol=1e-4, atol=1e-4)
    assert got.masks.shape == ref.masks.shape and got.masks.dtype == bool
    sure = np.abs(logits) >= KNIFE_EDGE
    np.testing.assert_array_equal(got.masks[1:][sure], ref.masks[1:][sure])
    np.testing.assert_array_equal(got.masks[0], ~np.any(got.masks[1:], axis=0))


def test_segment_views_matches_jax(backends, rig, jax_views):
    got = backends[1].segment_views(rig, QUERIES, [0.3])
    ref, logits = jax_views
    assert len(got) == 2 and sum(len(v.labels) - 1 for v in ref) > 0
    for g, r, lg in zip(got, ref, logits):
        _check_view(g, r, lg)
        assert np.abs(lg).max() > 100 * KNIFE_EDGE  # the knife edge excludes few pixels


def test_segment_single_view_matches_jax(backends, rig, jax_views):
    """``segment`` of one view against the JAX rig's result for that view
    (the JAX package holds its segment to its segment_views)."""
    ref, logits = jax_views
    _check_view(backends[1].segment(rig[1], QUERIES, [0.3]), ref[1], logits[1])


def test_segment_views_contract(backends, rig):
    """Background first with confidence 1.0 and exactly the complement of
    the union; bool masks at the image size; labels drawn from the queries."""
    port = backends[1]
    for vm in port.segment_views(rig, QUERIES, [0.3]):
        assert vm.labels[0] == "background" and vm.confidences[0] == 1.0
        assert vm.masks.dtype == bool and vm.masks.shape[1:] == (72, 96)
        assert len(vm.labels) == vm.masks.shape[0] == vm.confidences.shape[0]
        assert set(vm.labels[1:]) <= set(QUERIES)
        np.testing.assert_array_equal(vm.masks[0], ~np.any(vm.masks[1:], axis=0))


def test_no_detection_gives_background_only(backends, rig):
    jax_backend, port = backends[:2]
    got = port.segment_views(rig, QUERIES, [1.1])
    ref = jax_backend.segment_views(rig, QUERIES, [1.1])
    for g, r in zip(got, ref):
        assert g.labels == r.labels == ["background"]
        np.testing.assert_array_equal(g.masks, r.masks)
        assert g.masks.shape == (1, 72, 96) and g.masks.all()
    single = port.segment(rig[0], QUERIES, [1.1])
    assert single.labels == ["background"] and single.masks.all()


def test_precomputed_backend_cycles_and_with_background():
    masks = np.zeros((2, 4, 5), bool)
    masks[0, :2] = True
    masks[1, 1:3, :2] = True
    vm = with_background(masks, ["a", "b"], np.asarray([0.5, 0.7], np.float32))
    np.testing.assert_array_equal(vm.masks[0], ~(masks[0] | masks[1]))
    assert vm.labels == ["background", "a", "b"]
    np.testing.assert_array_equal(vm.confidences, np.asarray([1.0, 0.5, 0.7], np.float32))
    other = with_background(np.zeros((0, 4, 5), bool), [], np.zeros((0,), np.float32))
    assert other.masks.shape == (1, 4, 5) and other.masks.all()
    pre = PrecomputedMaskBackend([vm, other])
    assert [pre.segment(None, [], [0.3]) for _ in range(3)] == [vm, other, vm]
    pre.reset()
    assert pre.segment(None, [], [0.3]) is vm
