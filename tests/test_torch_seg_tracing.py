"""The tracer's spans and counters of open-text segmentation
(``GroundedSAMBackend.segment_views``), on the CPU at tiny sizes.

On, one request's spans nest as ``seg.segment_views`` -> ``seg.detect``
(-> ``.text``, ``.backbone``, ``.encoder``, ``.decoder``, ``.post``),
``seg.sam.encode``, ``seg.sam.decode``, ``seg.masks``; ``seg_boxes`` counts
the boxes SAM decodes and ``deform_gathers`` the deformable samplings (one
a decoder or encoder layer), each charged to the span it happens in. Off,
nothing is recorded and the masks are the same.
"""

import dataclasses

import numpy as np
import pytest

from d3fields_tpu_torch.models.groundingdino import model as tgd
from d3fields_tpu_torch.models.groundingdino.detector import GroundingDinoDetector
from d3fields_tpu_torch.models.sam import model as tsam
from d3fields_tpu_torch.models.sam.predictor import SamPredictor
from d3fields_tpu_torch.seg.grounded_sam import GroundedSAMBackend
from d3fields_tpu_torch.utils.profiling import tracer
from port_bench import weights_segment
from port_bench.reference.gdino import toy_tokenize

QUERIES = ["mug", "red can"]
PARENT = {"seg.segment_views": None, "seg.detect": "seg.segment_views",
          "seg.detect.text": "seg.detect", "seg.detect.backbone": "seg.detect",
          "seg.detect.encoder": "seg.detect", "seg.detect.decoder": "seg.detect",
          "seg.detect.post": "seg.detect", "seg.sam.encode": "seg.segment_views",
          "seg.sam.decode": "seg.segment_views", "seg.masks": "seg.segment_views"}


@pytest.fixture(scope="module")
def backend():
    gcfg, scfg = tgd.GroundingDinoConfig.tiny_test(), tsam.SamConfig.tiny_test()
    g = dataclasses.asdict(gcfg)
    gm = tgd.GroundingDino(gcfg, device="cpu")
    gm.load_state_dict(weights_segment.gdino_weights(g, 5, "cpu"))
    sm = tsam.Sam(scfg, device="cpu")
    sm.load_state_dict(weights_segment.sam_weights(dataclasses.asdict(scfg), 5, "cpu"))
    det = GroundingDinoDetector(gm.eval(), toy_tokenize, short_side=64, max_side=96, device="cpu")
    return GroundedSAMBackend(det, SamPredictor(sm.eval(), device="cpu")), gcfg


@pytest.fixture
def images():
    return np.random.default_rng(4).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)


@pytest.fixture
def traced():
    tracer.reset()
    tracer.enable()
    yield tracer
    tracer.disable()
    tracer.reset()


def test_spans_nest_and_counters_count(backend, images, traced):
    be, gcfg = backend
    views = be.segment_views(images, QUERIES, [-1.0])
    recs = traced.records()
    names = [r[0] for r in recs]
    assert sorted(set(names)) == sorted(PARENT)
    assert all(names.count(n) == 1 for n in PARENT)
    for name, t0, t1, parent, root, _ in recs:
        assert t1 is not None and t1 >= t0
        assert (recs[parent][0] if parent >= 0 else None) == PARENT[name], name
        assert recs[root][0] == "seg.segment_views"
    s = traced.summary()
    boxes = sum(len(v.labels) - 1 for v in views)
    assert boxes > 0
    assert s["counters"]["seg_boxes"] == boxes
    assert s["counters_by_span"]["seg.sam.decode"]["seg_boxes"] == boxes
    layers = gcfg.encoder_layers + gcfg.decoder_layers
    assert s["counters"]["deform_gathers"] == layers
    by = s["counters_by_span"]
    assert by["seg.detect.encoder"]["deform_gathers"] == gcfg.encoder_layers
    assert by["seg.detect.decoder"]["deform_gathers"] == gcfg.decoder_layers
    assert set(s["spans"]["seg.segment_views"]["children"]) == {
        "seg.detect", "seg.sam.encode", "seg.sam.decode", "seg.masks"}


def test_off_records_nothing_and_changes_nothing(backend, images):
    be, _ = backend
    tracer.reset()
    assert not tracer.on
    off = be.segment_views(images, QUERIES, [-1.0])
    assert tracer.records() == [] and tracer.summary()["counters"] == {}
    tracer.enable()
    try:
        on = be.segment_views(images, QUERIES, [-1.0])
    finally:
        tracer.disable()
        tracer.reset()
    for a, b in zip(off, on):
        assert np.array_equal(a.masks, b.masks) and a.labels == b.labels


def test_no_detection_opens_no_sam_span(backend, images, traced):
    be, _ = backend
    views = be.segment_views(images, QUERIES, [2.0])
    assert all(len(v.labels) == 1 for v in views)
    names = {r[0] for r in traced.records()}
    assert "seg.sam.encode" not in names and "seg_boxes" not in traced.summary()["counters"]
