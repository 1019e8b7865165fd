"""Port parity: the headless interactive session (interact/) of
d3fields_tpu_torch against d3fields_tpu, and the host drawing and resizing
it rests on against OpenCV and Pillow.

Soft aggregation is held at tests/test_session.py:74-75's tolerances
(rtol 1e-5, atol 1e-6 soft and 1e-4 hard). The interactions, the overlays,
the strokes (``cv2.line``), the enlarging ``INTER_AREA`` (``cv2.resize``) and
the RGBA reads (``Image.convert("RGBA")``) are held exactly. The propagation
round trip runs both sessions on one narrow XMem (key/value/hidden
8/16/8): probabilities at 1e-4, labels off the near-ties.
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from d3fields_tpu import interact as J
from d3fields_tpu.config import XMemConfig as JXMemConfig
from d3fields_tpu_torch import interact as T
from d3fields_tpu_torch.config import XMemConfig
from d3fields_tpu_torch.interact import session as tsession
from d3fields_tpu_torch.utils import png
from d3fields_tpu_torch.utils.visualization import draw_line, resize_area_u8
from test_torch_xmem import tiny_xmem


@pytest.mark.parametrize("keep_bg", [False, True])
@pytest.mark.parametrize("hard", [False, True])
def test_aggregate_wbg_matches_jax(keep_bg, hard):
    prob = np.random.RandomState(0).rand(3, 20, 24).astype(np.float32)
    np.testing.assert_allclose(T.aggregate_wbg(prob, keep_bg=keep_bg, hard=hard),
                               J.aggregate_wbg(prob, keep_bg=keep_bg, hard=hard),
                               rtol=1e-5, atol=1e-4 if hard else 1e-6)


class StubFbrs:
    """Records clicks and returns a disc mask (stands in for the f-BRS
    controller, held in tests/test_torch_interactive.py)."""

    def __init__(self, hw):
        self.hw = hw
        self.clicks = []
        self.unanchored = 0

    def interact(self, image, x, y, positive):
        self.clicks.append((float(x), float(y), bool(positive)))
        yy, xx = np.mgrid[:self.hw[0], :self.hw[1]]
        return np.hypot(yy - y, xx - x) < 6

    def unanchor(self):
        self.unanchored += 1


class StubS2M:
    """Returns fixed per-object probabilities and keeps the scribble map."""

    def __init__(self, prob):
        self.prob = prob
        self.maps = []

    def interact(self, image, prev_mask, scr_mask):
        self.maps.append(scr_mask.copy())
        return self.prob


def test_interactions_match_jax():
    """Free painting, scribbles (the stroke maps exactly, the hard
    aggregation) and clicks (the 0.9 clamp, the target overwrite)."""
    rs = np.random.RandomState(2)
    H, W, K = 30, 40, 2
    prev = (rs.rand(H, W) * (K + 1)).astype(np.uint8)
    strokes = [([(4.0, 4.0), (20.0, 18.0), (35.0, 25.0)], 2), ([(5.0, 25.0), (30.0, 5.0)], 0),
               ([(12.5, 7.5)], 1)]  # a lone point is a dot
    ours, ref = T.FreeInteraction(prev, K, size=3), J.FreeInteraction(prev, K, size=3)
    for pts, obj in strokes:
        ours.push_path(pts, obj)
        ref.push_path(pts, obj)
    np.testing.assert_array_equal(ours.drawn_map, ref.drawn_map)
    np.testing.assert_array_equal(ours.predict(), ref.predict())
    with pytest.raises(ValueError, match="out of range"):
        ours.push_path([(1.0, 1.0)], K + 1)

    fixed = rs.rand(K, H, W).astype(np.float32)
    img = np.zeros((H, W, 3), np.float32)
    ts, js = StubS2M(fixed), StubS2M(fixed)
    ours, ref = T.ScribbleInteraction(img, prev, ts, K), J.ScribbleInteraction(img, prev, js, K)
    for pts, obj in strokes:
        ours.push_path(pts, obj)
        ref.push_path(pts, obj)
    got, want = ours.predict(), ref.predict()
    np.testing.assert_array_equal(ts.maps[-1], js.maps[-1])
    np.testing.assert_array_equal(got, want)

    prob = rs.rand(K + 1, H, W).astype(np.float32)
    prob /= prob.sum(0)
    ours = T.ClickInteraction(img, prob, StubFbrs((H, W)), tar_obj=1)
    ref = J.ClickInteraction(img, prob, StubFbrs((H, W)), tar_obj=1)
    for c in ((10.0, 8.0, True), (20.0, 15.0, False)):
        ours.push_click(*c)
        ref.push_click(*c)
        np.testing.assert_array_equal(ours.predict(), ref.predict())


def frames(T_=4, H=48, W=64):
    rs = np.random.RandomState(7)
    base = (rs.rand(H, W, 3) * 255).astype(np.uint8)
    return np.stack([np.roll(base, 2 * t, axis=1) for t in range(T_)])


def test_session_gestures_store_and_object_switch(tmp_path):
    """Gestures adopt their state at once (gui.py:758-770), commit ends the
    interaction, navigation reloads the stored mask, save_masks writes
    paletted PNGs; switching the click target unanchors f-BRS and starts a
    new interaction (gui.py:670-680); every step equals the JAX session's."""
    fr = frames()
    stubs = StubFbrs(fr.shape[1:3]), StubFbrs(fr.shape[1:3])
    ours = T.InteractiveSession(fr, num_objects=2, fbrs_controller=stubs[0], device="cpu")
    ref = J.InteractiveSession(fr, num_objects=2, fbrs_controller=stubs[1])
    for s in (ours, ref):
        m = s.free_draw([(10, 10), (20, 20)], obj=1)
        assert (m == 1).any() and s.masks[0].max() == 1
        s.commit()
        s.set_object(2)
        first = s.click(40, 30, positive=True)
        assert (first == 2).any() and (first == 1).any()
        interaction = s.interaction
        s.set_object(1)
        s.click(12, 12, positive=False)
        assert s.interaction is not interaction
        s.commit()
        s.goto(1)
        assert s.current_mask.max() == 0
        s.goto(0)
    assert stubs[0].unanchored == stubs[1].unanchored > 0
    np.testing.assert_array_equal(ours.masks, ref.masks)
    np.testing.assert_array_equal(ours.current_mask, ref.current_mask)
    paths = ours.save_masks(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["0000000.png"]
    img = Image.open(paths[0])
    assert img.mode == "P"
    np.testing.assert_array_equal(np.array(img), ours.masks[0])
    with pytest.raises(RuntimeError, match="no s2m controller"):
        ours.scribble([(1, 1)])
    with pytest.raises(RuntimeError, match="no XMem model"):
        ours.propagate()


def test_session_propagation_round_trip_matches_jax():
    """A free-drawn box on a middle frame, propagated forward to the end
    and backward to frame 0, then paused after one frame, through both
    sessions on the same narrow XMem (gui.py:544-610, 862-866)."""
    model, jparams, kw = tiny_xmem()
    fr = frames(T_=5)
    ours = T.InteractiveSession(fr, num_objects=1, xmem_model=model,
                                xmem_cfg=XMemConfig(**kw), device="cpu")
    ref = J.InteractiveSession(fr, num_objects=1, xmem_params=jparams,
                               xmem_cfg=JXMemConfig(**kw))
    probs = {"ours": [], "ref": []}
    for s, key in ((ours, "ours"), (ref, "ref")):
        s.goto(2)
        s.free_draw([(20, 15), (40, 35)], obj=1)
        s.commit()
        grab = lambda t, m, s=s, key=key: probs[key].append(s.current_prob)  # noqa: E731
        assert s.propagate(forward=True, on_frame=grab) == [3, 4] and s.cursur == 4
        s.goto(2)
        assert s.propagate(forward=False, on_frame=grab) == [1, 0] and s.cursur == 0
        assert s._mask_known.all()
        s.goto(2)
        assert s.propagate(forward=True, max_frames=1, on_frame=grab) == [3]
    for a, b in zip(probs["ours"], probs["ref"]):
        assert a.shape == b.shape == (2, 48, 64)
        np.testing.assert_allclose(a, b, atol=1e-4)
        sure = np.abs(b[1] - b[0]) > 2e-4
        assert sure.mean() > 0.5
        np.testing.assert_array_equal(a.argmax(0)[sure], b.argmax(0)[sure])
    ours.clear_memory()
    assert ours.xmem.curr_ti == -1


def test_overlays_match_jax_exactly():
    """The five viewer modes, hard and soft, and the layered mode without
    a layer."""
    rs = np.random.RandomState(1)
    H, W, K = 20, 28, 2
    img = (rs.rand(H, W, 3) * 255).astype(np.uint8)
    mask = (rs.rand(H, W) * (K + 1)).astype(np.uint8)
    layer = (rs.rand(H, W, 4) * 255).astype(np.uint8)
    prob = rs.rand(K + 1, H, W).astype(np.float32)
    prob /= prob.sum(0)
    for mode in ("davis", "fade", "light", "popup", "layered"):
        for lay in (layer, None):
            np.testing.assert_array_equal(T.get_visualization(mode, img, mask, lay, [1, 2]),
                                          J.get_visualization(mode, img, mask, lay, [1, 2]))
        for targets in ([1, 2], [2], []):
            for lay in (layer.astype(np.float32) / 255.0, None):
                np.testing.assert_array_equal(
                    T.get_visualization_soft(mode, img / 255.0, prob, lay, targets),
                    J.get_visualization_soft(mode, img / 255.0, prob, lay, targets))
    with pytest.raises(ValueError, match="unknown visualization mode"):
        T.get_visualization("nope", img, mask, None, [1])


# ---------------------------------------------------------------------------
# host drawing and resizing against OpenCV and Pillow
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(48, 64), (480, 854)])
@pytest.mark.parametrize("thickness", [1, 2, 3, 4, 5])
def test_draw_line_equals_cv2(hw, thickness):
    """200 random segments, one in ten a lone point, their ends up to 1.5
    canvases beyond the border (lines that leave the canvas or miss it)."""
    H, W = hw
    rs = np.random.RandomState(thickness + H)
    for k in range(200):
        span = (W // 2, H // 2) if k % 2 else (20, 20)
        p0 = tuple(int(v) for v in rs.randint((-span[0], -span[1]), (W + span[0], H + span[1])))
        p1 = p0 if k % 10 == 0 else tuple(
            int(v) for v in rs.randint((-span[0], -span[1]), (W + span[0], H + span[1])))
        value = int(rs.randint(1, 256))
        want = cv2.line(np.zeros((H, W), np.uint8), p0, p1, value, thickness=thickness)
        got = draw_line(np.zeros((H, W), np.uint8), p0, p1, value, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{p0} -> {p1}")


def test_session_strokes_equal_cv2_polylines():
    """``_draw_path``: a rounded polyline at the brush size, a lone point as
    a zero-length line, drawn over an existing index map."""
    rs = np.random.RandomState(3)
    canvas = (rs.rand(48, 64) * 3).astype(np.uint8)
    for pts in ([(3.4, 4.6), (20.5, 18.5), (70.0, 25.2), (-5.0, 40.0)], [(12.5, 7.5)]):
        want = canvas.copy()
        ipts = [(int(round(x)), int(round(y))) for x, y in pts]
        for p0, p1 in zip(ipts[:-1] or ipts, ipts[1:] or ipts):
            cv2.line(want, p0, p1, 2, thickness=3)
        np.testing.assert_array_equal(tsession._draw_path(canvas.copy(), pts, 2, 3), want)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_area_enlarging_equals_cv2(channels):
    """Integer and non-integer scales, both axes enlarged or one shrunk."""
    rs = np.random.RandomState(channels)
    for (H, W), (h, w) in [((24, 32), (48, 64)), ((24, 32), (72, 96)), ((30, 40), (47, 83)),
                           ((31, 17), (64, 40)), ((40, 30), (35, 61)), ((240, 427), (480, 854)),
                           ((7, 5), (480, 854))]:
        img = rs.randint(0, 256, (H, W) if channels == 1 else (H, W, channels)).astype(np.uint8)
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area_u8(img, (h, w)), want,
                                      err_msg=f"{(H, W)} -> {(h, w)}")


def test_set_layer_resizes_as_jax(tmp_path):
    fr = frames(T_=2)
    layer = np.random.RandomState(4).randint(0, 256, (30, 40, 4)).astype(np.uint8)
    ours = T.InteractiveSession(fr, num_objects=1, device="cpu")
    ref = J.InteractiveSession(fr, num_objects=1)
    ours.set_layer(layer)
    ref.set_layer(layer)
    np.testing.assert_array_equal(ours.overlay_layer, ref.overlay_layer)
    np.testing.assert_array_equal(ours.visualize("layered"), ref.visualize("layered"))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L"])
def test_imread_rgba_equals_pillow_convert(tmp_path, mode):
    rs = np.random.RandomState(5)
    if mode == "P":
        img = Image.fromarray(rs.randint(0, 6, (20, 30)).astype(np.uint8), mode="P")
        img.putpalette(list(rs.randint(0, 256, 6 * 3)))
    else:
        shape = {"RGB": (20, 30, 3), "RGBA": (20, 30, 4), "L": (20, 30)}[mode]
        img = Image.fromarray(rs.randint(0, 256, shape).astype(np.uint8), mode=mode)
    path = str(tmp_path / f"{mode}.png")
    img.save(path)
    np.testing.assert_array_equal(png.imread_rgba(path),
                                  np.array(Image.open(path).convert("RGBA")))
    if mode == "P":
        img.save(path, transparency=0)
        with pytest.raises(ValueError, match="tRNS"):
            png.imread_rgba(path)
