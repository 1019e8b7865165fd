"""Port parity: the visualization layer of d3fields_tpu_torch against
d3fields_tpu and OpenCV.

``draw_keypoints`` equals ``cv2.circle`` filled discs exactly (radii 0-8,
centres inside, on and next to the border); ``resize_area_u8`` equals
``cv2.resize(INTER_AREA)`` exactly at the shapes here; the ``TrackVis``
mosaic is within one grey level of the JAX package's (its ``INTER_AREA``
rounding) and ``tracking.avi`` decodes, with OpenCV and with
``utils/avi.py``, to the mosaics exactly; ``aggregate_colored_pcd`` at rtol
1e-6 and ``remove_statistical_outliers`` equal to the JAX functions. Only
the tests import cv2.
"""

import os

import cv2
import numpy as np
import pytest

from d3fields_tpu.utils import synthetic as jsyn
from d3fields_tpu.utils import visualization as jvis
from d3fields_tpu_torch.utils import visualization as tvis
from d3fields_tpu_torch.utils.avi import AviWriter, read_avi


def _cv2_frames(path):
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f.copy())
    cap.release()
    return frames


@pytest.mark.parametrize("radius", range(0, 9))
def test_draw_keypoints_equals_cv2_circle(radius):
    rs = np.random.RandomState(radius)
    H, W = 23, 31
    img = rs.randint(0, 256, (H, W, 3)).astype(np.uint8)
    # inside, on each border, one pixel off it, and off the image
    uv = np.concatenate([np.stack([rs.randint(0, W, 12), rs.randint(0, H, 12)], 1),
                         [[0, 0], [W - 1, H - 1], [0, H // 2], [W - 1, 3], [5, 0], [7, H - 1],
                          [1, 1], [W - 2, H - 2], [-1, 4], [W, 4], [3, H]]])
    colors = rs.randint(0, 256, (uv.shape[0], 3)).astype(np.uint8)
    got = tvis.draw_keypoints(img, uv, colors, radius=radius)
    want = img.copy()
    for (u, v), c in zip(uv, colors):
        if 0 <= u < W and 0 <= v < H:
            cv2.circle(want, (int(u), int(v)), radius, tuple(int(x) for x in c[::-1]), -1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvis.draw_keypoints(img, uv[:12], radius=radius),
                                  jvis.draw_keypoints(img, uv[:12], radius=radius))


@pytest.mark.parametrize("hw,ratio", [((60, 80), 0.7), ((240, 320), 0.7), ((37, 53), 0.7),
                                      ((60, 80), 0.5), ((48, 60), 1 / 3)])
def test_resize_area_equals_cv2(hw, ratio):
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
    h, w = int(hw[0] * ratio), int(hw[1] * ratio)
    np.testing.assert_array_equal(tvis.resize_area_u8(img, (h, w)),
                                  cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))


def test_trackvis_mosaic_and_video_match_jax(tmp_path):
    """tests/test_apps.py:68-85's case through both classes: each mosaic
    within one grey level of the JAX one; tracking.avi holds the mosaics
    exactly (read by OpenCV and by read_avi); per-frame PNGs with
    save_frames."""
    rs = np.random.RandomState(0)
    poses = np.tile(np.eye(3, 4, dtype=np.float32)[None], (4, 1, 1))
    poses[:, 2, 3] = 1.0
    Ks = np.tile(np.array([[100.0, 0, 40], [0, 100, 30], [0, 0, 1]], np.float32)[None], (4, 1, 1))
    info = {"a": {"src_pts_color": rs.randint(0, 255, (5, 3), dtype=np.uint8)}}
    colors = rs.randint(0, 255, (4, 60, 80, 3), dtype=np.uint8)
    tv = tvis.TrackVis(poses, Ks, str(tmp_path / "t"), save_frames=True)
    jv = jvis.TrackVis(poses, Ks, str(tmp_path / "j"))
    mosaics = []
    for k in range(3):
        pts = [rs.uniform(-0.1, 0.1, (5, 3)).astype(np.float32)]
        got, want = tv.visualize_match_pts(pts, colors, info), jv.visualize_match_pts(pts, colors,
                                                                                      info)
        assert got.shape == want.shape == (42 * 2, 56 * 2, 3)
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1, f"frame {k}: {(diff > 0).mean():.4%} of samples off by 1"
        mosaics.append(got)
    tv.close()
    jv.close()
    path = str(tmp_path / "t" / "tracking.avi")
    np.testing.assert_array_equal(read_avi(path), np.stack(mosaics))
    decoded = _cv2_frames(path)
    assert len(decoded) == 3
    for a, b in zip(decoded, mosaics):
        np.testing.assert_array_equal(a, b)
    assert os.path.exists(tmp_path / "t" / "000002.png")
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t" / "000001.png")), mosaics[1])


@pytest.mark.parametrize("hw", [(5, 7), (37, 53), (84, 112)])
def test_avi_round_trip_with_opencv(tmp_path, hw):
    """Rows padded to 4 bytes (odd widths), any frame count."""
    rs = np.random.RandomState(hw[0])
    frames = rs.randint(0, 256, (4,) + hw + (3,)).astype(np.uint8)
    path = str(tmp_path / "v.avi")
    with AviWriter(path, fps=10) as w:
        for f in frames:
            w.write(f)
    np.testing.assert_array_equal(read_avi(path), frames)
    decoded = _cv2_frames(path)
    assert len(decoded) == 4
    np.testing.assert_array_equal(np.stack(decoded), frames)
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    assert cap.get(cv2.CAP_PROP_FPS) == 10.0
    cap.release()
    with pytest.raises(ValueError, match="after frames of"):
        with AviWriter(str(tmp_path / "x.avi")) as w:
            w.write(frames[0])
            w.write(frames[0][1:])


def test_aggregate_colored_pcd_and_outliers_match_jax():
    """tests/test_apps.py:88-109's inputs: points and colours at rtol 1e-6,
    with and without voxel averaging and masks; the outlier filter's
    indices equal."""
    sc = jsyn.render_sphere_scene(num_views=2, H=60, W=80, feat_dim=8)
    poses44 = np.concatenate(
        [sc["pose"], np.tile(np.array([[[0, 0, 0, 1.0]]], np.float32), (2, 1, 1))], axis=1)
    b = {"x_lower": -0.5, "x_upper": 0.7, "y_lower": -0.5, "y_upper": 0.6,
         "z_lower": 0.001, "z_upper": 0.5}
    masks = sc["sphere_masks"][:, 0]
    for kw in (dict(boundaries=b, downsample_voxel=0.01), dict(masks=masks), {}):
        args = (sc["color"][..., ::-1], sc["depth"], sc["K"], poses44)
        (tp, tc), (jp, jc) = tvis.aggregate_colored_pcd(*args, **kw), \
            jvis.aggregate_colored_pcd(*args, **kw)
        assert tp.shape == jp.shape and tc.shape == jc.shape and tp.shape[0] > 100
        np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-7)
    pts = tvis.aggregate_colored_pcd(*args, boundaries=b, downsample_voxel=0.01)[0]
    for n, k, r in ((2000, 5, 0.2), (500, 3, 1.0), (4, 5, 0.2)):
        np.testing.assert_array_equal(tvis.remove_statistical_outliers(pts[:n], k, r),
                                      jvis.remove_statistical_outliers(pts[:n], k, r))


def test_palette_and_index_mask_png_match_jax(tmp_path):
    """davis_palette equals the JAX table; save_index_mask_png writes a P
    file that Pillow reads back to the indices with that palette
    (tests/test_aux.py:310-336)."""
    from PIL import Image

    np.testing.assert_array_equal(tvis.davis_palette(), jvis.davis_palette())
    m = np.zeros((20, 30), np.uint8)
    m[5:15, 10:20] = 2
    m[0, :3] = 255
    p = str(tmp_path / "m.png")
    tvis.save_index_mask_png(p, m)
    img = Image.open(p)
    assert img.mode == "P"
    np.testing.assert_array_equal(np.array(img), m)
    np.testing.assert_array_equal(np.array(img.getpalette(), np.uint8).reshape(-1, 3),
                                  jvis.davis_palette())
