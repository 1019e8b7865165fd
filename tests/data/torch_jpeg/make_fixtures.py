"""Write the JPEG fixtures of tests/test_torch_jpeg.py and their expected.json.

Each fixture is a drifting-sphere frame (``utils/synthetic.py``)
written by OpenCV in one of the modes the port's decoder reads; the EXIF
fixture gets an APP1 segment with orientation 6 spliced in after SOI.
``expected.json`` records, for each file, the shape and SHA-256 of
``cv2.imread(path)``'s output: the bytes the decoder must reproduce.

  python tests/data/torch_jpeg/make_fixtures.py
"""

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from d3fields_tpu_torch.utils.synthetic import render_sphere_scene  # noqa: E402
S420, S422, S440, S444 = 0x221111, 0x211111, 0x121111, 0x111111

# name -> (crop or resize (h, w), grey, imwrite flags)
FIXTURES = {
    "baseline_420.jpg": ((240, 320), False, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S420]),
    "baseline_444.jpg": ((120, 160), False, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S444]),
    "baseline_422.jpg": ((120, 160), False, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S422]),
    "baseline_440.jpg": ((120, 160), False, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S440]),
    "grey.jpg": ((120, 160), True, []),
    "progressive_420.jpg": ((240, 320), False, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "restart_420.jpg": ((120, 160), False, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
    "odd_75x113.jpg": ((75, 113), False, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S420]),
    "exif_orientation_6.jpg": ((90, 120), False, []),
}


def exif_orientation_segment(value: int) -> bytes:
    """An APP1 Exif segment whose IFD0 holds one Orientation (0x0112) tag."""
    tiff = b"MM\x00\x2a" + struct.pack(">I", 8)
    ifd = struct.pack(">H", 1) + struct.pack(">HHIHH", 0x0112, 3, 1, value, 0)
    body = b"Exif\x00\x00" + tiff + ifd + struct.pack(">I", 0)
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def frame(t: int, hw) -> np.ndarray:
    offs = np.array([[0.008 * t, 0.004 * t, 0.0], [-0.005 * t, 0.006 * t, 0.0]])
    sc = render_sphere_scene(num_views=1, H=240, W=320, feat_dim=4, sphere_offsets=offs)
    bgr = np.ascontiguousarray(sc["color"][0][..., ::-1])
    return cv2.resize(bgr, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)


def main():
    expected = {}
    for t, (name, (hw, grey, flags)) in enumerate(FIXTURES.items()):
        img = frame(t, hw)
        if grey:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90] + flags)
        assert ok
        data = buf.tobytes()
        if name.startswith("exif"):
            data = data[:2] + exif_orientation_segment(6) + data[2:]
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        ref = cv2.imread(path)
        expected[name] = {"shape": list(ref.shape),
                          "sha256": hashlib.sha256(ref.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
