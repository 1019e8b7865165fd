"""Uncompressed AVI files: a writer and a reader, with no codec library.

The JAX package writes its tracking video with ``cv2.VideoWriter`` as an
mp4v ``.mp4``. The port may use neither OpenCV nor an encoder package, so
:class:`AviWriter` writes a RIFF AVI of uncompressed frames instead: one
video stream of 24-bit ``BI_RGB`` DIBs (BGR samples, each row padded to 4
bytes), one ``00db`` chunk per frame in the ``movi`` list, and an ``idx1``
index. The rows are stored top-down (a negative DIB height): OpenCV 5.0's
FFmpeg reader corrupts its heap on bottom-up frames, and reads top-down
ones exactly. :func:`read_avi` reads back what :class:`AviWriter` writes,
and bottom-up files too.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10


def _row_bytes(width: int) -> int:
    return (width * 3 + 3) & ~3


class AviWriter:
    """``write(frame)`` appends one (H, W, 3) BGR uint8 frame; ``close()``
    writes the index and the sizes. Every frame has the first frame's shape."""

    def __init__(self, path: str, fps: float = 10.0):
        self.path = path
        self.fps = fps
        self.f = None
        self.shape = None
        self.offsets: List[int] = []  # each frame chunk's offset from the 'movi' fourcc

    def _headers(self, frames: int) -> bytes:
        H, W = self.shape[:2]
        size = _row_bytes(W) * H
        usec = int(round(1e6 / self.fps))
        avih = struct.pack("<14I", usec, int(size * self.fps), 0, AVIF_HASINDEX, frames, 0, 1,
                           size, W, H, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"DIB ", 0, 0, 0, 0, 1,
                           int(round(self.fps)), 0, frames, size, 0xFFFFFFFF, 0, 0, 0, W, H)
        strf = struct.pack("<IiiHHIIiiII", 40, W, -H, 1, 24, 0, size, 0, 0, 0, 0)
        strl = (b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
        return _chunk(b"LIST", hdrl)

    def write(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"AviWriter writes (H, W, 3) uint8 BGR frames, got {frame.dtype} "
                             f"{frame.shape}")
        if self.f is None:
            self.shape = frame.shape
            self.f = open(self.path, "wb")
            header = self._headers(0)
            # RIFF size and the movi list's size are patched on close
            self.f.write(b"RIFF" + b"\0\0\0\0" + b"AVI " + header + b"LIST\0\0\0\0movi")
            self.movi = 12 + len(header) + 8  # file offset of the 'movi' fourcc
        elif frame.shape != self.shape:
            raise ValueError(f"frame of shape {frame.shape} after frames of {self.shape}")
        H, W = self.shape[:2]
        rows = np.zeros((H, _row_bytes(W)), np.uint8)
        rows[:, : W * 3] = frame.reshape(H, W * 3)
        self.offsets.append(self.f.tell() - self.movi)
        self.f.write(_chunk(b"00db", rows.tobytes()))

    def close(self) -> None:
        if self.f is None:
            return
        size = _row_bytes(self.shape[1]) * self.shape[0]
        movi_end = self.f.tell()
        self.f.write(_chunk(b"idx1", b"".join(
            struct.pack("<4sIII", b"00db", AVIIF_KEYFRAME, off, size) for off in self.offsets)))
        end = self.f.tell()
        self.f.seek(4)
        self.f.write(struct.pack("<I", end - 8))
        self.f.write(b"AVI " + self._headers(len(self.offsets)))
        self.f.seek(self.movi - 4)
        self.f.write(struct.pack("<I", movi_end - self.movi))
        self.f.close()
        self.f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _chunk(kind: bytes, body: bytes) -> bytes:
    pad = b"\0" if len(body) % 2 else b""
    return kind + struct.pack("<I", len(body)) + body + pad


def read_avi(path: str) -> np.ndarray:
    """The frames of an uncompressed 24-bit AVI as written by
    :class:`AviWriter`: (T, H, W, 3) BGR uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")
    W = H = None
    frames = []

    def walk(pos: int, end: int) -> None:
        nonlocal W, H
        while pos + 8 <= end:
            kind, size = struct.unpack("<4sI", data[pos:pos + 8])
            body = pos + 8
            if kind == b"LIST":
                walk(body + 4, body + size)
            elif kind == b"strf":
                _, W, H, _, bits, comp = struct.unpack("<IiiHHI", data[body:body + 20])
                if bits != 24 or comp != 0:
                    raise ValueError(f"{path}: {bits}-bit frames, compression {comp}: only "
                                     "24-bit BI_RGB frames are read")
            elif kind == b"00db":
                stride = _row_bytes(W)
                rows = np.frombuffer(data, np.uint8, stride * abs(H), body).reshape(abs(H), stride)
                rows = rows if H < 0 else rows[::-1]  # a positive height is bottom-up
                frames.append(rows[:, : W * 3].reshape(abs(H), W, 3))
            pos = body + size + (size & 1)

    walk(12, len(data))
    if W is None:
        raise ValueError(f"{path}: no video stream format (strf)")
    return np.stack(frames) if frames else np.zeros((0, abs(H), W, 3), np.uint8)
