"""Metrics and logging: AverageMeter, Integrator, JsonlLogger, Tee, and
the DAVIS J&F video-segmentation score.

Counterpart of ``d3fields_tpu/utils/metrics.py``: the reference's
``AverageMeter`` (``utils/my_utils.py:394-411``), XMem's ``Integrator``
(``XMem/util/log_integrator.py``), the ``Tee`` stdout capture
(``utils/my_utils.py:373-391``), metrics as JSON lines in place of
TensorBoard (``XMem/util/logger.py:22-46``), and :func:`davis_jf`, the
davis2017-evaluation J and F measures. The boundary tolerance's disk
dilation is numpy, equal to ``cv2.dilate`` with the same disk.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Integrator:
    """Accumulates scalar dicts; ``finalize`` averages what was added (and
    logs it). Values are taken as they come: across processes, feed it
    values that were already reduced."""

    def __init__(self, logger: Optional["JsonlLogger"] = None):
        self.logger = logger
        self.values: Dict[str, AverageMeter] = {}

    def add_dict(self, d: Dict[str, float]):
        for k, v in d.items():
            self.values.setdefault(k, AverageMeter()).update(float(v))

    def finalize(self, prefix: str, it: int) -> Dict[str, float]:
        out = {k: m.avg for k, m in self.values.items()}
        if self.logger is not None:
            self.logger.log_scalars(prefix, out, it)
        return out

    def reset(self):
        self.values = {}


class JsonlLogger:
    """Append-only JSON-lines metrics sink, stamped with the git commit
    (``TensorboardLogger``'s stamp, ``XMem/util/logger.py:22-46``)."""

    def __init__(self, path: str, run_name: str = "run"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a")
        stamp = {"run": run_name, "time": time.time()}
        try:
            stamp["git"] = subprocess.check_output(
                ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL).decode().strip()
        except (OSError, subprocess.CalledProcessError):
            pass
        self._write({"event": "start", **stamp})

    def _write(self, d: dict):
        self.f.write(json.dumps(d) + "\n")
        self.f.flush()

    def log_scalar(self, tag: str, value: float, it: int):
        self._write({"tag": tag, "value": float(value), "it": int(it)})

    def log_scalars(self, prefix: str, values: Dict[str, float], it: int):
        self._write({"prefix": prefix, "it": int(it), **{k: float(v) for k, v in values.items()}})

    def close(self):
        self.f.close()


class Tee:
    """Duplicates stdout to a file (``utils/my_utils.py:373-391``)."""

    def __init__(self, path: str, mode: str = "a"):
        self.file = open(path, mode)
        self.stdout = sys.stdout
        sys.stdout = self

    def close(self):
        sys.stdout = self.stdout
        self.file.close()

    def write(self, data):
        self.file.write(data)
        self.stdout.write(data)

    def flush(self):
        self.file.flush()
        self.stdout.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _boundary(mask: np.ndarray) -> np.ndarray:
    """Binary boundary map, davis2017-evaluation's ``seg2bmap`` at equal
    input and output size: a pixel is boundary iff it differs from its east,
    south or south-east neighbour, with the official last row and column."""
    seg = mask.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def dilate_disk(mask: np.ndarray, rad: int) -> np.ndarray:
    """Binary dilation by the Euclidean disk ``dy^2 + dx^2 <= rad^2``
    (``cv2.dilate`` with that kernel; outside the image adds nothing): each
    row of the disk is a horizontal run, dilated through cumulative sums."""
    m = mask.astype(bool)
    H, W = m.shape
    c = np.pad(np.pad(m, ((0, 0), (rad, rad))).astype(np.int32).cumsum(1), ((0, 0), (1, 0)))
    runs = {}
    out = np.zeros_like(m)
    for dy in range(-rad, rad + 1):
        hw = math.isqrt(rad * rad - dy * dy)
        if hw not in runs:  # any set pixel within hw columns
            runs[hw] = (c[:, rad + hw + 1:rad + hw + 1 + W] - c[:, rad - hw:rad - hw + W]) > 0
        row = runs[hw]
        if dy >= 0:  # output row y takes input row y + dy
            out[:H - dy] |= row[dy:]
        else:
            out[-dy:] |= row[:H + dy]
    return out


def davis_jf(pred_idx: np.ndarray, gt_idx: np.ndarray,
             num_objects: Optional[int] = None,
             bound_ratio: float = 0.008,
             objects: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """Per-frame DAVIS metrics of index masks (0 = background): J, the mean
    over objects of the region IoU; F, the mean boundary F-measure with a
    match tolerance of ``bound_ratio`` times the image diagonal (the
    davis2017 default); and JF = (J + F) / 2. ``objects`` restricts the
    scoring to those ids (partial ground truth, as YouTube-VOS's
    first-appearance frames are)."""
    H, W = gt_idx.shape
    if num_objects is None:
        num_objects = int(max(pred_idx.max(), gt_idx.max()))
    if objects is None:
        objects = range(1, num_objects + 1)
    objects = [int(o) for o in objects]
    if not objects:
        return {"J": 1.0, "F": 1.0, "JF": 1.0}
    # the official bound_pix: ceil(bound_th * diagonal), a Euclidean disk
    rad = max(1, int(np.ceil(bound_ratio * np.sqrt(H * H + W * W))))
    js, fs = [], []
    for o in objects:
        p = pred_idx == o
        g = gt_idx == o
        union = (p | g).sum()
        js.append(1.0 if union == 0 else (p & g).sum() / union)
        pb, gb = _boundary(p), _boundary(g)
        if pb.sum() == 0 and gb.sum() == 0:
            fs.append(1.0)
            continue
        if pb.sum() == 0 or gb.sum() == 0:
            fs.append(0.0)
            continue
        precision = (pb & dilate_disk(gb, rad)).sum() / pb.sum()
        recall = (gb & dilate_disk(pb, rad)).sum() / gb.sum()
        fs.append(0.0 if precision + recall == 0
                  else 2 * precision * recall / (precision + recall))
    j, f = float(np.mean(js)), float(np.mean(fs))
    return {"J": j, "F": f, "JF": (j + f) / 2}
