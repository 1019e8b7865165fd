"""Determinism of the host RNGs (reference ``set_seed``,
``utils/my_utils.py:222-228``).

Counterpart of ``d3fields_tpu/utils/seeding.py``: seeds Python's and
numpy's RNGs, which the host stages draw from (FPS random starts, data
sampling), and torch's. The JAX package can also return a root PRNG key;
torch has no such key to return.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
