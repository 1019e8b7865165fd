"""Scribble-to-Mask (S2M) network and controller (the reference GUI's
scribble backend, ``XMem/inference/interact/s2m/``) in PyTorch."""

from d3fields_tpu_torch.models.s2m.controller import S2MController  # noqa: F401
from d3fields_tpu_torch.models.s2m.model import (  # noqa: F401
    S2M, S2mConfig, init_params, load_jax_params,
)
