"""Constants and module constructors shared across the port's models."""

import functools

import numpy as np
import torch
from torch import nn

# ImageNet normalization (every backbone here — DINOv2, GroundingDINO,
# XMem — uses the same torchvision stats)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@functools.lru_cache(maxsize=8)
def imagenet_stats(device: torch.device):
    """(mean, std) as float32 tensors on ``device``, copied there once: a
    per-frame copy from host memory would wait for the device."""
    return (torch.as_tensor(IMAGENET_MEAN).to(device),
            torch.as_tensor(IMAGENET_STD).to(device))


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A per-call host array on ``device`` without waiting for the device's
    queued work: a CUDA copy goes from pinned memory, asynchronously (a
    plain copy from pageable memory waits for the stream to drain)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# The constructors below skip PyTorch's default initialisation: every weight is
# set by a model's init_params or by a checkpoint.

def linear(d_in: int, d_out: int, device, bias: bool = True) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias, device=device)


def embedding(n: int, dim: int, device) -> nn.Embedding:
    return nn.utils.skip_init(nn.Embedding, n, dim, device=device)


def named(**children: nn.Module) -> nn.Module:
    """A module that only holds ``children`` under their names, for the
    nesting of a huggingface state dict's keys."""
    m = nn.Module()
    for k, v in children.items():
        m.add_module(k, v)
    return m


# compute_dtype names, as the JAX package spells them
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` name ('float32' or 'bfloat16')."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


def cast_copy(model: nn.Module, dtype: torch.dtype, prefixes=("",)) -> nn.Module:
    """``model`` with its floating parameters and buffers whose names start
    with one of ``prefixes`` rounded to ``dtype``, once: the JAX package's
    compute-dtype cast of a model's trunk. The result is a new module tree
    that shares every other tensor with ``model`` (and ``model`` itself when
    nothing changes); ``model`` is left as it was."""
    import copy

    memo, changed = {}, False
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if id(t) in memo:  # a tied tensor
            continue
        if t.is_floating_point() and t.dtype != dtype and name.startswith(tuple(prefixes)):
            cast = t.detach().to(dtype)
            memo[id(t)] = nn.Parameter(cast, t.requires_grad) if isinstance(t, nn.Parameter) \
                else cast
            changed = True
        else:
            memo[id(t)] = t
    return copy.deepcopy(model, memo) if changed else model
