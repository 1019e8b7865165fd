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
