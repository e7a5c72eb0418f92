"""Initializers and normalisation shared by the port's detectors (the part
of ``repro/models/layers.py`` they use).  Params are plain f32 tensors;
the reference's sharding metadata is not ported."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def normal_init(gen: torch.Generator, shape: Sequence[int],
                stddev: float) -> torch.Tensor:
    """``stddev · N(0, 1)`` in f32, drawn from ``gen`` on its device."""
    return stddev * torch.randn(tuple(shape), generator=gen,
                                device=gen.device)


def fan_in_init(gen: torch.Generator, shape: Sequence[int],
                fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, 1/fan_in); ``fan_in`` defaults to ``shape[0]``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return normal_init(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)))


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)
