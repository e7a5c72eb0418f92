"""The RG-LRU linear recurrence ``h_t = a_t·h_{t−1} + x_t`` as a
hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``repro/kernels/rglru_scan.py``
(``rglru_scan``, ``_kernel``).  The source is ``csrc/rglru_scan.cu``, built
and loaded by ``_nvcc.py``; it says how the kernel is laid out and what
bounds it.  On the card it is bitwise equal to the plain version
(``ref.rglru_scan_ref``): both round the product and the sum apart.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  Nothing falls back.  ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _nvcc, ref

LAUNCHES = {"rglru_scan": 0}

_SIGNATURES = {"rgs_rglru_scan": (_nvcc.PTR,) * 5 + (_nvcc.I64,) * 3
               + (_nvcc.PTR,)}


def reset_launches() -> None:
    LAUNCHES["rglru_scan"] = 0


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, x: [B, L, W] f32; h0: [B, W] or None -> (h [B,L,W], h_last [B,W])."""
    _nvcc.require_no_grad("rglru_scan", a, x, h0)
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, x, h0)
    if a.device.type != "cuda":
        raise ValueError(
            f"rglru_scan takes CPU or CUDA tensors, got {a.device}")
    if a.dim() != 3 or min(a.shape) < 1:
        raise ValueError(f"rglru_scan takes a [B, L, W], got {tuple(a.shape)}")
    b, l, w = a.shape
    for name, t, shape in (("a", a, (b, l, w)), ("x", x, (b, l, w)),
                           ("h0", h0, (b, w))):
        if t is None:
            continue
        if t.device != a.device or t.dtype != torch.float32 or \
                tuple(t.shape) != shape:
            raise ValueError(f"rglru_scan: {name} must be float32 {shape} on "
                             f"{a.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    a, x = a.contiguous(), x.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    h = torch.empty_like(a)
    h_last = torch.empty(b, w, dtype=torch.float32, device=a.device)
    lib = _nvcc.load("rglru_scan", _SIGNATURES)
    _nvcc.raise_on(lib.rgs_rglru_scan(
        a.data_ptr(), x.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), h_last.data_ptr(), b, l, w, _nvcc.stream_of(a)),
        "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return h, h_last
