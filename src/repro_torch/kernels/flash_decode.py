"""Flash decode (one query token against a KV cache) as a hand-written CUDA
kernel for Hopper.

Replaces the Pallas TPU kernel of ``repro/kernels/flash_decode.py``
(``flash_decode``, ``_kernel``): one query per batch row with a per-row
valid ``length``, an online softmax over KV tiles, GQA, f32 or bf16
operands, and optionally the partials ``(o, m, l)`` a caller merges across
cache shards with ``ref.combine_partials``.  The source is
``csrc/flash_decode.cu``, built and loaded by ``_nvcc.py``; it says how the
kernel is laid out and what bounds it.

A CPU tensor runs the plain version (``ref.flash_decode_ref``); a CUDA
tensor launches the kernel or raises.  Nothing falls back.  ``LAUNCHES``
counts launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _nvcc, ref
from repro_torch.kernels.flash_attention import check_qkv

LAUNCHES = {"flash_decode": 0}

_SIGNATURES = {"fd_flash_decode": (_nvcc.PTR,) * 7 + (_nvcc.I32,) * 5
               + (_nvcc.F32, _nvcc.I32, _nvcc.PTR)}


def reset_launches() -> None:
    LAUNCHES["flash_decode"] = 0


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length,
                 *, return_partials: bool = False):
    """q: [B,HQ,D]; k,v: [B,T,HKV,D]; ``length``: [] or [B] valid cache
    prefix.  Returns o [B,HQ,D] in q's dtype, or ``(o, m [B,HQ], l [B,HQ])``
    (f32) when ``return_partials``."""
    _nvcc.require_no_grad("flash_decode", q, k, v)
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, length,
                                    return_partials=return_partials)
    check_qkv("flash_decode", q, k, v, q_dims=3)
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    length = torch.as_tensor(length, device=q.device).to(torch.int32)
    length = length.expand(b).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    m = torch.empty(b, hq, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = _nvcc.load("flash_decode", _SIGNATURES)
    _nvcc.raise_on(lib.fd_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), b, t, hq, hkv, d,
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        _nvcc.stream_of(q)), "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return (o, m, l) if return_partials else o
