"""Flash attention forward as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``repro/kernels/flash_attention.py``
(``flash_attention``, ``_kernel``): causal (offset T−S), sliding-window,
non-causal and GQA attention with an online softmax over K/V tiles held in
shared memory, f32 accumulation, f32 or bf16 operands, output in q's dtype.
The source is ``csrc/flash_attention.cu``, built and loaded by
``_nvcc.py``; it says how the kernel is laid out and what bounds it.  It
takes any S and T (blocks mask their own ragged edge) and head dims up to
128.

A CPU tensor runs the plain version (``ref.flash_attention_ref``); a CUDA
tensor launches the kernel or raises.  Nothing falls back.  ``LAUNCHES``
counts launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _nvcc, ref

LAUNCHES = {"flash_attention": 0}
MAX_HEAD_DIM = 128
MAX_GRID_YZ = 65535  # gridDim.y (heads) and gridDim.z (batch)
DTYPES = (torch.float32, torch.bfloat16)

_SIGNATURES = {"fa_flash_attention": (_nvcc.PTR,) * 4 + (_nvcc.I32,) * 6
               + (_nvcc.F32, _nvcc.I32, _nvcc.I32, _nvcc.I32, _nvcc.PTR)}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def check_qkv(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_dims: int) -> None:
    """Operands on one CUDA device, one dtype of :data:`DTYPES`, k and v
    [B, T, HKV, D] with HQ a multiple of HKV and D ≤ 128; q has
    ``q_dims`` dims (4: [B,S,HQ,D], 3: [B,HQ,D])."""
    if q.device.type != "cuda":
        raise ValueError(f"{kernel} takes CPU or CUDA tensors, got {q.device}")
    if q.dim() != q_dims or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{kernel}: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or hq % hkv or \
            min(q.shape) < 1 or k.shape[1] < 1:
        raise ValueError(f"{kernel}: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if d > MAX_HEAD_DIM or b > MAX_GRID_YZ or hq > MAX_GRID_YZ:
        raise ValueError(f"{kernel} takes D <= {MAX_HEAD_DIM} and B, HQ <= "
                         f"{MAX_GRID_YZ}, got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{kernel}: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"{kernel} takes {DTYPES}, got {q.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B,S,HQ,D]; k,v: [B,T,HKV,D] -> [B,S,HQ,D] in q's dtype."""
    _nvcc.require_no_grad("flash_attention", q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    check_qkv("flash_attention", q, k, v, q_dims=4)
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lib = _nvcc.load("flash_attention", _SIGNATURES)
    _nvcc.raise_on(lib.fa_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, t, hq,
        hkv, d, 1.0 / math.sqrt(d), int(causal), window or 0,
        int(q.dtype == torch.bfloat16), _nvcc.stream_of(q)), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
