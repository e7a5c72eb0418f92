"""Flash attention forward as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``repro/kernels/flash_attention.py``
(``flash_attention``, ``_kernel``): causal (offset T−S), sliding-window,
non-causal and GQA attention with an online softmax over K/V tiles held in
shared memory, f32 accumulation, f32 or bf16 operands, output in q's dtype.
The source is ``csrc/flash_attention.cu``, built and loaded by
``_nvcc.py``; it says how the kernel is laid out and what bounds it.  It
takes any S and T (blocks mask their own ragged edge) and head dims up to
128.  :func:`launch_plan` chooses the launch (rows and heads per block,
lanes per row, key tile, shared memory, copy width) in plain Python, so
that the CPU tests can hold it to the card's limits; the C entry point
checks the plan it is given.

A CPU tensor runs the plain version (``ref.flash_attention_ref``); a CUDA
tensor launches the kernel or raises.  Nothing falls back.  ``LAUNCHES``
counts launches.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _nvcc, ref

LAUNCHES = {"flash_attention": 0}
MAX_HEAD_DIM = 128
MAX_GRID_YZ = 65535  # gridDim.y (heads) and gridDim.z (batch)
DTYPES = (torch.float32, torch.bfloat16)

MAX_SMEM = 48 * 1024  # static shared memory; the plan never asks for more
MIN_BLOCKS = 256  # two blocks for each of the H100's 132 SMs, about

_SIGNATURES = {"fa_flash_attention": (_nvcc.PTR,) * 4 + (_nvcc.I32,) * 6
               + (_nvcc.F32,) + (_nvcc.I32,) * 9 + (_nvcc.PTR,)}


class LaunchPlan(NamedTuple):
    """How ``fa_flash_attention`` launches: ``dmax`` is the head-dim bound
    it is built for, ``lanes`` the threads that split one (row, head)'s
    keys, ``rows`` × ``heads`` the (query row, q head) pairs of a block,
    ``kv_heads`` the kv heads it stages, ``key_tile`` the keys of one
    staged tile, ``copy_width`` the bytes of one copy unit."""
    dmax: int
    lanes: int
    rows: int
    heads: int
    kv_heads: int
    key_tile: int
    threads: int
    grid: Tuple[int, int, int]
    smem_bytes: int
    copy_width: int


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, s: int, t: int, hq: int, hkv: int, d: int,
                dtype: torch.dtype, ptrs_aligned: bool) -> LaunchPlan:
    """The launch for q [b, s, hq, d] against k/v [b, t, hkv, d].

    Head dims up to 32 take the lanes kernel: ``lanes`` = 4 adjacent
    threads per (row, head); blocks of up to 512 (D ≤ 16) or 256 threads
    over the most heads that share whole kv heads and fit; as many rows
    (a power of two) as cover ``s`` and fit, halved (down to 64 threads)
    until the grid has :data:`MIN_BLOCKS`, but whole warps (the lanes
    merge by warp shuffles); the largest key tile of 64, 32, 16 or 8
    whose q tile and K/V tiles (two buffers each when ``t`` spans more
    than one tile) fit in :data:`MAX_SMEM`.  Copies move 16 bytes when
    every pointer is 16-byte aligned (``ptrs_aligned``) and a row of
    ``d`` elements is a multiple of 16 bytes, else one element.  Head
    dims above 32 take the row kernel (DMAX 64 or 128): 64 rows of one
    head per block, a thread per row, ``grid.x`` = ⌈s / 64⌉.  The LM
    prefill launches it at D = 128 (granite-3-8b) and D = 96 (phi3-mini,
    padded into DMAX 128)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    if d > 32:
        dmax = 64 if d <= 64 else 128
        key_tile = 32 if dmax >= 128 else 64
        return LaunchPlan(dmax, 1, 64, 1, 1, key_tile, 64,
                          (-(-s // 64), hq, b), 2 * key_tile * dmax * 4,
                          esize)
    dmax = 8 if d <= 8 else 16 if d <= 16 else 32
    lanes, max_threads = 4, 512 if dmax <= 16 else 256
    width = 16 if ptrs_aligned and d * esize % 16 == 0 else esize
    group = hq // hkv
    for key_tile in (64, 32, 16, 8):
        n_buf = 2 if t > key_tile else 1
        for heads in range(min(hq, max_threads // lanes), 0, -1):
            # whole warps: rows * heads * lanes a multiple of 32
            min_rows = 32 // math.gcd(32, heads * lanes)
            if hq % heads or (heads % group and group % heads) or \
                    min_rows * heads * lanes > max_threads:
                continue
            kv_heads = max(heads // group, 1)
            rows = 1
            while rows < s and rows * 2 * heads * lanes <= max_threads:
                rows *= 2
            while rows > 1 and rows * heads * lanes > 64 and \
                    -(-s // rows) * (hq // heads) * b < MIN_BLOCKS:
                rows //= 2
            rows = max(rows, min_rows)
            smem = (rows * heads + n_buf * 2 * key_tile * kv_heads) \
                * dmax * esize
            if smem <= MAX_SMEM:
                return LaunchPlan(
                    dmax, lanes, rows, heads, kv_heads, key_tile,
                    rows * heads * lanes,
                    (-(-s // rows), hq // heads, b), smem, width)
    raise ValueError(f"flash_attention: no launch fits q [{b}, {s}, {hq}, "
                     f"{d}] against k/v [{b}, {t}, {hkv}, {d}]")


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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    plan = launch_plan(b, s, t, hq, hkv, d, q.dtype,
                       all(p % 16 == 0 for p in ptrs))
    lib = _nvcc.load("flash_attention", _SIGNATURES)
    _nvcc.raise_on(lib.fa_flash_attention(
        *ptrs, b, s, t, hq, hkv, d, 1.0 / math.sqrt(d), int(causal),
        window or 0, int(q.dtype == torch.bfloat16), plan.rows, plan.heads,
        plan.lanes, plan.key_tile, plan.smem_bytes, plan.copy_width,
        _nvcc.stream_of(q)), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
