"""Flash decode (one query token against a KV cache) as a hand-written CUDA
kernel for Hopper.

Replaces the Pallas TPU kernel of ``repro/kernels/flash_decode.py``
(``flash_decode``, ``_kernel``): one query per batch row with a per-row
valid ``length``, an online softmax over KV tiles, GQA, f32 or bf16
operands, and optionally the partials ``(o, m, l)`` a caller merges across
cache shards with ``ref.combine_partials``.  The source is
``csrc/flash_decode.cu``, built and loaded by ``_nvcc.py``; it says how the
kernel is laid out and what bounds it.  :func:`launch_plan` chooses the
launch (q heads per block, shared memory, copy width) in plain Python, so
that the CPU tests can hold it to the card's limits; the C entry point
checks the plan it is given.

A CPU tensor runs the plain version (``ref.flash_decode_ref``); a CUDA
tensor launches the kernel or raises.  Nothing falls back.  ``LAUNCHES``
counts launches.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _nvcc, ref
from repro_torch.kernels.flash_attention import MAX_SMEM, check_qkv

LAUNCHES = {"flash_decode": 0}
MAX_HEAD_DIM = 128  # the lanes kernel to 32, the thread-per-key kernel above

LANES = 32      # G: lanes per (row, q head) of the lanes kernel (kLanes)
KEY_TILE = 64   # keys of one staged tile (kKeyTile)

_SIGNATURES = {"fd_flash_decode": (_nvcc.PTR,) * 7 + (_nvcc.I32,) * 5
               + (_nvcc.I64, _nvcc.F32) + (_nvcc.I32,) * 5 + (_nvcc.PTR,)}


class LaunchPlan(NamedTuple):
    """How ``fd_flash_decode`` launches: ``dmax`` is the head-dim bound it
    is built for, ``lanes`` the threads that split one (row, q head)'s keys
    (1: the thread-per-key kernel of head dims 64 and 128), ``heads`` the
    q heads of a block, ``kv_heads`` the kv heads it stages, ``key_tile``
    the keys of one staged tile, ``block``/``grid`` the launch dims and
    ``copy_width`` the bytes of one copy unit."""
    dmax: int
    lanes: int
    heads: int
    kv_heads: int
    key_tile: int
    threads: int
    block: Tuple[int, int, int]
    grid: Tuple[int, int, int]
    smem_bytes: int
    copy_width: int


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, t: int, hq: int, hkv: int, d: int,
                dtype: torch.dtype, ptrs_aligned: bool) -> LaunchPlan:
    """The launch for q [b, hq, d] against k/v [b, t, hkv, d].

    Head dims up to 32 take the lanes kernel with :data:`LANES` (one warp)
    per (row, q head): a block takes one batch row and the most q heads
    that are whole GQA groups (or a part of one group), fit in 512 (D ≤ 16)
    or 256 threads, and whose K and V tiles of :data:`KEY_TILE` keys (two
    buffers each when ``t`` spans more than one tile) fit in
    :data:`MAX_SMEM`; so the attn read-out runs 128 blocks, about one for
    each of the H100's 132 SMs.  Copies move 16 bytes when every pointer
    and q's batch stride are 16-byte aligned (``ptrs_aligned``) and a row
    of ``d`` elements is a multiple of 16 bytes, else one element.  Head
    dims 64 and 128 take the thread-per-key kernel (any D ≤ 128): one block
    of 128 threads per (row, q head)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    if d > 32:
        return LaunchPlan(128, 1, 1, 1, 128, 128, (128, 1, 1), (hq, b, 1),
                          0, esize)
    dmax = 8 if d <= 8 else 16 if d <= 16 else 32
    max_threads = 512 if dmax <= 16 else 256
    width = 16 if ptrs_aligned and d * esize % 16 == 0 else esize
    group = hq // hkv
    n_buf = 2 if t > KEY_TILE else 1
    for heads in range(min(hq, max_threads // LANES), 0, -1):
        if hq % heads or (heads % group and group % heads):
            continue
        kv_heads = max(heads // group, 1)
        smem = n_buf * 2 * KEY_TILE * kv_heads * dmax * esize
        if smem <= MAX_SMEM:
            per_kv = min(heads, group)
            return LaunchPlan(dmax, LANES, heads, kv_heads, KEY_TILE,
                              heads * LANES, (per_kv * LANES, kv_heads, 1),
                              (b, hkv // kv_heads, group // per_kv), smem,
                              width)
    raise ValueError(f"flash_decode: no launch fits q [{b}, {hq}, {d}] "
                     f"against k/v [{b}, {t}, {hkv}, {d}]")


def reset_launches() -> None:
    LAUNCHES["flash_decode"] = 0


def _kernel_length(length, b: int, device: torch.device) -> torch.Tensor:
    """``length`` as the kernel reads it, an int32 [b] tensor on the card:
    passed through as it is when it is one already (the detector's)."""
    if isinstance(length, torch.Tensor) and length.dtype == torch.int32 and \
            length.device == device and length.shape == (b,) and \
            length.is_contiguous():
        return length
    length = torch.as_tensor(length, device=device).to(torch.int32)
    return length.expand(b).contiguous()


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length,
                 *, return_partials: bool = False):
    """q: [B,HQ,D]; k,v: [B,T,HKV,D]; ``length``: [] or [B] valid cache
    prefix.  Returns o [B,HQ,D] in q's dtype, or ``(o, m [B,HQ], l [B,HQ])``
    (f32) when ``return_partials``.  q may broadcast one query over the
    batch (batch stride 0, as ``expand`` gives): it is read in place."""
    _nvcc.require_no_grad("flash_decode", q, k, v)
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k, v, length,
                                    return_partials=return_partials)
    check_qkv("flash_decode", q, k, v, q_dims=3, max_head_dim=MAX_HEAD_DIM)
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    length = _kernel_length(length, b, q.device)
    if not k.is_contiguous():
        k = k.contiguous()
    if not v.is_contiguous():
        v = v.contiguous()
    # each batch row of q contiguous [HQ, D]; the batch stride is free
    if q.stride(2) != 1 or (hq > 1 and q.stride(1) != d):
        q = q.contiguous()
    q_bstride = q.stride(0) if b > 1 else hq * d
    o = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    aligned = all(p % 16 == 0 for p in ptrs) and \
        q_bstride * q.element_size() % 16 == 0
    plan = launch_plan(b, t, hq, hkv, d, q.dtype, aligned)
    if plan.lanes == 1 and q_bstride != hq * d:  # that kernel reads q dense
        q = q.contiguous()
        q_bstride = hq * d
    if return_partials or plan.lanes == 1:
        m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        ml = (m.data_ptr(), l.data_ptr())
    else:
        ml = (None, None)
    lib = _nvcc.load("flash_decode", _SIGNATURES)
    _nvcc.raise_on(lib.fd_flash_decode(
        q.data_ptr(), ptrs[1], ptrs[2], length.data_ptr(), ptrs[3], *ml, b,
        t, hq, hkv, d, q_bstride, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), plan.lanes, plan.heads,
        plan.smem_bytes, plan.copy_width, _nvcc.stream_of(q)), "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return (o, m, l) if return_partials else o
