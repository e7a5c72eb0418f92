"""Flash attention forward as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``repro/kernels/flash_attention.py``
(``flash_attention``, ``_kernel``): causal (offset T−S), sliding-window,
non-causal and GQA attention with an online softmax over K/V tiles held in
shared memory, f32 sums, f32 or bf16 operands, output in q's dtype.  The
source is ``csrc/flash_attention.cu``, built and loaded by ``_nvcc.py``; it
says how each kernel is laid out and what bounds it.  It takes any S and T
(blocks mask their own ragged edge).  Three kernels, by dtype and head dim:

* D ≤ 32: the lanes kernel (f32 or bf16), the attn detector's path;
* bf16 at 32 < D ≤ 256: the tensor-core kernel (``mma.sync``), the LM
  prefill's (granite-3-8b at D = 128, phi3-mini at 96, recurrentgemma's
  local attention at 256);
* f32 at 32 < D ≤ 128: the row kernel (TF32 stays off, so f32 has no
  tensor cores); f32 above 128 raises.

:func:`launch_plan` chooses the launch in plain Python, so that the CPU
tests can hold it to the card's limits; the C entry point checks the plan
it is given and refuses any other.

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
MAX_HEAD_DIM = 256   # bf16; f32 stops at MAX_HEAD_DIM_F32
MAX_HEAD_DIM_F32 = 128
MAX_GRID_YZ = 65535  # gridDim.y and gridDim.z
DTYPES = (torch.float32, torch.bfloat16)

MAX_SMEM = 48 * 1024  # static shared memory: the lanes kernel's limit
MAX_SMEM_OPTIN = 232_448  # dynamic shared memory a block after the opt-in
MIN_BLOCKS = 256  # two blocks for each of the H100's 132 SMs, about

# the tensor-core kernel: head dims it is built for, and the query
# positions of one head a block (4 warps of 16)
MMA_DMAX = (64, 96, 128, 256)
MMA_ROWS = 64

KERNELS = ("lanes", "row", "mma")  # the C entry point's kernel codes 0, 1, 2

_SIGNATURES = {"fa_flash_attention": (_nvcc.PTR,) * 4 + (_nvcc.I32,) * 6
               + (_nvcc.F32,) + (_nvcc.I32,) * 10 + (_nvcc.PTR,)}


class LaunchPlan(NamedTuple):
    """How ``fa_flash_attention`` launches: ``kernel`` one of
    :data:`KERNELS`, ``dmax`` the head-dim bound it is built for, ``lanes``
    the threads that split one (row, head)'s keys, ``rows`` query positions
    × ``heads`` q heads a block, ``kv_heads`` the kv heads it stages,
    ``key_tile`` the keys of one staged tile, ``copy_width`` the bytes of
    one copy unit."""
    kernel: str
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


def mma_key_tile(dmax: int) -> int:
    """Keys of one staged K/V tile of the tensor-core kernel."""
    return 32 if dmax >= 256 else 64


def mma_smem_bytes(dmax: int) -> int:
    """The tensor-core kernel's shared memory: the q tile and two buffers
    of K and V tiles, bf16 rows padded by 8 elements."""
    return (MMA_ROWS + 4 * mma_key_tile(dmax)) * (dmax + 8) * 2


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
    ``d`` elements is a multiple of 16 bytes, else one element.  bf16 at
    32 < D ≤ 256 takes the tensor-core kernel: :data:`MMA_ROWS` positions
    of one head a block (4 warps), grid (heads, batch, position tiles),
    shared memory :func:`mma_smem_bytes` within :data:`MAX_SMEM_OPTIN`,
    16-byte copies when every pointer is 16-byte aligned and D is a
    multiple of 8, else 2.  f32 at 32 < D ≤ 128 takes the row kernel (DMAX
    64 or 128): 64 rows of one head per block, a thread per row,
    ``grid.x`` = ⌈s / 64⌉."""
    esize = 2 if dtype == torch.bfloat16 else 4
    if d > 32 and dtype == torch.bfloat16:
        dmax = next(x for x in MMA_DMAX if d <= x)
        grid = (hq, b, -(-s // MMA_ROWS))
        if max(grid[1:]) > MAX_GRID_YZ:
            raise ValueError(f"flash_attention: grid {grid} exceeds "
                             f"{MAX_GRID_YZ} in y or z")
        width = 16 if ptrs_aligned and d % 8 == 0 else 2
        return LaunchPlan("mma", dmax, 1, MMA_ROWS, 1, 1, mma_key_tile(dmax),
                          2 * MMA_ROWS, grid, mma_smem_bytes(dmax), width)
    if d > 32:
        if d > MAX_HEAD_DIM_F32:
            raise ValueError(
                f"flash_attention: f32 at D = {d} has no kernel: the "
                f"tensor-core kernel takes bf16, and the f32 row kernel "
                f"keeps a row of D floats a thread (D <= "
                f"{MAX_HEAD_DIM_F32})")
        dmax = 64 if d <= 64 else 128
        key_tile = 32 if dmax >= 128 else 64
        return LaunchPlan("row", dmax, 1, 64, 1, 1, key_tile, 64,
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
                    "lanes", dmax, lanes, rows, heads, kv_heads, key_tile,
                    rows * heads * lanes,
                    (-(-s // rows), hq // heads, b), smem, width)
    raise ValueError(f"flash_attention: no launch fits q [{b}, {s}, {hq}, "
                     f"{d}] against k/v [{b}, {t}, {hkv}, {d}]")


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def check_qkv(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_dims: int, max_head_dim: int = MAX_HEAD_DIM) -> None:
    """Operands on one CUDA device, one dtype of :data:`DTYPES`, k and v
    [B, T, HKV, D] with HQ a multiple of HKV and D ≤ ``max_head_dim``; q
    has ``q_dims`` dims (4: [B,S,HQ,D], 3: [B,HQ,D])."""
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
    if d > max_head_dim or b > MAX_GRID_YZ or hq > MAX_GRID_YZ:
        raise ValueError(f"{kernel} takes D <= {max_head_dim} and B, HQ <= "
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    b, s, hq, d = q.shape
    aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v, o))
    plan = launch_plan(b, s, k.shape[1], hq, k.shape[2], d, q.dtype, aligned)
    lib = _nvcc.load("flash_attention", _SIGNATURES)
    _nvcc.raise_on(lib.fa_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
        k.shape[1], hq, k.shape[2], d, 1.0 / math.sqrt(d), int(causal),
        window or 0, int(q.dtype == torch.bfloat16),
        KERNELS.index(plan.kernel), plan.rows, plan.heads, plan.lanes,
        plan.key_tile, plan.smem_bytes, plan.copy_width,
        _nvcc.stream_of(q)), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
