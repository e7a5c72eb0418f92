"""The RG-LRU linear recurrence ``h_t = a_t·h_{t−1} + x_t`` as a
hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel of ``repro/kernels/rglru_scan.py``
(``rglru_scan``, ``_kernel``).  The source is ``csrc/rglru_scan.cu``, built
and loaded by ``_nvcc.py``; it says how the kernel is laid out and what
bounds it.  :func:`launch_plan` chooses the launch (lanes a thread, block
and grid shape) in plain Python, so that the CPU tests can hold it
to the card's limits; the C entry point checks the plan it is given.  On
the card the kernel is bitwise equal to the plain version
(``ref.rglru_scan_ref``): both round the product and the sum apart.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  Nothing falls back.  ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _nvcc, ref

LAUNCHES = {"rglru_scan": 0}

TILE_ELEMS = 16    # elements of a and of x in one register tile (kTileElems)
MAX_THREADS = 256  # threads of one block, at most (kMaxThreads)
MAX_GRID_Y = 65535
MAX_DIM = 2 ** 31 - 1  # B, L and W go to the kernel as 32-bit ints

_SIGNATURES = {"rgs_rglru_scan": (_nvcc.PTR,) * 5 + (_nvcc.I32,) * 8
               + (_nvcc.PTR,)}


class LaunchPlan(NamedTuple):
    """How ``rgs_rglru_scan`` launches: a thread owns ``vec`` adjacent lanes
    (4, read with 16-byte float4 loads, or 1) and walks the time axis
    ``tile`` steps at a time; ``block`` (lane groups of a row, rows) and
    ``grid`` (lane-group tiles, row tiles)."""
    vec: int
    tile: int
    block: Tuple[int, int]
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, l: int, w: int, ptrs_aligned: bool) -> LaunchPlan:
    """The launch for a, x [b, l, w].

    A thread owns 4 adjacent lanes, read with 16-byte float4 loads, when
    the whole call is one 4-step tile, ``w % 4 == 0`` and every pointer is
    16-byte aligned (``ptrs_aligned``): the ssm detector's [128, 4, 512],
    fewer and wider threads.  Otherwise it owns 1 lane and walks 16-step
    tiles: the rglru detector's [128, 64, 16], one chain a thread and four
    times the threads.  On an H100 each choice measured the faster on its
    shape.  The warps of the whole call are spread evenly over the H100's
    SMs (``_nvcc.SMS``): a block holds ``32·ceil(warps / SMS)`` threads, at
    most :data:`MAX_THREADS`, so [128, 4, 512] runs 128 blocks of 128
    threads and [128, 64, 16] 64 blocks of one warp.  A block takes one
    row's lane groups when the row has that many, else it packs whole rows
    (the rglru shape: 16 lanes × 2 rows)."""
    if min(b, l, w) < 1 or max(b, l, w) > MAX_DIM:
        raise ValueError(f"rglru_scan: no launch for [{b}, {l}, {w}]")
    vec = 4 if l <= TILE_ELEMS // 4 and w % 4 == 0 and ptrs_aligned else 1
    per_row = w // vec
    warps = -(-b * per_row // 32)
    threads = min(32 * -(-warps // _nvcc.SMS), MAX_THREADS)
    if per_row >= threads:
        block = (threads, 1)
    else:
        block = (per_row, threads // per_row)
    grid = (-(-per_row // block[0]), -(-b // block[1]))
    if grid[1] > MAX_GRID_Y:
        raise ValueError(f"rglru_scan: {b} rows need {grid[1]} row tiles, "
                         f"more than {MAX_GRID_Y}")
    return LaunchPlan(vec, TILE_ELEMS // vec, block, grid)


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
    ptrs = [t.data_ptr() for t in (a, x, h0, h, h_last) if t is not None]
    plan = launch_plan(b, l, w, all(p % 16 == 0 for p in ptrs))
    lib = _nvcc.load("rglru_scan", _SIGNATURES)
    _nvcc.raise_on(lib.rgs_rglru_scan(
        a.data_ptr(), x.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), h_last.data_ptr(), b, l, w, plan.vec, *plan.block,
        *plan.grid, _nvcc.stream_of(a)), "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return h, h_last
