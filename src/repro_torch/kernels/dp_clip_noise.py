"""Fused DP clip+noise as hand-written CUDA kernels for Hopper.

Replaces the two Pallas TPU kernels of ``repro/kernels/dp_clip_noise.py``:

* :func:`sumsq_rows` — Σx² per row of the stacked client updates
  ``x [R, P]`` (counterpart of ``sumsq``, ``_sumsq_kernel``);
* :func:`scale_noise_rows` — ``o = x·scale[r] + σ·n`` (counterpart of
  ``scale_noise``, ``_scale_noise_kernel``).

The source is ``csrc/dp_clip_noise.cu``, built and loaded by ``_nvcc.py``.
Both kernels are memory-bound; the source says how they are laid out.
:func:`sumsq_plan` chooses the ``sumsq_rows`` launch (blocks a row, in one
thread-block cluster, and the columns of each) in plain Python, and
:func:`sumsq_segments` gives the loads each block makes, so that the CPU
tests can follow the kernel's order; the C entry point checks the plan.

A wrapper given a CPU tensor runs the plain version in ``kernels/ref.py``;
given a CUDA tensor it launches its kernel or raises.  Nothing falls back.
``LAUNCHES`` counts launches per kernel, so a run can show it went through
them.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _nvcc, ref

MAX_ROWS = 65535  # gridDim.y of both launches
CLUSTERS = (1, 2, 4, 8)  # blocks a row: the portable cluster sizes

LAUNCHES = {"sumsq_rows": 0, "scale_noise_rows": 0}

_SIGNATURES = {
    "dpcn_sumsq_rows": (_nvcc.PTR, _nvcc.PTR, _nvcc.I64, _nvcc.I64,
                        _nvcc.I32, _nvcc.I64, _nvcc.PTR),
    "dpcn_scale_noise_rows": (_nvcc.PTR, _nvcc.PTR, _nvcc.PTR, _nvcc.F32,
                              _nvcc.PTR, _nvcc.I64, _nvcc.I64, _nvcc.PTR),
}


class SumsqPlan(NamedTuple):
    """``sumsq_rows``' launch: ``cluster`` blocks a row (one thread-block
    cluster), block ``rank`` taking columns ``[rank·chunk, (rank+1)·chunk)``
    of its row; grid (cluster, R)."""
    cluster: int
    chunk: int


def sumsq_plan(r: int, p: int) -> SumsqPlan:
    """The fewest blocks a row (1, 2, 4 or 8) for which ``r`` rows cover the
    H100's SMs (``_nvcc.SMS``; 8 when none does): C = 4 at the paper's
    R = 40, C = 1 from R = 132 up.  ``chunk`` is ``ceil(p / C)`` rounded up
    to a multiple of 4, so every block of a row starts at the row's
    alignment."""
    cluster = next((c for c in CLUSTERS if r * c >= _nvcc.SMS), CLUSTERS[-1])
    per_block = -(-p // cluster)
    return SumsqPlan(cluster, -(-per_block // 4) * 4)


def sumsq_segments(plan: SumsqPlan, p: int,
                   row_start: int) -> List[Tuple[int, int, int]]:
    """The loads each block of one row makes, in rank order: ``(head, vec4s,
    tail)`` — scalar loads up to the first 16-byte boundary, 16-byte loads,
    scalar loads after them — for a row whose first element sits at element
    offset ``row_start`` of a 16-byte-aligned buffer (only its value mod 4
    matters).  Empty blocks give (0, 0, 0)."""
    out = []
    for rank in range(plan.cluster):
        lo = min(rank * plan.chunk, p)
        n = min(plan.chunk, p - lo)
        head = min((4 - (row_start + lo) % 4) % 4, n)
        vec4s = (n - head) // 4
        out.append((head, vec4s, n - head - 4 * vec4s))
    return out


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load():
    return _nvcc.load("dp_clip_noise", _SIGNATURES)


def _check_rows(name: str, t: torch.Tensor, device: torch.device,
                shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _require_cuda(x: torch.Tensor, kernel: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} takes CPU or CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{kernel} takes x [R, P], got {tuple(x.shape)}")
    if not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"{kernel} takes 1..{MAX_ROWS} rows, "
                         f"got {x.shape[0]}")


def sumsq_rows(x: torch.Tensor) -> torch.Tensor:
    """Σ x² over each row of ``x [R, P]`` f32 -> ``[R]`` f32.  Fixed
    reduction order: the same input gives the same bits every run."""
    if x.device.type == "cpu":
        return ref.sumsq_rows_ref(x)
    _require_cuda(x, "sumsq_rows")
    _check_rows("x", x, x.device)
    lib = _load()
    r, p = x.shape
    plan = sumsq_plan(r, p)
    out = torch.empty(r, dtype=torch.float32, device=x.device)
    stream = _nvcc.stream_of(x)
    _nvcc.raise_on(lib.dpcn_sumsq_rows(x.data_ptr(), out.data_ptr(), r, p,
                                       plan.cluster, plan.chunk, stream),
                   "sumsq_rows")
    LAUNCHES["sumsq_rows"] += 1
    return out


def scale_noise_rows(x: torch.Tensor, noise: torch.Tensor,
                     scale: torch.Tensor, sigma: float) -> torch.Tensor:
    """``o = x·scale[r] + σ·noise`` over ``[R, P]`` f32; ``scale [R]``."""
    if x.device.type == "cpu":
        return ref.scale_noise_rows_ref(x, noise, scale, sigma)
    _require_cuda(x, "scale_noise_rows")
    r, p = x.shape
    _check_rows("x", x, x.device)
    _check_rows("noise", noise, x.device, (r, p))
    _check_rows("scale", scale, x.device, (r,))
    lib = _load()
    out = torch.empty_like(x)
    stream = _nvcc.stream_of(x)
    _nvcc.raise_on(lib.dpcn_scale_noise_rows(
        x.data_ptr(), noise.data_ptr(), scale.data_ptr(), float(sigma),
        out.data_ptr(), r, p, stream), "scale_noise_rows")
    LAUNCHES["scale_noise_rows"] += 1
    return out
