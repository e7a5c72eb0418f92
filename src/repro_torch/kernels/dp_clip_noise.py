"""Fused DP clip+noise as hand-written CUDA kernels for Hopper.

Replaces the two Pallas TPU kernels of ``repro/kernels/dp_clip_noise.py``:

* :func:`sumsq_rows` — Σx² per row of the stacked client updates
  ``x [R, P]`` (counterpart of ``sumsq``, ``_sumsq_kernel``);
* :func:`scale_noise_rows` — ``o = x·scale[r] + σ·n``, with one σ or one
  ``σ[r]`` a row (counterpart of ``scale_noise``, ``_scale_noise_kernel``,
  and of the reference's traced-σ fold into its noise operand).

The source is ``csrc/dp_clip_noise.cu``, built and loaded by ``_nvcc.py``.
Both kernels are memory-bound; the source says how they are laid out.
:func:`sumsq_plan` chooses the ``sumsq_rows`` launch in plain Python: the
blocks a row, in one thread-block cluster, and the columns of each; or,
for a few rows as wide as a language model, the split plan (many blocks a
row, their partials added by a second fixed-order pass).
:func:`sumsq_segments` gives the loads each block makes, so that the CPU
tests can follow the kernel's order; the C entry points check the plan.

A wrapper given a CPU tensor runs the plain version in ``kernels/ref.py``;
given a CUDA tensor it launches its kernel or raises.  Nothing falls back.
``LAUNCHES`` counts launches per kernel, so a run can show it went through
them.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _nvcc, ref

MAX_ROWS = 65535  # gridDim.y of both launches
CLUSTERS = (1, 2, 4, 8)  # blocks a row: the portable cluster sizes
# the split plan: taken when R·8 blocks leave SMs idle and a cluster block
# would read more than SPLIT_MIN_CHUNK columns; it aims at SPLIT_BLOCKS
# blocks in all (4 a SM, each 256 threads with 16 float4 loads in flight)
SPLIT_MIN_CHUNK = 1 << 20
SPLIT_BLOCKS = 4 * _nvcc.SMS

LAUNCHES = {"sumsq_rows": 0, "scale_noise_rows": 0}

_SIGNATURES = {
    "dpcn_sumsq_rows": (_nvcc.PTR, _nvcc.PTR, _nvcc.I64, _nvcc.I64,
                        _nvcc.I32, _nvcc.I64, _nvcc.PTR),
    "dpcn_sumsq_rows_split": (_nvcc.PTR, _nvcc.PTR, _nvcc.PTR, _nvcc.I64,
                              _nvcc.I64, _nvcc.I32, _nvcc.I64, _nvcc.PTR),
    "dpcn_scale_noise_rows": (_nvcc.PTR, _nvcc.PTR, _nvcc.PTR, _nvcc.F32,
                              _nvcc.PTR, _nvcc.I64, _nvcc.I64, _nvcc.PTR),
    "dpcn_scale_noise_rows_sigma": (_nvcc.PTR, _nvcc.PTR, _nvcc.PTR,
                                    _nvcc.PTR, _nvcc.PTR, _nvcc.I64,
                                    _nvcc.I64, _nvcc.PTR),
}


class SumsqPlan(NamedTuple):
    """``sumsq_rows``' launch: ``cluster`` blocks a row (one thread-block
    cluster; grid (cluster, R)), or with ``split`` > 1 the split plan,
    ``split`` blocks a row (grid (split, R)) whose partials a second launch
    adds; block ``rank`` takes columns ``[rank·chunk, (rank+1)·chunk)`` of
    its row."""
    cluster: int
    chunk: int
    split: int = 1

    @property
    def blocks(self) -> int:
        """Blocks a row."""
        return self.cluster * self.split


def _chunk(p: int, blocks: int) -> int:
    """``ceil(p / blocks)`` rounded up to a multiple of 4, so every block
    of a row starts at the row's alignment."""
    return -(-(-(-p // blocks)) // 4) * 4


def cluster_plan(r: int, p: int) -> SumsqPlan:
    """The fewest blocks a row (1, 2, 4 or 8: one thread-block cluster) for
    which ``r`` rows cover the H100's SMs (``_nvcc.SMS``; 8 when none
    does): C = 4 at the paper's R = 40, C = 1 from R = 132 up."""
    cluster = next((c for c in CLUSTERS if r * c >= _nvcc.SMS), CLUSTERS[-1])
    return SumsqPlan(cluster, _chunk(p, cluster))


def sumsq_plan(r: int, p: int) -> SumsqPlan:
    """:func:`cluster_plan`, unless even 8 blocks a row leave SMs idle and
    each would read over ``SPLIT_MIN_CHUNK`` columns: then the split plan,
    ``ceil(SPLIT_BLOCKS / r)`` blocks a row (528 for one row)."""
    plan = cluster_plan(r, p)
    if r * plan.cluster < _nvcc.SMS and plan.chunk > SPLIT_MIN_CHUNK:
        split = -(-SPLIT_BLOCKS // r)
        return SumsqPlan(1, _chunk(p, split), split)
    return plan


def sumsq_segments(plan: SumsqPlan, p: int,
                   row_start: int) -> List[Tuple[int, int, int]]:
    """The loads each block of one row makes, in rank order: ``(head, vec4s,
    tail)`` — scalar loads up to the first 16-byte boundary, 16-byte loads,
    scalar loads after them — for a row whose first element sits at element
    offset ``row_start`` of a 16-byte-aligned buffer (only its value mod 4
    matters).  Empty blocks give (0, 0, 0)."""
    out = []
    for rank in range(plan.blocks):
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
    _nvcc.require_plain("sumsq_rows", x)
    if x.device.type == "cpu":
        return ref.sumsq_rows_ref(x)
    out = _launch_sumsq(x, sumsq_plan(*x.shape))
    LAUNCHES["sumsq_rows"] += 1
    return out


def _launch_sumsq(x: torch.Tensor, plan: SumsqPlan) -> torch.Tensor:
    """``sumsq_rows`` of a CUDA ``x`` on the launch ``plan``, uncounted
    (the C entry points refuse a plan whose chunk does not tile the row as
    :func:`_chunk` tiles it)."""
    _require_cuda(x, "sumsq_rows")
    _check_rows("x", x, x.device)
    lib = _load()
    r, p = x.shape
    out = torch.empty(r, dtype=torch.float32, device=x.device)
    stream = _nvcc.stream_of(x)
    if plan.split > 1:
        partials = torch.empty(r * plan.split, dtype=torch.float32,
                               device=x.device)
        err = lib.dpcn_sumsq_rows_split(x.data_ptr(), partials.data_ptr(),
                                        out.data_ptr(), r, p, plan.split,
                                        plan.chunk, stream)
    else:
        err = lib.dpcn_sumsq_rows(x.data_ptr(), out.data_ptr(), r, p,
                                  plan.cluster, plan.chunk, stream)
    _nvcc.raise_on(err, "sumsq_rows")
    return out


def scale_noise_rows(x: torch.Tensor, noise: torch.Tensor,
                     scale: torch.Tensor, sigma,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``o = x·scale[r] + σ·noise`` over ``[R, P]`` f32; ``scale [R]``;
    ``sigma`` a float, or a ``[R]`` f32 tensor with one σ a row (a sweep's
    lanes, each with its own ε).  ``o`` goes into ``out`` where given,
    which may be ``x`` itself: each element is read once, then written,
    by the same thread (an LM's update row is noised where it lies)."""
    _nvcc.require_plain("scale_noise_rows", x, noise, scale, out)
    if x.device.type == "cpu":
        o = ref.scale_noise_rows_ref(x, noise, scale, sigma)
        return o if out is None else out.copy_(o)
    _require_cuda(x, "scale_noise_rows")
    r, p = x.shape
    _check_rows("x", x, x.device)
    _check_rows("noise", noise, x.device, (r, p))
    _check_rows("scale", scale, x.device, (r,))
    per_row = isinstance(sigma, torch.Tensor)
    if per_row:
        _check_rows("sigma", sigma, x.device, (r,))
    if out is None:
        out = torch.empty_like(x)
    _check_rows("out", out, x.device, (r, p))
    lib = _load()
    stream = _nvcc.stream_of(x)
    if per_row:
        err = lib.dpcn_scale_noise_rows_sigma(
            x.data_ptr(), noise.data_ptr(), scale.data_ptr(),
            sigma.data_ptr(), out.data_ptr(), r, p, stream)
    else:
        err = lib.dpcn_scale_noise_rows(
            x.data_ptr(), noise.data_ptr(), scale.data_ptr(), float(sigma),
            out.data_ptr(), r, p, stream)
    _nvcc.raise_on(err, "scale_noise_rows")
    LAUNCHES["scale_noise_rows"] += 1
    return out
