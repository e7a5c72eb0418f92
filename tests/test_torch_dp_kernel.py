"""The ``sumsq_rows`` CUDA kernel's launch plan and cluster order on the
CPU.

The kernels (``csrc/dp_clip_noise.cu``: ``sumsq_rows_cluster_kernel``, and
the split plan's ``sumsq_rows_split_kernel`` and
``sumsq_rows_finish_kernel``) cannot run here; ``chip_smoke.py`` holds
them against the plain version on the card.  These tests mirror in torch
the order they sum in — a cluster of C blocks a row under
:func:`sumsq_plan` (or S blocks a row under its split plan), each block's
column range read as a scalar head up to a 16-byte boundary, 16-byte loads
and a scalar tail (:func:`sumsq_segments`), each thread's fmaf's and
the block's shuffle-down trees in f32, the block partials added in rank
order (the split plan: thread t of the second pass adds partials t,
t + 256, ... in order, then the block's trees) — and hold the mirror to
the port's plain version and the JAX package's interpret-mode Pallas
``sumsq`` at rtol 1e-5.  The plan is held to the
card's limits for every shape ``chip_smoke.py`` launches, and those
launches are shown to run every branch of the kernel.  Inputs come from a
NumPy seed.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dp_clip_noise import sumsq as j_sumsq

from repro_torch.kernels import dp_clip_noise as t_dp
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(1)

THREADS, UNROLL = 256, 4  # kSumsqThreads, kUnroll


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
SQ_CASES = CS.SQ_CASES


def _rows(case) -> torch.Tensor:
    """x [r, p] of a ``SQ_CASES`` case, ``offset`` elements past a 16-byte
    boundary, from a NumPy seed."""
    r, p, offset = case
    rng = np.random.default_rng(r * 7 + p + offset)
    x = torch.as_tensor((rng.standard_normal((r, p)) * 3).astype(np.float32))
    return CS.offset_copy(torch, x, offset)


def _fma_sq(v: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``fmaf(v, v, acc)`` in f32: v² is exact in f64, and the f64 sum
    rounded to f32 is fmaf's single rounding unless the f64 rounding lands
    on an f32 tie (about 2^-29 of the cases)."""
    return (v.double() * v.double() + acc.double()).float()


def _block_reduce(vals: torch.Tensor) -> torch.Tensor:
    """``block_reduce`` over the 256 threads' f32 values: in each warp the
    shuffle-down tree (offsets 16, 8, 4, 2, 1; lane l adds lane l + off),
    then warp 0 the same tree (4, 2, 1) over the 8 warp sums; lane 0's."""
    s = vals.reshape(THREADS // 32, 32).clone()
    for off in (16, 8, 4, 2, 1):
        s[:, :32 - off] = s[:, :32 - off] + s[:, off:]
    w = torch.zeros(32)
    w[:THREADS // 32] = s[:, 0]
    for off in (4, 2, 1):
        w[:32 - off] = w[:32 - off] + w[off:]
    return w[0]


def _block_sum(seg: torch.Tensor, head: int, vec4s: int) -> torch.Tensor:
    """One block's partial in the kernel's order, in f32: thread t squares
    its head element into accumulator 0; float4 j = t + 256·(u + 4k) goes
    into accumulator u by four fmaf's (x, y, z, w), k in order; its tail
    element into accumulator 1 by an fmaf; each thread adds its
    accumulators 0..3 in order, and :func:`_block_reduce` the threads."""
    acc = torch.zeros(UNROLL, THREADS)
    acc[0, :head] = seg[:head] * seg[:head]
    groups = -(-vec4s // (THREADS * UNROLL))
    body = torch.zeros(groups * THREADS * UNROLL * 4)
    body[:4 * vec4s] = seg[head:head + 4 * vec4s]
    body = body.reshape(groups, UNROLL, THREADS, 4)
    for k in range(groups):
        for c in range(4):
            acc = _fma_sq(body[k, :, :, c], acc)
    tail = seg[head + 4 * vec4s:]
    acc[1, :tail.numel()] = _fma_sq(tail, acc[1, :tail.numel()])
    per_thread = acc[0]
    for u in range(1, UNROLL):
        per_thread = per_thread + acc[u]
    return _block_reduce(per_thread)


def _cluster_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Σx² per row as the kernel's launch sums it, in f32: the plan's
    blocks of a row each take their column range, split as
    :func:`sumsq_segments` gives it for the row's real alignment; a
    cluster's rank 0 adds the partials 1..C-1 to its own in rank order,
    and the split plan's second pass has thread t add partials t,
    t + 256, ... in order from 0, then :func:`_block_reduce` the threads.
    The segments must tile the row exactly."""
    r, p = x.shape
    plan = t_dp.sumsq_plan(r, p)
    out = torch.empty(r)
    for row in range(r):
        start = x.data_ptr() % 16 // 4 + row * p
        segs = t_dp.sumsq_segments(plan, p, start)
        lo, parts = 0, []
        for rank, (head, vec4s, tail) in enumerate(segs):
            n = head + 4 * vec4s + tail
            assert lo == min(rank * plan.chunk, p) and head < 4 and tail < 4
            if vec4s:
                assert (start + lo + head) % 4 == 0  # 16-byte loads aligned
            parts.append(_block_sum(x[row, lo:lo + n], head, vec4s))
            lo += n
        assert lo == p
        if plan.split > 1:
            per_thread = torch.zeros(THREADS)
            for i, part in enumerate(parts):
                per_thread[i % THREADS] = per_thread[i % THREADS] + part
            out[row] = _block_reduce(per_thread)
        else:
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            out[row] = total
    return out


@pytest.mark.parametrize("case", SQ_CASES, ids=str)
def test_sumsq_cluster_mirror_matches_plain(case):
    """Every shape ``chip_smoke.py`` launches, at its offset from a 16-byte
    boundary: the mirrored cluster order covers each row once and agrees
    with the plain version at rtol 1e-5."""
    x = _rows(case)
    np.testing.assert_allclose(_cluster_sumsq(x).numpy(),
                               t_ref.sumsq_rows_ref(x).numpy(), rtol=1e-5)


@pytest.mark.parametrize("case", [c for c in SQ_CASES if c[0] <= 8],
                         ids=str)
def test_sumsq_cluster_mirror_matches_interpret_pallas(case):
    """The mirrored cluster order against the JAX package's ``sumsq`` in
    interpret mode, row by row, at rtol 1e-5."""
    x = _rows(case)
    got = _cluster_sumsq(x).numpy()
    want = np.asarray([float(j_sumsq(jnp.asarray(row.numpy())))
                       for row in x])
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("case", SQ_CASES + [
    (131, 64, 0), (132, 64, 0), (33, 8, 0), (65535, 3, 0),
    (1, 1_796_280_320, 0), (16, 8_388_609, 0), (17, 10 ** 9, 0),
], ids=str)
def test_sumsq_plan_fits_the_card(case):
    """The fewest blocks a row (1, 2, 4 or 8: one portable cluster) for
    which the rows cover the H100's 132 SMs, 8 when none does, unless 8
    leave SMs idle with over 2^20 columns a block: then the split plan,
    ceil(528 / r) blocks a row; columns in multiples of 4 that cover the
    row; rows within the grid's y limit."""
    r, p, _ = case
    plan = t_dp.sumsq_plan(r, p)
    if plan.split > 1:
        assert plan.cluster == 1 and r * 8 < 132
        assert -(-p // 8) > t_dp.SPLIT_MIN_CHUNK
        assert plan.split == -(-528 // r) and r * plan.split >= 528
    else:
        assert plan.cluster in (1, 2, 4, 8) and r <= 65535
        assert r * plan.cluster >= 132 or plan.cluster == 8
        assert plan.cluster == 1 or r * (plan.cluster // 2) < 132
    assert plan.chunk % 4 == 0 and plan.chunk >= 4
    assert plan.chunk * plan.blocks >= p > plan.chunk * plan.blocks - \
        4 * plan.blocks - plan.blocks
    if (r, p) == (CS.SLICE_ROWS, CS.SLICE_P):
        assert plan.cluster == 4  # 160 blocks on the paper's 40 clients
    if r >= 132:
        assert plan.cluster == 1
    if p == 1_796_280_320:  # granite's update at 8 layers
        assert plan == t_dp.SumsqPlan(1, 3_402_048, 528)


def test_chip_smoke_sumsq_cases_run_every_branch():
    """``chip_smoke.py``'s sumsq cases reach a cluster of blocks a row, one
    block a row and the split plan, and blocks with a scalar head, 16-byte
    loads, a scalar tail and no columns at all."""
    branches = set()
    for case in SQ_CASES:
        x = _rows(case)
        assert x.data_ptr() % 16 == 4 * case[2]
        branches |= CS.sumsq_branches(t_dp, x)
    assert CS.SQ_BRANCHES <= branches, CS.SQ_BRANCHES - branches
