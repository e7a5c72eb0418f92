"""The ``sumsq_rows`` CUDA kernel's launch plan and cluster order on the
CPU.

The kernel (``csrc/dp_clip_noise.cu``, ``sumsq_rows_cluster_kernel``)
cannot run here; ``chip_smoke.py`` holds it against the plain version on
the card.  These tests mirror in torch the order it sums in — a cluster of
C blocks a row under :func:`sumsq_plan`, each block's column range read as
a scalar head up to a 16-byte boundary, 16-byte loads and a scalar tail
(:func:`sumsq_segments`), the block partials added in rank order — and
hold the mirror to the port's plain version and the JAX package's
interpret-mode Pallas ``sumsq`` at rtol 1e-5.  The plan is held to the
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


def _block_sum(seg: torch.Tensor, head: int, vec4s: int) -> torch.Tensor:
    """One block's partial in the kernel's grouping: thread t squares its
    head element, float4s t, t + 256, ... into accumulator (j // 256) % 4,
    and its tail element; the accumulators, then the threads, are added."""
    sq = seg * seg
    acc = torch.zeros(THREADS, UNROLL)
    acc[:head, 0] += sq[:head]
    body = sq[head:head + 4 * vec4s].reshape(vec4s, 4).sum(1)
    j = torch.arange(vec4s)
    acc.index_put_((j % THREADS, (j // THREADS) % UNROLL), body,
                   accumulate=True)
    tail = sq[head + 4 * vec4s:]
    acc[:tail.numel(), 1] += tail
    return acc.sum(1).sum()


def _cluster_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Σx² per row as the kernel's launch sums it: the plan's C blocks of a
    row each take their column range, split as :func:`sumsq_segments`
    gives it for the row's real alignment, and the C partials are added in
    rank order.  The segments must tile the row exactly."""
    r, p = x.shape
    plan = t_dp.sumsq_plan(r, p)
    out = torch.empty(r)
    for row in range(r):
        start = x.data_ptr() % 16 // 4 + row * p
        segs = t_dp.sumsq_segments(plan, p, start)
        lo, total = 0, torch.zeros(())
        for rank, (head, vec4s, tail) in enumerate(segs):
            n = head + 4 * vec4s + tail
            assert lo == min(rank * plan.chunk, p) and head < 4 and tail < 4
            if vec4s:
                assert (start + lo + head) % 4 == 0  # 16-byte loads aligned
            total = total + _block_sum(x[row, lo:lo + n], head, vec4s)
            lo += n
        assert lo == p
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
], ids=str)
def test_sumsq_plan_fits_the_card(case):
    """The fewest blocks a row (1, 2, 4 or 8: one portable cluster) for
    which the rows cover the H100's 132 SMs, 8 when none does; columns in
    multiples of 4 that cover the row; rows within the grid's y limit."""
    r, p, _ = case
    plan = t_dp.sumsq_plan(r, p)
    assert plan.cluster in (1, 2, 4, 8) and r <= 65535
    assert r * plan.cluster >= 132 or plan.cluster == 8
    assert plan.cluster == 1 or r * (plan.cluster // 2) < 132
    assert plan.chunk % 4 == 0 and plan.chunk >= 4
    assert plan.chunk * plan.cluster >= p > plan.chunk * plan.cluster - \
        4 * plan.cluster - plan.cluster
    if (r, p) == (CS.SLICE_ROWS, CS.SLICE_P):
        assert plan.cluster == 4  # 160 blocks on the paper's 40 clients
    if r >= 132:
        assert plan.cluster == 1


def test_chip_smoke_sumsq_cases_run_every_branch():
    """``chip_smoke.py``'s sumsq cases reach a cluster of blocks a row and
    one block a row, and blocks with a scalar head, 16-byte loads, a scalar
    tail and no columns at all."""
    branches = set()
    for case in SQ_CASES:
        x = _rows(case)
        assert x.data_ptr() % 16 == 4 * case[2]
        branches |= CS.sumsq_branches(t_dp, x)
    assert CS.SQ_BRANCHES <= branches, CS.SQ_BRANCHES - branches
