"""The ``rglru_scan`` CUDA kernel's launch plan and tiling on the CPU.

The kernel (``csrc/rglru_scan.cu``, ``rglru_scan_tiles_kernel``) cannot run
here; ``chip_smoke.py`` holds it against the plain version on the card.
These tests mirror in torch what its launch does — which thread owns which
lanes of which row under :func:`launch_plan`, and the register tiles each
thread walks, ragged last tile included — and hold the mirror bitwise to
the port's plain version and, at 1e-6, to the JAX package's interpret-mode
Pallas kernel (not bitwise: XLA on the CPU fuses ``a·h + x`` into an FMA).
The plan is held to the card's limits for every shape ``chip_smoke.py``
launches, and those launches are shown to run every branch of the kernel.
Inputs come from a NumPy seed.
"""
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import rglru_scan as j_rglru_scan

from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import rglru_scan as t_rg

torch.set_num_threads(1)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
RG_CASES = CS.RG_CASES


def _tile_schedule(l: int, tile: int):
    """The steps each thread walks, tile by tile, as the kernel's ping-pong
    loop does: ``[(t0, n)]`` with n = min(tile, l - t0)."""
    out, t0 = [], 0
    while True:
        out.append((t0, min(tile, l - t0)))
        t0 += tile
        if t0 >= l:
            return out


def _tiled_scan(a, x, h0, plan):
    """The kernel's launch in torch f32: every thread (x, y) of every block
    owns lanes ``w0 .. w0 + vec`` of row b, with b and w0 from the block and
    grid as the kernel computes them; it walks the tiles of
    :func:`_tile_schedule` with ``s = a·s + x`` (product and sum rounded
    apart, in t order) and stores each step's h and, at the end, h_last.
    Every lane must have exactly one owner."""
    b, l, w = a.shape
    (tx, ty), (gx, gy) = plan.block, plan.grid
    rows = torch.arange(gy * ty).repeat_interleave(gx * tx)
    w0 = (torch.arange(gx * tx) * plan.vec).repeat(gy * ty)
    keep = (rows < b) & (w0 < w)
    cols = w0[keep][:, None] + torch.arange(plan.vec)[None]
    rows = rows[keep][:, None].expand_as(cols)
    owners = torch.zeros(b, w, dtype=torch.int64)
    owners.index_put_((rows, cols), torch.ones_like(cols), accumulate=True)
    assert torch.equal(owners, torch.ones(b, w, dtype=torch.int64))
    s = torch.zeros(cols.shape) if h0 is None else h0[rows, cols]
    h = torch.full_like(a, float("nan"))
    steps = []
    for t0, n in _tile_schedule(l, plan.tile):
        for t in range(t0, t0 + n):
            steps.append(t)
            s = a[rows, t, cols] * s + x[rows, t, cols]
            h[rows, t, cols] = s
    assert steps == list(range(l))
    h_last = torch.full((b, w), float("nan"))
    h_last[rows, cols] = s
    return h, h_last


@functools.lru_cache(maxsize=None)
def _inputs(case):
    b, l, w, with_h0 = case
    rng = np.random.default_rng(b * 1000 + l * 10 + w)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, l, w))))).astype(
        np.float32)
    x = rng.standard_normal((b, l, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    return a, x, h0


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", RG_CASES, ids=str)
def test_rglru_scan_tiled_mirror_is_bitwise_the_plain_version(case, aligned):
    """Every shape ``chip_smoke.py`` launches, with its plan for aligned and
    unaligned pointers: the mirrored launch covers every lane once and
    every step in order, and gives the plain version's bits."""
    a, x, h0 = (None if v is None else torch.as_tensor(v)
                for v in _inputs(case))
    b, l, w, _ = case
    plan = t_rg.launch_plan(b, l, w, aligned)
    h, h_last = _tiled_scan(a, x, h0, plan)
    h_ref, hl_ref = t_ref.rglru_scan_ref(a, x, h0)
    assert torch.equal(h, h_ref) and torch.equal(h_last, hl_ref)


@pytest.mark.parametrize("case", [c for c in RG_CASES if c[0] <= 128],
                         ids=str)
def test_rglru_scan_tiled_mirror_matches_interpret_pallas(case):
    """The mirrored launch against the JAX package's Pallas kernel in
    interpret mode, at 1e-6 (XLA on the CPU fuses an FMA)."""
    a, x, h0 = _inputs(case)
    b, l, w, _ = case
    plan = t_rg.launch_plan(b, l, w, True)
    h, h_last = _tiled_scan(torch.as_tensor(a), torch.as_tensor(x),
                            None if h0 is None else torch.as_tensor(h0), plan)
    jh, jhl = j_rglru_scan(jnp.asarray(a), jnp.asarray(x),
                           None if h0 is None else jnp.asarray(h0),
                           interpret=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jhl), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", RG_CASES + [
    (1, 1, 1, False),             # one lane, one step
    (65535, 2, 4, False),         # many rows: a block packs 256 of them
    (1, 4096, 3, True),           # a long call on three lanes
    (3, 4, 1_000_001, False),     # a row wider than one block
], ids=str)
def test_rglru_scan_launch_plan_fits_the_card(case, aligned):
    """Every launch ``chip_smoke.py`` makes and a few edge shapes stay
    within 256 threads a block and the grid's limits, cover every (row,
    lane) exactly once with no idle block, and take 4 lanes a thread (16-
    byte loads) only for a one-tile call whose loads may be 16 bytes."""
    b, l, w, _ = case
    plan = t_rg.launch_plan(b, l, w, aligned)
    (tx, ty), (gx, gy) = plan.block, plan.grid
    assert 1 <= tx * ty <= 256
    assert plan.vec == (4 if l <= 4 and w % 4 == 0 and aligned else 1)
    assert plan.tile == 16 // plan.vec
    assert gx * tx * plan.vec >= w > (gx - 1) * tx * plan.vec
    assert gy * ty >= b > (gy - 1) * ty
    assert gx < 2 ** 31 and gy <= 65535
    assert ty == 1 or tx * plan.vec >= w  # packed rows are whole rows
    if case == CS.RG_PATH and aligned:
        assert (plan.vec, plan.block, plan.grid) == (4, (128, 1), (1, 128))
    if case == CS.RG_RGLRU:
        assert (plan.vec, plan.block, plan.grid) == (1, (16, 2), (1, 64))


def test_rglru_scan_launch_plan_refuses_too_many_rows():
    """Rows past the grid's 65,535 row tiles are refused, not wrapped."""
    with pytest.raises(ValueError, match="row tiles"):
        t_rg.launch_plan(65535 * 256 + 1, 8, 1, True)


def test_chip_smoke_scan_cases_run_every_branch():
    """``chip_smoke.py``'s scan cases, dense and one element off 16-byte
    alignment, reach every branch of the kernel's plan (4 lanes with 16-byte
    loads, 1 lane with 4-byte loads; one row a block or rows packed; one,
    two or more tiles, a ragged tile, idle threads, with and without h0),
    and the misaligned copies hand the wrapper the same values."""
    branches = set()
    for case in RG_CASES:
        a, x, h0 = (None if v is None else torch.as_tensor(v)
                    for v in _inputs(case))
        off = tuple(None if t is None else CS.offset_copy(torch, t, 1)
                    for t in (a, x, h0))
        assert all(t.data_ptr() % 16 == 4 for t in off if t is not None)
        got = t_ref.rglru_scan_ref(*off)
        want = t_ref.rglru_scan_ref(a, x, h0)
        assert all(torch.equal(g, z) for g, z in zip(got, want))
        for layout in ((a, x, h0), off):
            branches |= CS.scan_branches(t_rg, case, all(
                t.data_ptr() % 16 == 0 for t in layout if t is not None))
    assert CS.RG_BRANCHES <= branches, CS.RG_BRANCHES - branches
