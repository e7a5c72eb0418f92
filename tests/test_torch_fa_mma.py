"""The tensor-core ``flash_attention`` kernel's order, mirrored in torch.

``csrc/flash_attention.cu``'s ``flash_attention_mma_kernel`` (bf16 at head
dims 33-256) cannot run here; ``chip_smoke.py`` holds it against the plain
version on the card.  These tests mirror its arithmetic on the CPU: the
blocks and warps of :func:`launch_plan` (64 positions of one head a block,
warps of 16), the key tiles each warp computes (:func:`_walk`, a Python
copy of the kernel's walk: the staged range and the tiles a warp skips),
scores in f32 scaled by 1/sqrt(D)·log2(e) after the dot, an online softmax
per tile with exp2, P in two bf16 terms (bf16(P) and the rest rounded),
l summing the f32 weights, f32 O divided by max(l, 1e-30).  The mirror is
held against ``ref.flash_attention_ref`` and the reference's Pallas kernel
in interpret mode at the bf16 bar (2e-2), and, with P unrounded on f32
inputs, at f32's 2e-5, so that a wrong skip of a tile shows.  The walk is
the mirror's, not the kernel's: the card's phase 8 holds the kernel's
output on the same cases.  Inputs come from a NumPy seed.
"""
import functools
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash_attention

from repro_torch.kernels import _nvcc
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _walk(plan, s, t, causal, window):
    """The kernel's walk over the key tiles, in Python: for each block's
    first query position ``p0``, ``(p0, (tile0, tile1), warps)``.
    ``[tile0, tile1)`` are the key tiles the block stages: from its first
    row's window start to its last row's causal limit when every row has a
    valid key, else all of them.  ``warps`` lists ``(first position, tiles
    it computes)`` for each warp of 16 rows with a row below ``s``; a warp
    skips a tile that masks every row of it once each has a valid key."""
    bk, rows, offset, w = plan.key_tile, plan.rows, t - s, window or 0
    out = []
    for p0 in range(0, s, rows):
        pmin, pmax = p0 + offset, min(p0 + rows, s) - 1 + offset
        all_valid = not causal or pmin >= 0
        kbeg = max(0, pmin - w + 1) if all_valid and w > 0 else 0
        kend = min(t, pmax + 1) if all_valid and causal else t
        tiles = (kbeg // bk, -(-kend // bk))
        warps = []
        for wp0 in range(p0, min(p0 + rows, s), 16):
            wmin, wmax = wp0 + offset, wp0 + 15 + offset
            w_valid = not causal or wmin >= 0
            warps.append((wp0, [
                j for j in range(*tiles) if not (w_valid and (
                    (causal and j * bk > wmax)
                    or (w > 0 and j * bk + bk - 1 <= wmin - w)))]))
        out.append((p0, tiles, warps))
    return out


def _mma_mirror(q, k, v, causal, window, plan, split=True):
    """The kernel's order in torch: for each head and each warp of
    ``plan``, the tiles :func:`_walk` gives, scores ``(q·k)·(scale·log2
    e)`` in f32 with masked keys at −1e30, an online softmax per tile, P
    in two bf16 terms (``split``; else f32 P), l summing the f32 P."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qk_scale = (torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
                * torch.tensor(LOG2E, dtype=torch.float32))
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(b, s, hq, d)
    offset, bk = t - s, plan.key_tile
    walk = _walk(plan, s, t, causal, window)
    for h in range(hq):
        kh = h // group
        for _, _, warps in walk:
            for wp0, tiles in warps:
                n = min(16, s - wp0)
                pos = torch.arange(wp0, wp0 + n) + offset
                qw = qf[:, wp0:wp0 + n, h]
                m = torch.full((b, n), NEG_INF)
                l = torch.zeros(b, n)
                acc = torch.zeros(b, n, d)
                for j in tiles:
                    keys = torch.arange(j * bk, min((j + 1) * bk, t))
                    sc = torch.einsum("bnd,bkd->bnk", qw,
                                      kf[:, keys, kh]) * qk_scale
                    valid = torch.ones(n, len(keys), dtype=torch.bool)
                    if causal:
                        valid &= keys[None] <= pos[:, None]
                    if window is not None:
                        valid &= keys[None] > pos[:, None] - window
                    sc = torch.where(valid, sc, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(sc - m_new[..., None])
                    weights = p
                    if split:
                        hi = p.to(torch.bfloat16).float()
                        weights = hi + (p - hi).to(torch.bfloat16).float()
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "bnk,bkd->bnd", weights, vf[:, keys, kh])
                    m = m_new
                out[:, wp0:wp0 + n, h] = \
                    acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


# (b, s, t, hq, hkv, d, causal, window)
MMA_CASES = [
    (1, 96, 64, 4, 1, 128, True, None),    # S > T: rows with no valid key
    (2, 40, 100, 8, 2, 96, True, None),    # T > S (prefix), GQA 4 packed
    (1, 100, 100, 4, 4, 64, True, None),   # S ragged, one head a block
    (1, 130, 130, 4, 2, 128, True, 16),    # window shorter than a key tile
    (1, 70, 90, 2, 2, 36, False, None),    # non-causal, D padded to 64
    (1, 80, 80, 4, 1, 256, True, 24),      # D = 256 (32-key tiles), MQA
    (1, 48, 40, 2, 1, 256, True, None),    # D = 256, S > T
]


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inputs(case, dtype):
    """q, k, v from a NumPy seed in ``dtype``, the plain version on them,
    and (bf16) the interpret-mode Pallas kernel on the same values."""
    b, s, t, hq, hkv, d, causal, window = case
    rng = np.random.default_rng(b * 1000 + s + t + d)
    arrays = (_normal(rng, (b, s, hq, d)), _normal(rng, (b, t, hkv, d)),
              _normal(rng, (b, t, hkv, d)))
    tq, tk, tv = (torch.as_tensor(a).to(dtype) for a in arrays)
    plain = t_ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                      window=window)
    kern = None
    if dtype == torch.bfloat16:
        jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
        kern = torch.as_tensor(np.array(j_flash_attention(
            jq, jk, jv, causal=causal, window=window, bq=s, bk=t,
            interpret=True).astype(jnp.float32)))
    return (tq, tk, tv), plain, kern


@pytest.mark.parametrize("case", MMA_CASES, ids=str)
def test_mma_mirror_matches_plain_and_pallas(case):
    """The mirror at the kernel's plan against the plain version and the
    Pallas kernel (interpret mode) at bf16's 2e-2; rows with no valid key
    average v."""
    _, _, _, hq, hkv, d, causal, window = case
    (tq, tk, tv), plain, kern = _inputs(case, torch.bfloat16)
    plan = t_fa.launch_plan(*case[:6], torch.bfloat16, True)
    assert plan.kernel == "mma"
    out = _mma_mirror(tq, tk, tv, causal, window, plan)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    for want in (plain.float(), kern):
        np.testing.assert_allclose(out.float().numpy(), want.numpy(),
                                   atol=2e-2, rtol=2e-2)
    err = float((out.float() - plain.float()).abs().max())
    print(f"{case} P in two bf16 terms: max|err| vs plain {err:.2e}")
    if case[1] > case[2] and causal:  # rows before the first key: mean of v
        n_empty = case[1] - case[2]
        mean_v = tv.float().mean(1).repeat_interleave(hq // hkv, dim=1)
        np.testing.assert_allclose(
            out[:, :n_empty].float().numpy(),
            mean_v[:, None].expand(-1, n_empty, -1, -1).numpy(),
            atol=2e-2, rtol=2e-2)


# beyond MMA_CASES: granite's heads, recurrentgemma's windowed MQA, S > T
# with a window
WALK_CASES = MMA_CASES + [
    (2, 512, 512, 32, 8, 128, True, None),
    (1, 300, 300, 16, 1, 256, True, 64),
    (1, 200, 136, 4, 2, 64, True, 40),
]


@pytest.mark.parametrize("case", MMA_CASES + WALK_CASES[-1:], ids=str)
def test_mma_walk_skips_nothing_a_row_needs(case):
    """On f32 inputs with P unrounded, the mirror equals the plain version
    at f32's 2e-5: the tiles the walk leaves out add nothing."""
    b, s, t, hq, hkv, d, causal, window = case
    (tq, tk, tv), plain, _ = _inputs(case, torch.float32)
    plan = t_fa.launch_plan(b, s, t, hq, hkv, d, torch.bfloat16, True)
    out = _mma_mirror(tq, tk, tv, causal, window, plan, split=False)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_mma_walk_covers_every_valid_key(case):
    """Each warp's tiles hold every valid key of each of its rows; a row
    with no valid key gets every tile; the staged range holds them all; a
    tile a warp skips masks all its rows."""
    b, s, t, hq, hkv, d, causal, window = case
    plan = t_fa.launch_plan(b, s, t, hq, hkv, d, torch.bfloat16, True)
    bk, n_tiles = plan.key_tile, -(-t // plan.key_tile)
    seen = set()
    for p0, (tile0, tile1), warps in _walk(plan, s, t, causal, window):
        assert 0 <= tile0 < tile1 <= n_tiles
        for wp0, tiles in warps:
            assert set(tiles) <= set(range(tile0, tile1))
            for row in range(wp0, min(wp0 + 16, s)):
                seen.add(row)
                pos = row + t - s
                valid = [j for j in range(t) if (not causal or j <= pos)
                         and (window is None or j > pos - window)]
                want = ({j // bk for j in valid} if valid
                        else set(range(n_tiles)))
                assert want <= set(tiles), (p0, row)
    assert seen == set(range(s))


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_mma", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the tensor-core kernel's branches that chip_smoke.py's bf16 cases at
# D > 32 must reach
MMA_BRANCHES = {"staged range cut", "warp skips a tile", "ragged rows",
                "ragged key tile", "rows with no valid key", "prefix offset",
                "non-causal", "window shorter than a key tile", "GQA", "MQA",
                "padded D", "2-byte copies", "DMAX 64", "DMAX 96",
                "DMAX 128", "DMAX 256"}


def _branches(case) -> set:
    """The branches a bf16 case at D > 32 takes, from its launch plan and
    :func:`_walk`."""
    b, s, t, hq, hkv, d, causal, window = case
    plan = t_fa.launch_plan(b, s, t, hq, hkv, d, torch.bfloat16, True)
    walk = _walk(plan, s, t, causal, window)
    all_tiles = (0, -(-t // plan.key_tile))
    out = {f"DMAX {plan.dmax}"}
    if any(tiles != all_tiles for _, tiles, _ in walk):
        out.add("staged range cut")
    if any(len(comp) < tiles[1] - tiles[0]
           for _, tiles, warps in walk for _, comp in warps):
        out.add("warp skips a tile")
    for cond, name in ((s % plan.rows, "ragged rows"),
                       (t % plan.key_tile, "ragged key tile"),
                       (causal and s > t, "rows with no valid key"),
                       (t > s, "prefix offset"),
                       (not causal, "non-causal"),
                       (window is not None and window < plan.key_tile,
                        "window shorter than a key tile"),
                       (1 < hq // hkv < hq, "GQA"),
                       (hkv == 1 < hq, "MQA"),
                       (d < plan.dmax, "padded D"),
                       (plan.copy_width == 2, "2-byte copies")):
        if cond:
            out.add(name)
    return out


def test_chip_smoke_cases_reach_every_branch_of_the_mma_kernel():
    """``chip_smoke.py``'s bf16 cases at D > 32 reach every branch of the
    tensor-core kernel's walk (as :func:`_walk` mirrors it) and plan."""
    reached = set().union(*(_branches(case) for case in _chip_smoke().FA_CASES
                            if case[5] > 32))
    assert reached == MMA_BRANCHES


def test_mma_plan_limits_and_refusals():
    """The plan's own limits: 64 positions of one head a block (4 warps),
    the key tile and shared memory of each DMAX within the opt-in, y and z
    within 65,535; f32 above D = 128 is refused, and only K3 takes D = 256
    (flash_decode keeps 128)."""
    for d, dmax, key_tile in ((36, 64, 64), (96, 96, 64), (128, 128, 64),
                              (200, 256, 32)):
        plan = t_fa.launch_plan(3, 100, 80, 8, 2, d, torch.bfloat16, True)
        assert (plan.kernel, plan.dmax, plan.rows, plan.heads,
                plan.threads, plan.key_tile, plan.grid) == \
            ("mma", dmax, 64, 1, 128, key_tile, (8, 3, 2))
        assert plan.smem_bytes == t_fa.mma_smem_bytes(dmax) \
            <= t_fa.MAX_SMEM_OPTIN == 227 * 1024
    with pytest.raises(ValueError, match="grid"):
        t_fa.launch_plan(1, 65535 * 64 + 1, 64, 1, 1, 64, torch.bfloat16,
                         True)
    with pytest.raises(ValueError, match="f32"):
        t_fa.launch_plan(1, 64, 64, 2, 1, 256, torch.float32, True)
    assert t_fa.MAX_HEAD_DIM == 256 and t_fd.MAX_HEAD_DIM == 128


def test_nvcc_build_name_hashes_the_headers(tmp_path, monkeypatch):
    """A library's name changes with its source and with any header
    beside it, so an edited header is never served from a stale build."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_nvcc, "CSRC", tmp_path)
    first = _nvcc._lib_path("k")
    assert first == _nvcc._lib_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _nvcc._lib_path("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert len({first, second, _nvcc._lib_path("k")}) == 3
