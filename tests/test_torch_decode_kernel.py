"""The ``flash_decode`` CUDA kernel's algorithm and launch plan on the CPU.

The kernel (``csrc/flash_decode.cu``, ``flash_decode_lanes_kernel``) cannot
run here; ``chip_smoke.py`` holds it against the plain version on the card.
These tests mirror its arithmetic in torch — G lanes splitting each key
tile, a softmax per tile in the exp2 domain, the xor-butterfly merge — and
hold the mirror against the port's plain version and the JAX package's
interpret-mode Pallas kernel, for the plan's G = 32 and for G = 1 to 16.
The launch plan is held to the card's limits for every shape
``chip_smoke.py`` launches, and those launches are shown to run every
staging branch of the kernel.  Inputs come from a NumPy seed.
"""
import functools
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as j_flash_decode

from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30


def _lane_split_decode(q, k, v, length, lanes, key_tile=64):
    """The arithmetic of ``flash_decode_lanes_kernel`` in torch f32:
    scale·log2(e) folded into q; ``lanes`` lanes per (row, q head), lane g
    taking keys t0 + g, t0 + g + G, ... of each tile of ``key_tile`` keys; a
    position t ≥ length scores −1e30 and takes part in the max; per tile
    one max, one rescale of (l, acc), then p·v with ``exp2``; the lane states
    merged in the xor butterfly with products and sums rounded apart, so
    that every lane ends with the same bits (checked).  Returns
    ``(o, m, l)`` with m in natural-log units (−1e30 kept exactly)."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qscale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * LOG2E
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bhd,bthd->bht", q.float() * qscale, kf)
    valid = torch.arange(t)[None] < length[:, None]
    scores = torch.where(valid[:, None], scores, torch.tensor(NEG_INF))
    m = torch.full((b, hq, lanes), NEG_INF)
    l = torch.zeros(b, hq, lanes)
    acc = torch.zeros(b, hq, lanes, d)
    for t0 in range(0, t, key_tile):
        for g in range(lanes):
            idx = torch.arange(t0 + g, min(t0 + key_tile, t), lanes)
            if idx.numel() == 0:
                continue
            sc = scores[..., idx]
            m_new = torch.maximum(m[..., g], sc.amax(-1))
            alpha = torch.exp2(m[..., g] - m_new)
            p = torch.exp2(sc - m_new[..., None])
            l[..., g] = l[..., g] * alpha + p.sum(-1)
            acc[..., g, :] = (acc[..., g, :] * alpha[..., None]
                              + torch.einsum("bhn,bnhd->bhd", p, vf[:, idx]))
            m[..., g] = m_new
    off = 1
    while off < lanes:
        partner = torch.arange(lanes) ^ off
        m_o, l_o = m[..., partner], l[..., partner]
        acc_o = acc[..., partner, :]
        m_new = torch.maximum(m, m_o)
        a, c = torch.exp2(m - m_new), torch.exp2(m_o - m_new)
        l = l * a + l_o * c
        acc = acc * a[..., None] + acc_o * c[..., None]
        m = m_new
        off *= 2
    assert torch.equal(l[..., :1].expand_as(l), l)
    assert torch.equal(acc[..., :1, :].expand_as(acc), acc)
    o = acc[..., 0, :] / torch.clamp(l[..., 0], min=1e-30)[..., None]
    m0 = m[..., 0]
    m_nat = torch.where(m0 == NEG_INF, m0, m0 * LN2)
    return o, m_nat, l[..., 0]


# (b, hq, hkv, d, t, lengths)
MIRROR_CASES = [
    (128, 2, 2, 8, 64, (64,) * 128),      # the attn read-out's path shape
    (2, 8, 2, 16, 128, (100, 128)),       # GQA: 8 q heads over 2 kv heads
    (3, 4, 1, 32, 64, (17, 1, 64)),       # MQA, short prefixes
    (3, 2, 2, 8, 64, (0, 40, 64)),        # a row of length 0
    (2, 4, 2, 8, 100, (100, 77)),         # T = 100: a ragged last tile
    (2, 4, 1, 16, 512, (512, 300)),       # T = 512: several tiles
]


@functools.lru_cache(maxsize=None)
def _mirror_inputs(case):
    """Inputs from a NumPy seed, the port's plain version and the
    interpret-mode Pallas kernel on them (each computed once)."""
    b, hq, hkv, d, t, lengths = case
    rng = np.random.default_rng(b * 1000 + hq * 100 + t + d)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    length = np.asarray(lengths, np.int32)
    tq, tk, tv, tl = (torch.as_tensor(x) for x in (q, k, v, length))
    plain = t_ref.flash_decode_ref(tq, tk, tv, tl, return_partials=True)
    kern = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(length), interpret=True,
                          return_partials=True)
    return (tq, tk, tv, tl), plain, tuple(np.asarray(x) for x in kern)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("case", MIRROR_CASES, ids=str)
def test_flash_decode_lane_split_mirror(case, lanes):
    """The CUDA kernel's algorithm, mirrored in torch, against the port's
    plain version and the interpret-mode Pallas kernel at f32 2e-5 in o, m
    and l.  A row of length 0 gives m = −1e30 and l = T exactly and o the
    mean of v, as the TPU kernel's −1e30 masking gives."""
    (tq, tk, tv, tl), plain, kern = _mirror_inputs(case)
    got = _lane_split_decode(tq, tk, tv, tl, lanes)
    for mine, want, theirs in zip(got, plain, kern):
        np.testing.assert_allclose(mine.numpy(), want.numpy(), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(mine.numpy(), theirs, atol=2e-5,
                                   rtol=2e-5)
    empty = tl == 0
    if empty.any():
        o, m, l = got
        t, group = tk.shape[1], tq.shape[1] // tk.shape[2]
        assert (m[empty] == np.float32(NEG_INF)).all()
        assert (l[empty] == t).all()
        mean_v = tv.float().mean(1).repeat_interleave(group, dim=1)
        np.testing.assert_allclose(o[empty].numpy(), mean_v[empty].numpy(),
                                   atol=2e-5, rtol=2e-5)


def _chip_smoke_fd_cases():
    """``FD_CASES`` of ``chip_smoke.py``: the shapes the card launches."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FD_CASES, mod.FD_PATH


FD_CASES, FD_PATH = _chip_smoke_fd_cases()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FD_CASES + [
    (1, 1, 1, 1, 1, 1),                    # D = 1, T = 1
    (2, 64, 1, 32, 300, 300),              # 64 q heads over 1 kv head
    (3, 64, 64, 20, 77, 77),               # 64 kv heads, odd D
    (65535, 2, 1, 12, 9, 9),               # the largest batch
], ids=str)
def test_flash_decode_launch_plan_fits_the_card(case, dtype, aligned):
    """Every launch ``chip_smoke.py`` makes and a few edge shapes stay
    within 1,024 threads of whole warps, 48 KB of static shared memory a
    block and the grid's limits; the lanes of a (row, head) are one warp,
    each lane's chain is 2 keys a tile, and the grid covers every
    (row, q head) once."""
    b, hq, hkv, d, t, _ = case
    esize = 2 if dtype == torch.bfloat16 else 4
    group = hq // hkv
    plan = t_fd.launch_plan(b, t, hq, hkv, d, dtype, aligned)
    assert plan.threads <= 1024 and plan.smem_bytes <= 48 * 1024
    assert math.prod(plan.block) == plan.threads
    assert plan.grid[0] < 2 ** 31 and max(plan.grid[1:]) <= 65535
    if d > 32:  # a block per (row, q head), a thread per key
        assert (plan.lanes, plan.threads, plan.grid) == (1, 128, (hq, b, 1))
        return
    assert plan.lanes == 32 and plan.key_tile == 64
    assert plan.threads == plan.heads * plan.lanes
    assert plan.threads <= (512 if plan.dmax <= 16 else 256)
    assert plan.dmax >= d and plan.dmax <= plan.lanes
    assert plan.heads % group == 0 or group % plan.heads == 0
    assert plan.kv_heads == max(plan.heads // group, 1)
    n_buf = 2 if t > plan.key_tile else 1
    assert plan.smem_bytes == n_buf * 2 * plan.key_tile * plan.kv_heads * \
        plan.dmax * esize
    assert plan.copy_width == (16 if aligned and d * esize % 16 == 0
                               else esize)
    # block (q heads of a kv head × G, kv heads, 1), grid (rows, kv-head
    # tiles, parts of a group); the grid covers each (row, q head) once
    per_kv = plan.block[0] // plan.lanes
    assert plan.block[1] == plan.kv_heads and plan.block[2] == 1 and \
        per_kv * plan.kv_heads == plan.heads
    assert plan.grid[0] == b
    heads = []
    for by in range(plan.grid[1]):
        for bz in range(plan.grid[2]):
            for ty in range(plan.kv_heads):
                for hh in range(per_kv):
                    h = (by * plan.kv_heads + ty) * group + bz * per_kv + hh
                    assert h // group == by * plan.kv_heads + ty
                    heads.append(h)
    assert sorted(heads) == list(range(hq))
    if case == FD_PATH:  # every q head of a row in one block, 128 blocks
        assert (plan.heads, plan.kv_heads, plan.grid) == (2, 2, (b, 1, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_chip_smoke_decode_layouts_run_every_staging_branch(dtype):
    """``chip_smoke.py``'s decode cases in its four layouts (dense, q
    broadcast, q strided, all three unaligned) reach, per dtype, a flat and
    a key-row-by-key-row staging with 16-byte copies and with element
    copies, and the layouts hand the wrapper the inputs unchanged: the
    plain version gives the same outputs in each."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", Path(__file__).resolve().parent.parent /
        "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    esize = 2 if dtype == torch.bfloat16 else 4
    branches = set()
    for case in FD_CASES:
        b, hq, hkv, d, t, lengths = case
        rng = np.random.default_rng(b * 1000 + hq * 100 + t + d)
        q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32)
                                   ).to(dtype)
                   for s in ((b, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
        ln = torch.as_tensor(np.broadcast_to(np.asarray(lengths, np.int32),
                                             (b,)).copy())
        layouts = cs.decode_layouts(torch, q, k, v)
        assert b == 1 or layouts["broadcast q"][0].stride(0) == 0
        assert layouts["strided q"][0].stride(0) == 2 * hq * d
        assert all(x.data_ptr() % 16 == esize
                   for x in layouts["unaligned"])
        want = t_ref.flash_decode_ref(q[:1].expand(b, hq, d), k, v, ln,
                                      return_partials=True)
        got = t_ref.flash_decode_ref(*layouts["broadcast q"], ln,
                                     return_partials=True)
        assert all(torch.equal(a, z) for a, z in zip(got, want))
        for name in ("dense", "strided q", "unaligned"):
            got = t_ref.flash_decode_ref(*layouts[name], ln,
                                         return_partials=True)
            want = t_ref.flash_decode_ref(q, k, v, ln, return_partials=True)
            assert all(torch.equal(a, z) for a, z in zip(got, want)), name
        for qkv in layouts.values():
            branches.add(cs.decode_branch(t_fd, *qkv))
    assert {(flat, width) for flat in (True, False)
            for width in (16, esize)} <= branches
