"""The sequence kernels' plain versions against the JAX reference.

The CUDA kernels (``flash_attention``, ``flash_decode``, ``rglru_scan``)
cannot run here; ``chip_smoke.py`` holds them against these plain versions
on the card.  On the CPU the port's wrappers (``kernels/ops.py``) take the
plain route because the tensors lie on the CPU, so these tests cover the
arithmetic every route shares.  Inputs come from a NumPy seed and go to
both packages; the JAX kernels run in interpret mode, as
``tests/test_kernels.py`` runs them.  The ``flash_attention`` kernel's own
algorithm (lanes splitting the keys, a softmax per tile, the lane merge)
is mirrored here in torch, and its launch plan is held to the card's
limits for every shape ``chip_smoke.py`` launches.
"""
import functools
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.kernels.flash_decode import combine_partials as j_combine
from repro.kernels.flash_decode import flash_decode as j_flash_decode

from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values in each package's ``dtype`` (bf16 rounds the same
    way, to nearest even, in both)."""
    return (jnp.asarray(a).astype(dtype),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal,window", [
    (4, 64, 64, 2, 2, 8, True, None),      # the attn detector's path shape
    (2, 64, 64, 4, 2, 16, True, None),     # GQA
    (1, 128, 128, 4, 1, 16, True, 32),     # MQA + sliding window
    (1, 64, 64, 2, 1, 16, False, None),    # bidirectional
    (1, 192, 192, 3, 3, 8, True, None),    # S = 192 (block 64)
    (2, 64, 128, 2, 2, 8, True, None),     # causal offset T − S
])
def test_flash_attention_plain_matches_jax(b, s, t, hq, hkv, d, causal,
                                           window, dtype):
    """The port's plain version (what ``ops.flash_attention`` runs for CPU
    tensors) against the interpret-mode Pallas kernel and
    ``flash_attention_ref``: f32 at 2e-5, bf16 at 2e-2 (the bars of
    ``tests/test_kernels.py``)."""
    rng = np.random.default_rng(b * 1000 + s + hq)
    jq, tq = _both(_normal(rng, (b, s, hq, d)), dtype)
    jk, tk = _both(_normal(rng, (b, t, hkv, d)), dtype)
    jv, tv = _both(_normal(rng, (b, t, hkv, d)), dtype)
    out = t_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    want = jax.jit(j_ref.flash_attention_ref, static_argnames=(
        "causal", "window"))(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if dtype == "float32":
        kern = j_flash_attention(jq, jk, jv, causal=causal, window=window,
                                 bq=64, bk=64, interpret=True)
        np.testing.assert_allclose(_np(out), _np(kern), atol=2e-5, rtol=2e-5)


LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _lane_split_attention(q, k, v, causal, window, lanes, key_tile=64):
    """The arithmetic of ``csrc/flash_attention.cu`` at D ≤ 32, in torch
    f32: scale·log2(e) folded into q; ``lanes`` lanes per (row, head),
    lane g taking keys t0 + g, t0 + g + G, ... of each tile of
    ``key_tile`` keys; a masked key scores −1e30 after scaling; per tile
    one max, one rescale of (l, acc), then p·v with ``exp2``; the lane
    states merged in the xor butterfly with products and sums rounded
    apart, so that every lane ends with the same bits (checked)."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qscale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * LOG2E
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float() * qscale, kf)
    pos = torch.arange(s)[:, None] + (t - s)
    key = torch.arange(t)[None, :]
    valid = torch.ones(s, t, dtype=torch.bool)
    if causal:
        valid &= key <= pos
    if window is not None:
        valid &= key > pos - window
    scores = torch.where(valid, scores, torch.tensor(NEG_INF))
    m = torch.full((b, hq, s, lanes), NEG_INF)
    l = torch.zeros(b, hq, s, lanes)
    acc = torch.zeros(b, hq, s, lanes, d)
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
                              + torch.einsum("bhsn,bnhd->bhsd", p,
                                             vf[:, idx]))
            m[..., g] = m_new
    off = 1
    while off < lanes:
        partner = torch.arange(lanes) ^ off
        m_o, l_o, acc_o = m[..., partner], l[..., partner], acc[..., partner, :]
        m_new = torch.maximum(m, m_o)
        a, c = torch.exp2(m - m_new), torch.exp2(m_o - m_new)
        l = l * a + l_o * c
        acc = acc * a[..., None] + acc_o * c[..., None]
        m = m_new
        off *= 2
    assert torch.equal(l[..., :1].expand_as(l), l)
    assert torch.equal(acc[..., :1, :].expand_as(acc), acc)
    out = acc[..., 0, :] / torch.clamp(l[..., 0], min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


# (b, s, t, hq, hkv, d, causal, window)
MIRROR_CASES = [
    (128, 64, 64, 2, 2, 8, True, None),    # the attn detector's path shape
    (2, 64, 64, 4, 2, 16, True, None),     # GQA
    (2, 128, 128, 2, 1, 8, True, 24),      # MQA + window, two key tiles
    (3, 100, 100, 4, 2, 16, True, None),   # S = 100 ragged
    (2, 64, 128, 2, 2, 8, True, None),     # causal offset T − S = 64
    (2, 96, 64, 2, 2, 8, True, None),      # S > T: rows with no valid key
    (1, 64, 64, 2, 1, 32, False, None),    # bidirectional, D = 32
]


@functools.lru_cache(maxsize=None)
def _mirror_inputs(case):
    """Inputs from a NumPy seed, the port's plain version and the
    interpret-mode Pallas kernel on them (each computed once)."""
    b, s, t, hq, hkv, d, causal, window = case
    rng = np.random.default_rng(b * 1000 + s + t + d)
    q, k, v = (_normal(rng, (b, s, hq, d)), _normal(rng, (b, t, hkv, d)),
               _normal(rng, (b, t, hkv, d)))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    plain = t_ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                      window=window)
    kern = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, interpret=True)
    return (tq, tk, tv), plain, _np(kern)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("case", MIRROR_CASES, ids=str)
def test_flash_attention_lane_split_mirror(case, lanes):
    """The CUDA kernel's algorithm, mirrored in torch, against the port's
    plain version and the interpret-mode Pallas kernel at f32 2e-5, for
    G = 1, 2, 4, 8 lanes.  Rows with no valid key (S > T) average all T
    keys, as the TPU kernel's −1e30 masking gives."""
    _, _, _, _, _, _, causal, window = case
    (tq, tk, tv), plain, kern = _mirror_inputs(case)
    out = _lane_split_attention(tq, tk, tv, causal, window, lanes)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), kern, atol=2e-5, rtol=2e-5)
    if case[1] > case[2]:  # rows before the first key: the mean of v
        n_empty = case[1] - case[2]
        mean_v = tv.float().mean(1).repeat_interleave(
            case[3] // case[4], dim=1)
        np.testing.assert_allclose(
            out[:, :n_empty].numpy(),
            mean_v[:, None].expand(-1, n_empty, -1, -1).numpy(),
            atol=2e-5, rtol=2e-5)


def _chip_smoke_fa_cases():
    """``FA_CASES`` of ``chip_smoke.py``: the shapes the card launches."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FA_CASES, mod.FA_PATH


FA_CASES, FA_PATH = _chip_smoke_fa_cases()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FA_CASES + [
    (1, 1, 1, 1, 1, 1, True, None),        # one row, one key, D = 1
    (2, 7, 300, 48, 4, 20, False, None),   # many heads, odd D, long T
    (1, 9, 9, 64, 64, 32, True, 4),        # 64 kv heads at D = 32
    (65535, 3, 3, 2, 1, 12, True, None),   # the largest batch
], ids=str)
def test_flash_attention_launch_plan_fits_the_card(case, dtype, aligned):
    """Every launch ``chip_smoke.py`` makes (and a few edge shapes) stays
    within 1,024 threads a block in whole warps, 48 KB of static shared
    memory (the lanes and row kernels) or the 227 KB opt-in (the
    tensor-core kernel), and 65,535 blocks in grid y and z; the grid covers
    every (row, head).  The lanes split a warp evenly and each lane's chain
    is at most 16 keys a tile; bf16 above D = 32 takes the tensor-core
    kernel, f32 the row kernel up to D = 128 and is refused above."""
    b, s, t, hq, hkv, d, _, _ = case
    esize = 2 if dtype == torch.bfloat16 else 4
    if dtype == torch.float32 and d > t_fa.MAX_HEAD_DIM_F32:
        with pytest.raises(ValueError, match="f32"):
            t_fa.launch_plan(b, s, t, hq, hkv, d, dtype, aligned)
        return
    plan = t_fa.launch_plan(b, s, t, hq, hkv, d, dtype, aligned)
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    assert 32 % plan.lanes == 0
    if d > 32 and dtype == torch.bfloat16:
        # (heads, batch, position tiles); 64 positions of one head a block,
        # 16 a warp
        assert plan.kernel == "mma" and plan.dmax >= d
        assert plan.smem_bytes <= t_fa.MAX_SMEM_OPTIN
        assert plan.grid[1] == b and max(plan.grid[1:]) <= 65535
        assert plan.grid[2] * plan.rows >= s > (plan.grid[2] - 1) * plan.rows
        assert plan.grid[0] == hq and plan.heads == 1
        assert plan.threads == 2 * plan.rows == 128
        assert plan.smem_bytes == (plan.rows + 4 * plan.key_tile) * \
            (plan.dmax + 8) * 2
        assert plan.copy_width == (16 if aligned and d % 8 == 0 else 2)
        return
    assert plan.smem_bytes <= 48 * 1024
    assert max(plan.grid[1:]) <= 65535 and plan.grid[2] == b
    assert plan.grid[0] * plan.rows >= s > (plan.grid[0] - 1) * plan.rows
    assert plan.grid[1] * plan.heads == hq
    if d > 32:  # f32: the row kernel, 64 rows of one head, a thread a row
        assert (plan.kernel, plan.dmax, plan.rows, plan.heads, plan.lanes,
                plan.threads) == ("row", 64 if d <= 64 else 128, 64, 1, 1,
                                  64)
        return
    assert plan.kernel == "lanes"
    assert plan.dmax >= d and \
        plan.threads == plan.rows * plan.heads * plan.lanes
    assert plan.key_tile % plan.lanes == 0 and \
        plan.key_tile // plan.lanes <= 16
    group = hq // hkv
    assert plan.heads % group == 0 or group % plan.heads == 0
    assert plan.kv_heads == max(plan.heads // group, 1)
    n_buf = 2 if t > plan.key_tile else 1
    assert plan.smem_bytes == (plan.rows * plan.heads + n_buf * 2 *
                               plan.key_tile * plan.kv_heads) * \
        plan.dmax * esize
    assert plan.copy_width == (16 if aligned and d * esize % 16 == 0
                               else esize)
    if case == FA_PATH:  # 32 rows x both heads x 4 lanes, 256 blocks
        assert (plan.rows, plan.heads, plan.lanes, plan.threads,
                plan.key_tile) == (32, 2, 4, 256, 64)
        assert math.prod(plan.grid) >= 256


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,d,t,lengths", [
    (4, 2, 2, 8, 64, (64, 64, 64, 64)),   # the attn read-out's path shape
    (2, 8, 2, 16, 128, (100, 128)),       # GQA, partial cache
    (3, 4, 1, 32, 64, (17, 1, 64)),       # MQA, short prefixes
])
def test_flash_decode_and_partials_match_jax(b, hq, hkv, d, t, lengths,
                                             dtype):
    """o, m and l against the interpret-mode Pallas kernel at 2e-5 (f32);
    bf16 o against ``flash_decode_ref`` at 2e-2."""
    rng = np.random.default_rng(b * 100 + t + d)
    jq, tq = _both(_normal(rng, (b, hq, d)), dtype)
    jk, tk = _both(_normal(rng, (b, t, hkv, d)), dtype)
    jv, tv = _both(_normal(rng, (b, t, hkv, d)), dtype)
    length = np.asarray(lengths, np.int32)
    o, m, l = t_ops.flash_decode(tq, tk, tv, torch.as_tensor(length),
                                 return_partials=True)
    assert o.dtype == tq.dtype and m.shape == l.shape == (b, hq)
    assert torch.equal(o, t_ops.flash_decode(tq, tk, tv,
                                             torch.as_tensor(length)))
    if dtype == "bfloat16":
        want = j_ref.flash_decode_ref(jq, jk, jv, jnp.asarray(length))
        np.testing.assert_allclose(_np(o), _np(want), atol=2e-2, rtol=2e-2)
        return
    jo, jm, jl = j_flash_decode(jq, jk, jv, jnp.asarray(length),
                                interpret=True, return_partials=True)
    for mine, theirs in ((o, jo), (m, jm), (l, jl)):
        np.testing.assert_allclose(_np(mine), _np(theirs), atol=2e-5,
                                   rtol=2e-5)


def test_combine_decode_partials_with_empty_shard_matches_jax():
    """A cache split into 4 shards, two of them empty for the first row:
    the log-sum-exp merge of the port's partials equals the JAX merge of
    the Pallas partials and the unsharded reference, with no NaN."""
    b, hq, hkv, d, t, shards = 2, 4, 2, 16, 128, 4
    rng = np.random.default_rng(11)
    q, k, v = (_normal(rng, (b, hq, d)), _normal(rng, (b, t, hkv, d)),
               _normal(rng, (b, t, hkv, d)))
    length = np.array([50, 128], np.int32)
    per = t // shards
    t_parts, j_parts = [], []
    for sh in range(shards):
        ln = np.clip(length - sh * per, 0, per).astype(np.int32)
        sl = slice(sh * per, (sh + 1) * per)
        t_parts.append(t_ops.flash_decode(
            torch.as_tensor(q), torch.as_tensor(k[:, sl]),
            torch.as_tensor(v[:, sl]), torch.as_tensor(ln),
            return_partials=True))
        j_parts.append(j_flash_decode(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(ln), interpret=True, return_partials=True))
    # an empty shard: m = −1e30 and l = T, as the TPU kernel gives
    assert t_parts[2][1][0, 0].item() == np.float32(-1e30)
    assert t_parts[2][2][0, 0].item() == per
    mine = t_ops.combine_decode_partials(
        *(torch.stack([p[i] for p in t_parts]) for i in range(3)))
    theirs = j_combine(*(jnp.stack([p[i] for p in j_parts])
                         for i in range(3)))
    full = j_ref.flash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(length))
    assert torch.isfinite(mine).all()
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(mine.numpy(), np.asarray(full), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("b,l,w,h0", [
    (1, 128, 128, False),
    (2, 64, 96, True),
    (3, 64, 512, True),    # the ssm detector's flattened-state width
    (1, 4, 512, False),    # few steps, wide lanes (the chunk-state shape)
])
def test_rglru_scan_plain_matches_jax_ref(b, l, w, h0):
    """The grid of ``tests/test_kernels.py``'s bitwise pin, at 1e-6.

    Not bitwise: XLA on the CPU contracts ``a·h + x`` into one FMA (every
    output of a step equals the FMA computed in f64 and rounded once),
    while the port's plain version rounds the product and the sum apart,
    as its CUDA kernel does, so that kernel and plain version are bitwise
    equal on the card (``chip_smoke.py``)."""
    rng = np.random.default_rng(l + w)
    a = (1.0 / (1.0 + np.exp(-_normal(rng, (b, l, w))))).astype(np.float32)
    x = _normal(rng, (b, l, w))
    h0v = _normal(rng, (b, w)) if h0 else None
    h, hl = t_ops.rglru_scan(torch.as_tensor(a), torch.as_tensor(x),
                             None if h0v is None else torch.as_tensor(h0v))
    rh, rhl = j_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(x),
                                   None if h0v is None else jnp.asarray(h0v))
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(hl.numpy(), np.asarray(rhl), atol=1e-6,
                               rtol=1e-6)


def test_wrappers_refuse_gradients_and_bad_windows():
    """The kernels have no backward: a wrapper refuses an operand that
    requires grad on every device, so the kernel route never returns a
    result without a ``grad_fn``.  Without autograd it runs."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(_normal(rng, (1, 8, 2, 4))).requires_grad_()
    k = torch.as_tensor(_normal(rng, (1, 8, 2, 4)))
    with pytest.raises(RuntimeError, match="no backward"):
        t_ops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        t_ops.flash_decode(q[:, 0], k, k, torch.tensor([8]))
    with pytest.raises(RuntimeError, match="no backward"):
        t_ops.rglru_scan(q[..., 0], k[..., 0])
    with pytest.raises(RuntimeError, match="no backward"):
        torch.func.grad(lambda z: t_ops.flash_attention(z, k, k).sum())(
            q.detach())
    with torch.no_grad():
        assert t_ops.flash_attention(q, k, k).shape == q.shape
    with pytest.raises(ValueError, match="window"):
        t_ops.flash_attention(q.detach(), k, k, window=0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_ops.rglru_scan(*(torch.empty(1, 2, 3, device="meta"),) * 2)
