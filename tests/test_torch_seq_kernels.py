"""The sequence kernels' plain versions against the JAX reference.

The CUDA kernels (``flash_attention``, ``flash_decode``, ``rglru_scan``)
cannot run here; ``chip_smoke.py`` holds them against these plain versions
on the card.  On the CPU the port's wrappers (``kernels/ops.py``) take the
plain route because the tensors lie on the CPU, so these tests cover the
arithmetic every route shares.  Inputs come from a NumPy seed and go to
both packages; the JAX kernels run in interpret mode, as
``tests/test_kernels.py`` runs them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.kernels.flash_decode import combine_partials as j_combine
from repro.kernels.flash_decode import flash_decode as j_flash_decode

from repro_torch.kernels import ops as t_ops

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
