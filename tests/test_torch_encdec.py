"""The port's encoder-decoder (``models/encdec.py``, seamless-m4t's family)
against the JAX reference.

The param tree (smoke and full config, on the meta device), the encoder
and cross attention, ``encode``, ``decode_train`` (with and without a
window), ``encdec_forward``, ``init_decode_cache`` (cross K/V projected
once a layer), ``encdec_decode_step`` against full and rolling self
caches step by step with ``prefill_scan`` bitwise the port's own loop,
``Model.loss`` and its gradients against ``jax.value_and_grad`` under
every remat, and ``Model.init_cache``'s zero encoder output.  Weights go
across with ``convert.lm_params_from_jax``; inputs come from a NumPy
seed.  Tolerances as in ``tests/test_torch_lm.py``: f32 at 1e-5, bf16 at
2e-2 with the absolute part scaled by the largest magnitude.  The
encoder-decoder takes no ``impl``: it runs no kernel, as the
reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch.serve import prefill_scan as j_prefill_scan
from repro.models import attention as j_attn
from repro.models import encdec as j_ed
from repro.models import model as j_model
from repro.models.sharding import split_meta as j_split_meta

from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import encdec as t_ed
from repro_torch.models import model as t_model

from test_torch_lm import _both, _close, _meta_tree, _np, _to_torch, _tokens

torch.set_num_threads(1)

ARCH = "seamless_m4t_large_v2"
DTYPES = ("float32", "bfloat16")


def _cfgs(dtype: str, **kw):
    jc = dataclasses.replace(j_base.get_arch(ARCH, smoke=True), dtype=dtype,
                             **kw)
    return jc, t_base.ModelConfig(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def _model(dtype: str):
    """(JAX model, its params, port model, the same params as tensors)."""
    jc, tc = _cfgs(dtype)
    jm = j_model.build(jc)
    jp = jm.init(jax.random.key(0))
    return jm, jp, t_model.build(tc), _to_torch(jp)


def _frames(cfg, b: int, t: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    return _both(rng.standard_normal((b, t, cfg.d_model)).astype(np.float32),
                 cfg.dtype)


def bfloat16_in(t: torch.Tensor, dtype: str) -> bool:
    """A bf16 cache, or a bf16 model: held at bf16's bar."""
    return t.dtype == torch.bfloat16 or dtype == "bfloat16"


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_tree_matches_jax(dtype):
    """``init_encdec_meta`` builds the reference's ParamMeta tree (shapes,
    dtypes, axes, the stacked "layers" axis of both stacks), drawn or on
    the meta device; ``encdec_axes`` is its axes tree."""
    jc, tc = _cfgs(dtype)
    jt = j_ed.init_encdec_meta(jax.random.key(0), jc)
    tt = t_ed.init_encdec_meta(torch.Generator().manual_seed(0), tc)
    assert _meta_tree(tt) == _meta_tree(jt)
    assert _meta_tree(t_ed.init_encdec_meta(None, tc)) == _meta_tree(jt)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.leaves(t_ed.encdec_axes(tc), is_leaf=is_axes) == \
        jax.tree.leaves(j_ed.encdec_axes(jc), is_leaf=is_axes)
    p = t_model.build(tc).init(0, device="cpu")
    wq = p["enc_stack"]["attn"]["wq"]["w"]
    assert wq.shape == (2, 128, 128) and not torch.equal(wq[0], wq[1])


def test_full_config_param_shapes_and_axes_equal_jax():
    """seamless-m4t-large-v2's full tree on the meta device equals the
    reference's ``Model.param_shapes()`` leaf by leaf: 1,632,233,472
    elements (3.26 GB in bf16), nothing allocated."""
    jm = j_model.build(j_base.get_arch(ARCH))
    tm = t_model.build(t_base.get_arch(ARCH))
    assert tm.is_encdec
    tl = jax.tree.leaves(tm.param_shapes())
    jl = jax.tree.leaves(jm.param_shapes())
    assert all(t.device.type == "meta" for t in tl)
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in tl] == \
        [(tuple(j.shape), str(j.dtype)) for j in jl]
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.leaves(tm.axes(), is_leaf=is_axes) == \
        jax.tree.leaves(jm.axes(), is_leaf=is_axes)
    n = sum(t.numel() for t in tl)
    assert n == 1_632_233_472 and 2 * n / 1e9 == pytest.approx(3.26, abs=0.01)


def test_encoder_and_cross_attention_match_jax():
    """``encoder_attention`` (bidirectional, RoPE'd), ``project_enc_kv``
    and ``cross_attention`` on the same inputs, f32 at 1e-5."""
    jc, tc = _cfgs("float32")
    jp, _ = j_split_meta(j_attn.init_attention(jax.random.key(3), jc))
    tp = _to_torch(jp)
    rng = np.random.default_rng(3)
    jx, tx = _both(rng.standard_normal((2, 12, 128)).astype(np.float32))
    je, te = _both(rng.standard_normal((2, 20, 128)).astype(np.float32))
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    _close(t_attn.encoder_attention(tp, tx, torch.as_tensor(pos.copy()), tc),
           j_attn.encoder_attention(jp, jx, jnp.asarray(pos), jc), "float32")
    jkv = j_attn.project_enc_kv(jp, je, jc)
    tkv = t_attn.project_enc_kv(tp, te, tc)
    for a, b in zip(tkv, jkv):
        assert tuple(a.shape) == (2, 20, 4, 32)
        _close(a, b, "float32")
    _close(t_attn.cross_attention(tp, tx, tkv, tc),
           j_attn.cross_attention(jp, jx, jkv, jc), "float32")


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_decode_train_match_jax(dtype, window):
    """``encode`` of stub frames, ``decode_train`` given the same encoder
    output (causal, or under a window of 4), and ``Model.forward``
    (full and ``last_only``; any ``impl``) against the reference's; the
    padded vocab is exactly −1e30."""
    jm, jp, tm, tp = _model(dtype)
    cfg = tm.cfg
    jf, tf = _frames(cfg, 2, 16)
    j_enc = j_ed.encode(jp, jm.cfg, jf, remat="none")
    t_enc = t_ed.encode(tp, cfg, tf)
    assert t_enc.dtype == getattr(torch, dtype)
    _close(t_enc, j_enc, dtype)
    toks = _tokens(cfg, 2, 10, seed=6)
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)
    v = cfg.vocab_size
    want = j_ed.decode_train(jp, jm.cfg, jt, j_enc, remat="none",
                             window=window)
    got = t_ed.decode_train(tp, cfg, tt, torch.as_tensor(
        np.array(j_enc.astype(jnp.float32))).to(t_enc.dtype),
        window=window)
    assert got.dtype == torch.float32
    _close(got[..., :v], np.asarray(want)[..., :v], dtype)
    assert bool((got[..., v:] == -1e30).all())
    batch_j, batch_t = {"frontend": jf, "tokens": jt}, {"frontend": tf,
                                                        "tokens": tt}
    for last_only in (False, True):
        want = jm.forward(jp, batch_j, window=window, last_only=last_only)
        got = tm.forward(tp, batch_t, impl="flash", window=window,
                         last_only=last_only)
        assert got.shape[1] == (1 if last_only else 10)
        _close(got[..., :v], np.asarray(want)[..., :v], dtype)


@pytest.mark.parametrize("window,steps", [(None, 8), (4, 7)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_cache_and_steps_match_jax(dtype, window, steps):
    """``init_decode_cache`` from an encoder output (cross K/V
    [L, B, T_enc, Hkv, hd], the self cache zeroed bf16, rolling at a
    window), then ``decode_step`` token by token against the reference's:
    logits and every cache after each step; ``prefill_scan`` bitwise the
    port's own loop and against the reference's."""
    jm, jp, tm, tp = _model(dtype)
    cfg = tm.cfg
    jf, tf = _frames(cfg, 2, cfg.enc_seq, seed=7)
    j_enc = j_ed.encode(jp, jm.cfg, jf, remat="none")
    t_enc = t_ed.encode(tp, cfg, tf)
    n = steps if window is None else 16
    jc = jm.init_cache(2, n, window=window, params=jp, enc_out=j_enc)
    tc = tm.init_cache(2, n, window=window, params=tp, enc_out=t_enc)
    clen = window or n
    assert tuple(tc["self"]["k"].shape) == (2, 2, clen, 4, 32)
    assert tc["self"]["k"].dtype == torch.bfloat16
    assert tuple(tc["cross"]["k"].shape) == (2, 2, cfg.enc_seq, 4, 32)
    assert jax.tree.structure(jc) == jax.tree.structure(
        jax.tree.map(lambda x: 0, tc))
    fresh = jax.tree.map(torch.clone, tc)
    for a, b in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        _close(a, b, dtype)
    toks = _tokens(cfg, 2, steps, seed=8)
    v = cfg.vocab_size
    loop = []
    for t in range(steps):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                jnp.asarray(t), window=window)
        tl, tc = tm.decode_step(tp, torch.as_tensor(toks[:, t:t + 1]), tc,
                                t, window=window)
        loop.append(tl)
        _close(tl[..., :v], np.asarray(jl)[..., :v], dtype)
        for a, b in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
            _close(a, b, "bfloat16" if bfloat16_in(a, dtype) else dtype)
    last, scan_c = t_serve.prefill_scan(tm, tp, torch.as_tensor(toks), fresh,
                                        window=window)
    assert torch.equal(last, loop[-1])
    for a, b in zip(jax.tree.leaves(scan_c), jax.tree.leaves(tc)):
        assert torch.equal(a, b)
    jc0 = jm.init_cache(2, n, window=window, params=jp, enc_out=j_enc)
    j_last, _ = j_prefill_scan(jm, jp, jnp.asarray(toks), jc0, window=window)
    _close(last[..., :v], np.asarray(j_last)[..., :v], dtype)


def test_model_init_cache_builds_a_zero_encoder_output():
    """Without ``enc_out``, ``Model.init_cache`` projects the cross K/V
    from zeros of [B, enc_seq, d] on the params' device, as the
    reference's; without params it raises."""
    jm, jp, tm, tp = _model("bfloat16")
    jc = jm.init_cache(3, 5, params=jp)
    tc = tm.init_cache(3, 5, params=tp)
    for a, b in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))
    assert tuple(tc["cross"]["v"].shape) == (2, 3, 16, 4, 32)
    with pytest.raises(ValueError, match="params"):
        tm.init_cache(3, 5, device="cpu")


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_jax_value_and_grad(remat):
    """``Model.loss`` (the decoder's cross-entropy given the frames) and
    its gradients against ``jax.value_and_grad`` of the reference's, f32
    at 1e-5 (gradients scaled by their largest magnitude), under each
    remat; the remats agree with ``"none"``."""
    jm, jp, tm, tp = _model("float32")
    cfg = tm.cfg
    jf, tf = _frames(cfg, 2, 12, seed=9)
    toks = _tokens(cfg, 2, 10, seed=9)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -100
    jb = {"frontend": jf, "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(labels)}
    tb = {"frontend": tf, "tokens": torch.as_tensor(toks),
          "labels": torch.as_tensor(labels)}
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, jb, remat="none"))(jp)
    tq = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    loss = tm.loss(tq, tb, remat=remat)
    loss.backward()
    _close(loss, jl, "float32")
    for g, j in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad, tq)),
                    jax.tree.leaves(jg)):
        _close(g, j, "float32", scaled=True)
    with pytest.raises(ValueError, match="remat"):
        tm.loss(tp, tb, remat="offload")


def test_convert_carries_the_tree_bitwise():
    """``convert.lm_params_from_jax`` carries the encoder-decoder's bf16
    tree across bitwise, each leaf in its dtype."""
    _, jp, _, tp = _model("bfloat16")
    again = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for j, a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp),
                       jax.tree.leaves(again)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)
        np.testing.assert_array_equal(_np(a), np.asarray(j, np.float32))
