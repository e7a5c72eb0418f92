"""The port's mixture-of-experts block (``models/moe.py`` and the ``moe``
kind of ``models/transformer.py``) against the JAX reference.

``route`` and ``moe_mlp`` on both dispatches (``"einsum"`` and
``"scatter"``) on the same inputs, at the phi3.5-moe smoke config's widths
(4 experts, top-2) and at a capacity the tokens overflow; the scatter
dispatch against the einsum one; the block's param tree; the smoke LM's
forward on both dispatches, ``Model.loss`` and its gradients against
``jax.value_and_grad`` (the aux loss included) under every remat; and the
routing of the bf16 LM against the reference's, flip by flip.

Tolerances: f32 at 1e-5; bf16 at 2e-2, the absolute part scaled by the
compared tensor's largest magnitude (``tests/test_torch_lm.py``).  The
router is f32 in both packages, so on the same input the routing is the
same; inside a bf16 model the two packages round each layer's input to
the router apart, and a token whose k-th and (k+1)-th gates lie closer
than that flips its choice (``routing_flips``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import model as j_model
from repro.models import moe as j_moe
from repro.models import transformer as j_tr
from repro.models.sharding import split_meta as j_split_meta

from repro_torch.configs import base as t_base
from repro_torch.models import model as t_model
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tr

from test_torch_lm import (_both, _close, _lm, _meta_tree, _np, _to_torch,
                           _tokens, check_flips, routing_flips, routing_spy)

torch.set_num_threads(1)

ARCH = "phi3p5_moe_42b"
IMPLS = ("einsum", "scatter")


def _cfgs(dtype: str, **kw):
    jc = dataclasses.replace(j_base.get_arch(ARCH, smoke=True), dtype=dtype,
                             **kw)
    return jc, t_base.ModelConfig(**dataclasses.asdict(jc))


def _moe_params(jc, seed: int = 0):
    jp, _ = j_split_meta(j_moe.init_moe(jax.random.key(seed), jc))
    return jp, _to_torch(jp)


def _x(dtype: str, b: int = 2, s: int = 32, d: int = 128, seed: int = 1):
    rng = np.random.default_rng(seed)
    return _both(rng.standard_normal((b, s, d)).astype(np.float32), dtype)


@pytest.fixture(autouse=True)
def _einsum_dispatch():
    """Every test starts, and leaves, on the reference's default."""
    yield
    j_tr.MOE_IMPL[0] = t_tr.MOE_IMPL[0] = "einsum"


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_jax(dtype, capacity_factor):
    """``route``: the dispatch tensor equal to the reference's, combine and
    aux at f32's bar (the router is f32 whatever the model's dtype).  At a
    capacity factor of 0.5 (8 slots an expert for 32 tokens × 2 choices
    over 4 experts) tokens overflow their expert's queue and are dropped:
    the same ones in both."""
    jc, tc = _cfgs(dtype, capacity_factor=capacity_factor)
    jp, tp = _moe_params(jc)
    jx, tx = _x(dtype)
    jd, jcomb, jaux = j_moe.route(jp["router"], jx, jc)
    td, tcomb, taux = t_moe.route(tp["router"], tx, tc)
    c = t_moe._capacity(tc, 32)
    assert c == j_moe._capacity(jc, 32) == int(capacity_factor * 16)
    assert tuple(td.shape) == (2, 32, 4, c)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    _close(tcomb, jcomb, "float32")
    _close(taux, jaux, "float32")
    kept = float(td.sum())
    # each kept choice owns one slot; the capacity drops some at 0.5
    assert bool((td.sum(dim=1) <= 1).all())
    assert (kept < 2 * 32 * 2) == (capacity_factor < 1)
    # the combine weights of a token sum to 1 over its kept experts
    w = tcomb.sum(dim=(2, 3))
    assert torch.allclose(w[td.sum(dim=(2, 3)) > 0], torch.ones(()),
                          atol=1e-6)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_mlp_matches_jax(impl, dtype, capacity_factor):
    """``moe_mlp`` on each dispatch against the reference's same dispatch,
    output and aux, with and without capacity drops."""
    jc, tc = _cfgs(dtype, capacity_factor=capacity_factor)
    jp, tp = _moe_params(jc)
    jx, tx = _x(dtype)
    jy, jaux = j_moe.moe_mlp(jp, jx, jc, impl=impl)
    ty, taux = t_moe.moe_mlp(tp, tx, tc, impl=impl)
    assert ty.dtype == tx.dtype and tuple(ty.shape) == tuple(tx.shape)
    # the experts' fan-in is the reference's (the expert count for wi/wg),
    # so outputs reach ~30: the bar's absolute part scales with them
    _close(ty, jy, dtype, scaled=True)
    _close(taux, jaux, "float32")


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_equals_einsum(dtype, capacity_factor):
    """The scatter dispatch computes the einsum one's output: f32 at 1e-6
    (absolute: of the largest magnitude), bf16 at its bar (the einsum
    combine rounds once, the gather twice); the aux loss bitwise; the
    scatter bitwise repeatable (a kept token owns its slot, a dropped one
    adds an exact zero); a token dropped by both of its choices gets
    zeros."""
    jc, tc = _cfgs(dtype, capacity_factor=capacity_factor)
    _, tp = _moe_params(jc)
    _, tx = _x(dtype)
    ye, aux_e = t_moe.moe_mlp(tp, tx, tc, impl="einsum")
    ys, aux_s = t_moe.moe_mlp(tp, tx, tc, impl="scatter")
    assert torch.equal(aux_e, aux_s)
    if dtype == "float32":
        np.testing.assert_allclose(_np(ys), _np(ye), rtol=1e-6,
                                   atol=1e-6 * float(ye.abs().max()))
    else:
        _close(ys, ye, dtype)
    assert torch.equal(ys, t_moe.moe_mlp(tp, tx, tc, impl="scatter")[0])
    dispatch, _, _ = t_moe.route(tp["router"], tx, tc)
    dropped = dispatch.sum(dim=(2, 3)) == 0
    assert bool((ye[dropped] == 0).all()) and bool((ys[dropped] == 0).all())
    assert bool(dropped.any()) == (capacity_factor < 1)
    with pytest.raises(ValueError, match="impl"):
        t_moe.moe_mlp(tp, tx, tc, impl="ragged")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_trees_match_jax(dtype):
    """``init_moe`` and the ``moe`` block build the reference's ParamMeta
    trees (router f32, experts in ``cfg.dtype``, axes
    experts/embed/mlp), drawn at the reference's fan-ins; the block's
    cache is attention's."""
    jc, tc = _cfgs(dtype)
    gen = torch.Generator().manual_seed(0)
    tt = t_moe.init_moe(gen, tc)
    assert _meta_tree(tt) == _meta_tree(j_moe.init_moe(jax.random.key(0),
                                                       jc))
    assert _meta_tree(t_tr.init_block(gen, tc, "moe")) == _meta_tree(
        j_tr.init_block(jax.random.key(0), jc, "moe"))
    assert _meta_tree(t_tr.init_block(None, tc, "moe")) == _meta_tree(
        j_tr.init_block(jax.random.key(0), jc, "moe"))
    for name, fan_in in (("router", 128), ("wi", 4), ("wg", 4), ("wo", 256)):
        std = float(tt[name].value.float().std())
        assert std == pytest.approx(fan_in ** -0.5, rel=0.05), name
    cache = t_tr.init_block_cache(tc, "moe", 3, 99)
    jcache = j_tr.init_block_cache(jc, "moe", 3, 99)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


# ---------------------------------------------------------------------------
# the smoke LM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_smoke_lm_forward_both_dispatches_match_jax(impl):
    """The smoke LM's logits on each dispatch against the reference's on
    the same dispatch (``MOE_IMPL`` flipped in both), f32 at 1e-5, both
    attention impls."""
    jm, jp, tm, tp = _lm(ARCH, "float32")
    j_tr.MOE_IMPL[0] = t_tr.MOE_IMPL[0] = impl
    toks = _tokens(tm.cfg, 2, 32)
    v = tm.cfg.vocab_size
    for attn_impl in ("ref", "flash"):
        want = jm.forward(jp, {"tokens": jnp.asarray(toks)}, impl=attn_impl)
        got = tm.forward(tp, {"tokens": torch.as_tensor(toks)},
                         impl=attn_impl)
        _close(got[..., :v], np.asarray(want)[..., :v], "float32")


def test_bf16_routing_against_jax_flip_by_flip():
    """The bf16 smoke LM's top-2 sets against the reference's, layer by
    layer: most agree, and each that does not lies within the two runs'
    gate gap; every row's logits before its first flip at bf16's bar."""
    jm, jp, tm, tp = _lm(ARCH, "bfloat16")
    toks = _tokens(tm.cfg, 2, 32)
    with routing_spy() as rec:
        want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
        got = tm.forward(tp, {"tokens": torch.as_tensor(toks)})
        jax.effects_barrier()
    assert len(rec["jax"]) == len(rec["torch"]) == tm.cfg.n_layers
    routing = routing_flips(rec["jax"], rec["torch"], 2)
    check_flips(routing)
    assert routing["share"] >= 0.95, routing
    v = tm.cfg.vocab_size
    for row, first in enumerate(routing["first"]):
        _close(got[row, :first, :v], np.asarray(want)[row, :first, :v],
               "bfloat16")


def test_scatter_vs_einsum_lm_routing_in_bf16():
    """The bf16 smoke LM on the scatter dispatch against itself on the
    einsum one: the first layer routes bitwise alike (the same input); a
    later flip lies within the runs' gate gap; rows before their first
    flip at bf16's bar."""
    _, _, tm, tp = _lm(ARCH, "bfloat16")
    toks = torch.as_tensor(_tokens(tm.cfg, 2, 32))
    gates = {}
    out = {}
    for impl in IMPLS:
        t_tr.MOE_IMPL[0] = impl
        with routing_spy() as rec:
            out[impl] = tm.forward(tp, {"tokens": toks})
        gates[impl] = rec["torch"]
    np.testing.assert_array_equal(gates["scatter"][0], gates["einsum"][0])
    routing = routing_flips(gates["einsum"], gates["scatter"], 2)
    check_flips(routing)
    for row, first in enumerate(routing["first"]):
        _close(out["scatter"][row, :first], out["einsum"][row, :first],
               "bfloat16")


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grads_match_jax_value_and_grad(impl):
    """``Model.loss`` (cross-entropy + the aux loss) and its gradients
    against ``jax.value_and_grad`` of the reference's in f32 at 1e-5 (the
    gradients scaled by their largest magnitude), with capacity drops; the
    remats recompute the routing alike: ``"full"`` and ``"dots"`` equal
    ``"none"``."""
    jm, jp, tm, tp = _lm(ARCH, "float32")
    j_tr.MOE_IMPL[0] = t_tr.MOE_IMPL[0] = impl
    toks = _tokens(tm.cfg, 2, 24, seed=3)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -100
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, jb, remat="none"))(jp)
    results = {}
    for remat in ("none", "full", "dots"):
        tq = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
        loss = tm.loss(tq, tb, remat=remat)
        loss.backward()
        results[remat] = (loss.detach(), [t.grad for t in
                                          jax.tree.leaves(tq)])
        _close(loss, jl, "float32")
        for g, j in zip(results[remat][1], jax.tree.leaves(jg)):
            _close(g, j, "float32", scaled=True)
    # the aux loss is in it: the loss without it differs
    aux = t_tr.lm_forward(tp, tm.cfg, tb["tokens"])[1]
    assert float(aux) > 0
    for remat in ("full", "dots"):
        assert torch.equal(results[remat][0], results["none"][0])
        for a, b in zip(results[remat][1], results["none"][1]):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


def test_full_config_moe_tree():
    """phi3.5-moe's full tree on the meta device: the reference's shapes,
    dtypes and axes (the f32 router beside bf16 experts), 41.87 B elements,
    and 21,069,172,736 at the 16 layers the card runs."""
    jc = j_base.get_arch(ARCH)
    tm = t_model.build(t_base.get_arch(ARCH))
    leaves = jax.tree.leaves(tm.param_shapes())
    assert sum(t.numel() for t in leaves) == sum(
        int(np.prod(j.shape)) for j in jax.tree.leaves(
            j_tr.lm_param_shapes(jc)))
    moe = tm.param_shapes()["stack"][0]["b0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["wi"].shape) == (32, 16, 4096, 6400)
    assert {moe[k].dtype for k in ("wi", "wg", "wo")} == {torch.bfloat16}
    cut = t_model.build(dataclasses.replace(t_base.get_arch(ARCH),
                                            n_layers=16))
    assert sum(t.numel() for t in jax.tree.leaves(cut.param_shapes())) == \
        21_069_172_736


# ---------------------------------------------------------------------------
# top-1 routing: llama4-maverick's ("attn", "moe") pair
# ---------------------------------------------------------------------------

LLAMA4 = "llama4_maverick_400b"


def _llama4_cfgs(dtype: str, **kw):
    jc = dataclasses.replace(j_base.get_arch(LLAMA4, smoke=True),
                             dtype=dtype, **kw)
    return jc, t_base.ModelConfig(**dataclasses.asdict(jc))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_top1_route_and_moe_mlp_match_jax(impl, dtype, capacity_factor):
    """llama4's top-1 routing (4 experts in the smoke config): ``route``'s
    dispatch equal to the reference's, its combine (the renormalised gate
    of a kept token is exactly 1) and aux at f32's bar, and ``moe_mlp`` on
    each dispatch against the reference's.  At a capacity factor of 0.25
    (2 slots an expert for 32 tokens) most tokens overflow and are
    dropped, the same ones in both, and get zeros; at 1.25 (10 slots)
    fewer, where routing favours an expert.  The full config's capacity is the reference's: 5 slots an
    expert for a sequence of 512 over 128 experts."""
    jc, tc = _llama4_cfgs(dtype, capacity_factor=capacity_factor)
    assert tc.experts_per_token == 1
    jp, tp = _moe_params(jc)
    jx, tx = _x(dtype)
    jd, jcomb, jaux = j_moe.route(jp["router"], jx, jc)
    td, tcomb, taux = t_moe.route(tp["router"], tx, tc)
    c = t_moe._capacity(tc, 32)
    assert c == j_moe._capacity(jc, 32) == int(capacity_factor * 8)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    _close(tcomb, jcomb, "float32")
    _close(taux, jaux, "float32")
    kept = td.sum(dim=(2, 3)) > 0
    # at most c tokens an expert a row are kept: 2 rows of 32 tokens
    assert int((~kept).sum()) >= 2 * 32 - 2 * 4 * c
    np.testing.assert_array_equal(_np(tcomb.sum(dim=(2, 3))[kept]), 1.0)
    jy, jaux2 = j_moe.moe_mlp(jp, jx, jc, impl=impl)
    ty, taux2 = t_moe.moe_mlp(tp, tx, tc, impl=impl)
    _close(ty, jy, dtype, scaled=True)
    _close(taux2, jaux2, "float32")
    assert bool((ty[~kept] == 0).all())
    full = t_base.get_arch(LLAMA4)
    assert t_moe._capacity(full, 512) == \
        j_moe._capacity(j_base.get_arch(LLAMA4), 512) == 5


@pytest.mark.parametrize("impl", IMPLS)
def test_llama4_smoke_lm_loss_and_grads_match_jax(impl):
    """llama4's smoke LM (a dense ``attn`` layer, then a top-1 ``moe``
    layer) in f32 on each dispatch: the forward on both attention impls
    and ``Model.loss`` (cross-entropy + aux) with its gradients against
    ``jax.value_and_grad`` of the reference's at 1e-5 (the gradients
    scaled by their largest magnitude), under remat "none" and
    "full"."""
    jm, jp, tm, tp = _lm(LLAMA4, "float32")
    assert tm.cfg.pattern() == ("attn", "moe")
    j_tr.MOE_IMPL[0] = t_tr.MOE_IMPL[0] = impl
    toks = _tokens(tm.cfg, 2, 24, seed=5)
    v = tm.cfg.vocab_size
    for attn_impl in ("ref", "flash"):
        want = jm.forward(jp, {"tokens": jnp.asarray(toks)}, impl=attn_impl)
        got = tm.forward(tp, {"tokens": torch.as_tensor(toks)},
                         impl=attn_impl)
        _close(got[..., :v], np.asarray(want)[..., :v], "float32")
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -100
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, jb, remat="none"))(jp)
    for remat in ("none", "full"):
        tq = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
        loss = tm.loss(tq, tb, remat=remat)
        loss.backward()
        _close(loss, jl, "float32")
        for g, j in zip([t.grad for t in jax.tree.leaves(tq)],
                        jax.tree.leaves(jg)):
            _close(g, j, "float32", scaled=True)


def test_llama4_trees_and_convert():
    """llama4's full tree on the meta device: the reference's shapes and
    dtypes, dense and MoE layers in one ("attn", "moe") segment of 24
    repeats, the f32 router beside bf16 experts, 394.67 B elements;
    18,429,404,160 at the 2 layers the card runs.  ``lm_params_from_jax``
    carries the smoke LM's mixed tree (f32 router, bf16 everything else)
    bitwise, dtype by dtype."""
    jc = j_base.get_arch(LLAMA4)
    tm = t_model.build(t_base.get_arch(LLAMA4))
    shapes = tm.param_shapes()
    leaves = jax.tree.leaves(shapes)
    jleaves = jax.tree.leaves(j_tr.lm_param_shapes(jc))
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in leaves] == \
        [(tuple(j.shape), str(j.dtype)) for j in jleaves]
    assert sum(t.numel() for t in leaves) == 394_674_017_280
    seg = shapes["stack"][0]
    assert set(seg) == {"b0", "b1"} and "moe" in seg["b1"] and \
        "moe" not in seg["b0"]
    moe = seg["b1"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["wi"].shape) == (24, 128, 5120, 8192)
    assert {moe[k].dtype for k in ("wi", "wg", "wo")} == {torch.bfloat16}
    cut = t_model.build(dataclasses.replace(t_base.get_arch(LLAMA4),
                                            n_layers=2))
    assert sum(t.numel() for t in jax.tree.leaves(cut.param_shapes())) == \
        18_429_404_160
    _, jp, _, tp = _lm(LLAMA4, "bfloat16")
    dtypes = set()
    for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert str(t.dtype)[6:] == str(j.dtype)
        dtypes.add(str(j.dtype))
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))
    assert dtypes == {"float32", "bfloat16"}
