"""The port's decoder-only LM serving path against the JAX reference.

Configs, layers, attention (``impl="ref"`` and ``impl="flash"``), decode
against full and rolling caches, the granite, phi3, recurrentgemma,
mamba2, qwen2.5, phi3.5-moe and qwen2-vl smoke LMs (``forward``,
``decode_step``, ``prefill_scan``; the recurrent blocks in
``tests/test_torch_recurrent_lm.py``, the MoE block in
``tests/test_torch_moe.py``, the encoder-decoder in
``tests/test_torch_encdec.py``), the VLM frontend (``mrope_positions``,
``forward`` and ``loss`` with patch embeddings), a 2-layer model
at granite's head layout (32 | 8 heads of 128), the full configs' param
shapes and axes, and the serve CLI.  Weights go across with
``convert.lm_params_from_jax``; inputs come from a NumPy seed.  On the CPU
``impl="flash"`` runs the kernel's plain version; the JAX ``"flash"`` route
runs its Pallas kernel in interpret mode.

Tolerances: f32 at 1e-5.  bf16 at 2e-2, the reference's own bar for bf16
(``tests/test_arch_smoke.py``, ``tests/test_kernels.py``), relative and
absolute, with the absolute part scaled by the compared tensor's largest
magnitude where that exceeds 1: XLA and torch round bf16 products and
activations at different places, and a one-ulp flip (2^-8 of the value)
in a layer's input reaches every element of its next product at the
scale of that input, small elements too.  The ``rec`` models' decode
holds f32's bar scaled the same way (``_init_caches``); mamba2's bf16
forward is held against the reference's f32 run and, by count, against
its bf16 run (``_close_logits``).
"""
import contextlib
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch.serve import prefill_scan as j_prefill_scan
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro.models import moe as j_moe
from repro.models import transformer as j_tr
from repro.models.sharding import split_meta as j_split_meta

from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import model as t_model
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tr

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the decoder-only architectures; PORTED adds the encoder-decoder
ARCHS = ("granite_3_8b", "phi3_mini_3p8b", "recurrentgemma_9b",
         "mamba2_130m", "qwen2p5_32b", "phi3p5_moe_42b", "qwen2_vl_72b",
         "mistral_large_123b", "llama4_maverick_400b")
PORTED = ARCHS + ("seamless_m4t_large_v2",)
# whole, their bf16 weights need several cards (245 and 789 GB); the
# port runs them on one cut in depth
SHARDED = ("mistral_large_123b", "llama4_maverick_400b")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype: str, scaled: bool = False):
    """Within ``dtype``'s bar; in bf16 (or f32 with ``scaled``) its
    absolute part scaled by max(1, max|want|)."""
    got, want = _np(got), _np(want)
    atol = TOL[dtype]
    if dtype == "bfloat16" or scaled:
        atol *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=atol)


def _both(a: np.ndarray, dtype: str = "float32"):
    """The same values in each package's ``dtype``."""
    return (jnp.asarray(a).astype(dtype),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _to_torch(tree):
    return convert.lm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _cfgs(arch: str, dtype: str, **kw):
    jc = dataclasses.replace(j_base.get_arch(arch, smoke=True), dtype=dtype,
                             **kw)
    return jc, t_base.ModelConfig(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def reference_fields(tc) -> dict:
    """``tc``'s fields, less the port's own ``router_experts`` (unset on
    every registered architecture: each layer holds all its experts)."""
    fields = dataclasses.asdict(tc)
    assert fields.pop("router_experts") == 0
    return fields


def router_params(tc) -> int:
    """The MoE routers' weights, which the port's ``param_count`` counts
    and the reference's leaves out."""
    return (sum(k == "moe" for k in tc.pattern()) * tc.d_model
            * tc.resolved_router_experts)


def _lm(arch: str, dtype: str, **kw):
    """(JAX model, its params, port model, the same params as tensors)."""
    jc, tc = _cfgs(arch, dtype, **kw)
    jm = j_model.build(jc)
    jp = jm.init(jax.random.key(0))
    return jm, jp, t_model.build(tc), _to_torch(jp)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_configs_match_the_reference():
    """Every architecture's ModelConfig methods (pattern, segments, counts)
    agree with the reference's; every config equals the reference's, full
    and smoke."""
    assert t_base.ARCH_IDS == j_base.ARCH_IDS
    assert t_base.ARCH_ALIASES == j_base.ARCH_ALIASES
    assert t_base.INPUT_SHAPES == {
        k: t_base.ShapeConfig(*dataclasses.astuple(v))
        for k, v in j_base.INPUT_SHAPES.items()}
    assert t_base.get_shape("long_500k").seq_len == 524_288
    for arch in j_base.ARCH_IDS:
        for smoke in (False, True):
            jc = j_base.get_arch(arch, smoke=smoke)
            tc = t_base.ModelConfig(**dataclasses.asdict(jc))
            assert tc.pattern() == jc.pattern()
            assert tc.segments() == jc.segments()
            assert tc.param_count() == jc.param_count() + router_params(tc)
            assert (tc.active_param_count()
                    == jc.active_param_count() + router_params(tc))
            assert tc.resolved_head_dim == jc.resolved_head_dim
            assert tc.supports_long_context() == jc.supports_long_context()
            for shape in j_base.INPUT_SHAPES.values():
                assert t_model.effective_window(
                    tc, t_base.ShapeConfig(*dataclasses.astuple(shape))) == \
                    j_model.effective_window(jc, shape)
            assert reference_fields(t_base.get_arch(arch, smoke)) == \
                dataclasses.asdict(jc)
    assert set(PORTED) == set(j_base.ARCH_IDS)
    assert t_base.get_arch("granite-3-8b").n_layers == 40
    assert t_base.get_arch("paper-mlp").hidden == 128
    assert t_model.parse_long_variant(t_base.get_arch("granite_3_8b")) == 4096
    assert 8.1e9 < t_base.get_arch("granite_3_8b").param_count() < 8.2e9


def test_unported_kinds_modes_and_models_raise():
    """Unknown block kinds, modes, remats and impls raise; every block kind
    of the reference is ported, and the models with a frontend build; the
    architectures that need several cards whole are no longer refused:
    ``get_arch`` returns their configs equal to the reference's, and no
    architecture waits."""
    _, tc = _cfgs("granite_3_8b", "float32")
    assert set(t_tr.KINDS) == {"attn", "moe", "rec", "ssd"}
    with pytest.raises(ValueError, match="conv"):
        t_tr.init_block(None, tc, "conv")
    with pytest.raises(ValueError, match="mode"):
        t_tr.apply_stack([], tc, torch.zeros(1, 1, 128), None, mode="scan")
    with pytest.raises(ValueError, match="remat"):
        t_tr.apply_stack([], tc, torch.zeros(1, 1, 128), None, mode="train",
                         remat="offload")
    for arch in ("seamless_m4t_large_v2", "qwen2_vl_72b"):
        jc = j_base.get_arch(arch, smoke=True)
        tm = t_model.build(t_base.ModelConfig(**dataclasses.asdict(jc)))
        assert tm.is_encdec == (arch == "seamless_m4t_large_v2")
    for arch in SHARDED:
        for smoke in (False, True):
            assert reference_fields(t_base.get_arch(arch, smoke)) == \
                dataclasses.asdict(j_base.get_arch(arch, smoke))
    assert not hasattr(t_base, "WAITING")
    with pytest.raises(ValueError, match="impl"):
        t_attn.attention(None, None, None, tc, impl="pallas")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    """rmsnorm, layernorm, dense (with bias), embed, unembed, rope_freqs,
    apply_rope, apply_mrope and mlp (swiglu, geglu, gelu, relu) on the same
    inputs."""
    rng = np.random.default_rng(1)
    d, f = 64, 96
    jx, tx = _both(rng.standard_normal((2, 8, d)).astype(np.float32), dtype)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    (js, ts), (jb, tb) = _both(scale, dtype), _both(bias, dtype)
    _close(t_layers.rmsnorm({"scale": ts}, tx, 1e-6),
           j_layers.rmsnorm({"scale": js}, jx, 1e-6), dtype)
    _close(t_layers.layernorm({"scale": ts, "bias": tb}, tx),
           j_layers.layernorm({"scale": js, "bias": jb}, jx), dtype)
    jw, tw = _both(rng.standard_normal((d, f)).astype(np.float32) / 8, dtype)
    jbo, tbo = _both(rng.standard_normal(f).astype(np.float32), dtype)
    _close(t_layers.dense({"w": tw, "b": tbo}, tx),
           j_layers.dense({"w": jw, "b": jbo}, jx), dtype)
    jt, tt = _both(rng.standard_normal((50, d)).astype(np.float32), dtype)
    ids = rng.integers(0, 50, (2, 8))
    te = t_layers.embed({"table": tt}, torch.as_tensor(ids))
    assert te.dtype == tt.dtype
    np.testing.assert_array_equal(
        _np(te), _np(j_layers.embed({"table": jt}, jnp.asarray(ids))))
    tu = t_layers.unembed({"table": tt}, tx)
    assert tu.dtype == torch.float32
    _close(tu, j_layers.unembed({"table": jt}, jx), "float32")
    for hd in (32, 96, 128):
        np.testing.assert_allclose(
            _np(t_layers.rope_freqs(hd, 10_000.0)),
            _np(j_layers.rope_freqs(hd, 10_000.0)), rtol=1e-6)
    pos = rng.integers(0, 300, (2, 8)).astype(np.int32)
    jq, tq = _both(rng.standard_normal((2, 8, 4, 32)).astype(np.float32),
                   dtype)
    tr = t_layers.apply_rope(tq, torch.as_tensor(pos), 10_000.0)
    assert tr.dtype == tq.dtype
    _close(tr, j_layers.apply_rope(jq, jnp.asarray(pos), 10_000.0), dtype)
    pos3 = rng.integers(0, 40, (2, 8, 3)).astype(np.int32)
    _close(t_layers.apply_mrope(tq, torch.as_tensor(pos3), (4, 6, 6)),
           j_layers.apply_mrope(jq, jnp.asarray(pos3), (4, 6, 6)), dtype)
    mats = {k: _both(rng.standard_normal(s).astype(np.float32) / 8, dtype)
            for k, s in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    jp = {k: {"w": v[0]} for k, v in mats.items()}
    tp = {k: {"w": v[1]} for k, v in mats.items()}
    for act in ("swiglu", "geglu", "gelu", "relu"):
        _close(t_layers.mlp(tp, tx, act), j_layers.mlp(jp, jx, act), dtype)


def _meta_tree(tree):
    """{path: (shape, dtype name, axes)} of a JAX or port ParamMeta tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out[path] = (tuple(node.value.shape),
                         str(node.value.dtype).replace("torch.", ""),
                         node.axes)
    walk(tree, ())
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_initializers_match_jax_in_shape_dtype_axes(dtype):
    """The init_* functions build the reference's trees (shapes, dtypes,
    logical axes); a bf16 draw is the f32 draw cast, as the reference's;
    an f32 draw is unchanged for the detectors."""
    jc, tc = _cfgs("granite_3_8b", dtype, qkv_bias=True)
    key, gen = jax.random.key(0), torch.Generator().manual_seed(0)
    pairs = [
        (j_layers.init_rmsnorm(key, 64, jc), t_layers.init_rmsnorm(gen, 64, tc)),
        (j_layers.init_layernorm(key, 64, jc),
         t_layers.init_layernorm(gen, 64, tc)),
        (j_layers.init_dense(key, 64, 32, jc, bias=True),
         t_layers.init_dense(gen, 64, 32, tc, bias=True)),
        (j_layers.init_embedding(key, 50, 64, jc),
         t_layers.init_embedding(gen, 50, 64, tc)),
        (j_layers.init_mlp(key, jc), t_layers.init_mlp(gen, tc)),
        (j_attn.init_attention(key, jc), t_attn.init_attention(gen, tc)),
        (j_tr.init_block(key, jc, "attn"), t_tr.init_block(gen, tc, "attn")),
    ]
    for jt, tt in pairs:
        assert _meta_tree(tt) == _meta_tree(jt)
    assert set(t_layers.init_mlp(gen, dataclasses.replace(tc, act="gelu"))) \
        == set(j_layers.init_mlp(key, dataclasses.replace(jc, act="gelu")))
    a = t_layers.normal_init(torch.Generator().manual_seed(3), (40, 30), 0.5,
                             torch.bfloat16)
    b = t_layers.normal_init(torch.Generator().manual_seed(3), (40, 30), 0.5)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))
    c = 0.5 * torch.randn((40, 30), generator=torch.Generator().manual_seed(3))
    assert b.dtype == torch.float32 and torch.equal(b, c)
    w = t_layers.fan_in_init(torch.Generator().manual_seed(3), (40, 30))
    assert torch.equal(w, (1.0 / math.sqrt(40)) * (c / 0.5))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_cfgs(d: int, hq: int, hkv: int, window=None):
    jc = j_base.ModelConfig(name="attn-test", family="dense", n_layers=1,
                            d_model=64, n_heads=hq, n_kv_heads=hkv, d_ff=64,
                            vocab_size=64, head_dim=d, dtype="float32",
                            sliding_window=window)
    return jc, t_base.ModelConfig(**dataclasses.asdict(jc))


@pytest.mark.parametrize("d,hq,hkv,window", [
    (32, 4, 2, None), (64, 4, 1, 16), (96, 4, 4, None), (128, 8, 2, 24)])
def test_attention_matches_jax(d, hq, hkv, window):
    """``attention`` with ``impl="ref"`` against the reference's jnp path,
    and ``impl="flash"`` (the kernel's plain version here) against the
    Pallas kernel in interpret mode, at D = 32, 64, 96, 128 with GQA and a
    window; f32 at 1e-5."""
    jc, tc = _attn_cfgs(d, hq, hkv)
    jp = j_attn.init_attention(jax.random.key(d), jc)
    jv, _ = j_split_meta(jp)
    tp = _to_torch(jv)
    rng = np.random.default_rng(d)
    jx, tx = _both(rng.standard_normal((2, 64, 64)).astype(np.float32))
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64))
    jpos, tpos = jnp.asarray(pos), torch.as_tensor(pos.copy())
    for impl in ("ref", "flash"):
        got = t_attn.attention(tp, tx, tpos, tc, window=window, impl=impl)
        want = j_attn.attention(jv, jx, jpos, jc, window=window, impl=impl)
        _close(got, want, "float32")


def _decode_run(window, cache_len: int, steps: int, dtype: str):
    """Decode ``steps`` tokens one at a time in both packages, comparing
    the output and the caches after every step (the port writes its cache
    in place)."""
    jc, tc = _attn_cfgs(32, 4, 2)
    jc, tc = (dataclasses.replace(c, dtype=dtype) for c in (jc, tc))
    jv, _ = j_split_meta(j_attn.init_attention(jax.random.key(1), jc))
    tp = _to_torch(jv)
    jcache = j_attn.init_cache(jc, 2, cache_len)
    tcache = t_attn.init_cache(tc, 2, cache_len)
    assert tcache["k"].dtype == torch.bfloat16
    rng = np.random.default_rng(cache_len)
    for t in range(steps):
        jx, tx = _both(rng.standard_normal((2, 1, 64)).astype(np.float32),
                       dtype)
        pos = np.full((2, 1), t, np.int32)
        jo, jcache = j_attn.decode_attention(
            jv, jx, jcache, jnp.asarray(t), jnp.asarray(pos), jc,
            window=window)
        to, tcache2 = t_attn.decode_attention(
            tp, tx, tcache, t, torch.as_tensor(pos), tc, window=window)
        assert tcache2 is tcache
        _close(to, jo, dtype)
        for name in ("k", "v"):
            _close(tcache[name], jcache[name], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_full_cache(dtype):
    _decode_run(None, 12, 12, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_rolling_cache_before_and_after_wrap(dtype):
    """A rolling cache of 8 slots over 13 steps: 8 before the wrap, 5
    after it (slots overwritten at index % 8, every slot valid)."""
    _decode_run(8, 8, 13, dtype)


# ---------------------------------------------------------------------------
# the smoke LMs
# ---------------------------------------------------------------------------


def _f32_logits(arch: str, dtype: str, toks: np.ndarray) -> np.ndarray:
    """The reference's logits of the same weights run in f32."""
    jm, jp, tm, _ = _lm(arch, dtype)
    jm32 = j_model.build(dataclasses.replace(jm.cfg, dtype="float32"))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    v = tm.cfg.vocab_size
    return np.asarray(jm32.forward(jp32, {"tokens": jnp.asarray(toks)}),
                      np.float32)[..., :v]


def _beyond(got, want, dtype: str) -> int:
    got, want = _np(got), _np(want)
    atol = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    return int((np.abs(got - want) > atol + TOL[dtype] * np.abs(want)).sum())


# Held against the reference's f32 run in bf16: XLA on the CPU rounds the
# reference's own bf16 logits of mamba2's smoke LM past the bar from its
# f32 run of the same weights in 92 of 32,768 elements (the port's: none).
F32_ANCHORED = ("mamba2_130m",)
# Routed: a top-2 choice that bf16's rounding flips (XLA's and torch's
# round apart) moves the token's output and, through attention, every later
# position's.  So in bf16 these are held (``_close_routed``) at the bar
# wherever no flip reaches, each flip justified by its gate margin, and the
# logits past the bar from the reference's bf16 run in no more elements
# than that run is from its own f32 run (phi3.5-moe's smoke LM: 445
# against 1,302 of 32,768).
ROUTED = ("phi3p5_moe_42b",)


@contextlib.contextmanager
def routing_spy():
    """The router's softmax gates [b, s, e] (f32) of every ``moe`` block
    call, in call order, of each package: ``{"jax": [...], "torch":
    [...]}``.  The reference's are read through an ordered
    ``jax.debug.callback`` from inside its layer scan; only its einsum
    dispatch calls ``route``."""
    rec = {"jax": [], "torch": []}
    j_route, t_choose = j_moe.route, t_moe._choose

    def j_spy(router_w, x, cfg):
        gates = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", x.astype(jnp.float32), router_w), axis=-1)
        jax.debug.callback(lambda g: rec["jax"].append(np.asarray(g)),
                           gates, ordered=True)
        return j_route(router_w, x, cfg)

    def t_spy(router_w, x, cfg):
        out = t_choose(router_w, x, cfg)
        rec["torch"].append(out[0].detach().float().numpy())
        return out

    j_moe.route, t_moe._choose = j_spy, t_spy
    try:
        yield rec
    finally:
        j_moe.route, t_moe._choose = j_route, t_choose


def routing_flips(want_gates, got_gates, k: int) -> dict:
    """The top-``k`` expert sets of two runs, call by call: the share of
    (token, call) sets that agree, each row's first position where a set
    differs in any call (S where none), and each flip's gate margin (the
    smaller of the two runs' gaps between their k-th and (k+1)-th gate)
    beside the two runs' own gate gap at that token (the largest
    difference of a gate), which a flip's margin must not exceed: a set
    that the two runs' gates order apart."""
    assert len(want_gates) == len(got_gates) > 0
    b, s, _ = want_gates[0].shape
    first = np.full(b, s)
    agree = total = 0
    flips = []
    for w, g in zip(want_gates, got_gates):
        tw = np.sort(np.argsort(-w, axis=-1, kind="stable")[..., :k], -1)
        tg = np.sort(np.argsort(-g, axis=-1, kind="stable")[..., :k], -1)
        same = (tw == tg).all(-1)  # [b, s]
        agree += int(same.sum())
        total += same.size
        sw, sg = -np.sort(-w, -1), -np.sort(-g, -1)
        for bi, si in zip(*np.nonzero(~same)):
            first[bi] = min(first[bi], si)
            margin = min(sw[bi, si, k - 1] - sw[bi, si, k],
                         sg[bi, si, k - 1] - sg[bi, si, k])
            gap = float(np.abs(w[bi, si] - g[bi, si]).max())
            flips.append((float(margin), gap))
    return {"share": agree / total, "first": first, "flips": flips, "s": s}


def check_flips(routing: dict) -> None:
    """Every flip's margin within the two runs' gate gap."""
    for margin, gap in routing["flips"]:
        assert margin <= gap, routing["flips"]


def _close_logits(arch: str, got, want, dtype: str, f32_want,
                  routing=None):
    """Logits at ``dtype``'s bar against the reference's.  For an arch of
    ``F32_ANCHORED`` in bf16, instead: within the bar of the reference's
    f32 run (``f32_want()``) everywhere, and past the bar from the
    reference's bf16 run in no more elements than that run is from its
    own f32 run.  For one of ``ROUTED`` in bf16, given the two runs'
    ``routing`` (:func:`routing_flips`) of ``[B, S]`` logits: each row at
    the bar before its first flip (a row of ``last_only`` logits only
    without one), every flip within its gate gap, and the count as for
    ``F32_ANCHORED``."""
    if dtype == "float32" or arch not in F32_ANCHORED + ROUTED:
        _close(got, want, dtype)
        return
    f32 = f32_want()
    if arch in F32_ANCHORED:
        _close(got, f32, dtype)
    else:
        check_flips(routing)
        got, want = _np(got), _np(want)
        for row, first in enumerate(routing["first"]):
            upto = first if got.shape[1] > 1 else int(first == routing["s"])
            if upto:
                _close(got[row, :upto], want[row, :upto], dtype)
    assert _beyond(got, want, dtype) <= _beyond(want, f32, dtype)


def _init_caches(jm, tm, tp, b: int, n: int, dtype: str):
    """Both packages' zero caches.  The reference allocates a recurrent
    block's ``conv`` cache in bf16 and its first step replaces it with one
    of the activations' dtype, which its own ``prefill_scan`` (a
    ``lax.scan``, whose carry keeps its type) refuses for an f32 model; so
    its ``conv`` starts in the model's dtype here, as the port's does.  An
    f32 model with ``rec`` blocks keeps every cache in f32 on both sides:
    a ``rec`` layer's f32 output differs from the reference's by ~1e-6,
    enough to round one value of the next attention layer's bf16 k/v an
    ulp apart, which moves the logits by ~1e-4 (ROADMAP Queue 3).  That
    ~1e-6 is an ulp of XLA's and torch's ``exp`` in the RG-LRU's
    sqrt(1 − a²), amplified ~500× where a nears 0.999; step after step it
    reaches the state at ~1e-5 of its largest magnitude, so a ``rec``
    model's decode is held at f32's bar scaled as bf16's is
    (:func:`_close`'s ``scaled``).  A top-1 MoE (llama4) in f32 keeps
    f32 caches too: its expert outputs reach ~30 (the reference's fan-in,
    the whole gate of 1 on one expert), so one bf16 k/v value rounded an
    ulp apart at step 0 moves its logits by 3.3e-5 (on f32 caches:
    6e-7)."""
    jcaches = jm.init_cache(b, n)
    tcaches = tm.init_cache(b, n, params=tp)
    if dtype == "float32" and ("rec" in tm.cfg.pattern()
                               or tm.cfg.experts_per_token == 1):
        return (jax.tree.map(lambda a: a.astype(jnp.float32), jcaches),
                jax.tree.map(lambda t: t.float(), tcaches))
    def conv_in_dtype(path, a):
        return a.astype(dtype) if path[-1].key == "conv" else a

    return jax.tree_util.tree_map_with_path(conv_in_dtype, jcaches), tcaches


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_lm_forward_matches_jax(arch, dtype):
    """Full and ``last_only`` logits, on both impls, against the
    reference's ``Model.forward``; the padded vocab is exactly −1e30."""
    jm, jp, tm, tp = _lm(arch, dtype)
    toks = _tokens(tm.cfg, 2, 32)
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)
    routed = dtype == "bfloat16" and arch in ROUTED

    def both(**kw):
        """(port's, reference's logits, their routing when ROUTED)."""
        with routing_spy() if routed else contextlib.nullcontext() as rec:
            want = np.asarray(jm.forward(jp, {"tokens": jt}, **kw))
            got = tm.forward(tp, {"tokens": tt}, **kw)
            jax.effects_barrier()
        return got, want, (routing_flips(rec["jax"], rec["torch"],
                                         tm.cfg.experts_per_token)
                           if routed else None)

    got, want, routing = both()
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 32, t_tr.padded_vocab(tm.cfg))
    v = tm.cfg.vocab_size
    f32 = functools.partial(_f32_logits, arch, dtype, toks)
    _close_logits(arch, got[..., :v], want[..., :v], dtype, f32, routing)
    assert bool((got[..., v:] == -1e30).all())
    last, want_last, routing = both(impl="flash", last_only=True)
    assert tuple(last.shape) == (2, 1, t_tr.padded_vocab(tm.cfg))
    _close_logits(arch, last[..., :v], want_last[..., :v], dtype,
                  lambda: f32()[:, -1:], routing)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_lm_decode_and_prefill_scan_match_jax(arch, dtype):
    """A sequence of ``decode_step``s against the reference's, logits (at
    ``dtype``'s bar) and every cache (at bf16's bar if it or the model is
    bf16, else at f32's) after each step; ``prefill_scan`` bitwise the
    port's own decode loop, and against the reference's ``prefill_scan``."""
    jm, jp, tm, tp = _lm(arch, dtype)
    toks = _tokens(tm.cfg, 2, 10, seed=1)
    v = tm.cfg.vocab_size
    scaled = "rec" in tm.cfg.pattern()
    jcaches, tcaches = _init_caches(jm, tm, tp, 2, 16, dtype)
    fresh = tcaches
    assert jax.tree.structure(jcaches) == jax.tree.structure(
        jax.tree.map(lambda x: 0, tcaches))
    # ROUTED in bf16: a row is held at the bar, logits and caches, until a
    # step flips one of its top-2 choices, each flip within its gate gap
    # (phi3.5-moe's smoke LM: one, at step 3, margin 2.3e-4 under a gap of
    # 7.1e-4); the row is not held after it
    routed = dtype == "bfloat16" and arch in ROUTED
    rows = np.arange(2)
    loop = []
    for t in range(toks.shape[1]):
        with routing_spy() if routed else contextlib.nullcontext() as rec:
            jl, jcaches = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                         jcaches, jnp.asarray(t))
            tl, tcaches = tm.decode_step(
                tp, torch.as_tensor(toks[:, t:t + 1]), tcaches, t)
            jax.effects_barrier()
        loop.append(tl)
        if routed:
            routing = routing_flips(rec["jax"], rec["torch"],
                                    tm.cfg.experts_per_token)
            check_flips(routing)
            rows = rows[routing["first"][rows] > 0]
        _close(tl[rows, :, :v], np.asarray(jl)[rows, :, :v], dtype, scaled)
        for jc_, tc_ in zip(jax.tree.leaves(jcaches),
                            jax.tree.leaves(tcaches)):
            # at the bar of bf16 where the cache or the model is bf16: both
            # sides round values that differ by ~1e-7 to it, so one may
            # land an ulp apart, and a bf16 model's f32 state inherits that
            # (the stacked caches' batch is their second axis)
            stored = str(tc_.dtype).removeprefix("torch.")
            _close(tc_[:, rows], np.asarray(jc_)[:, rows],
                   "bfloat16" if "bfloat16" in (stored, dtype)
                   else "float32", scaled)
    jscan, scan_caches = _init_caches(jm, tm, tp, 2, 16, dtype)
    assert all(a.dtype == b.dtype and not a.any() for a, b in zip(
        jax.tree.leaves(scan_caches), jax.tree.leaves(fresh)))
    last, scan_caches = t_serve.prefill_scan(tm, tp, torch.as_tensor(toks),
                                             scan_caches)
    assert torch.equal(last, loop[-1])
    for a, b in zip(jax.tree.leaves(scan_caches), jax.tree.leaves(tcaches)):
        assert torch.equal(a, b)
    j_last, _ = j_prefill_scan(jm, jp, jnp.asarray(toks), jscan)
    _close(last[rows, :, :v], np.asarray(j_last)[rows, :, :v], dtype, scaled)


def test_granite_head_layout_through_flash_matches_jax_interpret():
    """Two layers at granite's head layout (32 q heads | 8 kv heads of 128)
    through ``impl="flash"`` against the Pallas kernel in interpret mode,
    f32 at 1e-5."""
    jc = dataclasses.replace(j_base.get_arch("granite_3_8b", smoke=True),
                             d_model=256, n_heads=32, n_kv_heads=8,
                             head_dim=128, d_ff=512, dtype="float32")
    tc = t_base.ModelConfig(**dataclasses.asdict(jc))
    jm, tm = j_model.build(jc), t_model.build(tc)
    jp = jm.init(jax.random.key(2))
    tp = _to_torch(jp)
    toks = _tokens(tc, 1, 64, seed=2)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)}, impl="flash",
                      last_only=True)
    got = tm.forward(tp, {"tokens": torch.as_tensor(toks)}, impl="flash",
                     last_only=True)
    v = tc.vocab_size
    _close(got[..., :v], np.asarray(want)[..., :v], "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_shapes_and_axes_equal_jax(arch):
    """``param_shapes()`` and ``axes()`` of the FULL config equal the
    reference's ``lm_param_shapes``/``lm_axes``, built on the meta device:
    nothing is allocated."""
    jc = j_base.get_arch(arch)
    tm = t_model.build(t_base.get_arch(arch))
    jshapes, jaxes = j_tr.lm_param_shapes(jc), j_tr.lm_axes(jc)
    tshapes, taxes = tm.param_shapes(), tm.axes()
    tl, jl = jax.tree.leaves(tshapes), jax.tree.leaves(jshapes)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, tshapes)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, jshapes))
    assert all(t.device.type == "meta" for t in tl)
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in tl] == \
        [(tuple(j.shape), str(j.dtype)) for j in jl]
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.leaves(taxes, is_leaf=is_axes) == \
        jax.tree.leaves(jaxes, is_leaf=is_axes)
    n = sum(t.numel() for t in tl)
    # param_count leaves out the RG-LRU gate matrices wa and wx, as the
    # reference's does
    gates = 2 * (tm.cfg.lru_width or tm.cfg.d_model) ** 2 * \
        tm.cfg.pattern().count("rec")
    assert abs(n - gates - tm.cfg.param_count()) / n < 0.01
    if arch == "granite_3_8b":
        assert tl[-1].shape[0] == 40  # the stacked "layers" axis


def test_flash_launch_plan_takes_the_lm_shapes():
    """K3's plan for the LM prefills in bf16 is the tensor-core kernel:
    granite (D = 128, GQA group 4), phi3 (D = 96, MHA) and
    recurrentgemma's local attention (D = 256, MQA: 32-key tiles), S = T up
    to 4,096: 64 positions of one head a block (4 warps), grid (heads,
    batch, ⌈S / 64⌉), above the 48 KB static limit and within the 227 KB
    opt-in.  f32 (the 2-layer card-vs-CPU check) stays on the row kernel
    and is refused at D = 256."""
    for (b, hq, hkv, d), (dmax, key_tile) in (
            ((4, 32, 8, 128), (128, 64)), ((1, 32, 32, 96), (96, 64)),
            ((1, 16, 1, 256), (256, 32))):
        for s in (1, 128, 512, 1000, 4096):
            plan = t_fa.launch_plan(b, s, s, hq, hkv, d, torch.bfloat16, True)
            assert (plan.kernel, plan.dmax, plan.rows, plan.heads,
                    plan.threads, plan.key_tile) == \
                ("mma", dmax, 64, 1, 128, key_tile)
            assert plan.grid == (hq, b, -(-s // 64))
            assert t_fa.MAX_SMEM < plan.smem_bytes <= t_fa.MAX_SMEM_OPTIN
    row = t_fa.launch_plan(2, 128, 128, 32, 8, 128, torch.float32, True)
    assert (row.kernel, row.dmax, row.rows, row.heads, row.lanes) == \
        ("row", 128, 64, 1, 1)
    assert row.smem_bytes == 2 * 32 * 128 * 4 <= t_fa.MAX_SMEM
    with pytest.raises(ValueError, match="f32"):
        t_fa.launch_plan(1, 512, 512, 16, 1, 256, torch.float32, True)


def test_convert_keeps_dtypes_bitwise():
    jm, jp, _, tp = _lm("granite_3_8b", "bfloat16")
    for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))
    caches = convert.lm_caches_from_jax(jm.init_cache(2, 4), "cpu")
    assert caches[0]["b0"]["k"].dtype == torch.bfloat16
    assert tuple(caches[0]["b0"]["k"].shape) == (2, 2, 4, 2, 32)


def test_model_init_draws_layer_by_layer_into_stacked_params():
    """``Model.init`` on the CPU: the reference's tree, bf16 leaves, a seed
    repeats bitwise and a generator given is used; two layers differ."""
    tm = t_model.build(t_base.get_arch("granite_3_8b", smoke=True))
    p1 = tm.init(0, device="cpu")
    p2 = tm.init(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    wq = p1["stack"][0]["b0"]["attn"]["wq"]["w"]
    assert wq.shape == (2, 128, 128) and not torch.equal(wq[0], wq[1])
    assert float(wq.float().std()) == pytest.approx(128 ** -0.5, rel=0.05)


def test_serve_cli_on_the_cpu():
    """The serve CLI at smoke size: greedy tokens in the vocab, the first
    equal to the argmax of the prefill's last logits, and a sampled run."""
    out = t_serve.main(["--arch", "granite_3_8b", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "5",
                        "--new-tokens", "3"])
    toks = out["tokens"]
    assert tuple(toks.shape) == (2, 3)
    assert bool(((toks >= 0) & (toks < 512)).all())
    first = out["prefill_logits"][:, 0, :512].argmax(-1)
    assert torch.equal(toks[:, 0], first)
    assert out["tok_per_s"] > 0
    sampled = t_serve.main(["--arch", "phi3_mini_3p8b", "--device", "cpu",
                            "--batch", "1", "--prompt-len", "3",
                            "--new-tokens", "2", "--temperature", "1.0"])
    assert tuple(sampled["tokens"].shape) == (1, 2)


@pytest.mark.parametrize("arch", ["qwen2p5_32b", "phi3p5_moe_42b",
                                  "qwen2_vl_72b", "seamless_m4t_large_v2"])
def test_serve_cli_serves_the_new_families(arch):
    """The serve CLI at smoke size on the CPU for qwen2.5, phi3.5-moe,
    qwen2-vl (text only, as the reference's CLI) and seamless (through
    ``init_cache``'s zero encoder output): greedy tokens in the vocab, the
    first the argmax of the prefill's last logits."""
    out = t_serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                        "--prompt-len", "5", "--new-tokens", "3"])
    toks = out["tokens"]
    assert tuple(toks.shape) == (2, 3)
    assert bool(((toks >= 0) & (toks < 512)).all())
    first = out["prefill_logits"][:, 0, :512].argmax(-1)
    assert torch.equal(toks[:, 0], first)


# ---------------------------------------------------------------------------
# the VLM frontend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_front,n_text,grid_w", [
    (16, 12, 16), (1024, 512, 16), (10, 3, 4), (0, 7, 16)])
def test_mrope_positions_match_jax(n_front, n_text, grid_w):
    """(t, h, w) ids of [patches; text] equal the reference's."""
    got = t_model.mrope_positions(3, n_front, n_text, grid_w)
    want = j_model.mrope_positions(3, n_front, n_text, grid_w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _vlm_batch(cfg, dtype: str, b: int = 2, n_text: int = 12, seed: int = 4):
    rng = np.random.default_rng(seed)
    front = rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model))
    jf, tf = _both(front.astype(np.float32), dtype)
    toks = _tokens(cfg, b, n_text, seed)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -100
    return ({"frontend": jf, "tokens": jnp.asarray(toks),
             "labels": jnp.asarray(labels)},
            {"frontend": tf, "tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_forward_with_patches_matches_jax(dtype):
    """qwen2-vl's smoke LM with 16 stub patch embeddings before 12 text
    tokens on M-RoPE positions: the logits of every position (patches
    included) and ``last_only`` on both impls against the reference's."""
    jm, jp, tm, tp = _lm("qwen2_vl_72b", dtype)
    jb, tb = _vlm_batch(tm.cfg, dtype)
    v = tm.cfg.vocab_size
    for impl, last_only in (("ref", False), ("flash", True)):
        want = jm.forward(jp, jb, impl=impl, last_only=last_only)
        got = tm.forward(tp, tb, impl=impl, last_only=last_only)
        assert got.shape[1] == (1 if last_only else 16 + 12)
        _close(got[..., :v], np.asarray(want)[..., :v], dtype)


def test_vlm_loss_and_grads_match_jax_value_and_grad():
    """``Model.loss`` with patches (the patches' logits dropped, M-RoPE
    positions) and its gradients against ``jax.value_and_grad`` in f32,
    the patch embeddings' gradient too; ``transformer.lm_loss`` with
    ``extra_embeds`` on default positions against the reference's."""
    jm, jp, tm, tp = _lm("qwen2_vl_72b", "float32")
    jb, tb = _vlm_batch(tm.cfg, "float32")
    (jl, (jg, jgf)) = jax.value_and_grad(
        lambda p, f: jm.loss(p, {**jb, "frontend": f}, remat="none"),
        argnums=(0, 1))(jp, jb["frontend"])
    tq = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    front = tb["frontend"].clone().requires_grad_(True)
    loss = tm.loss(tq, {**tb, "frontend": front}, remat="full")
    loss.backward()
    _close(loss, jl, "float32")
    for g, j in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad, tq)),
                    jax.tree.leaves(jg)):
        _close(g, j, "float32", scaled=True)
    _close(front.grad, jgf, "float32", scaled=True)
    jc, tc = _cfgs("granite_3_8b", "float32")
    jm, jp, tm, tp = _lm("granite_3_8b", "float32")
    extra = np.random.default_rng(2).standard_normal((2, 5, 128))
    je, te = _both(extra.astype(np.float32))
    toks = _tokens(tc, 2, 9, seed=2)
    want = j_tr.lm_loss(jp, jc, jnp.asarray(toks), jnp.asarray(toks),
                        remat="none", extra_embeds=je)
    got = t_tr.lm_loss(tp, tc, torch.as_tensor(toks), torch.as_tensor(toks),
                       remat="none", extra_embeds=te)
    _close(got, want, "float32")


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_qwen2p5_loss_and_grads_match_jax_value_and_grad(remat):
    """qwen2.5's smoke LM (QKV bias) in f32: ``Model.loss`` and its
    gradients, the biases' included, against ``jax.value_and_grad`` of the
    reference's at 1e-5 (gradients scaled by their largest magnitude)."""
    jm, jp, tm, tp = _lm("qwen2p5_32b", "float32")
    toks = _tokens(tm.cfg, 2, 16, seed=7)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, jb, remat="none"))(jp)
    tq = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    loss = tm.loss(tq, tb, remat=remat)
    loss.backward()
    _close(loss, jl, "float32")
    assert "b" in tq["stack"][0]["b0"]["attn"]["wq"]
    for g, j in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad, tq)),
                    jax.tree.leaves(jg)):
        _close(g, j, "float32", scaled=True)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_mistral_loss_and_grads_match_jax_value_and_grad(remat):
    """mistral-large's smoke LM (a GQA group of 4, swiglu) in f32:
    ``Model.loss`` and its gradients against ``jax.value_and_grad`` of the
    reference's at 1e-5 (gradients scaled by their largest magnitude)."""
    jm, jp, tm, tp = _lm("mistral_large_123b", "float32")
    toks = _tokens(tm.cfg, 2, 16, seed=8)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, jb, remat="none"))(jp)
    tq = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    loss = tm.loss(tq, tb, remat=remat)
    loss.backward()
    _close(loss, jl, "float32")
    for g, j in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad, tq)),
                    jax.tree.leaves(jg)):
        _close(g, j, "float32", scaled=True)
