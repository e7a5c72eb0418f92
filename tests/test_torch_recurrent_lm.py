"""The port's recurrent LM families against the JAX reference on the CPU:
the ``rec`` block (RG-LRU, recurrentgemma) and the ``ssd`` block (Mamba-2,
mamba2), their decode steps and caches, and both smoke LMs.

* ``rglru_block`` with and without ``state`` on both impls (the port's
  ``"flash"`` runs ``rglru_scan``'s plain version here, the reference's
  its Pallas kernel in interpret mode), ``rglru_decode_step``;
* ``ssd_block`` with and without ``state``, ``ssd_chunked``'s default
  chunk recurrence against the detector's route and the reference's
  ``lax.scan``,
  ``ssd_decode_step``;
* both smoke LMs: the prefill forward on both impls, ``prefill_scan`` and
  decode over a prompt longer than recurrentgemma-smoke's window of 32
  (the rolling cache wraps) with the logits and every cache compared after
  every step, ``Model.loss`` and its gradients;
* the full configs' trees on the meta device, the registry, the serve
  CLI's default, the kernels' launch plans at the shapes
  ``chip_smoke.py``'s phase 18 launches, and that phase's f64 run.

Weights go across with ``convert.lm_params_from_jax``; inputs come from a
NumPy seed.  The decode steps write their state into the cache they are
given (the reference returns a new one), so every step compares the
port's cache, updated in place, with the reference's returned one.

Tolerances: f32 at 1e-5, relative and absolute; bf16 at 2e-2, the
absolute part scaled by max(1, max|want|) (``tests/test_torch_lm.py``).
The ``rec`` block's decode in f32 takes f32's 1e-5 scaled the same way:
an ulp of XLA's and torch's ``exp`` in the RG-LRU's sqrt(1 − a²) is
amplified ~500× where a nears 0.999, and step after step reaches the
state at up to ~1e-5 of its largest magnitude.  Gradients: 1e-5 of each
leaf's largest magnitude.
"""
import dataclasses
import functools
import importlib.util
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import serve as j_serve_cli
from repro.launch.serve import prefill_scan as j_prefill_scan
from repro.models import model as j_model
from repro.models import rglru as j_rglru
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tr
from repro.models.sharding import split_meta as j_split_meta

from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.core import rounds as t_rounds
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import rglru_scan as t_rgk
from repro_torch.launch import serve as t_serve
from repro_torch.models import model as t_model
from repro_torch.models import rglru as t_rglru
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tr
from repro_torch.tree import tree_leaves

from test_torch_lm import reference_fields

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ARCHS = ("recurrentgemma_9b", "mamba2_130m")
DTYPES = ("float32", "bfloat16")


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
    return (jnp.asarray(a).astype(dtype),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _cfgs(arch: str, dtype: str):
    jc = dataclasses.replace(j_base.get_arch(arch, smoke=True), dtype=dtype)
    return jc, t_base.ModelConfig(**dataclasses.asdict(jc))


def _to_torch(tree):
    return convert.lm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


@functools.lru_cache(maxsize=None)
def _lm(arch: str, dtype: str):
    """(JAX model, its params, port model, the same params as tensors)."""
    jc, tc = _cfgs(arch, dtype)
    jm = j_model.build(jc)
    jp = jm.init(jax.random.key(0))
    return jm, jp, t_model.build(tc), _to_torch(jp)


def _block_params(init, arch: str, dtype: str, seed: int):
    jc, tc = _cfgs(arch, dtype)
    jp = j_split_meta(init(jax.random.key(seed), jc))[0]
    return jc, tc, jp, _to_torch(jp)


def _normal(rng, shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def _cache_close(tcache: dict, jcache: dict, dtype: str, scaled=False):
    """Each leaf of a block's cache at bf16's bar where it or the model is
    bf16 (a bf16 model's f32 state inherits its inputs' rounding), else at
    f32's, with the reference's dtype."""
    assert set(tcache) == set(jcache)
    for k in tcache:
        assert str(tcache[k].dtype).removeprefix("torch.") == \
            str(jcache[k].dtype), k
        stored = str(jcache[k].dtype)
        _close(tcache[k], jcache[k], "bfloat16"
               if "bfloat16" in (stored, dtype) else "float32", scaled)


# ---------------------------------------------------------------------------
# the rec block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_block_matches_jax(dtype, with_state, impl):
    """The LM form of the block (recurrentgemma-smoke: d = w = 128, conv
    4) over 40 steps, from zeros or from a ``state`` (``h`` the scan's h0,
    ``conv`` the conv's carried inputs); the output and the returned
    ``{"h", "conv"}``."""
    jc, tc, jp, tp = _block_params(j_rglru.init_rglru, "recurrentgemma_9b",
                                   dtype, 1)
    rng = np.random.default_rng(2)
    jx, tx = _both(_normal(rng, (2, 40, 128)), dtype)
    jstate = tstate = None
    if with_state:
        h = _normal(rng, (2, 128))
        conv = _normal(rng, (2, 3, 128))
        jstate = {"h": jnp.asarray(h), "conv": _both(conv, dtype)[0]}
        tstate = {"h": torch.as_tensor(h), "conv": _both(conv, dtype)[1]}
    jout, jcache = j_rglru.rglru_block(jp, jx, jc, state=jstate, impl=impl)
    tout, tcache = t_rglru.rglru_block(tp, tx, tc, state=tstate, impl=impl)
    assert tout.dtype == tx.dtype
    _close(tout, jout, dtype)
    _cache_close(tcache, jcache, dtype)
    if with_state:  # the state is read, not written
        assert torch.equal(tstate["h"], torch.as_tensor(h))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode_step_writes_its_cache_in_place(dtype):
    """12 one-token steps from the port's zero cache against the
    reference's: the output and the cache after every step, the cache the
    same tensors as given; ``conv`` in the model's dtype, which the
    reference's takes after its first step."""
    jc, tc, jp, tp = _block_params(j_rglru.init_rglru, "recurrentgemma_9b",
                                   dtype, 3)
    tcache = t_rglru.init_rglru_cache(tc, 2)
    assert (tcache["h"].dtype, tcache["conv"].dtype) == \
        (torch.float32, getattr(torch, dtype))
    jcache = j_rglru.init_rglru_cache(jc, 2)
    h_buf, conv_buf = tcache["h"], tcache["conv"]
    rng = np.random.default_rng(4)
    for _ in range(12):
        jx, tx = _both(_normal(rng, (2, 1, 128)), dtype)
        jout, jcache = j_rglru.rglru_decode_step(jp, jx, jcache, jc)
        tout, tcache2 = t_rglru.rglru_decode_step(tp, tx, tcache, tc)
        assert tcache2 is tcache and tcache["h"] is h_buf and \
            tcache["conv"] is conv_buf
        _close(tout, jout, dtype, scaled=True)
        _cache_close(tcache, jcache, dtype, scaled=True)


def test_rglru_block_raises_on_an_unknown_impl():
    _, tc, _, tp = _block_params(j_rglru.init_rglru, "recurrentgemma_9b",
                                 "float32", 1)
    with pytest.raises(ValueError, match="impl"):
        t_rglru.rglru_block(tp, torch.zeros(1, 2, 128), tc, impl="pallas")


# ---------------------------------------------------------------------------
# the ssd block
# ---------------------------------------------------------------------------


def _ssd_inputs(seed: int, b: int = 2, l: int = 64, h: int = 8, p: int = 32,
                n: int = 32):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (b, l, h, p))
    dt = np.log1p(np.exp(_normal(rng, (b, l, h)) - 1.0)).astype(np.float32)
    A = np.linspace(1.0, 16.0, h).astype(np.float32)
    B, C = _normal(rng, (b, l, n)), _normal(rng, (b, l, n))
    s0 = _normal(rng, (b, h, p, n))
    return x, dt, A, B, C, s0


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_default_scan_matches_routed_and_jax(with_state):
    """The default chunk recurrence (``scan_fn=None``, the LM's) bitwise
    the ``ssm`` detector's route ``chunk_scan_via(ops.rglru_scan)``, which
    takes the same plain scan on a CPU tensor, and against the reference's
    ``lax.scan`` at 1e-5, 4 chunks of 16, from zeros or ``init_state``."""
    x, dt, A, B, C, s0 = _ssd_inputs(5)
    s0 = s0 if with_state else None
    targs = [torch.as_tensor(v) for v in (x, dt, A, B, C)]
    ts0 = None if s0 is None else torch.as_tensor(s0)
    y, fin = t_ssm.ssd_chunked(*targs, 16, ts0)
    yr, finr = t_ssm.ssd_chunked(*targs, 16, ts0, scan_fn=t_ssm.chunk_scan_via(
        t_ops.rglru_scan))
    assert torch.equal(y, yr) and torch.equal(fin, finr)
    jy, jfin = j_ssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, A, B, C)),
                                 16, None if s0 is None else jnp.asarray(s0))
    _close(y, jy, "float32", scaled=True)
    _close(fin, jfin, "float32", scaled=True)
    x, dt, _, B, C = (t[:, :60] if t.dim() > 1 else t for t in targs)
    with pytest.raises(ValueError, match="chunks"):
        t_ssm.ssd_chunked(x, dt, targs[2], B, C, 16)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_block_matches_jax(dtype, with_state):
    """The LM form of the mixer (mamba2-smoke: d 128, d_in 256, 8 heads of
    32, state 32, chunk 16) over 64 steps, from zeros or a ``state``; the
    output and the returned ``{"ssm", "conv"}``."""
    jc, tc, jp, tp = _block_params(j_ssm.init_ssd, "mamba2_130m", dtype, 6)
    rng = np.random.default_rng(7)
    jx, tx = _both(_normal(rng, (2, 64, 128)), dtype)
    jstate = tstate = None
    if with_state:
        ssm = 0.1 * _normal(rng, (2, 8, 32, 32))
        conv = _normal(rng, (2, 3, 320))
        jstate = {"ssm": jnp.asarray(ssm), "conv": _both(conv, dtype)[0]}
        tstate = {"ssm": torch.as_tensor(ssm), "conv": _both(conv, dtype)[1]}
    jout, jcache = j_ssm.ssd_block(jp, jx, jc, state=jstate)
    tout, tcache = t_ssm.ssd_block(tp, tx, tc, state=tstate)
    assert tout.dtype == tx.dtype
    _close(tout, jout, dtype)
    _cache_close(tcache, jcache, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_step_writes_its_cache_in_place(dtype):
    """12 one-token steps from the port's zero cache against the
    reference's, output and cache after every step, in place."""
    jc, tc, jp, tp = _block_params(j_ssm.init_ssd, "mamba2_130m", dtype, 8)
    tcache = t_ssm.init_ssd_cache(tc, 2)
    assert (tcache["ssm"].dtype, tcache["conv"].dtype) == \
        (torch.float32, getattr(torch, dtype))
    assert tuple(tcache["ssm"].shape) == (2, 8, 32, 32)
    assert tuple(tcache["conv"].shape) == (2, 3, 320)
    jcache = j_ssm.init_ssd_cache(jc, 2)
    bufs = dict(tcache)
    rng = np.random.default_rng(9)
    for _ in range(12):
        jx, tx = _both(_normal(rng, (2, 1, 128)), dtype)
        jout, jcache = j_ssm.ssd_decode_step(jp, jx, jcache, jc)
        tout, tcache2 = t_ssm.ssd_decode_step(tp, tx, tcache, tc)
        assert tcache2 is tcache and all(tcache[k] is bufs[k] for k in bufs)
        _close(tout, jout, dtype)
        _cache_close(tcache, jcache, dtype)


# ---------------------------------------------------------------------------
# block trees and the registry
# ---------------------------------------------------------------------------


def _meta_tree(tree):
    """{path: (shape, dtype name, axes)} of a JAX or port ParamMeta tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[path] = (tuple(node.value.shape),
                         str(node.value.dtype).replace("torch.", ""),
                         node.axes)
    walk(tree, ())
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,arch", [("rec", "recurrentgemma_9b"),
                                       ("ssd", "mamba2_130m")])
def test_block_trees_match_jax_in_shape_dtype_axes(kind, arch, dtype):
    """``init_block`` of each kind builds the reference's ParamMeta tree:
    the gates, Λ, A_log, D and dt_bias in f32 whatever ``cfg.dtype``."""
    jc, tc = _cfgs(arch, dtype)
    jt = j_tr.init_block(jax.random.key(0), jc, kind)
    tt = t_tr.init_block(torch.Generator().manual_seed(0), tc, kind)
    assert _meta_tree(tt) == _meta_tree(jt)
    assert _meta_tree(t_tr.init_block(None, tc, kind)) == _meta_tree(jt)
    cache = t_tr.init_block_cache(tc, kind, 3, 99)
    jcache = j_tr.init_block_cache(jc, kind, 3, 99)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


def test_registry_lifts_both_architectures():
    """Both configs equal the reference's, full and smoke; neither kind
    nor architecture waits any more; no block kind waits (``moe`` is
    ported too), and no architecture waits: mistral-large and llama4's
    configs equal the reference's too."""
    for arch in ARCHS:
        for smoke in (False, True):
            assert reference_fields(t_base.get_arch(arch, smoke)) == \
                dataclasses.asdict(j_base.get_arch(arch, smoke))
    assert {"rec", "ssd", "moe"} <= set(t_tr.KINDS)
    assert not hasattr(t_tr, "WAITING_KINDS")
    assert not hasattr(t_base, "WAITING")
    for arch in ("mistral_large_123b", "llama4_maverick_400b"):
        for smoke in (False, True):
            assert reference_fields(t_base.get_arch(arch, smoke)) == \
                dataclasses.asdict(j_base.get_arch(arch, smoke))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_trees_match_lm_param_shapes(arch):
    """The full config's tree on the meta device: the reference's
    ``lm_param_shapes`` leaf by leaf, its element count and bytes
    (recurrentgemma-9b: 9,396,408,320 elements, 20.54 GB, of which the
    26 ``rec`` layers' wa/wx are the 3.49 GB in f32; mamba2-130m:
    129,100,224), and ``param_count``'s figure, which leaves wa/wx out,
    the reference's."""
    jc = j_base.get_arch(arch)
    tm = t_model.build(t_base.get_arch(arch))
    tl = tree_leaves(tm.param_shapes())
    jl = jax.tree.leaves(j_tr.lm_param_shapes(jc))
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in tl] == \
        [(tuple(j.shape), str(j.dtype)) for j in jl]
    n = sum(t.numel() for t in tl)
    nbytes = sum(t.numel() * t.element_size() for t in tl)
    f32 = sum(t.numel() * 4 for t in tl if t.dtype == torch.float32)
    assert tm.cfg.param_count() == jc.param_count()
    if arch == "recurrentgemma_9b":
        assert n == 9_396_408_320 and round(nbytes / 1e9, 2) == 20.54
        assert round(f32 / 1e9, 2) == 3.49
        assert round(jc.param_count() / 1e9, 2) == 8.52
    else:
        assert n == 129_100_224


# ---------------------------------------------------------------------------
# the smoke LMs
# ---------------------------------------------------------------------------


def _tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_lm_prefill_matches_jax(arch):
    """The prefill forward at [2, 64] in f32 on both impls (recurrentgemma:
    past its window of 32, the ``rec`` layers on ``rglru_scan``'s plain
    version; mamba2: 4 chunks of 16), full and ``last_only``."""
    jm, jp, tm, tp = _lm(arch, "float32")
    toks = _tokens(tm.cfg, 2, 64, 10)
    v = tm.cfg.vocab_size
    for impl in ("ref", "flash"):
        for last_only in (False, True):
            want = jm.forward(jp, {"tokens": jnp.asarray(toks)}, impl=impl,
                              last_only=last_only)
            got = tm.forward(tp, {"tokens": torch.as_tensor(toks)},
                             impl=impl, last_only=last_only)
            _close(got[..., :v], np.asarray(want)[..., :v], "float32")


def _f32_caches(tree):
    return jax.tree.map(
        lambda a: a.float() if isinstance(a, torch.Tensor)
        else a.astype(jnp.float32), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_scan_and_decode_past_the_window_match_jax(arch):
    """``prefill_scan`` of a 40-token prompt, then 8 decode steps, with a
    cache of 48 (recurrentgemma's attention keeps min(48, 32) slots, so it
    wraps at step 32), in f32: the logits and every cache against the
    reference's after every prompt step (the port's loop, bitwise its
    ``prefill_scan``) and every decode step, the port's caches the same
    tensors throughout, written in place.  Every cache is f32 on both
    sides: a
    bf16 k/v value an ulp apart moves the logits by ~1e-4
    (``tests/test_torch_lm.py``), and the reference's ``prefill_scan``
    refuses its own bf16 ``conv`` for an f32 model.  bf16 is held over 10
    steps in ``tests/test_torch_lm.py`` and over 12 a block above: over
    48, two bf16 runs stray past bf16's elementwise bar from each other in
    a few elements of some steps, the reference's bf16 run from its own
    f32 run as often as the port's (mamba2-smoke: 18 logits at step 11
    for the reference, 11 at step 31 for the port)."""
    jm, jp, tm, tp = _lm(arch, "float32")
    b, prompt, new, clen = 2, 40, 8, 48
    toks = _tokens(tm.cfg, b, prompt + new, 11)
    v = tm.cfg.vocab_size
    scaled = "rec" in tm.cfg.pattern()
    fresh = tm.init_cache(b, clen, params=tp)
    conv = [c["conv"] for seg in fresh for c in seg.values() if "conv" in c]
    assert conv and all(c.dtype == torch.float32 for c in conv)
    jcaches = _f32_caches(jm.init_cache(b, clen))
    tcaches = _f32_caches(fresh)
    bufs = jax.tree.leaves(tcaches)
    scan_caches = jax.tree.map(torch.clone, tcaches)
    jstep = jax.jit(jm.decode_step)
    loop = []
    for t in range(prompt + new):
        tok = toks[:, t:t + 1]
        jl, jcaches = jstep(jp, jnp.asarray(tok), jcaches, jnp.asarray(t))
        tl, out = tm.decode_step(tp, torch.as_tensor(tok), tcaches, t)
        assert out is tcaches and all(
            a is c for a, c in zip(jax.tree.leaves(tcaches), bufs))
        loop.append(tl)
        _close(tl[..., :v], np.asarray(jl)[..., :v], "float32", scaled)
        for seg_t, seg_j in zip(tcaches, jcaches):
            for name in seg_t:
                _cache_close(seg_t[name], seg_j[name], "float32", scaled)
    last, scan_caches = t_serve.prefill_scan(
        tm, tp, torch.as_tensor(toks[:, :prompt]), scan_caches)
    assert torch.equal(last, loop[prompt - 1])
    jlast, _ = j_prefill_scan(jm, jp, jnp.asarray(toks[:, :prompt]),
                              _f32_caches(jm.init_cache(b, clen)))
    _close(last[..., :v], np.asarray(jlast)[..., :v], "float32", scaled)


def test_reference_conv_cache_takes_the_activation_dtype():
    """What the port's ``conv`` dtype follows: the reference's f32 model
    allocates ``conv`` in bf16 and holds f32 after one step."""
    jm, jp, _, _ = _lm("mamba2_130m", "float32")
    caches = jm.init_cache(1, 4)
    assert caches[0]["b0"]["conv"].dtype == jnp.bfloat16
    _, caches = jm.decode_step(jp, jnp.zeros((1, 1), jnp.int32), caches,
                               jnp.asarray(0))
    assert caches[0]["b0"]["conv"].dtype == jnp.float32


def _grads_close(got, want):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(
            a, b, rtol=0, atol=TOL["float32"] * max(float(np.abs(b).max()),
                                                    1e-12))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_and_grads_match_jax(arch):
    """``Model.loss`` (remat "full") and its gradients in f32 against the
    reference's ``jax.value_and_grad``; remat "none" bitwise the same."""
    jm, jp, tm, tp = _lm(arch, "float32")
    toks = _tokens(tm.cfg, 2, 32, 12)
    labels = np.roll(toks, -1, axis=1)
    labels[0, -1] = -100
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, remat="full")))(jp)
    tloss, tg = t_rounds.value_and_grad(
        lambda p, b: tm.loss(p, b, remat="full"))(tp, tb)
    _close(tloss, jloss, "float32")
    _grads_close(tg, jg)
    nloss, ng = t_rounds.value_and_grad(
        lambda p, b: tm.loss(p, b, remat="none"))(tp, tb)
    assert float(nloss) == float(tloss)
    assert all(torch.equal(a, c) for a, c in zip(tree_leaves(tg),
                                                 tree_leaves(ng)))


def test_serve_cli_default_arch_is_the_references(monkeypatch):
    """Both CLIs without ``--arch`` serve mamba2's smoke config."""
    argv = ["--batch", "1", "--prompt-len", "2", "--new-tokens", "1"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    ref_out, own_out = io.StringIO(), io.StringIO()
    with redirect_stdout(ref_out):
        j_serve_cli.main()
    with redirect_stdout(own_out):
        out = t_serve.main(argv + ["--device", "cpu"])
    first = lambda s: s.getvalue().splitlines()[0]  # noqa: E731
    assert first(ref_out).startswith("== serving mamba2-smoke (window=None)")
    assert first(own_out).startswith("== serving mamba2-smoke (window=None)")
    assert tuple(out["tokens"].shape) == (1, 1)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_rec", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernel_plans_at_the_recurrent_prefill_shapes():
    """The plans of phase 18's K2 and K3 cases stay within the card's
    limits: K2 at [4, 512, 4096] in 128 blocks of 128 threads and at
    [1, 4096, 4096] in 128 blocks of one warp, one lane a thread, each
    thread walking the whole L; K3 at D = 256 on the tensor-core kernel
    (32-key tiles)."""
    cs = _chip_smoke()
    plans = {case: t_rgk.launch_plan(*case, True)
             for _, case, _ in cs.REC_K2_CASES}
    assert {c: (p.vec, p.block, p.grid) for c, p in plans.items()} == {
        (4, 512, 4096): (1, (128, 1), (32, 4)),
        (1, 4096, 4096): (1, (32, 1), (128, 1))}
    for p in plans.values():
        assert p.block[0] * p.block[1] <= t_rgk.MAX_THREADS
    for _, (b, s, hq, hkv, d), window, _ in cs.REC_FA_CASES:
        plan = t_fa.launch_plan(b, s, s, hq, hkv, d, torch.bfloat16, True)
        assert (plan.kernel, plan.dmax, plan.key_tile) == ("mma", 256, 32)
        assert plan.grid == (hq, b, -(-s // 64)) and window == 2048
        assert t_fa.MAX_SMEM < plan.smem_bytes <= t_fa.MAX_SMEM_OPTIN


def test_f64_witness_widens_every_f32_pin():
    """``chip_smoke.f64_mode`` (phase 18's exact run of mamba2's f32 copy)
    on mamba2-smoke in f32 with its weights cast to f64: the last logits
    and every cache over 4 decode steps come out f64, no op returns f32,
    and the f32 run lies within 1e-5 of it."""
    cs = _chip_smoke()
    cfg = t_base.get_arch("mamba2_130m", smoke=True)
    m = t_model.build(dataclasses.replace(cfg, dtype="float32"))
    p32 = m.init(0, device="cpu")
    p64 = cs.tree_to(p32, torch.float64)
    toks = torch.as_tensor(_tokens(cfg, 2, 32, seed=9))
    mode = cs.f64_mode(torch)
    v = cfg.vocab_size
    want = m.forward(p32, {"tokens": toks}, last_only=True)
    with mode:
        got = m.forward(p64, {"tokens": toks}, last_only=True)
        c64 = m.init_cache(2, 4, params=p64)
    assert got.dtype == torch.float64
    _close(want[..., :v], got[..., :v], "float32", scaled=True)
    c32 = m.init_cache(2, 4, params=p32)
    for t in range(4):
        want, _ = m.decode_step(p32, toks[:, t:t + 1], c32, t)
        with mode:
            got, _ = m.decode_step(p64, toks[:, t:t + 1], c64, t)
        _close(want[..., :v], got[..., :v], "float32", scaled=True)
        for a, b in zip(tree_leaves(c32), tree_leaves(c64)):
            assert b.dtype == torch.float64
            _close(a, b, "float32", scaled=True)
    assert not mode.f32_ops
