"""The port's federated LM training path against the JAX reference.

The tree optimizers, the streamed aggregation and the tree server update,
``microbatched_value_and_grad``, ``Model.loss`` and its grads (mode
``"train"`` under every ``remat`` policy), the token streams, the
``client_serial`` round (``make_serial_round``) for 2 rounds on the
``mlp`` detector and on the granite smoke LM with clipped DP, the
single-device ``launch/steps.py`` policy and the train CLI.  Inputs come
from NumPy seeds; weights and states go across with ``convert``.  The
serial round is fed the reference's own draws: ``rounds.py``'s 5-way split
of ``state.rng``, ``iid_fail_times(k_fail, fold_in(k_fail, 1))`` and, per
slot, ``fold_in(k_dp, slot)`` split into one key a leaf.

Tolerances: f32 values within 1e-5 (relative and absolute), f32 grads
within 1e-4 of the leaf's largest magnitude (a grad is a sum over every
position, taken in another order); bf16 at the reference's own bar, 2e-2,
relative and of max(1, max|x|) (``tests/test_torch_lm.py``).  One bf16
SGD step and the streamed sums are held bitwise.
"""
import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs.base import FLConfig as JFLConfig
from repro.core import aggregation as j_agg
from repro.core import rounds as j_rounds
from repro.data import tokens as j_tokens
from repro.data.synthetic import make_federated as j_make_federated
from repro.data.synthetic import round_batches as j_round_batches
from repro.launch import steps as j_steps
from repro.models import model as j_model
from repro.models.spec import get_model_spec as j_get_model_spec
from repro.models.spec import meta_for as j_meta_for
from repro.optim import optimizers as j_opt

from repro_torch import convert
from repro_torch.configs import base as t_base
from repro_torch.configs.base import FLConfig
from repro_torch.core import aggregation as t_agg
from repro_torch.core import plans as t_plans
from repro_torch.core import rounds as t_rounds
from repro_torch.data import tokens as t_tokens
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import model as t_model
from repro_torch.models.spec import get_model_spec as t_get_model_spec
from repro_torch.models.spec import meta_for as t_meta_for
from repro_torch.optim import optimizers as t_opt
from repro_torch.tree import (flatten_rows, tree_leaves, tree_map, tree_paths,
                              unflatten_rows)

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BF16 = 2e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=RTOL, scaled=False):
    """``scaled``: the absolute part times max(1, max|want|) (bf16)."""
    got, want = _np(got), _np(want)
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _close_trees(got, want, tol=RTOL, scaled=False):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, tol, scaled)


def _grads_close(got, want, dtype: str):
    """Each leaf within GRAD_TOL[dtype] of its largest magnitude (bf16:
    also relatively)."""
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        a, b = _np(a), _np(b)
        tol = GRAD_TOL[dtype]
        np.testing.assert_allclose(
            a, b, rtol=tol if dtype == "bfloat16" else 0,
            atol=tol * max(float(np.abs(b).max()), 1e-12))


def _to_torch(tree):
    return convert.lm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _to_jax(tree):
    """A tree of tensors as jnp arrays of the same dtypes."""
    def one(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return one(tree)


def _rand_tree(seed: int, dtype: str):
    """A small tree of dicts and a list, in ``dtype``, as (torch, jax)."""
    rng = np.random.default_rng(seed)
    shapes = {"b": {"w": (3, 4), "a": (5,)}, "s": [{"x": (2, 3)}, {"y": (4,)}]}

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        if isinstance(node, list):
            return [make(v) for v in node]
        return torch.as_tensor(rng.normal(size=node).astype(np.float32)).to(
            getattr(torch, dtype))

    t = make(shapes)
    return t, _to_jax(t)


# ---------------------------------------------------------------------------
# trees and the tree optimizers
# ---------------------------------------------------------------------------


def test_tree_order_matches_jax_flatten():
    """Leaves of a tree with dicts and lists come in ``jax.tree.leaves``
    order; unflatten_rows inverts flatten_rows with views of the flat
    buffer, in that order."""
    t, j = _rand_tree(0, "float32")
    for a, b in zip(tree_leaves(t), jax.tree.leaves(j)):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert tree_paths(t)[0] == ("b", "a") and tree_paths(t)[-1] == ("s", 1, "y")
    flat = flatten_rows(t, 0)
    back = unflatten_rows(flat, t)
    assert isinstance(back["s"], list)
    offset = 0
    for leaf, want in zip(tree_leaves(back), tree_leaves(t)):
        assert leaf.data_ptr() == flat.data_ptr() + 4 * offset
        assert torch.equal(leaf, want)
        offset += leaf.numel()
    assert offset == flat.numel()


def test_unflattened_views_free_their_buffer_without_the_gc():
    """The views :func:`unflatten_rows` returns hold their flat buffer only
    while they live: no reference cycle keeps it for the garbage collector
    (at an LM's width each such buffer is 7 GB)."""
    t, _ = _rand_tree(6, "float32")
    gc.disable()
    try:
        flat = flatten_rows(t, 0)
        ref = weakref.ref(flat)
        views = unflatten_rows(flat, t)
        del flat
        assert ref() is not None
        del views
        assert ref() is None
    finally:
        gc.enable()


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(0.1), lambda m: m.tree_sgd(0.1)),
    "sgd-momentum": (lambda m: m.sgd(0.1, momentum=0.9),
                     lambda m: m.tree_sgd(0.1, momentum=0.9)),
    "sgd-nesterov-wd": (lambda m: m.sgd(0.1, 0.9, True, 0.01),
                        lambda m: m.tree_sgd(0.1, 0.9, True, 0.01)),
    "adam": (lambda m: m.adam(0.01), lambda m: m.tree_adam(0.01)),
    "adamw": (lambda m: m.adamw(0.01), lambda m: m.tree_adamw(0.01)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_tree_optimizer_matches_reference(name, dtype):
    """Three steps with fresh grads each: params (f32 1e-5; bf16 2e-2) and
    the f32 state (1e-5) as the reference's."""
    j_make, t_make = OPTIMIZERS[name]
    jo, to = j_make(j_opt), t_make(t_opt)
    tp, jp = _rand_tree(1, dtype)
    ts, js = to.init(tp), jo.init(jp)
    for i in range(3):
        tg, jg = _rand_tree(10 + i, dtype)
        tp, ts = to.update(tg, ts, tp)
        jp, js = jo.update(jg, js, jp)
        assert [l.dtype for l in tree_leaves(tp)] == [getattr(torch, dtype)] * 4
        _close_trees(tp, jp, BF16 if dtype == "bfloat16" else RTOL,
                     scaled=dtype == "bfloat16")
        if isinstance(ts, t_opt.AdamState):
            _close_trees(ts.mu, js.mu)
            _close_trees(ts.nu, js.nu)
            assert int(ts.count) == int(js.count)
        elif ts != ():
            _close_trees(ts, js)


def test_one_bf16_sgd_step_is_bitwise():
    """``(p.f32 − lr·g.f32).astype(bf16)``: one rounding, as jnp's."""
    tp, jp = _rand_tree(2, "bfloat16")
    tg, jg = _rand_tree(3, "bfloat16")
    got, _ = t_opt.tree_sgd(0.37).update(tg, (), tp)
    want, _ = j_opt.sgd(0.37).update(jg, (), jp)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            a.view(torch.int16).numpy(),
            np.asarray(b).view(np.int16))


@pytest.mark.parametrize("name", ["sgd", "fedavgm", "fedadam"])
def test_tree_server_update_matches_reference(name):
    """``apply_server_update_tree`` with each server optimizer, two rounds
    on a bf16 tree (2e-2) and its f32 state (1e-5)."""
    tp, jp = _rand_tree(4, "bfloat16")
    to = t_opt.make_tree_server_optimizer(name, 0.5)
    jo = j_opt.make_server_optimizer(name, 0.5)
    ts, js = to.init(tp), jo.init(jp)
    for i in range(2):
        td, jd = _rand_tree(20 + i, "float32")
        tp, ts = t_agg.apply_server_update_tree(to, tp, ts, td)
        jp, js = j_agg.apply_server_update(jo, jp, js, jd)
        _close_trees(tp, jp, BF16, scaled=True)
    for a, b in zip(tree_leaves(ts) if isinstance(ts, dict) else [],
                    jax.tree.leaves(js) if isinstance(ts, dict) else []):
        _close(a, b)


@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_stream_aggregation_matches_reference(acc_dtype):
    """stream_init / stream_accumulate (masks 1, 0, 1) / stream_finalize,
    bitwise in f32 and in a bf16 accumulator."""
    like, jlike = _rand_tree(5, "bfloat16")
    tc = t_agg.stream_init(like, getattr(torch, acc_dtype))
    jc = j_agg.stream_init(jlike, getattr(jnp, acc_dtype))
    for i, m in enumerate((1.0, 0.0, 1.0)):
        td, jd = _rand_tree(30 + i, "float32")
        tc = t_agg.stream_accumulate(tc, td, torch.tensor(m), 1.0)
        jc = j_agg.stream_accumulate(jc, jd, jnp.float32(m), 1.0)
    assert float(tc[1]) == float(jc[1])
    for a, b in zip(tree_leaves(tc[0]), jax.tree.leaves(jc[0])):
        assert a.dtype == getattr(torch, acc_dtype)
        np.testing.assert_array_equal(_np(a), _np(b))
    got, want = t_agg.stream_finalize(tc), j_agg.stream_finalize(jc)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(_np(a), _np(b))


# ---------------------------------------------------------------------------
# LM loss, remat and gradient accumulation
# ---------------------------------------------------------------------------


def _cfgs(arch: str, dtype: str):
    jc = dataclasses.replace(j_base.get_arch(arch, smoke=True), dtype=dtype)
    return jc, t_base.ModelConfig(**dataclasses.asdict(jc))


@functools.lru_cache(maxsize=None)
def _lm(arch: str, dtype: str):
    jc, tc = _cfgs(arch, dtype)
    jm = j_model.build(jc)
    jp = jm.init(jax.random.key(0))
    return jm, jp, t_model.build(tc), _to_torch(jp)


def _lm_batch(cfg, b: int, s: int, seed: int, ignore: bool = True):
    """Tokens and labels from the token stream; with ``ignore`` the last
    label of row 0 is -100."""
    d = j_tokens.lm_eval_batch(cfg.vocab_size, b, s, seed)
    if ignore:
        d["labels"][0, -1] = -100
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v) for k, v in d.items()})


REMATS = [("none", 1), ("full", 1), ("dots", 1), ("full", 2)]


@pytest.mark.parametrize("remat,group", REMATS,
                         ids=[f"{r}-g{g}" for r, g in REMATS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite_3_8b", "phi3_mini_3p8b"])
def test_model_loss_and_grads_match_jax(arch, dtype, remat, group):
    """``Model.loss`` and its grads (f32: loss 1e-5, grads 1e-4 of each
    leaf's max|g|; bf16: 2e-2) under each remat policy, and remat changes
    no value of the port's (bitwise against ``"none"``)."""
    jm, jp, tm, tp = _lm(arch, dtype)
    jb, tb = _lm_batch(jm.cfg, 2, 16, 7)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, remat=remat, remat_group=group)))(jp)
    vag = t_rounds.value_and_grad(
        lambda p, b: tm.loss(p, b, remat=remat, remat_group=group))
    tloss, tg = vag(tp, tb)
    assert tloss.dtype == torch.float32
    assert [g.dtype for g in tree_leaves(tg)] == \
        [p.dtype for p in tree_leaves(tp)]
    _close(tloss, jloss, GRAD_TOL[dtype] if dtype == "bfloat16" else RTOL)
    _grads_close(tg, jg, dtype)
    if remat != "none":
        nloss, ng = t_rounds.value_and_grad(
            lambda p, b: tm.loss(p, b, remat="none"))(tp, tb)
        assert float(nloss) == float(tloss)
        for a, b in zip(tree_leaves(tg), tree_leaves(ng)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("grad_accum", [1, 2, 4])
def test_microbatched_value_and_grad_matches_jax(grad_accum):
    """Loss (1e-5) and grads (1e-4 of max|g|) of the granite smoke LM in
    f32 over 4 rows split into ``grad_accum`` microbatches; the grads keep
    the params' dtype."""
    jm, jp, tm, tp = _lm("granite_3_8b", "float32")
    jb, tb = _lm_batch(jm.cfg, 4, 16, 8, ignore=False)
    jloss, jg = j_rounds.microbatched_value_and_grad(
        lambda p, b: jm.loss(p, b, remat="none"), grad_accum)(jp, jb)
    tloss, tg = t_rounds.microbatched_value_and_grad(
        lambda p, b: tm.loss(p, b, remat="none"), grad_accum)(tp, tb)
    _close(tloss, jloss)
    _grads_close(tg, jg, "float32")


def test_lm_loss_ignores_masked_labels_and_padding():
    """Labels of -100 drop out of the mean, and the padded vocab rows get
    no gradient (their logits are masked to -1e30)."""
    tm = t_model.build(dataclasses.replace(
        _cfgs("granite_3_8b", "float32")[1], vocab_size=500))
    tp = tm.init(0, device="cpu")
    _, tb = _lm_batch(tm.cfg, 2, 8, 9, ignore=False)
    all_labels = tm.loss(tp, tb, remat="none")
    masked = dict(tb, labels=torch.full_like(tb["labels"], -100))
    assert float(tm.loss(tp, masked, remat="none")) == 0.0
    _, g = t_rounds.value_and_grad(
        lambda p, b: tm.loss(p, b, remat="none"))(tp, tb)
    pad = g["embed"]["table"][tm.cfg.vocab_size:]
    assert pad.shape[0] == 12 and torch.isfinite(all_labels)
    assert float(pad.abs().max()) == 0.0


def test_token_streams_are_bitwise_the_reference():
    for seed in (0, 3):
        a = t_tokens.lm_round_batches(512, 3, 2, 2, 16, seed, round_idx=1)
        b = j_tokens.lm_round_batches(512, 3, 2, 2, 16, seed, round_idx=1)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(
            t_tokens.lm_eval_batch(49155, 2, 32, seed)["tokens"],
            j_tokens.lm_eval_batch(49155, 2, 32, seed)["tokens"])


# ---------------------------------------------------------------------------
# the client_serial round
# ---------------------------------------------------------------------------


def reference_serial_draws(state_rng, n: int, slots: int, local_steps: int,
                           shapes):
    """One serial round's :class:`SerialDraws` from the reference's keys
    (``rounds.py`` ``make_serial_round``), and the key it carries on."""
    rng, k_avail, k_sel, k_fail, k_dp = jax.random.split(state_rng, 5)
    noise = []
    for slot in range(slots if shapes else 0):
        keys = jax.random.split(jax.random.fold_in(k_dp, slot), len(shapes))
        noise.append(jnp.concatenate(
            [jax.random.normal(k, s, jnp.float32).reshape(-1)
             for k, s in zip(keys, shapes)]))
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    draws = t_rounds.SerialDraws(
        avail_u=t(jax.random.uniform(k_avail, (n,), jnp.float32)),
        sel_noise=t(jax.random.gumbel(k_sel, (n,))),
        fail_u=t(jax.random.uniform(k_fail, (slots,), jnp.float32)),
        fail_step=t(jax.random.randint(jax.random.fold_in(k_fail, 1),
                                       (slots,), 0, local_steps)).long(),
        dp_noise=t(jnp.stack(noise)) if noise else None)
    return draws, rng


def _serial_state(jstate, fl):
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return convert.serial_round_state_from_jax(
        to_np(jstate.params), to_np(jstate.server_opt_state), jstate.util,
        jstate.kctl, jstate.fault, fl, "cpu")


def _run_serial_pair(j_loss, t_loss, jfl, fl, jparams, n, batches_fn,
                     rounds=2, dtype_tol=RTOL, **util_kw):
    """``rounds`` rounds of the reference's serial step and the port's on
    its draws; per-round sel_mask/failed equal, params, util and metrics
    within ``dtype_tol``."""
    jstate = j_rounds.init_round_state(jparams, jfl, jax.random.key(11),
                                       n_clients=n, **util_kw)
    tstate = _serial_state(jstate, fl)
    jstep = j_rounds.make_serial_round(j_loss, jfl, n)
    tstep = t_rounds.make_serial_round(t_loss, fl, n, device="cpu")
    shapes = [tuple(l.shape) for l in jax.tree.leaves(jparams)]
    leaves = [_np(l) for l in jax.tree.leaves(jparams)]
    norm_atol = max(dtype_tol, np.sqrt(sum(l.size for l in leaves)) * 2.0**-24
                    * max(float(np.abs(l).max()) for l in leaves))
    for r in range(rounds):
        jb, tb = batches_fn(r)
        draws, _ = reference_serial_draws(
            jstate.rng, n, fl.serial_clients_in_step,
            tree_leaves(tb)[0].shape[1], shapes)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb, draws=draws)
        np.testing.assert_array_equal(_np(tm.sel_mask), _np(jm.sel_mask))
        np.testing.assert_array_equal(_np(tm.failed), _np(jm.failed))
        for f in ("pre_loss", "post_loss", "global_loss", "k_effective"):
            _close(getattr(tm, f), getattr(jm, f), dtype_tol)
        # Δ = p_final − p_global cancels in f32: an update norm is only
        # known to one half-ulp flip an element at the params' largest
        # magnitude, √P·2^-24·max|p| (3.6e-5 for the granite smoke LM)
        np.testing.assert_allclose(_np(tm.update_norms),
                                   _np(jm.update_norms), rtol=dtype_tol,
                                   atol=norm_atol)
        _close_trees(tstate.params, jstate.params, dtype_tol)
        for f in tstate.util._fields:
            _close(getattr(tstate.util, f), getattr(jstate.util, f),
                   dtype_tol)
        for f in tstate.kctl._fields:
            _close(getattr(tstate.kctl, f), getattr(jstate.kctl, f))
        assert tstate.round_idx == r + 1
    return tstate, jstate


def test_serial_builder_resolves_through_the_registry():
    assert t_plans.get_plan("client_serial").builder_fn() is \
        t_rounds.make_serial_round
    assert t_plans.get_plan("client_parallel").builder_fn() is \
        t_rounds.make_parallel_round


def test_serial_round_mlp_matches_reference():
    """tests/test_plans.py's serial config (6 clients, 3 slots, clipped DP,
    failures with checkpoint recovery) on the ``mlp`` detector, 2 rounds."""
    kw = dict(n_clients=6, clients_per_round=3, rounds=4, local_epochs=2,
              local_batch=8, local_lr=0.05, dp_enabled=True,
              dp_mode="clipped", dp_epsilon=100.0, dp_clip=2.0,
              plan="client_serial", serial_clients_in_step=3,
              fault_tolerance=True, failure_prob=0.3)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    fed = j_make_federated(1, "unsw", n_samples=400, n_clients=6)
    jspec = j_get_model_spec("mlp", j_meta_for(fed, hidden=16))
    tspec = t_get_model_spec("mlp", t_meta_for(fed, hidden=16))
    jparams = jspec.init(jax.random.key(7))
    sizes = fed.data_sizes()
    rng = np.random.default_rng(5)

    def batches(_):
        b = j_round_batches(rng, fed, fl.local_epochs, fl.local_batch)
        b = {k: v[:fl.serial_clients_in_step] for k, v in b.items()}
        return ({k: jnp.asarray(v) for k, v in b.items()},
                {k: torch.as_tensor(v) for k, v in b.items()})

    _run_serial_pair(jspec.loss, tspec.loss, jfl, fl, jparams,
                     fed.n_clients, batches,
                     data_size=jnp.asarray(sizes / sizes.mean()),
                     data_quality=jnp.asarray(fed.label_entropy()))


def _train_fl(kw_fl=None, **kw):
    """The train CLI's FLConfig (``launch/train.py``) for both packages."""
    base = dict(n_clients=8, clients_per_round=2, local_lr=0.005,
                dp_enabled=True, dp_mode="clipped", dp_epsilon=50.0,
                dp_clip=10.0, failure_prob=0.05, serial_clients_in_step=2,
                local_steps_in_step=1)
    base.update(kw)
    return JFLConfig(**base), FLConfig(**base)


def _lm_rounds(cfg, fl, batch=2, seq=16):
    def batches(r):
        d = j_tokens.lm_round_batches(cfg.vocab_size,
                                      fl.serial_clients_in_step,
                                      fl.local_steps_in_step, batch, seq,
                                      100 + r)
        return ({k: jnp.asarray(v) for k, v in d.items()},
                {k: torch.as_tensor(v) for k, v in d.items()})
    return batches


def test_serial_round_granite_lm_dp_matches_reference():
    """The granite smoke LM in f32 under the train CLI's config with
    clipped DP (ε 50, clip 10), 2 rounds."""
    jm, jp, tm, tp = _lm("granite_3_8b", "float32")
    jfl, fl = _train_fl()
    _run_serial_pair(lambda p, b: jm.loss(p, b, remat="none"),
                     lambda p, b: tm.loss(p, b, remat="none"),
                     jfl, fl, jp, 8, _lm_rounds(jm.cfg, fl))


def test_serial_round_bf16_lm_fedadam_grad_accum_and_gate():
    """The bf16 granite smoke LM with FedAdam on the server, 2 local steps,
    grad_accum 2 and remat "full": params (bf16) and the f32 server state
    at 2e-2 of the reference; then a closed update gate keeps params and
    server state bitwise."""
    jm, jp, tm, tp = _lm("granite_3_8b", "bfloat16")
    jfl, fl = _train_fl(server_opt="fedadam", server_lr=0.01,
                        local_steps_in_step=2, dp_enabled=False,
                        failure_prob=0.0)
    jstate = j_rounds.init_round_state(jp, jfl, jax.random.key(3),
                                       n_clients=8)
    tstate = _serial_state(jstate, fl)
    jstep = j_rounds.make_serial_round(
        lambda p, b: jm.loss(p, b, remat="full"), jfl, 8, grad_accum=2)
    tstep = t_rounds.make_serial_round(
        lambda p, b: tm.loss(p, b, remat="full"), fl, 8, grad_accum=2,
        device="cpu")
    jb, tb = _lm_rounds(jm.cfg, fl, batch=4)(0)
    draws, _ = reference_serial_draws(jstate.rng, 8, 2, 2, [])
    jstate, jmet = jstep(jstate, jb)
    tstate, tmet = tstep(tstate, tb, draws=draws)
    np.testing.assert_array_equal(_np(tmet.sel_mask), _np(jmet.sel_mask))
    _close(tmet.post_loss, jmet.post_loss, BF16)
    _close_trees(tstate.params, jstate.params, BF16, scaled=True)
    _close_trees(tstate.server_opt_state.mu, jstate.server_opt_state.mu,
                 BF16, scaled=True)
    assert int(tstate.server_opt_state.count) == 1
    frozen, _ = tstep(tstate, tb, update_gate=torch.tensor(0.0), draws=draws)
    for a, b in zip(tree_leaves(frozen.params), tree_leaves(tstate.params)):
        assert torch.equal(a, b)
    assert int(frozen.server_opt_state.count) == 1


def test_serial_round_paper_dp_matches_reference():
    """The paper's DP mode (σ·n added leaf by leaf, no clipping) in the
    serial round on the ``mlp`` detector, 2 rounds against the reference
    on its draws."""
    kw = dict(n_clients=6, clients_per_round=3, rounds=4, local_epochs=2,
              local_batch=8, local_lr=0.05, dp_enabled=True,
              dp_mode="paper", dp_sigma=0.05, plan="client_serial",
              serial_clients_in_step=3, failure_prob=0.2)
    jfl, fl = JFLConfig(**kw), FLConfig(**kw)
    fed = j_make_federated(2, "unsw", n_samples=300, n_clients=6)
    jspec = j_get_model_spec("mlp", j_meta_for(fed, hidden=16))
    tspec = t_get_model_spec("mlp", t_meta_for(fed, hidden=16))
    rng = np.random.default_rng(8)

    def batches(_):
        b = j_round_batches(rng, fed, fl.local_epochs, fl.local_batch)
        b = {k: v[:fl.serial_clients_in_step] for k, v in b.items()}
        return ({k: jnp.asarray(v) for k, v in b.items()},
                {k: torch.as_tensor(v) for k, v in b.items()})

    _run_serial_pair(jspec.loss, tspec.loss, jfl, fl,
                     jspec.init(jax.random.key(2)), fed.n_clients, batches)


def test_serial_round_draws_itself_and_routes_dp():
    """Without draws the round draws from the state's generator: the same
    seed gives the same round, bitwise.  The DP route follows the device;
    ``dp_use_kernel=False``, the reference's switch to its plain version,
    is accepted for a round on the CPU (which runs the plain version
    anyway) and refused for one on the card, before anything reaches a
    card."""
    _, _, tm, tp = _lm("granite_3_8b", "float32")
    _, fl = _train_fl()
    loss = lambda p, b: tm.loss(p, b, remat="none")  # noqa: E731
    _, tb = _lm_rounds(tm.cfg, fl)(0)
    outs = []
    for use_kernel in (None, False):
        state = t_rounds.init_serial_state(
            tp, fl, torch.Generator().manual_seed(4), n_clients=8)
        step = t_rounds.make_serial_round(loss, fl, 8, device="cpu",
                                          dp_use_kernel=use_kernel)
        outs.append(step(state, tb))
    (s0, m0), (s1, m1) = outs
    for f in m0._fields:
        assert torch.equal(getattr(m0, f), getattr(m1, f)), f
    for a, b in zip(tree_leaves(s0.params), tree_leaves(s1.params)):
        assert torch.equal(a, b)
    assert float(m0.update_norms.min()) > 0
    for device in (None, "cuda"):
        with pytest.raises(ValueError, match="dp_use_kernel"):
            t_rounds.make_serial_round(loss, fl, 8, device=device,
                                       dp_use_kernel=False)


# ---------------------------------------------------------------------------
# launch: the execution-profile policy and the train CLI
# ---------------------------------------------------------------------------


def test_steps_policy_matches_reference():
    for arch in j_base.ARCH_IDS:
        jc = j_base.get_arch(arch)
        tc = t_base.ModelConfig(**dataclasses.asdict(jc))
        assert t_steps.choose_plan(tc) == j_steps.choose_plan(jc)
        for b in (1, 4, 16):
            assert t_steps.choose_grad_accum(tc, b) == \
                j_steps.choose_grad_accum(jc, b)
        plan = j_steps.choose_plan(jc)
        assert dataclasses.asdict(t_steps.make_fl_config(tc, plan, 16)) == \
            dataclasses.asdict(j_steps.make_fl_config(jc, plan, 16))


def test_train_cli_runs_on_cpu_and_needs_a_card_by_default(capsys):
    """The CLI in-process with ``--device cpu``: the reference's lines and
    finite losses; without ``--device`` it goes to CUDA (raising without a
    card)."""
    out = t_train.main(["--device", "cpu", "--rounds", "2", "--dp",
                        "--seq", "16"])
    text = capsys.readouterr().out
    assert "initial eval loss:" in text and "final eval loss:" in text
    assert "round 1: local_loss=" in text and "failures=" in text
    assert np.isfinite(out["initial_eval_loss"])
    assert np.isfinite(out["final_eval_loss"])
    assert all(np.isfinite(r["local_loss"]) for r in out["rounds"])
    assert out["state"].round_idx == 2
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(["--rounds", "1"])
