"""Selection, failure processes, aggregation and server optimizers of the
port against the JAX reference, fed the same variates.

The variates come from ``reference_draws`` (test_torch_parity.py), which
rebuilds them from the reference's own keys.  Masks and failure steps are
compared bitwise, floats to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.base import fl_params as j_fl_params
from repro.core import aggregation as j_agg
from repro.core import rounds as j_rounds
from repro.core import selection as j_sel
from repro.fault import process as j_proc
from repro.optim import optimizers as j_opt
from repro.train import fl_driver as j_fl_driver

from repro_torch.configs.base import FLConfig
from repro_torch.configs.base import fl_params as t_fl_params
from repro_torch.core import aggregation as t_agg
from repro_torch.core import rounds as t_rounds
from repro_torch.core import selection as t_sel
from repro_torch.fault import process as t_proc
from repro_torch.optim import optimizers as t_opt
from repro_torch.train import fl_driver as t_fl_driver
from test_torch_parity import reference_draws

torch.set_num_threads(1)

N = 24


def _close(a, b, what="", atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-6,
                               atol=atol, err_msg=what)


def _util_states(seed, n=N):
    """The same random UtilityState for both packages."""
    rng = np.random.default_rng(seed)
    fields = {
        "perf_ema": rng.normal(0, 0.2, n), "loss_ema": rng.uniform(0.2, 2, n),
        "loss_var": rng.uniform(0, 1, n), "data_size": rng.uniform(0.2, 2, n),
        "data_quality": rng.uniform(0, 1, n), "coherence": rng.normal(0, .3, n),
        "compute": rng.uniform(0.3, 1, n), "comm_cost": rng.uniform(0.2, 1, n),
        "last_selected": rng.integers(0, 5, n).astype(float),
        "participation": rng.integers(0, 9, n).astype(float),
        "fail_ema": rng.uniform(0, 0.5, n),
    }
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    return (j_sel.UtilityState(**{k: jnp.asarray(v) for k, v in fields.items()}),
            t_sel.UtilityState(**{k: torch.as_tensor(v) for k, v in fields.items()}))


def _avail(seed, n=N, p=0.8):
    a = (np.random.default_rng(seed).random(n) < p).astype(np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


@pytest.mark.parametrize("fault_w", [None, 0.0, 2.0])
def test_compute_utility_matches_reference(fault_w):
    js, ts = _util_states(1)
    _close(t_sel.compute_utility(ts, FLConfig(), fault_w=fault_w),
           j_sel.compute_utility(js, JFLConfig(), fault_w=fault_w))


@pytest.mark.parametrize("k_eff,k_max", [(3.5, 8), (5.0, N), (20.0, N),
                                         (0.5, 4)])
def test_topk_mask_ties_and_fractional_k(k_eff, k_max):
    """Tied scores go to the lower index (``lax.top_k``); a fractional
    ``k_eff`` selects every rank below it; unavailable clients never."""
    scores = np.round(np.random.default_rng(2).random(N), 1).astype(np.float32)
    scores[3] = scores[7] = scores[11] = scores.max()
    ja, ta = _avail(3)
    expect = j_sel._topk_mask(jnp.asarray(scores), ja,
                              jnp.float32(k_eff), k_max)
    got = t_sel._topk_mask(torch.as_tensor(scores), ta,
                           torch.tensor(k_eff), k_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("name", ["adaptive_utility", "random", "acfl",
                                  "power_of_choice", "adafl"])
def test_strategies_match_reference(name):
    """Each ``sel_*`` with the reference's selection variate: bitwise."""
    key = jax.random.key(17)
    draws, _ = reference_draws(key, N, 3, [(1,)], name)
    k_sel = jax.random.split(key, 5)[2]
    js, ts = _util_states(4)
    ja, ta = _avail(5)
    fl = FLConfig()
    utility = t_sel.compute_utility(ts, fl)
    for k_eff, k_max in ((4.5, N), (3.0, 6)):
        expect = j_sel.get_strategy(name)(
            k_sel, js, j_sel.compute_utility(js, JFLConfig()), ja,
            jnp.float32(k_eff), k_max, 0.05)
        got = t_sel.get_strategy(name)(draws.sel_noise, ts, utility, ta,
                                       torch.tensor(k_eff), k_max, 0.05)
        np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_update_k_matches_reference():
    """A run of losses through the adaptive-K controller, state by state."""
    for kw in ({}, {"k_tol": 0.05, "k_patience": 2.0, "k_max": 12}):
        jfl, tfl = JFLConfig(**kw), FLConfig(**kw)
        js, ts = j_sel.init_k_state(jfl), t_sel.init_k_state(tfl)
        for loss in (0.9, 0.5, 0.49, 0.49, 0.5, 0.5, 0.5, 0.2, 0.2, 0.2, 0.2,
                     0.21, 0.2, 0.19, 0.19):
            js = j_sel.update_k(js, jnp.float32(loss), jfl)
            ts = t_sel.update_k(ts, torch.tensor(loss), tfl)
            for a, b in zip(ts, js):
                _close(a, b)


@pytest.mark.parametrize("with_faults", [False, True])
def test_update_utility_state_matches_reference(with_faults):
    js, ts = _util_states(6)
    rng = np.random.default_rng(7)
    sel = (rng.random(N) < 0.4).astype(np.float32)
    pre = rng.uniform(0.3, 1.5, N).astype(np.float32)
    post = rng.uniform(0.2, 1.2, N).astype(np.float32)
    coh = rng.normal(0, 0.5, N).astype(np.float32)
    att = np.maximum(sel, (rng.random(N) < 0.2)).astype(np.float32)
    failed = (att * (rng.random(N) < 0.5)).astype(np.float32)
    extra_j = extra_t = {}
    if with_faults:
        extra_j = dict(attempted=jnp.asarray(att), failed=jnp.asarray(failed))
        extra_t = dict(attempted=torch.as_tensor(att),
                       failed=torch.as_tensor(failed))
    jn = j_sel.update_utility_state(js, jnp.asarray(sel), jnp.asarray(pre),
                                    jnp.asarray(post), JFLConfig(),
                                    coherence=jnp.asarray(coh), **extra_j)
    tn = t_sel.update_utility_state(ts, torch.as_tensor(sel),
                                    torch.as_tensor(pre), torch.as_tensor(post),
                                    FLConfig(), coherence=torch.as_tensor(coh),
                                    **extra_t)
    for name, jv in jn._asdict().items():
        _close(getattr(tn, name), jv, name)


@pytest.mark.parametrize("process", [0.0, 1.0, 2.0, 3.0])
def test_fault_step_matches_reference(process):
    """Six rounds of each failure process with the reference's variates:
    failure steps, slow factors and the carried state, bitwise."""
    jfl = JFLConfig(fault_process=process, failure_prob=0.3, fault_burst=2.0)
    tfl = FLConfig(fault_process=process, failure_prob=0.3, fault_burst=2.0)
    jpr, tpr = j_fl_params(jfl), t_fl_params(tfl)
    js, ts = j_proc.init_fault_state(N), t_proc.init_fault_state(N)
    key = jax.random.key(int(process) + 30)
    for r in range(6):
        draws, key_next = reference_draws(key, N, 5, [(1,)])
        k_fail = jax.random.split(key, 5)[3]
        jfa, jslow, js = j_proc.fault_step(js, k_fail, jpr, N, 5)
        tfa, tslow, ts = t_proc.fault_step(ts, draws.fault_u,
                                           draws.fault_steps, tpr, N, 5)
        np.testing.assert_array_equal(tfa.numpy(), np.asarray(jfa),
                                      err_msg=f"fail_at round {r}")
        np.testing.assert_array_equal(tslow.numpy(), np.asarray(jslow))
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        key = key_next


def test_arrival_score_and_cohort_fraction_match_reference():
    rng = np.random.default_rng(12)
    slow = np.where(rng.random(N) < 0.3, 4.0, 1.0).astype(np.float32)
    compute = rng.uniform(0.05, 1.0, N).astype(np.float32)
    _close(t_proc.arrival_score(torch.as_tensor(slow), torch.as_tensor(compute)),
           j_proc.arrival_score(jnp.asarray(slow), jnp.asarray(compute)))
    for k_eff in (0.5, 7.75, 8.0, 12.5, 60.0):
        _close(t_fl_driver.realized_cohort_fraction(torch.tensor(k_eff), 40),
               j_fl_driver.realized_cohort_fraction(jnp.float32(k_eff), 40))


@pytest.mark.parametrize("ft,ckpt", [(True, 1), (True, 2), (True, 3),
                                     (False, 2)])
def test_effective_steps_matches_reference(ft, ckpt):
    fail = np.array([0, 1, 2, 3, 4, 5, 5, 2], np.int32)
    je, jf = j_rounds._effective_steps(jnp.asarray(fail), 5, ckpt, ft)
    te, tf = t_rounds._effective_steps(torch.as_tensor(fail).long(), 5, ckpt,
                                       ft)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_aggregate_stacked_matches_reference():
    rng = np.random.default_rng(8)
    d = rng.normal(0, 1, (N, 300)).astype(np.float32)
    m = (rng.random(N) < 0.5).astype(np.float32)
    w = rng.uniform(0.2, 2, N).astype(np.float32)
    _close(t_agg.aggregate_stacked(torch.as_tensor(d), torch.as_tensor(m),
                                   torch.as_tensor(w)),
           j_agg.aggregate_stacked(jnp.asarray(d), jnp.asarray(m),
                                   jnp.asarray(w)))
    zero = np.zeros(N, np.float32)  # nobody contributes: a zero update
    _close(t_agg.aggregate_stacked(torch.as_tensor(d), torch.as_tensor(zero),
                                   torch.as_tensor(w)), np.zeros(300))


@pytest.mark.parametrize("name", ["sgd", "fedavgm", "fedadam"])
def test_server_optimizers_match_reference(name):
    """Three server steps on one flat update vector."""
    rng = np.random.default_rng(9)
    p = rng.normal(0, 1, 500).astype(np.float32)
    jo, to = (j_opt.make_server_optimizer(name, 0.7),
              t_opt.make_server_optimizer(name, 0.7))
    jp, tp = jnp.asarray(p), torch.as_tensor(p)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        d = rng.normal(0, 0.1, 500).astype(np.float32)
        jp, js = jo.update(jnp.asarray(d), js, jp)
        tp, ts = to.update(torch.as_tensor(d), ts, tp)
        _close(tp, jp)
        for a, b in zip(jax.tree.leaves(ts), jax.tree.leaves(js)):
            _close(a, b)


@pytest.mark.parametrize("plan,ft", [("client_parallel", True),
                                     ("client_parallel", False),
                                     ("buffered_async", True),
                                     ("hierarchical", True)])
def test_simulate_round_time_matches_reference(plan, ft):
    kw = dict(plan=plan, fault_tolerance=ft,
              async_buffer=3.0 if plan == "buffered_async" else 0.0)
    jfl, tfl = JFLConfig(**kw), FLConfig(**kw)
    js, ts = _util_states(10)
    rng = np.random.default_rng(11)
    sel = (rng.random(N) < 0.4).astype(np.float32)
    failed = (rng.random(N) < 0.2).astype(np.float32)
    slow = np.where(rng.random(N) < 0.2, 4.0, 1.0).astype(np.float32)
    for mask in (sel, np.zeros(N, np.float32)):
        expect = j_fl_driver.simulate_round_time(
            jfl, js, jnp.asarray(mask), jnp.asarray(failed),
            slow=jnp.asarray(slow))
        got = t_fl_driver.simulate_round_time(
            tfl, ts, torch.as_tensor(mask), torch.as_tensor(failed),
            slow=torch.as_tensor(slow))
        _close(got, expect)
    # the methods tweak the same fields in both packages
    for m in t_fl_driver.METHODS:
        jm, tm = j_fl_driver.fl_for_method(jfl, m), t_fl_driver.fl_for_method(tfl, m)
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
