"""The execution plans of the ``client_parallel`` family in the port —
``buffered_async`` (plan code 1) and ``hierarchical`` (code 2) — against
the JAX reference: the plan registry, the lane step round by round with
the reference's draws fed in, a mixed sync/async/hier sweep lane by lane,
and the identities that tie both plans to the synchronous one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.core import plans as j_plans
from repro.core import rounds as j_rounds
from repro.data.synthetic import make_federated as j_make_federated
from repro.data.synthetic import round_batches as j_round_batches
from repro.models import mlp as j_mlp
from repro.train import fl_driver as j_fl_driver

from repro_torch import convert
from repro_torch.configs.base import FLConfig, fl_params
from repro_torch.core import plans as t_plans
from repro_torch.core import rounds as t_rounds
from repro_torch.data import synthetic as t_syn
from repro_torch.models import mlp as t_mlp
from repro_torch.train import fl_driver as t_fl_driver
from repro_torch.tree import flatten_rows
from test_torch_parity import leaf_shapes, reference_draws, to_np
from test_torch_sweep import BASE, _assert_lanes_match, _run_both

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 8   # clients: E = 3 edges get groups of 3, 3 and 2
MARKOV = {"fault_process": 1.0, "fault_burst": 3.0}
STRAGGLER = {"fault_process": 3.0, "straggler_slow": 8.0}


@pytest.mark.parametrize("name", j_plans.plan_names())
def test_registry_entry_matches_reference(name):
    """Every registered plan, field for field."""
    assert t_plans.plan_names() == j_plans.plan_names()
    tp, jp = t_plans.get_plan(name), j_plans.get_plan(name)
    for f in ("name", "family", "code", "builder", "time_model",
              "fault_arrivals", "driver_capable", "cohort_capable"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert (tp.requires is None) == (jp.requires is None)


@pytest.mark.parametrize("kw", [
    {"plan": "buffered_async"},                        # no buffer K
    {"plan": "hierarchical", "hierarchy_edges": 0},
    {"plan": "client_cohort"},                         # no k_max
    {"async_buffer": 2.0},                             # K on a sync plan
    {"plan": "fedbuff"},                               # unregistered
], ids=["async-no-K", "hier-no-edges", "cohort-no-kmax", "K-on-sync",
        "unknown"])
def test_validate_plan_gives_the_reference_errors(kw):
    with pytest.raises(ValueError) as jerr:
        JFLConfig(**kw)
    with pytest.raises(ValueError) as terr:
        FLConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("plan_kw,fault_kw", [
    ({"plan": "buffered_async", "async_buffer": 2.0}, MARKOV),
    ({"plan": "buffered_async", "async_buffer": 2.0}, STRAGGLER),
    ({"plan": "buffered_async", "async_buffer": 4.0,
      "async_staleness_pow": 1.0}, STRAGGLER),
    ({"plan": "hierarchical", "hierarchy_edges": 1}, MARKOV),
    ({"plan": "hierarchical", "hierarchy_edges": 3}, STRAGGLER),
    ({"plan": "hierarchical", "hierarchy_edges": 3}, MARKOV),
    ({"plan": "hierarchical", "hierarchy_edges": 4}, STRAGGLER),
], ids=["async-K2-markov", "async-K2-straggler", "async-K4-straggler",
        "hier-E1-markov", "hier-E3-straggler", "hier-E3-markov",
        "hier-E4-straggler"])
def test_plan_round_matches_reference(plan_kw, fault_kw):
    """5 rounds of make_parallel_round at plan code 1 or 2 (the lane step
    at L = 1) against the reference's, fed its draws: sel_mask, avail,
    failed and slow equal; params, utility, K and fault state and the
    metrics to rtol 1e-5 (atol 1e-6)."""
    fed = j_make_federated(0, "unsw", n_samples=1_500, n_clients=N)
    cfg = dict(n_clients=N, clients_per_round=5, local_epochs=2,
               local_batch=16, local_lr=0.08, dp_epsilon=200.0, dp_clip=5.0,
               failure_prob=0.3, **plan_kw, **fault_kw)
    jfl, tfl = JFLConfig(**cfg), FLConfig(**cfg)
    sizes = fed.data_sizes()
    jparams = j_mlp.init_mlp(jax.random.key(0), fed.n_features, 32, 2)
    jstate = j_rounds.init_round_state(
        jparams, jfl, jax.random.key(1), n_clients=N,
        data_size=jnp.asarray(sizes / sizes.mean()),
        data_quality=jnp.asarray(fed.label_entropy()))
    tstate = convert.round_state_from_jax(
        to_np(jstate.params), to_np(jstate.util), to_np(jstate.kctl),
        to_np(jstate.fault), tfl, "cpu")
    jstep = jax.jit(j_rounds.make_parallel_round(j_mlp.mlp_loss, jfl, N))
    tstep = t_rounds.make_parallel_round(t_mlp.mlp_loss, tfl, N,
                                         device="cpu")
    rng = np.random.default_rng(0)
    for r in range(5):
        b = j_round_batches(rng, fed, jfl.local_epochs, jfl.local_batch)
        draws, _ = reference_draws(jstate.rng, N, jfl.local_epochs,
                                   leaf_shapes(jparams))
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, {"x": torch.as_tensor(b["x"]),
                                    "y": torch.as_tensor(b["y"]).long()},
                           draws=draws)
        for name in ("sel_mask", "avail", "failed", "slow"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)),
                                          err_msg=f"{name} round {r}")
        for name in ("pre_loss", "post_loss", "global_loss", "k_effective",
                     "update_norms"):
            _close(getattr(tm, name), getattr(jm, name), f"{name} round {r}")
        _close(flatten_rows(tstate.params, 0),
               np.concatenate([np.ravel(l) for l in
                               jax.tree.leaves(jstate.params)]),
               f"params round {r}")
        for part in ("util", "kctl", "fault"):
            for name, jv in getattr(jstate, part)._asdict().items():
                _close(getattr(getattr(tstate, part), name), jv,
                       f"{part}.{name} round {r}")


@pytest.fixture(scope="module")
def feds():
    return (j_make_federated(0, "unsw", n_samples=1_500, n_clients=8),
            t_syn.make_federated(0, "unsw", n_samples=1_500, n_clients=8))


def test_mixed_plan_sweep_matches_jax_sweep(feds):
    """Sync, buffered_async at K = 2 and 4 and hierarchical (E = 3) cells
    on Markov and straggler lanes as one sweep against the JAX
    ``run_fl_sweep`` with the reference's draws: every history key, ε, the
    simulated time and the final params of every lane to rtol 1e-5; one
    runner serves the whole grid."""
    jfed, tfed = feds
    base = {**BASE, "failure_prob": 0.3, "hierarchy_edges": 3}
    cells = [{**plan, **fault} for plan in (
        {}, {"plan": "buffered_async", "async_buffer": 2.0},
        {"plan": "buffered_async", "async_buffer": 4.0},
        {"plan": "hierarchical"}) for fault in (MARKOV, STRAGGLER)]
    misses = t_fl_driver.RUNNER_STATS["misses"]
    jres, tres = _run_both(jfed, tfed, base, cells, (0, 1))
    assert t_fl_driver.RUNNER_STATS["misses"] == misses + 1
    _assert_lanes_match(jres, tres)
    # the plans differ: K-th arrival and edge hops beat the slowest client
    # on straggler lanes
    sync_t = tres[1][0].sim_time_s
    assert all(tres[ci][0].sim_time_s < sync_t for ci in (3, 5, 7))


def _port_sweep(tfed, base, cells, **kw):
    return t_fl_driver.run_fl_sweep(
        tfed, FLConfig(**base), cells, seeds=(0, 1), rounds=4, eval_every=2,
        device="cpu", return_params=True, **kw)


MODEL_COLUMNS = ("loss", "acc", "auc", "k", "fail")


def test_zero_staleness_async_is_bitwise_sync(feds):
    """buffered_async with K = n: every contributor arrives in the first
    buffer (staleness 0, weight exactly 1), so its lanes equal the sync
    lanes bitwise in every model column and in the params; only the time
    model (the K-th arrival) differs."""
    _, tfed = feds
    sync, asyn = _port_sweep(tfed, {**BASE, **STRAGGLER}, [
        {}, {"plan": "buffered_async", "async_buffer": float(N)}])
    for a, b in zip(sync, asyn):
        for name in MODEL_COLUMNS:
            assert a.history[name] == b.history[name], name
        assert torch.equal(flatten_rows(a.params, 0),
                           flatten_rows(b.params, 0))


def test_one_edge_hierarchy_equals_flat(feds):
    """hierarchical at E = 1: one edge's weighted mean is the flat mean and
    the cloud's mean over one live edge is that mean, so its lanes equal
    the sync lanes to float order in every model column and the params."""
    _, tfed = feds
    sync, hier = _port_sweep(tfed, {**BASE, **MARKOV, "hierarchy_edges": 1},
                             [{}, {"plan": "hierarchical"}])
    for a, b in zip(sync, hier):
        for name in MODEL_COLUMNS:
            _close(b.history[name], a.history[name], name)
        _close(flatten_rows(b.params, 0), flatten_rows(a.params, 0),
               "params")


@pytest.mark.parametrize("plan", ["client_serial", "client_cohort"])
def test_sweep_refuses_non_driver_plans_as_reference(feds, plan):
    """A cell of a plan the registry marks ``driver_capable=False`` is
    refused by both packages' sweep engines with the same error."""
    jfed, tfed = feds
    cell = {"plan": plan, "k_max": 4}
    with pytest.raises(ValueError, match="cannot run on this engine") as jerr:
        j_fl_driver.run_fl_sweep(jfed, JFLConfig(**BASE), [cell], seeds=(0,),
                                 rounds=1)
    with pytest.raises(ValueError, match="cannot run on this engine") as terr:
        t_fl_driver.run_fl_sweep(tfed, FLConfig(**BASE), [cell], seeds=(0,),
                                 rounds=1, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_legacy_refuses_async_as_reference(feds):
    jfed, tfed = feds
    cfg = {**BASE, "plan": "buffered_async", "async_buffer": 2.0}
    with pytest.raises(ValueError, match="compiled engine") as jerr:
        j_fl_driver.run_fl_legacy(jfed, JFLConfig(**cfg), rounds=1)
    with pytest.raises(ValueError, match="compiled engine") as terr:
        t_fl_driver.run_fl_legacy(tfed, FLConfig(**cfg), rounds=1,
                                  device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_lane_step_refuses_other_families():
    for fl in (FLConfig(plan="client_serial"),
               FLConfig(plan="client_cohort", k_max=4)):
        with pytest.raises(NotImplementedError, match="family"):
            t_rounds.make_lane_round(t_mlp.mlp_loss, fl, 4, device="cpu")


@pytest.mark.parametrize("codes", [(0.0,), (0.0, 1.0), (0.0, 2.0)],
                         ids=["sync", "sync-async", "sync-hier"])
def test_lane_step_without_unused_plan_blocks_is_bitwise(codes):
    """A lane step built for a subset of plan codes (as a sweep builds it
    for its cells' codes) leaves out the async or hier block; on code-0
    lanes that changes no bit of the state or the metrics, over 3 rounds
    on straggler lanes with DP on."""
    cfg = FLConfig(n_clients=N, clients_per_round=5, local_epochs=2,
                   local_batch=16, local_lr=0.08, dp_epsilon=200.0,
                   dp_clip=5.0, failure_prob=0.3, hierarchy_edges=3,
                   **STRAGGLER)
    full = t_rounds.make_lane_round(t_mlp.mlp_loss, cfg, N, device="cpu")
    part = t_rounds.make_lane_round(t_mlp.mlp_loss, cfg, N, device="cpu",
                                    plan_codes=codes)
    d = 6
    states = []
    for seed in (0, 1):
        gen = torch.Generator().manual_seed(seed)
        states.append(t_rounds.init_round_state(
            t_mlp.init_mlp(gen, d, 16, 2), cfg, gen, n_clients=N))
    state_a = state_b = t_rounds.stack_states(states)
    pr = fl_params(cfg)
    gen = torch.Generator().manual_seed(7)
    n_params = flatten_rows(state_a.params).shape[-1]
    for r in range(3):
        batches = {"x": torch.randn(2, N, 2, 16, d, generator=gen),
                   "y": torch.randint(0, 2, (2, N, 2, 16), generator=gen)}
        draws = t_rounds.draw_round([gen, gen], N, 2, n_params,
                                    cfg.selection)
        state_a, m_a = full(state_a, batches, pr, draws)
        state_b, m_b = part(state_b, batches, pr, draws)
        assert torch.equal(flatten_rows(state_a.params),
                           flatten_rows(state_b.params)), f"round {r}"
        for part_a, part_b in ((state_a.util, state_b.util),
                               (state_a.kctl, state_b.kctl),
                               (state_a.fault, state_b.fault), (m_a, m_b)):
            for a, b in zip(part_a, part_b):
                assert torch.equal(a, b), f"round {r}"
