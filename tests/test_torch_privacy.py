"""The port's privacy subsystem (``repro_torch.privacy``, the scheduled
carry of ``train/fl_driver.py`` and the release gate of
``core/rounds.py``), mirroring the reference's tests/test_privacy.py:

* the f32 in-loop accountant against an independent f64 offline
  reference within 1e-6 (relative, floored at 1) on the reference's
  (z × q × steps) grid, and against the host accountant;
* monotonicity, and the device bisection against the host's and the
  reference's;
* the schedule laws and the adaptive controller, against the reference's
  functions on the same inputs;
* the exhaustion gate: a lane that is not live keeps its params and server
  state bitwise, in the lane step and through the engine;
* one runner for a budget grid, with the frontier ordered;
* ``dp_scheduled`` requires clipped updates; the legacy loop and the host
  closed form refuse scheduled configs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.base import fl_params as j_fl_params
from repro.privacy import accountant as j_acct
from repro.privacy import schedule as j_sched

from repro_torch.configs.base import FLConfig, fl_params, params_lanes
from repro_torch.core import rounds as t_rounds
from repro_torch.data import synthetic as t_syn
from repro_torch.data.synthetic import make_federated
from repro_torch.models import mlp as t_mlp
from repro_torch.privacy import accountant as acct_lib
from repro_torch.privacy import schedule as sched_lib
from repro_torch.train import fl_driver
from repro_torch.tree import flatten_rows

torch.set_num_threads(1)

DELTA = 1e-5
GRID = acct_lib.order_grid(DELTA, "cpu")


def _offline_epsilon(z: float, q: float, steps: int, delta: float) -> float:
    """Offline reference, re-derived in f64 here (not imported from either
    package): subsampled-Gaussian RDP composed ``steps`` times, converted
    with the tightened bound over the shared order grid."""
    a = np.asarray(acct_lib.ORDERS, np.float64)
    rdp = steps * np.minimum(a / (2.0 * z * z), 2.0 * q * q * a / (z * z))
    eps = rdp + np.log1p(-1.0 / a) - (np.log(delta) + np.log(a)) / (a - 1.0)
    return float(eps.min())


def _loop_epsilon(zs, qs, steps: int) -> np.ndarray:
    """ε of each lane after ``steps`` in-loop accountant steps at constant
    z and q, as the engine composes it."""
    z = torch.as_tensor(np.float32(zs)).reshape(-1)
    q = torch.as_tensor(np.float32(qs)).reshape(-1)
    st = acct_lib.init_accountant_state(z.shape[0])
    for _ in range(steps):
        st = acct_lib.accountant_step(st, z, q, GRID)
    return acct_lib.epsilon_from_state(st, GRID).numpy()


# ---------------------------------------------------------------------------
# accountant vs offline and host references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z", [0.8, 1.2, 2.0, 4.0])
@pytest.mark.parametrize("q", [0.1, 0.25, 1.0])
@pytest.mark.parametrize("steps", [1, 7, 40, 200])
def test_accountant_matches_offline_reference(z, q, steps):
    """The reference's acceptance grid: in-loop f32 ε within 1e-6 of the
    f64 reference, both fed the same representable z and q."""
    zf, qf = float(np.float32(z)), float(np.float32(q))
    got = float(_loop_epsilon(zf, qf, steps)[0])
    ref = _offline_epsilon(zf, qf, steps, DELTA)
    assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref)), (got, ref)


def test_accountant_lanes_match_host_and_reference_accountants():
    """Lanes with their own varying z_t and q_t compose what the host f64
    accountant does, each lane within 1e-6, and what the reference's
    in-scan accountant does on the same sequence; the port's host
    accountant equals the reference's to the bit."""
    rng = np.random.default_rng(0)
    lanes, steps = 5, 60
    zs = rng.uniform(0.5, 4.0, (steps, lanes)).astype(np.float32)
    qs = rng.choice([0.125, 0.25, 0.5, 1.0], (steps, lanes)).astype(
        np.float32)
    st = acct_lib.init_accountant_state(lanes)
    hosts = [acct_lib.RdpAccountant(DELTA) for _ in range(lanes)]
    jst = [j_acct.init_accountant_state() for _ in range(lanes)]
    for t in range(steps):
        st = acct_lib.accountant_step(st, torch.as_tensor(zs[t]),
                                      torch.as_tensor(qs[t]), GRID)
        for i in range(lanes):
            hosts[i].step(float(zs[t, i]), float(qs[t, i]))
            jst[i] = j_acct.accountant_step(jst[i], jnp.float32(zs[t, i]),
                                            jnp.float32(qs[t, i]))
    got = acct_lib.epsilon_from_state(st, GRID).numpy()
    for i in range(lanes):
        host = hosts[i].epsilon()
        assert abs(got[i] - host) <= 1e-6 * max(1.0, host), (i, got[i], host)
        np.testing.assert_allclose(
            got[i], float(j_acct.epsilon_from_state(jst[i], DELTA)),
            rtol=1e-6)
    assert st.steps.tolist() == [steps] * lanes
    jhost = j_acct.RdpAccountant(DELTA)
    for t in range(steps):
        jhost.step(float(zs[t, 0]), float(qs[t, 0]))
    assert hosts[0].epsilon() == jhost.epsilon()
    assert acct_lib.compose_epsilon(1.3, 0.2, 25, DELTA) == \
        j_acct.compose_epsilon(1.3, 0.2, 25, DELTA)


def test_accountant_monotonicity():
    eps_by_z = _loop_epsilon([0.6, 1.0, 2.0, 4.0], [0.25] * 4, 30)
    assert np.all(np.diff(eps_by_z) < 0), eps_by_z
    # larger cohort -> more loss while the amplification term binds; past
    # q = 0.5 it saturates at the unamplified Gaussian
    eps_by_q = _loop_epsilon([1.2] * 4, [0.05, 0.1, 0.2, 0.4], 30)
    assert np.all(np.diff(eps_by_q) > 0), eps_by_q
    sat = _loop_epsilon([1.2, 1.2], [0.8, 1.0], 30)
    assert sat[0] == sat[1]
    eps_by_s = [float(_loop_epsilon(1.2, 0.25, s)[0]) for s in (1, 5, 25, 125)]
    assert all(a < b for a, b in zip(eps_by_s, eps_by_s[1:])), eps_by_s
    empty = acct_lib.init_accountant_state(3)
    assert acct_lib.epsilon_from_state(empty, GRID).tolist() == [0.0] * 3


def test_budget_calibration_rt_matches_host_and_reference():
    """The device bisection lands where the host bisection does (1e-3, as
    the reference's test) and where the reference's does (1e-6), for all
    lanes at once, and the calibrated z meets its budget."""
    cases = ((8.0, 40, 0.25), (100.0, 60, 0.2), (2000.0, 50, 0.5))
    for eps_total, rounds, q in cases:
        z_rt = float(acct_lib.noise_multiplier_for_budget_rt(
            torch.tensor([eps_total]), GRID, rounds, torch.tensor([q]))[0])
        z_host = acct_lib.noise_multiplier_for_budget(eps_total, DELTA,
                                                      rounds, q)
        z_jax = float(jax.jit(lambda e: j_acct.noise_multiplier_for_budget_rt(
            e, DELTA, rounds, q))(jnp.float32(eps_total)))
        assert abs(z_rt - z_host) / z_host < 1e-3, (z_rt, z_host)
        np.testing.assert_allclose(z_rt, z_jax, rtol=1e-6)
        assert acct_lib.compose_epsilon(z_rt, q, rounds, DELTA) <= \
            eps_total * (1 + 1e-4)
    assert z_host == j_acct.noise_multiplier_for_budget(eps_total, DELTA,
                                                        rounds, q)


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------


def _prs(**kw):
    """The same runtime params in both packages, with one lane."""
    t = fl_params(FLConfig())._replace(
        **{k: torch.tensor([v], dtype=torch.float32) for k, v in kw.items()})
    j = j_fl_params(JFLConfig())._replace(
        **{k: jnp.float32(v) for k, v in kw.items()})
    return t, j


def test_schedule_codes_select_the_law():
    st = sched_lib.SchedulerState(z_base=torch.tensor([2.0]),
                                  boost=torch.tensor([0.5]),
                                  best_auc=torch.tensor([0.0]))
    jst = j_sched.SchedulerState(z_base=jnp.float32(2.0),
                                 boost=jnp.float32(0.5),
                                 best_auc=jnp.float32(0.0))
    rounds = 11
    got = {}
    for name, kw, r in (("uniform", dict(dp_sched=0.0), 5),
                        ("linear0", dict(dp_sched=1.0, dp_sched_rate=0.4), 0),
                        ("linear_end", dict(dp_sched=1.0, dp_sched_rate=0.4),
                         rounds - 1),
                        ("linear3", dict(dp_sched=1.0, dp_sched_rate=0.3), 3),
                        ("adaptive", dict(dp_sched=2.0), 5)):
        tpr, jpr = _prs(**kw)
        got[name] = float(sched_lib.scheduled_multiplier(st, tpr, r,
                                                         rounds)[0])
        want = float(j_sched.scheduled_multiplier(
            jst, jpr, jnp.asarray(r, jnp.int32), rounds))
        assert got[name] == want, name
    assert got["uniform"] == 2.0
    np.testing.assert_allclose(got["linear0"], 2.0 * 1.4, rtol=1e-6)
    np.testing.assert_allclose(got["linear_end"], 2.0 * 0.6, rtol=1e-6)
    np.testing.assert_allclose(got["adaptive"], 2.0 * 0.5, rtol=1e-6)
    assert sched_lib.SCHEDULES == j_sched.SCHEDULES
    assert sched_lib.BOOST_FLOOR == j_sched.BOOST_FLOOR
    assert sched_lib.schedule_code("adaptive") == 2.0


def test_adaptive_controller_spends_on_stall():
    tpr, jpr = _prs(dp_sched_rate=0.5, dp_stall_tol=1e-3)
    st = sched_lib.init_scheduler(torch.tensor([50.0]), GRID, 40, 0.25)
    jst = j_sched.init_scheduler(jnp.float32(50.0), DELTA, 40,
                                 jnp.float32(0.25))
    np.testing.assert_allclose(float(st.z_base[0]), float(jst.z_base),
                               rtol=1e-6)
    assert float(st.boost[0]) == 1.0
    boosts = []
    for auc in (0.7, 0.7) + (0.7,) * 10 + (0.9,):
        st = sched_lib.scheduler_update(st, torch.tensor([auc]), tpr)
        jst = j_sched.scheduler_update(jst, jnp.float32(auc), jpr)
        assert float(st.boost[0]) == float(jst.boost)
        assert float(st.best_auc[0]) == float(jst.best_auc)
        boosts.append(float(st.boost[0]))
    # improving: untouched; stalled: × (1 − rate); floored; a fresh
    # improvement stops the decay without raising it back
    assert boosts[0] == 1.0 and boosts[1] == pytest.approx(0.5)
    assert boosts[-2] == pytest.approx(sched_lib.BOOST_FLOOR)
    assert boosts[-1] == boosts[-2]
    assert float(st.best_auc[0]) == pytest.approx(0.9)


# ---------------------------------------------------------------------------
# the exhaustion gate
# ---------------------------------------------------------------------------

ROUNDS = 12
EVAL_EVERY = 4


@pytest.fixture(scope="module")
def fed():
    return make_federated(0, "unsw", n_samples=800, n_clients=6)


@pytest.fixture(scope="module")
def fl():
    return FLConfig(n_clients=6, clients_per_round=3, rounds=ROUNDS,
                    local_epochs=2, local_batch=16, local_lr=0.08,
                    dp_enabled=True, dp_mode="clipped", dp_clip=1.0,
                    dp_scheduled=True, fault_tolerance=True,
                    failure_prob=0.05)


@pytest.mark.parametrize("server_opt", ["sgd", "fedavgm", "fedadam"])
def test_gate_freezes_a_lane_bitwise_in_the_lane_step(fed, server_opt):
    """Three lanes, the middle one gated off every round: its params and
    server state (momentum; Adam's moments and step count) stay bitwise,
    and the live lanes equal the ungated step."""
    fl = FLConfig(n_clients=6, clients_per_round=3, local_epochs=2,
                  local_batch=16, server_opt=server_opt, server_lr=0.5)
    n = fed.n_clients
    sizes = fed.data_sizes()
    singles = []
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        singles.append(t_rounds.init_round_state(
            t_mlp.init_mlp(gen, fed.n_features, 16), fl, gen, n_clients=n,
            data_size=torch.as_tensor(sizes / sizes.mean()),
            data_quality=torch.as_tensor(fed.label_entropy())))
    gated = ungated = t_rounds.stack_states(singles)
    frozen = (flatten_rows(gated.params).clone(), gated.server_opt_state)
    step = t_rounds.make_lane_round(t_mlp.mlp_loss, fl, n, device="cpu")
    stack = t_syn.stack_federation(fed, "cpu")
    pr = params_lanes([fl] * 3, 1)
    gate = torch.tensor([1.0, 0.0, 1.0])
    n_params = flatten_rows(singles[0].params, 0).numel()
    for r in range(3):
        gens = [torch.Generator().manual_seed(10 * r + i) for i in range(3)]
        idx = t_syn.draw_batch_indices(gens, stack.sizes, fl.local_epochs,
                                       fl.local_batch)
        draws = t_rounds.draw_round(gens, n, fl.local_epochs, n_params,
                                    fl.selection)
        batches = t_syn.sample_round_batches(stack, idx)
        gated, gm = step(gated, batches, pr, draws, update_gate=gate)
        ungated, um = step(ungated, batches, pr, draws)
        # a frozen lane's clients still train and score from its old model,
        # so only the live lanes see the ungated run's selection
        assert torch.equal(gm.sel_mask[[0, 2]], um.sel_mask[[0, 2]])
    flat = flatten_rows(gated.params)
    assert torch.equal(flat[1], frozen[0][1])
    assert not torch.equal(flat[0], frozen[0][0])
    assert torch.equal(flat[[0, 2]], flatten_rows(ungated.params)[[0, 2]])
    lane1 = t_rounds.lane_state(gated, 1).server_opt_state
    start1 = t_rounds.lane_state(t_rounds.stack_states(singles),
                                 1).server_opt_state
    for a, b in zip(jax.tree.leaves(lane1), jax.tree.leaves(start1)):
        assert torch.equal(a, b)
    if server_opt == "fedadam":
        assert gated.server_opt_state.count.tolist() == [3, 0, 3]


def _lane_params(fed, fl, budget, rounds, seed=0):
    res = fl_driver.run_fl_batch(
        fed, dataclasses.replace(fl, dp_budget=budget), seeds=(seed,),
        rounds=rounds, eval_every=EVAL_EVERY, hidden=16, return_params=True,
        device="cpu")[0]
    return res


def test_exhaustion_freezes_global_model_bitwise(fed, fl):
    """A budget below the conversion floor (0.01 < ~0.019 at δ = 1e-5):
    every release overshoots, so the lane's params stay at its init
    bitwise, nothing is released or spent, and a longer run ends at the
    same bits."""
    res = _lane_params(fed, fl, 0.01, ROUNDS)
    gen = torch.Generator().manual_seed(0)
    init = t_mlp.init_mlp(gen, fed.n_features, 16, fed.n_classes)
    assert torch.equal(flatten_rows(res.params, 0), flatten_rows(init, 0))
    assert res.history["live"] == [0.0] * 3
    assert res.history["eps"] == [0.0] * 3 and res.eps_spent == 0.0
    longer = _lane_params(fed, fl, 0.01, 20)
    assert torch.equal(flatten_rows(longer.params, 0),
                       flatten_rows(res.params, 0))


def test_live_budget_moves_the_model_and_respects_budget(fed, fl):
    res = _lane_params(fed, fl, 300.0, ROUNDS)
    gen = torch.Generator().manual_seed(0)
    init = t_mlp.init_mlp(gen, fed.n_features, 16, fed.n_classes)
    assert not torch.equal(flatten_rows(res.params, 0),
                           flatten_rows(init, 0))
    eps = np.asarray(res.history["eps"])
    assert np.all(np.diff(eps) >= -1e-6) and np.all(eps <= 300.0 * (1 + 1e-5))


def test_budget_grid_one_runner_and_ordered_frontier(fed, fl):
    """A (budget × schedule) grid is one runner; more budget, less noise;
    each lane's ε within its own budget; the always-stalling adaptive lane
    spends faster than the uniform lane at the same budget."""
    budgets = (50.0, 200.0, 800.0, 3200.0)
    cells = [{"dp_budget": b} for b in budgets]
    cells.append({"dp_budget": 800.0,
                  "dp_sched": sched_lib.schedule_code("adaptive"),
                  "dp_stall_tol": 10.0})
    m0 = fl_driver.RUNNER_STATS["misses"]
    sweep = fl_driver.run_fl_sweep(fed, fl, cells, seeds=(0, 1),
                                   rounds=ROUNDS, eval_every=EVAL_EVERY,
                                   hidden=16, device="cpu")
    assert fl_driver.RUNNER_STATS["misses"] - m0 == 1
    sigmas = [row[0].history["sigma"][0] for row in sweep[:4]]
    assert all(a > b for a, b in zip(sigmas, sigmas[1:])), sigmas
    for cell, row in zip(cells, sweep):
        for r in row:
            assert r.eps_spent <= cell["dp_budget"] * (1 + 1e-5)
            assert r.history["eps"][-1] == r.eps_spent
    ada, uni = sweep[4][0].history["sigma"], sweep[2][0].history["sigma"]
    assert ada[-1] < ada[0] and uni[-1] == pytest.approx(uni[0])
    assert sweep[4][0].history["eps"][-1] >= sweep[2][0].history["eps"][-1]


def test_unscheduled_configs_and_legacy_are_unchanged(fed, fl):
    """``dp_scheduled=False`` keeps the host closed-form ε and no
    ``eps``/``sigma`` columns; the legacy loop and the closed form refuse
    scheduled configs."""
    plain = dataclasses.replace(fl, dp_scheduled=False, dp_epsilon=200.0)
    r = fl_driver.run_fl(fed, plain, seed=0, rounds=6, eval_every=3,
                         hidden=16, device="cpu")
    assert "eps" not in r.history and "sigma" not in r.history
    assert r.eps_spent == acct_lib.accounted_epsilon(dataclasses.replace(
        plain, selection="adaptive_utility"), 6)
    with pytest.raises(ValueError, match="dp_scheduled"):
        fl_driver.run_fl_legacy(fed, fl, seed=0, rounds=4, device="cpu")
    with pytest.raises(ValueError, match="in-loop accountant"):
        acct_lib.accounted_epsilon(fl, 4)


def test_scheduled_requires_clipped_mode(fed, fl):
    """dp_scheduled with the paper's unclipped mode would state an (ε, δ)
    for a mechanism of unbounded sensitivity: refused."""
    with pytest.raises(ValueError, match="clipped"):
        fl_driver.run_fl(fed, dataclasses.replace(fl, dp_mode="paper"),
                         seed=0, rounds=4, eval_every=2, device="cpu")
