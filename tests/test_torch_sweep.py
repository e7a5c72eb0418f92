"""The port's sweep engine (``run_fl_sweep`` / ``run_fl_batch`` /
``run_fl``) against the JAX reference's, and against itself lane by lane:
fixed-σ cells on unsw, ``dp_scheduled`` cells (the in-loop accountant,
the three schedules and the exhaustion gate) and one ``road_raw`` cell
each of the ``cnn`` and ``rglru`` detectors.

The parity test rebuilds every lane's random decisions from the
reference's own keys (``fold_in(key, 0..2)`` in ``_build_single_run``,
``split`` of the data key per round, ``reference_draws`` for the round
step) and feeds them to the port's engine; both run on the CPU in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.core import rounds as j_rounds
from repro.data.synthetic import make_federated as j_make_federated
from repro.data.synthetic import stack_federation as j_stack_federation
from repro.kernels import ref as j_ref
from repro.models import spec as j_spec
from repro.train import fl_driver as j_fl_driver

from repro_torch import convert
from repro_torch.configs.base import FLConfig, fl_params, params_lanes
from repro_torch.core import rounds as t_rounds
from repro_torch.data import synthetic as t_syn
from repro_torch.kernels import ref as t_ref
from repro_torch.models import mlp as t_mlp
from repro_torch.train import fl_driver as t_fl_driver
from repro_torch.tree import flatten_rows
from test_torch_parity import leaf_shapes, reference_draws, to_np

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
ROUNDS, EVAL_EVERY = 5, 2          # two eval blocks and a trailing partial one
SEEDS = (0, 2)
# the reference's tests/test_sweep.py config
BASE = dict(n_clients=8, clients_per_round=3, local_epochs=2, local_batch=16,
            local_lr=0.08, dp_epsilon=200.0, dp_clip=5.0, failure_prob=0.05)
# two ε values, and Markov outages at another failure rate.  At ε = 50 the
# noise (σ = 0.48 a coordinate) drives the loss past 50 and the softmax to
# 0 and 1, where the rank AUC (no tie correction, as the reference's) turns on
# one-ulp differences between near-equal scores; these cells train.
CELLS = ({"dp_epsilon": 200.0}, {"dp_epsilon": 1000.0},
         {"fault_process": 1.0, "failure_prob": 0.3})


@pytest.fixture(scope="module")
def feds():
    """The same federation from both packages' (bitwise equal) generators."""
    return (j_make_federated(0, "unsw", n_samples=1_500, n_clients=8),
            t_syn.make_federated(0, "unsw", n_samples=1_500, n_clients=8))


def _close(a, b, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _reference_lane_inputs(jfed, tfl, seed, rounds, jfl=None):
    """One seed's initial state and per-round ``(batch_idx, RoundDraws)``
    as the reference's engine draws them from ``jax.random.key(seed)``,
    for the model of ``jfl`` (the ``BASE`` config by default)."""
    jfl = jfl or JFLConfig(**BASE)
    key = jax.random.key(seed)
    spec = j_spec.get_model_spec(jfl.model, j_spec.meta_for(jfed, hidden=64))
    jparams = spec.init(jax.random.fold_in(key, 0))
    sizes = jfed.data_sizes()
    jstate = j_rounds.init_round_state(
        jparams, jfl, jax.random.fold_in(key, 1), n_clients=jfed.n_clients,
        data_size=jnp.asarray(sizes / sizes.mean()),
        data_quality=jnp.asarray(jfed.label_entropy()))
    init = convert.round_state_from_jax(
        to_np(jstate.params), to_np(jstate.util), to_np(jstate.kctl),
        to_np(jstate.fault), tfl, "cpu", seed=seed)
    stack = j_stack_federation(jfed)
    randint = jax.vmap(lambda k, size: jax.random.randint(
        k, (jfl.local_epochs, jfl.local_batch), 0, size))
    data_key, state_rng, draws = jax.random.fold_in(key, 2), jstate.rng, []
    for _ in range(rounds):
        data_key, k_batch = jax.random.split(data_key)
        idx = randint(jax.random.split(k_batch, jfed.n_clients), stack.sizes)
        d, state_rng = reference_draws(state_rng, jfed.n_clients,
                                       jfl.local_epochs, leaf_shapes(jparams))
        draws.append((torch.as_tensor(np.array(idx)).long(), d))
    return init, draws


def test_sweep_matches_jax_sweep_with_reference_draws(feds):
    """3 cells × 2 seeds, 5 rounds at eval_every 2: every history key of
    every lane to rtol 1e-5 (atol 1e-6), ε equal, simulated time to rtol
    1e-5, against one JAX ``run_fl_sweep``."""
    jfed, tfed = feds
    jfl, tfl = JFLConfig(**BASE), FLConfig(**BASE)
    jres = j_fl_driver.run_fl_sweep(jfed, jfl, list(CELLS), seeds=SEEDS,
                                    rounds=ROUNDS, eval_every=EVAL_EVERY)
    per_seed = [_reference_lane_inputs(jfed, tfl, s, ROUNDS) for s in SEEDS]
    lanes = [per_seed[si] for _ in CELLS for si in range(len(SEEDS))]
    tres = t_fl_driver.run_fl_sweep(
        tfed, tfl, list(CELLS), seeds=SEEDS, rounds=ROUNDS,
        eval_every=EVAL_EVERY, device="cpu",
        init_states=[init for init, _ in lanes],
        draws=[d for _, d in lanes])
    assert len(tres) == len(CELLS)
    for ci, (jrow, trow) in enumerate(zip(jres, tres)):
        for jr, tr in zip(jrow, trow):
            what = f"cell {ci} seed {tr.seed}"
            assert tr.seed == jr.seed
            assert tr.history.keys() == jr.history.keys()
            assert tr.history["round"] == jr.history["round"] == [2, 4, 5]
            for name in jr.history:
                _close(tr.history[name], jr.history[name], f"{name}, {what}")
            assert tr.eps_spent == jr.eps_spent, what
            _close(tr.sim_time_s, jr.sim_time_s, f"sim_time, {what}",
                   atol=0.0)
    # the grid is real: ε differs across the two ε cells
    assert tres[0][0].eps_spent != tres[1][0].eps_spent


def _run_both(jfed, tfed, base, cells, seeds):
    """The JAX ``run_fl_sweep`` and the port's, fed the reference's draws,
    over ``cells × seeds`` at ROUNDS / EVAL_EVERY."""
    jfl, tfl = JFLConfig(**base), FLConfig(**base)
    jres = j_fl_driver.run_fl_sweep(jfed, jfl, list(cells), seeds=seeds,
                                    rounds=ROUNDS, eval_every=EVAL_EVERY,
                                    return_params=True)
    per_seed = [_reference_lane_inputs(jfed, tfl, s, ROUNDS, jfl)
                for s in seeds]
    lanes = [per_seed[si] for _ in cells for si in range(len(seeds))]
    tres = t_fl_driver.run_fl_sweep(
        tfed, tfl, list(cells), seeds=seeds, rounds=ROUNDS,
        eval_every=EVAL_EVERY, device="cpu",
        init_states=[init for init, _ in lanes],
        draws=[d for _, d in lanes], return_params=True)
    return jres, tres


def _assert_lanes_match(jres, tres):
    """Every history key of every lane to rtol 1e-5 / atol 1e-6, ε and
    the simulated time as in the three-cell parity test, and the final
    params to 1e-5."""
    for ci, (jrow, trow) in enumerate(zip(jres, tres)):
        for jr, tr in zip(jrow, trow):
            what = f"cell {ci} seed {tr.seed}"
            assert tr.history.keys() == jr.history.keys(), what
            for name in jr.history:
                _close(tr.history[name], jr.history[name], f"{name}, {what}")
            _close(tr.eps_spent, jr.eps_spent, f"eps, {what}")
            _close(tr.sim_time_s, jr.sim_time_s, f"sim_time, {what}",
                   atol=0.0)
            for a, b in zip(jax.tree.leaves(jr.params),
                            t_fl_driver.tree_leaves(tr.params)):
                _close(b, a, f"params, {what}", atol=1e-5)


# scheduled budgets: uniform, linear and an always-stalling adaptive lane,
# and a budget below the conversion floor, which no release fits.  The
# budgets keep σ at or under ~0.12 a coordinate, where the model trains
# (at a budget of 300, σ = 0.41 drives the loss past 20: see CELLS)
SCHED_CELLS = ({"dp_budget": 3000.0},
               {"dp_budget": 5000.0, "dp_sched": 1.0, "dp_sched_rate": 0.4},
               {"dp_budget": 5000.0, "dp_sched": 2.0, "dp_stall_tol": 10.0},
               {"dp_budget": 0.01})


def test_scheduled_sweep_matches_jax_sweep_with_reference_draws(feds):
    """``dp_scheduled`` lanes against the JAX ``run_fl_sweep``: every
    history key, ``eps``/``sigma``/``live`` included, to rtol 1e-5; ε from
    the lane's in-loop accountant; the exhausted lane never releases and
    its params stay at init bitwise."""
    jfed, tfed = feds
    base = {**BASE, "dp_scheduled": True}
    jres, tres = _run_both(jfed, tfed, base, SCHED_CELLS, SEEDS)
    _assert_lanes_match(jres, tres)
    for row in tres:
        for r in row:
            assert {"eps", "sigma", "live"} <= r.history.keys()
            assert r.eps_spent == r.history["eps"][-1]
    # the linear lane's σ falls, the stalling adaptive lane's too; the
    # uniform lane's is constant
    for ci in (1, 2):
        assert tres[ci][0].history["sigma"][-1] < \
            tres[ci][0].history["sigma"][0]
    assert len(set(tres[0][0].history["sigma"])) == 1
    exhausted = tres[3]
    init, _ = _reference_lane_inputs(jfed, FLConfig(**base), SEEDS[0],
                                     ROUNDS, JFLConfig(**base))
    assert all(v == 0.0 for r in exhausted for v in r.history["live"])
    assert all(r.eps_spent == 0.0 for r in exhausted)
    assert torch.equal(flatten_rows(exhausted[0].params, 0),
                       flatten_rows(init.params, 0))


@pytest.fixture(scope="module")
def road_feds():
    return (j_make_federated(0, "road_raw", n_samples=600, n_clients=8),
            t_syn.make_federated(0, "road_raw", n_samples=600, n_clients=8))


@pytest.mark.parametrize("model", ["cnn", "rglru"])
def test_window_detector_sweep_matches_jax_sweep(road_feds, model):
    """One ``road_raw`` cell of ``cnn`` or ``rglru`` × 2 seeds, at the
    reference sweep test's config, against the JAX ``run_fl_sweep`` with
    the reference's draws (every history key to rtol 1e-5 / atol 1e-6,
    the final params to 1e-5).  The reference evaluates on its CPU
    default route (``"ref"``), the port on ``"kernel"`` (the plain
    sequential scan on the CPU)."""
    jfed, tfed = road_feds
    jres, tres = _run_both(jfed, tfed, {**BASE, "model": model}, [{}],
                           SEEDS)
    _assert_lanes_match(jres, tres)


def test_sweep_lanes_equal_single_runs_with_own_rng(feds):
    """Each lane of a sweep drawing from its own ``torch.Generator`` equals
    ``run_fl`` of its cell and seed (the counterpart of the reference's
    tests/test_sweep.py lane-for-lane test, at its tolerances)."""
    _, tfed = feds
    fl = FLConfig(**BASE)
    cells = [dataclasses.replace(fl, dp_epsilon=e) for e in (50.0, 1000.0)]
    sweep = t_fl_driver.run_fl_sweep(tfed, fl, cells, seeds=SEEDS, rounds=6,
                                     eval_every=4, device="cpu")
    for cell, row in zip(cells, sweep):
        for seed, lane in zip(SEEDS, row):
            single = t_fl_driver.run_fl(tfed, cell, "proposed", seed=seed,
                                        rounds=6, eval_every=4, device="cpu")
            assert lane.seed == seed and lane.eps_spent == single.eps_spent
            assert lane.history["round"] == single.history["round"] == [4, 6]
            np.testing.assert_allclose(lane.history["acc"],
                                       single.history["acc"], atol=1e-5)
            np.testing.assert_allclose(lane.history["cum_time"],
                                       single.history["cum_time"], rtol=1e-5)
    eps = [row[0].eps_spent for row in sweep]
    assert eps == sorted(eps) and len(set(eps)) == len(cells)
    # one seed's lanes differ across cells only through the runtime values
    assert sweep[0][0].history["loss"] != sweep[1][0].history["loss"]


def test_fedl2p_personalises_each_lane_and_returns_params(feds):
    """``fedl2p`` lanes report the personalisation pass over the lane's
    final params, at 1.2× the simulated time, as the reference's sweep
    does; ``return_params`` hands back the lane's params."""
    _, tfed = feds
    fl = FLConfig(**BASE)
    res = t_fl_driver.run_fl_batch(tfed, fl, "fedl2p", seeds=SEEDS, rounds=3,
                                   eval_every=3, return_params=True,
                                   device="cpu")
    plain = t_fl_driver.run_fl_batch(tfed, fl, "random", seeds=SEEDS,
                                     rounds=3, eval_every=3, device="cpu")
    spec = t_fl_driver.get_model_spec("mlp", t_fl_driver.meta_for(tfed))
    for seed, lane, base in zip(SEEDS, res, plain):
        assert plain[0].params is None and lane.params is not None
        assert lane.history == base.history  # fedl2p trains as random
        acc, auc = t_fl_driver._personalize(lane.params, tfed, spec,
                                            seed=seed)
        assert (lane.accuracy, lane.auc) == (acc, auc)
        assert lane.sim_time_s == pytest.approx(1.2 * base.sim_time_s,
                                                rel=1e-6)


def test_one_runner_per_static_key(feds):
    """A grid builds one runner; new runtime values hit it; a STATIC change
    or another lane count builds another."""
    _, tfed = feds
    fl = FLConfig(**BASE)
    cells = [dataclasses.replace(fl, dp_epsilon=e) for e in (60.0, 120.0)]
    kw = dict(seeds=SEEDS, rounds=2, eval_every=2, device="cpu")
    m0 = t_fl_driver.RUNNER_STATS["misses"]
    t_fl_driver.run_fl_sweep(tfed, fl, cells, **kw)
    assert t_fl_driver.RUNNER_STATS["misses"] == m0 + 1
    h0 = t_fl_driver.RUNNER_STATS["hits"]
    t_fl_driver.run_fl_sweep(tfed, fl, [{"dp_epsilon": 7.0},
                                        {"local_lr": 0.2}], **kw)
    assert t_fl_driver.RUNNER_STATS["misses"] == m0 + 1
    assert t_fl_driver.RUNNER_STATS["hits"] == h0 + 1
    t_fl_driver.run_fl_batch(tfed, dataclasses.replace(fl, selection="random"),
                             method="random", **kw)
    t_fl_driver.run_fl_batch(tfed, fl, **kw)  # 2 lanes, not 4
    assert t_fl_driver.RUNNER_STATS["misses"] == m0 + 3


def test_cells_rejected_and_accepted_as_in_the_reference(feds):
    _, tfed = feds
    fl = FLConfig(**BASE)
    kw = dict(seeds=(0,), rounds=2, eval_every=2, device="cpu")
    with pytest.raises(ValueError, match="STATIC"):
        t_fl_driver.run_fl_sweep(
            tfed, fl, [fl, dataclasses.replace(fl, dp_mode="paper")], **kw)
    grid = [{"dp_epsilon": 80.0},
            fl_params(dataclasses.replace(fl, dp_epsilon=80.0))]
    res = t_fl_driver.run_fl_sweep(tfed, fl, grid, **kw)
    assert res[0][0].eps_spent == res[1][0].eps_spent
    assert res[0][0].history == res[1][0].history
    # plans of the sweep's family ride its lanes, from a plan code or a
    # plan name; a plan the registry keeps off this engine raises before
    # any round, with the reference's error
    coded = t_fl_driver.run_fl_sweep(
        tfed, fl, [fl_params(fl)._replace(plan_code=2.0),
                   dataclasses.replace(fl, plan="buffered_async",
                                       async_buffer=2.0)], **kw)
    assert [len(row) for row in coded] == [1, 1]
    with pytest.raises(ValueError, match="cannot run on this engine"):
        t_fl_driver.run_fl(tfed, dataclasses.replace(fl, plan="client_serial"),
                           rounds=2, device="cpu")
    # scheduled privacy needs clipped updates, as in the reference
    with pytest.raises(ValueError, match="clipped"):
        t_fl_driver.run_fl(tfed, dataclasses.replace(
            fl, dp_scheduled=True, dp_mode="paper"), rounds=2, device="cpu")
    assert t_fl_driver.run_fl_sweep(tfed, fl, [], **kw) == []


def test_sample_round_batches_respects_client_sizes(feds):
    """Every sampled row is one of that client's own rows, never padding
    (the counterpart of the reference's tests/test_engine.py test)."""
    _, tfed = feds
    stack = t_syn.stack_federation(tfed, "cpu")
    gens = [torch.Generator().manual_seed(s) for s in (0, 1, 2)]
    idx = t_syn.draw_batch_indices(gens, stack.sizes, 4, 64)
    b = t_syn.sample_round_batches(stack, idx)
    n, d = tfed.n_clients, tfed.n_features
    assert b["x"].shape == (3, n, 4, 64, d) and b["y"].shape == (3, n, 4, 64)
    assert b["y"].dtype == torch.long
    sizes = stack.sizes.reshape(1, n, 1, 1)
    assert bool((idx >= 0).all()) and bool((idx < sizes).all())
    for lane in range(3):
        for ci in range(n):
            rows = b["x"][lane, ci].reshape(-1, d).numpy()
            src = tfed.x[ci]
            hit = (np.abs(src[None] - rows[:, None]).max(-1) == 0).any(-1)
            assert hit.all(), (lane, ci)
            np.testing.assert_array_equal(
                b["y"][lane, ci].reshape(-1).numpy(),
                tfed.y[ci][idx[lane, ci].reshape(-1).numpy()])
    # lanes of one generator state draw the same rows
    again = t_syn.draw_batch_indices([torch.Generator().manual_seed(1)],
                                     stack.sizes, 4, 64)
    assert torch.equal(again[0], idx[1])


def test_lane_step_equals_separate_steps(feds):
    """The lane round step at L = 3, lanes with iid, Markov and straggler
    failures and different ε, equals three one-run steps, round by round:
    masks and failures bitwise, the rest to 1e-6."""
    _, tfed = feds
    fl = FLConfig(**{**BASE, "failure_prob": 0.3})
    cells = [dataclasses.replace(fl, fault_process=c, dp_epsilon=e)
             for c, e in ((0.0, 50.0), (1.0, 200.0), (3.0, 1000.0))]
    n = tfed.n_clients
    sizes = tfed.data_sizes()
    singles = []
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        singles.append(t_rounds.init_round_state(
            t_mlp.init_mlp(gen, tfed.n_features, 32), fl, gen, n_clients=n,
            data_size=torch.as_tensor(sizes / sizes.mean()),
            data_quality=torch.as_tensor(tfed.label_entropy())))
    lanes = t_rounds.stack_states(singles)
    lane_step = t_rounds.make_lane_round(t_mlp.mlp_loss, fl, n, device="cpu")
    one_step = t_rounds.make_parallel_round(t_mlp.mlp_loss, fl, n,
                                            device="cpu")
    pr = params_lanes(cells, 1)
    stack = t_syn.stack_federation(tfed, "cpu")
    n_params = flatten_rows(singles[0].params, 0).numel()
    stragglers = 0.0
    for r in range(3):
        gens = [torch.Generator().manual_seed(100 * r + i) for i in range(3)]
        idx = t_syn.draw_batch_indices(gens, stack.sizes, fl.local_epochs,
                                       fl.local_batch)
        draws = t_rounds.draw_round(gens, n, fl.local_epochs, n_params,
                                    fl.selection)
        batches = t_syn.sample_round_batches(stack, idx)
        lanes, lm = lane_step(lanes, batches, pr, draws)
        stragglers += float((lm.slow[2] > 1.0).sum())
        for i, cell in enumerate(cells):
            singles[i], sm = one_step(
                singles[i], {k: v[i] for k, v in batches.items()},
                params=fl_params(cell), draws=draws.lane(i))
            for name in ("sel_mask", "avail", "failed", "slow"):
                assert torch.equal(getattr(lm, name)[i], getattr(sm, name)), \
                    f"{name}, lane {i}, round {r}"
            for name in ("pre_loss", "post_loss", "global_loss",
                         "k_effective", "update_norms"):
                _close(getattr(lm, name)[i], getattr(sm, name),
                       f"{name}, lane {i}, round {r}", rtol=1e-6, atol=1e-7)
            got = t_rounds.lane_state(lanes, i)
            for a, b in zip([*got.util, *got.kctl, *got.fault],
                            [*singles[i].util, *singles[i].kctl,
                             *singles[i].fault]):
                _close(a, b, f"state, lane {i}, round {r}", rtol=1e-6,
                       atol=1e-7)
            _close(flatten_rows(got.params, 0),
                   flatten_rows(singles[i].params, 0),
                   f"params, lane {i}, round {r}", rtol=1e-6, atol=1e-7)
    # the straggler lane ran its own process: slow clients, no failures
    assert stragglers > 0


def test_scale_noise_per_row_sigma_is_the_reference_fold():
    """``scale_noise_rows_ref`` with one σ a row is bitwise the JAX
    ``dp_clip_noise_tree_ref`` with a traced (array) σ, row by row, and the
    float-σ route is bitwise the same numbers."""
    rng = np.random.default_rng(5)
    rows, x_rows, noise_rows, scales, want = 6, [], [], [], []
    sigmas = rng.uniform(0.05, 3.0, rows).astype(np.float32)
    for r in range(rows):
        tree = {"a": {"w": rng.normal(0, 2, (7, 5)).astype(np.float32),
                      "b": rng.normal(0, 2, (5,)).astype(np.float32)},
                "z": rng.normal(0, 2, (11,)).astype(np.float32)}
        key = jax.random.key(r)
        out, norm = j_ref.dp_clip_noise_tree_ref(
            jax.tree.map(jnp.asarray, tree), key, 1.5, jnp.float32(sigmas[r]))
        leaves = jax.tree.leaves(tree)
        keys = jax.random.split(key, len(leaves))
        noise_rows.append(np.concatenate(
            [np.asarray(jax.random.normal(k, l.shape, jnp.float32)).ravel()
             for k, l in zip(keys, leaves)]))
        x_rows.append(np.concatenate([l.ravel() for l in leaves]))
        scale = np.minimum(np.float32(1.0), np.float32(1.5) / np.maximum(
            np.asarray(norm, np.float32), np.float32(1e-12)))
        scales.append(scale)
        want.append(np.concatenate([np.asarray(l).ravel()
                                    for l in jax.tree.leaves(out)]))
    x, nz = torch.as_tensor(np.stack(x_rows)), torch.as_tensor(
        np.stack(noise_rows))
    scale = torch.as_tensor(np.stack(scales).astype(np.float32))
    got = t_ref.scale_noise_rows_ref(x, nz, scale, torch.as_tensor(sigmas))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    for r in range(rows):
        one = t_ref.scale_noise_rows_ref(x[r:r + 1], nz[r:r + 1],
                                         scale[r:r + 1], float(sigmas[r]))
        assert torch.equal(one[0], got[r])
