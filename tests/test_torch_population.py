"""The port's population engine against the JAX reference: the lazy
``Population``, the on-device cohort draw (``cohort_topk``), the cohort
gather, the ``client_cohort`` round step and ``run_fl_population``, and
the memory accounting of ``core/scale.py``.

The reference draws a cohort round's DP noise from ``fold_in(k_dp,
client_id)``, its batch rows from ``split(k_batch, k_max)`` and its
covariate shifts from ``fold_in(shift_key, client_id)``; all three depend
on the cohort, so :func:`reference_cohort_draws` rebuilds them from the
reference's keys once its step has picked the cohort, and the port's step
is fed them.  Both sides run on the CPU in f32.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.base import fl_params as j_fl_params
from repro.core import rounds as j_rounds
from repro.core import scale as j_scale
from repro.core import selection as j_sel
from repro.data import synthetic as j_syn
from repro.models import spec as j_spec
from repro.train import fl_driver as j_fl_driver

from repro_torch import convert
from repro_torch.configs.base import FLConfig, fl_params
from repro_torch.core import rounds as t_rounds
from repro_torch.core import scale as t_scale
from repro_torch.core import selection as t_sel
from repro_torch.data import synthetic as t_syn
from repro_torch.fault import process as t_fault
from repro_torch.train import fl_driver as t_fl_driver
from repro_torch.tree import flatten_rows
from test_torch_parity import leaf_shapes, reference_draws, to_np

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N, MEMBERS, POOL, K_MAX = 128, 16, 2_000, 8
# bench_scale's config at a small size
BASE = dict(n_clients=N, clients_per_round=6, k_max=K_MAX, local_epochs=2,
            local_batch=16, local_lr=0.08, dp_epsilon=200.0, dp_clip=5.0,
            failure_prob=0.1)


def _close(a, b, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def pops():
    """The same population from both packages' generators, the port's on
    the CPU as the engine holds it."""
    kw = dict(n_clients=N, pool_samples=POOL, members_per_client=MEMBERS)
    return (j_syn.make_population(0, **kw),
            t_syn.make_population(0, **kw).to("cpu"))


# ---------------------------------------------------------------------------
# the population's arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dataset,n,chunk", [
    ("unsw", 3_000, 1_024),      # three chunks and a ragged fourth
    ("unsw", 200, 16_384),
    ("road_raw", 300, 128),
], ids=["unsw-chunked", "unsw-one-chunk", "road_raw"])
def test_make_population_is_bitwise_the_reference(dataset, n, chunk):
    kw = dict(dataset=dataset, n_clients=n, pool_samples=1_200,
              members_per_client=12, chunk_clients=chunk)
    jp, tp = j_syn.make_population(3, **kw), t_syn.make_population(3, **kw)
    for name in t_syn.Population._ARRAYS:
        a, b = getattr(tp, name), np.asarray(getattr(jp, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tp.feature_shape, tp.feature_shift) == (jp.feature_shape,
                                                     jp.feature_shift)
    assert tp.shift_seed == 3 ^ 0x5CA1E
    dev = tp.to("cpu")
    assert dev.pool_y.dtype == torch.int64
    assert dev.member_idx.dtype == torch.int32
    assert dev.shapes() != tp.shapes() and dev.n_clients == n


# ---------------------------------------------------------------------------
# the cohort draw
# ---------------------------------------------------------------------------


def _cohort_case(seed: int, lanes: int, n: int, ties: bool):
    rng = np.random.default_rng(seed)
    if ties:   # few distinct values: most scores tie
        scores = rng.integers(0, 4, (lanes, n)).astype(np.float32)
    else:
        scores = rng.normal(size=(lanes, n)).astype(np.float32)
    avail = (rng.random((lanes, n)) < 0.7).astype(np.float32)
    k_eff = rng.uniform(1.0, 20.0, lanes).astype(np.float32)
    return scores, avail, k_eff


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "distinct"])
@pytest.mark.parametrize("chunks", [1, 4, 16])
def test_cohort_topk_is_bitwise_host_and_jax(ties, chunks):
    """The port's cohort over ``[L, N]`` lanes equals, lane for lane and
    bitwise, the NumPy oracle and the JAX ``cohort_topk`` (lower index
    first among ties), chunked or not, with unavailable clients and a
    ``k_eff`` above what is available in one lane."""
    lanes, n, k_max = 3, 256, 16
    scores, avail, k_eff = _cohort_case(chunks, lanes, n, ties)
    avail[2, :10], avail[2, 10:] = 1.0, 0.0   # 10 available, k_eff 18
    k_eff[2] = 18.0
    idx, take = t_sel.cohort_topk(torch.as_tensor(scores),
                                  torch.as_tensor(avail),
                                  torch.as_tensor(k_eff), k_max,
                                  chunks=chunks)
    h_idx, h_take = t_sel.cohort_topk_host(scores, avail, k_eff, k_max)
    np.testing.assert_array_equal(idx.numpy(), h_idx)
    np.testing.assert_array_equal(take.numpy(), h_take)
    for lane in range(lanes):
        j_idx, j_take = j_sel.cohort_topk(
            jnp.asarray(scores[lane]), jnp.asarray(avail[lane]),
            jnp.asarray(k_eff[lane]), k_max, chunks=chunks)
        np.testing.assert_array_equal(idx[lane].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(take[lane].numpy(), np.asarray(j_take))
        r_idx, r_take = j_sel.cohort_topk_host(scores[lane], avail[lane],
                                               float(k_eff[lane]), k_max)
        np.testing.assert_array_equal(idx[lane].numpy(), r_idx)
        np.testing.assert_array_equal(take[lane].numpy(), r_take)
    assert take[2].sum() == 10           # capped by availability
    # the dense mask is the index form scattered
    dense = t_sel._topk_mask(torch.as_tensor(scores), torch.as_tensor(avail),
                             torch.as_tensor(k_eff), k_max)
    assert torch.equal(torch.zeros(lanes, n).scatter_(-1, idx, take), dense)


def test_score_functions_and_refusal():
    assert t_sel.cohort_strategy_names() == j_sel.cohort_strategy_names()
    with pytest.raises(ValueError) as jerr:
        j_sel.get_score_fn("power_of_choice")
    with pytest.raises(ValueError) as terr:
        t_sel.get_score_fn("power_of_choice")
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the cohort gather
# ---------------------------------------------------------------------------


def reference_batch_draws(k_batch, jpop, idx, local_steps, batch):
    """The reference sampler's member positions ``[k_max, steps, batch]``
    and shifts ``[k_max, d]`` for the cohort ``idx``."""
    idx = jnp.asarray(idx)
    keys = jax.random.split(k_batch, idx.shape[0])
    sizes = jpop.member_size[idx]
    j = jax.vmap(lambda kk, s: jax.random.randint(
        kk, (local_steps, batch), 0, jnp.maximum(s, 1)))(keys, sizes)
    d = jpop.pool_x.shape[1]
    shift = jax.vmap(lambda c: jpop.feature_shift * jax.random.normal(
        jax.random.fold_in(jpop.shift_key, c), (d,)))(idx)
    return (torch.as_tensor(np.array(j)).long(),
            torch.as_tensor(np.array(shift)))


def test_sample_cohort_batches_with_reference_draws(pops):
    """Fed the reference's member positions and shifts, the port's cohort
    gather gives the reference's batches bitwise, two lanes at once."""
    jpop, tpop = pops
    cohorts = np.array([[5, 0, 127, 64, 9, 33, 2, 100],
                        [7, 5, 1, 2, 3, 4, 126, 90]])
    want, j_idx, shifts = [], [], []
    for lane, key in enumerate((11, 12)):
        k = jax.random.key(key)
        b = j_syn.sample_cohort_batches(k, jpop, jnp.asarray(cohorts[lane]),
                                        3, 8)
        want.append(b)
        j, s = reference_batch_draws(k, jpop, cohorts[lane], 3, 8)
        j_idx.append(j)
        shifts.append(s)
    got = t_syn.sample_cohort_batches(
        tpop, torch.as_tensor(cohorts), 3, 8, batch_idx=torch.stack(j_idx),
        shift=torch.stack(shifts))
    for lane in range(2):
        np.testing.assert_array_equal(got["x"][lane].numpy(),
                                      np.asarray(want[lane]["x"]))
        np.testing.assert_array_equal(got["y"][lane].numpy(),
                                      np.asarray(want[lane]["y"]))


def test_shift_is_a_stable_per_client_draw(pops):
    """The port's covariate shift: the same client gets the same shift in
    any slot, lane and round (the draw's own batch rows vary), clients
    differ, another seed differs, and the values are N(0, shift²)."""
    _, tpop = pops
    u = torch.rand(2, 4, 2, 8, generator=torch.Generator().manual_seed(0))
    cohort = torch.tensor([[3, 7, 50, 9], [9, 50, 1, 3]])
    b1 = t_syn.sample_cohort_batches(tpop, cohort, 2, 8, u=u)
    b2 = t_syn.sample_cohort_batches(tpop, cohort, 2, 8, u=torch.rand_like(u))
    s = t_syn.cohort_shift(tpop.shift_seed, cohort, tpop.n_features,
                           tpop.feature_shift)
    assert torch.equal(s[0, 0], s[1, 3]) and torch.equal(s[0, 3], s[1, 0])
    assert torch.equal(s[0, 2], s[1, 1])
    assert not torch.equal(s[0, 0], s[0, 1])
    for b in (b1, b2):       # x − the pool row is the client's shift
        rows = b["x"] - s[:, :, None, None]
        pool = tpop.pool_x
        assert all(bool(torch.isclose(pool, r, atol=1e-5).all(dim=1).any())
                   for r in rows.reshape(-1, pool.shape[1])[:16])
    other = t_syn.cohort_shift(tpop.shift_seed ^ 1, cohort, 42, 0.15)
    assert not torch.equal(other, s)
    # the hash is lowbias32 in exact 32-bit arithmetic, on tensors and ints
    def lowbias32(v):
        v ^= v >> 16
        v = (v * 0x7FEB352D) & 0xFFFFFFFF
        v ^= v >> 15
        v = (v * 0x846CA68B) & 0xFFFFFFFF
        return v ^ (v >> 16)

    xs = [0, 1, 0x5CA1E, 2**31 - 1, 2**31, 2**32 - 1]
    assert t_syn._hash32(torch.tensor(xs)).tolist() == \
        [lowbias32(v) for v in xs] == [t_syn._hash32(v) for v in xs]
    z = t_syn.cohort_shift(7, torch.arange(20_000), 42, 1.0)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    assert torch.isfinite(z).all()


# ---------------------------------------------------------------------------
# the cohort round
# ---------------------------------------------------------------------------


def reference_cohort_draws(state_rng, k_batch, jpop, idx, local_steps,
                           batch, shapes, selection):
    """One cohort round's :class:`CohortDraws` (one lane, CPU tensors)
    from the reference's keys, for the cohort ``idx`` its step picked."""
    n = jpop.member_idx.shape[0]
    d, _ = reference_draws(state_rng, n, local_steps, [(1,)], selection)
    k_dp = jax.random.split(state_rng, 5)[4]
    noise = []
    for c in np.asarray(idx):
        keys = jax.random.split(jax.random.fold_in(k_dp, int(c)), len(shapes))
        noise.append(jnp.concatenate(
            [jax.random.normal(k, s, jnp.float32).reshape(-1)
             for k, s in zip(keys, shapes)]))
    j, shift = reference_batch_draws(k_batch, jpop, idx, local_steps, batch)
    return t_rounds.CohortDraws(
        *d[:4], dp_noise=torch.as_tensor(np.array(jnp.stack(noise))),
        batch_idx=j, shift=shift)


def _lane(draws):
    return t_rounds.CohortDraws.stack([draws])


@pytest.mark.parametrize("extra", [
    {"fault_process": 1.0},                          # Markov outages
    {"selection": "random", "fault_process": 3.0},   # stragglers
    {"selection": "acfl", "adaptive_k": False},
    {"selection": "adafl", "fault_process": 2.0, "clients_per_round": 12},
], ids=["adaptive-markov", "random-straggler", "acfl", "adafl-weibull-kcap"])
def test_cohort_round_matches_reference(pops, extra):
    """5 rounds of the port's cohort step (one lane) against the
    reference's ``make_cohort_round``, fed its draws: cohort ids, ``take``,
    ``failed`` and ``slow`` equal; params, the [N] utility, K and fault
    state, the losses, norms and ``fail_frac`` to rtol 1e-5 (atol 1e-6).
    The last case asks for more clients than ``k_max``."""
    jpop, tpop = pops
    cfg = {**BASE, **extra}
    jfl, tfl = JFLConfig(**cfg), FLConfig(**cfg)
    spec = j_spec.get_model_spec("mlp", j_spec.meta_for(jpop, hidden=32))
    jparams = spec.init(jax.random.key(0))
    jstate = j_rounds.init_round_state(
        jparams, jfl, jax.random.key(1), n_clients=N,
        data_size=jpop.data_size, data_quality=jpop.data_quality)
    tstate = t_rounds.stack_states([convert.round_state_from_jax(
        to_np(jstate.params), to_np(jstate.util), to_np(jstate.kctl),
        to_np(jstate.fault), tfl, "cpu")])

    def sample_fn(k, p, idx):
        return j_syn.sample_cohort_batches(k, p, idx, jfl.local_epochs,
                                           jfl.local_batch)

    jstep = jax.jit(j_rounds.make_cohort_round(spec.loss, jfl, N, sample_fn))
    from repro_torch.models.spec import get_model_spec, meta_for
    tspec = get_model_spec("mlp", meta_for(tpop, hidden=32))
    tstep = t_rounds.make_cohort_round(tspec.loss, tfl, N, device="cpu")
    shapes, data_key = leaf_shapes(jparams), jax.random.key(5)
    for r in range(5):
        data_key, k_batch = jax.random.split(data_key)
        rng_before = jstate.rng
        jstate, jm = jstep(jstate, jpop, k_batch)
        draws = reference_cohort_draws(rng_before, k_batch, jpop,
                                       jm.cohort_idx, jfl.local_epochs,
                                       jfl.local_batch, shapes, jfl.selection)
        tstate, tm = tstep(tstate, tpop, fl_params(tfl), _lane(draws))
        for name in ("cohort_idx", "take", "failed", "slow"):
            np.testing.assert_array_equal(getattr(tm, name)[0].numpy(),
                                          np.asarray(getattr(jm, name)),
                                          err_msg=f"{name} round {r}")
        for name in ("pre_loss", "post_loss", "global_loss", "k_effective",
                     "update_norms", "fail_frac"):
            _close(getattr(tm, name)[0], getattr(jm, name),
                   f"{name} round {r}")
        _close(flatten_rows(tstate.params)[0],
               np.concatenate([np.ravel(l) for l in
                               jax.tree.leaves(jstate.params)]),
               f"params round {r}")
        for part in ("util", "kctl", "fault"):
            for name, jv in getattr(jstate, part)._asdict().items():
                _close(getattr(getattr(tstate, part), name)[0], jv,
                       f"{part}.{name} round {r}")
    assert float(jm.k_effective) <= K_MAX


def test_cohort_round_refuses_dense_kmax():
    with pytest.raises(ValueError, match="positive") as jerr:
        j_rounds.make_cohort_round(lambda p, b: 0.0, JFLConfig(n_clients=N),
                                   N, lambda *a: None)
    with pytest.raises(ValueError, match="positive") as terr:
        t_rounds.make_cohort_round(lambda p, b: 0.0, FLConfig(n_clients=N),
                                   N, device="cpu")
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the population engine
# ---------------------------------------------------------------------------


ROUNDS, EVAL_EVERY = 5, 2


def _reference_population_lane(jpop, jfl, cell, seed, tfl, rounds):
    """One lane of the reference's population runner (its keys:
    ``fold_in(key, 0..2)``, a ``split`` of the data key a round), stepped
    here to learn each round's cohort; returns the port's initial state
    and its per-round :class:`CohortDraws` for that lane."""
    key = jax.random.key(seed)
    spec = j_spec.get_model_spec(jfl.model, j_spec.meta_for(jpop, hidden=32))
    jparams = spec.init(jax.random.fold_in(key, 0))
    n = jpop.member_idx.shape[0]
    state = j_rounds.init_round_state(
        jparams, jfl, jax.random.fold_in(key, 1), n_clients=n,
        data_size=jpop.data_size, data_quality=jpop.data_quality)
    init = convert.round_state_from_jax(
        to_np(state.params), to_np(state.util), to_np(state.kctl),
        to_np(state.fault), tfl, "cpu", seed=seed)

    def sample_fn(k, p, idx):
        return j_syn.sample_cohort_batches(k, p, idx, jfl.local_epochs,
                                           jfl.local_batch)

    step = jax.jit(j_rounds.make_cohort_round(spec.loss, jfl, n, sample_fn))
    pr = j_fl_params(JFLConfig(**cell))
    data_key, draws = jax.random.fold_in(key, 2), []
    for _ in range(rounds):
        data_key, k_batch = jax.random.split(data_key)
        rng_before = state.rng
        state, m = step(state, jpop, k_batch, pr)
        draws.append(reference_cohort_draws(
            rng_before, k_batch, jpop, m.cohort_idx, jfl.local_epochs,
            jfl.local_batch, leaf_shapes(jparams), jfl.selection))
    return init, draws


@pytest.mark.parametrize("n", [64, 256])
def test_run_fl_population_matches_jax_lane_by_lane(n):
    """Two cells (iid at ε 200, Markov at ε 1000) × seeds 0 and 2 against
    the JAX ``run_fl_population``, fed the reference's draws: every
    history key of every lane to rtol 1e-5 (atol 1e-6), ε and the
    simulated time equal to rtol 1e-5; one runner for the grid."""
    kw = dict(n_clients=n, pool_samples=POOL, members_per_client=MEMBERS)
    jpop = j_syn.make_population(1, **kw)
    tpop = t_syn.make_population(1, **kw)
    base = {**BASE, "n_clients": n}
    cells = [{**base, "dp_epsilon": 200.0},
             {**base, "dp_epsilon": 1000.0, "fault_process": 1.0,
              "failure_prob": 0.3}]
    seeds = (0, 2)
    jfl, tfl = JFLConfig(**base), FLConfig(**base)
    jres = j_fl_driver.run_fl_population(
        jpop, jfl, [JFLConfig(**c) for c in cells], seeds=seeds,
        rounds=ROUNDS, eval_every=EVAL_EVERY, hidden=32, shard=False)
    lanes = [_reference_population_lane(jpop, jfl, c, s, tfl, ROUNDS)
             for c in cells for s in seeds]
    misses = t_fl_driver.RUNNER_STATS["misses"]
    tres = t_fl_driver.run_fl_population(
        tpop, tfl, [FLConfig(**c) for c in cells], seeds=seeds,
        rounds=ROUNDS, eval_every=EVAL_EVERY, hidden=32, device="cpu",
        init_states=[i for i, _ in lanes], draws=[d for _, d in lanes])
    assert t_fl_driver.RUNNER_STATS["misses"] == misses + 1
    for ci, (jrow, trow) in enumerate(zip(jres, tres)):
        for jr, tr in zip(jrow, trow):
            what = f"cell {ci} seed {tr.seed}"
            assert tr.history.keys() == jr.history.keys(), what
            assert tr.history["round"] == [2, 4, 5]
            for name in jr.history:
                _close(tr.history[name], jr.history[name], f"{name} {what}")
            assert tr.eps_spent == jr.eps_spent, what
            _close(tr.sim_time_s, jr.sim_time_s, f"sim_time {what}", atol=0)


def test_population_runner_once_per_shape(pops):
    """One runner build per (population shape, lanes, sel_chunks), hits
    after; chunked selection (by ``sel_chunks`` or a memory budget) leaves
    every history column bitwise; own draws give finite histories."""
    _, tpop = pops
    host = t_syn.make_population(0, n_clients=N, pool_samples=POOL,
                                 members_per_client=MEMBERS)
    fl = FLConfig(**BASE)
    kw = dict(seeds=(0, 1), rounds=3, eval_every=3, hidden=32,
              device="cpu")
    stats = dict(t_fl_driver.RUNNER_STATS)
    first = t_fl_driver.run_fl_population(host, fl, **kw)
    again = t_fl_driver.run_fl_population(host, fl, **kw)
    assert t_fl_driver.RUNNER_STATS["misses"] == stats["misses"] + 1
    assert t_fl_driver.RUNNER_STATS["hits"] == stats["hits"] + 1
    assert all(a.history == b.history for a, b in zip(first[0], again[0]))
    for r in first[0]:
        assert all(math.isfinite(v) for k in ("loss", "acc", "auc", "fail",
                                              "cum_time")
                   for v in r.history[k])
    chunked = t_fl_driver.run_fl_population(host, fl, sel_chunks=4, **kw)
    # a budget 600 B above the resident state leaves room for a quarter of
    # the selection transients (4·N f32): the policy picks 4 chunks
    model = t_fl_driver.get_model_spec(
        "mlp", t_fl_driver.meta_for(host, hidden=32)).param_bytes()
    budget = t_scale.population_resident_bytes(N, MEMBERS, 2, model) + 600
    assert t_scale.auto_chunks(N, budget, MEMBERS, 2, model) == 4
    budgeted = t_fl_driver.run_fl_population(host, fl,
                                             memory_budget_bytes=budget, **kw)
    # sel_chunks=4 and the budget's 4 chunks share a runner
    assert t_fl_driver.RUNNER_STATS["misses"] == stats["misses"] + 2
    for other in (chunked, budgeted):
        assert all(a.history == b.history for a, b in zip(first[0],
                                                          other[0]))
    bigger = t_syn.make_population(0, n_clients=2 * N, pool_samples=POOL,
                                   members_per_client=MEMBERS)
    t_fl_driver.run_fl_population(bigger, FLConfig(**{**BASE,
                                                      "n_clients": 2 * N}),
                                  **kw)
    assert t_fl_driver.RUNNER_STATS["misses"] == stats["misses"] + 3


def test_population_scheduled_privacy():
    """Scheduled budgets on the population engine: every lane's in-loop ε
    within its budget, σ from the schedule, and a budget no release fits
    leaves the lane's params at their initial values."""
    host = t_syn.make_population(0, n_clients=N, pool_samples=POOL,
                                 members_per_client=MEMBERS)
    fl = FLConfig(**{**BASE, "dp_scheduled": True})
    res = t_fl_driver.run_fl_population(
        host, fl, [{"dp_budget": b} for b in (0.01, 3000.0)], seeds=(0,),
        rounds=4, eval_every=2, hidden=32, device="cpu")
    dead, live = res[0][0], res[1][0]
    assert {"eps", "sigma", "live"} <= live.history.keys()
    assert dead.eps_spent == 0.0 and dead.history["live"] == [0.0, 0.0]
    assert 0.0 < live.eps_spent <= 3000.0
    assert live.history["live"] == [1.0, 1.0]


@pytest.mark.parametrize("case", ["fedl2p", "k_max", "power_of_choice",
                                  "async_plan", "mesh"])
def test_run_fl_population_refusals(pops, case):
    """The reference's refusals with its messages: fedl2p, the dense
    ``k_max = 0``, a strategy with no score function and a plan the
    registry marks ``cohort_capable=False``; and a mesh layout of more
    ranks than the process group has (here none: one rank)."""
    jpop, tpop = pops
    host = t_syn.make_population(0, n_clients=N, pool_samples=POOL,
                                 members_per_client=MEMBERS)
    kw, cfg = dict(rounds=1, eval_every=1), dict(BASE)
    if case == "mesh":
        with pytest.raises(ValueError, match="asks for 4 ranks"):
            t_fl_driver.run_fl_population(host, FLConfig(**cfg),
                                          mesh_shape=(2, 2), device="cpu",
                                          **kw)
        return
    method = case if case in ("fedl2p", "power_of_choice") else "proposed"
    if case == "k_max":
        cfg["k_max"] = 0
    grid = ([{"plan": "buffered_async", "async_buffer": 2.0}]
            if case == "async_plan" else None)
    with pytest.raises(ValueError) as jerr:
        j_fl_driver.run_fl_population(jpop, JFLConfig(**cfg), grid,
                                      method=method, shard=False, **kw)
    with pytest.raises(ValueError) as terr:
        t_fl_driver.run_fl_population(host, FLConfig(**cfg), grid,
                                      method=method, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------


def test_scale_field_counts_pinned_to_port_state():
    assert t_scale.UTILITY_STATE_FIELDS == len(t_sel.UtilityState._fields)
    assert t_scale.FAULT_STATE_FIELDS == len(t_fault.FaultState._fields)
    assert t_scale.CARRY_FIELDS == j_scale.CARRY_FIELDS
    assert t_scale.SELECTION_BUFFERS == j_scale.SELECTION_BUFFERS


def test_scale_bytes_match_real_tensors(pops):
    """The formulas against the port's tensors: the device population's
    per-client arrays, one lane's carries, and a cohort's batches (the
    labels counted as i32, as the formula does; the port holds int64)."""
    _, tpop = pops
    data = sum(getattr(tpop, k).nbytes for k in ("member_idx", "member_size",
                                                "data_size", "data_quality"))
    assert t_scale.population_data_bytes(N, MEMBERS) == data
    gen = torch.Generator().manual_seed(0)
    state = t_rounds.init_round_state({"w": torch.zeros(3)}, FLConfig(**BASE),
                                      gen, n_clients=N)
    carry = sum(t.nbytes for t in (*state.util, *state.fault))
    assert t_scale.population_carry_bytes(N) == carry
    cohort = torch.arange(K_MAX)[None]
    b = t_syn.sample_cohort_batches(tpop, cohort, 2, 16,
                                    u=torch.rand(1, K_MAX, 2, 16))
    assert t_scale.cohort_batch_bytes(K_MAX, 2, 16, tpop.n_features) == \
        b["x"].nbytes + 4 * b["y"].numel()
    assert t_scale.selection_transient_bytes(N, 4) == 4 * (N // 4) * 4


@pytest.mark.parametrize("n,budget,lanes,model", [
    (1_000, 1 << 20, 1, 0), (100_000, 256 << 20, 2, 40_000),
    (1_000_000, 200 << 20, 2, 0), (10_000, 10 << 20, 4, 1 << 16)])
def test_scale_formulas_equal_reference(n, budget, lanes, model):
    for fn, args in ((lambda m: m.population_data_bytes(n, 32), ()),
                     (lambda m: m.population_carry_bytes(n), ()),
                     (lambda m: m.selection_transient_bytes(n, 3), ()),
                     (lambda m: m.population_resident_bytes(n, 32, lanes,
                                                            model), ()),
                     (lambda m: m.auto_chunks(n, budget, 32, lanes,
                                              model_bytes=model), ())):
        try:
            want = fn(j_scale)
        except ValueError as e:
            with pytest.raises(ValueError, match="exceeds"):
                fn(t_scale)
            assert "exceeds" in str(e)
            continue
        assert fn(t_scale) == want
    for plan in ("client_parallel", "buffered_async", "hierarchical"):
        assert t_scale.plan_transient_buffers(plan) == \
            j_scale.plan_transient_buffers(plan)
    assert t_scale.model_needs_sharding(model) == \
        j_scale.model_needs_sharding(model)
