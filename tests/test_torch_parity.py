"""Round-level parity of the PyTorch port against the JAX reference.

Torch cannot reproduce JAX's threefry bits, so :func:`reference_draws`
rebuilds one round's variates from the reference's own keys (the 5-way
split of ``state.rng`` in ``make_parallel_round``, ``fold_in(k_fail, 1..7)``
in ``fault_step``, ``split(k_dp, n)`` then a per-leaf split in the DP step)
and the port's round step is fed them.  Both sides then run on the CPU in
f32 and are compared round by round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.core import rounds as j_rounds
from repro.data.synthetic import make_federated as j_make_federated
from repro.data.synthetic import round_batches as j_round_batches
from repro.models import mlp as j_mlp
from repro.train import fl_driver as j_fl_driver

from repro_torch import convert
from repro_torch.configs.base import FLConfig
from repro_torch.core import rounds as t_rounds
from repro_torch.core.selection import NOISE_KIND
from repro_torch.models import mlp as t_mlp
from repro_torch.train import fl_driver as t_fl_driver
from repro_torch.tree import flatten_rows

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
# the reference's quickstart config (examples/quickstart.py part 2)
QUICK = dict(n_clients=10, clients_per_round=4, local_epochs=3,
             local_batch=32, dp_epsilon=50.0, dp_clip=5.0)


def leaf_shapes(params):
    """Leaf shapes of a JAX params tree, in ``jax.tree`` (sorted-key) order."""
    return [tuple(l.shape) for l in jax.tree.leaves(params)]


def reference_draws(state_rng, n, local_steps, leaf_shapes,
                    selection="adaptive_utility"):
    """One round's :class:`RoundDraws` (as CPU tensors) from the reference's
    keys, and the state key the reference carries to the next round."""
    rng, k_avail, k_sel, k_fail, k_dp = jax.random.split(state_rng, 5)
    avail_u = jax.random.uniform(k_avail, (n,), jnp.float32)
    if NOISE_KIND[selection] == "gumbel":
        sel_noise = jax.random.gumbel(k_sel, (n,))
    else:
        sel_noise = jax.random.uniform(k_sel, (n,))
    fk = lambda i: jax.random.fold_in(k_fail, i)  # noqa: E731
    fault_u = jnp.stack([jax.random.uniform(fk(i), (n,)) for i in (1, 3, 5, 7)])
    fault_steps = jnp.stack([jax.random.randint(fk(i), (n,), 0, local_steps)
                             for i in (2, 4, 6)])
    noise = []
    for key in jax.random.split(k_dp, n):
        keys = jax.random.split(key, len(leaf_shapes))
        noise.append(jnp.concatenate(
            [jax.random.normal(k, s, jnp.float32).reshape(-1)
             for k, s in zip(keys, leaf_shapes)]))
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    draws = t_rounds.RoundDraws(
        avail_u=t(avail_u), sel_noise=t(sel_noise), fault_u=t(fault_u),
        fault_steps=t(fault_steps).long(), dp_noise=t(jnp.stack(noise)))
    return draws, rng


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def test_reference_draws_reproduce_reference_availability():
    """The helper's uniforms reproduce the reference's Bernoulli draws."""
    key = jax.random.key(3)
    draws, _ = reference_draws(key, 16, 3, [(2,)])
    _, k_avail, _, k_fail, _ = jax.random.split(key, 5)
    avail = jax.random.bernoulli(k_avail, 0.95, (16,))
    np.testing.assert_array_equal(draws.avail_u.numpy() < np.float32(0.95),
                                  np.asarray(avail))
    fails = jax.random.bernoulli(jax.random.fold_in(k_fail, 1), 0.3, (16,))
    np.testing.assert_array_equal(draws.fault_u[0].numpy() < np.float32(0.3),
                                  np.asarray(fails))


def _assert_close(a, b, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("fault_process,selection,dataset,extra", [
    pytest.param(0.0, "adaptive_utility", "unsw", {},   # the quickstart's iid
                 id="0.0-adaptive_utility"),
    pytest.param(2.0, "adaptive_utility", "unsw", {},   # Weibull (lgamma, pow)
                 id="2.0-adaptive_utility"),
    pytest.param(1.0, "acfl", "unsw", {},               # Markov, fixed-K ACFL
                 id="1.0-acfl"),
    pytest.param(0.0, "random", "unsw", {}, id="0.0-random"),
    # power-of-choice trains the highest-loss clients, so at ε = 50 its
    # losses pass 30 by round 5, where one f32 ulp (1.9e-6) of a loss
    # exceeds atol in perf_ema (an EMA of pre − post loss); at ε = 500 they
    # stay near 1
    pytest.param(0.0, "power_of_choice", "unsw", {"dp_epsilon": 500.0},
                 id="0.0-power_of_choice"),
    pytest.param(0.0, "adafl", "unsw", {}, id="0.0-adafl"),
    pytest.param(0.0, "adaptive_utility", "road", {},
                 id="0.0-adaptive_utility-road"),
    pytest.param(3.0, "adaptive_utility", "unsw", {},   # stragglers: alive
                 id="3.0-adaptive_utility"),
])
def test_parallel_round_matches_reference(fault_process, selection, dataset,
                                          extra):
    """5 rounds of make_parallel_round (the lane step at L = 1): sel_mask
    bitwise per round; params, utility state, K controller and metrics to
    rtol 1e-5 (atol 1e-6).  Every selection strategy, both datasets and
    every failure process.

    The model is far from converged at these settings (losses reach ~1e2),
    so a server optimizer that amplifies float-order differences (FedAdam's
    g/(|g|+1e-3)) is held to the reference in the optimizer test of
    test_torch_selection_fault.py, not over rounds."""
    fed = j_make_federated(0, dataset, n_samples=2_000, n_clients=10)
    # failure rate raised from 0.05 so that 10 clients x 5 rounds see failures
    cfg = dict(QUICK, fault_process=fault_process, selection=selection,
               failure_prob=0.2, **extra)
    jfl, tfl = JFLConfig(**cfg), FLConfig(**cfg)
    sizes = fed.data_sizes()
    jparams = j_mlp.init_mlp(jax.random.key(0), fed.n_features, 64, 2)
    jstate = j_rounds.init_round_state(
        jparams, jfl, jax.random.key(1), n_clients=10,
        data_size=jnp.asarray(sizes / sizes.mean()),
        data_quality=jnp.asarray(fed.label_entropy()))
    tstate = convert.round_state_from_jax(
        to_np(jstate.params), to_np(jstate.util), to_np(jstate.kctl),
        to_np(jstate.fault), tfl, "cpu")
    jstep = jax.jit(j_rounds.make_parallel_round(j_mlp.mlp_loss, jfl, 10))
    tstep = t_rounds.make_parallel_round(t_mlp.mlp_loss, tfl, 10,
                                         device="cpu")
    shapes = leaf_shapes(jparams)
    rng = np.random.default_rng(0)
    for r in range(5):
        b = j_round_batches(rng, fed, jfl.local_epochs, jfl.local_batch)
        draws, _ = reference_draws(jstate.rng, 10, jfl.local_epochs, shapes,
                                   selection)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, {"x": torch.as_tensor(b["x"]),
                                    "y": torch.as_tensor(b["y"]).long()},
                           draws=draws)
        np.testing.assert_array_equal(tm.sel_mask.numpy(),
                                      np.asarray(jm.sel_mask),
                                      err_msg=f"sel_mask round {r}")
        for name in ("avail", "failed", "slow"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)),
                                          err_msg=f"{name} round {r}")
        for name in ("pre_loss", "post_loss", "global_loss", "k_effective",
                     "update_norms"):
            _assert_close(getattr(tm, name), getattr(jm, name),
                          f"{name} round {r}")
        _assert_close(flatten_rows(tstate.params, 0),
                      np.concatenate([np.ravel(l) for l in
                                      jax.tree.leaves(jstate.params)]),
                      f"params round {r}")
        for name, jv in jstate.util._asdict().items():
            _assert_close(getattr(tstate.util, name), jv, f"util.{name} {r}")
        for name, jv in jstate.kctl._asdict().items():
            _assert_close(getattr(tstate.kctl, name), jv, f"kctl.{name} {r}")
        for name, jv in jstate.fault._asdict().items():
            _assert_close(getattr(tstate.fault, name), jv, f"fault.{name} {r}")


def test_run_fl_legacy_matches_reference():
    """The port's run_fl_legacy against the reference's for 5 rounds with
    the reference's draws fed in: history to rtol 1e-5, eps_spent to 1e-12."""
    fed = j_make_federated(0, "unsw", n_samples=2_000, n_clients=10)
    jfl, tfl = JFLConfig(**QUICK), FLConfig(**QUICK)
    rounds, seed = 5, 0
    jres = j_fl_driver.run_fl_legacy(fed, jfl, "proposed", seed=seed,
                                  rounds=rounds, eval_every=1)

    # the reference driver's own initial state (fl_driver.run_fl_legacy)
    key = jax.random.key(seed)
    jparams = j_mlp.init_mlp(jax.random.fold_in(key, 0), fed.n_features, 64, 2)
    sizes = fed.data_sizes()
    jstate = j_rounds.init_round_state(
        jparams, jfl, jax.random.fold_in(key, 1), n_clients=fed.n_clients,
        data_size=jnp.asarray(sizes / sizes.mean()),
        data_quality=jnp.asarray(fed.label_entropy()))
    init = convert.round_state_from_jax(
        to_np(jstate.params), to_np(jstate.util), to_np(jstate.kctl),
        to_np(jstate.fault), tfl, "cpu")
    draws, state_rng = [], jstate.rng
    for _ in range(rounds):
        d, state_rng = reference_draws(state_rng, fed.n_clients,
                                       jfl.local_epochs, leaf_shapes(jparams))
        draws.append(d)

    tres = t_fl_driver.run_fl_legacy(fed, tfl, "proposed", seed=seed,
                                  rounds=rounds, eval_every=1, device="cpu",
                                  init_state=init, draws=draws)
    assert tres.history.keys() == jres.history.keys()
    for name in jres.history:
        _assert_close(tres.history[name], jres.history[name], name)
    assert abs(tres.eps_spent - jres.eps_spent) <= 1e-12
    for target in (0.5, 0.8, 0.99):
        assert tres.time_to_acc(target) == pytest.approx(
            jres.time_to_acc(target), rel=1e-5)
    assert tres.rounds == jres.rounds
