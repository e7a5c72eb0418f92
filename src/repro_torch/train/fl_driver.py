"""End-to-end FL driver for the anomaly-detection use case (paper §V): the
port's copy of ``repro/train/fl_driver.py``'s engines and what they need
(``METHODS``, ``fl_for_method``, ``RunResult``, ``simulate_round_time``,
``realized_cohort_fraction``, the FedL2P personalisation pass and
``export_personalized``, the deprecated ``spent_epsilon``).  The engines'
host phases are traced by ``repro_torch.obs`` (``sweep.*`` and
``population.*`` spans, ``compile.runner_miss`` events and ``runner.build``
spans; ``RUNNER_STATS`` is a registry view).

Both run the full Algorithm-1 loop on the synthetic UNSW-NB15 / ROAD
federations and report accuracy, AUC-ROC, simulated training time and the
accounted ε:

* :func:`run_fl_sweep` — the sweep engine: every seed×config lane of a
  grid advances together, round by round on the device, through one lane
  round step (``core/rounds.py`` ``make_lane_round``); batches are sampled
  on the device from each lane's ``torch.Generator``, test metrics are
  computed on the device every ``eval_every`` rounds, and nothing is read
  back to the host until the loop ends.  :func:`run_fl_batch` (one cell)
  and :func:`run_fl` (one cell, one seed) are its front doors.
* :func:`run_fl_population` — the population engine: the same lanes over
  a 10^3–10^6-client :class:`~repro_torch.data.synthetic.Population`,
  each round training only the on-device top-k cohort (the
  ``client_cohort`` plan, ``core/rounds.py`` ``make_cohort_round``).
* :func:`run_fl_legacy` — the per-round driver, kept as the oracle:
  batches are sampled on the host with the reference's NumPy sampler, so
  one seed feeds both packages the same batches, and eval is pulled to the
  host.

The sweep engine runs the whole ``client_parallel`` family: sync,
``buffered_async`` and ``hierarchical`` cells may share one sweep, their
plan a runtime lane.  Scheduled privacy (``dp_scheduled``, the sweep and
population engines) carries an in-loop RDP accountant and a noise
scheduler per lane; a release that would overspend a lane's budget is
withheld (:func:`scheduled_round`).  ``client_serial`` is refused, as the
reference's registry refuses it on these engines.

Methods:
  proposed        — adaptive utility selection + DP + fault tolerance (ours)
  proposed_noft   — ours without fault tolerance      (Table II ablation)
  acfl            — ACFL-style uncertainty (active) selection
  fedl2p          — FedAvg + per-client personalisation fine-tuning
  random          — plain FedAvg with random selection
  adafl           — AdaFL-style history-weighted selection
  power_of_choice — power-of-choice selection
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import (FLConfig, FLParams, as_f32, fl_params,
                                     fl_static, params_lanes)
from repro_torch.core import fault as fault_lib
from repro_torch.core import plans as plans_lib
from repro_torch.core import rounds as rounds_lib
from repro_torch.core import scale as scale_lib
from repro_torch.data.synthetic import (FederatedData, Population,
                                        StackedFederation, draw_batch_indices,
                                        round_batches, sample_round_batches,
                                        stack_federation)
from repro_torch.device import resolve_device
from repro_torch.models.mlp import auc_roc, auc_roc_torch
from repro_torch.models.spec import (DataMeta, ModelSpec, get_model_spec,
                                     meta_for)
from repro_torch.obs import stats as obs_stats
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import phase
from repro_torch.privacy import accountant as acct_lib
from repro_torch.privacy import schedule as sched_lib
from repro_torch.privacy.accountant import accounted_epsilon
from repro_torch.tree import tree_leaves, tree_map

METHODS = ("proposed", "proposed_noft", "acfl", "fedl2p", "random", "adafl",
           "power_of_choice")


def fl_for_method(base: FLConfig, method: str) -> FLConfig:
    """Method-specific FLConfig tweaks (selection strategy etc.)."""
    if method == "proposed":
        return dataclasses.replace(base, selection="adaptive_utility",
                                   fault_tolerance=True)
    if method == "proposed_noft":
        return dataclasses.replace(base, selection="adaptive_utility",
                                   fault_tolerance=False)
    if method == "acfl":
        return dataclasses.replace(base, selection="acfl", adaptive_k=False)
    if method == "fedl2p":
        return dataclasses.replace(base, selection="random", adaptive_k=False)
    if method == "random":
        return dataclasses.replace(base, selection="random", adaptive_k=False)
    if method == "adafl":
        return dataclasses.replace(base, selection="adafl")
    if method == "power_of_choice":
        return dataclasses.replace(base, selection="power_of_choice",
                                   adaptive_k=False)
    raise ValueError(method)


@dataclass
class RunResult:
    method: str
    dataset: str
    seed: int
    accuracy: float
    auc: float
    sim_time_s: float
    wall_time_s: float
    rounds: int
    eps_spent: float
    history: Dict[str, List[float]] = field(default_factory=dict)
    params: Optional[object] = field(default=None, repr=False)

    def time_to_acc(self, target: float) -> float:
        """Simulated seconds until test accuracy first reaches ``target``;
        inf if never."""
        for t, a in zip(self.history.get("cum_time", []),
                        self.history.get("acc", [])):
            if a >= target:
                return t
        return float("inf")


def personalized_client_params(params, fed: FederatedData, spec: ModelSpec,
                               steps: int = 3, lr: float = 0.05,
                               batch: int = 64, seed: int = 0) -> List:
    """FedL2P-lite fine-tuning: a few local SGD steps per client from the
    global ``params`` (on their device), with the reference's NumPy batch
    draws in client order.  One personalised tree per client."""
    rng = np.random.default_rng(seed)
    grad_fn = torch.func.grad(spec.loss)
    device = tree_leaves(params)[0].device
    out = []
    for ci in range(fed.n_clients):
        p = params
        for _ in range(steps):
            idx = rng.integers(0, len(fed.x[ci]), batch)
            b = {"x": torch.as_tensor(fed.x[ci][idx], device=device),
                 "y": torch.as_tensor(fed.y[ci][idx], device=device).long()}
            g = grad_fn(p, b)
            p = tree_map(lambda a, gg: a - lr * gg, p, g)
        out.append(p)
    return out


def export_personalized(params, fed: FederatedData, spec: ModelSpec,
                        steps: int = 3, lr: float = 0.05,
                        batch: int = 64, seed: int = 0):
    """Personalised per-client parameters STACKED along a leading client
    axis (host NumPy): the ``heads`` tree ``ServeEngine`` indexes with
    ``client=i`` and ``save_serving_checkpoint`` persists."""
    per_client = personalized_client_params(params, fed, spec, steps=steps,
                                            lr=lr, batch=batch, seed=seed)
    return tree_map(lambda *leaves: np.stack([l.detach().cpu().numpy()
                                              for l in leaves]), *per_client)


def _personalize(params, fed: FederatedData, spec: ModelSpec,
                 steps: int = 3, lr: float = 0.05,
                 batch: int = 64, seed: int = 0):
    """FedL2P-lite personalisation: mean personalised test accuracy and the
    AUC of the mean personalised score."""
    per_client = personalized_client_params(params, fed, spec, steps=steps,
                                            lr=lr, batch=batch, seed=seed)
    device = tree_leaves(params)[0].device
    tx = torch.as_tensor(fed.test_x, device=device)
    ty = torch.as_tensor(fed.test_y, device=device)
    accs, scores_all = [], []
    for p in per_client:
        accs.append(float(spec.accuracy(p, tx, ty)))
        scores_all.append(spec.predict_proba(p, tx)[:, 1].cpu().numpy())
    acc = float(np.mean(accs))
    auc = auc_roc(np.mean(scores_all, axis=0), fed.test_y)
    return acc, auc


def simulate_round_time(fl: FLConfig, util_state, sel_mask, failed,
                        base_step_time: float = 0.02,
                        comm_time: float = 0.35,
                        ckpt_write: float = 0.08,
                        param_kb: float = 64.0,
                        params: Optional[FLParams] = None,
                        slow=None) -> torch.Tensor:
    """The paper-faithful wall-time model for one round: the slowest
    selected client's local compute (``steps × base_step_time /
    compute_i``, stretched by straggler ``slow`` factors) + communication +
    DP pass + checkpoint writes + recovery.  ``buffered_async`` (plan code
    1) waits for the K-th arrival instead of the slowest; ``hierarchical``
    (code 2) pays two edge hops of ``hier_comm_frac`` of the WAN hop.

    Clients are the last axis (``[n]`` for one run, ``[L, n]`` for a
    sweep's lanes, each with its own ``params`` lane); the plan variants are
    selected by ``torch.where`` on the plan code, so nothing here reads a
    value back to the host."""
    pr = fl_params(fl) if params is None else params
    sel = sel_mask > 0
    zero = torch.zeros_like(sel_mask)
    steps = fl.local_epochs
    compute = steps * base_step_time / torch.clamp(util_state.compute, min=0.1)
    if slow is not None:
        compute = compute * slow
    slowest = torch.amax(torch.where(sel, compute, zero), dim=-1)
    comm_full = comm_time * (1.0 + param_kb / 1024.0)

    t = slowest + comm_full
    if fl.dp_enabled:
        t = t + 0.01  # clip+noise pass
    n_failed_sel = torch.sum(torch.where(sel, failed, zero), dim=-1)
    if fl.fault_tolerance:
        t = t + ckpt_write * max(1, steps // 2)
        t = t + n_failed_sel * fault_lib.recovery_overhead(pr.recovery_time)
    else:
        # failed clients redo the whole round next time: amortised penalty
        t = t + n_failed_sel * slowest

    # buffered_async (code 1): the K-th smallest selected arrival, capped at
    # the slowest; hierarchical (code 2): two edge hops for the WAN hop
    arrivals = torch.sort(torch.where(sel, compute, torch.full_like(
        compute, math.inf)), dim=-1).values
    k_idx = torch.clamp(as_f32(pr.async_buffer, t), 1.0,
                        float(sel_mask.shape[-1])).long() - 1
    kth = torch.gather(arrivals, -1, k_idx.expand(t.shape)[..., None])[..., 0]
    t_async = torch.minimum(kth, slowest) + comm_full
    if fl.dp_enabled:
        t_async = t_async + 0.01
    t_hier = t - comm_full + 2.0 * pr.hier_comm_frac * comm_full
    code = as_f32(pr.plan_code, t)
    t = torch.where(code == 1.0, t_async, torch.where(code == 2.0, t_hier, t))
    return torch.where(torch.any(sel, dim=-1), t,
                       torch.full_like(t, comm_time))


def spent_epsilon(fl: FLConfig, rounds: int) -> float:
    """Deprecated alias of :func:`repro_torch.privacy.accountant.
    accounted_epsilon`, kept as the reference keeps it: fixed-σ runs report
    the closed-form composition, scheduled runs the in-loop accountant's
    trace (``RunResult.history['eps']``)."""
    warnings.warn(
        "fl_driver.spent_epsilon is deprecated; use "
        "repro_torch.privacy.accountant.accounted_epsilon (fixed-σ) or the "
        "in-loop accountant trace (dp_scheduled)", DeprecationWarning,
        stacklevel=2)
    return accounted_epsilon(fl, rounds)


def realized_cohort_fraction(k_eff, n_clients: int):
    """Sampling fraction the RDP accountant must compose at: ``_topk_mask``
    selects ``ceil(k_eff)`` clients for a fractional K."""
    return torch.clamp(torch.ceil(torch.as_tensor(k_eff)) / n_clients,
                       0.0, 1.0)


def run_fl_legacy(
    fed: FederatedData,
    fl: FLConfig,
    method: str = "proposed",
    seed: int = 0,
    rounds: Optional[int] = None,
    eval_every: int = 10,
    dataset: str = "unsw",
    hidden: int = 64,
    *,
    device=None,
    init_state: Optional[rounds_lib.RoundState] = None,
    draws: Optional[Sequence[rounds_lib.RoundDraws]] = None,
    on_round: Optional[Callable] = None,
) -> RunResult:
    """The per-round driver: host-side NumPy batch sampling, one round step
    per iteration, eval pulled to the host every ``eval_every`` rounds.

    Runs on ``device`` (``cuda`` unless ``"cpu"`` is asked; without a card
    it raises).  With no ``init_state`` the model and utility state are
    drawn from a ``torch.Generator`` seeded with ``seed`` on the device;
    ``init_state`` (e.g. from ``convert.py``) starts from a given state.
    ``draws`` gives each round's :class:`~repro_torch.core.rounds.RoundDraws`
    instead of drawing them.  ``on_round(r, state, metrics)`` is called
    after each round step."""
    device = resolve_device(device)
    fl = fl_for_method(fl, method)
    if fl.dp_enabled and fl.dp_scheduled:
        raise ValueError(
            "run_fl_legacy does not support dp_scheduled configs")
    legacy_plan = plans_lib.get_plan(fl.plan)
    if legacy_plan.family != "client_parallel" or legacy_plan.code != 0.0:
        raise ValueError(
            f"run_fl_legacy implements only the synchronous client_parallel "
            f"plan; plan {fl.plan!r} needs the compiled engine "
            "(run_fl / run_fl_sweep)")
    rounds = rounds or fl.rounds
    rng = np.random.default_rng(seed)

    spec = get_model_spec(fl.model, meta_for(fed, hidden=hidden))
    if init_state is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = spec.init(gen)
        sizes = fed.data_sizes()
        state = rounds_lib.init_round_state(
            params, fl, gen, n_clients=fed.n_clients,
            data_size=torch.as_tensor(sizes / sizes.mean(), device=device),
            data_quality=torch.as_tensor(fed.label_entropy(), device=device),
        )
    else:
        state = init_state
    round_step = rounds_lib.make_parallel_round(spec.loss, fl, fed.n_clients,
                                                device=device,
                                                plan_codes=(0.0,))

    tx = torch.as_tensor(fed.test_x, device=device)
    ty = torch.as_tensor(fed.test_y, device=device)
    history = {"round": [], "loss": [], "acc": [], "auc": [], "k": [],
               "fail": [], "cum_time": []}
    sim_time = 0.0
    t0 = time.time()
    for r in range(rounds):
        with phase("fl.batches"):
            b = round_batches(rng, fed, fl.local_epochs, fl.local_batch)
            batches = {"x": torch.as_tensor(b["x"], device=device),
                       "y": torch.as_tensor(b["y"], device=device).long()}
        with phase("fl.round_step"):
            state, metrics = round_step(
                state, batches, draws=None if draws is None else draws[r])
        if on_round is not None:
            on_round(r, state, metrics)
        with phase("fl.sim_time"):
            sim_time += float(simulate_round_time(
                fl, state.util, metrics.sel_mask, metrics.failed,
                slow=metrics.slow))
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            with phase("fl.eval"):
                acc = float(spec.accuracy(state.params, tx, ty))
                proba = spec.predict_proba(state.params, tx)[:, 1]
                auc = auc_roc(proba.cpu().numpy(), fed.test_y)
            history["round"].append(r + 1)
            history["loss"].append(float(metrics.global_loss))
            history["acc"].append(acc)
            history["auc"].append(auc)
            history["k"].append(float(metrics.k_effective))
            history["fail"].append(float(torch.mean(metrics.failed)))
            history["cum_time"].append(sim_time)

    acc, auc = history["acc"][-1], history["auc"][-1]
    if method == "fedl2p":
        # personalisation pass (the point of FedL2P) + its simulated cost
        acc, auc = _personalize(state.params, fed, spec, seed=seed)
        sim_time *= 1.2
    eps = accounted_epsilon(fl, rounds)

    return RunResult(
        method=method, dataset=dataset, seed=seed,
        accuracy=acc, auc=auc,
        sim_time_s=sim_time, wall_time_s=time.time() - t0,
        rounds=rounds, eps_spent=eps, history=history,
        params=state.params,
    )


# ---------------------------------------------------------------------------
# Sweep engine: every seed×config lane of a grid, round by round on the card
# ---------------------------------------------------------------------------


def _eval_rounds(rounds: int, eval_every: int) -> List[int]:
    """0-based round indices the legacy loop evaluated at."""
    return [r for r in range(rounds)
            if (r + 1) % eval_every == 0 or r == rounds - 1]


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """On a card, make any host synchronisation inside the block raise
    (``torch.cuda.set_sync_debug_mode("error")``): the round loop reads
    nothing back until the readback."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _eval_lanes(spec: ModelSpec, params, test_x, test_y):
    """Test accuracy and rank AUC of every lane ``[L]``: one forward a lane
    (the sequence detectors' kernels cannot run under ``vmap``), then the
    metrics over the stacked ``[L, n_test]`` logits."""
    lanes = tree_leaves(params)[0].shape[0]
    logits = torch.stack([spec.logits(tree_map(lambda a: a[i], params),
                                      test_x) for i in range(lanes)])
    acc = torch.mean((torch.argmax(logits, dim=-1) == test_y).float(), dim=-1)
    proba = torch.softmax(logits, dim=-1)[..., 1]
    return acc, auc_roc_torch(proba, test_y)


class PrivacyState(NamedTuple):
    """A scheduled-budget sweep's privacy state, one row a lane: the
    in-loop accountant and the noise scheduler."""

    acct: acct_lib.AccountantState
    sched: sched_lib.SchedulerState


def init_privacy(fl: FLConfig, pr: FLParams, grid: acct_lib.OrderGrid,
                 n_clients: int, rounds: int,
                 k_cap: Optional[int] = None) -> PrivacyState:
    """An empty accountant, and each lane's scheduler calibrated to its
    ``dp_budget`` (``pr``'s fields are ``[L]`` lanes) over ``rounds`` at
    the nominal cohort fraction (``clients_per_round``, at most ``k_cap``
    clients: the population engine's cohort size)."""
    k_nom = fl.clients_per_round if k_cap is None else min(
        fl.clients_per_round, k_cap)
    q_nom = min(k_nom / n_clients, 1.0)
    return PrivacyState(
        acct_lib.init_accountant_state(pr.dp_budget.shape[0],
                                       grid.orders.device),
        sched_lib.init_scheduler(pr.dp_budget, grid, rounds, q_nom))


def scheduled_round(step: Callable, fl: FLConfig, state, batches,
                    pr: FLParams, draws, priv: PrivacyState,
                    grid: acct_lib.OrderGrid, rounds: int,
                    k_cap: Optional[int] = None,
                    n_clients: Optional[int] = None):
    """One round of the lane step (or, with ``batches`` a population, the
    cohort step) under scheduled privacy.

    The scheduler gives each lane z_t (σ_t = z_t · clip); the accountant
    composes the release tentatively at the realised cohort fraction
    q_t = ``realized_cohort_fraction(k_eff)``, K capped at ``k_cap`` (the
    cohort step's ``k_max``) when given; a lane is live when the
    composed ε stays within its ``dp_budget``.  The step runs with σ_t and
    the live gate (a lane that is not live keeps its global params and
    server state bitwise), and the accountant commits only live lanes'
    releases.  All on the device, by ``torch.where``.  Returns ``(state,
    metrics, priv, sigma_t [L], live [L])``.  ``n_clients``: the
    population's size where ``state`` holds only a share of its clients."""
    n = n_clients or state.util.compute.shape[-1]
    k_eff = (state.kctl.k if fl.adaptive_k else
             torch.full_like(state.kctl.k, float(fl.clients_per_round)))
    if k_cap is not None:
        k_eff = torch.clamp(k_eff, max=float(k_cap))
    q_t = realized_cohort_fraction(k_eff, n)
    z_t = sched_lib.scheduled_multiplier(priv.sched, pr, state.round_idx,
                                         rounds)
    sigma_t = z_t * pr.dp_clip
    acct_next = acct_lib.accountant_step(priv.acct, z_t, q_t, grid)
    live = (acct_lib.epsilon_from_state(acct_next, grid)
            <= pr.dp_budget).float()
    state, m = step(state, batches, pr._replace(dp_sigma=sigma_t), draws,
                    update_gate=live)
    keep = live > 0
    acct = acct_lib.AccountantState(*(
        torch.where(keep.reshape(keep.shape + (1,) * (new.dim() - 1)), new,
                    old) for new, old in zip(acct_next, priv.acct)))
    return state, m, priv._replace(acct=acct), sigma_t, live


def _round_loop(fl: FLConfig, spec: ModelSpec, step: Callable, state,
                pr: FLParams, rounds: int, eval_every: int, test_x, test_y,
                round_inputs: Callable, k_cap: Optional[int] = None,
                clients=None, full_params: Optional[Callable] = None):
    """The engines' round loop over the lanes' ``state``: eval blocks of
    ``eval_every`` rounds and a trailing partial block when ``rounds %
    eval_every != 0``, test accuracy and AUC computed on the device at the
    end of each block, nothing read back to the host.  ``round_inputs
    (state)`` gives the round's ``(batches, draws)`` (the population, for
    the cohort step); ``k_cap`` is the cohort step's ``k_max``, ``None``
    for the lane step.  Returns ``(state, sim_time [L], trace)``, ``trace``
    mapping each history column to ``[L, n_evals]``.

    A scheduled-budget config (``fl.dp_scheduled``) runs each round through
    :func:`scheduled_round` and adds the columns ``eps`` (each lane's ε
    after the block), ``sigma`` (σ of its last round) and ``live`` (the
    block's share of released rounds); the scheduler updates from each
    block's AUC.

    ``clients`` (``core/rounds.py`` ``ClientShard``): the state holds this
    rank's share of the population's clients; the cohort's capacities are
    read from their owners.  ``full_params(params)``: the lanes' whole
    params for eval, where the state keeps them split (the model-sharding
    hook)."""
    n_full, rem = divmod(rounds, eval_every)
    blocks = [eval_every] * n_full + ([rem] if rem else [])
    scheduled = fl.dp_enabled and fl.dp_scheduled
    device = test_x.device
    n = state.util.compute.shape[-1] if clients is None else clients.n
    cum_time = torch.zeros(len(state.rng), device=device)
    columns = ("loss", "acc", "auc", "k", "fail", "cum_time")
    if scheduled:
        columns += ("eps", "sigma", "live")
        grid = acct_lib.order_grid(fl.dp_delta, device)
        priv = init_privacy(fl, pr, grid, n, rounds, k_cap=k_cap)
    trace = {k: [] for k in columns}
    with _no_host_sync(device):
        for block in blocks:
            lives = []
            for _ in range(block):
                data, d = round_inputs(state)
                if scheduled:
                    state, m, priv, sigma_t, live = scheduled_round(
                        step, fl, state, data, pr, d, priv, grid, rounds,
                        k_cap=k_cap, n_clients=n)
                    lives.append(live)
                else:
                    state, m = step(state, data, pr, d)
                if k_cap is None:
                    cum_time = cum_time + simulate_round_time(
                        fl, state.util, m.sel_mask, m.failed, params=pr,
                        slow=m.slow)
                else:  # the cohort waits for its slowest selected client
                    compute = (torch.gather(state.util.compute, -1,
                                            m.cohort_idx) if clients is None
                               else clients.at(state.util.compute,
                                               m.cohort_idx))
                    util = state.util._replace(compute=compute)
                    cum_time = cum_time + simulate_round_time(
                        fl, util, m.take, m.failed, params=pr, slow=m.slow)
            with phase("eval_block"):
                acc, auc = _eval_lanes(
                    spec, state.params if full_params is None
                    else full_params(state.params), test_x, test_y)
            fail = (torch.mean(m.failed, dim=-1) if k_cap is None
                    else m.fail_frac)
            for name, v in (("loss", m.global_loss), ("acc", acc),
                            ("auc", auc), ("k", m.k_effective),
                            ("fail", fail), ("cum_time", cum_time)):
                trace[name].append(v)
            if scheduled:
                trace["eps"].append(acct_lib.epsilon_from_state(
                    priv.acct, grid))
                trace["sigma"].append(sigma_t)
                trace["live"].append(torch.stack(lives).mean(dim=0))
                priv = priv._replace(sched=sched_lib.scheduler_update(
                    priv.sched, auc, pr))
    return (state, cum_time,
            {k: torch.stack(v, dim=1) for k, v in trace.items()})


def _check_scheduled(fl: FLConfig) -> None:
    if fl.dp_enabled and fl.dp_scheduled and fl.dp_mode != "clipped":
        raise ValueError(
            "dp_scheduled requires dp_mode='clipped': the accountant "
            "composes z_t = sigma_t/dp_clip, which is only a valid "
            "(epsilon, delta) statement when updates are clipped to "
            "dp_clip — the paper's unclipped fixed-sigma mode has "
            "unbounded sensitivity")


def _init_lanes(spec: ModelSpec, fl: FLConfig, seeds: Sequence[int],
                n_clients: int, data_size, data_quality, device):
    """Each lane's fresh state from ``torch.Generator(device)
    .manual_seed(seed)``: the initial params, then the utility state."""
    states = []
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        states.append(rounds_lib.init_round_state(
            spec.init(gen), fl, gen, n_clients=n_clients,
            data_size=data_size, data_quality=data_quality))
    return states


def _n_noise(fl: FLConfig, state) -> int:
    """DP noise variates a client row draws: one per parameter."""
    return (sum(t[0].numel() for t in tree_leaves(state.params))
            if fl.dp_enabled else 0)


def _build_lane_run(fl: FLConfig, rounds: int, eval_every: int,
                    meta: DataMeta, n_clients: int, device: torch.device,
                    plan_codes: Optional[Sequence[float]] = None):
    """``lane_run(seeds, stack, data_size, data_quality, params,
    init_states=None, draws=None) -> (params [L], sim_time [L], trace)``
    for the STATIC config ``fl``: the counterpart of the reference's
    ``_build_single_run`` under its ``vmap`` over lanes.

    Lane ``l`` has its own ``torch.Generator(device).manual_seed(seeds[l])``,
    which draws the initial params, then the utility state, then each
    round that lane's batch indices and its :class:`RoundDraws`; lanes of
    one seed therefore share their draws across cells, as the reference's
    keys do.  ``init_states`` (one run's :class:`RoundState` a lane) and
    ``draws`` (a lane's list over rounds of ``(batch_idx [n, local_steps,
    batch], RoundDraws)``) replace them, as the parity tests feed the
    reference's own.  ``plan_codes``: the codes the lanes carry
    (``make_lane_round``).  The rounds run in :func:`_round_loop`."""
    _check_scheduled(fl)
    spec = get_model_spec(fl.model, meta)
    n = n_clients
    step = rounds_lib.make_lane_round(spec.loss, fl, n, device=device,
                                      plan_codes=plan_codes)

    def lane_run(seeds: Sequence[int], stack: StackedFederation, data_size,
                 data_quality, pr: FLParams, init_states=None, draws=None):
        lanes = len(seeds)
        if init_states is None:
            init_states = _init_lanes(spec, fl, seeds, n, data_size,
                                      data_quality, device)
        state = rounds_lib.stack_states(init_states)
        n_noise = _n_noise(fl, state)
        steps, batch = fl.local_epochs, fl.local_batch
        if draws is None:  # buffers each round's draws go into
            u_batch = torch.empty(lanes, n, steps, batch, device=device)
            draw_out = rounds_lib.RoundDraws.empty(lanes, n, n_noise, device)

        def round_inputs(state):
            if draws is None:
                idx = draw_batch_indices(state.rng, stack.sizes, steps,
                                         batch, out=u_batch)
                d = rounds_lib.draw_round(state.rng, n, steps, n_noise,
                                          fl.selection, out=draw_out)
            else:
                r = state.round_idx
                idx = torch.stack([lane[r][0] for lane in draws])
                d = rounds_lib.RoundDraws.stack([lane[r][1]
                                                 for lane in draws])
            return sample_round_batches(stack, idx), d

        state, cum_time, trace = _round_loop(
            fl, spec, step, state, pr, rounds, eval_every, stack.test_x,
            stack.test_y, round_inputs)
        return state.params, cum_time, trace

    return lane_run


class _LaneSplit(NamedTuple):
    """This rank's share of an engine's lanes over the ``lane`` axis of a
    mesh (the sweep's 1-D ``("lane",)`` one or the population's ``(lane,
    client)`` one; the counterpart of the reference's lane
    ``NamedSharding``): the lanes padded up to a multiple of the lane
    ranks by repeating the last one (dropped on readback), lane rank r
    taking the r-th run of ``per``.  The lanes never interact, so each
    rank runs its own with their own generators and the round issues no
    collective over ``lane``; the readback all-gathers them, placed by
    ``lane_shardings``."""

    mesh: object      # DeviceMesh with a "lane" axis
    n_lanes: int
    per: int          # lanes a lane rank
    rank: int
    padded: int       # per × the lane ranks

    @staticmethod
    def over(mesh, n_lanes: int) -> "_LaneSplit":
        ranks = mesh["lane"].size() if mesh.ndim > 1 else mesh.size()
        per = -(-n_lanes // ranks)
        return _LaneSplit(mesh, n_lanes, per, mesh.get_local_rank("lane"),
                          per * ranks)

    def take(self, seq):
        """This rank's entries of a per-lane list (``None`` passes)."""
        if seq is None:
            return None
        seq = list(seq)
        padded = seq + seq[-1:] * (self.padded - len(seq))
        return padded[self.rank * self.per:(self.rank + 1) * self.per]

    def take_lanes(self, pr: FLParams) -> FLParams:
        """This rank's ``[per]`` slice of ``[n_lanes]`` param lanes."""
        pad, a = self.padded - self.n_lanes, self.rank * self.per
        return FLParams(*(torch.cat([t, t[-1:].expand(pad)])[a:a + self.per]
                          for t in pr))

    def gather(self, tree):
        """Every lane rank's ``[per, ...]`` lanes -> ``[n_lanes, ...]`` on
        each rank (a tensor, or dicts, lists and tuples of them)."""
        from torch.distributed.tensor import DTensor

        from repro_torch.models.sharding import lane_shardings
        if isinstance(tree, dict):
            return {k: self.gather(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.gather(v) for v in tree)
        return DTensor.from_local(
            tree.contiguous(), self.mesh, lane_shardings(self.mesh)[0],
            run_check=False).full_tensor()[:self.n_lanes]


def _lane_mesh(n_lanes: int, device: torch.device):
    """The sweep's 1-D ``("lane",)`` mesh over the default process group's
    ranks, or ``None`` (no group, one rank or one lane: the unsharded
    engine).  Every rank of the group calls the engine with the same
    arguments."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() <= 1 \
            or n_lanes <= 1:
        return None
    from repro_torch.launch.mesh import mesh_from_shape
    return mesh_from_shape((dist.get_world_size(),), ("lane",), device.type)


# Lane runners keyed on (STATIC config, rounds, eval_every, DataMeta,
# n_lanes, stack shapes, device, the cells' plan codes): every runtime knob
# (FLParams) and the federation are arguments, so one runner serves a
# whole ε/failure/lr/plan grid; a code-0 grid's runner leaves out the async
# and hier blocks.  The population engine's runners share the cache under a "pop"
# tag.  RUNNER_STATS counts misses and hits, as the reference's does: a view
# of the registry (repro_torch.obs.stats), so dict-style call sites (index,
# +=, dict(...)) work unchanged and STATS.snapshot()/reset()/expect() see it
# as the "runner" namespace.
_RUNNER_CACHE: Dict = {}
RUNNER_STATS = obs_stats.STATS.counters("runner", misses=0, hits=0)

# Device-side federations cached per host FederatedData object (keyed by
# id() and device, with a weakref guard: FederatedData defines __eq__, so it
# is unhashable), so repeat calls skip the re-pad and upload.
_STACK_CACHE: Dict = {}


def _device_federation(fed: FederatedData, device: torch.device):
    key = (id(fed), str(device))
    entry = _STACK_CACHE.get(key)
    if entry is None or entry[0]() is not fed:
        sizes = fed.data_sizes()
        ref = weakref.ref(fed, lambda _: _STACK_CACHE.pop(key, None))
        entry = (ref, stack_federation(fed, device),
                 torch.as_tensor(sizes / sizes.mean(), device=device),
                 torch.as_tensor(fed.label_entropy(), device=device))
        _STACK_CACHE[key] = entry
    return entry[1], entry[2], entry[3]


def _cached_runner(cache_key, build: Callable, engine: str, model: str,
                   rounds: int, n_lanes: int):
    """The runner of ``cache_key``, built by ``build()`` on a miss: one miss
    a key (counted in ``RUNNER_STATS``, a ``compile.runner_miss`` event and
    a ``runner.build`` span), hits after."""
    runner = _RUNNER_CACHE.get(cache_key)
    if runner is None:
        RUNNER_STATS["misses"] += 1
        obs_trace.event("compile.runner_miss", engine=engine, model=model,
                        rounds=rounds, n_lanes=n_lanes,
                        cache_size=len(_RUNNER_CACHE))
        with obs_trace.span("runner.build", engine=engine, model=model):
            runner = _RUNNER_CACHE[cache_key] = build()
    else:
        RUNNER_STATS["hits"] += 1
    return runner


def _run_lanes(tag: str, prepare: Callable, **attrs):
    """Time one engine call: ``prepare()`` gives the runner's thunk, whose
    ``(params, sim_time, trace)`` are read back to the host, each step
    under a ``{tag}.prepare/execute/readback`` span (``attrs`` on the
    first).  Returns ``(params, sim_time [L], trace {column: [L,
    n_evals]}, wall s)`` as NumPy."""
    n_lanes = attrs["n_lanes"]
    t0 = time.perf_counter()
    with obs_trace.span(f"{tag}.prepare", **attrs):
        execute = prepare()
    with obs_trace.span(f"{tag}.execute", n_lanes=n_lanes):
        params_b, sim_b, trace_b = execute()
    with obs_trace.span(f"{tag}.readback", n_lanes=n_lanes):
        trace_np = {k: v.cpu().numpy() for k, v in trace_b.items()}
        sim_np = sim_b.cpu().numpy()
    return params_b, sim_np, trace_np, time.perf_counter() - t0


def _lane_results(cells: Sequence[FLConfig], seeds: Sequence[int],
                  method: str, dataset: str, rounds: int, eval_every: int,
                  sim_np, trace_np, wall_per_lane: float,
                  finish: Optional[Callable] = None) -> List[List[RunResult]]:
    """The engines' :class:`RunResult` grid ``[cell][seed]`` from the lanes'
    read-back columns (lane = cell_index · n_seeds + seed_index).  A fixed-σ
    cell's ``eps_spent`` is the host accountant's closed form, a scheduled
    cell's the lane's in-loop ε after its last round.  ``finish(lane, seed,
    result)``, when given, returns the lane's final result."""
    eval_idx = _eval_rounds(rounds, eval_every)
    out: List[List[RunResult]] = []
    for ci, cell in enumerate(cells):
        scheduled = cell.dp_enabled and cell.dp_scheduled
        eps_cell = None if scheduled else accounted_epsilon(cell, rounds)
        row = []
        for si, seed in enumerate(seeds):
            lane = ci * len(seeds) + si
            history = {"round": [r + 1 for r in eval_idx]}
            for name, v in trace_np.items():
                history[name] = [float(x) for x in v[lane]]
            res = RunResult(
                method=method, dataset=dataset, seed=seed,
                accuracy=history["acc"][-1], auc=history["auc"][-1],
                sim_time_s=float(sim_np[lane]), wall_time_s=wall_per_lane,
                rounds=rounds,
                eps_spent=history["eps"][-1] if scheduled else eps_cell,
                history=history)
            row.append(res if finish is None else finish(lane, seed, res))
        out.append(row)
    return out


def _sweep_cells(fl: FLConfig, params_grid: Sequence, method: str,
                 capability: str = "driver_capable") -> List[FLConfig]:
    """Resolve a params_grid into per-cell FLConfigs sharing ``fl``'s
    statics (for the sweep and population engines).  Each cell's plan must
    carry ``capability`` in the ``core/plans`` registry
    (``driver_capable`` for the dense engines, ``cohort_capable`` for the
    population engine); plans of one family may differ across cells, their
    plan code a runtime lane."""
    cells: List[FLConfig] = []
    for p in params_grid:
        if isinstance(p, FLConfig):
            cell = fl_for_method(p, method)
        elif isinstance(p, FLParams):
            # plan_code is derived from FLConfig.plan, not a config field:
            # map a differing code back to the registered plan name
            overrides = p._asdict()
            code = float(overrides.pop("plan_code"))
            cell = dataclasses.replace(fl, **overrides)
            if code != plans_lib.plan_code(cell.plan):
                cell = dataclasses.replace(cell, plan=plans_lib.plan_for_code(
                    plans_lib.plan_family(cell.plan), code))
        else:
            cell = dataclasses.replace(fl, **dict(p))
        if not getattr(plans_lib.get_plan(cell.plan), capability):
            raise ValueError(
                f"plan {cell.plan!r} cannot run on this engine: the "
                f"core/plans registry marks it {capability}=False")
        if fl_static(cell) != fl_static(fl):
            raise ValueError(
                "params_grid cell differs from the base config in a STATIC "
                "field — those gate code structure and cannot ride the "
                f"runtime lane axis: {cell}")
        cells.append(cell)
    return cells


def run_fl_sweep(
    fed: FederatedData,
    fl: FLConfig,
    params_grid: Sequence,
    seeds: Sequence[int] = (0, 1, 2, 3),
    method: str = "proposed",
    rounds: Optional[int] = None,
    eval_every: int = 10,
    dataset: str = "unsw",
    hidden: int = 64,
    return_params: bool = False,
    *,
    device=None,
    init_states: Optional[Sequence[rounds_lib.RoundState]] = None,
    draws: Optional[Sequence[Sequence]] = None,
) -> List[List[RunResult]]:
    """A whole hyper-parameter sweep, every lane advancing together.

    ``params_grid``: one entry per cell — an :class:`FLConfig` sharing
    ``fl``'s statics, a dict of runtime-field overrides applied to ``fl``,
    or an :class:`FLParams`.  Each cell's runtime scalars become ``[L]``
    lanes (``len(params_grid) · len(seeds)``, lane = cell_index · n_seeds
    + seed_index), and each round is one set of batched device ops for all
    lanes; test metrics are computed on the device every ``eval_every``
    rounds and read back once, at the end.  Runs on ``device`` (``cuda``
    unless ``"cpu"`` is asked).  ``init_states``/``draws``: one entry a
    lane (see :func:`_build_lane_run`).  A cell's ``eps_spent`` is the host
    accountant's closed form, or, under ``dp_scheduled``, the lane's
    in-loop ε after its last round (``history["eps"][-1]``).

    ``run_fl_sweep(..., [cfg_a, cfg_b], seeds)[i][j]`` equals
    ``run_fl(fed, cfg_i, seed=seeds[j])`` up to float order.  Returns
    results indexed ``[cell][seed]``.

    Under a process group of several ranks (each calling with the same
    arguments) the lanes are split over a 1-D ``("lane",)`` mesh of its
    ranks (:class:`_LaneSplit`): each rank runs its share, and the
    readback all-gathers every lane to every rank."""
    device = resolve_device(device)
    fl = fl_for_method(fl, method)
    rounds = int(rounds or fl.rounds)
    seeds = [int(s) for s in seeds]
    cells = _sweep_cells(fl, params_grid, method)
    if not cells:
        return []
    n_lanes = len(cells) * len(seeds)
    meta = meta_for(fed, hidden=hidden)
    codes = tuple(sorted({plans_lib.plan_code(c.plan) for c in cells}))
    lane_mesh = _lane_mesh(n_lanes, device)

    def prepare():
        stack, data_size, data_quality = _device_federation(fed, device)
        lanes = params_lanes(cells, len(seeds), device)
        lane_seeds, states, lane_draws = seeds * len(cells), init_states, draws
        split = None
        if lane_mesh is not None:
            split = _LaneSplit.over(lane_mesh, n_lanes)
            lane_seeds, states, lane_draws = (
                split.take(lane_seeds), split.take(states),
                split.take(lane_draws))
            lanes = split.take_lanes(lanes)
        n_run = len(lane_seeds)
        runner = _cached_runner(
            (fl_static(fl), rounds, eval_every, meta, n_run, stack.shapes(),
             str(device), codes),
            lambda: _build_lane_run(fl_static(fl), rounds, eval_every, meta,
                                    stack.n_clients, device, codes),
            "sweep", fl.model, rounds, n_run)

        def execute():
            out = runner(lane_seeds, stack, data_size, data_quality, lanes,
                         init_states=states, draws=lane_draws)
            return out if split is None else split.gather(out)

        return execute

    params_b, sim_np, trace_np, wall = _run_lanes(
        "sweep", prepare, method=method, n_lanes=n_lanes, n_cells=len(cells),
        rounds=rounds, plans=",".join(sorted({c.plan for c in cells})))
    finish = None
    if return_params or method == "fedl2p":
        spec = get_model_spec(fl.model, meta)

        def finish(lane, seed, res):
            lane_params = tree_map(lambda a: a[lane].clone(), params_b)
            if method == "fedl2p":
                # personalisation pass (the point of FedL2P) + its cost
                acc, auc = _personalize(lane_params, fed, spec, seed=seed)
                res = dataclasses.replace(res, accuracy=acc, auc=auc,
                                          sim_time_s=res.sim_time_s * 1.2)
            return dataclasses.replace(
                res, params=lane_params if return_params else None)

    return _lane_results(cells, seeds, method, dataset, rounds, eval_every,
                         sim_np, trace_np, wall / n_lanes, finish)


def run_fl_batch(fed: FederatedData, fl: FLConfig, method: str = "proposed",
                 seeds: Sequence[int] = (0, 1, 2, 3),
                 rounds: Optional[int] = None, eval_every: int = 10,
                 dataset: str = "unsw", hidden: int = 64,
                 return_params: bool = False, *,
                 device=None) -> List[RunResult]:
    """All repeated trials of one (method, dataset) cell: a one-cell
    :func:`run_fl_sweep` (one lane a seed)."""
    return run_fl_sweep(fed, fl, [fl], seeds=seeds, method=method,
                        rounds=rounds, eval_every=eval_every, dataset=dataset,
                        hidden=hidden, return_params=return_params,
                        device=device)[0]


def run_fl(fed: FederatedData, fl: FLConfig, method: str = "proposed",
           seed: int = 0, rounds: Optional[int] = None, eval_every: int = 10,
           dataset: str = "unsw", hidden: int = 64,
           return_params: bool = False, *, device=None) -> RunResult:
    """One seed of one cell through the sweep engine (a batch of one)."""
    return run_fl_batch(fed, fl, method, seeds=(seed,), rounds=rounds,
                        eval_every=eval_every, dataset=dataset, hidden=hidden,
                        return_params=return_params, device=device)[0]


# ---------------------------------------------------------------------------
# Population engine: cohort training over a 10^3–10^6-client population
# ---------------------------------------------------------------------------


class _ModelSplit:
    """The model-sharding hook's storage (``ModelSpec.param_axes`` under
    ``RULES_MODEL_SCALE``): each lane's wide leaves (the axes the rules
    put on ``client``) kept split over the client ranks, the rest whole.
    The layout is the one ``spec.constrain_params`` gives inside
    ``sharding_ctx(rules, cmesh)``; a round gathers the leaves whole once
    (FSDP-style) and runs the replicated math on them, so its values are
    the unsharded run's, and splits the new params again."""

    def __init__(self, spec: ModelSpec, cmesh, like):
        from torch.distributed.tensor import DTensor, Replicate

        from repro_torch.models import shardctx
        from repro_torch.models.sharding import RULES_MODEL_SCALE, without_axes
        self.cmesh = cmesh
        rules = without_axes(RULES_MODEL_SCALE, ("lane",))
        with shardctx.sharding_ctx(rules, cmesh):
            placed = spec.constrain_params(tree_map(
                lambda t: DTensor.from_local(t, cmesh, [Replicate()],
                                             run_check=False), like))
        # a lane-stacked leaf's split dim: the unstacked one's, plus one
        self.dims = tree_map(lambda d: (d.placements[0].dim + 1
                                        if d.placements[0].is_shard()
                                        else None), placed)

    def split(self, params):
        """Whole lane-stacked params -> this rank's shares."""
        rank, ranks = self.cmesh.get_local_rank(), self.cmesh.size()
        return tree_map(lambda t, d: t if d is None else
                        t.chunk(ranks, dim=d)[rank].contiguous(),
                        params, self.dims)

    def whole(self, params):
        """This rank's shares -> the whole lane-stacked params."""
        from torch.distributed.tensor import DTensor, Shard
        return tree_map(lambda t, d: t if d is None else DTensor.from_local(
            t, self.cmesh, [Shard(d)], run_check=False).full_tensor(),
            params, self.dims)


def _build_population_run(fl: FLConfig, rounds: int, eval_every: int,
                          meta: DataMeta, n_clients: int, sel_chunks: int,
                          device: torch.device):
    """``pop_run(seeds, pop, params, init_states=None, draws=None,
    clients=None, model_split=False) -> (params [L], sim_time [L],
    trace)`` over a device
    :class:`~repro_torch.data.synthetic.Population`: the population-scale
    sibling of :func:`_build_lane_run`, with the ``client_cohort`` round
    step (``core/rounds.py`` ``make_cohort_round``).  A round's compute is
    O(k_max); O(N) work is vector ops over the ``[L, N]`` carries, and
    every per-round column is a lane scalar.

    Each lane's generator draws the initial params, the utility state,
    then each round's :class:`~repro_torch.core.rounds.CohortDraws`.
    ``init_states`` and ``draws`` (a lane's list over rounds of one-lane
    ``CohortDraws``) replace them.  The time model waits for the slowest
    selected client (the cohort's compute capacities); scheduled privacy
    caps K at ``k_max``.

    ``clients`` (a ``ClientShard``): ``pop`` holds this rank's rows of
    the per-client arrays, and the lanes' per-client state is split the
    same way (each rank draws the lanes' whole ``[L, N]`` variates and
    keeps its columns, so they are the unsharded run's).  ``model_split``
    (with ``clients``): the params are stored as :class:`_ModelSplit`
    shares."""
    _check_scheduled(fl)
    spec = get_model_spec(fl.model, meta)
    k_max = int(fl.k_max)
    step = rounds_lib.make_cohort_round(spec.loss, fl, n_clients,
                                        sel_chunks=sel_chunks, device=device)

    def pop_run(seeds: Sequence[int], pop: Population, pr: FLParams,
                init_states=None, draws=None, clients=None,
                model_split: bool = False):
        if init_states is None:
            init_states = _init_lanes(spec, fl, seeds, n_clients,
                                      pop.data_size, pop.data_quality, device)
        state = rounds_lib.stack_states(init_states)
        n_noise = _n_noise(fl, state)
        if draws is None:
            draw_out = rounds_lib.CohortDraws.empty(
                len(seeds), n_clients, k_max, fl.local_epochs,
                fl.local_batch, n_noise, device)
        run_step, whole = step, None
        if clients is not None:
            data_mean = torch.mean(state.util.data_size, dim=-1,
                                   keepdim=True)
            mine = lambda t: clients.cols(t).contiguous()  # noqa: E731
            state = state._replace(
                util=type(state.util)(*map(mine, state.util)),
                fault=type(state.fault)(*map(mine, state.fault)))
            split = (_ModelSplit(spec, clients.cmesh,
                                 tree_map(lambda a: a[0], state.params))
                     if model_split else None)

            def run_step(state, batches, pr, draws=None, update_gate=None):
                if split is not None:
                    state = state._replace(params=split.whole(state.params))
                state, m = step(state, batches, pr, draws, update_gate,
                                clients=clients, data_mean=data_mean)
                if split is not None:
                    state = state._replace(params=split.split(state.params))
                return state, m

            if split is not None:
                state = state._replace(params=split.split(state.params))
                whole = split.whole

        def round_inputs(state):
            if draws is None:
                return pop, rounds_lib.draw_cohort_round(
                    state.rng, n_clients, k_max, fl.local_epochs,
                    fl.local_batch, n_noise, fl.selection, out=draw_out)
            r = state.round_idx
            return pop, rounds_lib.CohortDraws.stack(
                [lane[r] for lane in draws])

        state, cum_time, trace = _round_loop(
            fl, spec, run_step, state, pr, rounds, eval_every, pop.test_x,
            pop.test_y, round_inputs, k_cap=k_max, clients=clients,
            full_params=whole)
        return (state.params if whole is None else whole(state.params),
                cum_time, trace)

    return pop_run


def _local_population(pop: Population, mesh) -> Population:
    """This rank's share of a device population on a ``(lane, client)``
    mesh, placed by ``population_shardings``: its rows of the per-client
    arrays, the pool and the test set whole."""
    from repro_torch.models.shardctx import local_box
    from repro_torch.models.sharding import population_shardings
    placements = population_shardings(mesh, pop)

    def mine(name):
        t = getattr(pop, name)
        shape, offset = local_box(t.shape, mesh, getattr(placements, name))
        return t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]

    return dataclasses.replace(pop, **{k: mine(k) for k in Population._ARRAYS})


def run_fl_population(
    pop: Population,
    fl: FLConfig,
    params_grid: Optional[Sequence] = None,
    seeds: Sequence[int] = (0,),
    method: str = "proposed",
    rounds: Optional[int] = None,
    eval_every: int = 10,
    dataset: str = "unsw",
    hidden: int = 64,
    mesh_shape: Optional[tuple] = None,
    shard: bool = True,
    sel_chunks: Optional[int] = None,
    memory_budget_bytes: Optional[int] = None,
    model_replicated_max_bytes: Optional[int] = None,
    *,
    device=None,
    init_states: Optional[Sequence[rounds_lib.RoundState]] = None,
    draws: Optional[Sequence[Sequence]] = None,
) -> List[List[RunResult]]:
    """A sweep over a 10^3–10^6-client :class:`Population`: cells × seeds
    lanes as :func:`run_fl_sweep` lays them out (results ``[cell][seed]``),
    each round training only the cohort picked on the device (the
    ``client_cohort`` plan): per-round compute and data traffic are
    O(k_max), whatever N.  Runs on ``device`` (``cuda`` unless ``"cpu"``
    is asked); the population's arrays go to the device once a call.

    ``sel_chunks`` splits the cohort top-k (bitwise-neutral); with
    ``memory_budget_bytes`` and no ``sel_chunks`` it comes from
    ``core/scale.auto_chunks``.  ``init_states``/``draws``: one entry a
    lane (see :func:`_build_population_run`).  The runner is cached on
    (statics, rounds, cadence, lanes, population shapes, ``sel_chunks``,
    device, the mesh layout and the model-sharding choice) in the sweep
    engine's cache under a "pop" tag.

    The lane × client mesh (``launch/mesh.py`` ``make_scale_mesh`` over
    the default process group's ranks, every rank calling with the same
    arguments; ``mesh_shape`` pins ``(lane, client)``, whose product is the
    group's size): lanes split over ``lane`` as in the sweep engine
    (:class:`_LaneSplit`), and the population's per-client arrays and the
    lanes' ``[L, N]`` utility and fault state over ``client``
    (``population_shardings``; ``core/rounds.py`` ``ClientShard``: the
    cohort's top-k in two stages, its rows read from their owners, results
    written back on them).  A client axis that does not divide N
    replicates instead, as the reference's does.  ``shard=False``, one
    rank or no group: the unsharded engine.  The model-sharding hook: a
    detector whose ``param_bytes()`` passes ``model_replicated_max_bytes``
    (default ``core/scale.MODEL_REPLICATED_MAX_BYTES``) and that declares
    ``ModelSpec.param_axes`` keeps its wide leaves split over a client
    axis of more than one rank (``RULES_MODEL_SCALE``,
    :class:`_ModelSplit`), gathered whole for each round's replicated
    math.

    ``fedl2p`` is refused: its personalisation pass is O(N) host work."""
    device = resolve_device(device)
    if method == "fedl2p":
        raise ValueError(
            "run_fl_population does not support fedl2p: its host-side "
            "personalisation fine-tunes every client (O(N) python loop) — "
            "use the dense engine at dense-federation scale")
    fl = fl_for_method(fl, method)
    if not fl.k_max or int(fl.k_max) <= 0:
        raise ValueError(
            "run_fl_population needs an explicit positive FLConfig.k_max "
            "(the static cohort size gathered per round)")
    rounds = int(rounds or fl.rounds)
    seeds = [int(s) for s in seeds]
    cells = _sweep_cells(fl, [fl] if params_grid is None else params_grid,
                         method, capability="cohort_capable")
    if not cells:
        return []
    n_lanes = len(cells) * len(seeds)
    meta = meta_for(pop, hidden=hidden)
    spec = get_model_spec(fl.model, meta)
    model_bytes = spec.param_bytes()
    if sel_chunks is None:
        sel_chunks = 1 if memory_budget_bytes is None else \
            scale_lib.auto_chunks(
                pop.n_clients, int(memory_budget_bytes),
                pop.members_per_client, n_lanes, model_bytes=model_bytes)
    mesh = _scale_mesh(n_lanes, mesh_shape, device) if shard else None
    n_client_ranks = 1 if mesh is None else mesh["client"].size()
    split_clients = n_client_ranks > 1 and pop.n_clients % n_client_ranks == 0
    model_split = (split_clients and spec.param_axes is not None
                   and scale_lib.model_needs_sharding(
                       model_bytes, model_replicated_max_bytes))
    layout = None if mesh is None else (
        tuple(zip(mesh.mesh_dim_names, mesh.shape)), split_clients,
        model_split)

    def prepare():
        pop_dev = pop.to(device)
        lanes = params_lanes(cells, len(seeds), device)
        lane_seeds, states, lane_draws = seeds * len(cells), init_states, draws
        split = clients = None
        if mesh is not None:
            split = _LaneSplit.over(mesh, n_lanes)
            lane_seeds, states, lane_draws = (
                split.take(lane_seeds), split.take(states),
                split.take(lane_draws))
            lanes = split.take_lanes(lanes)
        if split_clients:
            clients = rounds_lib.ClientShard(mesh["client"], pop.n_clients)
            local = _local_population(pop_dev, mesh)
        n_run = len(lane_seeds)
        runner = _cached_runner(
            ("pop", fl_static(fl), rounds, eval_every, meta, n_run,
             pop.shapes(), int(sel_chunks), str(device), layout),
            lambda: _build_population_run(fl_static(fl), rounds, eval_every,
                                          meta, pop.n_clients,
                                          int(sel_chunks), device),
            "population", fl.model, rounds, n_run)

        def execute():
            if clients is not None and states is None:
                # each lane's whole state, then this rank keeps its columns
                states_ = _init_lanes(spec, fl, lane_seeds, pop.n_clients,
                                      pop_dev.data_size,
                                      pop_dev.data_quality, device)
            else:
                states_ = states
            out = runner(lane_seeds, pop_dev if clients is None else local,
                         lanes, init_states=states_, draws=lane_draws,
                         clients=clients, model_split=model_split)
            return out if split is None else split.gather(out)

        return execute

    _, sim_np, trace_np, wall = _run_lanes(
        "population", prepare, method=method, n_lanes=n_lanes,
        n_cells=len(cells), rounds=rounds, n_clients=pop.n_clients)
    return _lane_results(cells, seeds, method, dataset, rounds, eval_every,
                         sim_np, trace_np, wall / n_lanes)


def _scale_mesh(n_lanes: int, mesh_shape, device: torch.device):
    """The population engine's ``(lane, client)`` mesh over the default
    process group, or ``None`` (no group or one rank, without a pinned
    shape of more): ``launch/mesh.py`` ``make_scale_mesh``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_scale_mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_shape is not None and math.prod(mesh_shape) != world:
        raise ValueError(
            f"mesh_shape {tuple(mesh_shape)} asks for "
            f"{math.prod(mesh_shape)} ranks; the process group has {world}")
    return make_scale_mesh(n_lanes, shape=mesh_shape,
                           device_type=device.type)
