"""End-to-end FL driver for the anomaly-detection use case (paper §V): the
port's copy of ``repro/train/fl_driver.py``'s engines and what they need
(``METHODS``, ``fl_for_method``, ``RunResult``, ``simulate_round_time``,
``realized_cohort_fraction``, the FedL2P personalisation pass).

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
* :func:`run_fl_legacy` — the per-round driver, kept as the oracle:
  batches are sampled on the host with the reference's NumPy sampler, so
  one seed feeds both packages the same batches, and eval is pulled to the
  host.

Scheduled privacy (``dp_scheduled``, :func:`run_fl_sweep` and its front
doors only) carries an in-loop RDP accountant and a noise scheduler per
lane; a release that would overspend a lane's budget is withheld
(:func:`scheduled_round`).  Not ported yet (each raises): plan codes 1 and
2 and ``client_serial``, and the population (cohort) engine.

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
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import (FLConfig, FLParams, as_f32, fl_params,
                                     fl_static, params_lanes)
from repro_torch.core import fault as fault_lib
from repro_torch.core import plans as plans_lib
from repro_torch.core import rounds as rounds_lib
from repro_torch.data.synthetic import (FederatedData, StackedFederation,
                                        draw_batch_indices, round_batches,
                                        sample_round_batches, stack_federation)
from repro_torch.device import resolve_device
from repro_torch.models.mlp import auc_roc, auc_roc_torch
from repro_torch.models.spec import (DataMeta, ModelSpec, get_model_spec,
                                     meta_for)
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
            f"plan; plan {fl.plan!r} is not ported yet")
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
                                                device=device)

    tx = torch.as_tensor(fed.test_x, device=device)
    ty = torch.as_tensor(fed.test_y, device=device)
    history = {"round": [], "loss": [], "acc": [], "auc": [], "k": [],
               "fail": [], "cum_time": []}
    sim_time = 0.0
    t0 = time.time()
    for r in range(rounds):
        with record_function("fl.batches"):
            b = round_batches(rng, fed, fl.local_epochs, fl.local_batch)
            batches = {"x": torch.as_tensor(b["x"], device=device),
                       "y": torch.as_tensor(b["y"], device=device).long()}
        with record_function("fl.round_step"):
            state, metrics = round_step(
                state, batches, draws=None if draws is None else draws[r])
        if on_round is not None:
            on_round(r, state, metrics)
        with record_function("fl.sim_time"):
            sim_time += float(simulate_round_time(
                fl, state.util, metrics.sel_mask, metrics.failed,
                slow=metrics.slow))
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            with record_function("fl.eval"):
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
                 n_clients: int, rounds: int) -> PrivacyState:
    """An empty accountant, and each lane's scheduler calibrated to its
    ``dp_budget`` (``pr``'s fields are ``[L]`` lanes) over ``rounds`` at
    the nominal cohort fraction."""
    q_nom = min(fl.clients_per_round / n_clients, 1.0)
    return PrivacyState(
        acct_lib.init_accountant_state(pr.dp_budget.shape[0],
                                       grid.orders.device),
        sched_lib.init_scheduler(pr.dp_budget, grid, rounds, q_nom))


def scheduled_round(step: Callable, fl: FLConfig, state, batches,
                    pr: FLParams, draws, priv: PrivacyState,
                    grid: acct_lib.OrderGrid, rounds: int):
    """One round of the lane step under scheduled privacy.

    The scheduler gives each lane z_t (σ_t = z_t · clip); the accountant
    composes the release tentatively at the realised cohort fraction
    q_t = ``realized_cohort_fraction(k_eff)``; a lane is live when the
    composed ε stays within its ``dp_budget``.  The step runs with σ_t and
    the live gate (a lane that is not live keeps its global params and
    server state bitwise), and the accountant commits only live lanes'
    releases.  All on the device, by ``torch.where``.  Returns ``(state,
    metrics, priv, sigma_t [L], live [L])``."""
    n = state.util.compute.shape[-1]
    k_eff = (state.kctl.k if fl.adaptive_k else
             torch.full_like(state.kctl.k, float(fl.clients_per_round)))
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


def _build_lane_run(fl: FLConfig, rounds: int, eval_every: int,
                    meta: DataMeta, n_clients: int, device: torch.device):
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
    reference's own.

    The loop runs eval blocks of ``eval_every`` rounds and a trailing
    partial block when ``rounds % eval_every != 0``; test accuracy and AUC
    are computed on the device at the end of each block.  ``trace`` maps
    each history column to ``[L, n_evals]``.  Between the lanes'
    initialisation and the return nothing is read back to the host.

    A scheduled-budget config (``fl.dp_scheduled``) runs each round through
    :func:`scheduled_round` and adds the columns ``eps`` (each lane's ε
    after the block), ``sigma`` (σ of its last round) and ``live`` (the
    block's share of released rounds); the scheduler updates from each
    block's AUC."""
    n_full, rem = divmod(rounds, eval_every)
    blocks = [eval_every] * n_full + ([rem] if rem else [])
    scheduled = fl.dp_enabled and fl.dp_scheduled
    if scheduled and fl.dp_mode != "clipped":
        raise ValueError(
            "dp_scheduled requires dp_mode='clipped': the accountant "
            "composes z_t = sigma_t/dp_clip, which is only a valid "
            "(epsilon, delta) statement when updates are clipped to "
            "dp_clip — the paper's unclipped fixed-sigma mode has "
            "unbounded sensitivity")
    spec = get_model_spec(fl.model, meta)
    n = n_clients
    step = rounds_lib.make_lane_round(spec.loss, fl, n, device=device)

    def lane_run(seeds: Sequence[int], stack: StackedFederation, data_size,
                 data_quality, pr: FLParams, init_states=None, draws=None):
        lanes = len(seeds)
        if init_states is None:
            init_states = []
            for seed in seeds:
                gen = torch.Generator(device=device).manual_seed(int(seed))
                init_states.append(rounds_lib.init_round_state(
                    spec.init(gen), fl, gen, n_clients=n,
                    data_size=data_size, data_quality=data_quality))
        state = rounds_lib.stack_states(init_states)
        n_noise = (sum(t[0].numel() for t in tree_leaves(state.params))
                   if fl.dp_enabled else 0)
        steps, batch = fl.local_epochs, fl.local_batch
        if draws is None:  # buffers each round's draws go into
            u_batch = torch.empty(lanes, n, steps, batch, device=device)
            draw_out = rounds_lib.RoundDraws.empty(lanes, n, n_noise, device)
        cum_time = torch.zeros(lanes, device=device)
        columns = ("loss", "acc", "auc", "k", "fail", "cum_time")
        if scheduled:
            columns += ("eps", "sigma", "live")
            grid = acct_lib.order_grid(fl.dp_delta, device)
            priv = init_privacy(fl, pr, grid, n, rounds)
        trace = {k: [] for k in columns}
        with _no_host_sync(device):
            for block in blocks:
                lives = []
                for _ in range(block):
                    r = state.round_idx
                    if draws is None:
                        idx = draw_batch_indices(state.rng, stack.sizes,
                                                 steps, batch, out=u_batch)
                        d = rounds_lib.draw_round(state.rng, n, steps,
                                                  n_noise, fl.selection,
                                                  out=draw_out)
                    else:
                        idx = torch.stack([lane[r][0] for lane in draws])
                        d = rounds_lib.RoundDraws.stack(
                            [lane[r][1] for lane in draws])
                    batches = sample_round_batches(stack, idx)
                    if scheduled:
                        state, m, priv, sigma_t, live = scheduled_round(
                            step, fl, state, batches, pr, d, priv, grid,
                            rounds)
                        lives.append(live)
                    else:
                        state, m = step(state, batches, pr, d)
                    cum_time = cum_time + simulate_round_time(
                        fl, state.util, m.sel_mask, m.failed, params=pr,
                        slow=m.slow)
                with record_function("eval_block"):
                    acc, auc = _eval_lanes(spec, state.params, stack.test_x,
                                           stack.test_y)
                for name, v in (("loss", m.global_loss), ("acc", acc),
                                ("auc", auc), ("k", m.k_effective),
                                ("fail", torch.mean(m.failed, dim=-1)),
                                ("cum_time", cum_time)):
                    trace[name].append(v)
                if scheduled:
                    trace["eps"].append(acct_lib.epsilon_from_state(
                        priv.acct, grid))
                    trace["sigma"].append(sigma_t)
                    trace["live"].append(torch.stack(lives).mean(dim=0))
                    priv = priv._replace(sched=sched_lib.scheduler_update(
                        priv.sched, auc, pr))
        return (state.params, cum_time,
                {k: torch.stack(v, dim=1) for k, v in trace.items()})

    return lane_run


# Lane runners keyed on (STATIC config, rounds, eval_every, DataMeta,
# n_lanes, stack shapes, device): every runtime knob (FLParams) and the
# federation are arguments, so one runner serves a whole ε/failure/lr grid.
# RUNNER_STATS counts misses and hits, as the reference's does.
_RUNNER_CACHE: Dict = {}
RUNNER_STATS = {"misses": 0, "hits": 0}

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


def _get_runner(fl: FLConfig, rounds: int, eval_every: int, meta: DataMeta,
                n_lanes: int, stack: StackedFederation, device: torch.device):
    static = fl_static(fl)
    cache_key = (static, rounds, eval_every, meta, n_lanes, stack.shapes(),
                 str(device))
    runner = _RUNNER_CACHE.get(cache_key)
    if runner is None:
        RUNNER_STATS["misses"] += 1
        runner = _build_lane_run(static, rounds, eval_every, meta,
                                 stack.n_clients, device)
        _RUNNER_CACHE[cache_key] = runner
    else:
        RUNNER_STATS["hits"] += 1
    return runner


def _sweep_cells(fl: FLConfig, params_grid: Sequence,
                 method: str) -> List[FLConfig]:
    """Resolve a params_grid into per-cell FLConfigs sharing ``fl``'s
    statics, and refuse what the port's engine does not run yet."""
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
        if fl_static(cell) != fl_static(fl):
            raise ValueError(
                "params_grid cell differs from the base config in a STATIC "
                "field — those gate code structure and cannot ride the "
                f"runtime lane axis: {cell}")
        plan = plans_lib.get_plan(cell.plan)
        if plan.family != "client_parallel" or plan.code != 0.0:
            raise NotImplementedError(
                f"the port's sweep engine runs only the synchronous "
                f"client_parallel plan (code 0); plan {cell.plan!r} is not "
                f"ported yet")
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
    results indexed ``[cell][seed]``."""
    device = resolve_device(device)
    fl = fl_for_method(fl, method)
    rounds = int(rounds or fl.rounds)
    seeds = [int(s) for s in seeds]
    cells = _sweep_cells(fl, params_grid, method)
    if not cells:
        return []
    n_lanes = len(cells) * len(seeds)

    t0 = time.perf_counter()
    with record_function("sweep.prepare"):
        meta = meta_for(fed, hidden=hidden)
        stack, data_size, data_quality = _device_federation(fed, device)
        runner = _get_runner(fl, rounds, eval_every, meta, n_lanes, stack,
                             device)
        lanes = params_lanes(cells, len(seeds), device)
    with record_function("sweep.execute"):
        params_b, sim_b, trace_b = runner(
            seeds * len(cells), stack, data_size, data_quality, lanes,
            init_states=init_states, draws=draws)
    with record_function("sweep.readback"):
        trace_np = {k: v.cpu().numpy() for k, v in trace_b.items()}
        sim_np = sim_b.cpu().numpy()
    wall_per_lane = (time.perf_counter() - t0) / n_lanes

    eval_idx = _eval_rounds(rounds, eval_every)
    spec = get_model_spec(fl.model, meta) if method == "fedl2p" else None
    out: List[List[RunResult]] = []
    for ci, cell in enumerate(cells):
        # fixed-σ cells: the host closed form; scheduled cells: the lane's
        # in-loop accountant
        scheduled = cell.dp_enabled and cell.dp_scheduled
        eps_cell = None if scheduled else accounted_epsilon(cell, rounds)
        row = []
        for si, seed in enumerate(seeds):
            lane = ci * len(seeds) + si
            history = {"round": [r + 1 for r in eval_idx]}
            for name, v in trace_np.items():
                history[name] = [float(x) for x in v[lane]]
            eps = history["eps"][-1] if scheduled else eps_cell
            sim_time = float(sim_np[lane])
            acc, auc = history["acc"][-1], history["auc"][-1]
            lane_params = (tree_map(lambda a: a[lane].clone(), params_b)
                           if return_params or method == "fedl2p" else None)
            if method == "fedl2p":
                # personalisation pass (the point of FedL2P) + its cost
                acc, auc = _personalize(lane_params, fed, spec, seed=seed)
                sim_time *= 1.2
            row.append(RunResult(
                method=method, dataset=dataset, seed=seed,
                accuracy=acc, auc=auc,
                sim_time_s=sim_time, wall_time_s=wall_per_lane,
                rounds=rounds, eps_spent=eps, history=history,
                params=lane_params if return_params else None))
        out.append(row)
    return out


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
