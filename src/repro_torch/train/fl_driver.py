"""End-to-end FL driver for the anomaly-detection use case (paper §V): the
port's copy of ``repro/train/fl_driver.py``'s per-round driver
``run_fl_legacy`` and what it needs (``METHODS``, ``fl_for_method``,
``RunResult``, ``simulate_round_time``, ``realized_cohort_fraction``, the
FedL2P personalisation pass).

It runs the full Algorithm-1 loop on the synthetic UNSW-NB15 / ROAD
federations and reports accuracy, AUC-ROC, simulated training time and the
accounted ε.  Batches are sampled on the host with the reference's NumPy
sampler, so one seed feeds both packages the same batches.  The compiled
sweep engine of the reference is not ported yet.

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

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import FLConfig, FLParams, fl_params
from repro_torch.core import fault as fault_lib
from repro_torch.core import plans as plans_lib
from repro_torch.core import rounds as rounds_lib
from repro_torch.data.synthetic import FederatedData, round_batches
from repro_torch.device import resolve_device
from repro_torch.models.mlp import auc_roc
from repro_torch.models.spec import ModelSpec, get_model_spec, meta_for
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
    (code 2) pays two edge hops of ``hier_comm_frac`` of the WAN hop."""
    pr = fl_params(fl) if params is None else params
    sel = sel_mask > 0
    zero = torch.zeros_like(sel_mask)
    steps = fl.local_epochs
    compute = steps * base_step_time / torch.clamp(util_state.compute, min=0.1)
    if slow is not None:
        compute = compute * slow
    slowest = torch.max(torch.where(sel, compute, zero))
    comm_full = comm_time * (1.0 + param_kb / 1024.0)

    t = slowest + comm_full
    if fl.dp_enabled:
        t = t + 0.01  # clip+noise pass
    n_failed_sel = torch.sum(torch.where(sel, failed, zero))
    if fl.fault_tolerance:
        t = t + ckpt_write * max(1, steps // 2)
        t = t + n_failed_sel * fault_lib.recovery_overhead(pr.recovery_time)
    else:
        # failed clients redo the whole round next time: amortised penalty
        t = t + n_failed_sel * slowest

    code = float(pr.plan_code)
    if code == 1.0:
        arrivals = torch.sort(torch.where(sel, compute,
                                          torch.full_like(compute, math.inf))
                              ).values
        k_idx = int(min(max(float(pr.async_buffer), 1.0),
                        float(sel_mask.shape[0]))) - 1
        t = torch.minimum(arrivals[k_idx], slowest) + comm_full
        if fl.dp_enabled:
            t = t + 0.01
    elif code == 2.0:
        t = t - comm_full + 2.0 * pr.hier_comm_frac * comm_full
    return torch.where(torch.any(sel), t, torch.full_like(t, comm_time))


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
