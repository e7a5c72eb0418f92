"""Client selection (paper §IV-A, Algorithm 1): the port's copy of the
dense half of ``repro/core/selection.py``.

Utility scores combine performance contribution, data quality, compute
capacity and a staleness bonus; they drive SelectTopK, and the adaptive
controller grows K on a plateau and shrinks it while improvement is strong.

Where the reference's strategies take a PRNG key, the port's take the
selection variate itself: ``noise [n]``, a standard Gumbel for
``adaptive_utility``/``acfl``/``adafl`` and a uniform for
``random``/``power_of_choice`` (:data:`NOISE_KIND`).  The round step draws
it from its ``torch.Generator``, or a test injects the reference's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import FLConfig

F32_MIN = torch.finfo(torch.float32).min


class UtilityState(NamedTuple):
    """Per-client running statistics (all [n_clients] f32)."""

    perf_ema: torch.Tensor          # EMA of local loss improvement
    loss_ema: torch.Tensor          # EMA of local loss (ACFL uncertainty proxy)
    loss_var: torch.Tensor          # EMA of squared loss deviation
    data_size: torch.Tensor         # samples per client (normalised)
    data_quality: torch.Tensor      # label-entropy proxy in [0, 1]
    coherence: torch.Tensor         # EMA of cos(delta_i, aggregated delta)
    compute: torch.Tensor           # relative compute capacity
    comm_cost: torch.Tensor         # relative communication cost
    last_selected: torch.Tensor     # rounds since last participation
    participation: torch.Tensor     # cumulative selection count
    fail_ema: torch.Tensor          # EMA of observed failures when selected


def init_utility_state(n: int, gen: Optional[torch.Generator] = None,
                       data_size=None, data_quality=None, compute=None,
                       comm_cost=None, device=None) -> UtilityState:
    """With ``gen``, ``compute ~ U[0.3, 1)`` and ``comm_cost ~ U[0.2, 1)``
    are drawn from it (on its device), as the reference draws them from its
    key."""
    device = gen.device if gen is not None else device
    ones = torch.ones(n, device=device)
    zeros = torch.zeros(n, device=device)
    if gen is not None:
        if compute is None:
            compute = torch.rand(n, generator=gen, device=device) * 0.7 + 0.3
        if comm_cost is None:
            comm_cost = torch.rand(n, generator=gen, device=device) * 0.8 + 0.2
    return UtilityState(
        perf_ema=zeros,
        loss_ema=ones * 2.0,
        loss_var=ones,
        data_size=ones if data_size is None else data_size,
        data_quality=ones if data_quality is None else data_quality,
        coherence=zeros,
        compute=ones if compute is None else compute,
        comm_cost=ones * 0.5 if comm_cost is None else comm_cost,
        last_selected=zeros,
        participation=zeros,
        fail_ema=zeros,
    )


def compute_utility(state: UtilityState, fl: FLConfig,
                    fault_w=None) -> torch.Tensor:
    """U_i — the paper's multi-factor utility score,
    F(S_t) = α·Accuracy(S_t) − γ·Cost(S_t); ``fault_w`` penalises the
    per-client failure EMA (0.0 is an exact no-op)."""
    ds = state.data_size / torch.clamp(torch.mean(state.data_size), min=1e-9)
    perf = 0.3 * state.perf_ema
    quality = 0.25 * state.data_quality * torch.log1p(ds) + 5.0 * state.coherence
    capacity = state.compute
    staleness = torch.log1p(state.last_selected) * 0.1  # exploration bonus
    cost = state.comm_cost + (1.0 / torch.clamp(capacity, min=0.1)) * 0.5
    base = fl.alpha * (perf + quality + 0.2 * capacity) - fl.gamma * cost + staleness
    if fault_w is None:
        return base
    return base - fault_w * state.fail_ema


# ---------------------------------------------------------------------------
# Strategies — (noise, state, utility, avail, k_eff, k_max, explore) -> mask
# ---------------------------------------------------------------------------


def _topk_mask(scores: torch.Tensor, avail: torch.Tensor, k_eff, k_max: int):
    """Float mask selecting the dynamic top-``k_eff`` of the static
    top-``k_max``.  Ties go to the lower index, as ``lax.top_k`` breaks
    them: a stable sort of the negated scores.  A fractional ``k_eff``
    selects every rank below it (12.5 selects 13)."""
    masked = torch.where(avail > 0, scores, torch.full_like(scores, F32_MIN))
    idx = torch.argsort(-masked, stable=True)[:k_max]
    ranks = torch.arange(k_max, device=scores.device)
    take = (ranks < k_eff).float()
    mask = torch.zeros_like(scores)
    mask[idx] = take
    # never select unavailable clients even if k_eff > #available
    return mask * (avail > 0)


def score_adaptive_utility(noise, state, utility, avail, explore=0.05):
    """Ours: utility with ε-greedy Gumbel exploration noise."""
    return utility + explore * noise


def score_random(noise, state, utility, avail, explore=0.05):
    return noise


def score_acfl(noise, state, utility, avail, explore=0.05):
    """ACFL-style active selection: prefer high loss level & variance."""
    uncertainty = state.loss_ema + torch.sqrt(torch.clamp(state.loss_var, min=0.0))
    return uncertainty + explore * noise


def score_adafl(noise, state, utility, avail, explore=0.05):
    """AdaFL: current + historical contribution."""
    hist = state.perf_ema + 0.1 * state.participation / torch.clamp(
        torch.max(state.participation), min=1.0)
    return hist + explore * noise


def sel_adaptive_utility(noise, state, utility, avail, k_eff, k_max,
                         explore=0.05):
    return _topk_mask(score_adaptive_utility(noise, state, utility, avail,
                                             explore), avail, k_eff, k_max)


def sel_random(noise, state, utility, avail, k_eff, k_max, explore=0.05):
    return _topk_mask(score_random(noise, state, utility, avail, explore),
                      avail, k_eff, k_max)


def sel_acfl(noise, state, utility, avail, k_eff, k_max, explore=0.05):
    return _topk_mask(score_acfl(noise, state, utility, avail, explore),
                      avail, k_eff, k_max)


def sel_power_of_choice(noise, state, utility, avail, k_eff, k_max,
                        explore=0.05):
    """Power-of-choice: sample d=2·k_max candidates, keep highest-loss K."""
    d = min(2 * k_max, avail.shape[0])
    cand = _topk_mask(noise, avail, d, d)
    scores = torch.where(cand > 0, state.loss_ema,
                         torch.full_like(state.loss_ema, F32_MIN))
    return _topk_mask(scores, avail, k_eff, k_max)


def sel_adafl(noise, state, utility, avail, k_eff, k_max, explore=0.05):
    return _topk_mask(score_adafl(noise, state, utility, avail, explore),
                      avail, k_eff, k_max)


_STRATEGIES = {
    "adaptive_utility": sel_adaptive_utility,
    "random": sel_random,
    "acfl": sel_acfl,
    "power_of_choice": sel_power_of_choice,
    "adafl": sel_adafl,
}

# which variate each strategy consumes
NOISE_KIND = {
    "adaptive_utility": "gumbel",
    "random": "uniform",
    "acfl": "gumbel",
    "power_of_choice": "uniform",
    "adafl": "gumbel",
}


def get_strategy(name: str) -> Callable:
    return _STRATEGIES[name]


# ---------------------------------------------------------------------------
# Adaptive-K controller
# ---------------------------------------------------------------------------


class KControllerState(NamedTuple):
    k: torch.Tensor            # current K (0-d f32)
    best_metric: torch.Tensor  # best global metric seen
    plateau: torch.Tensor      # consecutive rounds without improvement


def init_k_state(fl: FLConfig, device=None) -> KControllerState:
    return KControllerState(
        k=torch.tensor(float(fl.clients_per_round), device=device),
        best_metric=torch.tensor(float("inf"), device=device),
        plateau=torch.zeros((), device=device),
    )


def update_k(state: KControllerState, global_loss, fl: FLConfig,
             tol=None, patience=None) -> KControllerState:
    """Grow K on plateau, shrink while improving fast (only once a finite
    best metric exists); clamp to [k_min, k_max]."""
    tol = fl.k_tol if tol is None else tol
    patience = fl.k_patience if patience is None else patience
    k_max = float(fl.k_max or fl.n_clients)
    zero = torch.zeros_like(state.plateau)
    improved = global_loss < state.best_metric * (1.0 - tol)
    plateau = torch.where(improved, zero, state.plateau + 1.0)
    grow = plateau >= patience
    k = torch.where(grow, state.k + torch.clamp(0.25 * state.k, min=1.0),
                    state.k)
    strong = (torch.isfinite(state.best_metric)
              & (global_loss < state.best_metric * (1.0 - 10.0 * tol)))
    k = torch.where(strong & ~grow, k - 1.0, k)
    k = torch.clamp(k, float(fl.k_min), k_max)
    return KControllerState(
        k=k,
        best_metric=torch.minimum(state.best_metric, global_loss),
        plateau=torch.where(grow, zero, plateau),
    )


# ---------------------------------------------------------------------------
# Utility-state update after a round
# ---------------------------------------------------------------------------


def update_utility_state(state: UtilityState, sel_mask, pre_loss, post_loss,
                         fl: FLConfig, coherence=None, attempted=None,
                         failed=None) -> UtilityState:
    """EMA updates from this round's local results; only the clients in
    ``sel_mask`` (the contribution mask) move.  Every ``attempted`` client's
    ``fail_ema`` moves toward its ``failed`` outcome."""
    m = sel_mask > 0
    improvement = torch.clamp(pre_loss - post_loss, min=-1.0)
    e = fl.utility_ema
    perf = torch.where(m, (1 - e) * state.perf_ema + e * improvement,
                       state.perf_ema)
    loss_ema = torch.where(m, (1 - e) * state.loss_ema + e * post_loss,
                           state.loss_ema)
    dev = (post_loss - loss_ema) ** 2
    loss_var = torch.where(m, (1 - e) * state.loss_var + e * dev,
                           state.loss_var)
    coh = state.coherence
    if coherence is not None:
        coh = torch.where(m, (1 - e) * coh + e * coherence, coh)
    fail_ema = state.fail_ema
    if failed is not None:
        att = (attempted if attempted is not None else sel_mask) > 0
        fail_ema = torch.where(att, (1 - e) * fail_ema + e * failed.float(),
                               fail_ema)
    return state._replace(
        perf_ema=perf,
        loss_ema=loss_ema,
        loss_var=loss_var,
        coherence=coh,
        last_selected=torch.where(m, torch.zeros_like(state.last_selected),
                                  state.last_selected + 1.0),
        participation=state.participation + sel_mask,
        fail_ema=fail_ema,
    )
