"""Client selection (paper §IV-A, Algorithm 1): the port's copy of
``repro/core/selection.py``, dense strategies and the population engine's
cohort draw (:func:`cohort_topk`).

Utility scores combine performance contribution, data quality, compute
capacity and a staleness bonus; they drive SelectTopK, and the adaptive
controller grows K on a plateau and shrinks it while improvement is strong.

Where the reference's strategies take a PRNG key, the port's take the
selection variate itself: ``noise [n]``, a standard Gumbel for
``adaptive_utility``/``acfl``/``adafl`` and a uniform for
``random``/``power_of_choice`` (:data:`NOISE_KIND`).  The round step draws
it from its ``torch.Generator``, or a test injects the reference's.

Every function here takes one run's ``[n]`` client vectors or a sweep's
``[L, n]`` lanes of them, reducing over the last axis; the controller's
state is then ``[L]``, and a runtime knob (``explore``, ``fault_w``,
``tol``, ``patience``) a float or a per-lane tensor that broadcasts
against the state (``[L, 1]`` beside ``[L, n]``, ``[L]`` beside ``[L]``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.profiler import record_function

from repro_torch.configs.base import FLConfig

F32_MIN = torch.finfo(torch.float32).min


class UtilityState(NamedTuple):
    """Per-client running statistics (all [n_clients] f32, or
    [L, n_clients] in a sweep)."""

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
                    fault_w=None, data_mean=None) -> torch.Tensor:
    """U_i — the paper's multi-factor utility score,
    F(S_t) = α·Accuracy(S_t) − γ·Cost(S_t); ``fault_w`` penalises the
    per-client failure EMA (0.0 is an exact no-op).  ``data_mean``: the
    mean of ``data_size`` over every client (keepdim), for a caller that
    holds only its share of them."""
    if data_mean is None:
        data_mean = torch.mean(state.data_size, dim=-1, keepdim=True)
    ds = state.data_size / torch.clamp(data_mean, min=1e-9)
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
    top-``k_max`` along the last axis; ``k_eff`` is a number or a tensor of
    ``scores.shape[:-1]`` (one K a lane).  Ties go to the lower index, as
    ``lax.top_k`` breaks them: a stable sort of the negated scores.  A
    fractional ``k_eff`` selects every rank below it (12.5 selects 13)."""
    masked = torch.where(avail > 0, scores, torch.full_like(scores, F32_MIN))
    idx = torch.argsort(-masked, dim=-1, stable=True)[..., :k_max]
    if isinstance(k_eff, torch.Tensor):
        k_eff = k_eff[..., None]
    ranks = torch.arange(k_max, device=scores.device)
    take = (ranks < k_eff).float().expand(idx.shape)
    mask = torch.zeros_like(scores).scatter_(-1, idx, take)
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


def score_adafl(noise, state, utility, avail, explore=0.05, part_max=None):
    """AdaFL: current + historical contribution (``part_max``: the largest
    participation over every client, keepdim, for a caller that holds only
    its share of them)."""
    if part_max is None:
        part_max = torch.amax(state.participation, dim=-1, keepdim=True)
    hist = state.perf_ema + 0.1 * state.participation / torch.clamp(
        part_max, min=1.0)
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
    d = min(2 * k_max, avail.shape[-1])
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


def strategy_names():
    return tuple(_STRATEGIES)


_SCORES = {
    "adaptive_utility": score_adaptive_utility,
    "random": score_random,
    "acfl": score_acfl,
    "adafl": score_adafl,
}


def get_score_fn(name: str) -> Callable:
    """Score function of the population engine's cohort plan.  A strategy
    whose selection is not one score pass (``power_of_choice``: its
    candidate stage needs ``k_max``) has none and raises."""
    try:
        return _SCORES[name]
    except KeyError:
        raise ValueError(
            f"selection strategy {name!r} has no score function — the "
            f"population cohort plan supports {tuple(_SCORES)}") from None


def cohort_strategy_names():
    return tuple(_SCORES)


# ---------------------------------------------------------------------------
# On-device cohort sampling (the population engine)
# ---------------------------------------------------------------------------


def _topk_stable(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis, ties
    to the lower index as ``lax.top_k`` breaks them (``torch.topk`` does not
    promise an order among equals): a stable sort of the negated values."""
    idx = torch.argsort(-x, dim=-1, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx


def cohort_topk(scores: torch.Tensor, avail: torch.Tensor, k_eff, k_max: int,
                chunks: int = 1):
    """Top-``k_max`` cohort of the score lanes ``[L, N]`` (or one run's
    ``[N]``): ``(idx [L, k_max] int64, take [L, k_max] f32)``.

    The index form of :func:`_topk_mask`: scattering ``take`` at ``idx``
    gives its dense mask.  ``take`` zeroes the ranks at or above the
    lane's ``k_eff`` (a number or ``[L]``) and any slot that fell to an
    unavailable client.  ``chunks`` > 1 (with ``N % chunks == 0`` and
    ``N // chunks >= k_max``) takes each chunk's top ``k_max`` and merges
    them; the candidates stand chunk-major, then index-major, which is
    global index order among equal values, so the merge is bitwise the
    unchunked draw."""
    with record_function("cohort_topk"):
        masked = torch.where(avail > 0, scores,
                             torch.full_like(scores, F32_MIN))
        lead, n = masked.shape[:-1], masked.shape[-1]
        chunks = int(chunks)
        if chunks > 1 and n % chunks == 0 and n // chunks >= k_max:
            per = n // chunks
            v, i = _topk_stable(masked.reshape(*lead, chunks, per), k_max)
            i = i + (torch.arange(chunks, device=i.device) * per)[:, None]
            vals, j = _topk_stable(v.reshape(*lead, chunks * k_max), k_max)
            idx = torch.gather(i.reshape(*lead, chunks * k_max), -1, j)
        else:
            vals, idx = _topk_stable(masked, k_max)
        return idx, cohort_take(vals, k_eff, k_max)


def cohort_take(vals: torch.Tensor, k_eff, k_max: int) -> torch.Tensor:
    """The live-slot mask of a cohort whose sorted scores are ``vals
    [..., k_max]``: the ranks below ``k_eff`` (a number or one a row) that
    fell to an available client."""
    if isinstance(k_eff, torch.Tensor):
        k_eff = k_eff[..., None]
    ranks = torch.arange(k_max, device=vals.device)
    return (ranks < k_eff).float() * (vals > F32_MIN)


def cohort_topk_host(scores, avail, k_eff, k_max: int):
    """NumPy oracle of :func:`cohort_topk` (the reference's): a stable sort
    (lower index first among ties) and the same availability masking, over
    the last axis; ``k_eff`` is a number or one a row."""
    import numpy as np
    scores = np.asarray(scores, np.float32)
    neg = np.finfo(np.float32).min
    masked = np.where(np.asarray(avail) > 0, scores, neg).astype(np.float32)
    idx = np.argsort(-masked, axis=-1, kind="stable")[..., :k_max]
    k_eff = np.asarray(k_eff, np.float32)[..., None]
    take = ((np.arange(k_max) < k_eff)
            & (np.take_along_axis(masked, idx, -1) > neg)).astype(np.float32)
    return idx.astype(np.int64), take


# ---------------------------------------------------------------------------
# Adaptive-K controller
# ---------------------------------------------------------------------------


class KControllerState(NamedTuple):
    k: torch.Tensor            # current K (0-d f32, or [L] in a sweep)
    best_metric: torch.Tensor  # best global metric seen
    plateau: torch.Tensor      # consecutive rounds without improvement


def init_k_state(fl: FLConfig, device=None) -> KControllerState:
    return KControllerState(
        k=torch.full((), float(fl.clients_per_round), device=device),
        best_metric=torch.full((), float("inf"), device=device),
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
