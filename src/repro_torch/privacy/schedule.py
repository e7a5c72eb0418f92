"""Privacy-budget schedulers: how a total (ε, δ) budget is spent per round
(the port's copy of ``repro/privacy/schedule.py``).

A scheduler turns the runtime budget knobs (``FLParams.dp_budget``,
``dp_sched``, ``dp_sched_rate``, ``dp_stall_tol``) into a per-round noise
multiplier ``z_t`` (σ_t = z_t · clip) for each lane.  Three schedules, all
computed and then selected by the runtime code ``dp_sched``, so the
schedule is a sweep lane, not an option of the code path:

* ``uniform``  (0) — constant z, calibrated so the composed ε over the
  planned rounds meets the budget
  (:func:`~repro_torch.privacy.accountant.noise_multiplier_for_budget_rt`);
* ``linear``   (1) — noise falls linearly from ``(1+rate)·z`` to
  ``(1−rate)·z``;
* ``adaptive`` (2) — starts at the uniform z; each eval block whose AUC
  does not beat the best seen multiplies the noise by ``(1 − rate)``,
  floored at :data:`BOOST_FLOOR`.

Schedules other than ``uniform`` leave exact calibration to the in-loop
accountant and the exhaustion gate (``train/fl_driver.py``): a round whose
release would push ε past ``dp_budget`` is withheld from the global model.
State is ``[L]`` f32 tensors, one value a lane, updated on eval boundaries
only, so σ is constant within an eval block.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import as_f32
from repro_torch.privacy import accountant as acct_lib

SCHEDULES = ("uniform", "linear", "adaptive")

# the noise never drops below this fraction of the calibrated base: one
# stall streak cannot spend the whole budget at once
BOOST_FLOOR = 0.25


def schedule_code(name: str) -> float:
    """Runtime lane value for a schedule name."""
    return float(SCHEDULES.index(name))


class SchedulerState(NamedTuple):
    """Carried per lane through the round loop, each ``[L]`` f32."""

    z_base: torch.Tensor    # budget-calibrated base noise multiplier
    boost: torch.Tensor     # adaptive noise factor in [BOOST_FLOOR, 1]
    best_auc: torch.Tensor  # best validation AUC seen (stall detector)


def init_scheduler(budget: torch.Tensor, grid: acct_lib.OrderGrid,
                   rounds: int, q) -> SchedulerState:
    """Calibrate each lane's base multiplier for its ``budget [L]`` over
    ``rounds`` planned releases at the nominal sampling fraction ``q``, and
    start the adaptive controller at no boost."""
    z = acct_lib.noise_multiplier_for_budget_rt(budget, grid, rounds,
                                                as_f32(q, budget))
    return SchedulerState(z_base=z, boost=torch.ones_like(z),
                          best_auc=torch.zeros_like(z))


def scheduled_multiplier(state: SchedulerState, pr, round_idx: int,
                         rounds: int) -> torch.Tensor:
    """Each lane's noise multiplier z_t at round ``round_idx`` of a plan of
    ``rounds``.  ``pr`` is the runtime :class:`~repro_torch.configs.base.
    FLParams`; every law is computed and ``dp_sched`` selects."""
    z_base = state.z_base
    # t in f32, as the reference divides its i32 round counter
    t = as_f32(float(np.float32(round_idx) / np.float32(max(rounds - 1, 1))),
               z_base)
    z_uniform = z_base
    z_linear = z_base * (1.0 + pr.dp_sched_rate * (1.0 - 2.0 * t))
    z_adaptive = z_base * state.boost
    sched = as_f32(pr.dp_sched, z_base)
    z = torch.where(sched < 0.5, z_uniform,
                    torch.where(sched < 1.5, z_linear, z_adaptive))
    return torch.clamp(z, min=1e-3)


def scheduler_update(state: SchedulerState, auc: torch.Tensor,
                     pr) -> SchedulerState:
    """Eval-boundary update: a block whose AUC fails to beat the best seen
    by ``dp_stall_tol`` is a stall, and each stall shrinks the adaptive
    noise factor by ``(1 − dp_sched_rate)`` down to :data:`BOOST_FLOOR`.
    Uniform and linear lanes carry the same state but never read
    ``boost``."""
    improved = auc > state.best_auc + pr.dp_stall_tol
    boost = torch.where(
        improved, state.boost,
        torch.clamp(state.boost * (1.0 - pr.dp_sched_rate), min=BOOST_FLOOR))
    return SchedulerState(z_base=state.z_base, boost=boost,
                          best_auc=torch.maximum(state.best_auc, auc))
