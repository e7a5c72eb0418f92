"""Pluggable failure processes: the port's copy of ``repro/fault/process.py``.

* ``iid``       (code 0) — per-round Bernoulli(``failure_prob``) failure at a
  uniform local step.
* ``markov``    (code 1) — per-client up/down chain with expected outage
  length ``fault_burst`` and stationary failure rate ``failure_prob``.
* ``weibull``   (code 2) — per-client lifetimes with the discrete Weibull
  hazard, λ calibrated so the steady-state rate is ``failure_prob``.
* ``straggler`` (code 3) — slow clients (``straggler_slow``×), whose
  updates survive.

All four are computed every round and the runtime ``fault_process`` code
picks one, as in the reference.  Where the reference draws from
``fold_in(k_fail, 1..7)``, the port takes the variates as operands:
``u [4, n]`` uniforms (iid Bernoulli, markov, weibull, straggler: folds
1, 3, 5, 7) and ``steps [3, n]`` integer steps in ``[0, local_steps)``
(iid, markov, weibull: folds 2, 4, 6).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class FaultState(NamedTuple):
    """Per-client failure-process state, carried across rounds ([n] f32)."""

    down: torch.Tensor   # Markov outage indicator (1 = client currently down)
    age: torch.Tensor    # Weibull age: rounds survived since last failure


def init_fault_state(n: int, device=None) -> FaultState:
    return FaultState(down=torch.zeros(n, device=device),
                      age=torch.zeros(n, device=device))


def iid_fail_times(u_bern: torch.Tensor, step: torch.Tensor, p,
                   local_steps: int) -> torch.Tensor:
    """Bernoulli(p) failures (``u < p``, as ``jax.random.bernoulli``) at
    ``step``; ``local_steps`` for survivors."""
    return torch.where(u_bern < p, step, torch.full_like(step, local_steps))


def fault_step(state: FaultState, u: torch.Tensor, steps: torch.Tensor, pr,
               n: int, local_steps: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                  FaultState]:
    """One round of the failure-scenario engine.  Returns ``(fail_at [n]
    int, slow [n] f32, new_state)``.  Scalars are taken to f32 first, as the
    reference computes them."""
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32,  # noqa: E731
                                 device=u.device)
    p = f32(pr.failure_prob)
    full = torch.full_like(steps[0], local_steps)

    # --- iid (code 0) --------------------------------------------------------
    fa_iid = iid_fail_times(u[0], steps[0], p, local_steps)

    p_c = torch.clamp(p, 1e-6, 0.999)

    # --- markov (code 1): bursty, correlated outages ------------------------
    burst = torch.maximum(torch.clamp(f32(pr.fault_burst), min=1.0),
                          p_c / (1.0 - p_c))
    stay = 1.0 - 1.0 / burst                       # P(down -> down)
    enter = torch.clamp(p_c / (burst * (1.0 - p_c)), 0.0, 1.0)  # P(up -> down)
    was_down = state.down > 0
    down_next = torch.where(was_down, u[1] < stay, u[1] < enter)
    fa_markov = torch.where(down_next & ~was_down, steps[1],
                            torch.where(down_next, torch.zeros_like(full),
                                        full))

    # --- weibull (code 2): per-client lifetimes, ageing hazard --------------
    k_w = torch.clamp(f32(pr.weibull_shape), min=0.1)
    gamma_1p = torch.exp(torch.lgamma(1.0 + 1.0 / k_w))
    lam = torch.clamp((1.0 / p_c - 0.5) / gamma_1p, min=1e-3)
    a = state.age
    hazard = -torch.expm1((a / lam) ** k_w - ((a + 1.0) / lam) ** k_w)
    fail_w = u[2] < hazard
    fa_weibull = torch.where(fail_w, steps[2], full)

    # --- straggler (code 3): slow, not dead ---------------------------------
    straggler = u[3] < p
    ones = torch.ones(n, device=u.device)
    slow_s = torch.where(straggler,
                         torch.clamp(f32(pr.straggler_slow), min=1.0), ones)

    code = float(pr.fault_process)
    fail_at = (fa_iid if code < 0.5 else fa_markov if code < 1.5
               else fa_weibull if code < 2.5 else full)
    slow = slow_s if code > 2.5 else ones
    new_state = FaultState(down=down_next.float(),
                           age=torch.where(fail_w, torch.zeros_like(a), a + 1.0))
    return fail_at, slow, new_state


def arrival_score(slow, compute):
    """Per-client arrival-order score of the ``buffered_async`` plan."""
    return slow / torch.clamp(compute, min=0.1)
