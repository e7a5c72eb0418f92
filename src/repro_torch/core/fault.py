"""Fault tolerance (paper §IV "Handling training failures"): the port's copy
of ``repro/core/fault.py``.

* Client failures follow a Weibull distribution (paper eq.):
      p_f(t_c) = 1 - exp(-(t_c / λ)^k)
* Total overhead balancing checkpoint cost vs recovery cost:
      C(t_c) = t_c/T + p_f(t_c) · t_r/T        (paper's cost model)

  The paper's literal C(t_c) increases monotonically in t_c (both t_c/T
  and p_f(t_c) grow with it), so it has no interior minimum.  The renewal
  form, where a failure loses the work since the last checkpoint and each
  interval pays a write cost w,
      C_w(t_c) = [ w + p_f(t_c) · (t_c/2 + t_r) ] / t_c
  has one, and recovers Young/Daly t_c* ≈ sqrt(2·w·MTBF) for exponential
  failures.  Both are here (``write_cost=None`` is the paper's).
* t_c* minimises C by golden-section search on a bracket.

This module is the HOST-SIDE half of the fault subsystem: the cost model,
the interval search and the MLE Weibull fit run in NumPy float64 and are
bitwise the reference's; :func:`recovery_overhead` is the term the
simulated round time charges; :class:`FailureModel` samples failures for
host-side simulations from an explicit ``torch.Generator``.  Per-round
failure injection inside the engines lives in ``repro_torch/fault/
process.py``; ``repro_torch.fault`` re-exports both halves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def weibull_failure_prob(t_c, lam: float, k: float):
    """p_f(t_c) = 1 - exp(-(t_c/λ)^k)."""
    t = np.asarray(t_c, dtype=np.float64)
    return 1.0 - np.exp(-((t / lam) ** k))


def recovery_overhead(recovery_time, frac: float = 0.01):
    """Per-failed-client recovery term of the simulated round time: a
    checkpoint restart resumes near the failure point, so only
    ``frac·t_r`` is charged per failure."""
    return recovery_time * frac


def checkpoint_cost(t_c, T: float, t_r: float, lam: float, k: float,
                    write_cost: Optional[float] = None):
    """Paper cost model C(t_c) = t_c/T + p_f(t_c)·t_r/T (write_cost=None),
    or the renewal model (module docstring) with write cost w:
    C_w(t_c) = [w + p_f(t_c)·(t_c/2 + t_r)] / t_c."""
    t = np.asarray(t_c, dtype=np.float64)
    pf = weibull_failure_prob(t, lam, k)
    if write_cost is None:
        return t / T + pf * t_r / T
    t_safe = np.maximum(t, 1e-9)
    return (write_cost + pf * (t_safe / 2.0 + t_r)) / t_safe


def optimal_checkpoint_interval(T: float, t_r: float, lam: float, k: float,
                                write_cost: Optional[float] = None,
                                bracket: Tuple[float, float] = (1e-3, None)
                                ) -> float:
    """argmin_{t_c} C(t_c) by golden-section search (dC/dt=0 numerically)."""
    lo = bracket[0]
    hi = bracket[1] or max(T, 4.0 * lam)
    gr = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - gr * (b - a)
    d = a + gr * (b - a)
    for _ in range(200):
        if checkpoint_cost(c, T, t_r, lam, k, write_cost) < checkpoint_cost(
            d, T, t_r, lam, k, write_cost
        ):
            b = d
        else:
            a = c
        c = b - gr * (b - a)
        d = a + gr * (b - a)
        if abs(b - a) < 1e-6 * max(1.0, abs(b)):
            break
    return 0.5 * (a + b)


def fit_weibull(samples: Sequence[float], iters: int = 100
                ) -> Tuple[float, float]:
    """MLE for (λ, k) from observed failure inter-arrival times: Newton
    iteration on the profile likelihood for k, λ in closed form."""
    x = np.asarray([s for s in samples if s > 0], dtype=np.float64)
    if x.size < 2:
        return float(np.mean(x) if x.size else 1.0), 1.0
    lx = np.log(x)
    k = 1.0
    for _ in range(iters):
        xk = x**k
        A = np.sum(xk * lx) / np.sum(xk)
        f = 1.0 / k - (A - np.mean(lx))
        B = np.sum(xk * lx * lx) / np.sum(xk) - A**2
        fp = -1.0 / k**2 - B
        step = f / fp
        k_new = k - step
        if not np.isfinite(k_new) or k_new <= 0:
            k_new = k / 2.0
        if abs(k_new - k) < 1e-10:
            k = k_new
            break
        k = k_new
    lam = float(np.mean(x**k) ** (1.0 / k))
    return lam, float(k)


@dataclass
class FailureModel:
    """Per-round failure sampling for HOST-SIDE simulations.

    ``mode='bernoulli'`` draws RandomFailure(p_f) as in Algorithm 1;
    ``mode='weibull'`` samples a failure time within the round of duration
    ``round_time`` from Weibull(λ, k) and fails if it lands inside.

    The reference draws from a JAX key; here each call takes a
    ``torch.Generator`` on ``device`` (``cuda`` unless ``"cpu"`` is asked;
    without a card it raises), so the two agree in distribution, not in
    bits.  The engines' failure processes are ``repro_torch/fault/
    process.py``'s."""

    p_fail: float = 0.05
    mode: str = "bernoulli"
    lam: float = 600.0
    k: float = 1.2
    round_time: float = 30.0
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def sample(self, gen: torch.Generator, n_clients: int) -> torch.Tensor:
        """``[n_clients]`` bool: which clients fail this round."""
        u = torch.rand(n_clients, generator=gen, device=self.device)
        if self.mode == "bernoulli":
            return u < self.p_fail
        u = u * (1.0 - 1e-9) + 1e-9           # uniform on [1e-9, 1)
        t_fail = self.lam * (-torch.log(u)) ** (1.0 / self.k)
        return t_fail < self.round_time

    def failure_step(self, gen: torch.Generator, n_clients: int,
                     local_steps: int) -> torch.Tensor:
        """Uniform step index at which each failing client dies (for
        checkpoint-recovery simulation); ``local_steps`` for survivors."""
        fails = self.sample(gen, n_clients)
        step = torch.randint(0, local_steps, (n_clients,), generator=gen,
                             device=self.device)
        return torch.where(fails, step, torch.full_like(step, local_steps))
