"""Rényi-DP accounting for the subsampled Gaussian mechanism: the port's
copy of ``repro/privacy/accountant.py``.

Two faces of the same math:

* **Host (NumPy, f64)** — :class:`RdpAccountant`, :func:`compose_epsilon`,
  :func:`noise_multiplier_for_budget`, :func:`accounted_epsilon`: exact
  composition for reporting, calibration and offline verification.  The
  same NumPy operations as the reference, so both give the same ε to the
  bit.
* **In-loop (torch, f32)** — :class:`AccountantState` +
  :func:`accountant_step` + :func:`epsilon_from_state`: the accountant as
  state carried through the sweep engine's round loop, one row a lane
  (``[L, n_orders]``).  The noise multiplier ``z`` and the sampling
  fraction ``q`` are ``[L]`` device tensors (scheduler output, adaptive-K
  cohort size).  The RDP vector is summed with Neumaier compensation (two
  f32 arrays), which keeps the composed sum within one f32 rounding of the
  total over hundreds of rounds.  The order grid and its (ε, δ)
  conversion constants are folded on the host in f64, cast to f32 and put
  on the device once, as an :class:`OrderGrid`, so the loop makes no
  host-to-device copy; the reference's in-scan functions take ``delta``
  (and ``orders``) where these take the grid.

RDP of one release at order α is ``α / (2 z²)``; with sampling fraction q
the small-q amplification bound ``min(α/(2z²), 2 q² α / z²)``.  Conversion
to (ε, δ) uses ``ε = RDP(α) + log1p(-1/α) − (log δ + log α)/(α−1)``
minimised over a fixed order grid.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

ORDERS = tuple([1.25, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0,
                16.0, 20.0, 32.0, 48.0, 64.0, 128.0, 256.0])


# ---------------------------------------------------------------------------
# Host side (NumPy, f64) — reporting, calibration, offline verification
# ---------------------------------------------------------------------------


def rdp_gaussian(noise_multiplier: float, orders=ORDERS) -> np.ndarray:
    """RDP of one Gaussian release: eps(alpha) = alpha / (2 z^2)."""
    a = np.asarray(orders, dtype=np.float64)
    return a / (2.0 * noise_multiplier**2)


def rdp_subsampled_gaussian(noise_multiplier: float, q: float,
                            orders=ORDERS) -> np.ndarray:
    """Small-q amplification bound, never worse than no amplification."""
    base = rdp_gaussian(noise_multiplier, orders)
    a = np.asarray(orders, dtype=np.float64)
    amplified = 2.0 * (q**2) * a / (noise_multiplier**2)
    return np.minimum(base, amplified)


def conversion_consts(delta: float, orders=ORDERS) -> np.ndarray:
    """Order-dependent part of the RDP→(ε, δ) bound."""
    a = np.asarray(orders, dtype=np.float64)
    return np.log1p(-1.0 / a) - (np.log(delta) + np.log(a)) / (a - 1.0)


def rdp_to_dp(rdp: np.ndarray, delta: float, orders=ORDERS) -> Tuple[float, float]:
    """Convert composed RDP curve to (epsilon, best_order)."""
    a = np.asarray(orders, dtype=np.float64)
    eps = rdp + conversion_consts(delta, orders)
    i = int(np.argmin(eps))
    return float(eps[i]), float(a[i])


class RdpAccountant:
    """Tracks cumulative privacy loss over communication rounds (host)."""

    def __init__(self, delta: float, orders=ORDERS):
        self.delta = delta
        self.orders = orders
        self._rdp = np.zeros(len(orders), dtype=np.float64)
        self.steps = 0

    def step(self, noise_multiplier: float, q: float = 1.0):
        if q >= 1.0:
            self._rdp += rdp_gaussian(noise_multiplier, self.orders)
        else:
            self._rdp += rdp_subsampled_gaussian(noise_multiplier, q,
                                                 self.orders)
        self.steps += 1

    def epsilon(self) -> float:
        if self.steps == 0:
            return 0.0
        return rdp_to_dp(self._rdp, self.delta, self.orders)[0]


def compose_epsilon(noise_multiplier: float, q: float, steps: int,
                    delta: float, orders=ORDERS) -> float:
    """ε after ``steps`` releases at constant z and q."""
    if steps <= 0:
        return 0.0
    rdp = steps * rdp_subsampled_gaussian(noise_multiplier, min(q, 1.0),
                                          orders)
    return rdp_to_dp(rdp, delta, orders)[0]


def noise_multiplier_for_budget(epsilon: float, delta: float, rounds: int,
                                q: float = 1.0) -> float:
    """Smallest z such that ``rounds`` compositions stay within (ε, δ):
    geometric bisection over the closed-form composition, returning the
    side that satisfies the budget (ε(z) ≤ epsilon)."""
    lo, hi = 1e-2, 1e4
    for _ in range(80):
        mid = math.sqrt(lo * hi)
        if compose_epsilon(mid, q, rounds, delta) > epsilon:
            lo = mid
        else:
            hi = mid
    return hi


def accounted_epsilon(fl, rounds: int) -> float:
    """DP budget spent by a fixed-σ run of ``rounds`` rounds of ``fl``.
    Scheduled runs vary σ and the cohort per round, so their ε comes from
    the in-loop accountant's trace (``RunResult.history["eps"]``)."""
    if not fl.dp_enabled:
        return 0.0
    if fl.dp_scheduled:
        raise ValueError(
            "dp_scheduled runs report ε from the in-loop accountant "
            "(RunResult.history['eps']), not from a host-side closed form")
    from repro_torch.core import dp as dp_lib

    sigma = (fl.dp_sigma if fl.dp_mode == "paper"
             else dp_lib.gaussian_sigma(fl.dp_epsilon, fl.dp_delta, fl.dp_clip))
    q = fl.clients_per_round / fl.n_clients
    z = max(sigma / max(fl.dp_clip, 1e-9), 1e-3)
    return compose_epsilon(z, q, rounds, fl.dp_delta)


# ---------------------------------------------------------------------------
# In-loop side (torch, f32) — the accountant as the round loop's state
# ---------------------------------------------------------------------------


class OrderGrid(NamedTuple):
    """The order grid and its (ε, δ) conversion constants as f32 tensors
    ``[n_orders]`` on one device (folded on the host in f64)."""

    orders: torch.Tensor
    const: torch.Tensor


def order_grid(delta: float, device=None, orders=ORDERS) -> OrderGrid:
    """:class:`OrderGrid` for ``delta`` on ``device``; made once, before
    the round loop (it copies from the host)."""
    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float64).astype(np.float32),
                               device=device)

    return OrderGrid(orders=f32(orders), const=f32(conversion_consts(delta,
                                                                     orders)))


class AccountantState(NamedTuple):
    """The cumulative RDP curve of ``L`` lanes.  ``rdp``/``rdp_c`` are the
    Neumaier (sum, carry) pair per order, ``[L, n_orders]`` f32:
    ``rdp + rdp_c`` is the composed RDP to about one ulp of the total;
    ``steps [L]`` int32 counts the committed releases."""

    rdp: torch.Tensor
    rdp_c: torch.Tensor
    steps: torch.Tensor


def init_accountant_state(lanes: int, device=None,
                          orders=ORDERS) -> AccountantState:
    n = len(orders)
    return AccountantState(
        rdp=torch.zeros(lanes, n, device=device),
        rdp_c=torch.zeros(lanes, n, device=device),
        steps=torch.zeros(lanes, dtype=torch.int32, device=device))


def rdp_increment(noise_multiplier: torch.Tensor, q: torch.Tensor,
                  grid: OrderGrid) -> torch.Tensor:
    """One release's RDP vector, ``[..., n_orders]`` for z and q of shape
    ``[...]``.  At q = 1 the amplified term is never the min, so the
    elementwise minimum is the unamplified bound without a branch."""
    a = grid.orders
    z2 = torch.square(torch.clamp(noise_multiplier, min=1e-6))[..., None]
    base = a / (2.0 * z2)
    amplified = (2.0 * torch.square(q))[..., None] * a / z2
    return torch.minimum(base, amplified)


def accountant_step(state: AccountantState, noise_multiplier, q,
                    grid: OrderGrid) -> AccountantState:
    """Compose one release into every lane's state (Neumaier two-sum)."""
    inc = rdp_increment(noise_multiplier, q, grid)
    s = state.rdp + inc
    larger = torch.abs(state.rdp) >= torch.abs(inc)
    big = torch.where(larger, state.rdp, inc)
    small = torch.where(larger, inc, state.rdp)
    return AccountantState(rdp=s, rdp_c=state.rdp_c + ((big - s) + small),
                           steps=state.steps + 1)


def epsilon_from_state(state: AccountantState,
                       grid: OrderGrid) -> torch.Tensor:
    """(ε, δ) of each lane's composed curve ``[L]``; 0 before any
    release."""
    eps = (state.rdp + state.rdp_c) + grid.const
    return torch.where(state.steps > 0, eps.amin(dim=-1),
                       torch.zeros_like(eps[..., 0]))


def composed_epsilon_rt(noise_multiplier, q, steps: int,
                        grid: OrderGrid) -> torch.Tensor:
    """ε after ``steps`` releases at constant z and q (device twin of
    :func:`compose_epsilon`)."""
    eps = steps * rdp_increment(noise_multiplier, q, grid) + grid.const
    return eps.amin(dim=-1)


def noise_multiplier_for_budget_rt(epsilon: torch.Tensor, grid: OrderGrid,
                                   rounds: int, q,
                                   iters: int = 60) -> torch.Tensor:
    """Device twin of :func:`noise_multiplier_for_budget`: ``iters`` steps
    of geometric bisection on every lane at once, by ``torch.where`` (no
    host synchronisation), so a whole budget grid calibrates together.
    ``epsilon`` (the total budget) and ``q`` are ``[L]`` tensors.  Returns
    the budget-satisfying side."""
    lo = torch.full_like(epsilon, 1e-2)
    hi = torch.full_like(epsilon, 1e4)
    for _ in range(iters):
        mid = torch.sqrt(lo * hi)
        over = composed_epsilon_rt(mid, q, rounds, grid) > epsilon
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    return hi
