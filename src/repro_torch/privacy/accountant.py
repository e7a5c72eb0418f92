"""Rényi-DP accounting for the subsampled Gaussian mechanism: the host
(NumPy, f64) half of ``repro/privacy/accountant.py``.

RDP of one Gaussian release at order α is ``α / (2 z²)``; with sampling
fraction q the small-q amplification bound ``min(α/(2z²), 2 q² α / z²)``.
Conversion to (ε, δ) uses ``ε = RDP(α) + log1p(-1/α) − (log δ + log α)/(α−1)``
minimised over a fixed order grid.  The same NumPy operations as the
reference, so both give the same ε to the bit.  The in-loop accountant for
scheduled budgets is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

ORDERS = tuple([1.25, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0,
                16.0, 20.0, 32.0, 48.0, 64.0, 128.0, 256.0])


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


def compose_epsilon(noise_multiplier: float, q: float, steps: int,
                    delta: float, orders=ORDERS) -> float:
    """ε after ``steps`` releases at constant z and q."""
    if steps <= 0:
        return 0.0
    rdp = steps * rdp_subsampled_gaussian(noise_multiplier, min(q, 1.0),
                                          orders)
    return rdp_to_dp(rdp, delta, orders)[0]


def accounted_epsilon(fl, rounds: int) -> float:
    """DP budget spent by a fixed-σ run of ``rounds`` rounds of ``fl``."""
    if not fl.dp_enabled:
        return 0.0
    if fl.dp_scheduled:
        raise ValueError(
            "dp_scheduled runs report ε from an in-loop accountant, which "
            "the PyTorch port does not have yet")
    from repro_torch.core import dp as dp_lib

    sigma = (fl.dp_sigma if fl.dp_mode == "paper"
             else dp_lib.gaussian_sigma(fl.dp_epsilon, fl.dp_delta, fl.dp_clip))
    q = fl.clients_per_round / fl.n_clients
    z = max(sigma / max(fl.dp_clip, 1e-9), 1e-3)
    return compose_epsilon(z, q, rounds, fl.dp_delta)
