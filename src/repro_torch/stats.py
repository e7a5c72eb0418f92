"""Nonparametric statistics: the port's copy of ``repro/stats.py``.

The one-sided Mann-Whitney U test is the paper's comparison (Table III);
the port's card-side checks use it without importing the reference.
"""
from __future__ import annotations

from typing import Sequence, Tuple


def mannwhitney_greater(a: Sequence[float], b: Sequence[float],
                        alpha: float = 0.05) -> Tuple[float, float, bool]:
    """One-sided Mann-Whitney U test that ``a``'s distribution is
    stochastically greater than ``b``'s.

    Returns ``(U, p, significant)`` with significance at ``alpha``.  scipy
    is imported here, not with the module, so ``repro_torch`` imports
    without it."""
    from scipy import stats

    u, p = stats.mannwhitneyu(list(a), list(b), alternative="greater")
    return float(u), float(p), bool(p < alpha)
