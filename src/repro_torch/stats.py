"""Nonparametric statistics: the port's copy of ``repro/stats.py``.

The one-sided Mann-Whitney U test is the paper's comparison (Table III);
the port's card-side checks use it without importing the reference.
:func:`mannwhitney_two_sided` builds the two-sided test from it, and
:func:`compare_finals` applies that to two sets of per-seed finals (the
own-RNG distribution check of ``tests/test_torch_rng_distribution.py`` and
``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple


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


def mannwhitney_two_sided(a: Sequence[float], b: Sequence[float]) -> float:
    """Two-sided Mann-Whitney p-value from the one-sided test in both
    directions: ``min(1, 2·min(p(a > b), p(b > a)))``."""
    p_ab = mannwhitney_greater(a, b)[1]
    p_ba = mannwhitney_greater(b, a)[1]
    return min(1.0, 2.0 * min(p_ab, p_ba))


def compare_finals(rows: Sequence[Mapping[str, float]],
                   ref_rows: Sequence[Mapping[str, float]],
                   keys: Sequence[str] = ("accuracy", "auc", "mean_k")
                   ) -> Dict[str, Tuple[float, float, float]]:
    """Per key, ``(median of rows, median of ref_rows, two-sided p)`` of
    per-seed finals (one mapping a seed)."""
    import numpy as np

    out = {}
    for k in keys:
        a, b = [r[k] for r in rows], [r[k] for r in ref_rows]
        out[k] = (float(np.median(a)), float(np.median(b)),
                  mannwhitney_two_sided(a, b))
    return out
