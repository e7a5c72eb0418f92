"""Masked weighted aggregation of client updates (the paper's global
server): the stacked half of ``repro/core/aggregation.py``.

w_g ← w_g + server_opt( Σ_i m_i·n_i·Δ̃_i / Σ_i m_i·n_i ), with m_i the
selection×survival mask and n_i the client's normalised sample count.
"""
from __future__ import annotations

import torch


def aggregate_stacked(deltas: torch.Tensor, mask: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """deltas: ``[n, ...]`` with a leading client axis; mask/weights: [n]."""
    w = (mask * weights).float()
    denom = torch.clamp(torch.sum(w), min=1e-9)
    wb = w.reshape((-1,) + (1,) * (deltas.dim() - 1))
    return torch.sum(deltas.float() * wb, dim=0) / denom


def apply_server_update(server_opt, params, opt_state, agg_delta):
    """w_g <- w_g + server_opt(Δ)."""
    return server_opt.update(agg_delta.float(), opt_state, params)
