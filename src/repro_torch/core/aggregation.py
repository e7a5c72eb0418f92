"""Masked weighted aggregation of client updates (the paper's global
server): the stacked half of ``repro/core/aggregation.py``.

w_g ← w_g + server_opt( Σ_i m_i·n_i·Δ̃_i / Σ_i m_i·n_i ), with m_i the
selection×survival mask and n_i the client's normalised sample count.
"""
from __future__ import annotations

import torch


def aggregate_stacked(deltas: torch.Tensor, mask: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """The weighted mean over the client axis, the last axis of ``mask``
    and ``weights`` (``[n]``, or ``[L, n]`` for a sweep's lanes, each lane
    its own mean); ``deltas`` is ``mask.shape + update shape``."""
    w = (mask * weights).float()
    denom = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    tail = (1,) * (deltas.dim() - w.dim())
    return (torch.sum(deltas.float() * w.reshape(w.shape + tail),
                      dim=w.dim() - 1) / denom.reshape(denom.shape + tail))


def apply_server_update(server_opt, params, opt_state, agg_delta):
    """w_g <- w_g + server_opt(Δ)."""
    return server_opt.update(agg_delta.float(), opt_state, params)
