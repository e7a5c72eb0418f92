"""Masked weighted aggregation of client updates (the paper's global
server): the port's copy of ``repro/core/aggregation.py``.

w_g ← w_g + server_opt( Σ_i m_i·n_i·Δ̃_i / Σ_i m_i·n_i ), with m_i the
selection×survival mask and n_i the client's normalised sample count.
Two layouts:

* stacked  — Δ as ``[..., n, P]`` flat rows (the lane and cohort steps);
* streamed — a running (weighted sum, weight) carry over update trees, one
  client at a time (the ``client_serial`` plan).  The carry is the round's
  own, so :func:`stream_accumulate` and :func:`stream_finalize` write into
  its leaves in place: at an LM's width a second f32 copy of the model
  would not fit beside the first.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


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


def stream_init(params_like, dtype=torch.float32):
    """Zeroed accumulator over ``params_like``'s tree, f32 by default (the
    reference lets a ≥100B config pass bf16), and an f32 weight sum."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params_like)
    return zeros, torch.zeros((), device=tree_leaves(zeros)[0].device)


def stream_accumulate(carry, delta, m_i, n_i):
    """``acc += (m_i·n_i)·Δ`` in f32, rounded to the accumulator's dtype,
    leaf by leaf in place.  Returns the carry."""
    acc, wsum = carry
    w = torch.as_tensor(m_i * n_i, dtype=torch.float32,
                        device=wsum.device)
    tree_map(lambda a, d: a.copy_(a.float() + w * d.float()), acc, delta)
    return acc, wsum + w


def stream_finalize(carry):
    """The weighted mean ``acc / max(Σw, 1e-9)`` in f32.  An f32
    accumulator is divided in place and returned."""
    acc, wsum = carry
    denom = torch.clamp(wsum, min=1e-9)
    return tree_map(lambda a: a.float().div_(denom), acc)


def apply_server_update_tree(server_opt, params, opt_state, agg_delta):
    """w_g <- w_g + server_opt(Δ) over a param tree, each leaf stepped in
    its storage dtype (``optim/optimizers.py`` tree form)."""
    return server_opt.update(tree_map(lambda d: d.float(), agg_delta),
                             opt_state, params)
