"""Mixture-of-Experts layer: the port's copy of ``repro/models/moe.py``.

Top-k routing (top-1 for Llama-4 Maverick, top-2 for Phi-3.5-MoE) by
iterative ``argmax``, the Switch load-balance aux loss, a capacity of
``_capacity`` slots an expert a sequence (a token's position in its
expert's queue by cumsum; a token past it is dropped), and the gates
renormalised over the kept experts.  Two dispatches, as in the reference:

- ``"einsum"``: the GShard one-hot ``dispatch``/``combine`` tensors
  ``[b, s, e, c]`` and two einsums, ``bsec,bsd->ebcd`` and back;
- ``"scatter"``: tokens added into the ``[e, b, c, d]`` expert buffers
  with ``index_put(…, accumulate=True)`` and gathered back by index.  A
  kept token owns its slot alone (the two choices' queues of an expert
  follow one another), and a dropped one adds an exact zero into slot
  c − 1, so the sum is the same in any order.

The router is f32, the experts' ``wi``/``wg``/``wo`` in ``cfg.dtype``;
their fan-in is the reference's (``shape[0]``: the expert count for
``wi``/``wg``, ``d_ff`` for ``wo``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of, fan_in_init
from repro_torch.models.sharding import pm


def init_moe(gen, cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    p = {
        "router": pm(fan_in_init(gen, (d, e)), "embed", None),
        "wi": pm(fan_in_init(gen, (e, d, f), dtype=dt),
                 "experts", "embed", "mlp"),
        "wo": pm(fan_in_init(gen, (e, f, d), fan_in=f, dtype=dt),
                 "experts", "mlp", "embed"),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = pm(fan_in_init(gen, (e, d, f), dtype=dt),
                     "experts", "embed", "mlp")
    return p


def _capacity(cfg, tokens_per_group: int) -> int:
    cap = int(cfg.capacity_factor * tokens_per_group * cfg.experts_per_token
              / cfg.n_experts)
    return max(cap, cfg.experts_per_token, 1)


def _choose(router_w, x, cfg):
    """The router's softmax gates ``[b, s, e]`` f32, the top-k choices in
    order (expert index ``[b, s]``, its one-hot mask ``[b, s, e]`` and its
    gate ``[b, s]`` each) and the Switch aux loss."""
    e = cfg.n_experts
    gates = torch.softmax(torch.einsum("bsd,de->bse", x.float(), router_w),
                          dim=-1)
    idxs: List[torch.Tensor] = []
    masks: List[torch.Tensor] = []
    gvals: List[torch.Tensor] = []
    g = gates
    for _ in range(cfg.experts_per_token):
        idx = torch.argmax(g, dim=-1)
        m = F.one_hot(idx, e).float()
        idxs.append(idx)
        masks.append(m)
        gvals.append(torch.sum(g * m, dim=-1))
        g = g * (1.0 - m)
    # load-balance aux loss (Switch): e * sum_e fraction_e * prob_e
    frac = torch.mean(masks[0], dim=(0, 1))
    prob = torch.mean(gates, dim=(0, 1))
    aux = e * torch.sum(frac * prob) * cfg.router_aux_coef
    return gates, idxs, masks, gvals, aux


def _queue_positions(masks):
    """Each choice's position ``[b, s, e]`` in its expert's queue: the
    cumsum of its mask after every earlier choice's tokens."""
    prior = torch.zeros_like(masks[0][:, :1])
    out = []
    for m in masks:
        out.append(torch.cumsum(m, dim=1) - m + prior)
        prior = prior + torch.sum(m, dim=1, keepdim=True)
    return out


def _one_hot_slots(pos: torch.Tensor, c: int) -> torch.Tensor:
    """``jax.nn.one_hot(pos, c)``: all zeros where ``pos`` ≥ c."""
    return (pos[..., None] == torch.arange(c, device=pos.device)).float()


def route(router_w, x, cfg) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Top-k routing with capacity.  x: [b, s, d] -> (dispatch [b,s,e,c]
    0/1 f32, combine [b,s,e,c] f32, aux loss)."""
    b, s, _ = x.shape
    c = _capacity(cfg, s)
    _, _, masks, gvals, aux = _choose(router_w, x, cfg)
    dispatch = x.new_zeros((b, s, cfg.n_experts, c), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    for m, gv, pos in zip(masks, gvals, _queue_positions(masks)):
        keep = (pos < c) * m
        pos_oh = _one_hot_slots(pos, c)
        dispatch = dispatch + keep[..., None] * pos_oh
        combine = combine + (keep * gv[..., None])[..., None] * pos_oh
    # renormalise the top-k gates over the kept experts
    denom = torch.sum(combine, dim=(2, 3), keepdim=True)
    return dispatch, combine / torch.clamp(denom, min=1e-9), aux


def _experts_forward(params, xe: torch.Tensor, cfg) -> torch.Tensor:
    """xe: [e, b, c, d] -> [e, b, c, d] through the per-expert MLPs."""
    h = torch.einsum("ebcd,edf->ebcf", xe, params["wi"])
    if "wg" in params:
        g = torch.einsum("ebcd,edf->ebcf", xe, params["wg"])
        act = (F.silu(g) if cfg.act == "swiglu"
               else F.gelu(g, approximate="tanh"))
        h = act * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("ebcf,efd->ebcd", h, params["wo"])


def moe_mlp(params, x: torch.Tensor, cfg, impl: str = "einsum"):
    """x: [b, s, d] -> ([b, s, d], aux_loss) on the ``impl`` dispatch."""
    if impl == "scatter":
        return _moe_mlp_scatter(params, x, cfg)
    if impl != "einsum":
        raise ValueError(f"MoE impl {impl!r}: 'einsum' or 'scatter'")
    dispatch, combine, aux = route(params["router"], x, cfg)
    xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)
    ye = _experts_forward(params, xe, cfg)
    return torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), ye), aux


def _moe_mlp_scatter(params, x: torch.Tensor, cfg):
    """Scatter/gather dispatch: the routing of :func:`route`, the tokens
    added into ``[e, b, c, d]`` buffers and gathered back by index."""
    b, s, d = x.shape
    c = _capacity(cfg, s)
    _, idxs, masks, gvals, aux = _choose(params["router"], x, cfg)
    keeps, poss = [], []
    for m, pos in zip(masks, _queue_positions(masks)):
        pos_tok = torch.sum(pos * m, dim=-1).long()  # [b, s]
        keep = (pos_tok < c) & (torch.sum(m, dim=-1) > 0)
        keeps.append(keep)
        poss.append(torch.where(keep, pos_tok, c - 1))
    bi = torch.arange(b, device=x.device)[:, None].expand(b, s)
    xe = x.new_zeros((cfg.n_experts, b, c, d))
    for idx, keep, pos in zip(idxs, keeps, poss):
        contrib = torch.where(keep[..., None], x, torch.zeros_like(x))
        xe = xe.index_put((idx, bi, pos), contrib, accumulate=True)
    ye = _experts_forward(params, xe, cfg)
    # gather back + gate-weighted combine (renormalised over kept experts)
    outs, weights = [], []
    for idx, keep, pos, gv in zip(idxs, keeps, poss, gvals):
        got = ye[idx, bi, pos]  # [b, s, d]
        w = gv * keep
        outs.append(got * w[..., None].to(got.dtype))
        weights.append(w)
    denom = torch.clamp(sum(weights), min=1e-9)[..., None].to(x.dtype)
    return sum(outs) / denom, aux
