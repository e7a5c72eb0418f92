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

On DTensors (a sharded step) the routing runs as DTensor ops, so the aux
loss's means are over the whole batch, and the experts run in one
``local_map`` (:func:`_local_experts`): each rank dispatches its batch
rows to the experts it holds, runs them and combines their outputs into
a partial sum over the expert axes.

A layer may hold a share of its experts, as one card of those that share
the layer by expert parallelism holds them (``cfg.router_experts`` the
router's width, ``cfg.n_experts`` the experts held, the first of them):
it routes over all of the router's experts (the softmax, the top-k, the
capacity and the aux loss at the router's width), computes only its held
experts' part of the output, and renormalises that part by every kept
choice, held or not.  On one card the layer runs without its exchange;
a share on DTensors is not supported.

Device phases (``obs.phase_call``, forward and ``.bwd``): ``moe.route``
(the router product, softmax, top-k, capacity queues and the dispatch
and combine tensors or indices) and ``moe.experts`` (the held experts'
products and activation).  ``MOE_STATS``, the registry's ``moe``
counters, count each layer call from shapes alone: ``calls``, ``routed``
(b·s·k choices) and ``expert_rows`` (held experts × b × capacity, the
rows the expert products compute, padding included).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of, fan_in_init
from repro_torch.models.shardctx import is_dtensor, local_box
from repro_torch.models.sharding import pm
from repro_torch.obs.stats import STATS
from repro_torch.obs.trace import phase_call

MOE_STATS = STATS.counters("moe", calls=0, routed=0, expert_rows=0)


def init_moe(gen, cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    p = {
        "router": pm(fan_in_init(gen, (d, cfg.resolved_router_experts)),
                     "embed", None),
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
              / cfg.resolved_router_experts)
    return max(cap, cfg.experts_per_token, 1)


def _choose(router_w, x, cfg):
    """The router's softmax gates ``[b, s, e]`` f32 over its ``e`` experts,
    the top-k choices in order (expert index ``[b, s]``, its one-hot mask
    ``[b, s, e]`` and its gate ``[b, s]`` each) and the Switch aux loss."""
    e = cfg.resolved_router_experts
    gates = _gates(router_w, x)
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


def _gates(router_w, x):
    """The router's softmax over the experts, f32 ``[b, s, e]``.  On a
    DTensor ``x`` (batch-split, the router whole on every rank) each rank
    gates its own rows in a ``local_map``, and the router's grad is a
    partial sum over the batch axes."""
    if not is_dtensor(x):
        return torch.softmax(torch.einsum("bsd,de->bse", x.float(), router_w),
                             dim=-1)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    if not all(p.is_replicate() for p in router_w.placements):
        raise ValueError(f"router {router_w.placements}: whole on every rank")
    x_pl = tuple(x.placements)
    if any(not (p.is_replicate() or p.is_shard(0)) for p in x_pl):
        raise ValueError(f"moe x {x_pl}: split over its batch only")
    r_pl = tuple(router_w.placements)
    r_grad = tuple(Partial() if p.is_shard() else r for p, r in zip(x_pl, r_pl))
    return local_map(
        lambda xl, rl: torch.softmax(torch.einsum("bsd,de->bse", xl.float(),
                                                  rl), dim=-1),
        (x_pl,), in_placements=(x_pl, r_pl), in_grad_placements=(x_pl, r_grad),
        device_mesh=x.device_mesh)(x, router_w)


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


def _token_slots(masks, c: int):
    """Each choice's keep ``[b, s]`` (its expert's queue under the
    capacity ``c``) and slot ``[b, s]`` (its queue position; a dropped
    choice's is c − 1)."""
    keeps, poss = [], []
    for m, pos in zip(masks, _queue_positions(masks)):
        pos_tok = torch.sum(pos * m, dim=-1).long()
        keep = (pos_tok < c) & (torch.sum(m, dim=-1) > 0)
        keeps.append(keep)
        poss.append(torch.where(keep, pos_tok, c - 1))
    return keeps, poss


def _kept_weight(gvals, keeps) -> torch.Tensor:
    """The renormalising denominator ``[b, s]``: the gates of every kept
    choice, held here or not."""
    return torch.clamp(sum(gv * kp for gv, kp in zip(gvals, keeps)),
                       min=1e-9)


def route(router_w, x, cfg) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Top-k routing with capacity over the router's experts.  x: [b, s, d]
    -> (dispatch [b,s,e,c] 0/1 f32, combine [b,s,e,c] f32, aux loss), e
    the held experts, the combine renormalised over every kept choice."""
    b, s, _ = x.shape
    c = _capacity(cfg, s)
    n = cfg.n_experts
    _, _, masks, gvals, aux = _choose(router_w, x, cfg)
    dispatch = x.new_zeros((b, s, n, c), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    keeps = []
    for m, gv, pos in zip(masks, gvals, _queue_positions(masks)):
        keep = (pos < c) * m
        keeps.append(keep)
        pos_oh = _one_hot_slots(pos[..., :n], c)
        dispatch = dispatch + keep[..., :n, None] * pos_oh
        combine = combine + (keep * gv[..., None])[..., :n, None] * pos_oh
    denom = _kept_weight(gvals, [torch.sum(k, dim=-1) for k in keeps])
    return dispatch, combine / denom[..., None, None], aux


def _slots(router_w, x, cfg, c: int):
    """The scatter dispatch's routing: the choices (``_choose``), each
    one's keep and slot (``_token_slots``), their gates, the
    renormalising denominator and the aux loss."""
    _, idxs, masks, gvals, aux = _choose(router_w, x, cfg)
    keeps, poss = _token_slots(masks, c)
    return idxs, keeps, poss, gvals, _kept_weight(gvals, keeps), aux


def _experts_forward(params, xe: torch.Tensor, cfg) -> torch.Tensor:
    """xe: [e, b, c, d] -> [e, b, c, d] through the per-expert MLPs, the
    device phase ``moe.experts``."""
    return phase_call("moe.experts", lambda z: _experts(params, z, cfg), xe)


def _experts(params, xe: torch.Tensor, cfg) -> torch.Tensor:
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
    """x: [b, s, d] -> ([b, s, d], aux_loss) on the ``impl`` dispatch: the
    held experts' part of the output."""
    if impl not in ("einsum", "scatter"):
        raise ValueError(f"MoE impl {impl!r}: 'einsum' or 'scatter'")
    sharded = is_dtensor(x)
    if sharded and cfg.n_experts != cfg.resolved_router_experts:
        raise ValueError(f"a share of {cfg.n_experts} of "
                         f"{cfg.resolved_router_experts} experts runs on one "
                         "device only, not in a sharded step")
    b, s, _ = x.shape
    MOE_STATS["calls"] += 1
    MOE_STATS["routed"] += b * s * cfg.experts_per_token
    MOE_STATS["expert_rows"] += cfg.n_experts * b * _capacity(cfg, s)
    if sharded:
        return _moe_mlp_sharded(params, x, cfg, impl)
    if impl == "scatter":
        return _moe_mlp_scatter(params, x, cfg)
    dispatch, combine, aux = phase_call(
        "moe.route", lambda y: route(params["router"], y, cfg), x)
    xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)
    ye = _experts_forward(params, xe, cfg)
    return torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), ye), aux


def _moe_mlp_sharded(params, x, cfg, impl: str):
    """:func:`moe_mlp` on DTensors: ``x`` split over batch axes only, the
    experts' weights over expert axes only (``wi``/``wg``/``wo`` dim 0).
    The routing runs as DTensor ops; each rank then dispatches its batch
    rows to its own experts, runs them and combines their outputs (one
    ``local_map``), a partial sum over the expert axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    w_names = [k for k in ("wi", "wg", "wo") if k in params]
    e_dims = {i for i, p in enumerate(params["wi"].placements) if p.is_shard(0)}
    for k in w_names:
        bad = [p for i, p in enumerate(params[k].placements)
               if not (p.is_replicate() or (i in e_dims and p.is_shard(0)))]
        if bad:
            raise ValueError(f"moe {k} {params[k].placements}: only the "
                             "expert dim may be split in a sharded step")
    b_dims = {i for i, p in enumerate(x.placements) if p.is_shard(0)}
    if b_dims & e_dims or any(not (p.is_replicate() or p.is_shard(0))
                              for p in x.placements):
        raise ValueError(f"moe x {x.placements} on experts split "
                         f"{params['wi'].placements}")
    ((e_local, *_), (e0, *_)) = local_box(params["wi"].shape, mesh,
                                          params["wi"].placements)

    def pl(b_dim, e_dim=None, other=Replicate()):
        """``Shard(b_dim)`` on the batch axes; on the expert axes
        ``Shard(e_dim)``, or ``other`` for a tensor without an expert
        dim; ``Replicate()`` elsewhere."""
        def one(i):
            if i in b_dims:
                return Shard(b_dim)
            if i in e_dims:
                return other if e_dim is None else Shard(e_dim)
            return Replicate()
        return tuple(one(i) for i in range(mesh.ndim))

    x_pl = pl(0)
    out_pl = pl(0, other=Partial())
    w_pls = tuple(tuple(params[k].placements) for k in w_names)
    weights = [params[k] for k in w_names]
    # grads of the local pieces: a weight's sums its rank's batch rows
    # (partial over the batch axes); x's and a token's gate sum the rank's
    # experts' shares (partial over the expert axes)
    w_grads = tuple(tuple(Partial() if i in b_dims else p
                          for i, p in enumerate(w)) for w in w_pls)
    x_grad = pl(0, other=Partial())
    if impl == "einsum":
        dispatch, combine, aux = route(params["router"], x, cfg)
        # each rank's slice of the experts (a local chunk, no traffic)
        dispatch = dispatch.redistribute(mesh, pl(0, 2))
        combine = combine.redistribute(mesh, pl(0, 2))

        def local(disp, comb, xl, *ws):
            p = dict(zip(w_names, ws))
            xe = torch.einsum("bsec,bsd->ebcd", disp.to(xl.dtype), xl)
            ye = _experts_forward(p, xe, cfg)
            return torch.einsum("bsec,ebcd->bsd", comb.to(xl.dtype), ye)

        out = local_map(local, (out_pl,),
                        in_placements=(pl(0, 2), pl(0, 2), x_pl) + w_pls,
                        in_grad_placements=(pl(0, 2), pl(0, 2), x_grad)
                        + w_grads,
                        device_mesh=mesh)(dispatch, combine, x, *weights)
        return out, aux

    c = _capacity(cfg, x.shape[1])
    idxs, keeps, poss, gvals, weights_sum, aux = _slots(params["router"], x,
                                                        cfg, c)
    k = len(idxs)
    tok_pl = pl(0)

    def local_scatter(xl, *rest):
        ws, rest = rest[:len(w_names)], rest[len(w_names):]
        il, kl, ql, gl = rest[:k], rest[k:2 * k], rest[2 * k:3 * k], rest[3 * k:]
        return _scatter_experts(dict(zip(w_names, ws)), xl, il, kl, ql, gl,
                                e0, e_local, c, cfg)

    out = local_map(local_scatter, (out_pl,),
                    in_placements=(x_pl,) + w_pls + (tok_pl,) * (4 * k),
                    in_grad_placements=(x_grad,) + w_grads
                    + (tok_pl,) * (3 * k) + (x_grad,) * k,
                    device_mesh=mesh)(x, *weights, *idxs, *keeps, *poss,
                                      *gvals)
    return out / weights_sum[..., None].to(x.dtype), aux


def _scatter_experts(p, x, idxs, keeps, poss, gvals, e0: int, n: int, c: int,
                     cfg):
    """The part of the output ``[b, s, d]`` that the experts ``[e0, e0 +
    n)`` give, before the renormalisation: each kept choice of one of them
    added into its slot of the ``[n, b, c, d]`` buffers, the experts run,
    and each gathered back at its gate.  Any other choice adds an exact
    zero into a slot and takes nothing back."""
    b, s, d = x.shape
    bi = torch.arange(b, device=x.device)[:, None].expand(b, s)
    xe = x.new_zeros((n, b, c, d))
    mine = []
    for idx, keep, pos in zip(idxs, keeps, poss):
        rel = idx - e0
        here = keep & (rel >= 0) & (rel < n)
        mine.append((rel.clamp(0, n - 1), here, pos))
        contrib = torch.where(here[..., None], x, torch.zeros_like(x))
        xe = xe.index_put((mine[-1][0], bi, pos), contrib, accumulate=True)
    ye = _experts_forward(p, xe, cfg)
    outs = []
    for (rel, here, pos), gv in zip(mine, gvals):
        got = ye[rel, bi, pos]
        outs.append(got * (gv * here)[..., None].to(got.dtype))
    return sum(outs)


def _moe_mlp_scatter(params, x: torch.Tensor, cfg):
    """Scatter/gather dispatch: the routing of :func:`route`, the tokens
    of the held experts added into ``[e, b, c, d]`` buffers and gathered
    back by index."""
    c = _capacity(cfg, x.shape[1])
    idxs, keeps, poss, gvals, denom, aux = phase_call(
        "moe.route", lambda y: _slots(params["router"], y, cfg, c), x)
    out = _scatter_experts(params, x, idxs, keeps, poss, gvals, 0,
                           cfg.n_experts, c, cfg)
    return out / denom[..., None].to(x.dtype), aux
