"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block: the port's
copy of the prefill path of ``repro/models/ssm.py``.

Chunked SSD: the sequence is split into chunks of length Q; within a chunk
the output is the quadratic "attention-like" masked form, across chunks a
linear recurrence carries the [heads, head_dim, state] SSM state.  That
recurrence is the RG-LRU scan's ``h = a·h + x`` form over the flattened
state (:func:`chunk_scan_via`), so it runs on the ``rglru_scan`` kernel on
the card.  The one-token decode step waits for the LM substrate.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.models.layers import fan_in_init, rmsnorm


def ssd_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or max(1, d_in // cfg.ssm_head_dim)
    return d_in, heads, cfg.ssm_head_dim, cfg.ssm_state


def init_ssd(gen: torch.Generator, cfg) -> dict:
    """Fresh mixer params (f32) on ``gen.device``; the fused input
    projection is ``[z (gate), x, B, C, dt]``."""
    d = cfg.d_model
    d_in, h, p, n = ssd_dims(cfg)
    dev = gen.device
    d_proj = 2 * d_in + 2 * n + h
    return {
        "in_proj": fan_in_init(gen, (d, d_proj)),
        "conv_w": fan_in_init(gen, (cfg.conv_width, d_in + 2 * n)),
        "conv_b": torch.zeros(d_in + 2 * n, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones(h, device=dev),
        "dt_bias": torch.zeros(h, device=dev),
        "norm_scale": torch.ones(d_in, device=dev),
        "out_proj": fan_in_init(gen, (d_in, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + silu over a whole sequence.  x: [b, l, c];
    w: [k, c]."""
    k = w.shape[0]
    pad = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + b
    return F.silu(out)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < m <= i} a[..., m]; −inf above the
    diagonal.  a: [..., q] -> [..., q, q]."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=a.device)[:, None]
    j = torch.arange(q, device=a.device)[None, :]
    return diff.masked_fill(j > i, float("-inf"))


def _project(params, x: torch.Tensor, cfg):
    """Fused input projection -> (z [b,l,d_in], xBC [b,l,d_in+2n],
    dt [b,l,h])."""
    d_in, h, p, n = ssd_dims(cfg)
    proj = torch.einsum("bld,de->ble", x, params["in_proj"])
    z = proj[..., :d_in]
    xbc = proj[..., d_in:2 * d_in + 2 * n]
    dtp = proj[..., 2 * d_in + 2 * n:]
    dt = F.softplus(dtp.float() + params["dt_bias"])
    return z, xbc, dt


def chunk_scan_via(linear_scan: Callable) -> Callable:
    """Adapt an ``(a, x, h0) -> (hs, h_last)`` diagonal linear recurrence
    (``kernels.ops.rglru_scan`` or ``kernels.ref.rglru_scan_ref``) into the
    inter-chunk state scan of :func:`ssd_chunked`: ``s_new = s·dec + st``
    is elementwise over the flattened [h·p·n] state with the per-chunk
    decay broadcast over (p, n).  The returned ``scan_fn(chunk_decay
    [b,nc,h], states [b,nc,h,p,n], s0 [b,h,p,n])`` gives ``(final_state,
    prev_states)``, the state before each chunk's update."""

    def scan_fn(chunk_decay, states, s0):
        b, nc, h, p, n = states.shape
        w = h * p * n
        a = chunk_decay[:, :, :, None, None].expand(states.shape)
        hs, h_last = linear_scan(a.reshape(b, nc, w),
                                 states.reshape(b, nc, w), s0.reshape(b, w))
        prev = torch.cat([s0.reshape(b, 1, w), hs[:, :-1]], dim=1)
        return h_last.reshape(b, h, p, n), prev.reshape(b, nc, h, p, n)

    return scan_fn


def ssd_chunked(x, dt, A, B, C, chunk: int, scan_fn: Callable):
    """x: [b,l,h,p]; dt: [b,l,h]; A: [h] (positive, used as −A); B, C:
    [b,l,n].  Returns (y [b,l,h,p], final_state [b,h,p,n]), starting from
    a zero state.  ``scan_fn`` is the inter-chunk recurrence
    (:func:`chunk_scan_via`)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, l)
    if l % q:
        raise ValueError(f"sequence {l} does not split into chunks of {q}")
    nc = l // q

    dA = (-A) * dt
    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h)
    dAr = dA.reshape(b, nc, q, h)
    Br = B.reshape(b, nc, q, n)
    Cr = C.reshape(b, nc, q, n)

    # intra-chunk (quadratic) term
    L = torch.exp(_segsum(dAr.permute(0, 1, 3, 2)))          # [b,nc,h,q,q]
    CB = torch.einsum("bcin,bcjn->bcij", Cr, Br)             # [b,nc,q,q]
    M = CB[:, :, None] * L
    y_diag = torch.einsum("bchij,bcjh,bcjhp->bcihp", M, dtr, xr)

    # per-chunk final states
    dA_cum = torch.cumsum(dAr, dim=2)                         # [b,nc,q,h]
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = torch.einsum("bcjn,bcjh,bcjh,bcjhp->bchpn", Br, decay_states,
                          dtr, xr)

    # inter-chunk recurrence
    chunk_decay = torch.exp(torch.sum(dAr, dim=2))           # [b,nc,h]
    s0 = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    final_state, prev_states = scan_fn(chunk_decay, states, s0)

    # inter-chunk contribution
    state_decay = torch.exp(dA_cum)
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", Cr, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, final_state


def ssd_block(params, x: torch.Tensor, cfg, scan_fn: Callable):
    """Full Mamba-2 mixer over a whole sequence.  x: [b, l, d] ->
    ([b, l, d], the final SSM state [b,h,p,n] f32)."""
    d_in, h, p, n = ssd_dims(cfg)
    z, xbc, dt = _project(params, x, cfg)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs = xbc[..., :d_in].reshape(x.shape[0], x.shape[1], h, p).float()
    B = xbc[..., d_in:d_in + n].float()
    C = xbc[..., d_in + n:].float()
    A = torch.exp(params["A_log"])
    y, final = ssd_chunked(xs, dt, A, B, C, cfg.ssm_chunk, scan_fn=scan_fn)
    y = y + params["D"][None, None, :, None] * xs
    y = y.reshape(x.shape[0], x.shape[1], d_in).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    out = torch.einsum("ble,ed->bld", y, params["out_proj"])
    return out, final
