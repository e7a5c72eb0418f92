"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block: the port's
copy of ``repro/models/ssm.py``.

Chunked SSD: the sequence is split into chunks of length Q; within a chunk
the output is the quadratic "attention-like" masked form, across chunks a
linear recurrence carries the [heads, head_dim, state] SSM state.  That
recurrence is the RG-LRU scan's ``h = a·h + x`` form over the flattened
state (:func:`chunk_scan_via`).  By default it runs on the scan's plain
version, chunk by chunk in f32, as the reference's ``lax.scan`` does; the
LM takes that path.  The ``ssm`` detector routes it through the
``rglru_scan`` kernel.

Decode: O(1) per token by the recurrent form
    S_t = exp(dt*A) * S_{t-1} + dt * B_t ⊗ x_t ;  y_t = C_t · S_t + D * x_t
:func:`ssd_decode_step` writes its new state into the cache it is given,
where the reference returns a fresh cache.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as kref
from repro_torch.models import rglru as rglru_lib
from repro_torch.models.layers import (device_of, dtype_of, fan_in_init,
                                       rmsnorm)
from repro_torch.models.sharding import pm


def ssd_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_heads or max(1, d_in // cfg.ssm_head_dim)
    return d_in, heads, cfg.ssm_head_dim, cfg.ssm_state


def init_ssd(gen: Optional[torch.Generator], cfg) -> dict:
    """Fresh mixer params as a ParamMeta tree (the reference's axes) on
    ``gen.device``, or shapes only on the meta device for ``gen`` None:
    ``cfg.dtype``, with ``A_log``, ``D`` and ``dt_bias`` in f32.  The fused
    input projection is ``[z (gate), x, B, C, dt]``.  Drawn in the order
    in_proj, conv_w, out_proj."""
    d = cfg.d_model
    d_in, h, p, n = ssd_dims(cfg)
    dt, dev = dtype_of(cfg), device_of(gen)
    d_proj = 2 * d_in + 2 * n + h
    return {
        "in_proj": pm(fan_in_init(gen, (d, d_proj), dtype=dt),
                      "embed", "mlp"),
        "conv_w": pm(fan_in_init(gen, (cfg.conv_width, d_in + 2 * n),
                                 dtype=dt), None, "mlp"),
        "conv_b": pm(torch.zeros(d_in + 2 * n, dtype=dt, device=dev), "mlp"),
        "A_log": pm(torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
                    None),
        "D": pm(torch.ones(h, device=dev), None),
        "dt_bias": pm(torch.zeros(h, device=dev), None),
        "norm_scale": pm(torch.ones(d_in, dtype=dt, device=dev), "mlp"),
        "out_proj": pm(fan_in_init(gen, (d_in, d), dtype=dt), "mlp", "embed"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """The RG-LRU block's depthwise causal conv, then silu.  Returns (out
    [b, l, c], the new state)."""
    out, new_state = rglru_lib._causal_conv(x, w, b, state)
    return F.silu(out), new_state


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


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None,
                scan_fn: Optional[Callable] = None):
    """x: [b,l,h,p]; dt: [b,l,h]; A: [h] (positive, used as −A); B, C:
    [b,l,n]; ``init_state`` [b,h,p,n] or None for zeros.  Returns (y
    [b,l,h,p], final_state [b,h,p,n]).  ``scan_fn`` is the inter-chunk
    recurrence ``s_new = s·dec + st`` (:func:`chunk_scan_via`); None runs
    it on ``rglru_scan``'s plain version, as the reference's ``lax.scan``."""
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
    s0 = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    if scan_fn is None:
        scan_fn = chunk_scan_via(kref.rglru_scan_ref)
    final_state, prev_states = scan_fn(chunk_decay, states, s0)

    # inter-chunk contribution
    state_decay = torch.exp(dA_cum)
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", Cr, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, final_state


def ssd_block(params, x: torch.Tensor, cfg, state=None,
              scan_fn: Optional[Callable] = None):
    """Full Mamba-2 mixer over a whole sequence.  x: [b, l, d] ->
    ([b, l, d], {"ssm": [b,h,p,n] f32, "conv": [b, k-1, d_in+2n]}).
    ``state`` (a cache of :func:`init_ssd_cache`, or None for zeros) is
    read, not written; ``scan_fn`` goes to :func:`ssd_chunked`."""
    d_in, h, p, n = ssd_dims(cfg)
    z, xbc, dt = _project(params, x, cfg)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 None if state is None else state["conv"])
    xs = xbc[..., :d_in].reshape(x.shape[0], x.shape[1], h, p).float()
    B = xbc[..., d_in:d_in + n].float()
    C = xbc[..., d_in + n:].float()
    A = torch.exp(params["A_log"])
    y, final = ssd_chunked(xs, dt, A, B, C, cfg.ssm_chunk,
                           None if state is None else state["ssm"],
                           scan_fn=scan_fn)
    y = y + params["D"][None, None, :, None] * xs
    y = y.reshape(x.shape[0], x.shape[1], d_in).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    out = torch.einsum("ble,ed->bld", y, params["out_proj"])
    return out, {"ssm": final, "conv": new_conv}


def ssd_decode_step(params, x: torch.Tensor, cache, cfg):
    """One token by the recurrent form.  x: [b, 1, d] -> ([b, 1, d],
    cache), the new ``ssm`` and ``conv`` written into ``cache`` in
    place."""
    d_in, h, p, n = ssd_dims(cfg)
    z, xbc, dt = _project(params, x, cfg)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 cache["conv"])
    xs = xbc[..., :d_in].reshape(x.shape[0], 1, h, p).float()[:, 0]
    B = xbc[..., d_in:d_in + n].float()[:, 0]                # [b,n]
    C = xbc[..., d_in + n:].float()[:, 0]
    A = torch.exp(params["A_log"])
    dt0 = dt[:, 0]                                            # [b,h]
    dA = torch.exp(-A * dt0)
    s = cache["ssm"] * dA[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt0, xs, B)
    y = torch.einsum("bn,bhpn->bhp", C, s) + params["D"][None, :, None] * xs
    y = y.reshape(x.shape[0], 1, d_in).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    out = torch.einsum("ble,ed->bld", y, params["out_proj"])
    cache["ssm"].copy_(s)
    cache["conv"].copy_(new_conv)
    return out, cache


def init_ssd_cache(cfg, batch: int, device=None) -> dict:
    """Zeroed decode state: ``ssm`` [b,h,p,n] f32 and ``conv`` [b, k-1,
    d_in+2n] in the activation dtype ``cfg.dtype`` (the reference's bf16
    buffer takes the activations' dtype after its first step; the zeros
    are equal in either, as ``rglru.init_rglru_cache`` says)."""
    d_in, h, p, n = ssd_dims(cfg)
    return {"ssm": torch.zeros(batch, h, p, n, dtype=torch.float32,
                               device=device),
            "conv": torch.zeros(batch, cfg.conv_width - 1, d_in + 2 * n,
                                dtype=dtype_of(cfg), device=device)}
