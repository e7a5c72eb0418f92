"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427): the
port's copy of ``repro/models/rglru.py``.

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(-c * softplus(Λ) * r_t)       learned decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t²) * (i_t ⊙ x_t)

The full residual block is
    x -> [W_in -> causal conv(4) -> RG-LRU] ⊙ gelu(W_gate x) -> W_out

The recurrence runs on one of two scans (``rglru_block``'s ``impl``):
``"ref"`` is :func:`rglru_scan`, a log-depth scan in plain torch ops that
mirrors ``jax.lax.associative_scan``'s odd/even recursion (6 levels at
L = 64) and stays differentiable under ``torch.func.vmap``; ``"flash"`` is
``kernels.ops.rglru_scan``, the CUDA kernel on the card (its sequential
plain version on the CPU), which has no backward.  ``state`` (the cache
of :func:`init_rglru_cache`) carries ``h`` into the scan as its ``h0``
and ``conv`` into the causal conv.  :func:`rglru_decode_step` is the
one-token recurrence; it writes its new state into the cache it is given
(the stacked caches of ``transformer.stack_cache`` are updated through
views), where the reference returns a fresh cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import device_of, dtype_of, fan_in_init
from repro_torch.models.sharding import pm

_C = 8.0


def lru_width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def init_rglru(gen: Optional[torch.Generator], cfg) -> dict:
    """Fresh block params as a ParamMeta tree (the reference's axes) on
    ``gen.device``, or shapes only on the meta device for ``gen`` None:
    the projections and the conv in ``cfg.dtype``, the RG-LRU gates and Λ
    in f32.  Drawn in the order w_in, w_gate, conv_w, wa, wx, w_out."""
    d = cfg.d_model
    w = lru_width(cfg)
    dt, dev = dtype_of(cfg), device_of(gen)
    return {
        "w_in": pm(fan_in_init(gen, (d, w), dtype=dt), "embed", "mlp"),
        "w_gate": pm(fan_in_init(gen, (d, w), dtype=dt), "embed", "mlp"),
        "conv_w": pm(fan_in_init(gen, (cfg.conv_width, w), dtype=dt),
                     None, "mlp"),
        "conv_b": pm(torch.zeros(w, dtype=dt, device=dev), "mlp"),
        # RG-LRU gates (diagonal parameterisation)
        "wa": pm(fan_in_init(gen, (w, w)), "mlp", None),
        "ba": pm(torch.zeros(w, device=dev), None),
        "wx": pm(fan_in_init(gen, (w, w)), "mlp", None),
        "bx": pm(torch.zeros(w, device=dev), None),
        # Λ so that a ≈ uniform(0.9, 0.999) at r = 1 (paper §2.4)
        "lam": pm(torch.log(torch.expm1(
            -torch.log(torch.linspace(0.9, 0.999, w, device=dev)) / _C)),
            None),
        "w_out": pm(fan_in_init(gen, (w, d), dtype=dt), "mlp", "embed"),
    }


def _gates(params, x: torch.Tensor):
    """x: [b, l, w] f32 -> (a_t [b,l,w], gated input [b,l,w])."""
    r = torch.sigmoid(torch.einsum("blw,wv->blv", x, params["wa"])
                      + params["ba"])
    i = torch.sigmoid(torch.einsum("blw,wv->blv", x, params["wx"])
                      + params["bx"])
    log_a = -_C * F.softplus(params["lam"]) * r       # [b,l,w], <= 0
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x)
    return a, x_in


def _combine(lhs, rhs):
    """Compose two steps of ``h = a·h + x``: first ``lhs``, then ``rhs``."""
    a1, x1 = lhs
    a2, x2 = rhs
    return a1 * a2, a2 * x1 + x2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``out[:, 0::2] = even``, ``out[:, 1::2] = odd`` along axis 1, where
    ``even`` has as many steps as ``odd`` or one more; out of place, so
    that it batches under ``vmap`` and differentiates."""
    n_odd = odd.shape[1]
    pairs = torch.stack([even[:, :n_odd], odd], dim=2)
    out = pairs.reshape(odd.shape[0], 2 * n_odd, *odd.shape[2:])
    if even.shape[1] > n_odd:
        out = torch.cat([out, even[:, n_odd:]], dim=1)
    return out


def _assoc_scan(a: torch.Tensor, x: torch.Tensor):
    """Inclusive scan of :func:`_combine` over axis 1, by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    the pairs, then fill in the even steps."""
    n = a.shape[1]
    if n < 2:
        return a, x
    odd_a, odd_x = _assoc_scan(*_combine((a[:, 0:-1:2], x[:, 0:-1:2]),
                                         (a[:, 1::2], x[:, 1::2])))
    if n % 2 == 0:
        even_a, even_x = _combine((odd_a[:, :-1], odd_x[:, :-1]),
                                  (a[:, 2::2], x[:, 2::2]))
    else:
        even_a, even_x = _combine((odd_a, odd_x), (a[:, 2::2], x[:, 2::2]))
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_x = torch.cat([x[:, :1], even_x], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_x, odd_x)


def rglru_scan(a: torch.Tensor, x_in: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear recurrence ``h_t = a_t h_{t-1} + x_t`` by a log-depth scan.

    a, x_in: [b, l, w]; h0: [b, w] or None.  Returns (h [b,l,w],
    h_last [b,w])."""
    if h0 is not None:
        x_in = torch.cat([x_in[:, :1] + a[:, :1] * h0[:, None], x_in[:, 1:]],
                         dim=1)
    _, h = _assoc_scan(a, x_in)
    return h, h[:, -1]


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over a whole sequence.  x: [b, l, c];
    w: [k, c]; ``state`` the last k−1 inputs before x, or None for zeros.
    Returns (out [b, l, c], the new state)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + b
    return out, new_state


def rglru_block(params, x: torch.Tensor, cfg, state=None,
                impl: str = "ref"):
    """The recurrent residual branch over a whole sequence.  x: [b, l, d]
    -> ([b, l, d], {"h": [b, w] f32, "conv": [b, k-1, w]}).  ``state``
    (a cache of :func:`init_rglru_cache`, or None for zeros) is read, not
    written.  ``impl``: ``"ref"`` (the log-depth scan) or ``"flash"``
    (``kernels.ops.rglru_scan``, ``h`` its ``h0`` operand)."""
    gate = F.gelu(torch.einsum("bld,dw->blw", x, params["w_gate"]),
                  approximate="tanh")
    u = torch.einsum("bld,dw->blw", x, params["w_in"])
    u, new_conv = _causal_conv(u, params["conv_w"], params["conv_b"],
                               None if state is None else state["conv"])
    a, x_in = _gates(params, u.float())
    h0 = None if state is None else state["h"]
    if impl == "flash":
        h, h_last = kops.rglru_scan(a, x_in, h0)
    elif impl == "ref":
        h, h_last = rglru_scan(a, x_in, h0)
    else:
        raise ValueError(f"rglru_block: unknown impl {impl!r}")
    y = h.to(x.dtype) * gate
    out = torch.einsum("blw,wd->bld", y, params["w_out"])
    return out, {"h": h_last, "conv": new_conv}


def rglru_decode_step(params, x: torch.Tensor, cache, cfg):
    """One token: :func:`rglru_block` over x [b, 1, d] from ``cache`` (its
    scan of one step is ``h = a·h + x``), the new ``h`` and ``conv``
    written into ``cache`` in place.  Returns ([b, 1, d], cache)."""
    out, new = rglru_block(params, x, cfg, state=cache)
    cache["h"].copy_(new["h"])
    cache["conv"].copy_(new["conv"])
    return out, cache


def init_rglru_cache(cfg, batch: int, device=None) -> dict:
    """Zeroed decode state: ``h`` [b, w] f32 and ``conv`` [b, k-1, w] in
    the activation dtype ``cfg.dtype``.  The reference allocates ``conv``
    in bf16 and replaces it after the first step with one of the
    activations' dtype; an in-place cache keeps that dtype from the start
    (the zeros are equal in either), so an f32 model's conv state is never
    rounded to bf16."""
    w = lru_width(cfg)
    return {"h": torch.zeros(batch, w, dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, cfg.conv_width - 1, w,
                                dtype=dtype_of(cfg), device=device)}
