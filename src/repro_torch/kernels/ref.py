"""Plain PyTorch versions of the port's kernels.

The counterparts of ``repro/kernels/ref.py``: the DP clip+noise
(``dp_clip_noise_ref``, ``dp_clip_noise_tree_ref``, plus the row-batched
forms over ``[R, P]``, one row per client, that ``dp_clip_noise.py``
computes), ``flash_attention_ref``, ``flash_decode_ref`` (with the
``(o, m, l)`` partials the decode kernel can return), ``rglru_scan_ref`` and
``combine_partials`` (``repro/kernels/flash_decode.py``'s shard merge).  The
CPU path runs these; ``chip_smoke.py`` holds the kernels against them on
the card, and every ``loss`` differentiates them (the kernels have no
backward).

DP noise is an operand (standard normal, in leaf order for a tree), as in
the TPU kernel: torch cannot reproduce JAX's threefry bits, so the tests
hand both packages the same numbers.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.tree import flatten_rows, unflatten_rows


def sumsq_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Σ x² over each row of ``x [R, P]`` -> ``[R]``."""
    x = x.float()
    return torch.sum(x * x, dim=1)


def scale_noise_rows_ref(x: torch.Tensor, noise: torch.Tensor,
                         scale: torch.Tensor, sigma) -> torch.Tensor:
    """``o = x·scale[r] + σ·n`` over ``[R, P]``; ``sigma`` is one float or
    a ``[R]`` tensor, one σ a row.  σ·n is rounded once either way, so a
    per-row σ gives the bits of the reference's traced-σ fold
    (``x·scale + 1.0·(σ·n)``)."""
    if isinstance(sigma, torch.Tensor):
        sigma = sigma[:, None]
    return x.float() * scale[:, None] + sigma * noise.float()


def clip_scale(norm: torch.Tensor, clip) -> torch.Tensor:
    """``min(1, clip / max(norm, 1e-12))`` (the reference's clip factor);
    ``clip`` is a float or a tensor shaped like ``norm``."""
    return torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)


def dp_clip_noise_rows_ref(x: torch.Tensor, noise: torch.Tensor, clip,
                           sigma):
    """Clip each row to L2 ``clip`` and add σ-scaled noise; ``clip`` and
    ``sigma`` are floats or ``[R]`` tensors (one a row).
    Returns ``(out [R, P], pre_clip_norm [R])``."""
    norm = torch.sqrt(sumsq_rows_ref(x))
    return scale_noise_rows_ref(x, noise, clip_scale(norm, clip), sigma), norm


def dp_clip_noise_ref(x: torch.Tensor, noise_unit: torch.Tensor, clip: float,
                      sigma: float) -> torch.Tensor:
    """One flat update ``x [N]`` (``dp_clip_noise_ref`` of the reference)."""
    out, _ = dp_clip_noise_rows_ref(x[None], noise_unit[None], clip, sigma)
    return out[0].to(x.dtype)


def dp_clip_noise_tree_ref(tree, noise: torch.Tensor, clip: float,
                           sigma: float):
    """One update tree with a shared global norm; ``noise`` is flat ``[P]``
    in leaf order.  Returns ``(noised_tree, pre_clip_global_norm)``."""
    out, norm = dp_clip_noise_rows_ref(flatten_rows(tree, 0)[None],
                                       noise[None], clip, sigma)
    return unflatten_rows(out[0], tree), norm[0]


# -- sequence kernels -------------------------------------------------------

NEG_INF = -1e30  # the TPU kernels' mask value; a masked row stays finite


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: [B,S,HQ,D]; k,v: [B,T,HKV,D] -> [B,S,HQ,D] (f32 math, output in
    q's dtype).  The causal mask is offset by T−S; q head h reads kv head
    h // (HQ/HKV)."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, s, hkv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(d)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i + (t - s)
    if window is not None:
        mask &= j > i + (t - s) - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, return_partials: bool = False):
    """One-token decode.  q: [B,HQ,D]; k,v: [B,T,HKV,D]; ``length``: [] or
    [B] valid cache positions.  Returns o [B,HQ,D] in q's dtype, or
    ``(o, m [B,HQ], l [B,HQ])`` with the row max and softmax normaliser
    (f32) when ``return_partials``: a row with no valid position has
    m = −1e30 and l = T, as the TPU kernel gives."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d)
    scores = torch.einsum("bkgd,btkd->bkgt", qf, k.float()) / math.sqrt(d)
    length = torch.as_tensor(length, device=q.device).expand(b)
    valid = torch.arange(t, device=q.device)[None] < length[:, None]
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v.float())
    o = out.reshape(b, hq, d).to(q.dtype)
    if not return_partials:
        return o
    m = scores.amax(dim=-1)
    l = torch.exp(scores - m[..., None]).sum(dim=-1)
    return o, m.reshape(b, hq), l.reshape(b, hq)


def combine_partials(os_: torch.Tensor, ms: torch.Tensor,
                     ls: torch.Tensor) -> torch.Tensor:
    """Merge per-shard flash-decode partials (leading shard axis) by
    log-sum-exp.  os_: [S,B,HQ,D] (each already normalised by its own l);
    ms, ls: [S,B,HQ].  An empty shard (m = −1e30) gets weight 0."""
    m_star = ms.amax(dim=0)
    w = ls * torch.exp(ms - m_star)
    denom = torch.clamp(w.sum(dim=0), min=1e-30)
    o = (os_.float() * w[..., None]).sum(dim=0) / denom[..., None]
    return o.to(os_.dtype)


def rglru_scan_ref(a: torch.Tensor, x: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """Sequential linear recurrence ``h_t = a_t·h_{t−1} + x_t``, a product
    and a sum each rounded in f32.  a, x: [B,L,W]; h0: [B,W] or None.
    Returns (h [B,L,W], h_last [B,W])."""
    b, l, w = a.shape
    h = (torch.zeros(b, w, dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    hs = []
    for t in range(l):
        h = a[:, t].float() * h + x[:, t].float()
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    return hs, hs[:, -1]
