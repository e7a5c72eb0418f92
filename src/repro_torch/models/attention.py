"""GQA attention: the port's copy of ``repro/models/attention.py``.

Prefill (full-causal or sliding-window) self-attention, on plain torch
(``impl="ref"``, the reference's jnp einsums) or on the ``flash_attention``
kernel (``impl="flash"``: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors; ``kernels/ops.py``), and one-token decode against
a full or rolling KV cache.  The encoder-decoder's ``encoder_attention``
(bidirectional), ``cross_attention`` (against K/V projected once by
``project_enc_kv``) run on plain torch, with no ``impl``, as the
reference's do.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_mrope, apply_rope, dense, init_dense

NEG_INF = -1e30


def init_attention(gen, cfg, d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    b = cfg.qkv_bias
    return {
        "wq": init_dense(gen, d, cfg.n_heads * hd, cfg, axes=("embed", "heads"), bias=b),
        "wk": init_dense(gen, d, cfg.n_kv_heads * hd, cfg, axes=("embed", "kv"), bias=b),
        "wv": init_dense(gen, d, cfg.n_kv_heads * hd, cfg, axes=("embed", "kv"), bias=b),
        "wo": init_dense(gen, cfg.n_heads * hd, d, cfg, axes=("heads", "embed")),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _rope(q, k, positions, cfg):
    if cfg.mrope_sections is not None:
        # positions: [..., seq, 3]
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    elif positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _softmax_attend(q, k, v, mask) -> torch.Tensor:
    """q [B,S,Hq,hd] against k/v [B,T,Hkv,hd] in f32; ``mask`` [S,T] or
    [T] (True = attend) or None.  Returns f32 [B,S,Hq,hd]."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qs = q.reshape(b, s, hkv, hq // hkv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qs.float(), k.float())
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, hq, hd)


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q:[B,S,Hq,hd] k/v:[B,T,Hkv,hd] mask:[S,T] (True = attend) or None;
    output in v's dtype."""
    return _softmax_attend(q, k, v, mask).to(v.dtype)


def causal_mask(s: int, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """[S,S] boolean mask; sliding window if requested."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m


def attention(params, x, positions, cfg, *, window: Optional[int] = None,
              impl: str = "ref") -> torch.Tensor:
    """Full-sequence (prefill) self-attention.  x: [B,S,d]; positions:
    [B,S] (or [B,S,3] for M-RoPE).  Returns [B,S,d]."""
    if impl not in ("ref", "flash"):
        raise ValueError(f"attention impl {impl!r}: 'ref' or 'flash'")
    hd = cfg.resolved_head_dim
    q = _split_heads(dense(params["wq"], x), cfg.n_heads, hd)
    k = _split_heads(dense(params["wk"], x), cfg.n_kv_heads, hd)
    v = _split_heads(dense(params["wv"], x), cfg.n_kv_heads, hd)
    q, k = _rope(q, k, positions, cfg)
    if impl == "flash":
        out = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        out = _sdpa(q, k, v, causal_mask(x.shape[1], window, x.device))
    return dense(params["wo"], out.reshape(out.shape[:2] + (-1,)))


def encoder_attention(params, x, positions, cfg) -> torch.Tensor:
    """Bidirectional self-attention (the audio encoder).  x: [B,T,d]."""
    hd = cfg.resolved_head_dim
    q = _split_heads(dense(params["wq"], x), cfg.n_heads, hd)
    k = _split_heads(dense(params["wk"], x), cfg.n_kv_heads, hd)
    v = _split_heads(dense(params["wv"], x), cfg.n_kv_heads, hd)
    q, k = _rope(q, k, positions, cfg)
    out = _sdpa(q, k, v, None)
    return dense(params["wo"], out.reshape(out.shape[:2] + (-1,)))


def cross_attention(params, x, enc_kv, cfg) -> torch.Tensor:
    """Decoder -> encoder attention.  enc_kv: the (k, v) pair
    [B,T,Hkv,hd] of :func:`project_enc_kv`."""
    hd = cfg.resolved_head_dim
    q = _split_heads(dense(params["wq"], x), cfg.n_heads, hd)
    k, v = enc_kv
    out = _sdpa(q, k, v, None)
    return dense(params["wo"], out.reshape(out.shape[:2] + (-1,)))


def project_enc_kv(params, enc_out, cfg):
    """The cross-attention's (k, v) [B,T,Hkv,hd] of the encoder output."""
    hd = cfg.resolved_head_dim
    k = _split_heads(dense(params["wk"], enc_out), cfg.n_kv_heads, hd)
    v = _split_heads(dense(params["wv"], enc_out), cfg.n_kv_heads, hd)
    return k, v


# ---------------------------------------------------------------------------
# Decode (one new token against a KV cache)
# ---------------------------------------------------------------------------


def decode_attention(params, x, cache, index: int, positions, cfg, *,
                     window: Optional[int] = None):
    """One-step decode.

    x: [B,1,d] current token hidden states.
    cache: dict(k=[B,C,Hkv,hd], v=[B,C,Hkv,hd]) where C = the full length
        for dense attention or the rolling window size for SWA.
    index: host int, the number of tokens already in context.
    positions: [B,1] (or [B,1,3]) position ids of the new token.

    Writes the new token's k and v IN PLACE into ``cache`` at slot
    ``index`` (``index % C`` for a rolling cache; a full cache clamps the
    slot to C − 1, as ``dynamic_update_slice`` clamps it) and returns
    ``(out [B,1,d], cache)``, the same dict the reference returns anew.
    """
    hd = cfg.resolved_head_dim
    q = _split_heads(dense(params["wq"], x), cfg.n_heads, hd)
    k_new = _split_heads(dense(params["wk"], x), cfg.n_kv_heads, hd)
    v_new = _split_heads(dense(params["wv"], x), cfg.n_kv_heads, hd)
    q, k_new = _rope(q, k_new, positions, cfg)

    cache_len = cache["k"].shape[1]
    slot = index % cache_len if window is not None else min(index, cache_len - 1)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]

    # valid positions: cache slots holding tokens <= index
    j = torch.arange(cache_len, device=x.device)
    if window is None or index < cache_len:
        valid = j <= index
    else:
        # a rolling buffer that has wrapped holds a token of the window in
        # every slot
        valid = torch.ones(cache_len, dtype=torch.bool, device=x.device)
    out = _softmax_attend(q, cache["k"], cache["v"], valid).to(x.dtype)
    b, s = x.shape[:2]
    return dense(params["wo"], out.reshape(b, s, -1)), cache


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device=None):
    """Zeroed k/v caches [B, C, Hkv, hd]: bf16 by default, whatever the
    model's dtype, as the reference's are."""
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
