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
from repro_torch.models.shardctx import is_dtensor, local_box
from repro_torch.obs.trace import phase_call

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
    if is_dtensor(x):
        x = _gather_uneven_heads(x, n)
    return x.reshape(x.shape[:-1] + (n, hd))


def _gather_uneven_heads(x, n: int):
    """A DTensor projection whose feature dim is split over more ranks
    than its ``n`` heads divide (llama4's 40 heads over 16) is gathered
    over those axes first: the heads are then whole on every rank of
    them."""
    from torch.distributed.tensor import Replicate
    last = x.dim() - 1
    sizes = x.device_mesh.shape
    split = math.prod(sz for sz, p in zip(sizes, x.placements)
                      if p.is_shard(last))
    if n % split == 0:
        return x
    pl = tuple(Replicate() if p.is_shard(last) else p for p in x.placements)
    return x.redistribute(x.device_mesh, pl)


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
    if is_dtensor(q):
        q, k, v = _reduced(q), _reduced(k), _reduced(v)
        q = _gather_heads_over_slot_axes(q, k)
        if _uneven_head_split(q, hkv):
            k, v = _expand_kv(k, hq), _expand_kv(v, hq)
            hkv = hq
        k, v = _split_heads_like(q, k), _split_heads_like(q, v)
        if not any(p.is_shard(1) for p in k.placements):
            return _local_attend(q, k, v, mask)
    qs = q.reshape(b, s, hkv, hq // hkv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qs.float(), k.float())
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, hq, hd)


def _reduced(x):
    """``x`` with any partial sum reduced: the softmax is not linear, and
    a ``local_map`` reads each rank's values as they are."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _gather_heads_over_slot_axes(q, k):
    """Decode against a cache whose slots (k's dim 1) are split over a
    mesh axis that also splits q's heads: q (one position) is gathered
    over that axis, so the scores stay split by slot and the cache never
    moves."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if a.is_shard(2) and b.is_shard(1) else a
               for a, b in zip(q.placements, k.placements))
    return q if pl == tuple(q.placements) else q.redistribute(
        q.device_mesh, pl)


def _split_heads_like(q, x):
    """k or v split over the heads as q is wherever it is replicated (a
    local slice, no communication), so the score product pairs each
    rank's heads with their own k/v."""
    from torch.distributed.tensor import Shard
    pl = tuple(Shard(2) if a.is_shard(2) and b.is_replicate() else b
               for a, b in zip(q.placements, x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _uneven_head_split(q, hkv: int) -> bool:
    """A DTensor ``q`` whose heads are split over more ranks than ``hkv``
    divides: the GQA view ``[..., hkv, group, hd]`` cannot carry that
    split (e.g. 8 kv heads, 32 q heads over 16 ranks)."""
    sizes = q.device_mesh.shape
    n = math.prod(sz for sz, p in zip(sizes, q.placements)
                  if p.is_shard(2))
    return hkv % n != 0


def _expand_kv(x, hq: int):
    """k or v [B,T,Hkv,hd] repeated to the query heads [B,T,Hq,hd] (q head
    h reads kv head h // (Hq/Hkv), as the grouped view pairs them)."""
    b, t, hkv, hd = x.shape
    return x[:, :, :, None].expand(b, t, hkv, hq // hkv, hd).reshape(
        b, t, hq, hd)


def _local_attend(q, k, v, mask):
    """Attention with every key on each rank (prefill, train): each rank
    attends its own batch rows and heads, which q, k and v share after
    :func:`_split_heads_like`, and the result keeps q's placements.  One
    ``local_map`` in place of the einsums' sharding propagation (a batch
    split and a head split flattened into one product dim)."""
    from torch.distributed.tensor.experimental import local_map

    def local(ql, kl, vl):
        return _softmax_attend(ql, kl, vl, mask)

    pl = tuple(q.placements)
    return local_map(local, (pl,), in_placements=(pl, tuple(k.placements),
                                                  tuple(v.placements)),
                     device_mesh=q.device_mesh)(q, k, v)


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
    [B,S] (or [B,S,3] for M-RoPE).  Returns [B,S,d].  The attend (the
    mask, the f32 scores, softmax and values, or the kernel) is the
    device phase ``block.attend``, forward and ``.bwd``."""
    if impl not in ("ref", "flash"):
        raise ValueError(f"attention impl {impl!r}: 'ref' or 'flash'")
    hd = cfg.resolved_head_dim
    q = _split_heads(dense(params["wq"], x), cfg.n_heads, hd)
    k = _split_heads(dense(params["wk"], x), cfg.n_kv_heads, hd)
    v = _split_heads(dense(params["wv"], x), cfg.n_kv_heads, hd)
    q, k = _rope(q, k, positions, cfg)

    def attend(q, k, v):
        if impl == "flash":
            return kops.flash_attention(q, k, v, causal=True, window=window)
        return _sdpa(q, k, v, causal_mask(q.shape[1], window, q.device))

    out = phase_call("block.attend", attend, q, k, v)
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
    write_slot(cache["k"], slot, k_new[:, 0])
    write_slot(cache["v"], slot, v_new[:, 0])

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


def write_slot(buf, slot: int, value) -> None:
    """``buf[:, slot] = value`` in place.  On a DTensor cache whose slots
    (dim 1) are split over mesh axes, only the rank whose slice holds
    ``slot`` writes it, into its local shard: ``value`` is laid out as the
    cache is, and replicated over the slot axes."""
    if not (is_dtensor(buf) and any(p.is_shard(1) for p in buf.placements)):
        buf[:, slot] = value
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    (_, n_local, *_), (_, start, *_) = local_box(buf.shape, mesh,
                                                 buf.placements)
    val_pl = tuple(Replicate() if p.is_shard(1) else
                   Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else p
                   for p in buf.placements)
    local_value = value.redistribute(mesh, val_pl).to_local()
    if start <= slot < start + n_local:
        buf.to_local()[:, slot - start] = local_value


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device=None):
    """Zeroed k/v caches [B, C, Hkv, hd]: bf16 by default, whatever the
    model's dtype, as the reference's are."""
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
