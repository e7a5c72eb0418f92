"""Encoder-decoder backbone (Seamless-M4T-style, the audio use case): the
port's copy of ``repro/models/encdec.py``.

The audio frontend (mel-spectrogram + conv feature extractor) is the
reference's STUB: the encoder takes precomputed frame embeddings
[B, T_enc, d].  The encoder is a bidirectional transformer; the decoder is
a causal transformer with a cross-attention a layer whose K/V are
projected once from the encoder output and carried in the decode cache.
Both stacks are drawn layer by layer from a ``torch.Generator`` into
tensors stacked along a leading "layers" axis, as ``init_lm``'s are, and
run as a Python loop over views of them.  Attention here is plain torch,
with no ``impl``, as in the reference: the encoder-decoder launches no
kernel.  The decode step writes its self-attention k/v into the stacked
cache in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.shardctx import unshard
from repro_torch.models.sharding import pm, split_meta


def _enc_block_init(gen, cfg):
    return {
        "ln1": L.init_rmsnorm(gen, cfg.d_model, cfg),
        "attn": attn_lib.init_attention(gen, cfg),
        "ln2": L.init_rmsnorm(gen, cfg.d_model, cfg),
        "mlp": L.init_mlp(gen, cfg),
    }


def _dec_block_init(gen, cfg):
    return {
        "ln1": L.init_rmsnorm(gen, cfg.d_model, cfg),
        "self_attn": attn_lib.init_attention(gen, cfg),
        "lnx": L.init_rmsnorm(gen, cfg.d_model, cfg),
        "cross_attn": attn_lib.init_attention(gen, cfg),
        "ln2": L.init_rmsnorm(gen, cfg.d_model, cfg),
        "mlp": L.init_mlp(gen, cfg),
    }


def init_encdec_meta(gen, cfg) -> Dict[str, Any]:
    """The parameter tree as ParamMeta; ``gen`` None builds the shapes on
    the meta device."""
    pv = T.padded_vocab(cfg)
    dt = L.dtype_of(cfg)
    return {
        "embed": {"table": pm(L.normal_init(gen, (pv, cfg.d_model), 0.02, dt),
                              "vocab", "embed")},
        "enc_stack": T.stack_layers(cfg.enc_layers,
                                    lambda: _enc_block_init(gen, cfg)),
        "enc_ln": L.init_rmsnorm(gen, cfg.d_model, cfg),
        "dec_stack": T.stack_layers(cfg.n_layers,
                                    lambda: _dec_block_init(gen, cfg)),
        "final_ln": L.init_rmsnorm(gen, cfg.d_model, cfg),
        "head": {"w": pm(L.normal_init(gen, (cfg.d_model, pv), 0.02, dt),
                         "embed", "vocab")},
    }


def init_encdec(gen, cfg):
    """Returns (params values, logical axes)."""
    return split_meta(init_encdec_meta(gen, cfg))


def encdec_axes(cfg):
    return init_encdec(None, cfg)[1]


def encdec_param_shapes(cfg):
    return init_encdec(None, cfg)[0]


def _arange_positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def _run_stack(stack, n: int, body, x, remat: str):
    """``body(layer_params, h)`` over the ``n`` stacked layers, each under
    ``remat`` (mode ``"train"``; ``"none"`` otherwise)."""
    if remat not in T.REMATS:
        raise ValueError(f"remat {remat!r}: one of {T.REMATS}")
    run = T._remat(lambda pl, h: body(unshard(pl), h), remat)
    for pl in T._unbind(stack, n):
        x = run(pl, x)
    return x


def encode(params, cfg, enc_embeds, *, remat: str = "none") -> torch.Tensor:
    """enc_embeds: [B, T, d] stub-frontend frame embeddings -> [B, T, d]."""
    x = enc_embeds.to(L.dtype_of(cfg))
    positions = _arange_positions(x)
    x = T._act(x)

    def body(pl, h):
        h = T._act(h + attn_lib.encoder_attention(
            pl["attn"], L.rmsnorm(pl["ln1"], h, cfg.norm_eps), positions,
            cfg))
        h = h + L.mlp(pl["mlp"], L.rmsnorm(pl["ln2"], h, cfg.norm_eps),
                      cfg.act)
        return T._act(h)

    x = _run_stack(params["enc_stack"], cfg.enc_layers, body, x, remat)
    return L.rmsnorm(unshard(params["enc_ln"]), x, cfg.norm_eps)


def decode_train(params, cfg, tokens, enc_out, *, remat: str = "none",
                 window: Optional[int] = None,
                 last_only: bool = False) -> torch.Tensor:
    """Teacher-forced decoder pass.  Returns logits [B,S,V] (or [B,1,V])."""
    x = L.embed(unshard(params["embed"]), tokens)
    positions = _arange_positions(x)
    x = T._act(x)

    def body(pl, h):
        h = T._act(h + attn_lib.attention(
            pl["self_attn"], L.rmsnorm(pl["ln1"], h, cfg.norm_eps), positions,
            cfg, window=window))
        enc_kv = attn_lib.project_enc_kv(pl["cross_attn"], enc_out, cfg)
        h = T._act(h + attn_lib.cross_attention(
            pl["cross_attn"], L.rmsnorm(pl["lnx"], h, cfg.norm_eps), enc_kv,
            cfg))
        h = h + L.mlp(pl["mlp"], L.rmsnorm(pl["ln2"], h, cfg.norm_eps),
                      cfg.act)
        return T._act(h)

    x = _run_stack(params["dec_stack"], cfg.n_layers, body, x, remat)
    if last_only:
        x = x[:, -1:]
    return T.lm_logits(params, cfg, x)


def encdec_forward(params, cfg, enc_embeds, tokens, *, remat: str = "none",
                   window: Optional[int] = None,
                   last_only: bool = False) -> torch.Tensor:
    """Logits of ``tokens`` [B,S] given the frame embeddings (the
    reference also returns a zero aux loss)."""
    enc_out = encode(params, cfg, enc_embeds, remat=remat)
    return decode_train(params, cfg, tokens, enc_out, remat=remat,
                        window=window, last_only=last_only)


def encdec_loss(params, cfg, enc_embeds, tokens, labels, *,
                remat: str = "full") -> torch.Tensor:
    return T.xent(encdec_forward(params, cfg, enc_embeds, tokens,
                                 remat=remat), labels)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_decode_cache(params, cfg, batch: int, cache_len: int, enc_out,
                      window: Optional[int] = None):
    """``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each stacked over the
    decoder's layers: the self-attention's zeroed bf16 k/v
    [L, B, C, Hkv, hd] (C the window when one is given, rolling) and the
    cross-attention's K/V [L, B, T_enc, Hkv, hd] projected once from
    ``enc_out``, on ``enc_out``'s device."""
    clen = min(cache_len, window) if window else cache_len
    one = attn_lib.init_cache(cfg, batch, clen, device=enc_out.device)
    self_cache = {k: v.new_zeros((cfg.n_layers,) + tuple(v.shape))
                  for k, v in one.items()}
    kv = [attn_lib.project_enc_kv(pl["cross_attn"], enc_out, cfg)
          for pl in T._unbind(params["dec_stack"], cfg.n_layers)]
    cross = {"k": torch.stack([k for k, _ in kv]),
             "v": torch.stack([v for _, v in kv])}
    return {"self": self_cache, "cross": cross}


def encdec_decode_step(params, cfg, token, caches, index: int, *,
                       window: Optional[int] = None):
    """One-token decode.  token: [B,1]; ``index`` a host int.  Returns
    (logits [B,1,V], caches), the self cache written in place."""
    x = T._act(L.embed(unshard(params["embed"]), token))
    positions = torch.full(token.shape, index, dtype=torch.int32,
                           device=token.device)
    layers = T._unbind(params["dec_stack"], cfg.n_layers)
    for r, pl in enumerate(layers):
        pl = unshard(pl)
        a, _ = attn_lib.decode_attention(
            pl["self_attn"], L.rmsnorm(pl["ln1"], x, cfg.norm_eps),
            T._index(caches["self"], r), index, positions, cfg,
            window=window)
        x = T._act(x + a)
        x = T._act(x + attn_lib.cross_attention(
            pl["cross_attn"], L.rmsnorm(pl["lnx"], x, cfg.norm_eps),
            (caches["cross"]["k"][r], caches["cross"]["v"][r]), cfg))
        x = T._act(x + L.mlp(pl["mlp"], L.rmsnorm(pl["ln2"], x, cfg.norm_eps),
                             cfg.act))
    return T.lm_logits(params, cfg, x), caches
