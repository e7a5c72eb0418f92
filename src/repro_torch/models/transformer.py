"""Decoder-only transformer stack: the port's copy of
``repro/models/transformer.py`` for the ``attn``, ``moe`` (attention and
a mixture of experts), ``rec`` (RG-LRU) and ``ssd`` (Mamba-2) block
kinds.

Layers are stacked per *segment* (``ModelConfig.segments``): a segment is
a super-block of block kinds repeated N times, and its params are stacked
along a leading "layers" axis, as the reference stacks them for its
``lax.scan``, so weights carry across as a tree map.  Here the segment
runs as a Python loop over its repeats, each on views of the stacked
params (``unbind``: one backward stacks the layers' grads) and, in decode,
of the stacked caches.

Mode ``"train"`` runs the stack under ``remat`` (the reference's
``jax.checkpoint`` of its scan body): ``"full"`` checkpoints each repeat,
or each group of ``remat_group`` repeats when that divides the segment
(``torch.utils.checkpoint``, non-reentrant); ``"dots"`` checkpoints the
same regions but saves the outputs of the products without batch dims
(``aten.mm``/``addmm``: the dense projections) and recomputes the rest,
the counterpart of ``dots_with_no_batch_dims_saveable``.  ``lm_loss`` is
the next-token cross-entropy plus the ``moe`` blocks' aux loss, which
``apply_stack`` sums over the layers as the reference's does.  In decode
every block writes its new state into the stacked caches through their
views (the attention's k/v slots, the recurrent blocks' ``h``/``ssm``
and ``conv``).  A ``rec`` block takes ``impl`` in prefill and train, as
the reference's does (``"flash"``: the ``rglru_scan`` kernel); an
``ssd`` block runs its chunk scan on the scan's plain version and
launches no kernel, as the reference's LM does.  A ``moe`` block's
experts run on the dispatch ``MOE_IMPL[0]`` names (``"einsum"`` or
``"scatter"``; ``models/moe.py``), a one-element list so a caller can
flip it without threading a kwarg through every block, as in the
reference.  ``lm_forward`` takes ``extra_embeds``, a multimodal
frontend's embeddings prepended to the tokens' (the VLM's stub patches);
``lm_loss`` drops their logits.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.shardctx import active as sharded, constrain, unshard
from repro_torch.models.sharding import (ParamMeta, add_axis, map_meta, pm,
                                         split_meta)
from repro_torch.obs.trace import phase_call

VOCAB_PAD_TO = 256
NEG_INF = attn_lib.NEG_INF

# MoE dispatch: "einsum" (GShard one-hot) or "scatter" (index-based)
MOE_IMPL = ["einsum"]
KINDS = ("attn", "moe", "rec", "ssd")
MODES = ("train", "prefill", "decode")
REMATS = ("none", "full", "dots")
# the products "dots" saves: those without batch dims (the dense
# projections); attention's batched einsums (bmm) are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD_TO) * VOCAB_PAD_TO


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def init_block(gen, cfg, kind: str):
    _check_kind(kind)
    d = cfg.d_model
    if kind == "ssd":
        return {"ln": L.init_rmsnorm(gen, d, cfg),
                "ssd": ssm_lib.init_ssd(gen, cfg)}
    if kind == "rec":
        mixer = {"rec": rglru_lib.init_rglru(gen, cfg)}
    else:
        mixer = {"attn": attn_lib.init_attention(gen, cfg)}
    ffn = ({"moe": moe_lib.init_moe(gen, cfg)} if kind == "moe"
           else {"mlp": L.init_mlp(gen, cfg)})
    return {"ln1": L.init_rmsnorm(gen, d, cfg), **mixer,
            "ln2": L.init_rmsnorm(gen, d, cfg), **ffn}


def _attn_window(cfg, window_override):
    if window_override is not None:
        return window_override
    return cfg.sliding_window


def apply_block(params, kind: str, x, positions, cfg, *, mode: str,
                cache=None, index: Optional[int] = None,
                window_override=None, impl: str = "ref"):
    """Returns (x, new_cache, aux): ``aux`` is a ``moe`` block's aux loss,
    else 0.  In decode ``cache`` is written in place
    (``attention.decode_attention``, ``rglru_decode_step``,
    ``ssd_decode_step``); the stack keeps no prefill cache, as the
    reference's drops it.  Device phases (``obs.phase_call``, forward and
    ``.bwd``): ``block.attention`` (``ln1`` to the output projection) of
    the ``attn`` and ``moe`` blocks in train and prefill, ``block.mlp``
    (``ln2`` and the dense MLP), ``block.moe`` (``ln2`` through the
    experts' combine, with ``moe.route`` and ``moe.experts`` inside it);
    the residual adds stay outside."""
    _check_kind(kind)
    new_cache = cache
    if kind == "ssd":
        h = L.rmsnorm(params["ln"], x, cfg.norm_eps)
        if mode == "decode":
            s, new_cache = ssm_lib.ssd_decode_step(params["ssd"], h, cache,
                                                   cfg)
        else:
            s, _ = ssm_lib.ssd_block(params["ssd"], h, cfg)
        return _act(x + s), new_cache, 0.0

    def ln1(y):
        return L.rmsnorm(params["ln1"], y, cfg.norm_eps)

    if kind == "rec":
        if mode == "decode":
            a, new_cache = rglru_lib.rglru_decode_step(params["rec"], ln1(x),
                                                       cache, cfg)
        else:
            a, _ = rglru_lib.rglru_block(params["rec"], ln1(x), cfg,
                                         impl=impl)
    elif mode == "decode":
        a, new_cache = attn_lib.decode_attention(
            params["attn"], ln1(x), cache, index, positions, cfg,
            window=_attn_window(cfg, window_override))
    else:
        a = phase_call("block.attention", lambda y: attn_lib.attention(
            params["attn"], ln1(y), positions, cfg,
            window=_attn_window(cfg, window_override), impl=impl), x)
    x = _act(x + a)
    if kind == "moe":
        m, aux = phase_call("block.moe", lambda y: moe_lib.moe_mlp(
            params["moe"], L.rmsnorm(params["ln2"], y, cfg.norm_eps), cfg,
            impl=MOE_IMPL[0]), x)
        return _act(x + m), new_cache, aux
    m = phase_call("block.mlp", lambda y: L.mlp(
        params["mlp"], L.rmsnorm(params["ln2"], y, cfg.norm_eps), cfg.act), x)
    return _act(x + m), new_cache, 0.0


def _act(x):
    """The residual stream's placement (batch over the data axes); the
    identity outside a sharding context."""
    return constrain(x, "act_batch", "act_seq", None)


def init_block_cache(cfg, kind: str, batch: int, cache_len: int,
                     window_override=None, device=None):
    _check_kind(kind)
    if kind == "rec":
        return rglru_lib.init_rglru_cache(cfg, batch, device=device)
    if kind == "ssd":
        return ssm_lib.init_ssd_cache(cfg, batch, device=device)
    w = _attn_window(cfg, window_override)
    clen = min(cache_len, w) if w else cache_len
    return attn_lib.init_cache(cfg, batch, clen, device=device)


# ---------------------------------------------------------------------------
# Segmented stack
# ---------------------------------------------------------------------------


def stack_layers(reps: int, init_one):
    """``reps`` layers of ``init_one()`` (a ParamMeta tree) stacked along
    a leading "layers" axis.  Layers are drawn one at a time and copied
    into the stacked tensors, so no f32 draw of a whole stacked leaf is
    ever held; a single layer is stacked as a view, without a copy (one
    of llama4's 18 B-element ``("attn", "moe")`` pairs would otherwise
    be held twice)."""
    if reps == 1:
        return add_axis(map_meta(lambda m: ParamMeta(
            m.value.unsqueeze(0), m.axes), init_one()), "layers")
    stacked = None
    for r in range(reps):
        one = init_one()
        if stacked is None:
            stacked = add_axis(map_meta(lambda m: ParamMeta(
                m.value.new_empty((reps,) + tuple(m.value.shape)),
                m.axes), one), "layers")
        _copy_into(split_meta(stacked)[0], split_meta(one)[0], r)
    return stacked


def init_stack(gen, cfg):
    """Per-segment stacked param trees (with ParamMeta)."""
    return [stack_layers(reps, lambda kinds=kinds: {
        f"b{i}": init_block(gen, cfg, kind) for i, kind in enumerate(kinds)})
        for kinds, reps in cfg.segments()]


def _copy_into(stacked, layer, r: int) -> None:
    if isinstance(stacked, dict):
        for k in stacked:
            _copy_into(stacked[k], layer[k], r)
    elif stacked.device.type != "meta":
        stacked[r].copy_(layer)


def _index(tree, r: int):
    """Views of repeat ``r`` of a stacked tree of dicts."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _unbind(tree, reps: int):
    """The ``reps`` repeats of a stacked tree of dicts, as a list of trees
    of views."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, reps) for k, v in tree.items()}
        return [{k: v[r] for k, v in per_key.items()} for r in range(reps)]
    return list(torch.unbind(tree, 0))


def stack_cache(cfg, batch: int, cache_len: int, window_override=None,
                device=None):
    """Caches mirroring the segment structure (stacked over repeats)."""
    out = []
    for kinds, reps in cfg.segments():
        seg = {}
        for i, kind in enumerate(kinds):
            one = init_block_cache(cfg, kind, batch, cache_len,
                                   window_override, device=device)
            seg[f"b{i}"] = {k: v.new_zeros((reps,) + tuple(v.shape))
                            for k, v in one.items()}
        out.append(seg)
    return out


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str):
    """``fn`` under the ``remat`` policy (mode ``"train"``)."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _dots_policy))


def apply_stack(stack_params, cfg, x, positions, *, mode: str, caches=None,
                index: Optional[int] = None, window_override=None,
                impl: str = "ref", remat: str = "none",
                remat_group: int = 1):
    """Run all segments.  Returns (x, caches, aux): in decode the stacked
    caches, written in place, else None; ``aux`` the sum of the ``moe``
    blocks' aux losses (0 without one).  ``remat`` and ``remat_group``
    apply in mode ``"train"`` only, as in the reference."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r}: one of {REMATS}")
    if mode != "train":
        remat = "none"
    aux_total = 0.0
    for si, (kinds, reps) in enumerate(cfg.segments()):
        layers = _unbind(stack_params[si], reps)
        g = remat_group if (mode == "train" and remat_group > 1
                            and reps % remat_group == 0) else 1

        def group(h, r0, layers=layers, kinds=kinds, si=si):
            aux = 0.0
            for r in range(r0, r0 + g):
                cl = _index(caches[si], r) if mode == "decode" else None
                for i, kind in enumerate(kinds):
                    h, _, a = apply_block(
                        unshard(layers[r][f"b{i}"]), kind, h, positions, cfg,
                        mode=mode,
                        cache=cl[f"b{i}"] if cl is not None else None,
                        index=index, window_override=window_override,
                        impl=impl)
                    aux = aux + a
            return h, aux

        run = _remat(group, remat)
        for r0 in range(0, reps, g):
            x, aux = run(x, r0)
            aux_total = aux_total + aux
    return x, (caches if mode == "decode" else None), aux_total


# ---------------------------------------------------------------------------
# Full decoder-only model
# ---------------------------------------------------------------------------


def init_lm_meta(gen, cfg) -> Dict[str, Any]:
    """Full LM parameter tree as ParamMeta (value + logical axes); ``gen``
    None builds the shapes on the meta device."""
    pv = padded_vocab(cfg)
    dt = L.dtype_of(cfg)
    meta: Dict[str, Any] = {
        "embed": {"table": pm(L.normal_init(gen, (pv, cfg.d_model), 0.02, dt),
                              "vocab", "embed")},
        "final_ln": L.init_rmsnorm(gen, cfg.d_model, cfg),
        "stack": init_stack(gen, cfg),
    }
    if not cfg.tie_embeddings:
        meta["head"] = {"w": pm(L.normal_init(gen, (cfg.d_model, pv), 0.02, dt),
                                "embed", "vocab")}
    return meta


def init_lm(gen, cfg):
    """Returns (params values, logical axes) for the decoder-only LM."""
    return split_meta(init_lm_meta(gen, cfg))


def lm_logits(params, cfg, x) -> torch.Tensor:
    """f32 logits over the padded vocab; the padding is masked to −1e30
    (in place, or, on a vocab-sharded DTensor, by a mask)."""
    params = unshard({k: params[k] for k in ("final_ln", "head", "embed")
                      if k in params})
    x = L.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    if "head" in params:
        logits = L.logits_f32(x, params["head"]["w"])
    else:
        logits = L.unembed(params["embed"], x)
    pv = logits.shape[-1]
    if pv != cfg.vocab_size and sharded():
        pad = torch.arange(pv, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    elif pv != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return constrain(logits, "act_batch", None, "vocab")


def _positions(cfg, pos: torch.Tensor) -> torch.Tensor:
    if cfg.mrope_sections is not None:
        return pos[..., None].expand(pos.shape + (3,))
    return pos


def _lm_hidden(params, cfg, tokens, positions, *, extra_embeds, mode: str,
               remat: str, window_override, impl: str, remat_group: int):
    """The embedding and the stack: (the final residual stream, the
    ``moe`` blocks' aux loss)."""
    x = _act(L.embed(unshard(params["embed"]), tokens))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    if positions is None:
        b, s = x.shape[:2]
        positions = _positions(cfg, torch.arange(
            s, dtype=torch.int32, device=tokens.device).expand(b, s))
    x = _act(x)
    x, _, aux = apply_stack(params["stack"], cfg, x, positions, mode=mode,
                            window_override=window_override, impl=impl,
                            remat=remat, remat_group=remat_group)
    return x, aux


def lm_forward(params, cfg, tokens, positions=None, *, extra_embeds=None,
               mode: str = "prefill", remat: str = "none",
               window_override=None, impl: str = "ref",
               last_only: bool = False, remat_group: int = 1):
    """Train or prefill forward.  tokens: [B,S] int.  ``extra_embeds``:
    optional [B,S_front,d] frontend embeddings (VLM patches) prepended to
    the token embeddings.  ``mode`` is ``"prefill"`` (the port's default:
    serving) or ``"train"`` (the reference's default), which applies
    ``remat``/``remat_group``.  ``last_only``: logits for the final
    position only (the serving prefill).  Returns (logits [B,S(+S_front),V]
    or [B,1,V], the ``moe`` blocks' aux loss: 0 without one).  The final
    norm and the logits are the device phase ``lm.head``."""
    x, aux = _lm_hidden(params, cfg, tokens, positions,
                        extra_embeds=extra_embeds, mode=mode, remat=remat,
                        window_override=window_override, impl=impl,
                        remat_group=remat_group)
    if last_only:
        x = x[:, -1:]
    return phase_call("lm.head", lambda y: lm_logits(params, cfg, y), x), aux


def xent(logits, labels) -> torch.Tensor:
    """Mean next-token cross-entropy of f32 ``logits`` [B,S,V] against
    ``labels`` [B,S] int, over the labels that are not ``-100``."""
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    # on vocab-sharded logits each rank's gather is masked to its slice of
    # the vocab and summed by the constrain (the identity outside a
    # sharding context)
    gold = constrain(torch.gather(logits, -1, labels.clamp(min=0)[..., None]),
                     "act_batch", None, None)[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def lm_loss(params, cfg, tokens, labels, *, remat: str = "full",
            impl: str = "ref", extra_embeds=None, remat_group: int = 1,
            positions=None) -> torch.Tensor:
    """Next-token cross-entropy over the padded vocab (its padding is
    masked to −1e30), mean over the labels that are not ``-100``, plus the
    ``moe`` blocks' aux loss.  labels: [B,S] int, the text tokens' (the
    logits of ``extra_embeds`` are dropped).  The final norm, the logits
    and the cross-entropy are the device phase ``lm.head``."""
    x, aux = _lm_hidden(params, cfg, tokens, positions,
                        extra_embeds=extra_embeds, mode="train", remat=remat,
                        window_override=None, impl=impl,
                        remat_group=remat_group)

    def head(y):
        logits = lm_logits(params, cfg, y)
        if extra_embeds is not None:
            logits = logits[:, extra_embeds.shape[1]:]
        return xent(logits, labels)

    return phase_call("lm.head", head, x) + aux


def lm_decode_step(params, cfg, token, caches, index: int, positions=None,
                   *, window_override=None):
    """One-token decode.  token: [B,1] int; ``index`` a host int.  Returns
    (logits [B,1,V], caches), the caches written in place."""
    x = _act(L.embed(unshard(params["embed"]), token))
    if positions is None:
        positions = _positions(cfg, torch.full(
            token.shape, index, dtype=torch.int32, device=token.device))
    x, caches, _ = apply_stack(params["stack"], cfg, x, positions,
                               mode="decode", caches=caches, index=index,
                               window_override=window_override)
    return lm_logits(params, cfg, x), caches


def lm_axes(cfg):
    """Logical axes tree matching init_lm's output, built on the meta
    device (nothing allocated)."""
    return init_lm(None, cfg)[1]


def lm_param_shapes(cfg):
    """The LM's parameter tree as meta tensors (shapes and dtypes, no
    allocation)."""
    return init_lm(None, cfg)[0]
