"""Core layers: the port's copy of ``repro/models/layers.py``.

Initializers draw f32 normals from a ``torch.Generator`` on its device and
cast to the config's dtype, as the reference's ``normal_init`` draws f32
and casts.  A ``gen`` of ``None`` builds only the shapes, on the ``meta``
device: nothing is drawn or allocated (``Model.param_shapes``).  Every
``init_*`` of the language model returns a tree of
:class:`~repro_torch.models.sharding.ParamMeta` (value + logical axes);
``split_meta`` separates them.  Apply functions take the value tree.  The
detectors use ``normal_init``, ``fan_in_init`` and ``rmsnorm`` with f32
params, as before.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.shardctx import is_dtensor, local_box
from repro_torch.models.sharding import pm


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def device_of(gen: Optional[torch.Generator]) -> torch.device:
    """Where an init with ``gen`` builds its tensors: ``gen``'s device, or
    ``meta`` for a shapes-only build (``gen`` None)."""
    return torch.device("meta") if gen is None else gen.device


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def normal_init(gen: Optional[torch.Generator], shape: Sequence[int],
                stddev: float, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """``stddev · N(0, 1)`` drawn in f32 from ``gen`` on its device, cast
    to ``dtype``."""
    if gen is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = stddev * torch.randn(tuple(shape), generator=gen, device=gen.device)
    return x if dtype == torch.float32 else x.to(dtype)


def fan_in_init(gen: Optional[torch.Generator], shape: Sequence[int],
                fan_in: Optional[int] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in); ``fan_in`` defaults to ``shape[0]``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return normal_init(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


def init_rmsnorm(gen, d: int, cfg):
    return {"scale": pm(torch.ones(d, dtype=dtype_of(cfg),
                                   device=device_of(gen)), "embed")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(gen, d: int, cfg):
    dt, dev = dtype_of(cfg), device_of(gen)
    return {"scale": pm(torch.ones(d, dtype=dt, device=dev), "embed"),
            "bias": pm(torch.zeros(d, dtype=dt, device=dev), "embed")}


def layernorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Linear / embedding
# ---------------------------------------------------------------------------


def init_dense(gen, d_in: int, d_out: int, cfg, axes=("embed", "mlp"),
               bias: bool = False):
    dt = dtype_of(cfg)
    p = {"w": pm(fan_in_init(gen, (d_in, d_out), dtype=dt), *axes)}
    if bias:
        p["b"] = pm(torch.zeros(d_out, dtype=dt, device=device_of(gen)),
                    axes[1])
    return p


def dense(params, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


def init_embedding(gen, vocab: int, d: int, cfg):
    return {"table": pm(normal_init(gen, (vocab, d), 0.02, dtype_of(cfg)),
                        "vocab", "embed")}


def embed(params, ids: torch.Tensor) -> torch.Tensor:
    table = params["table"]
    if _vocab_sharded(table):
        return _vocab_parallel_embed(table, ids)
    return F.embedding(ids, table)


def _vocab_sharded(table) -> bool:
    return is_dtensor(table) and any(p.is_shard(0) for p in table.placements)


def _vocab_parallel_embed(table, ids):
    """The gather from a DTensor table sharded on its vocab dim: each rank
    looks up the ids in its slice of the vocab and zeroes the rest, and
    the result is a partial sum over the vocab's mesh axes (reduced where
    the caller places it).  The ids are replicated over those axes."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    (rows, _), (start, _) = local_box(table.shape, mesh, table.placements)
    ids_pl = tuple(ids.placements)
    for p, ip in zip(table.placements, ids_pl):
        if p.is_shard(0) and not ip.is_replicate():
            raise ValueError(f"ids {ids.placements} are split over the "
                             f"vocab's mesh axes {table.placements}")
    out_pl = tuple(Partial() if p.is_shard(0) else ip
                   for p, ip in zip(table.placements, ids_pl))
    # each rank's table grad sums its own batch rows: a partial sum over
    # the axes that split the ids
    grad_pl = tuple(Partial() if p.is_replicate() and ip.is_shard() else p
                    for p, ip in zip(table.placements, ids_pl))

    def local(t, i):
        rel = i - start
        inside = (rel >= 0) & (rel < rows)
        out = F.embedding(rel.clamp(0, rows - 1), t)
        return out.masked_fill(~inside[..., None], 0)

    return local_map(local, (out_pl,), in_placements=(table.placements, ids_pl),
                     in_grad_placements=(grad_pl, ids_pl),
                     device_mesh=mesh)(table, ids)


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Project hidden states to logits with the (tied or separate) table,
    in f32 (:func:`logits_f32`)."""
    return logits_f32(x, params["table"], tied=True)


# ---------------------------------------------------------------------------
# The LM head's f32 logits on the bf16 tensor cores
# ---------------------------------------------------------------------------

#: Calls of the head product on a card: its forward and its split backward.
#: A run reads them to show that every step took the tensor cores.
HEAD_GEMMS = {"forward": 0, "split_backward": 0}

#: Elements of the f32 logits' gradient split at once: the backward walks
#: blocks of vocab columns whose three bf16 terms and f32 rest take ~0.7 GB,
#: less than the f32 copy of granite's table that the product never makes.
SPLIT_ELEMS = 1 << 26

#: The most products one tensor-core GEMM sums before an f32 add joins its
#: sum to the rest.  The tensor cores accumulate in f32 but truncate, so
#: their error grows with a GEMM's K; in pieces of 1,024 it stays under the
#: f32 FMA GEMM's own distance from f64 (granite-3-8b's head on an H100).
TC_K = 1024


def reset_head_gemms() -> None:
    for k in HEAD_GEMMS:
        HEAD_GEMMS[k] = 0


def logits_f32(x: torch.Tensor, w: torch.Tensor, *,
               tied: bool = False) -> torch.Tensor:
    """f32 logits of the hidden states ``x [..., d]`` against the head
    ``w [d, V]``, or against the embedding table ``w [V, d]`` (``tied``).

    bf16 operands on a card take :class:`HeadProduct`: the same exact
    products, summed in f32 on the bf16 tensor cores.  Anything else (the
    CPU, f32 models, DTensors) multiplies f32 copies: the reference's
    maths."""
    if (x.is_cuda and x.dtype == w.dtype == torch.bfloat16
            and not is_dtensor(x) and not is_dtensor(w)):
        wt = w.t() if tied else w
        out = HeadProduct.apply(x.reshape(-1, x.shape[-1]), wt)
        return out.view(*x.shape[:-1], wt.shape[1])
    wf = w.float()
    return torch.matmul(x.float(), wf.t() if tied else wf)


def mm_f32(a: torch.Tensor, b: torch.Tensor,
           acc: Optional[torch.Tensor] = None,
           whole: bool = False) -> torch.Tensor:
    """``acc + a @ b`` (``a @ b`` without ``acc``, which is written in
    place) of bf16 operands, in f32: tensor-core GEMMs (``aten::mm.dtype``,
    ``aten::addmm.dtype``) over pieces of at most ``TC_K`` of the inner
    dim, each piece's sum added in f32 by the GEMM's epilogue; ``whole``
    sums the whole inner dim in one GEMM.  Off a card, where those ops
    have no kernel, f32 GEMMs of the same values: every product of two bf16
    values is exact in f32, so both sum the same products."""
    k = a.shape[1]
    pieces = 1 if whole else -(-k // TC_K)
    kc = k if pieces == 1 else -(-k // (64 * pieces)) * 64
    for k0 in range(0, k, kc):
        ak, bk = a[:, k0:k0 + kc], b[k0:k0 + kc]
        if not a.is_cuda:
            ak, bk = ak.float(), bk.float()
            acc = torch.mm(ak, bk) if acc is None else acc.addmm_(ak, bk)
        elif acc is None:
            acc = torch.mm(ak, bk, out_dtype=torch.float32)
        else:
            torch.addmm(acc, ak, bk, out_dtype=torch.float32, out=acc)
    return acc


def split3(g: torch.Tensor) -> torch.Tensor:
    """The f32 ``g`` as three bf16 terms ``[3, *g.shape]`` that sum back
    to it exactly: hi = bf16(g), mid = bf16(g − hi), lo = bf16(g − hi −
    mid).  Each rest is exact in f32 (it holds the bits that the term
    before dropped), and lo holds the last 8 of g's 24 significant bits,
    for every |g| ≥ 2^-110 (below, lo is bf16's subnormal)."""
    t = torch.empty((3,) + tuple(g.shape), dtype=torch.bfloat16,
                    device=g.device)
    t[0].copy_(g)
    rest = torch.sub(g, t[0])
    t[1].copy_(rest)
    rest.sub_(t[1])
    t[2].copy_(rest)
    return t


def head_grads(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
               need_dx: bool = True, need_dw: bool = True,
               dtype: Optional[torch.dtype] = None):
    """``(g·wᵀ, xᵀ·g)`` for the f32 logits' gradient ``g [N, V]``, bf16
    ``x [N, d]`` and ``w [d, V]``, each rounded once to ``dtype`` (x's
    and w's by default) from f32: g in three bf16 terms (:func:`split3`),
    a block of vocab columns at a time.  The small terms go first, each
    whole in one GEMM (dw: mid and lo stacked along N, x repeated): their
    sums are 2^-8 of hi's and below, and so is the truncation's error.
    Then hi in pieces of ``TC_K`` (:func:`mm_f32`).  Either result is None
    where not needed."""
    n, v = g.shape
    blocks = -(-n * v // SPLIT_ELEMS)
    cols = v if blocks <= 1 else -(-v // (64 * blocks)) * 64  # aligned
    x2 = x.repeat(2, 1) if need_dw else None
    dx = None
    dw = torch.empty_like(w, dtype=dtype or w.dtype) if need_dw else None
    for v0 in range(0, v, cols):
        v1 = min(v, v0 + cols)
        t = split3(g[:, v0:v1])
        if need_dx:
            wc = w[:, v0:v1].t()
            dx = mm_f32(t[2], wc, dx, whole=True)
            dx = mm_f32(t[1], wc, dx, whole=True)
            dx = mm_f32(t[0], wc, dx)
        if need_dw:
            small = t[1:].view(2 * n, v1 - v0)
            if dw.stride(0) == 1:       # a [V, d] table seen as [d, V]
                part = mm_f32(small.t(), x2, whole=True)
                dw.t()[v0:v1] = mm_f32(t[0].t(), x, part)
            else:
                part = mm_f32(x2.t(), small, whole=True)
                dw[:, v0:v1] = mm_f32(x.t(), t[0], part)
    if dx is not None:
        dx = dx.to(dtype or x.dtype)
    return dx, dw


class HeadProduct(torch.autograd.Function):
    """``x [N, d] @ w [d, V]`` → f32 logits, for bf16 ``x`` and ``w``.
    Forward: tensor-core GEMMs written in f32 (:func:`mm_f32`); it keeps
    the bf16 operands for backward, not f32 copies.  Backward:
    :func:`head_grads`, whose results round to bf16 where the f32 copies'
    backward rounded them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        HEAD_GEMMS["forward"] += 1
        return mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        HEAD_GEMMS["split_backward"] += 1
        return head_grads(g, x, w, *ctx.needs_input_grad)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim//2]


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [..., seq, heads, hd] rotated by ``angles [..., seq, hd/2]`` in
    f32, cast back to x's dtype."""
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 10_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  positions_3d: [..., seq, 3] (temporal,
    height, width ids); ``sections`` splits the head_dim//2 frequency bands
    between them."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device))  # [half] in {0, 1, 2}
    pos = positions_3d.float()[..., sec_ids]  # [..., seq, half]
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# MLP blocks
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg, d_model: Optional[int] = None,
             d_ff: Optional[int] = None):
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    p = {"wi": init_dense(gen, d, f, cfg, axes=("embed", "mlp"))}
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = init_dense(gen, d, f, cfg, axes=("embed", "mlp"))
    p["wo"] = init_dense(gen, f, d, cfg, axes=("mlp", "embed"))
    return p


def mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """``jax.nn.gelu`` is the tanh approximation by default, so is this."""
    h = dense(params["wi"], x)
    if act == "swiglu":
        h = F.silu(dense(params["wg"], x)) * h
    elif act == "geglu":
        h = F.gelu(dense(params["wg"], x), approximate="tanh") * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        h = F.relu(h)
    return dense(params["wo"], h)
