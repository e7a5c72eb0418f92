"""The plain reference of the decoder-only LM: the forward pass, the loss
and (by autograd) its gradients, in float32 with TF32 off.

It follows the block the configuration states, written from its
equations and not from the program: token embedding; per layer
``x += attn(rmsnorm(x))`` (GQA, rotary positions on the first and second
halves of each head, causal softmax at 1/sqrt(head_dim)) and ``x +=
ffn(rmsnorm(x))`` (SwiGLU, or a top-k mixture of experts); a final
rmsnorm and the logits over the real vocabulary against the tied
embedding or the head.  The mixture routes each token to its top-k
of the router's E experts by the f32 router's softmax, keeps a token's
choice while its expert's queue in the sequence (every first choice in
order, then every second) is under the capacity ``int(cf·S·k/E)``,
renormalises the kept gates, and adds the Switch load-balance loss
``coef·E·Σ frac·prob`` of the first choices to the loss.  A layer that
holds a share of the E experts (``layout.router_experts``) routes over
all of them, renormalises by every kept choice, held or not, and adds
only its held experts' part of the output.

A forward pass may take its expert choices from another run (a
:class:`Route`'s ``replay``: a bf16 program routes a near-tie the other
way from run to run, and the reference then follows its choices in
place of its own argmaxes).  Its gates, and so the gate values, the
capacity queue, the drops, the renormalisation and the aux loss, stay
its own f32 ones; the route gap says how far the choices taken lie from
its own: the widest by which the router logit of a replayed choice lies
below the k-th largest at its token.

``precision="fp8"`` is the control: every product whose operands the
configuration states in bf16 rounds both operands to float8 e4m3 (one
scale a tensor, its amax at 448) before the f32 product, forward and
backward; the f32 router stays f32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.layout import block_kind, head_dim, router_experts

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _FakeFp8(torch.autograd.Function):
    """Round to float8 e4m3 at one scale a tensor; the gradient passes
    straight through (and is itself rounded where it enters a product)."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    q = (x.float() * scale).to(torch.float8_e4m3fn)
    return (q.float() / scale).to(x.dtype)


def make_mm(precision: str):
    """The product ``x @ w`` of the given precision."""
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return lambda x, w: torch.matmul(_FakeFp8.apply(x), _FakeFp8.apply(w))
    raise ValueError(f"precision {precision!r}: 'f32' or 'fp8'")


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x [B, S, H, hd] at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h, p, m, mm):
    b, s, _ = h.shape
    hd, nq, nkv = head_dim(m), m["n_heads"], m["n_kv_heads"]
    q = mm(h, p["wq"]).reshape(b, s, nq, hd)
    k = mm(h, p["wk"]).reshape(b, s, nkv, hd)
    v = mm(h, p["wv"]).reshape(b, s, nkv, hd)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    # query head j reads key/value head j // (nq / nkv)
    k = k.repeat_interleave(nq // nkv, dim=2)
    v = v.repeat_interleave(nq // nkv, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    future = torch.ones(s, s, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, nq * hd)
    return mm(out, p["wo"])


def swiglu(x, wi, wg, wo, mm):
    return mm(mm(x, wi) * F.silu(mm(x, wg)), wo)


class Route:
    """The routing of one forward pass's MoE layers.  ``replay``: a layer,
    the top-k choices to take in place of the argmaxes (``[B, S]`` expert
    ids each, in choice order); ``shift``: the planted fault, each token's
    last choice moved to its next-best expert.  After the pass ``taken``
    holds each layer's choices, ``gap`` the route gap (0 where nothing is
    replayed; inf where a layer's replayed choices do not cover its
    batch) and ``flips`` the replayed choices below the k-th logit, of
    ``choices``."""

    def __init__(self, replay=None, shift: bool = False):
        self.replay, self.shift = replay, shift
        self.taken, self.gap, self.flips, self.choices = [], 0.0, 0, 0

    def layer(self, h, p, m, mm, layer: int):
        given = None if self.replay is None else self.replay[layer]
        out, aux, taken, gap, flips = moe(h, p, m, mm, given, self.shift)
        self.taken.append(taken)
        self.gap = max(self.gap, gap)
        self.flips += flips
        self.choices += sum(t.numel() for t in taken) * (given is not None)
        return out, aux


def moe(h, p, m, mm, given=None, shift: bool = False):
    """Top-k mixture with per-sequence capacity over the router's experts,
    of which the layer holds the first ``n_experts``; ``given``
    replays choices (see :class:`Route`).  Returns (out, aux, the choices
    taken, the route gap, the replayed choices below the k-th logit)."""
    b, s, d = h.shape
    e, k = router_experts(m), m["experts_per_token"]
    scores = h @ p["router"]  # f32 router
    gates = torch.softmax(scores, dim=-1)
    gap, flips = 0.0, 0
    if given is not None:
        if len(given) != k or any(tuple(i.shape) != (b, s) for i in given):
            given, gap = None, math.inf
        else:
            given = [i.to(h.device) for i in given]
    g = gates
    choices = []
    for c in range(k + shift):
        idx = torch.argmax(g, dim=-1) if given is None else given[c]
        onehot = F.one_hot(idx, e).to(gates.dtype)
        choices.append((idx, onehot, (g * onehot).sum(-1)))
        g = g * (1.0 - onehot)
    if shift:
        del choices[k - 1]
    if given is not None:
        with torch.no_grad():
            sc = scores.detach()
            kth = sc.topk(k, dim=-1).values[..., -1]
            for idx in given:
                below = kth - sc.gather(-1, idx[..., None])[..., 0]
                gap = max(gap, float(below.max()))
                flips += int((below > 0).sum())
    aux = (e * torch.sum(choices[0][1].mean((0, 1)) * gates.mean((0, 1)))
           * m["router_aux_coef"])
    cap = max(int(m["capacity_factor"] * s * k / e), k, 1)
    prior = torch.zeros(b, 1, e, device=h.device)
    kept = []
    for idx, onehot, gv in choices:
        queue = torch.cumsum(onehot, dim=1) - onehot + prior
        prior = prior + onehot.sum(1, keepdim=True)
        keep = (queue * onehot).sum(-1) < cap
        kept.append((idx, keep, gv * keep))
    denom = torch.clamp(sum(w for _, _, w in kept), min=1e-9)
    xs = h.reshape(b * s, d)
    out = torch.zeros_like(xs)
    for ex in range(m["n_experts"]):
        rows, weights = [], []
        for idx, keep, w in kept:
            sel = ((idx == ex) & keep).reshape(-1).nonzero()[:, 0]
            rows.append(sel)
            weights.append((w / denom).reshape(-1)[sel])
        rows_t = torch.cat(rows)
        if rows_t.numel() == 0:
            continue
        y = swiglu(xs[rows_t], p["wi"][ex], p["wg"][ex], p["wo"][ex], mm)
        out = out.index_add(0, rows_t, y * torch.cat(weights)[:, None])
    return (out.reshape(b, s, d), aux, [idx for idx, _, _ in choices], gap,
            flips)


def layer_params(w: Dict[Tuple, torch.Tensor], layer: int, kind: str) -> dict:
    """One layer's f32 weights from the stacked leaves ``w`` ({path:
    tensor})."""
    pre = ("stack", 0, "b0")
    p = {name: w[pre + ("attn", name, "w")][layer]
         for name in ("wq", "wk", "wv", "wo")}
    p["ln1"] = w[pre + ("ln1", "scale")][layer]
    p["ln2"] = w[pre + ("ln2", "scale")][layer]
    if kind == "attn":
        for name in ("wi", "wg", "wo"):
            p["mlp_" + name] = w[pre + ("mlp", name, "w")][layer]
    else:
        for name in ("router", "wi", "wg", "wo"):
            p["moe_" + name] = w[pre + ("moe", name)][layer]
    return {k: v.float() for k, v in p.items()}


def hidden(w, m, tokens, mm, route: Optional[Route] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final-normed hidden states [B, S, d] f32 of ``tokens`` and the
    summed aux loss; a MoE's layers route through ``route`` where
    given."""
    kind = block_kind(m)
    eps = m["norm_eps"]
    x = F.embedding(tokens.long(), w[("embed", "table")]).float()
    aux = torch.zeros((), device=x.device)
    for layer in range(m["n_layers"]):
        p = layer_params(w, layer, kind)
        x = x + attention(rmsnorm(x, p["ln1"], eps), p, m, mm)
        h = rmsnorm(x, p["ln2"], eps)
        if kind == "attn":
            x = x + swiglu(h, p["mlp_wi"], p["mlp_wg"], p["mlp_wo"], mm)
        else:
            route = Route() if route is None else route
            out, a = route.layer(h, {k[4:]: v for k, v in p.items()
                                     if k.startswith("moe_")}, m, mm, layer)
            x = x + out
            aux = aux + a
    return rmsnorm(x, w[("final_ln", "scale")].float(), eps), aux


def logits(w, m, x, mm) -> torch.Tensor:
    """Logits over the real vocabulary."""
    v = m["vocab_size"]
    if m["tie_embeddings"]:
        return mm(x, w[("embed", "table")][:v].float().t())
    return mm(x, w[("head", "w")][:, :v].float())


def loss(w, m, tokens, labels, mm, route: Optional[Route] = None
         ) -> torch.Tensor:
    """Mean next-token cross-entropy plus the aux loss."""
    x, aux = hidden(w, m, tokens, mm, route)
    lg = logits(w, m, x, mm)
    labels = labels.long()
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0) + aux


def last_logits(w, m, tokens, mm) -> torch.Tensor:
    """The last position's logits [B, V] f32 of a prompt batch."""
    with torch.no_grad():
        x, _ = hidden(w, m, tokens, mm)
        return logits(w, m, x[:, -1], mm)


def f32_leaves(w: Dict[Tuple, torch.Tensor],
               paths: Optional[list] = None) -> Dict[Tuple, torch.Tensor]:
    """f32 copies of the leaves that require grad."""
    return {k: v.detach().float().requires_grad_(True)
            for k, v in w.items() if paths is None or k in paths}
