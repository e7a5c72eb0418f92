"""The paper's own detector model: a feed-forward network for tabular
network-traffic features (Marfo et al. 2022, ref [1] of the paper).

d_in -> hidden -> hidden/2 -> n_classes with ReLU.  Params are a functional
dict ``{"l1": {"w", "b"}, "l2": ..., "out": ...}`` in the JAX package's
layout (``w`` is ``[in, out]``, ``x @ w + b``), so ``torch.func`` can
``vmap``/``grad`` over it and ``convert.py`` carries weights across as they
are.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def init_mlp(gen: torch.Generator, d_in: int, hidden: int = 128,
             n_classes: int = 2):
    """Random init from ``gen`` on ``gen.device``: N(0, 1/fan_in) weights,
    zero biases."""

    def lin(a, b):
        w = torch.randn(a, b, generator=gen, device=gen.device) / math.sqrt(a)
        return {"w": w, "b": torch.zeros(b, device=gen.device)}

    return {
        "l1": lin(d_in, hidden),
        "l2": lin(hidden, hidden // 2),
        "out": lin(hidden // 2, n_classes),
    }


def mlp_logits(params, x):
    h = torch.relu(x @ params["l1"]["w"] + params["l1"]["b"])
    h = torch.relu(h @ params["l2"]["w"] + params["l2"]["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


def cross_entropy(logits, y):
    """Mean CE from logits; ``y`` is an integer label vector."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return torch.mean(lse - gold)


def mlp_loss(params, batch):
    """batch: {"x": [b, d], "y": [b] int} -> mean CE."""
    return cross_entropy(mlp_logits(params, batch["x"]), batch["y"])


def mlp_predict_proba(params, x):
    return torch.softmax(mlp_logits(params, x), dim=-1)


def accuracy(params, x, y) -> torch.Tensor:
    pred = torch.argmax(mlp_logits(params, x), dim=-1)
    return torch.mean((pred == y).float())


def auc_roc_torch(scores, labels) -> torch.Tensor:
    """Rank AUC on the device (Mann-Whitney U normalisation) over the last
    axis, so ``scores [L, n]`` gives one AUC a lane; without average-rank
    tie correction: scores are continuous softmax outputs.  :func:`auc_roc`
    is the tie-exact host oracle."""
    s = scores.float()
    y = labels.float()
    n = s.shape[-1]
    n_pos = torch.sum(y, dim=-1)
    n_neg = n - n_pos
    order = torch.argsort(s, dim=-1, stable=True)
    ranks = torch.zeros_like(s).scatter_(
        -1, order, torch.arange(1, n + 1, dtype=torch.float32,
                                device=s.device).expand(s.shape))
    u = torch.sum(ranks * y, dim=-1) - n_pos * (n_pos + 1.0) / 2.0
    return u / torch.clamp(n_pos * n_neg, min=1.0)


def auc_roc(scores, labels) -> float:
    """Rank-based AUC-ROC with average ranks for ties (host, f64)."""
    s = np.asarray(scores, dtype=np.float64)
    y = np.asarray(labels)
    pos = s[y == 1]
    neg = s[y == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([neg, pos]), kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ranks for ties
    allv = np.concatenate([neg, pos])
    sorted_v = allv[order]
    i = 0
    while i < len(sorted_v):
        j = i
        while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = np.mean(ranks[order[i : j + 1]])
        i = j + 1
    r_pos = ranks[len(neg):].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))
