"""Differential privacy for FL model updates (paper §IV): the port's copy
of ``repro/core/dp.py``.

* ``paper``   — ``∇w ← ∇w + N(0, σ²)`` with a fixed σ, as the paper writes
                it (no clipping, so the sensitivity is only assumed).
* ``clipped`` — per-client L2 clipping of the whole update to S, then
                σ = S·sqrt(2 ln(1.25/δ))/ε; on the card this is the fused
                clip+noise CUDA kernel (``kernels/ops.py``).

Noise is an operand: a standard-normal tensor laid out like the update
(flat, in leaf order), drawn by the caller from its ``torch.Generator`` or
injected by a test.  The RDP accountant is ``privacy/accountant.py``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import clip_scale
from repro_torch.tree import tree_leaves, tree_map, unflatten_rows


def gaussian_sigma(epsilon: float, delta: float, sensitivity: float = 1.0) -> float:
    """Classic Gaussian-mechanism noise scale for one release."""
    if epsilon <= 0:
        raise ValueError("epsilon must be > 0")
    return sensitivity * math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def gaussian_sigma_rt(epsilon, delta: float, sensitivity=1.0):
    """:func:`gaussian_sigma` without validation, in the reference's
    operation order (callers own the ε > 0 contract).  ``epsilon`` and
    ``sensitivity`` may be per-lane f32 tensors: the constant then divides
    as an f32 tensor, as a traced ε divides it in the reference (torch's
    ``float / tensor`` multiplies by the reciprocal, one rounding more)."""
    c = math.sqrt(2.0 * math.log(1.25 / delta))
    if isinstance(epsilon, torch.Tensor):
        return sensitivity * (torch.full_like(epsilon, c) / epsilon)
    return sensitivity * (c / epsilon)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree_leaves(tree)))


def clip_by_global_norm(tree, clip: float):
    """Scale the whole update so its global L2 norm is <= clip."""
    norm = global_norm(tree)
    scale = clip_scale(norm, clip)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm


def add_gaussian_noise(tree, sigma: float, noise: torch.Tensor):
    """``x + σ·n`` per leaf; ``noise`` is flat ``[P]`` in leaf order."""
    n = unflatten_rows(noise, tree)
    return tree_map(lambda x, z: (x + sigma * z.float()).to(x.dtype), tree, n)


def privatize_update(tree, noise: torch.Tensor, *, mode: str, clip: float,
                     sigma: float):
    """The paper's DP step on ONE client's update tree.  ``clipped`` goes
    through the fused kernel route (``kernels/ops.py``).
    Returns ``(noised_update, pre_clip_norm)``."""
    if mode == "paper":
        return add_gaussian_noise(tree, sigma, noise), global_norm(tree)
    if mode == "clipped":
        return kops.dp_clip_noise_tree(tree, noise, clip, sigma)
    raise ValueError(mode)


def privatize_rows(deltas: torch.Tensor, noise: torch.Tensor, *, mode: str,
                   clip, sigma, out=None):
    """:func:`privatize_update` for every client at once over the stacked
    flat updates ``deltas [R, P]`` (the counterpart of the reference's
    ``jax.vmap(privatize)``); ``clip`` and ``sigma`` are floats or ``[R]``
    tensors, one value a row.  The noised rows go into ``out`` where
    given (``deltas`` itself too: an LM's rows are noised where they
    lie).  Returns ``(noised [R, P], norms [R])``."""
    if mode == "paper":
        norms = torch.sqrt(torch.sum(deltas * deltas, dim=1))
        if isinstance(sigma, torch.Tensor):
            sigma = sigma[:, None]
        if out is None:
            return deltas + sigma * noise, norms
        return torch.add(deltas, sigma * noise, out=out), norms
    if mode == "clipped":
        return kops.dp_clip_noise_rows(deltas.contiguous(),
                                       noise.contiguous(), clip, sigma, out)
    raise ValueError(mode)
