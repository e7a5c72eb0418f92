"""Public wrappers over the DP clip+noise kernels (the counterpart of
``repro/kernels/ops.py``'s ``dp_clip_noise`` / ``dp_clip_noise_tree``).

The route is decided by the tensors' device alone: the CUDA kernels for
CUDA tensors, the plain versions in ``kernels/ref.py`` for CPU tensors.
σ is a Python float here (``core/rounds.py`` ``_dp_sigma``), so it goes to
the kernel as an argument; there is no traced σ to fold into the noise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dp_clip_noise as _dp
from repro_torch.kernels.ref import clip_scale
from repro_torch.tree import flatten_rows, unflatten_rows


def dp_clip_noise_rows(x: torch.Tensor, noise: torch.Tensor, clip: float,
                       sigma: float):
    """Per-row clip to L2 ``clip`` + σ-scaled noise over the stacked
    updates ``x [R, P]``: one shared norm per row (client-level DP).
    Two kernel launches on the card.  Returns ``(out, pre_clip_norm [R])``."""
    norm = torch.sqrt(_dp.sumsq_rows(x))
    out = _dp.scale_noise_rows(x, noise, clip_scale(norm, clip), sigma)
    return out, norm


def dp_clip_noise(x: torch.Tensor, noise: torch.Tensor, clip: float,
                  sigma: float):
    """One flat update ``x [N]``.  Returns ``(out [N], norm)``."""
    out, norm = dp_clip_noise_rows(x.reshape(1, -1), noise.reshape(1, -1),
                                   clip, sigma)
    return out.reshape(x.shape), norm[0]


def dp_clip_noise_tree(tree, noise: torch.Tensor, clip: float, sigma: float):
    """One update tree with a SHARED global norm across its leaves;
    ``noise`` is flat ``[P]`` in leaf order (sorted keys, as the reference
    splits its per-leaf keys).  Returns ``(noised_tree, pre_clip_norm)``."""
    flat = flatten_rows(tree, 0).float().contiguous()
    out, norm = dp_clip_noise(flat, noise.contiguous(), clip, sigma)
    return unflatten_rows(out, tree), norm
