"""Plain PyTorch versions of the DP clip+noise kernels.

The counterparts of ``repro/kernels/ref.py``'s ``dp_clip_noise_ref`` and
``dp_clip_noise_tree_ref``, plus the row-batched forms over ``[R, P]`` (one
row per client) that the CUDA kernels in ``dp_clip_noise.py`` compute.  The
CPU path uses these; ``chip_smoke.py`` holds the kernels against them on
the card.  Nothing on the main path calls them when a card is present.

Noise is an operand (standard normal, in leaf order for a tree), as in the
TPU kernel: torch cannot reproduce JAX's threefry bits, so the tests hand
both packages the same numbers.
"""
from __future__ import annotations

import torch

from repro_torch.tree import flatten_rows, unflatten_rows


def sumsq_rows_ref(x: torch.Tensor) -> torch.Tensor:
    """Σ x² over each row of ``x [R, P]`` -> ``[R]``."""
    x = x.float()
    return torch.sum(x * x, dim=1)


def scale_noise_rows_ref(x: torch.Tensor, noise: torch.Tensor,
                         scale: torch.Tensor, sigma: float) -> torch.Tensor:
    """``o = x·scale[r] + σ·n`` over ``[R, P]``."""
    return x.float() * scale[:, None] + sigma * noise.float()


def clip_scale(norm: torch.Tensor, clip: float) -> torch.Tensor:
    """``min(1, clip / max(norm, 1e-12))`` (the reference's clip factor)."""
    return torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)


def dp_clip_noise_rows_ref(x: torch.Tensor, noise: torch.Tensor, clip: float,
                           sigma: float):
    """Clip each row to L2 ``clip`` and add σ-scaled noise.
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
