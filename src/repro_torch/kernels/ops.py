"""Public wrappers over the port's kernels (the counterpart of
``repro/kernels/ops.py``): the DP clip+noise, ``flash_attention``,
``flash_decode`` with ``combine_decode_partials``, and ``rglru_scan``.

The route is decided by the tensors' device alone: the CUDA kernels for
CUDA tensors, the plain versions in ``kernels/ref.py`` for CPU tensors.
σ and the clip bound are Python floats for one run, or ``[R]`` tensors
with one value a row for a sweep's stacked lanes (``core/rounds.py``
``_dp_sigma``): the kernel reads σ[r] beside scale[r], where the
reference folds a traced σ into its noise operand, a further pass over
``[R, P]``.

The sequence detectors' default score route is ``"kernel"`` on every
device (:data:`DEFAULT_ROUTE`): on the CPU these wrappers already run the
plain versions, so no by-backend switch is needed.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dp_clip_noise as _dp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels.ref import clip_scale, combine_partials
from repro_torch.tree import flatten_rows, unflatten_rows

DEFAULT_ROUTE = "kernel"

flash_attention = _fa.flash_attention
flash_decode = _fd.flash_decode
combine_decode_partials = combine_partials
# bitwise equal to ref.rglru_scan_ref on every device, so the two score
# routes of the ssm detector agree to the bit
rglru_scan = _rg.rglru_scan


def dp_clip_noise_rows(x: torch.Tensor, noise: torch.Tensor, clip, sigma,
                       out: Optional[torch.Tensor] = None):
    """Per-row clip to L2 ``clip`` + σ-scaled noise over the stacked
    updates ``x [R, P]``: one shared norm per row (client-level DP).
    ``clip`` and ``sigma`` are floats or ``[R]`` tensors; the result goes
    into ``out`` where given (``x`` itself too).  Two kernel launches on
    the card.  Returns ``(out, pre_clip_norm [R])``."""
    norm = torch.sqrt(_dp.sumsq_rows(x))
    out = _dp.scale_noise_rows(x, noise, clip_scale(norm, clip), sigma, out)
    return out, norm


def dp_clip_noise(x: torch.Tensor, noise: torch.Tensor, clip: float,
                  sigma: float, out: Optional[torch.Tensor] = None):
    """One flat update ``x [N]`` (into ``out [N]`` where given, ``x``
    itself too).  Returns ``(out [N], norm)``."""
    out, norm = dp_clip_noise_rows(
        x.reshape(1, -1), noise.reshape(1, -1), clip, sigma,
        None if out is None else out.view(1, -1))
    return out.reshape(x.shape), norm[0]


def dp_clip_noise_tree(tree, noise: torch.Tensor, clip: float, sigma: float):
    """One update tree with a SHARED global norm across its leaves;
    ``noise`` is flat ``[P]`` in leaf order (sorted keys, as the reference
    splits its per-leaf keys).  Returns ``(noised_tree, pre_clip_norm)``."""
    flat = flatten_rows(tree, 0).float().contiguous()
    out, norm = dp_clip_noise(flat, noise.contiguous(), clip, sigma)
    return unflatten_rows(out, tree), norm
