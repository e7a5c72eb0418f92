"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a card and without an explicit CPU request they raise: the port
never carries on quietly on the CPU.  On the card, TF32 stays off so float32
products round as float32 products, as in the JAX reference, and bf16
products reduce in f32: cuBLAS may otherwise round the partial sums of a
split-K bf16 GEMM to bf16, which the reference's f32-accumulated bf16
products (``preferred_element_type`` f32 inside XLA's dot) never do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        if dev.index is None:  # tensors report cuda:N, so name N
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
