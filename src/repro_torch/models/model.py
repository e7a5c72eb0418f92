"""Model API: the port's copy of ``repro/models/model.py`` for decoder-only
configs.

``build(cfg)`` returns a :class:`Model` exposing ``init`` / ``axes`` /
``param_shapes`` / ``loss`` / ``forward`` / ``decode_step`` /
``init_cache``.  Encoder-decoder configs wait for the encoder-decoder slice
and configs with a multimodal frontend for the VLM slice; both raise.
``input_specs`` waits for the dry-run slice.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T


def parse_long_variant(cfg: ModelConfig) -> Optional[int]:
    """'swa-4096' -> 4096."""
    if cfg.long_context_variant and cfg.long_context_variant.startswith("swa-"):
        return int(cfg.long_context_variant.split("-")[1])
    return None


def effective_window(cfg: ModelConfig, shape: Optional[ShapeConfig]) -> Optional[int]:
    """Attention window override for a given input shape.

    For ``long_500k`` full-attention archs run their labelled sliding-window
    variant; all other shapes use the published attention
    (cfg.sliding_window, usually None).  An attention config that reaches
    ``long_500k`` with no window anywhere (no ``sliding_window``, no
    ``swa-*`` variant, a family without long context) is a config error:
    it would run full attention over 524288 positions.
    """
    if shape is not None and shape.name == "long_500k" and cfg.family != "ssm":
        if cfg.sliding_window is not None:
            return cfg.sliding_window
        window = parse_long_variant(cfg)
        if window is None and not cfg.supports_long_context():
            raise ValueError(
                f"arch {cfg.name!r} (family {cfg.family!r}) cannot run the "
                "long_500k shape: it has no sliding_window, no 'swa-*' "
                "long_context_variant, and its family does not support "
                "long context — full attention over 524288 positions is "
                "never intended.  Label the config with "
                "long_context_variant='swa-<window>' or pick an "
                "ssm/hybrid arch")
        return window
    return cfg.sliding_window


class Model:
    """Decoder-only LM over explicit param trees (stateless)."""

    def __init__(self, cfg: ModelConfig):
        if cfg.enc_layers > 0:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder models wait for the "
                "encoder-decoder slice (models/encdec.py)")
        if cfg.family == "vlm" or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: multimodal frontends wait for the VLM slice")
        self.cfg = cfg

    # -- parameters ---------------------------------------------------------
    def init(self, seed: Union[int, torch.Generator] = 0,
             device: DeviceLike = None):
        """Random params on ``device`` (CUDA unless ``device="cpu"``), drawn
        from ``seed``'s ``torch.Generator`` (or the generator given, which
        must live on that device) layer by layer."""
        dev = resolve_device(device)
        if isinstance(seed, torch.Generator):
            gen = seed
            if gen.device.type != dev.type:
                raise ValueError(f"generator on {gen.device}, params on {dev}")
        else:
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        return T.init_lm(gen, self.cfg)[0]

    def axes(self):
        return T.lm_axes(self.cfg)

    def param_shapes(self):
        """The param tree as ``meta`` tensors: shapes and dtypes, nothing
        allocated."""
        return T.lm_param_shapes(self.cfg)

    # -- training -----------------------------------------------------------
    def loss(self, params, batch, *, remat: str = "full", impl: str = "ref",
             remat_group: int = 1) -> torch.Tensor:
        """Next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both [B,S]; -100 ignored) in mode ``"train"``
        (``transformer.lm_loss``)."""
        return T.lm_loss(params, self.cfg, batch["tokens"], batch["labels"],
                         remat=remat, impl=impl, remat_group=remat_group)

    # -- inference ----------------------------------------------------------
    def forward(self, params, batch, *, impl: str = "ref",
                window: Optional[int] = None, last_only: bool = False):
        """Prefill logits for ``batch["tokens"]`` [B,S]; ``impl="flash"``
        runs attention on the ``flash_attention`` kernel and the ``rec``
        blocks' recurrence on ``rglru_scan``."""
        return T.lm_forward(params, self.cfg, batch["tokens"], impl=impl,
                            window_override=window, last_only=last_only)

    def decode_step(self, params, token, caches, index: int, *,
                    window: Optional[int] = None):
        """(logits [B,1,V], caches) for one token at host-int ``index``; the
        caches are written in place."""
        return T.lm_decode_step(params, self.cfg, token, caches, index,
                                window_override=window)

    def init_cache(self, batch: int, cache_len: int, *,
                   window: Optional[int] = None, params=None,
                   device: DeviceLike = None):
        """Zeroed stacked caches on ``params``' device when given, else on
        ``device`` (CUDA unless ``device="cpu"``)."""
        dev = (params["embed"]["table"].device if params is not None
               else resolve_device(device))
        return T.stack_cache(self.cfg, batch, cache_len,
                             window_override=window, device=dev)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
