"""Model API: the port's copy of ``repro/models/model.py``.

``build(cfg)`` returns a :class:`Model` exposing ``init`` / ``axes`` /
``param_shapes`` / ``loss`` / ``forward`` / ``decode_step`` /
``init_cache`` over the decoder-only LMs (``models/transformer.py``) and
the encoder-decoder (``enc_layers > 0``: ``models/encdec.py``), so a
caller never branches on family.  A batch's ``"frontend"`` holds stub
frontend embeddings: a VLM's patches, prepended to the text tokens on
M-RoPE positions (:func:`mrope_positions`), or the encoder-decoder's
audio frames.  ``cache_specs`` and ``input_specs`` give a step's inputs
as ``meta`` tensors (shapes and dtypes, nothing allocated), for the step
bundles and the dry-run (``launch/steps.py``, ``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as E
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


def mrope_positions(batch: int, n_front: int, n_text: int,
                    grid_w: int = 16, device=None) -> torch.Tensor:
    """Qwen2-VL style (t, h, w) position ids [batch, n_front + n_text, 3]
    for [image patches; text]: patch i at (0, i // grid_w, i % grid_w),
    text token j at n_front // grid_w + j on all three."""
    img_i = torch.arange(n_front, dtype=torch.int32, device=device)
    img = torch.stack([torch.zeros_like(img_i), img_i // grid_w,
                       img_i % grid_w], dim=-1)
    txt_i = torch.arange(n_text, dtype=torch.int32,
                         device=device) + n_front // grid_w
    txt = torch.stack([txt_i, txt_i, txt_i], dim=-1)
    pos = torch.cat([img, txt], dim=0)
    return pos.expand((batch,) + tuple(pos.shape))


class Model:
    """Family-dispatching wrapper over explicit param trees (stateless)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.is_encdec = cfg.enc_layers > 0
        if cfg.frontend == "audio" and not self.is_encdec:
            raise ValueError(
                f"{cfg.name}: the audio frontend's frames feed an encoder "
                "(enc_layers > 0)")

    def _vlm_positions(self, batch):
        """M-RoPE positions for [patches; text] when the batch carries a
        frontend and the config M-RoPE, else None (the default
        positions)."""
        extra = batch.get("frontend")
        if self.cfg.mrope_sections is None or extra is None:
            return None
        b, n_text = batch["tokens"].shape
        return mrope_positions(b, extra.shape[1], n_text,
                               device=batch["tokens"].device)

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
        if self.is_encdec:
            return E.init_encdec(gen, self.cfg)[0]
        return T.init_lm(gen, self.cfg)[0]

    def axes(self):
        if self.is_encdec:
            return E.encdec_axes(self.cfg)
        return T.lm_axes(self.cfg)

    def param_shapes(self):
        """The param tree as ``meta`` tensors: shapes and dtypes, nothing
        allocated."""
        if self.is_encdec:
            return E.encdec_param_shapes(self.cfg)
        return T.lm_param_shapes(self.cfg)

    # -- training -----------------------------------------------------------
    def loss(self, params, batch, *, remat: str = "full", impl: str = "ref",
             remat_group: int = 1) -> torch.Tensor:
        """Next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both [B,S]; -100 ignored) in mode ``"train"``,
        plus the ``moe`` blocks' aux loss (``transformer.lm_loss``); with
        ``batch["frontend"]``, the VLM's patches prepended (their logits
        dropped) or the encoder-decoder's frames encoded
        (``encdec.encdec_loss``, which takes no ``impl``)."""
        cfg = self.cfg
        if self.is_encdec:
            return E.encdec_loss(params, cfg, batch["frontend"],
                                 batch["tokens"], batch["labels"],
                                 remat=remat)
        return T.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                         remat=remat, impl=impl,
                         extra_embeds=batch.get("frontend"),
                         remat_group=remat_group,
                         positions=self._vlm_positions(batch))

    # -- inference ----------------------------------------------------------
    def forward(self, params, batch, *, impl: str = "ref",
                window: Optional[int] = None, last_only: bool = False):
        """Prefill logits for ``batch["tokens"]`` [B,S] (after the
        ``batch["frontend"]`` patches of a VLM; given the frames of an
        encoder-decoder); ``impl="flash"`` runs attention on the
        ``flash_attention`` kernel and the ``rec`` blocks' recurrence on
        ``rglru_scan``.  The encoder-decoder takes no ``impl``, as the
        reference's."""
        cfg = self.cfg
        if self.is_encdec:
            return E.encdec_forward(params, cfg, batch["frontend"],
                                    batch["tokens"], window=window,
                                    last_only=last_only)
        return T.lm_forward(params, cfg, batch["tokens"],
                            self._vlm_positions(batch),
                            extra_embeds=batch.get("frontend"), impl=impl,
                            window_override=window, last_only=last_only)[0]

    def decode_step(self, params, token, caches, index: int, *,
                    window: Optional[int] = None):
        """(logits [B,1,V], caches) for one token at host-int ``index``; the
        caches are written in place."""
        if self.is_encdec:
            return E.encdec_decode_step(params, self.cfg, token, caches,
                                        index, window=window)
        return T.lm_decode_step(params, self.cfg, token, caches, index,
                                window_override=window)

    def init_cache(self, batch: int, cache_len: int, *,
                   window: Optional[int] = None, params=None,
                   device: DeviceLike = None, enc_out=None):
        """Zeroed stacked caches on ``params``' device when given, else on
        ``device`` (CUDA unless ``device="cpu"``).  The encoder-decoder's
        needs ``params``: its cross K/V are projected from ``enc_out``
        [B, T_enc, d], zeros of ``[batch, cfg.enc_seq, d]`` in the
        model's dtype when none is given, as the reference's."""
        dev = (params["embed"]["table"].device if params is not None
               else resolve_device(device))
        if self.is_encdec:
            if params is None:
                raise ValueError("the encoder-decoder's cache needs params")
            if enc_out is None:
                enc_out = torch.zeros(
                    (batch, self.cfg.enc_seq, self.cfg.d_model),
                    dtype=getattr(torch, self.cfg.dtype), device=dev)
            return E.init_decode_cache(params, self.cfg, batch, cache_len,
                                       enc_out, window=window)
        return T.stack_cache(self.cfg, batch, cache_len,
                             window_override=window, device=dev)

    def cache_specs(self, batch: int, cache_len: int, *,
                    window: Optional[int] = None):
        """The decode cache as ``meta`` tensors (no allocation)."""
        if self.is_encdec:
            return self.init_cache(batch, cache_len, window=window,
                                   params=self.param_shapes())
        return T.stack_cache(self.cfg, batch, cache_len,
                             window_override=window, device="meta")

    # -- dry-run input specs --------------------------------------------------
    def input_specs(self, shape: ShapeConfig):
        """``meta`` stand-ins for every model input of a step: ``tokens``
        (and ``labels`` in train; ``frontend`` for the VLM and the
        encoder-decoder) in train and prefill; ``token`` [B, 1],
        ``caches`` and ``index`` (0-d int32: the step itself takes a host
        int) in decode."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        dt = getattr(torch, cfg.dtype)
        window = effective_window(cfg, shape)

        def sd(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.mode in ("train", "prefill"):
            if self.is_encdec:
                return {
                    "frontend": sd((b, cfg.enc_seq, cfg.d_model), dt),
                    "tokens": sd((b, s), i32),
                    "labels": sd((b, s), i32),
                }
            specs = {}
            n_text = s
            if cfg.frontend != "none" and cfg.frontend_tokens:
                n_text = s - cfg.frontend_tokens
                specs["frontend"] = sd((b, cfg.frontend_tokens, cfg.d_model),
                                       dt)
            specs["tokens"] = sd((b, n_text), i32)
            specs["labels"] = sd((b, n_text), i32)
            if shape.mode == "prefill":
                specs.pop("labels")
            return specs
        return {
            "token": sd((b, 1), i32),
            "caches": self.cache_specs(b, s, window=window),
            "index": sd((), i32),
        }


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
