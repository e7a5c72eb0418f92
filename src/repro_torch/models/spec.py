"""Pluggable detector architectures: the port's copy of
``repro/models/spec.py``.

A :class:`ModelSpec` packages the surface the engine needs: ``init``,
``loss`` and ``logits``, plus the derived ``predict_proba``/``accuracy``.
A builder ``(meta: DataMeta) -> ModelSpec`` is registered under the name
that ``FLConfig.model`` takes.  The port registers ``mlp`` only so far; the
window-native detectors and the reference's sharding hooks are not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.models import mlp as mlp_lib
from repro_torch.models.mlp import cross_entropy  # noqa: F401  (re-export)


class DataMeta(NamedTuple):
    """Dataset-shape metadata a model builder needs."""

    n_features: int
    n_classes: int
    hidden: int                       # generic width knob, per-spec meaning
    feature_shape: Tuple[int, ...]

    @property
    def windowed(self) -> bool:
        return len(self.feature_shape) > 1


def meta_for(fed, hidden: int = 64) -> DataMeta:
    """DataMeta of a :class:`repro_torch.data.synthetic.FederatedData`."""
    shape = getattr(fed, "feature_shape", None) or (fed.n_features,)
    return DataMeta(n_features=fed.n_features, n_classes=fed.n_classes,
                    hidden=hidden, feature_shape=tuple(int(s) for s in shape))


@dataclass(frozen=True)
class ModelSpec:
    """``init(gen) -> params`` draws from a ``torch.Generator`` on its
    device; ``loss(params, batch)`` is what the round step differentiates
    per client; ``logits(params, x)`` is what the metrics derive from."""

    name: str
    init: Callable
    loss: Callable
    logits: Callable

    def predict_proba(self, params, x):
        return torch.softmax(self.logits(params, x), dim=-1)

    def accuracy(self, params, x, y) -> torch.Tensor:
        pred = torch.argmax(self.logits(params, x), dim=-1)
        return torch.mean((pred == y).float())


_REGISTRY: Dict[str, Callable[[DataMeta], ModelSpec]] = {}


def register_model(name: str, builder: Callable[[DataMeta], ModelSpec]):
    _REGISTRY[name] = builder


def model_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_model_spec(name: str, meta: DataMeta) -> ModelSpec:
    try:
        builder = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown FLConfig.model {name!r}; registered: {model_names()}"
        ) from None
    return builder(meta)


def _build_mlp(meta: DataMeta) -> ModelSpec:
    return ModelSpec(
        name="mlp",
        init=lambda gen: mlp_lib.init_mlp(gen, meta.n_features, meta.hidden,
                                          meta.n_classes),
        loss=mlp_lib.mlp_loss,
        logits=mlp_lib.mlp_logits,
    )


register_model("mlp", _build_mlp)
