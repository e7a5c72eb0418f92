"""Pluggable detector architectures: the port's copy of
``repro/models/spec.py``.

A :class:`ModelSpec` packages the surface the engine needs: ``init``,
``loss`` and ``logits``, plus the derived ``predict_proba``/``accuracy``.
A builder ``(meta: DataMeta) -> ModelSpec`` is registered under the name
that ``FLConfig.model`` takes.  The port registers what the reference
does: ``mlp`` and, from ``models/detectors.py``, the window-native
detectors ``cnn``, ``rglru``, ``ssm`` and ``attn`` (the last three with
their score routes).  The reference's sharding hooks are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.ops import DEFAULT_ROUTE
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.mlp import cross_entropy  # noqa: F401  (re-export)
from repro_torch.tree import tree_leaves


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
    """DataMeta of a :class:`repro_torch.data.synthetic.FederatedData` or a
    :class:`~repro_torch.data.synthetic.Population`."""
    shape = getattr(fed, "feature_shape", None) or (fed.n_features,)
    return DataMeta(n_features=fed.n_features, n_classes=fed.n_classes,
                    hidden=hidden, feature_shape=tuple(int(s) for s in shape))


@dataclass(frozen=True)
class ModelSpec:
    """``init(gen) -> params`` draws from a ``torch.Generator`` on its
    device; ``loss(params, batch)`` is what the round step differentiates
    per client; ``logits(params, x)`` is what the metrics derive from.

    ``route_variants`` maps a score route to its logits function for the
    sequence detectors: ``"kernel"`` runs the CUDA kernels through
    ``kernels/ops.py`` (their plain versions for CPU tensors), ``"ref"``
    the plain versions of ``kernels/ref.py``.  ``logits`` is the
    ``"kernel"`` route; ``loss`` always differentiates ``"ref"``."""

    name: str
    init: Callable
    loss: Callable
    logits: Callable
    route_variants: Optional[Mapping[str, Callable]] = None

    def logits_routed(self, route: Optional[str] = None) -> Callable:
        """Logits function on an explicit score route (``None`` is
        ``kernels.ops.DEFAULT_ROUTE``, the kernels); a spec without route
        variants has one implementation, which serves every route."""
        if self.route_variants is None:
            return self.logits
        route = route or DEFAULT_ROUTE
        try:
            return self.route_variants[route]
        except KeyError:
            raise KeyError(
                f"model {self.name!r} has no score route {route!r}; "
                f"available: {tuple(self.route_variants)}") from None

    def predict_proba(self, params, x):
        return torch.softmax(self.logits(params, x), dim=-1)

    def predict_proba_routed(self, params, x, route: Optional[str] = None):
        return torch.softmax(self.logits_routed(route)(params, x), dim=-1)

    def accuracy(self, params, x, y) -> torch.Tensor:
        pred = torch.argmax(self.logits(params, x), dim=-1)
        return torch.mean((pred == y).float())

    def param_bytes(self) -> int:
        """Bytes of one replica of the parameters (``core/scale.py``'s model
        term), from one initialisation on the CPU."""
        params = self.init(torch.Generator().manual_seed(0))
        return sum(t.numel() * t.element_size() for t in tree_leaves(params))


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

# The window-native detectors register themselves on import.
from repro_torch.models import detectors as _detectors  # noqa: E402,F401
