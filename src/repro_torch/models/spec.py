"""Pluggable detector architectures: the port's copy of
``repro/models/spec.py``.

A :class:`ModelSpec` packages the surface the engine needs: ``init``,
``loss`` and ``logits``, plus the derived ``predict_proba``/``accuracy``.
A builder ``(meta: DataMeta) -> ModelSpec`` is registered under the name
that ``FLConfig.model`` takes.  The port registers what the reference
does: ``mlp`` and, from ``models/detectors.py``, the window-native
detectors ``cnn``, ``rglru``, ``ssm`` and ``attn`` (the last three with
their score routes), ``ssm`` and ``attn`` with the model-sharding hook
(``param_axes``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.ops import DEFAULT_ROUTE
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.mlp import cross_entropy  # noqa: F401  (re-export)
from repro_torch.tree import tree_leaves, tree_map


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
    ``"kernel"`` route; ``loss`` always differentiates ``"ref"``.

    ``param_axes() -> tree`` (optional) gives each param leaf's logical
    axis names, a tuple of the leaf's rank, in ``init``'s tree: the
    model-sharding hook.  :meth:`constrain_params` places params by them
    through an active ``models/shardctx`` context (outside one it is the
    identity), so the spec declares WHERE its params may split and the
    driver decides WHEN (the population engine, when the replicated model
    passes ``core/scale.py``'s budget and the client axis has more than
    one rank)."""

    name: str
    init: Callable
    loss: Callable
    logits: Callable
    route_variants: Optional[Mapping[str, Callable]] = None
    param_axes: Optional[Callable[[], object]] = None

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

    def constrain_params(self, params):
        """Each param leaf (a DTensor) placed by its ``param_axes`` through
        the active ``models/shardctx`` context.  The same tree (the same
        leaves) when the spec declares no axes or no context is active:
        every unsharded path is unchanged."""
        from repro_torch.models import shardctx
        if self.param_axes is None or not shardctx.active():
            return params
        # an axes tree's leaves are tuples, which trees do not descend into
        leaves, axes = tree_leaves(params), tree_leaves(self.param_axes())
        if len(leaves) != len(axes):
            raise ValueError(f"{self.name}: {len(axes)} param_axes for "
                             f"{len(leaves)} param leaves")
        by_id = {id(t): shardctx.constrain(t, *a)
                 for t, a in zip(leaves, axes)}
        return tree_map(lambda t: by_id[id(t)], params)


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
