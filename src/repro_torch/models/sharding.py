"""Logical-axis metadata for parameters: the port's copy of the first half
of ``repro/models/sharding.py`` (``ParamMeta``, ``pm``, ``is_meta``,
``split_meta``, ``add_axis``).

An ``init_*`` function returns a tree (nested dicts and lists) of
:class:`ParamMeta`, each a tensor with the logical names of its axes
("embed", "mlp", "heads", "kv", "vocab", "layers", ...).  The names ride
along for the sharding slice, which maps them onto a device mesh; on one
card nothing reads them but ``Model.axes``.  The rule tables and
PartitionSpecs wait for that slice.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple


class ParamMeta:
    """A parameter value bundled with its logical axis names."""

    __slots__ = ("value", "axes")

    def __init__(self, value, axes):
        self.value = value
        self.axes = tuple(axes)

    def __repr__(self):
        shape = getattr(self.value, "shape", None)
        return f"ParamMeta({tuple(shape) if shape is not None else None}, axes={self.axes})"


def pm(value, *axes) -> ParamMeta:
    assert value.dim() == len(axes), (tuple(value.shape), axes)
    return ParamMeta(value, axes)


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def map_meta(fn: Callable[[ParamMeta], Any], tree):
    """``fn`` on every ParamMeta of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_meta(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_meta(fn, v) for v in tree]
    assert is_meta(tree), type(tree)
    return fn(tree)


def split_meta(tree) -> Tuple[Any, Any]:
    """Split a tree of ParamMeta into (values, logical_axes) trees."""
    return map_meta(lambda m: m.value, tree), map_meta(lambda m: m.axes, tree)


def add_axis(meta_tree, name: str = "layers"):
    """Prepend a stacked axis name to every ParamMeta in a tree (the value
    is left as it is: the caller stacks it)."""
    return map_meta(lambda m: ParamMeta(m.value, (name,) + m.axes), meta_tree)
