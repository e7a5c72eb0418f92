"""Parameter trees of nested dicts and lists, flattened in the JAX package's
leaf order.

``jax.tree.flatten`` sorts dict keys and keeps list order, so an MLP
update's leaves come as ``l1.b, l1.w, l2.b, l2.w, out.b, out.w`` and a
language model's as ``embed``, ``final_ln``, then the segments of
``stack`` in order.  The DP noise is drawn per leaf in that order, so every
flat layout in the port (the ``[R, P]`` rows the clip+noise kernel sees,
injected noise, the flat server update) follows it.  A path holds a dict's
keys and a list's indices.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

import torch

Tree = Union[Dict[str, object], List[object]]
_NODES = (dict, list)


def _children(node) -> list:
    """(key, child) pairs of a dict or list node, in leaf order."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def tree_paths(tree: Tree, prefix: Tuple = ()) -> List[Tuple]:
    """Key paths of the leaves, in sorted-key (JAX) order."""
    out = []
    for k, v in _children(tree):
        if isinstance(v, _NODES):
            out.extend(tree_paths(v, prefix + (k,)))
        else:
            out.append(prefix + (k,))
    return out


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    out = []
    for _, v in _children(tree):
        if isinstance(v, _NODES):
            out.extend(tree_leaves(v))
        else:
            out.append(v)
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    def one(v, *rs):
        return tree_map(fn, v, *rs) if isinstance(v, _NODES) else fn(v, *rs)

    if isinstance(tree, list):
        return [one(v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return {k: one(v, *(r[k] for r in rest)) for k, v in tree.items()}


def flatten_rows(tree: Tree, batch_dims: int = 1) -> torch.Tensor:
    """Concatenate the leaves into ``[*batch, P]`` in leaf order; the
    leading ``batch_dims`` axes (0 for a single update) are kept."""
    leaves = tree_leaves(tree)
    lead = leaves[0].shape[:batch_dims]
    return torch.cat([l.reshape(*lead, -1) for l in leaves], dim=-1)


def unflatten_rows(flat: torch.Tensor, like: Tree) -> Tree:
    """Inverse of :func:`flatten_rows`: split ``flat [*batch, P]`` back into
    a tree shaped like ``like`` (whose leaves carry no batch axes).  The
    leaves are views of ``flat``."""
    out, offset = _split(flat, like, 0)
    if offset != flat.shape[-1]:
        raise ValueError(f"flat width {flat.shape[-1]} != tree size {offset}")
    return out


def _split(flat: torch.Tensor, node, offset: int):
    """(``node``'s subtree of views of ``flat`` from ``offset``, the offset
    after it).  A plain recursive function: a self-referencing closure
    over ``flat`` would form a reference cycle and hold ``flat`` until the
    garbage collector ran."""
    if isinstance(node, dict):
        out = {}
        for k, v in _children(node):
            out[k], offset = _split(flat, v, offset)
        return out, offset
    if isinstance(node, list):
        out = []
        for v in node:
            leaf, offset = _split(flat, v, offset)
            out.append(leaf)
        return out, offset
    size = node.numel()
    return (flat[..., offset:offset + size].reshape(
        *flat.shape[:-1], *node.shape), offset + size)

