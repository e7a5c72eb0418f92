"""Nested-dict parameter trees, flattened in the JAX package's leaf order.

``jax.tree.flatten`` sorts dict keys, so an MLP update's leaves come as
``l1.b, l1.w, l2.b, l2.w, out.b, out.w``.  The DP noise is drawn per leaf in
that order, so every flat layout in the port (the ``[R, P]`` rows the
clip+noise kernel sees, injected noise, the flat server update) follows it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

Tree = Dict[str, object]


def tree_paths(tree: Tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """Key paths of the leaves, in sorted-key (JAX) order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_paths(v, prefix + (k,)))
        else:
            out.append(prefix + (k,))
    return out


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    out = []
    for path in tree_paths(tree):
        node = tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def flatten_rows(tree: Tree, batch_dims: int = 1) -> torch.Tensor:
    """Concatenate the leaves into ``[*batch, P]`` in leaf order; the
    leading ``batch_dims`` axes (0 for a single update) are kept."""
    leaves = tree_leaves(tree)
    lead = leaves[0].shape[:batch_dims]
    return torch.cat([l.reshape(*lead, -1) for l in leaves], dim=-1)


def unflatten_rows(flat: torch.Tensor, like: Tree) -> Tree:
    """Inverse of :func:`flatten_rows`: split ``flat [*batch, P]`` back into
    a tree shaped like ``like`` (whose leaves carry no batch axes)."""
    lead = flat.shape[:-1]
    out: Tree = {}
    offset = 0
    for path, leaf in zip(tree_paths(like), tree_leaves(like)):
        size = leaf.numel()
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[..., offset:offset + size].reshape(
            *lead, *leaf.shape)
        offset += size
    if offset != flat.shape[-1]:
        raise ValueError(f"flat width {flat.shape[-1]} != tree size {offset}")
    return out

