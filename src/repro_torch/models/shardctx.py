"""Activation-sharding context: the port's copy of
``repro/models/shardctx.py``.

Step builders (``launch/steps.py``) install a rule table and a
``DeviceMesh``; model code calls :func:`constrain` with *logical* axis
names.  Outside any context ``constrain`` is the identity (the same
tensor object), so the model zoo stays mesh-agnostic and an unsharded
run changes no bit.  Inside one, the tensor must be a DTensor: it is
redistributed to the rule's placements after ``sanitize_pspec``; a plain
tensor raises, since passing it through would hide a missed placement.

A context also turns on DTensor's implicit replication, so the plain
tensors a step makes as it runs (positions, masks, ``arange``s) take part
as replicated, and :func:`unshard` is the FSDP gather: the params' shards
over the data-parallel mesh axes (the rule table's ``act_batch`` axes)
gathered before a layer uses them, and their grads reduce-scattered back
by autograd.
"""
from __future__ import annotations

import contextlib

from repro_torch.models.sharding import (logical_to_pspec, pspec_placements,
                                         sanitize_pspec)

_STATE = {"rules": None, "mesh": None}


@contextlib.contextmanager
def sharding_ctx(rules: dict, mesh=None):
    from torch.distributed.tensor.experimental import implicit_replication
    prev = dict(_STATE)
    _STATE["rules"] = rules
    _STATE["mesh"] = mesh
    try:
        with implicit_replication():
            yield
    finally:
        _STATE.update(prev)


def active() -> bool:
    return _STATE["rules"] is not None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_box(shape, mesh, placements):
    """(local shape, global offset) of the shard this rank holds of a
    tensor of ``shape`` laid out by ``placements`` on ``mesh``.  Worked
    out on the host (outside any fake-tensor mode: the mesh's coordinate
    tables are real tensors)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        local, offset = compute_local_shape_and_global_offset(
            tuple(shape), mesh, tuple(placements))
    return tuple(local), tuple(offset)


def _mesh_of(x):
    return _STATE["mesh"] if _STATE["mesh"] is not None else x.device_mesh


def constrain(x, *logical_axes):
    """Redistribute ``x`` to the placements the active rule table gives
    its logical axes; the identity outside a context."""
    rules = _STATE["rules"]
    if rules is None:
        return x
    if not is_dtensor(x):
        raise TypeError(
            f"constrain{logical_axes} inside a sharding context got a plain "
            f"{type(x).__name__}: every activation of a sharded step is a "
            "DTensor")
    mesh = _mesh_of(x)
    spec = sanitize_pspec(tuple(x.shape),
                          logical_to_pspec(tuple(logical_axes), rules), mesh)
    return x.redistribute(mesh, pspec_placements(spec, mesh))


def _data_axes():
    """The data-parallel mesh axes of the active rule table (its
    ``act_batch``)."""
    ab = _STATE["rules"].get("act_batch")
    if not ab:
        return ()
    return (ab,) if isinstance(ab, str) else tuple(ab)


def unshard(tree):
    """Inside a context, every DTensor leaf of ``tree`` (dicts and lists)
    with its shards over the data-parallel axes gathered (FSDP); the tree
    itself outside one."""
    if not active():
        return tree
    from torch.distributed.tensor import Replicate
    axes = _data_axes()

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, list):
            return [one(v) for v in t]
        if not is_dtensor(t):
            return t
        names = t.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if n in axes else p
                   for n, p in zip(names, t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(
            t.device_mesh, pl)

    return one(tree)
