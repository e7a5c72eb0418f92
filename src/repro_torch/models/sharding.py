"""Logical-axis sharding: the port's copy of ``repro/models/sharding.py``.

Params carry logical axis names; a rule table maps them to mesh axes
(MaxText-style); helpers turn whole trees into :class:`PartitionSpec`
trees and those into DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh``.

An ``init_*`` function returns a tree (nested dicts and lists) of
:class:`ParamMeta`, each a tensor with the logical names of its axes:

  "embed"    d_model dimension of weight matrices (FSDP candidate)
  "mlp"      d_ff dimension                      (tensor parallel)
  "heads"    query-head dimension                (tensor parallel)
  "kv"       kv-head dimension (may be < mesh model size -> replicated)
  "vocab"    vocabulary dimension                (tensor parallel)
  "experts"  MoE expert dimension                (expert parallel)
  "layers"   stacked layer dimension             (never sharded)
  "act_batch"  activation batch                  (data parallel)
  "act_seq"    activation sequence               (context parallel, decode KV)
  None       replicated

torch has no ``PartitionSpec``, so the port keeps its own: a tuple with one
entry per tensor dim, each ``None``, a mesh axis name, or a tuple of names
(major to minor).  :func:`pspec_placements` turns one into the placements
of a DTensor: a dim over several mesh axes is a ``Shard(d)`` on each of
them, which DTensor splits in mesh order, so the axes of one dim must come
in the mesh's order (JAX's major-to-minor order is then the same).  The
functions that read a mesh take a ``DeviceMesh`` or a
:class:`~repro_torch.configs.base.MeshConfig` (its names and sizes only).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple


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


# ---------------------------------------------------------------------------
# PartitionSpec
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name or a tuple of
    names; trailing replicated dims may be left out."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# client_serial plan: the whole mesh co-trains one client -> FSDP over data.
RULES_SERIAL = {
    "embed": ("data",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv": None,
    "vocab": ("model",),
    "experts": ("model",),
    "layers": None,
    "act_batch": ("data",),
    # sequence parallelism is an opt-in override: None keeps the residual
    # stream replicated across the model axis
    "act_seq": None,
    "ssm_state": None,
}

# client_parallel plan: clients live on the data axis -> per-client weights
# must NOT be sharded over data (they diverge per client).
RULES_PARALLEL = {
    "embed": None,
    "mlp": ("model",),
    "heads": ("model",),
    "kv": None,
    "vocab": ("model",),
    "experts": ("model",),
    "layers": None,
    "act_batch": ("data",),
    "act_seq": None,
    "ssm_state": None,
}


def with_pod(rules: dict, multi_pod: bool, family: str) -> dict:
    """Extend a rule table with the 'pod' axis for the 2x16x16 mesh.

    client_serial: pod joins the FSDP/data-parallel group (one giant client
    mesh).  client_parallel: pod multiplies the client axis, so activations
    shard over (pod, data) while weights stay unsharded over both.
    """
    if not multi_pod:
        return rules
    r = dict(rules)
    if family == "client_serial":
        if r["embed"]:
            r["embed"] = ("pod", "data")
        r["act_batch"] = ("pod", "data")
    else:
        r["act_batch"] = ("pod", "data")
    return r


def make_rules(plan: str, multi_pod: bool) -> dict:
    """Sharding rules for a registered plan, keyed on the plan's static
    program family (``core/plans.py``), so same-family plans share one
    rule table."""
    from repro_torch.core.plans import plan_family
    family = plan_family(plan)
    base = RULES_SERIAL if family == "client_serial" else RULES_PARALLEL
    return with_pod(base, multi_pod, family)


def without_axes(rules: dict, axes) -> dict:
    """``rules`` with the mesh ``axes`` taken out of every entry (one left
    with none maps to ``None``): the table for a sub-mesh that lacks
    them, as the ``client_parallel`` round's model sub-mesh lacks the
    data axes."""
    out = {}
    for k, v in rules.items():
        rest = () if v is None else tuple(a for a in _parts(v)
                                          if a not in axes)
        out[k] = rest or None
    return out


# The population engine's 2-D (lane, client) scale mesh
# (``launch/mesh.py`` ``make_scale_mesh``): "clients" is the population
# axis of every per-client [N] tensor, "lanes" the sweep's trial axis.
RULES_POPULATION = {
    "clients": ("client",),
    "lanes": ("lane",),
}

# Model-sharding variant for the same scale mesh: a detector past the
# replicated-size budget tensor-parallels its wide axes ("mlp"/"heads")
# over ``client`` while the residual-stream dims replicate.
RULES_MODEL_SCALE = {
    **RULES_POPULATION,
    "embed": None,
    "mlp": ("client",),
    "heads": ("client",),
    "kv": None,
    "vocab": None,
    "experts": None,
    "layers": None,
    "act_batch": None,
    "act_seq": None,
    "ssm_state": None,
}


def population_shardings(mesh, pop):
    """Placements for a :class:`repro_torch.data.synthetic.Population` on a
    ``(lane, client)`` scale mesh: per-client tensors (membership table,
    sizes, quality) shard over ``client``; the shared pool and the test set
    replicate; the shift seed is a host int and passes as it is."""
    per_client = pspec_placements(P("client"), mesh)
    replicated = pspec_placements(P(), mesh)
    return type(pop)(
        pool_x=replicated, pool_y=replicated,
        member_idx=per_client, member_size=per_client,
        data_size=per_client, data_quality=per_client,
        shift_seed=pop.shift_seed,
        test_x=replicated, test_y=replicated,
        feature_shift=pop.feature_shift, feature_shape=pop.feature_shape,
    )


def lane_shardings(mesh):
    """(lane-sharded, replicated) placements for per-lane inputs on the
    scale mesh."""
    return pspec_placements(P("lane"), mesh), pspec_placements(P(), mesh)


# ---------------------------------------------------------------------------
# Conversions
# ---------------------------------------------------------------------------


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical names (or None)."""
    return isinstance(x, tuple) and all(y is None or isinstance(y, str)
                                        for y in x)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshConfig``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axes, mesh.shape))


def _parts(part) -> Tuple[str, ...]:
    return (part,) if isinstance(part, str) else tuple(part)


def logical_to_pspec(axes: Tuple[Optional[str], ...], rules: dict
                     ) -> PartitionSpec:
    parts = []
    used: set = set()
    for a in axes:
        m = rules.get(a) if a else None
        if m is None:
            parts.append(None)
            continue
        m = _parts(m)
        m = tuple(x for x in m if x not in used)
        used.update(m)
        parts.append(m if len(m) != 1 else m[0])
        if not m:
            parts[-1] = None
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _map_axes(fn, axes_tree):
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [_map_axes(fn, v) for v in axes_tree]
    assert is_axes(axes_tree), axes_tree
    return fn(axes_tree)


def tree_pspecs(axes_tree, rules: dict):
    return _map_axes(lambda a: logical_to_pspec(a, rules), axes_tree)


def divisibility_ok(shape: Tuple[int, ...], spec: PartitionSpec, mesh
                    ) -> bool:
    """Check a shape divides evenly under a spec for this mesh."""
    sizes = mesh_axis_sizes(mesh)
    for dim, part in zip(shape, tuple(spec)):
        if part is None:
            continue
        if dim % math.prod(sizes[p] for p in _parts(part)):
            return False
    return True


def sanitize_pspec(shape: Tuple[int, ...], spec: PartitionSpec, mesh
                   ) -> PartitionSpec:
    """Drop partitions that do not divide the dimension evenly (e.g. kv=8
    over model=16), so every placement splits its dim evenly."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    spec_t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for dim, part in zip(shape, spec_t):
        if part is None:
            out.append(None)
            continue
        n = math.prod(sizes[p] for p in _parts(part))
        out.append(part if dim % n == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def pspec_placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a spec: ``Shard(d)`` on
    each mesh axis that tensor dim ``d`` lies over, ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(tuple(spec)):
        if part is None:
            continue
        idx = [names.index(a) for a in _parts(part)]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(
                f"dim {d} of {spec} lies over {_parts(part)}: name them in "
                f"the mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} used twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def tree_shardings(axes_tree, rules: dict, mesh):
    """Placements for every leaf of an axes tree."""
    return _map_axes(lambda a: pspec_placements(logical_to_pspec(a, rules),
                                                mesh), axes_tree)
