"""Step builders: the port's copy of ``repro/launch/steps.py``.

(arch × input shape × mesh) → a :class:`StepBundle`:
    fn            — the step (FL round / prefill / decode)
    in_specs      — every input as ``meta`` tensors (no allocation)
    in_shardings / out_shardings — DTensor placement trees on the mesh
so that a caller places real inputs with :func:`place` and calls ``fn``,
and ``launch/dryrun.py`` runs ``fn`` once on fake local shards
(:func:`abstract_inputs`).  The step runs its model on DTensors under
``shardctx.sharding_ctx`` with the rule table of its plan.

Execution profiles (the reference's policy):
    param_count < 10B  → client_parallel (clients on the data axes)
    otherwise          → client_serial  (whole mesh per client, FSDP)
grad_accum is chosen so the per-chip activation microbatch is ~1-2
sequences for the ≥10B models.

Built here: the prefill and decode bundles and both train bundles: the
``client_serial`` round (``core/rounds.py`` ``make_serial_round`` under a
mesh) and the ``client_parallel`` round (``make_parallel_round`` with a
``ClientRows`` as its ``delta_constraint``: clients across the data
ranks, each trained on the model sub-mesh).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import FLConfig, MeshConfig, ModelConfig, ShapeConfig
from repro_torch.core import plans as plans_lib
from repro_torch.models.model import Model, build, effective_window
from repro_torch.models.sharding import (P, logical_to_pspec, make_rules,
                                         mesh_axis_sizes, pspec_placements,
                                         sanitize_pspec, without_axes)
from repro_torch.models.shardctx import sharding_ctx
from repro_torch.models.transformer import padded_vocab
from repro_torch.tree import tree_map

PARALLEL_PLAN_MAX_PARAMS = 10e9


@dataclass
class StepBundle:
    name: str
    fn: Callable
    in_specs: Tuple
    in_shardings: Tuple
    out_shardings: Any
    meta: Dict[str, Any]


# ---------------------------------------------------------------------------
# Profiles
# ---------------------------------------------------------------------------


def choose_plan(cfg: ModelConfig) -> str:
    return (
        "client_parallel"
        if cfg.param_count() < PARALLEL_PLAN_MAX_PARAMS
        else "client_serial"
    )


def choose_grad_accum(cfg: ModelConfig, per_shard_batch: int) -> int:
    n = cfg.param_count()
    if n >= 50e9:
        target = 1
    elif n >= 10e9:
        target = 2
    else:
        return 1
    return max(1, per_shard_batch // target)


def make_fl_config(cfg: ModelConfig, plan: str, n_clients: int) -> FLConfig:
    return FLConfig(
        n_clients=n_clients,
        # coherence scoring costs a params-size all-reduce per client in the
        # parallel plan — keep it for sub-B models, off for multi-B LMs
        coherence_scoring=cfg.param_count() < 1e9,
        clients_per_round=max(2, n_clients // 4),
        adaptive_k=True,
        local_lr=0.01,
        dp_enabled=True,
        dp_mode="clipped",
        dp_epsilon=8.0,
        dp_clip=1.0,
        fault_tolerance=True,
        failure_prob=0.05,
        plan=plan,
        serial_clients_in_step=2,
        local_steps_in_step=1,
    )


def _scan_correction(cfg: ModelConfig, mode: str, clients_scan: int = 1,
                     local_steps: int = 1, grad_accum: int = 1) -> dict:
    """The reference's record of a step's static trip structure: XLA's
    cost analysis counts a scan body once, and ``product`` is its
    correction factor.  The port runs its layers, slots and microbatches
    as Python loops and its flop counter sees every trip, so its counts
    need no correction (``"port_counts_every_trip": True``); the dict is
    kept so the two dry-runs' records read alike."""
    segs = cfg.segments()
    blocks_counted = sum(len(kinds) for kinds, _ in segs)
    total_blocks = sum(len(kinds) * reps for kinds, reps in segs)
    layers_mult = total_blocks / max(blocks_counted, 1)
    if cfg.enc_layers:
        layers_mult = (cfg.enc_layers + cfg.n_layers) / 2.0
    product = layers_mult * clients_scan * local_steps * grad_accum
    return {
        "layers_mult": layers_mult,
        "clients_scan": clients_scan,
        "local_steps": local_steps,
        "grad_accum": grad_accum,
        "product": product,
        "port_counts_every_trip": True,
    }


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------


def _spec(shape, spec, mesh):
    return sanitize_pspec(tuple(shape), spec, mesh)


def param_pspecs(model: Model, rules: dict, mesh):
    """The params' PartitionSpecs, leaf by leaf (after
    ``sanitize_pspec``)."""
    return tree_map(lambda a, s: _spec(s.shape, logical_to_pspec(a, rules),
                                       mesh),
                    model.axes(), model.param_shapes())


def param_shardings(model: Model, rules: dict, mesh):
    return tree_map(lambda s: pspec_placements(s, mesh),
                    param_pspecs(model, rules, mesh))


def replicated(mesh, tree):
    return tree_map(lambda _: pspec_placements(P(), mesh), tree)


def batch_axes(rules: dict):
    ab = rules.get("act_batch")
    return ab if ab else None


def _named_map(fn, tree, name=None):
    """``fn(leaf name, leaf)`` over a tree of dicts and lists, the name
    being the nearest dict key above the leaf."""
    if isinstance(tree, dict):
        return {k: _named_map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_named_map(fn, v, name) for v in tree]
    return fn(name, tree)


def cache_pspecs(cache_specs, rules: dict, mesh, *, ssm_shard: str = "heads"):
    """Decode-cache PartitionSpecs by leaf name:
      k/v   [L,B,C,H,D]  → batch over data axes, cache SEQ over model
                            (context-parallel decode; kv heads replicated)
      h     [L,B,W]      → recurrent width over model
      conv  [L,B,K,C]    → channel dim over model
      ssm   [L,B,H,P,N]  → ``ssm_shard``: "heads" puts model on H (falls back
                            to replicated when H doesn't divide); "state" puts
                            it on N (the SSD state dim); "state_convrep"
                            also replicates ``conv``.
    """
    ab = batch_axes(rules)

    def spec_for(name, leaf):
        nd = leaf.dim()
        if name in ("k", "v"):
            s = P(None, ab, "model", None, None) if nd == 5 else P(ab, "model", None, None)
        elif name == "h":
            s = P(None, ab, "model") if nd == 3 else P(ab, "model")
        elif name == "conv":
            if ssm_shard == "state_convrep":
                s = P(None, ab, None, None) if nd == 4 else P(ab, None, None)
            else:
                s = P(None, ab, None, "model") if nd == 4 else P(ab, None, "model")
        elif name == "ssm":
            if ssm_shard in ("state", "state_convrep"):
                s = (P(None, ab, None, None, "model") if nd == 5
                     else P(ab, None, None, "model"))
            else:
                s = (P(None, ab, "model", None, None) if nd == 5
                     else P(ab, "model", None, None))
        else:
            s = P()
        return _spec(leaf.shape, s, mesh)

    return _named_map(spec_for, cache_specs)


def cache_shardings(cache_specs, rules: dict, mesh, *,
                    ssm_shard: str = "heads"):
    return tree_map(lambda s: pspec_placements(s, mesh),
                    cache_pspecs(cache_specs, rules, mesh,
                                 ssm_shard=ssm_shard))


def _client_axes(mesh_cfg: MeshConfig):
    return ("pod", "data") if mesh_cfg.multi_pod else ("data",)


def _mesh_size(mesh, axes) -> int:
    """The number of ranks over ``axes`` of a ``DeviceMesh`` or a
    ``MeshConfig``."""
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _leading_spec(shape, lead, mesh):
    return _spec(shape, P(*(tuple(lead) + (None,) * (len(shape) - len(lead)))),
                 mesh)


# ---------------------------------------------------------------------------
# Placing inputs
# ---------------------------------------------------------------------------


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and all(hasattr(p, "is_shard") for p in x)


def _zip_map(fn, tree, shard_tree):
    """``fn(leaf, placements)`` over a tree of dicts, lists, tuples and
    NamedTuples whose shardings tree has the same structure."""
    if _is_placements(shard_tree):
        return fn(tree, shard_tree)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shard_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_zip_map(fn, v, s) for v, s in zip(tree, shard_tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    if shard_tree is None:
        return tree
    raise TypeError(f"no placements for {type(tree).__name__}")


def place(tree, shardings, mesh):
    """The full tensors of ``tree`` as DTensors with ``shardings``: each
    rank keeps its own shard of the (identical) full tensor it holds,
    with no communication.  Leaves whose sharding is ``None`` (host
    values) pass through."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, pl):
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return _zip_map(one, tree, shardings)


def abstract_inputs(tree, shardings, mesh):
    """``meta`` specs as DTensors of empty local shards on the mesh's
    device type (call under a ``FakeTensorMode`` for the dry-run: nothing
    is allocated)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.shardctx import local_box

    def one(spec, pl):
        local_shape, _ = local_box(spec.shape, mesh, pl)
        local = torch.empty(local_shape, dtype=spec.dtype,
                            device=mesh.device_type)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=spec.shape,
                                  stride=torch.empty(spec.shape,
                                                     device="meta").stride())

    return _zip_map(one, tree, shardings)


def _redistribute(x, placements):
    return x.redistribute(x.device_mesh, placements)


# ---------------------------------------------------------------------------
# Train step (one FL communication round on the assigned architecture)
# ---------------------------------------------------------------------------


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
                     mesh, *, plan: Optional[str] = None,
                     grad_accum: Optional[int] = None,
                     remat: str = "full",
                     remat_group: int = 1,
                     rules_override: Optional[dict] = None,
                     n_clients: int = 40,
                     fl: Optional[FLConfig] = None) -> StepBundle:
    """One FL round on the plan's program family.  ``fn(state, batches,
    draws=None)`` takes a ``RoundState`` (``core/rounds.py``
    ``init_serial_state``) whose params are DTensors placed by
    ``in_shardings[0]`` (the selection state plain, the same on every
    rank) and DTensor batches placed by ``in_shardings[1]``.

    ``client_serial``: the K = ``serial_clients_in_step`` slots folded
    into the step, each client's batch ``[K, steps, B, ...]`` over the
    data axes, params FSDP over data and tensor-parallel over model.
    ``client_parallel`` (and its family): one client a data rank (the
    reference's ``n_clients`` = the data ranks), batches ``[n, steps,
    B/n, ...]`` split over the data axes, params replicated over them
    and tensor-parallel over model (``RULES_PARALLEL``); each data rank
    trains its clients on the model sub-mesh and keeps their update rows
    (``ClientRows``), and FedAvg is one all-reduce over the data axes.
    ``grad_accum`` defaults to 1 there, as in the reference.  ``fl``
    replaces the reference's ``make_fl_config`` (its ``n_clients`` then
    counts: for ``client_parallel`` a multiple of the data ranks)."""
    from repro_torch.core import rounds as rounds_lib
    model = build(cfg)
    plan = plan or choose_plan(cfg)
    plan_spec = plans_lib.get_plan(plan)
    family = plan_spec.family
    rules = dict(rules_override or make_rules(plan, mesh_cfg.multi_pod))
    client_axes = _client_axes(mesh_cfg)
    data_shards = _mesh_size(mesh, client_axes)
    parallel = family == "client_parallel"
    if parallel:
        n_clients = data_shards if fl is None else fl.n_clients
        if n_clients % data_shards:
            raise ValueError(f"{n_clients} clients do not split over "
                             f"{data_shards} data ranks")
        per_client_batch = max(1, shape.global_batch // n_clients)
        ga = 1 if grad_accum is None else grad_accum
    else:
        per_client_batch = shape.global_batch
        per_shard = max(1, per_client_batch // data_shards)
        ga = (grad_accum if grad_accum is not None
              else choose_grad_accum(cfg, per_shard))

    if fl is None:
        fl = make_fl_config(cfg, plan, n_clients)
    n_clients = fl.n_clients

    def loss_fn(p, b):
        return model.loss(p, b, remat=remat, remat_group=remat_group)

    base = model.input_specs(dataclasses.replace(shape, global_batch=per_client_batch))
    steps = fl.local_steps_in_step
    slots = n_clients if parallel else fl.serial_clients_in_step
    batches = {k: torch.empty((slots, steps) + tuple(s.shape), dtype=s.dtype,
                              device="meta") for k, s in base.items()}
    lead = ((client_axes if len(client_axes) > 1 else client_axes[0], None)
            if parallel else (None, None, rules.get("act_batch")))
    batch_shard = {k: pspec_placements(_leading_spec(s.shape, lead, mesh),
                                       mesh)
                   for k, s in batches.items()}
    p_shard = param_shardings(model, rules, mesh)

    meta = {}
    if parallel:
        round_step = rounds_lib.make_parallel_round(
            loss_fn, fl, n_clients, device=mesh.device_type,
            plan_codes=(plans_lib.plan_code(plan),), grad_accum=ga,
            delta_constraint=rounds_lib.ClientRows(mesh, client_axes),
            lm=True)
        ctx_rules = without_axes(rules, client_axes)
    else:
        delta_dtype = (torch.bfloat16 if cfg.param_count() > 100e9
                       else torch.float32)
        meta["delta_dtype"] = str(delta_dtype).replace("torch.", "")
        round_step = rounds_lib.make_serial_round(
            loss_fn, fl, n_clients, grad_accum=ga, delta_dtype=delta_dtype,
            device=mesh.device_type, mesh=mesh)
        ctx_rules = rules

    def step(state, batches, draws=None):
        # the parallel round's model runs on the model sub-mesh
        ctx_mesh = (rounds_lib.client_submeshes(mesh, client_axes)[1]
                    if parallel else mesh)
        with sharding_ctx(ctx_rules, ctx_mesh):
            return round_step(state, batches, draws=draws)

    tokens = slots * steps * per_client_batch * shape.seq_len
    return StepBundle(
        name=f"fl_round[{plan}]",
        fn=step,
        in_specs=(model.param_shapes(), batches),
        in_shardings=(p_shard, batch_shard),
        out_shardings=(p_shard, None),
        meta={
            "plan": plan, "grad_accum": ga, "tokens_per_step": tokens,
            "clients_in_step": slots,
            "per_client_batch": per_client_batch,
            "n_clients": n_clients, "fl": fl, **meta,
            "scan": _scan_correction(
                cfg, "train", clients_scan=1 if parallel else slots,
                local_steps=steps, grad_accum=ga),
        },
    )


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
                       mesh, rules_override: Optional[dict] = None,
                       impl: str = "ref") -> StepBundle:
    """``fn(params, batch)`` → the last position's logits [B, 1, V]
    (batch over the data axes, vocab over model)."""
    model = build(cfg)
    rules = dict(rules_override or make_rules("client_serial", mesh_cfg.multi_pod))
    window = effective_window(cfg, shape)
    specs = model.input_specs(shape)
    ab = rules.get("act_batch")
    batch_shard = {k: pspec_placements(_leading_spec(s.shape, (ab,), mesh), mesh)
                   for k, s in specs.items()}
    out_spec = (shape.global_batch, 1, padded_vocab(cfg))
    out_shard = pspec_placements(_spec(out_spec, P(ab, None, "model"), mesh), mesh)

    @torch.no_grad()
    def step(params, batch):
        with sharding_ctx(rules, mesh):
            logits = model.forward(params, batch, impl=impl, window=window,
                                   last_only=True)
            return _redistribute(logits, out_shard)

    return StepBundle(
        name="serve_prefill",
        fn=step,
        in_specs=(model.param_shapes(), specs),
        in_shardings=(param_shardings(model, rules, mesh), batch_shard),
        out_shardings=out_shard,
        meta={"window": window,
              "tokens_per_step": shape.global_batch * shape.seq_len,
              "scan": _scan_correction(cfg, "prefill")},
    )


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
                      mesh, rules_override: Optional[dict] = None,
                      ssm_shard: str = "state") -> StepBundle:
    """``fn(params, token, caches, index)`` → (logits [B, 1, V], caches):
    ``index`` a host int (``meta["index"]`` is the last slot of a full
    cache); the caches are written in place, each slot by the rank that
    holds it."""
    model = build(cfg)
    rules = dict(rules_override or make_rules("client_serial", mesh_cfg.multi_pod))
    window = effective_window(cfg, shape)
    specs = model.input_specs(shape)
    ab = rules.get("act_batch")
    c_shard = cache_shardings(specs["caches"], rules, mesh, ssm_shard=ssm_shard)
    t_shard = pspec_placements(_spec(specs["token"].shape, P(ab, None), mesh), mesh)
    out_spec = (shape.global_batch, 1, padded_vocab(cfg))
    logits_shard = pspec_placements(_spec(out_spec, P(ab, None, "model"), mesh),
                                    mesh)

    @torch.no_grad()
    def step(params, token, caches, index: int):
        with sharding_ctx(rules, mesh):
            logits, new_caches = model.decode_step(params, token, caches,
                                                   int(index), window=window)
            return _redistribute(logits, logits_shard), new_caches

    return StepBundle(
        name="serve_decode",
        fn=step,
        in_specs=(model.param_shapes(), specs["token"], specs["caches"],
                  specs["index"]),
        in_shardings=(param_shardings(model, rules, mesh), t_shard, c_shard,
                      None),
        out_shardings=(logits_shard, c_shard),
        meta={"window": window, "cache_len": shape.seq_len,
              "index": shape.seq_len - 1,
              "tokens_per_step": shape.global_batch,
              "scan": _scan_correction(cfg, "decode")},
    )


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig, mesh,
               **kw) -> StepBundle:
    if shape.mode == "train":
        return build_train_step(cfg, shape, mesh_cfg, mesh, **kw)
    if shape.mode == "prefill":
        return build_prefill_step(cfg, shape, mesh_cfg, mesh, **kw)
    return build_decode_step(cfg, shape, mesh_cfg, mesh, **kw)
