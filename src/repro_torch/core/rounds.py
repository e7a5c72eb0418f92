"""The FL round engine — Algorithm 1 as one PyTorch round step: the port's
copy of ``repro/core/rounds.py``'s ``client_parallel`` family (plan codes
0 sync, 1 ``buffered_async``, 2 ``hierarchical``) and its
``client_cohort`` plan.

Algorithm 1 exists once, as the LANE step of :func:`make_lane_round`: it
advances ``L`` independent runs (a sweep's seed×config lanes) together.
State is ``[L, n]`` per client and ``[L, P]`` for the global model; every
runtime knob of :class:`FLParams` is a Python float shared by the lanes or
an ``[L]`` tensor with one value a lane.  Local training runs for all
``L·n`` client rows at once (``torch.func.vmap`` of ``grad_and_value`` over
the functional params, the counterpart of the reference's
``jax.vmap(local_train)`` under its ``jax.vmap`` over lanes), the updates
are flattened to ``[L·n, P]`` rows in leaf order, privatised by the fused
clip+noise kernel (``core/dp.py`` → ``kernels/ops.py``; the kernel takes
one σ a row, so every lane's ε rides one launch), and aggregated as a
masked weighted mean per lane.  The ``plan_code`` lane picks, by
``torch.where``, the staleness-weighted mean of ``buffered_async`` or the
edge-then-cloud mean of ``hierarchical``; code-0 lanes are bitwise the
synchronous plan, and no lane draws more random numbers.
:func:`make_parallel_round` is the one-run view of the same step
(``L = 1``) for a detector; at ``lm=True`` it runs the same plan on an
LM's param tree (:func:`_make_tree_round`: the clients one after another, one
``[n, P]`` row each, K1 on the rows), on one process or, with a
:class:`ClientRows`, one client a data rank of a mesh.  An optional
``update_gate`` (``[L]`` 0/1) withholds a lane's release (budget
exhaustion under scheduled privacy, :func:`_gate_server_update`).

:func:`make_cohort_round` is the population-scale form: availability,
scores, the cohort top-k and the failure processes run as ``[L, N]``
vector ops, and training, DP and aggregation run on the gathered
``[L, k_max]`` cohort only; given a :class:`ClientShard` the ``[L, N]``
state is this rank's columns of it.

:func:`make_serial_round` is the ``client_serial`` plan, the reference's
large-model path (``launch/train.py``): one run, one client slot at a
time, on a param TREE kept in its storage dtype (bf16 for the LMs).  Each
slot trains with autograd (:func:`microbatched_value_and_grad`, optional
gradient accumulation), writes its f32 update straight into one flat
``[P]`` buffer that the DP kernel reads as a ``[1, P]`` row, and streams
into an f32 accumulator (``aggregation.stream_*``); the server steps the
tree leaf by leaf.

Fault tolerance: failure times come from ``fault/process.py``; a client
that fails at step f keeps ``c·⌊f/c⌋`` steps of work with checkpoints every
``c`` steps, or nothing without fault tolerance.

Random draws: torch cannot reproduce JAX's threefry stream.  A round's
variates form a :class:`RoundDraws` (or :class:`CohortDraws`,
:class:`SerialDraws`) bundle, drawn from each lane's ``torch.Generator``
on the device (:func:`draw_round`, :func:`draw_cohort_round`,
:func:`draw_serial_round`), or built by a caller (the parity tests rebuild
the reference's own draws from its keys).  This is the port's counterpart
of the key argument.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import FLConfig, FLParams, as_f32, fl_params
from repro_torch.core import aggregation as agg
from repro_torch.core import dp as dp_lib
from repro_torch.core import selection as sel_lib
from repro_torch.core.plans import get_plan
from repro_torch.data.synthetic import Population, sample_cohort_batches
from repro_torch.device import resolve_device
from repro_torch.fault import process as fault_proc
from repro_torch.kernels import ops as kops
from repro_torch.optim.optimizers import (AdamState, make_server_optimizer,
                                          make_tree_server_optimizer,
                                          tree_sgd)
from repro_torch.tree import (flatten_rows, tree_leaves, tree_map,
                              unflatten_rows)


class RoundState(NamedTuple):
    """Carried across communication rounds: one run's, or ``L`` lanes' with
    a leading lane axis on every tensor and one generator a lane."""

    params: Dict[str, Any]       # nested dict of tensors (the global model)
    server_opt_state: Any        # over the flat [P] / [L, P] model, or
                                 # the param tree (the serial plan)
    util: sel_lib.UtilityState
    kctl: sel_lib.KControllerState
    round_idx: int
    rng: Any                     # torch.Generator, or a list of L of them
    fault: fault_proc.FaultState


class RoundMetrics(NamedTuple):
    sel_mask: torch.Tensor
    avail: torch.Tensor
    failed: torch.Tensor
    pre_loss: torch.Tensor
    post_loss: torch.Tensor
    global_loss: torch.Tensor
    k_effective: torch.Tensor
    update_norms: torch.Tensor
    slow: torch.Tensor      # [n] round-time stretch factors (straggler process)


class RoundDraws(NamedTuple):
    """One round's random variates (the reference's key splits, as values).

    * ``avail_u [n]`` — uniforms; client i is available iff
      ``avail_u[i] < avail_prob`` (``jax.random.bernoulli``'s rule);
    * ``sel_noise [n]`` — the selection variate (``NOISE_KIND``: Gumbel or
      uniform);
    * ``fault_u [4, n]`` / ``fault_steps [3, n]`` — the failure processes'
      uniforms and integer steps (``fault/process.py``);
    * ``dp_noise [n, P]`` — standard normals in leaf order.

    A sweep's bundle has a leading lane axis on each.
    """

    avail_u: torch.Tensor
    sel_noise: torch.Tensor
    fault_u: torch.Tensor
    fault_steps: torch.Tensor
    dp_noise: torch.Tensor

    def to(self, device) -> "RoundDraws":
        return RoundDraws(*(None if t is None else t.to(device)
                            for t in self))

    def lane(self, i: int) -> "RoundDraws":
        """Lane ``i`` of a sweep's bundle."""
        return RoundDraws(*(t[i] for t in self))

    @staticmethod
    def empty(lanes: int, n: int, n_params: int, device) -> "RoundDraws":
        """Buffers for ``lanes`` lanes' draws (:func:`draw_round`'s
        ``out``)."""
        return RoundDraws(
            avail_u=torch.empty(lanes, n, device=device),
            sel_noise=torch.empty(lanes, n, device=device),
            fault_u=torch.empty(lanes, 4, n, device=device),
            fault_steps=torch.empty(lanes, 3, n, dtype=torch.long,
                                    device=device),
            dp_noise=torch.empty(lanes, n, n_params, device=device))

    @staticmethod
    def stack(draws: Sequence["RoundDraws"]) -> "RoundDraws":
        """One bundle a lane -> a sweep's bundle."""
        return RoundDraws(*(torch.stack(ts) for ts in zip(*draws)))


def draw_round(gens: Sequence[torch.Generator], n: int, local_steps: int,
               n_params: int, selection: str,
               out: Optional[RoundDraws] = None) -> RoundDraws:
    """Draw one round's :class:`RoundDraws` for every lane, lane ``l`` from
    ``gens[l]`` on its device, in a fixed order (availability, selection
    variate, failure uniforms, failure steps, DP noise).  ``out`` is a
    bundle of buffers to draw into: a sweep draws each round's
    ``[L, n, P]`` noise into one preallocated buffer, each lane its
    slice."""
    if out is None:
        out = RoundDraws.empty(len(gens), n, n_params, gens[0].device)
    for i, gen in enumerate(gens):
        out.avail_u[i].uniform_(generator=gen)
        out.sel_noise[i].uniform_(generator=gen)
        out.fault_u[i].uniform_(generator=gen)
        out.fault_steps[i].random_(0, local_steps, generator=gen)
        out.dp_noise[i].normal_(generator=gen)
    return out._replace(sel_noise=_selection_variate(out.sel_noise,
                                                     selection))


def _selection_variate(u: torch.Tensor, selection: str) -> torch.Tensor:
    """Uniforms ``u`` as the variate ``selection`` consumes
    (``NOISE_KIND``): standard Gumbel, or the uniforms themselves."""
    if sel_lib.NOISE_KIND[selection] == "gumbel":
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return u


def init_round_state(params, fl: FLConfig, gen: torch.Generator,
                     n_clients=None, **util_kw) -> RoundState:
    """Fresh state of one run on ``gen.device``; ``gen`` draws the utility
    state's compute/comm costs now and the round variates later."""
    n = n_clients or fl.n_clients
    server = make_server_optimizer(fl.server_opt, fl.server_lr)
    return RoundState(
        params=params,
        server_opt_state=server.init(flatten_rows(params, 0)),
        util=sel_lib.init_utility_state(n, gen=gen, **util_kw),
        kctl=sel_lib.init_k_state(fl, device=gen.device),
        round_idx=0,
        rng=gen,
        fault=fault_proc.init_fault_state(n, device=gen.device),
    )


def _opt_map(fn: Callable, *opt_states):
    """``fn`` over the tensors of server optimizer states (or param trees)
    of one structure: tensors, dicts, lists and ``AdamState`` (a lane's
    Adam step count is its own, as each lane's is in the reference's vmap:
    a gated lane does not step)."""
    first = opt_states[0]
    if isinstance(first, torch.Tensor):
        return fn(*opt_states)
    if isinstance(first, dict):
        return {k: _opt_map(fn, *(s[k] for s in opt_states)) for k in first}
    if isinstance(first, (list, AdamState)):
        vals = [_opt_map(fn, *ts) for ts in zip(*opt_states)]
        return AdamState(*vals) if isinstance(first, AdamState) else vals
    return first  # () of plain SGD


def stack_states(states: Sequence[RoundState]) -> RoundState:
    """One run's state a lane -> the lanes' state (the lanes step together,
    so they share the first one's round index)."""
    first = states[0]
    params = tree_map(lambda *ls: torch.stack(ls), *(s.params for s in states))
    opt = _opt_map(lambda *ts: torch.stack(ts),
                   *(s.server_opt_state for s in states))
    stack = lambda *xs: type(xs[0])(*map(torch.stack, zip(*xs)))  # noqa: E731
    return RoundState(params, opt, stack(*(s.util for s in states)),
                      stack(*(s.kctl for s in states)), first.round_idx,
                      [s.rng for s in states],
                      stack(*(s.fault for s in states)))


def lane_state(state: RoundState, i: int) -> RoundState:
    """Lane ``i`` of the lanes' state, as one run's state."""
    lane = lambda t: t[i]  # noqa: E731
    return RoundState(tree_map(lane, state.params),
                      _opt_map(lane, state.server_opt_state),
                      type(state.util)(*map(lane, state.util)),
                      type(state.kctl)(*map(lane, state.kctl)),
                      state.round_idx, state.rng[i],
                      type(state.fault)(*map(lane, state.fault)))


def _local_train_fn(loss_fn: Callable):
    """Local SGD of every client row of every lane at once, with step
    masking (``effective_steps`` implements checkpoint-recovery
    truncation).  Returns ``(delta [L, n, P], loss at the first step
    [L, n], loss at the last [L, n])``."""
    grad_and_loss = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def local_train(global_params, step_batches, effective_steps, lr):
        lanes, n, local_steps = step_batches["x"].shape[:3]
        rows = lanes * n
        p = tree_map(lambda a: a[:, None].expand(lanes, n, *a.shape[1:])
                     .reshape(rows, *a.shape[1:]), global_params)
        batches = {k: v.reshape(rows, *v.shape[2:])
                   for k, v in step_batches.items()}
        steps_rows = effective_steps.reshape(rows)
        if isinstance(lr, torch.Tensor):  # one lr a lane -> one a row
            lr = lr.repeat_interleave(n)
        losses = []
        for s in range(local_steps):
            grads, loss = grad_and_loss(
                p, {k: v[:, s] for k, v in batches.items()})
            live = s < steps_rows

            def step(a, g):
                shape = (-1,) + (1,) * (a.dim() - 1)
                rate = lr.reshape(shape) if isinstance(lr, torch.Tensor) \
                    else lr
                return torch.where(live.reshape(shape), a - rate * g, a)

            p = tree_map(step, p, grads)
            losses.append(loss)
        delta = (flatten_rows(p).reshape(lanes, n, -1)
                 - flatten_rows(global_params)[:, None])
        return (delta, losses[0].reshape(lanes, n),
                losses[-1].reshape(lanes, n))

    return local_train


def _effective_steps(fail_step, local_steps: int, ckpt_every: int,
                     ft_enabled: bool):
    """Steps of work that survive a failure at ``fail_step``."""
    failed = fail_step < local_steps
    full = torch.full_like(fail_step, local_steps)
    if not ft_enabled:
        return torch.where(failed, torch.zeros_like(fail_step), full), failed
    c = max(int(ckpt_every), 1)
    kept = (fail_step // c) * c
    return torch.where(failed, kept, full), failed


def _dp_sigma(fl: FLConfig, pr: FLParams):
    """Noise scale: ``dp_sigma`` in paper mode, the Gaussian mechanism's σ
    for ``dp_clip`` and ``dp_epsilon`` when clipped (a float, or one a
    lane)."""
    if fl.dp_mode == "paper" or fl.dp_scheduled:
        return pr.dp_sigma
    return dp_lib.gaussian_sigma_rt(pr.dp_epsilon, fl.dp_delta, pr.dp_clip)


def _gate_server_update(update_gate, new_params, new_server_state,
                        params, server_state):
    """Budget-exhaustion masking: a lane whose ``update_gate`` is ≤ 0 keeps
    its global params AND server-optimizer state bitwise (the old values
    are selected, not a zero update added), as a deployment that halts at
    exhaustion.  ``update_gate`` is an ``[L]`` 0/1 device tensor, so a lane
    can flip without a host read (a 0-d one for the serial round's single
    run); ``None`` leaves the step ungated.  Params are flat lanes or a
    tree."""
    if update_gate is None:
        return new_params, new_server_state
    live = update_gate > 0

    def keep(new, old):
        return torch.where(live.reshape(
            live.shape + (1,) * (new.dim() - live.dim())), new, old)

    return (_opt_map(keep, new_params, params),
            _opt_map(keep, new_server_state, server_state))


def _column(v):
    """A per-lane ``[L]`` knob as an ``[L, 1]`` column beside ``[L, n]``
    client state; a float as it is."""
    return v[:, None] if isinstance(v, torch.Tensor) else v


def _rows(v, n: int):
    """A per-lane ``[L]`` knob as one value per client row ``[L·n]``."""
    return v.repeat_interleave(n) if isinstance(v, torch.Tensor) else v


def _coherence(deltas: torch.Tensor, agg_delta: torch.Tensor, mask):
    """cos(Δ_i, Δ_agg) of each client row ``deltas [L, n, P]`` with its
    lane's aggregate ``[L, P]``, times ``mask [L, n]``."""
    agg_norm = torch.sqrt(torch.clamp(
        torch.sum(agg_delta * agg_delta, dim=-1), min=1e-18))
    nrm = torch.sqrt(torch.clamp(torch.sum(deltas * deltas, dim=-1),
                                 min=1e-18))
    num = torch.sum(deltas * agg_delta[:, None], dim=-1)
    return num / (nrm * agg_norm[:, None]) * mask


def _async_mask(contrib_mask, slow, compute, col: FLParams, code):
    """The ``buffered_async`` plan's (code 1) aggregation mask: every
    contributor's update lands this round, discounted by how many K-sized
    buffer flushes precede its arrival: staleness s = ⌊rank/K⌋, weight
    (1+s)^-pow.  Arrival order comes from the failure processes' slow
    factors and the compute capacities, not from new draws; on lanes of
    another code the weight is exactly 1.0.  Over ``[..., n]``."""
    with record_function("async_buffer"):
        arrive = fault_proc.arrival_score(slow, compute)
        arrive = torch.where(contrib_mask > 0, arrive,
                             torch.full_like(arrive, math.inf))
        rank = torch.argsort(torch.argsort(arrive, dim=-1, stable=True),
                             dim=-1, stable=True).float()
        stale = torch.floor(rank / torch.clamp(
            as_f32(col.async_buffer, rank), min=1.0))
        stale_w = torch.pow(1.0 + stale,
                            -as_f32(col.async_staleness_pow, rank))
        return contrib_mask * torch.where(code == 1.0, stale_w,
                                          torch.ones_like(stale_w))


def _edge_sum(v: torch.Tensor, n_edges: int) -> torch.Tensor:
    """Sums of ``v [L, n, ...]`` over the clients of each edge, client i
    reporting to edge ``i % n_edges``: ``[L, n_edges, ...]``.  The client
    axis is padded with zeros to a multiple of the edges and folded, so the
    sums are a fixed reduction, not float atomics."""
    lanes, n = v.shape[:2]
    groups = -(-n // n_edges)
    pad = groups * n_edges - n
    if pad:
        v = torch.cat([v, v.new_zeros((lanes, pad) + v.shape[2:])], dim=1)
    return v.reshape(lanes, groups, n_edges, *v.shape[2:]).sum(dim=1)


def _edge_weights(w_cli: torch.Tensor, n_edges: int):
    """The ``hierarchical`` plan's edges for client weights ``w_cli [L,
    n]``: (each edge's weight ``[L, E]``, 1.0 where it is live (nonzero),
    the live edges ``[L]``, at least 1)."""
    edge_w = _edge_sum(w_cli, n_edges)
    edge_live = (edge_w > 0).float()
    return edge_w, edge_live, torch.clamp(torch.sum(edge_live, dim=-1),
                                          min=1.0)


def _hier_aggregate(deltas: torch.Tensor, w_cli: torch.Tensor,
                    n_edges: int) -> torch.Tensor:
    """The ``hierarchical`` plan's update ``[L, P]``: each edge takes the
    weighted mean of its clients' ``deltas [L, n, P]`` (weights ``w_cli
    [L, n]``), and the cloud the unweighted mean over live edges (those
    whose weight is nonzero)."""
    edge_w, edge_live, n_live = _edge_weights(w_cli, n_edges)
    esum = _edge_sum(deltas.float() * w_cli[..., None], n_edges)
    edelta = esum / torch.clamp(edge_w, min=1e-9)[..., None]
    return (torch.sum(edelta * edge_live[..., None], dim=1)
            / n_live[:, None])


class _Picked(NamedTuple):
    """What :func:`_select_and_fail` gives back."""

    avail: torch.Tensor           # [..., n] available clients
    k_eff: torch.Tensor           # [...] the round's K
    sel_mask: torch.Tensor        # [..., n] selected clients
    slow: torch.Tensor            # [..., n] slow factors
    fault: Any                    # the failure processes' next state
    eff_steps: torch.Tensor       # [..., n] surviving local steps
    failed: torch.Tensor          # [..., n] bool


def _select_and_fail(strategy, fl: FLConfig, state: RoundState, draws,
                     col: FLParams, k_shape, k_max: int, n: int,
                     local_steps: int, ckpt_every_steps: int,
                     device) -> _Picked:
    """Algorithm 1 lines 3-4 and the failure processes, from the round's
    draws: the ``client_parallel`` family's shared head (the lane step's
    ``[L, n]``, ``k_shape = (L,)``, and the param-tree round's ``[n]``,
    ``k_shape = ()``)."""
    # ---- GetAvailableClients (Alg.1 line 3) ----
    avail = (draws.avail_u < as_f32(col.avail_prob, draws.avail_u)).float()

    # ---- ComputeUtility + SelectTopK (line 4) ----
    # record_function spans name the reference's jax.named_scope phases
    # in a torch.profiler trace; outside a trace they cost ~1 us each
    with record_function("selection"):
        utility = sel_lib.compute_utility(state.util, fl,
                                          fault_w=col.fault_util_w)
        k_eff = (state.kctl.k if fl.adaptive_k
                 else torch.full(k_shape, float(fl.clients_per_round),
                                 device=device))
        sel_mask = strategy(draws.sel_noise, state.util, utility, avail,
                            k_eff, k_max, col.explore_noise)

    # ---- failure injection + checkpoint-recovery truncation ----
    fail_at, slow, new_fault = fault_proc.fault_step(
        state.fault, draws.fault_u, draws.fault_steps, col, n, local_steps)
    eff_steps, failed = _effective_steps(fail_at, local_steps,
                                         ckpt_every_steps, fl.fault_tolerance)
    return _Picked(avail, k_eff, sel_mask, slow, new_fault, eff_steps,
                   failed)


def _close_round(fl: FLConfig, pr: FLParams, state: RoundState,
                 picked: _Picked, params, server_state, pre_loss, post_loss,
                 global_loss, norms, contrib, coherence
                 ) -> Tuple[RoundState, RoundMetrics]:
    """The ``client_parallel`` family's bookkeeping: utility and K from
    the round's losses, then the next state and the metrics."""
    failed_f = picked.failed.float()
    util = sel_lib.update_utility_state(
        state.util, contrib, pre_loss, post_loss, fl, coherence=coherence,
        attempted=picked.sel_mask, failed=failed_f)
    kctl = sel_lib.update_k(state.kctl, global_loss, fl, tol=pr.k_tol,
                            patience=pr.k_patience)
    new_state = RoundState(params, server_state, util, kctl,
                           state.round_idx + 1, state.rng, picked.fault)
    metrics = RoundMetrics(picked.sel_mask, picked.avail, failed_f, pre_loss,
                           post_loss, global_loss, picked.k_eff, norms,
                           picked.slow)
    return new_state, metrics


class _Release(NamedTuple):
    """What :func:`_train_and_release` gives back for ``[L, m]`` client
    rows."""

    flat: torch.Tensor            # [L, P] released global model
    server_state: Any
    pre_loss: torch.Tensor        # [L, m]
    post_loss: torch.Tensor       # [L, m]
    norms: torch.Tensor           # [L, m] update norms (pre-clip)
    contrib: torch.Tensor         # [L, m] selected rows with surviving work
    coherence: Optional[torch.Tensor]   # [L, m], or None
    global_loss: torch.Tensor     # [L]


def _train_and_release(local_train: Callable, fl: FLConfig, pr: FLParams,
                       server, state: RoundState, flat_params, batches,
                       eff_steps, sel, dp_noise, aggregate: Callable,
                       update_gate) -> _Release:
    """Algorithm 1 from local training to the server's release, for the
    ``[L, m]`` client rows of the lane step (``m = n``) or the cohort step
    (``m = k_max``): local SGD, DP on the ``[L·m, P]`` rows (outside any
    vmap: the CUDA kernels are called through ctypes), ``aggregate(deltas
    [L, m, P], contrib [L, m]) -> [L, P]``, the server update and the
    release gate."""
    lanes, n_params = flat_params.shape
    m = eff_steps.shape[-1]
    with record_function("local_train"):
        deltas, pre_loss, post_loss = local_train(state.params, batches,
                                                  eff_steps, pr.local_lr)

    # ---- DP: noise on updates, not on scores (lines 8-9) ----
    with record_function("dp_privatize"):
        if fl.dp_enabled:
            rows, norms = dp_lib.privatize_rows(
                deltas.reshape(lanes * m, n_params),
                dp_noise.reshape(lanes * m, n_params),
                mode=fl.dp_mode, clip=_rows(pr.dp_clip, m),
                sigma=_rows(_dp_sigma(fl, pr), m))
            deltas = rows.reshape(lanes, m, n_params)
            norms = norms.reshape(lanes, m)
        else:
            norms = torch.sqrt(torch.sum(deltas * deltas, dim=-1))

    # drop clients whose surviving work is zero
    contrib = sel * (eff_steps > 0)

    # ---- aggregation + server update (line 18) ----
    with record_function("aggregate"):
        agg_delta = aggregate(deltas, contrib)
        new_flat, new_server_state = agg.apply_server_update(
            server, flat_params, state.server_opt_state, agg_delta)
        new_flat, new_server_state = _gate_server_update(
            update_gate, new_flat, new_server_state, flat_params,
            state.server_opt_state)

    # ---- update-coherence (data-quality observable): cos(Δ_i, Δ_agg) ----
    coherence = (_coherence(deltas, agg_delta, contrib)
                 if fl.coherence_scoring else None)
    sel_denom = torch.clamp(torch.sum(contrib, dim=-1), min=1.0)
    global_loss = torch.sum(post_loss * contrib, dim=-1) / sel_denom
    return _Release(new_flat, new_server_state, pre_loss, post_loss, norms,
                    contrib, coherence, global_loss)


def make_lane_round(loss_fn: Callable, fl: FLConfig, n_clients: int,
                    ckpt_every_steps: int = 2, device=None,
                    plan_codes: Optional[Sequence[float]] = None):
    """Build ``lane_step(state, batches, params, draws=None,
    update_gate=None) -> (state, metrics)``, Algorithm 1 for ``L`` lanes at
    once on ``device`` (``cuda`` unless ``"cpu"`` is asked).

    ``state``: the lanes' :class:`RoundState` (:func:`stack_states`).
    batches: ``{"x": [L, n, local_steps, b, d] f32, "y": [L, n,
    local_steps, b] int}``.  ``params``: :class:`FLParams` whose fields are
    floats or ``[L]`` f32 tensors on the device; a lane's ``plan_code``
    (0, 1 or 2) picks its plan within the ``client_parallel`` family.
    ``draws``: the lanes' :class:`RoundDraws`, or ``None`` to draw from
    ``state.rng``.
    ``update_gate``: ``[L]`` 0/1, or ``None`` (:func:`_gate_server_update`).
    ``plan_codes``: the codes the lanes may carry (a sweep knows its
    cells'), or ``None`` for all three; the async and hier blocks are
    built only for a code present (on other lanes their selects are
    identities, so leaving them out changes no bit).
    Metrics are ``[L, n]`` per client and ``[L]`` per lane.  The step
    issues no host synchronisation."""
    device = resolve_device(device)
    plan = get_plan(fl.plan)
    if plan.family != "client_parallel":
        raise NotImplementedError(
            f"the lane step runs the client_parallel family (sync, "
            f"buffered_async, hierarchical); plan {fl.plan!r} is of family "
            f"{plan.family!r}")
    strategy = sel_lib.get_strategy(fl.selection)
    local_train = _local_train_fn(loss_fn)
    k_max = int(fl.k_max or n_clients)
    n = n_clients
    n_edges = max(int(fl.hierarchy_edges), 1)
    codes = {0.0, 1.0, 2.0} if plan_codes is None else set(plan_codes)

    def lane_step(state: RoundState, batches, pr: FLParams,
                  draws: Optional[RoundDraws] = None,
                  update_gate: Optional[torch.Tensor] = None
                  ) -> Tuple[RoundState, RoundMetrics]:
        flat_params = flatten_rows(state.params)
        if flat_params.device != device:
            raise ValueError(f"state is on {flat_params.device}, the round "
                             f"step was built for {device}")
        lanes, n_params = flat_params.shape
        col = FLParams(*map(_column, pr))
        server = make_server_optimizer(fl.server_opt, col.server_lr)
        local_steps = batches["x"].shape[2]
        if draws is None:
            draws = draw_round(state.rng, n, local_steps,
                               n_params if fl.dp_enabled else 0, fl.selection)

        picked = _select_and_fail(strategy, fl, state, draws, col,
                                  (lanes,), k_max, n, local_steps,
                                  ckpt_every_steps, device)
        code = as_f32(col.plan_code, flat_params)   # [L, 1] or 0-d

        def aggregate(deltas, contrib_mask):
            agg_mask = contrib_mask
            if 1.0 in codes:
                agg_mask = _async_mask(contrib_mask, picked.slow,
                                       state.util.compute, col, code)
            flat = agg.aggregate_stacked(deltas, agg_mask,
                                         state.util.data_size)
            if 2.0 not in codes:
                return flat
            # hierarchical (code 2): edge FedAvg, then the cloud's mean
            with record_function("hier_aggregate"):
                hier = _hier_aggregate(
                    deltas, agg_mask * state.util.data_size, n_edges)
            return torch.where(code == 2.0, hier, flat)

        # ---- local training over lanes × clients (line 5) → release ----
        rel = _train_and_release(local_train, fl, pr, server, state,
                                 flat_params, batches, picked.eff_steps,
                                 picked.sel_mask, draws.dp_noise, aggregate,
                                 update_gate)

        # ---- bookkeeping ----
        like = tree_map(lambda a: a[0], state.params)
        return _close_round(fl, pr, state, picked,
                            unflatten_rows(rel.flat, like), rel.server_state,
                            rel.pre_loss, rel.post_loss, rel.global_loss,
                            rel.norms, rel.contrib, rel.coherence)

    return lane_step


def make_parallel_round(loss_fn: Callable, fl: FLConfig, n_clients: int,
                        ckpt_every_steps: int = 2, device=None,
                        plan_codes: Optional[Sequence[float]] = None,
                        grad_accum: int = 1, delta_constraint=None,
                        lm: bool = False):
    """Build ``round_step(state, batches, params=None, draws=None,
    update_gate=None) -> (state, metrics)`` for one run on ``device``
    (``cuda`` unless ``"cpu"`` is asked).

    ``lm`` picks the route.  False: the lane step of :func:`make_lane_round`
    at ``L = 1`` on a detector's ``{"x": [n, local_steps, b, d] f32, "y":
    [n, local_steps, b] int}`` (``state`` from :func:`init_round_state`);
    it takes neither ``grad_accum`` nor ``delta_constraint``.  True: the
    param-tree round of :func:`_make_tree_round` on a dict of ``[n,
    local_steps, ...]`` tensors (an LM's ``{"tokens", "labels"}``, with
    ``frontend`` for a VLM or an encoder-decoder; ``state`` from
    :func:`init_serial_state`: params a tree in their storage dtype), with
    ``grad_accum`` microbatches a local step and, given a
    :class:`ClientRows` as ``delta_constraint``, the clients laid across a
    mesh's data ranks.

    ``params``: runtime :class:`FLParams` (``None`` uses ``fl``'s).
    ``draws``: a :class:`RoundDraws` on the device, or ``None`` to draw
    from ``state.rng``.  ``update_gate``: a 0-d 0/1 tensor, or ``None``.
    ``plan_codes``: as in :func:`make_lane_round`."""
    if lm:
        return _make_tree_round(loss_fn, fl, n_clients, ckpt_every_steps,
                                device, plan_codes, grad_accum,
                                delta_constraint)
    if grad_accum != 1 or delta_constraint is not None:
        raise ValueError(
            "the detector lane step takes neither grad_accum nor a "
            "delta_constraint; those are the param-tree round's (lm=True)")
    lane_step = make_lane_round(loss_fn, fl, n_clients, ckpt_every_steps,
                                device, plan_codes)
    default_params = fl_params(fl)

    def round_step(state: RoundState, batches,
                   params: Optional[FLParams] = None,
                   draws: Optional[RoundDraws] = None,
                   update_gate: Optional[torch.Tensor] = None
                   ) -> Tuple[RoundState, RoundMetrics]:
        pr = default_params if params is None else params
        lanes, metrics = lane_step(
            stack_states([state]), {k: v[None] for k, v in batches.items()},
            pr,
            None if draws is None else RoundDraws(*(t[None] for t in draws)),
            None if update_gate is None else update_gate.reshape(1))
        return lane_state(lanes, 0), RoundMetrics(*(t[0] for t in metrics))

    return round_step


# ---------------------------------------------------------------------------
# client_cohort plan (population scale: train the gathered cohort only)
# ---------------------------------------------------------------------------


class CohortMetrics(NamedTuple):
    """Round metrics in cohort form: ``[L, k_max]`` where
    :class:`RoundMetrics` was ``[L, n]``, plus population scalars ``[L]``."""

    cohort_idx: torch.Tensor    # [L, k_max] int64 selected client ids
    take: torch.Tensor          # [L, k_max] live-slot mask (rank < k_eff)
    failed: torch.Tensor        # [L, k_max] failure indicator (cohort)
    slow: torch.Tensor          # [L, k_max] straggler stretch (cohort)
    pre_loss: torch.Tensor      # [L, k_max]
    post_loss: torch.Tensor     # [L, k_max]
    global_loss: torch.Tensor   # [L]
    k_effective: torch.Tensor   # [L]
    update_norms: torch.Tensor  # [L, k_max]
    fail_frac: torch.Tensor     # [L] population-wide failure fraction


class CohortDraws(NamedTuple):
    """One cohort round's random variates for ``L`` lanes: the population
    vectors ``avail_u``/``sel_noise [L, N]``, ``fault_u [L, 4, N]`` and
    ``fault_steps [L, 3, N]`` as in :class:`RoundDraws`, and for the cohort
    rows ``dp_noise [L, k_max, P]`` and ``batch_u [L, k_max, local_steps,
    batch]`` (uniforms that become member positions).  ``batch_idx``
    (member positions) and ``shift [L, k_max, d]`` override the sampler's
    own, as the parity tests feed the reference's; ``None`` leaves them to
    :func:`~repro_torch.data.synthetic.sample_cohort_batches`."""

    avail_u: torch.Tensor
    sel_noise: torch.Tensor
    fault_u: torch.Tensor
    fault_steps: torch.Tensor
    dp_noise: torch.Tensor
    batch_u: Optional[torch.Tensor] = None
    batch_idx: Optional[torch.Tensor] = None
    shift: Optional[torch.Tensor] = None

    def to(self, device) -> "CohortDraws":
        return CohortDraws(*(None if t is None else t.to(device)
                             for t in self))

    @staticmethod
    def empty(lanes: int, n: int, k_max: int, local_steps: int, batch: int,
              n_params: int, device) -> "CohortDraws":
        """Buffers for ``lanes`` lanes' draws (:func:`draw_cohort_round`'s
        ``out``)."""
        d = RoundDraws.empty(lanes, n, 0, device)
        return CohortDraws(
            *d[:4], dp_noise=torch.empty(lanes, k_max, n_params,
                                         device=device),
            batch_u=torch.empty(lanes, k_max, local_steps, batch,
                                device=device))

    @staticmethod
    def stack(draws: Sequence["CohortDraws"]) -> "CohortDraws":
        """One bundle a lane -> the lanes' bundle."""
        return CohortDraws(*(None if ts[0] is None else torch.stack(ts)
                             for ts in zip(*draws)))


def draw_cohort_round(gens: Sequence[torch.Generator], n: int, k_max: int,
                      local_steps: int, batch: int, n_params: int,
                      selection: str,
                      out: Optional[CohortDraws] = None) -> CohortDraws:
    """Draw one cohort round's :class:`CohortDraws` for every lane from
    ``gens``: :func:`draw_round`'s variates in its order (the DP noise for
    the ``k_max`` cohort rows), then the batch uniforms."""
    if out is None:
        out = CohortDraws.empty(len(gens), n, k_max, local_steps, batch,
                                n_params, gens[0].device)
    d = draw_round(gens, n, local_steps, n_params, selection,
                   out=RoundDraws(*out[:5]))
    for u, gen in zip(out.batch_u, gens):
        u.uniform_(generator=gen)
    return out._replace(sel_noise=d.sel_noise)


class _AllClients:
    """Every client of the population on this process: the cohort step's
    reads and writes of per-client ``[L, N]`` state, as plain ops."""

    lo = 0

    def __init__(self, n: int):
        self.n_local = n

    def cols(self, x):
        return x

    def at(self, x, idx):
        return torch.gather(x, -1, idx)

    def rows(self, t, ids):
        return t.index_select(0, ids)

    def scatter(self, like, idx, vals):
        return torch.zeros_like(like).scatter_(-1, idx, vals)

    def topk(self, scores, avail, k_eff, k_max: int, chunks: int):
        return sel_lib.cohort_topk(scores, avail, k_eff, k_max,
                                   chunks=chunks)

    def mean(self, x):
        return torch.mean(x, dim=-1)


class ClientShard(_AllClients):
    """This rank's share of a population's clients on a ``client`` mesh
    axis (``cmesh``, 1-D): the contiguous columns ``[lo, lo + N/C)`` of
    every per-client ``[L, N]`` tensor (utility and fault state, draws)
    and the same rows of the membership table.  The cohort step reads the
    cohort's values from their owners (each rank gives its own, zero
    elsewhere, summed over the axis: one value a slot, so the sum is
    exact), writes results back on the owner only, takes the top-k in two
    stages (each rank's top-``k_max``, gathered rank-major and merged:
    :func:`~repro_torch.core.selection.cohort_topk`'s chunked form, bitwise
    its unchunked one) and gathers the rest of a reduction over ``N``
    (a failure fraction, a maximum) whole, so that every value is bitwise
    the unsharded engine's."""

    def __init__(self, cmesh, n: int):
        ranks = cmesh.size()
        if n % ranks:
            raise ValueError(f"{n} clients over {ranks} client ranks")
        self.cmesh, self.n = cmesh, n
        self.n_local = n // ranks
        self.lo = cmesh.get_local_rank() * self.n_local

    def _sum(self, x):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        return DTensor.from_local(x, self.cmesh, [Partial()],
                                  run_check=False).redistribute(
            self.cmesh, [Replicate()]).to_local()

    def _cat(self, x):
        """Every rank's ``x [..., m]`` side by side: ``[..., C·m]``."""
        from torch.distributed.tensor import DTensor, Shard
        return DTensor.from_local(x.contiguous(), self.cmesh,
                                  [Shard(x.dim() - 1)],
                                  run_check=False).full_tensor()

    def _own(self, idx):
        own = (idx >= self.lo) & (idx < self.lo + self.n_local)
        return own, torch.where(own, idx - self.lo, torch.zeros_like(idx))

    def cols(self, x):
        return x[..., self.lo:self.lo + self.n_local]

    def at(self, x, idx):
        own, local = self._own(idx)
        v = torch.gather(x, -1, local)
        return self._sum(torch.where(own, v, torch.zeros_like(v)))

    def rows(self, t, ids):
        own, local = self._own(ids)
        v = t.index_select(0, local)
        mask = own.reshape(own.shape + (1,) * (v.dim() - 1))
        return self._sum(torch.where(mask, v, torch.zeros_like(v)))

    def scatter(self, like, idx, vals):
        own, local = self._own(idx)
        out = like.new_zeros(like.shape[:-1] + (self.n_local + 1,))
        return out.scatter_(-1, torch.where(own, local, self.n_local),
                            vals)[..., :self.n_local]

    def topk(self, scores, avail, k_eff, k_max: int, chunks: int):
        with record_function("cohort_topk"):
            masked = torch.where(avail > 0, scores,
                                 torch.full_like(scores, sel_lib.F32_MIN))
            v, i = sel_lib._topk_stable(masked, min(k_max, self.n_local))
            vals, j = sel_lib._topk_stable(self._cat(v), k_max)
            idx = torch.gather(self._cat(i + self.lo), -1, j)
            return idx, sel_lib.cohort_take(vals, k_eff, k_max)

    def amax(self, x):
        return torch.amax(self._cat(x), dim=-1, keepdim=True)

    def mean(self, x):
        return torch.mean(self._cat(x), dim=-1)


def make_cohort_round(loss_fn: Callable, fl: FLConfig, n_clients: int,
                      ckpt_every_steps: int = 2, sel_chunks: int = 1,
                      device=None):
    """Build the population-scale round ``cohort_step(state, pop, params,
    draws=None, update_gate=None, *, clients=None, data_mean=None) ->
    (state, CohortMetrics)`` for ``L`` lanes on ``device`` (``cuda``
    unless ``"cpu"`` is asked).

    Algorithm 1 as :func:`make_lane_round` runs it, restructured so that a
    round's compute is O(k_max) and only vector work touches all ``N``
    clients:

    1. availability, utility scores and the failure processes as ``[L, N]``
       vector ops;
    2. :func:`~repro_torch.core.selection.cohort_topk` picks each lane's
       ``ceil(k_eff)`` cohort on the device (``sel_chunks`` chunks,
       bitwise-neutral);
    3. :func:`~repro_torch.data.synthetic.sample_cohort_batches` gathers
       only the cohort's data;
    4. local training, DP (``dp_lib.privatize_rows`` on the ``[L·k_max, P]``
       rows: the K1a/K1b kernels, one σ a row) and aggregation run over
       the ``k_max`` cohort slots;
    5. the per-client carries (utility EMAs, ``fail_ema``, the fault
       state) update at the cohort's columns by ``scatter_`` (the cohort's
       ids are distinct, so it is deterministic).

    ``pop``: a :class:`~repro_torch.data.synthetic.Population` on the
    device.  ``fl.k_max`` must be a positive static (it sizes the cohort).
    The step issues no host synchronisation.

    ``clients`` (a :class:`ClientShard`): ``pop``'s per-client arrays and
    the state's ``[L, N]`` carries hold this rank's clients only (the
    draws stay whole, each rank keeping its columns); ``data_mean`` is
    then the lanes' mean ``data_size`` over every client (keepdim), which
    the utility score divides by."""
    device = resolve_device(device)
    score_fn = sel_lib.get_score_fn(fl.selection)
    if not fl.k_max or int(fl.k_max) <= 0:
        raise ValueError(
            "the client_cohort plan needs an explicit positive FLConfig."
            "k_max (it is the static cohort size gathered to the compute "
            "lanes); the dense default 0 -> n_clients would train the "
            "whole population")
    local_train = _local_train_fn(loss_fn)
    k_max = int(fl.k_max)
    local_steps, batch = int(fl.local_epochs), int(fl.local_batch)
    n = n_clients

    def cohort_step(state: RoundState, pop: Population, pr: FLParams,
                    draws: Optional[CohortDraws] = None,
                    update_gate: Optional[torch.Tensor] = None, *,
                    clients: Optional[ClientShard] = None, data_mean=None
                    ) -> Tuple[RoundState, CohortMetrics]:
        flat_params = flatten_rows(state.params)
        if flat_params.device != device:
            raise ValueError(f"state is on {flat_params.device}, the round "
                             f"step was built for {device}")
        lanes, n_params = flat_params.shape
        col = FLParams(*map(_column, pr))
        server = make_server_optimizer(fl.server_opt, col.server_lr)
        if draws is None:
            draws = draw_cohort_round(state.rng, n, k_max, local_steps, batch,
                                      n_params if fl.dp_enabled else 0,
                                      fl.selection)
        own = _AllClients(n) if clients is None else clients
        score_kw = ({} if clients is None or fl.selection != "adafl" else
                    {"part_max": own.amax(state.util.participation)})

        # ---- O(N) population vector phase ----
        with record_function("selection"):
            avail = (own.cols(draws.avail_u) < as_f32(
                col.avail_prob, draws.avail_u)).float()
            utility = sel_lib.compute_utility(state.util, fl,
                                              fault_w=col.fault_util_w,
                                              data_mean=data_mean)
            k_eff = (state.kctl.k if fl.adaptive_k
                     else torch.full((lanes,), float(fl.clients_per_round),
                                     device=device))
            k_eff = torch.clamp(k_eff, max=float(k_max))
            scores = score_fn(own.cols(draws.sel_noise), state.util, utility,
                              avail, col.explore_noise, **score_kw)
            idx, take = own.topk(scores, avail, k_eff, k_max, sel_chunks)
        fail_at_full, slow_full, new_fault = fault_proc.fault_step(
            state.fault, own.cols(draws.fault_u), own.cols(draws.fault_steps),
            col, own.n_local, local_steps)

        # ---- cohort gather + O(k_max) training phase ----
        fail_at, slow = own.at(fail_at_full, idx), own.at(slow_full, idx)
        eff_steps, failed = _effective_steps(
            fail_at, local_steps, ckpt_every_steps, fl.fault_tolerance)
        batches = sample_cohort_batches(pop, idx, local_steps, batch,
                                        u=draws.batch_u,
                                        batch_idx=draws.batch_idx,
                                        shift=draws.shift,
                                        member_rows=own.rows)
        data_size = own.at(state.util.data_size, idx)
        rel = _train_and_release(
            local_train, fl, pr, server, state, flat_params, batches,
            eff_steps, take, draws.dp_noise,
            lambda deltas, contrib: agg.aggregate_stacked(deltas, contrib,
                                                          data_size),
            update_gate)
        contrib = rel.contrib

        # ---- scatter back into the [L, N] carries ----
        def scatter(vals_c):
            return own.scatter(avail, idx, vals_c)

        failed_f = failed.float()
        util = sel_lib.update_utility_state(
            state.util, scatter(contrib),
            scatter(rel.pre_loss * contrib), scatter(rel.post_loss * contrib),
            fl,
            coherence=(None if rel.coherence is None
                       else scatter(rel.coherence)),
            attempted=scatter(take), failed=scatter(failed_f * take))
        kctl = sel_lib.update_k(state.kctl, rel.global_loss, fl,
                                tol=pr.k_tol, patience=pr.k_patience)

        like = tree_map(lambda a: a[0], state.params)
        new_state = RoundState(unflatten_rows(rel.flat, like),
                               rel.server_state, util, kctl,
                               state.round_idx + 1, state.rng, new_fault)
        metrics = CohortMetrics(
            cohort_idx=idx, take=take, failed=failed_f * take, slow=slow,
            pre_loss=rel.pre_loss, post_loss=rel.post_loss,
            global_loss=rel.global_loss, k_effective=k_eff,
            update_norms=rel.norms,
            fail_frac=own.mean((fail_at_full < local_steps).float()))
        return new_state, metrics

    return cohort_step


# ---------------------------------------------------------------------------
# client_serial plan (the LM path: one client slot at a time, param trees)
# ---------------------------------------------------------------------------


def _placed_like(g, p):
    """A DTensor grad laid out as its param (a partial sum reduced, a
    replicated one split: FSDP's reduce-scatter); a plain grad as it
    is."""
    if not hasattr(p, "placements") or tuple(g.placements) == tuple(
            p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def value_and_grad(loss_fn: Callable):
    """``jax.value_and_grad`` of ``loss_fn(params, batch)`` over a param
    tree, by autograd: ``(loss, grads)``, each grad in its leaf's dtype
    (zeros for a leaf the loss does not reach).  The params need not
    require grad; detached leaves that do are made here, so the caller's
    tensors are never marked."""
    def vag(params, batch):
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss = loss_fn(p, batch)
            leaves = tree_leaves(p)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        by_leaf = {id(t): _placed_like(g, t) for t, g in zip(leaves, grads)}
        return loss.detach(), tree_map(lambda t: by_leaf[id(t)], p)

    return vag


def _whole(x):
    """A batch DTensor gathered whole (the microbatches are runs of global
    rows, which a split over the data ranks does not align with; the
    model's first ``constrain`` splits each microbatch again); a plain
    tensor as it is."""
    if not hasattr(x, "device_mesh"):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def microbatched_value_and_grad(loss_fn: Callable, grad_accum: int):
    """Gradient accumulation: batch leaves ``[B, ...]`` are split into
    ``grad_accum`` microbatches run in order; losses and grads are summed
    in f32, scaled by ``1/grad_accum`` and the grads cast back to each
    param's dtype (the reference's ``lax.scan``)."""
    vag = value_and_grad(loss_fn)
    if grad_accum <= 1:
        return vag

    def accumulated(params, batch):
        mb = tree_map(lambda x: _whole(x).reshape(
            (grad_accum, x.shape[0] // grad_accum) + tuple(x.shape[1:])),
            batch)
        first = tree_leaves(params)[0]
        loss_acc = torch.zeros((), device=first.device)
        g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        for i in range(grad_accum):
            loss, g = vag(params, tree_map(lambda x: x[i], mb))
            tree_map(lambda a, x: a.add_(x.float()), g_acc, g)
            loss_acc = loss_acc + loss
        scale = 1.0 / grad_accum
        return loss_acc * scale, tree_map(
            lambda gg, p: (gg * scale).to(p.dtype), g_acc, params)

    return accumulated


def _local_train_tree_fn(loss_fn: Callable, grad_accum: int = 1):
    """One client's local SGD on a param tree (the reference's
    ``_local_train_fn``): every local step runs, and ``torch.where`` keeps
    the steps at or past ``effective_steps`` (checkpoint-recovery
    truncation) from landing, so params stay in their storage dtype.
    Returns ``(delta, loss at the first step, loss at the last)``: the f32
    update as one flat ``[P]`` buffer in leaf order, the row the DP kernel
    reads (:func:`unflatten_rows` gives its tree of views), written into
    ``out`` where given.  With a :class:`_ShardLayout` (DTensor params)
    the row is the rank's local one, in the layout's order."""
    vag = microbatched_value_and_grad(loss_fn, grad_accum)

    def local_train(global_params, step_batches, effective_steps, lr,
                    layout=None, out=None):
        opt = tree_sgd(lr)
        p = global_params
        losses = []
        for s in range(tree_leaves(step_batches)[0].shape[0]):
            loss, grads = vag(p, tree_map(lambda v: v[s], step_batches))
            new_p, _ = opt.update(grads, (), p)
            del grads
            live = s < effective_steps
            p = tree_map(lambda a, b: torch.where(live, b, a), p, new_p)
            del new_p
            losses.append(loss)
        if layout is not None:
            flat = layout.row() if out is None else out
            for d, a, b in zip(layout.views(flat), tree_leaves(p),
                               tree_leaves(global_params)):
                d.copy_(_placed_like(a, b).to_local()).sub_(b.to_local())
            return flat, _plain(losses[0]), _plain(losses[-1])
        leaves = tree_leaves(global_params)
        flat = out if out is not None else torch.empty(
            sum(t.numel() for t in leaves), device=leaves[0].device)
        # f32 copy, then the f32 subtraction: a.f32 − b.f32 with no f32
        # temporaries of the tree
        tree_map(lambda d, a, b: d.copy_(a).sub_(b),
                 unflatten_rows(flat, global_params), p, global_params)
        return flat, losses[0], losses[-1]

    return local_train


def _plain(x):
    """A replicated DTensor's value as a plain tensor (a plain one as it
    is)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


class _ShardLayout:
    """Where each param leaf's local shard lies in a rank's flat row, for
    the serial round on DTensor params.

    The row holds the leaves' local shards (f32, each flattened): first
    those this rank *owns* (it is the first replica of its shard: mesh
    coordinate 0 on every axis the leaf is replicated over), then the
    rest, each group in leaf order.  The owned prefix is what the DP
    norm reads, so the all-reduced Σx² counts every element of the
    global update once however many ranks replicate it."""

    def __init__(self, params):
        from repro_torch.models.shardctx import local_box
        self.leaves = tree_leaves(params)
        self.mesh = self.leaves[0].device_mesh
        coord = self.mesh.get_coordinate()
        boxes = [local_box(t.shape, self.mesh, t.placements)
                 for t in self.leaves]
        self.local_shapes = [tuple(b[0]) for b in boxes]
        self.box_offsets = [tuple(b[1]) for b in boxes]
        owned = [all(c == 0 for c, p in zip(coord, t.placements)
                     if not p.is_shard()) for t in self.leaves]
        order = ([i for i, o in enumerate(owned) if o]
                 + [i for i, o in enumerate(owned) if not o])
        self.row_offsets = [0] * len(self.leaves)
        off = 0
        for i in order:
            self.row_offsets[i] = off
            off += math.prod(self.local_shapes[i])
        self.n_local = off
        self.n_owned = sum(math.prod(self.local_shapes[i])
                           for i, o in enumerate(owned) if o)
        # each leaf's start in the global row (leaf order) and the mesh
        # coordinates that name its shard (those of the axes it is split
        # over): ranks with equal shard ids hold equal values
        self.global_offsets, g = [], 0
        for t in self.leaves:
            self.global_offsets.append(g)
            g += t.numel()
        self.shard_ids = [tuple(c for c, p in zip(coord, t.placements)
                                if p.is_shard()) for t in self.leaves]
        self.device = self.leaves[0].to_local().device

    def row(self) -> torch.Tensor:
        return torch.empty(self.n_local, device=self.device)

    def views(self, flat):
        """The leaves' local shards as views of ``flat``, in leaf order."""
        return [flat[o:o + math.prod(s)].view(s)
                for o, s in zip(self.row_offsets, self.local_shapes)]

    def local_noise(self, global_row, out):
        """``out`` ← each leaf's slice of the global noise row (leaf
        order, the unsharded round's layout), by global offset."""
        for v, t, g, box, s in zip(self.views(out), self.leaves,
                                   self.global_offsets, self.box_offsets,
                                   self.local_shapes):
            full = global_row[g:g + t.numel()].view(tuple(t.shape))
            v.copy_(full[tuple(slice(o, o + n) for o, n in zip(box, s))])
        return out

    def draw_noise(self, rng: torch.Generator, out, round_idx: int,
                   slot: int):
        """Standard normals for the local row.  On a one-rank mesh the
        unsharded round's draw (``out.normal_`` from ``rng``).  Across
        ranks each leaf's shard draws from a generator seeded, on the
        host, by ``rng``'s seed, the round, the slot, the leaf and the
        shard id: replicas of a shard draw the same noise, distinct shards
        independent noise."""
        if self.mesh.size() == 1:
            return out.normal_(generator=rng)
        return self.seeded_noise(rng, out, round_idx, slot)

    def seeded_noise(self, rng: torch.Generator, out, round_idx: int,
                     slot: int):
        """:meth:`draw_noise`'s draw across ranks: each leaf's shard from a
        generator seeded by ``rng``'s seed, the round, the slot (a serial
        slot, or a client of the parallel round), the leaf and the shard
        id."""
        base = (rng.initial_seed(), int(round_idx), slot)
        for i, (v, sid) in enumerate(zip(self.views(out), self.shard_ids)):
            g = torch.Generator(device=rng.device).manual_seed(
                hash(base + (i,) + sid) & (2 ** 62 - 1))
            if v.numel():
                v.view(-1).copy_(torch.randn(v.numel(), generator=g,
                                             device=rng.device))
        return out

    def global_sumsq(self, owned_sumsq: torch.Tensor) -> torch.Tensor:
        """Σ over the mesh of every rank's owned Σx²."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        nd = self.mesh.ndim
        return DTensor.from_local(owned_sumsq, self.mesh, [Partial()] * nd,
                                  run_check=False).redistribute(
            self.mesh, [Replicate()] * nd).to_local()

    def wrap(self, views, like):
        """Local shards (leaf order) as DTensors shaped as ``like``'s
        leaves, in ``like``'s tree."""
        from torch.distributed.tensor import DTensor
        by_id = {id(t): DTensor.from_local(v, self.mesh, t.placements,
                                           run_check=False, shape=t.shape,
                                           stride=t.stride())
                 for v, t in zip(views, self.leaves)}
        return tree_map(lambda t: by_id[id(t)], like)


def _sharded_clip_noise(layout: _ShardLayout, flat, noise, clip, sigma):
    """The DP clip+noise on a rank's local row: K1a on the owned prefix,
    the Σx² all-reduced over the mesh, K1b on the whole local row (in
    place) with the global scale.  Returns (row, global norm)."""
    from repro_torch.kernels import dp_clip_noise as dpk
    from repro_torch.kernels.ref import clip_scale
    owned = flat[:layout.n_owned].view(1, -1)
    ss = layout.global_sumsq(dpk.sumsq_rows(owned))
    norm = torch.sqrt(ss)
    dpk.scale_noise_rows(flat.view(1, -1), noise.view(1, -1),
                         clip_scale(norm, clip), sigma, flat.view(1, -1))
    return flat, norm[0]


def _sharded_norm(layout: _ShardLayout, flat):
    """The global L2 norm of a sharded update (no DP)."""
    owned = flat[:layout.n_owned]
    return torch.sqrt(layout.global_sumsq(torch.sum(owned * owned)
                                          .reshape(1)))[0]


class SerialDraws(NamedTuple):
    """One serial round's random variates (the reference's key splits, as
    values): ``avail_u [n]`` and ``sel_noise [n]`` as in
    :class:`RoundDraws`; ``fail_u [K]`` and ``fail_step [K]`` the slots'
    i.i.d. failure uniforms and steps (``fault/process.py``
    ``iid_fail_times``); ``dp_noise [K, P]`` standard normals in leaf
    order, or ``None``: the round then draws each slot's noise from the
    state's generator into one reusable ``[P]`` buffer as it privatises
    that slot (at an LM's width a ``[K, P]`` bundle would not fit)."""

    avail_u: torch.Tensor
    sel_noise: torch.Tensor
    fail_u: torch.Tensor
    fail_step: torch.Tensor
    dp_noise: Optional[torch.Tensor] = None

    def to(self, device) -> "SerialDraws":
        return SerialDraws(*(None if t is None else t.to(device)
                             for t in self))


def draw_serial_round(gen: torch.Generator, n: int, slots: int,
                      local_steps: int, selection: str) -> SerialDraws:
    """Draw a serial round's :class:`SerialDraws` (without ``dp_noise``)
    from ``gen`` on its device, in a fixed order: availability, selection
    variate, failure uniforms, failure steps.  The slots' DP noise follows
    in the round, slot by slot."""
    dev = gen.device
    avail_u = torch.empty(n, device=dev).uniform_(generator=gen)
    sel_u = torch.empty(n, device=dev).uniform_(generator=gen)
    fail_u = torch.empty(slots, device=dev).uniform_(generator=gen)
    fail_step = torch.empty(slots, dtype=torch.long, device=dev).random_(
        0, local_steps, generator=gen)
    return SerialDraws(avail_u, _selection_variate(sel_u, selection),
                       fail_u, fail_step)


def init_serial_state(params, fl: FLConfig, gen: torch.Generator,
                      n_clients=None, **util_kw) -> RoundState:
    """:func:`init_round_state` for the ``client_serial`` plan: the server
    optimizer's state is over the param tree (``params`` stay a tree in
    their storage dtype, never flattened)."""
    n = n_clients or fl.n_clients
    server = make_tree_server_optimizer(fl.server_opt, fl.server_lr)
    return RoundState(
        params=params,
        server_opt_state=server.init(params),
        util=sel_lib.init_utility_state(n, gen=gen, **util_kw),
        kctl=sel_lib.init_k_state(fl, device=gen.device),
        round_idx=0,
        rng=gen,
        fault=fault_proc.init_fault_state(n, device=gen.device),
    )


def make_serial_round(loss_fn: Callable, fl: FLConfig, n_clients: int,
                      ckpt_every_steps: int = 2,
                      dp_use_kernel: Optional[bool] = None,
                      grad_accum: int = 1, delta_dtype=None, device=None,
                      mesh=None):
    """Build ``round_step(state, batches, params=None, update_gate=None, *,
    draws=None) -> (state, metrics)``, the ``client_serial`` plan for one
    run on ``device`` (``cuda`` unless ``"cpu"`` is asked).

    ``state``: a :class:`RoundState` from :func:`init_serial_state` (params
    a tree in their storage dtype).  batches: a dict of ``[K, local_steps,
    ...]`` tensors (``{"tokens", "labels"}`` for an LM, ``{"x", "y"}`` for
    a detector), the data of the K = ``fl.serial_clients_in_step`` client
    slots that the host filled; slot i is the i-th client of the stable
    top-K of ``sel_mask + utility·1e-6`` (ties to the lower index, as
    ``lax.top_k``).  ``params``: runtime :class:`FLParams` (``None`` uses
    ``fl``'s).  ``update_gate``: a 0-d 0/1 tensor withholding the release,
    or ``None``.  ``draws``: a :class:`SerialDraws`, or ``None`` to draw
    from ``state.rng``.

    Failures are the historical i.i.d. draw per SLOT (``fault/process.py``
    ``iid_fail_times``); the fault state is carried unchanged.  Each slot
    is trained (``grad_accum`` microbatches), privatised and streamed into
    the accumulator (f32, or ``delta_dtype``).  Clipped DP runs on the
    slot's flat ``[P]`` update (``kernels/ops.py`` ``dp_clip_noise``: on
    the card K1a + K1b on a ``[1, P]`` row, on the CPU the plain version);
    the paper mode goes leaf by leaf (``privatize_update``).  The route
    follows the device: ``dp_use_kernel`` None or True takes it, and False,
    the reference's switch to its plain version, is refused for a round
    on the card, whose tensors always run the kernels.  Per-client metrics are
    scattered back from the slots; ``failed`` and ``update_norms`` are per
    slot ``[K]``.

    With a ``mesh`` (``launch/steps.py`` ``build_train_step``, inside its
    sharding context) the params, server state and batches are DTensors:
    each rank trains on its shards, writes its local update into its own
    row (:class:`_ShardLayout`), runs K1a on the row's owned prefix,
    all-reduces Σx² and runs K1b on its whole row with the global scale.
    Given ``draws.dp_noise`` [K, P] (the unsharded round's leaf order),
    each rank takes its elements by global offset, so the round equals
    the unsharded one; else each shard draws its own
    (:meth:`_ShardLayout.draw_noise`).  Clipped DP only: the paper mode's
    leaf-by-leaf norm raises under a mesh."""
    if dp_use_kernel is False and torch.device(
            "cuda" if device is None else device).type == "cuda":
        raise ValueError("dp_use_kernel=False asks for the plain DP version, "
                         "but a round on the card always runs the kernels")
    device = resolve_device(device)
    if mesh is not None and fl.dp_enabled and fl.dp_mode != "clipped":
        raise NotImplementedError(
            f"dp_mode {fl.dp_mode!r} on a mesh: the sharded serial round "
            "privatises the flat local row (dp_mode='clipped') only")
    strategy = sel_lib.get_strategy(fl.selection)
    local_train = _local_train_tree_fn(loss_fn, grad_accum)
    slots = int(fl.serial_clients_in_step)
    k_max = int(fl.k_max or n_clients)
    default_params = fl_params(fl)

    def round_step(state: RoundState, batches,
                   params: Optional[FLParams] = None,
                   update_gate: Optional[torch.Tensor] = None, *,
                   draws: Optional[SerialDraws] = None
                   ) -> Tuple[RoundState, RoundMetrics]:
        leaves = tree_leaves(state.params)
        layout = _ShardLayout(state.params) if mesh is not None else None
        if layout is None and leaves[0].device != device:
            raise ValueError(f"state is on {leaves[0].device}, the round "
                             f"step was built for {device}")
        n_params = (sum(t.numel() for t in leaves) if layout is None
                    else layout.n_local)
        pr = default_params if params is None else params
        server = make_tree_server_optimizer(fl.server_opt, pr.server_lr)
        sigma = _dp_sigma(fl, pr) if fl.dp_enabled else 0.0
        local_steps = tree_leaves(batches)[0].shape[1]
        if draws is None:
            draws = draw_serial_round(state.rng, n_clients, slots,
                                      local_steps, fl.selection)

        with record_function("selection"):
            avail = (draws.avail_u < as_f32(pr.avail_prob,
                                            draws.avail_u)).float()
            utility = sel_lib.compute_utility(state.util, fl,
                                              fault_w=pr.fault_util_w)
            k_eff = torch.clamp(
                state.kctl.k if fl.adaptive_k
                else torch.full((), float(fl.clients_per_round),
                                device=device), max=float(slots))
            sel_mask = strategy(draws.sel_noise, state.util, utility, avail,
                                k_eff, min(slots, k_max), pr.explore_noise)
            # slot i <- i-th selected client (the host fed matching data)
            sel_idx = torch.argsort(-(sel_mask + utility * 1e-6),
                                    stable=True)[:slots]
            slot_live = (torch.arange(slots, device=device) < k_eff).float()

        fail_at = fault_proc.iid_fail_times(
            draws.fail_u, draws.fail_step,
            as_f32(pr.failure_prob, draws.fail_u), local_steps)
        eff_steps, failed = _effective_steps(fail_at, local_steps,
                                             ckpt_every_steps,
                                             fl.fault_tolerance)

        acc = agg.stream_init(state.params, delta_dtype or torch.float32)
        pre_loss, post_loss, norms = (torch.zeros(slots, device=device)
                                      for _ in range(3))
        noise = noise_buf = None
        for slot in range(slots):
            with record_function("local_train"):
                flat, pre, post = local_train(
                    state.params, tree_map(lambda v: v[slot], batches),
                    eff_steps[slot], pr.local_lr, layout)
            with record_function("dp_privatize"):
                if fl.dp_enabled:
                    if noise_buf is None and (layout is not None
                                              or draws.dp_noise is None):
                        noise_buf = torch.empty(n_params, device=flat.device)
                    if layout is not None and draws.dp_noise is not None:
                        noise = layout.local_noise(draws.dp_noise[slot],
                                                   noise_buf)
                    elif layout is not None:
                        noise = layout.draw_noise(state.rng, noise_buf,
                                                  state.round_idx, slot)
                    elif draws.dp_noise is not None:
                        noise = draws.dp_noise[slot]
                    else:
                        noise = noise_buf.normal_(generator=state.rng)
                if layout is not None:
                    if fl.dp_enabled:
                        flat, norm = _sharded_clip_noise(
                            layout, flat, noise, pr.dp_clip, sigma)
                    else:
                        norm = _sharded_norm(layout, flat)
                    delta = layout.wrap(layout.views(flat), state.params)
                elif fl.dp_enabled and fl.dp_mode == "clipped":
                    # noised where it lies: no second [P] row
                    flat, norm = kops.dp_clip_noise(flat, noise, pr.dp_clip,
                                                    sigma, out=flat)
                    delta = unflatten_rows(flat, state.params)
                elif fl.dp_enabled:
                    delta, norm = dp_lib.privatize_update(
                        unflatten_rows(flat, state.params), noise,
                        mode=fl.dp_mode, clip=pr.dp_clip, sigma=sigma)
                else:
                    delta = unflatten_rows(flat, state.params)
                    norm = dp_lib.global_norm(delta)
            with record_function("aggregate"):
                m = slot_live[slot] * (eff_steps[slot] > 0)
                acc = agg.stream_accumulate(acc, delta, m, 1.0)
            del flat, delta
            pre_loss[slot], post_loss[slot], norms[slot] = pre, post, norm
        del noise, noise_buf

        with record_function("aggregate"):
            agg_delta = agg.stream_finalize(acc)
            del acc
            new_params, new_server_state = agg.apply_server_update_tree(
                server, state.params, state.server_opt_state, agg_delta)
            del agg_delta
            new_params, new_server_state = _gate_server_update(
                update_gate, new_params, new_server_state, state.params,
                state.server_opt_state)

        contrib = slot_live * (eff_steps > 0)
        denom = torch.clamp(torch.sum(contrib), min=1.0)
        global_loss = torch.sum(post_loss * contrib) / denom
        # scatter slot losses back to the selected clients' entries (the
        # slots' clients are distinct)
        zeros = torch.zeros(n_clients, device=device)
        full_mask = zeros.index_add(0, sel_idx, contrib)
        full_pre = zeros.index_add(0, sel_idx, pre_loss * contrib)
        full_post = zeros.index_add(0, sel_idx, post_loss * contrib)
        util = sel_lib.update_utility_state(state.util, full_mask, full_pre,
                                            full_post, fl)
        kctl = sel_lib.update_k(state.kctl, global_loss, fl,
                                tol=pr.k_tol, patience=pr.k_patience)

        new_state = RoundState(new_params, new_server_state, util, kctl,
                               state.round_idx + 1, state.rng, state.fault)
        metrics = RoundMetrics(full_mask, avail, failed.float(), full_pre,
                               full_post, global_loss, k_eff, norms,
                               torch.ones(n_clients, device=device))
        return new_state, metrics

    return round_step


# ---------------------------------------------------------------------------
# client_parallel plan on param trees (the LMs), unsharded or laid across the
# data ranks of a mesh
# ---------------------------------------------------------------------------


class ClientRows(NamedTuple):
    """The port's ``delta_constraint`` of the ``client_parallel`` round:
    where the clients' update rows live.  The reference pins the stacked
    deltas' client axis onto the data mesh axes so that no device holds
    every client's weights; here the clients of the round's batches are
    split over ``client_axes`` of ``mesh`` (a ``DeviceMesh``), and each
    data rank trains its own clients on the rest of the mesh (the model
    sub-mesh: tensor-parallel as the rule table places the params),
    privatises their rows on it and keeps them: only the weighted sum
    over the clients (one all-reduce over ``client_axes``) and per-client
    scalars cross data ranks."""

    mesh: Any
    client_axes: Tuple[str, ...]


def client_submeshes(mesh, client_axes: Sequence[str]):
    """(the client sub-mesh over ``client_axes``, the model sub-mesh over
    the other axes) of ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    model_axes = tuple(a for a in names if a not in client_axes)
    if not model_axes or set(client_axes) - set(names):
        raise ValueError(f"mesh axes {names}: the client axes "
                         f"{tuple(client_axes)} must be some, not all")

    def sub(axes):
        return mesh[axes[0]] if len(axes) == 1 else mesh[tuple(axes)]

    return sub(tuple(client_axes)), sub(model_axes)


class _LocalRows:
    """Every client's row on this process: the row is the update in leaf
    order (``flatten_rows``), and every reduction is local."""

    layout = None

    def __init__(self, params, n: int):
        leaves = tree_leaves(params)
        self.n_local, self.first = n, 0
        self.row_len = self.n_owned = sum(t.numel() for t in leaves)
        self.device = leaves[0].device
        self.train_params = params

    def client_batch(self, batches, j: int):
        return tree_map(lambda v: v[j], batches)

    def model_sum(self, x):
        return x

    def client_sum(self, x):
        return x

    def gather(self, x):
        return x

    def noise(self, dp_noise, rng, round_idx: int, like):
        """The rows' standard normals: ``dp_noise [n, P]`` as given, else
        drawn from ``rng`` into one buffer like the rows."""
        if dp_noise is not None:
            return dp_noise
        return torch.empty_like(like).normal_(generator=rng)

    def sumsq(self, rows):
        """Σx² of each row's owned prefix, summed over the model ranks:
        ``[rows]``."""
        return self.model_sum(torch.stack(
            [torch.sum(r * r) for r in rows[:, :self.n_owned]]))

    def privatize(self, rows, noise, mode: str, clip, sigma):
        return dp_lib.privatize_rows(rows, noise, mode=mode, clip=clip,
                                     sigma=sigma, out=rows)

    def tree(self, row, like):
        return unflatten_rows(row, like)


class _MeshRows(_LocalRows):
    """The rows of this data rank's clients (:class:`ClientRows`): each
    row holds the local shards of one client's update on the model
    sub-mesh, in :class:`_ShardLayout`'s order (owned shards first), so
    Σx² over the owned prefix, summed over the model sub-mesh, counts
    every element of the client's update once."""

    def __init__(self, rows: ClientRows, params, batches, n: int):
        from torch.distributed.tensor import DTensor

        from repro_torch.models.shardctx import local_box
        self.mesh = rows.mesh
        names = tuple(self.mesh.mesh_dim_names)
        self.cmesh, self.sub = client_submeshes(self.mesh, rows.client_axes)
        cdims = [names.index(a) for a in rows.client_axes]
        mdims = [i for i in range(len(names)) if i not in cdims]
        for t in tree_leaves(params):
            if any(not t.placements[i].is_replicate() for i in cdims):
                raise ValueError(
                    f"a param placed {t.placements} over the client axes "
                    f"{rows.client_axes}: the clients' weights diverge, so "
                    "the params replicate over them")

        def on_sub(t):
            return DTensor.from_local(t.to_local(), self.sub,
                                      [t.placements[i] for i in mdims],
                                      run_check=False, shape=t.shape,
                                      stride=t.stride())

        self.train_params = tree_map(on_sub, params)
        self.layout = _ShardLayout(self.train_params)
        self.leaves = tree_leaves(params)
        self.row_len, self.n_owned = self.layout.n_local, self.layout.n_owned
        self.device = self.layout.device
        first = tree_leaves(batches)[0]
        shape, offset = local_box(first.shape, self.mesh, first.placements)
        if shape[0] * self.cmesh.size() != n:
            raise ValueError(f"{n} clients over {self.cmesh.size()} data "
                             f"ranks: the batches hold {shape[0]} a rank")
        self.n_local, self.first = shape[0], offset[0]

    def client_batch(self, batches, j: int):
        from torch.distributed.tensor import DTensor, Replicate
        rep = [Replicate()] * self.sub.ndim
        return tree_map(lambda v: DTensor.from_local(
            v.to_local()[j], self.sub, rep, run_check=False), batches)

    def model_sum(self, x):
        return self.layout.global_sumsq(x)

    def client_sum(self, x):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        nd = self.cmesh.ndim
        return DTensor.from_local(x, self.cmesh, [Partial()] * nd,
                                  run_check=False).redistribute(
            self.cmesh, [Replicate()] * nd).to_local()

    def gather(self, x):
        from torch.distributed.tensor import DTensor, Shard
        return DTensor.from_local(x, self.cmesh, [Shard(0)] * self.cmesh.ndim,
                                  run_check=False).full_tensor()

    def noise(self, dp_noise, rng, round_idx: int, like):
        """Given ``dp_noise [n, P]`` (the unsharded round's leaf order),
        each row takes its client's elements by global offset, so the
        round equals the unsharded one.  Else a one-rank mesh draws the
        whole buffer at once, as the unsharded round does, and across
        ranks each (client, leaf, shard) draws from its own seeded
        generator."""
        out = torch.empty_like(like)
        if dp_noise is None and self.mesh.size() == 1:
            return out.normal_(generator=rng)
        for j in range(self.n_local):
            if dp_noise is not None:
                self.layout.local_noise(dp_noise[self.first + j], out[j])
            else:
                self.layout.seeded_noise(rng, out[j], round_idx,
                                         self.first + j)
        return out

    def privatize(self, rows, noise, mode: str, clip, sigma):
        """K1a on the rows' owned prefix, Σx² summed over the model
        sub-mesh, K1b on the whole rows in place with the global scale
        (clipped); or the summed norms and σ·n added (paper)."""
        from repro_torch.kernels import dp_clip_noise as dpk
        from repro_torch.kernels.ref import clip_scale
        if mode == "paper":
            norms = torch.sqrt(self.sumsq(rows))
            return rows.add_(sigma * noise), norms
        if mode != "clipped":
            raise ValueError(mode)
        owned = rows[:, :self.n_owned]
        norms = torch.sqrt(self.model_sum(dpk.sumsq_rows(
            owned if owned.is_contiguous() else owned.contiguous())))
        dpk.scale_noise_rows(rows, noise, clip_scale(norms, clip), sigma,
                             rows)
        return rows, norms

    def tree(self, row, like):
        """The local row as DTensors placed as ``like``'s leaves on the
        whole mesh (after the all-reduce over the client axes every data
        rank holds the same values)."""
        from torch.distributed.tensor import DTensor
        by_id = {id(t): DTensor.from_local(v, self.mesh, t.placements,
                                           run_check=False, shape=t.shape,
                                           stride=t.stride())
                 for v, t in zip(self.layout.views(row), self.leaves)}
        return tree_map(lambda t: by_id[id(t)], like)


def _tree_agg_weights(fl: FLConfig, codes, pr: FLParams, contrib, slow,
                      util, n_edges: int):
    """The tree round's aggregate as weights: ``Σ_i a_i·Δ_i / d`` with
    ``a [n]`` and a 0-d ``d``.  Code 0: a = contrib·size, d = Σa (clamped
    at 1e-9), the weighted FedAvg; code 1 the same on the async mask; code
    2 (hierarchical) a_i = w_i·live_e / edge_w_e for client i of edge e =
    i % E and d = the live edges, the cloud's mean of the edges' means."""
    code = as_f32(pr.plan_code, contrib)
    agg_mask = contrib
    if 1.0 in codes:
        agg_mask = _async_mask(contrib, slow, util.compute, pr, code)
    a = (agg_mask * util.data_size).float()
    d = torch.clamp(torch.sum(a), min=1e-9)
    if 2.0 in codes:
        with record_function("hier_aggregate"):
            edge_w, edge_live, d_h = (t[0] for t in _edge_weights(a[None],
                                                                  n_edges))
            per_client = torch.arange(a.shape[0], device=a.device) % n_edges
            a_h = a * (edge_live / torch.clamp(edge_w, min=1e-9))[per_client]
        a = torch.where(code == 2.0, a_h, a)
        d = torch.where(code == 2.0, d_h, d)
    return a, d


def _draw_tree_round(gen: torch.Generator, n: int, local_steps: int,
                     selection: str) -> RoundDraws:
    """One run's :class:`RoundDraws` without the DP noise (``None``): the
    round draws the noise from ``gen`` when it privatises, once its rows
    exist (an ``[n, P]`` bundle drawn first would double an LM round's
    peak)."""
    d = draw_round([gen], n, local_steps, 0, selection)
    return RoundDraws(*(t[0] for t in d[:4]), dp_noise=None)


def _make_tree_round(loss_fn: Callable, fl: FLConfig, n_clients: int,
                     ckpt_every_steps: int = 2, device=None,
                     plan_codes: Optional[Sequence[float]] = None,
                     grad_accum: int = 1,
                     rows: Optional[ClientRows] = None):
    """The ``client_parallel`` round on a param tree (the reference's
    ``make_parallel_round`` for an LM): ``tree_step(state, batches,
    params=None, draws=None, update_gate=None) -> (state, metrics)``.

    Selection, the failure processes and the bookkeeping are the lane
    step's (:func:`_select_and_fail`, :func:`_close_round`), for one run,
    and the plan's weights its aggregate's.  The ``n`` clients train one
    after another (the serial round's :func:`_local_train_tree_fn`:
    autograd, ``grad_accum`` microbatches, remat inside ``loss_fn``;
    checkpointed autograd does not go through ``torch.func.vmap``), each
    writing its f32 update into one row of ``[n, P]``; DP runs on the rows
    at once (clipped: K1a + K1b, one launch each a round, written in
    place); the aggregate ``Σ_i a_i·Δ_i / d`` (:func:`_tree_agg_weights`)
    is summed row by row into one f32 ``[P]`` row and the server steps the
    tree.  Coherence, when
    on, is cos(Δ_i, Δ_agg) of the noised rows.

    With ``rows`` (:class:`ClientRows`) the params are DTensors replicated
    over the client axes and ``batches`` DTensors split over them: each
    data rank trains its clients on the model sub-mesh, privatises its
    rows there (Σx² summed over the model sub-mesh), sums its weighted
    rows, and one all-reduce over the client axes gives every rank the
    aggregate; per-client losses and norms are all-gathered.  The caller
    runs the step inside ``shardctx.sharding_ctx`` on the model sub-mesh
    (``launch/steps.py``).  Every rank draws the same selection and
    failures from its own copy of the state's generator."""
    device = resolve_device(device)
    strategy = sel_lib.get_strategy(fl.selection)
    local_train = _local_train_tree_fn(loss_fn, grad_accum)
    k_max = int(fl.k_max or n_clients)
    n = n_clients
    n_edges = max(int(fl.hierarchy_edges), 1)
    codes = {0.0, 1.0, 2.0} if plan_codes is None else set(plan_codes)
    default_params = fl_params(fl)

    def tree_step(state: RoundState, batches,
                  params: Optional[FLParams] = None,
                  draws: Optional[RoundDraws] = None,
                  update_gate: Optional[torch.Tensor] = None
                  ) -> Tuple[RoundState, RoundMetrics]:
        pr = default_params if params is None else params
        place = (_LocalRows(state.params, n) if rows is None
                 else _MeshRows(rows, state.params, batches, n))
        if rows is None and place.device != device:
            raise ValueError(f"state is on {place.device}, the round step "
                             f"was built for {device}")
        server = make_tree_server_optimizer(fl.server_opt, pr.server_lr)
        local_steps = tree_leaves(batches)[0].shape[1]
        if draws is None:
            draws = _draw_tree_round(state.rng, n, local_steps, fl.selection)

        picked = _select_and_fail(strategy, fl, state, draws, pr, (), k_max,
                                  n, local_steps, ckpt_every_steps, device)
        eff_steps = picked.eff_steps

        # ---- local training, one client after another (line 5) ----
        deltas = torch.empty(place.n_local, place.row_len,
                             device=place.device)
        pre, post = [], []
        for j in range(place.n_local):
            with record_function("local_train"):
                _, p0, p1 = local_train(
                    place.train_params, place.client_batch(batches, j),
                    eff_steps[place.first + j], pr.local_lr, place.layout,
                    out=deltas[j])
            pre.append(p0)
            post.append(p1)
        pre_loss = place.gather(torch.stack(pre).float())
        post_loss = place.gather(torch.stack(post).float())

        # ---- DP: noise on updates, not on scores (lines 8-9) ----
        with record_function("dp_privatize"):
            if fl.dp_enabled:
                noise = place.noise(draws.dp_noise, state.rng,
                                    state.round_idx, deltas)
                deltas, norms = place.privatize(deltas, noise, fl.dp_mode,
                                                pr.dp_clip,
                                                _dp_sigma(fl, pr))
                del noise
            else:
                norms = torch.sqrt(place.sumsq(deltas))
            norms = place.gather(norms)

        contrib = picked.sel_mask * (eff_steps > 0)

        # ---- aggregation + server update (line 18) ----
        with record_function("aggregate"):
            a, d = _tree_agg_weights(fl, codes, pr, contrib, picked.slow,
                                     state.util, n_edges)
            acc = torch.zeros(place.row_len, device=place.device)
            for j in range(place.n_local):
                acc.addcmul_(deltas[j], a[place.first + j])
            agg_row = place.client_sum(acc).div_(d)
            del acc
            new_params, new_server_state = agg.apply_server_update_tree(
                server, state.params, state.server_opt_state,
                place.tree(agg_row, state.params))
            new_params, new_server_state = _gate_server_update(
                update_gate, new_params, new_server_state, state.params,
                state.server_opt_state)

        # ---- update-coherence (data-quality observable): cos(Δ_i, Δ_agg) ----
        coherence = None
        if fl.coherence_scoring:
            own_agg = agg_row[:place.n_owned]
            agg_norm = torch.sqrt(torch.clamp(place.model_sum(
                torch.sum(own_agg * own_agg).reshape(1)), min=1e-18))
            num = place.model_sum(torch.stack(
                [torch.sum(r * own_agg) for r in deltas[:, :place.n_owned]]))
            nrm = torch.sqrt(torch.clamp(place.sumsq(deltas), min=1e-18))
            coherence = place.gather(num / (nrm * agg_norm)) * contrib
        del deltas, agg_row

        # ---- bookkeeping ----
        sel_denom = torch.clamp(torch.sum(contrib), min=1.0)
        global_loss = torch.sum(post_loss * contrib) / sel_denom
        return _close_round(fl, pr, state, picked, new_params,
                            new_server_state, pre_loss, post_loss,
                            global_loss, norms, contrib, coherence)

    return tree_step
