"""The FL round engine — Algorithm 1 as one PyTorch round step: the port's
copy of ``repro/core/rounds.py``'s ``client_parallel`` plan at plan code 0.

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
masked weighted mean per lane.  :func:`make_parallel_round` is the one-run
view of the same step (``L = 1``).  An optional ``update_gate`` (``[L]``
0/1) withholds a lane's release (budget exhaustion under scheduled
privacy, :func:`_gate_server_update`).  The other plan codes
(buffered_async, hierarchical) and the ``client_serial`` plan raise: they
are not ported yet.

Fault tolerance: failure times come from ``fault/process.py``; a client
that fails at step f keeps ``c·⌊f/c⌋`` steps of work with checkpoints every
``c`` steps, or nothing without fault tolerance.

Random draws: torch cannot reproduce JAX's threefry stream.  A round's
variates form a :class:`RoundDraws` bundle, drawn from each lane's
``torch.Generator`` on the device (:func:`draw_round`), or built by a
caller (the parity tests rebuild the reference's own draws from its
keys).  This is the port's counterpart of the key argument.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import FLConfig, FLParams, as_f32, fl_params
from repro_torch.core import aggregation as agg
from repro_torch.core import dp as dp_lib
from repro_torch.core import selection as sel_lib
from repro_torch.core.plans import get_plan
from repro_torch.device import resolve_device
from repro_torch.fault import process as fault_proc
from repro_torch.optim.optimizers import AdamState, make_server_optimizer
from repro_torch.tree import flatten_rows, tree_map, unflatten_rows


class RoundState(NamedTuple):
    """Carried across communication rounds: one run's, or ``L`` lanes' with
    a leading lane axis on every tensor and one generator a lane."""

    params: Dict[str, Any]       # nested dict of tensors (the global model)
    server_opt_state: Any        # over the flat [P] (or [L, P]) global model
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
        return RoundDraws(*(t.to(device) for t in self))

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
    if sel_lib.NOISE_KIND[selection] == "gumbel":
        tiny = torch.finfo(torch.float32).tiny
        u = torch.clamp(out.sel_noise, min=tiny)
        return out._replace(sel_noise=-torch.log(-torch.log(u)))
    return out


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
    """``fn`` over the tensors of server optimizer states of one structure
    (a lane's Adam step count is its own, as each lane's is in the
    reference's vmap: a gated lane does not step)."""
    first = opt_states[0]
    if isinstance(first, torch.Tensor):
        return fn(*opt_states)
    if isinstance(first, AdamState):
        return AdamState(*(fn(*ts) for ts in zip(*opt_states)))
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


def _gate_server_update(update_gate, new_flat, new_server_state,
                        flat_params, server_state):
    """Budget-exhaustion masking: a lane whose ``update_gate`` is ≤ 0 keeps
    its global params AND server-optimizer state bitwise (the old values
    are selected, not a zero update added), as a deployment that halts at
    exhaustion.  ``update_gate`` is an ``[L]`` 0/1 device tensor, so a lane
    can flip without a host read; ``None`` leaves the step ungated."""
    if update_gate is None:
        return new_flat, new_server_state
    live = update_gate > 0

    def keep(new, old):
        return torch.where(live.reshape(live.shape + (1,) * (new.dim() - 1)),
                           new, old)

    return (keep(new_flat, flat_params),
            _opt_map(keep, new_server_state, server_state))


def _column(v):
    """A per-lane ``[L]`` knob as an ``[L, 1]`` column beside ``[L, n]``
    client state; a float as it is."""
    return v[:, None] if isinstance(v, torch.Tensor) else v


def _rows(v, n: int):
    """A per-lane ``[L]`` knob as one value per client row ``[L·n]``."""
    return v.repeat_interleave(n) if isinstance(v, torch.Tensor) else v


def make_lane_round(loss_fn: Callable, fl: FLConfig, n_clients: int,
                    ckpt_every_steps: int = 2, device=None):
    """Build ``lane_step(state, batches, params, draws=None,
    update_gate=None) -> (state, metrics)``, Algorithm 1 for ``L`` lanes at
    once on ``device`` (``cuda`` unless ``"cpu"`` is asked).

    ``state``: the lanes' :class:`RoundState` (:func:`stack_states`).
    batches: ``{"x": [L, n, local_steps, b, d] f32, "y": [L, n,
    local_steps, b] int}``.  ``params``: :class:`FLParams` whose fields are
    floats or ``[L]`` f32 tensors on the device; the caller has checked
    that every lane's ``plan_code`` is 0.  ``draws``: the lanes'
    :class:`RoundDraws`, or ``None`` to draw from ``state.rng``.
    ``update_gate``: ``[L]`` 0/1, or ``None`` (:func:`_gate_server_update`).
    Metrics are ``[L, n]`` per client and ``[L]`` per lane.  The step
    issues no host synchronisation."""
    device = resolve_device(device)
    plan = get_plan(fl.plan)
    if plan.family != "client_parallel" or plan.code != 0.0:
        raise NotImplementedError(
            f"the PyTorch port builds only the synchronous client_parallel "
            f"plan (code 0); plan {fl.plan!r} is not ported yet")
    strategy = sel_lib.get_strategy(fl.selection)
    local_train = _local_train_fn(loss_fn)
    k_max = int(fl.k_max or n_clients)
    n = n_clients

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

        # ---- GetAvailableClients (Alg.1 line 3) ----
        avail = (draws.avail_u < as_f32(col.avail_prob,
                                        draws.avail_u)).float()

        # ---- ComputeUtility + SelectTopK (line 4) ----
        # record_function spans name the reference's jax.named_scope phases
        # in a torch.profiler trace; outside a trace they cost ~1 us each
        with record_function("selection"):
            utility = sel_lib.compute_utility(state.util, fl,
                                              fault_w=col.fault_util_w)
            k_eff = (state.kctl.k if fl.adaptive_k
                     else torch.full((lanes,), float(fl.clients_per_round),
                                     device=device))
            sel_mask = strategy(draws.sel_noise, state.util, utility, avail,
                                k_eff, k_max, col.explore_noise)

        # ---- failure injection + checkpoint-recovery truncation ----
        fail_at, slow, new_fault = fault_proc.fault_step(
            state.fault, draws.fault_u, draws.fault_steps, col, n,
            local_steps)
        eff_steps, failed = _effective_steps(
            fail_at, local_steps, ckpt_every_steps, fl.fault_tolerance)

        # ---- local training, in parallel over lanes × clients (line 5) ----
        with record_function("local_train"):
            deltas, pre_loss, post_loss = local_train(state.params, batches,
                                                      eff_steps, pr.local_lr)

        # ---- DP: noise on updates, not on scores (lines 8-9) ----
        # on the L·n flattened rows, outside any vmap: the CUDA kernels are
        # called through ctypes
        with record_function("dp_privatize"):
            if fl.dp_enabled:
                rows, norms = dp_lib.privatize_rows(
                    deltas.reshape(lanes * n, n_params),
                    draws.dp_noise.reshape(lanes * n, n_params),
                    mode=fl.dp_mode, clip=_rows(pr.dp_clip, n),
                    sigma=_rows(_dp_sigma(fl, pr), n))
                deltas = rows.reshape(lanes, n, n_params)
                norms = norms.reshape(lanes, n)
            else:
                norms = torch.sqrt(torch.sum(deltas * deltas, dim=-1))

        # drop clients whose surviving work is zero
        contrib_mask = sel_mask * (eff_steps > 0)

        # ---- aggregation + server update (line 18) ----
        with record_function("aggregate"):
            agg_delta = agg.aggregate_stacked(deltas, contrib_mask,
                                              state.util.data_size)
            new_flat, new_server_state = agg.apply_server_update(
                server, flat_params, state.server_opt_state, agg_delta)
            new_flat, new_server_state = _gate_server_update(
                update_gate, new_flat, new_server_state, flat_params,
                state.server_opt_state)

        # ---- update-coherence (data-quality observable): cos(Δ_i, Δ_agg) ----
        if fl.coherence_scoring:
            agg_norm = torch.sqrt(torch.clamp(
                torch.sum(agg_delta * agg_delta, dim=-1), min=1e-18))
            nrm = torch.sqrt(torch.clamp(torch.sum(deltas * deltas, dim=-1),
                                         min=1e-18))
            num = torch.sum(deltas * agg_delta[:, None], dim=-1)
            coherence = num / (nrm * agg_norm[:, None]) * contrib_mask
        else:
            coherence = None

        # ---- bookkeeping ----
        sel_denom = torch.clamp(torch.sum(contrib_mask, dim=-1), min=1.0)
        global_loss = torch.sum(post_loss * contrib_mask, dim=-1) / sel_denom
        failed_f = failed.float()
        util = sel_lib.update_utility_state(state.util, contrib_mask, pre_loss,
                                            post_loss, fl, coherence=coherence,
                                            attempted=sel_mask, failed=failed_f)
        kctl = sel_lib.update_k(state.kctl, global_loss, fl,
                                tol=pr.k_tol, patience=pr.k_patience)

        like = tree_map(lambda a: a[0], state.params)
        new_state = RoundState(unflatten_rows(new_flat, like),
                               new_server_state, util, kctl,
                               state.round_idx + 1, state.rng, new_fault)
        metrics = RoundMetrics(sel_mask, avail, failed_f, pre_loss, post_loss,
                               global_loss, k_eff, norms, slow)
        return new_state, metrics

    return lane_step


def make_parallel_round(loss_fn: Callable, fl: FLConfig, n_clients: int,
                        ckpt_every_steps: int = 2, device=None):
    """Build ``round_step(state, batches, params=None, draws=None,
    update_gate=None) -> (state, metrics)`` for one run on ``device``
    (``cuda`` unless ``"cpu"`` is asked): the lane step of
    :func:`make_lane_round` at ``L = 1``.

    batches: ``{"x": [n, local_steps, b, d] f32, "y": [n, local_steps, b]
    int}`` on the device.  ``params``: runtime :class:`FLParams` (``None``
    uses ``fl``'s).  ``draws``: a :class:`RoundDraws` on the device, or
    ``None`` to draw from ``state.rng``.  ``update_gate``: a 0-d 0/1
    tensor, or ``None``."""
    lane_step = make_lane_round(loss_fn, fl, n_clients, ckpt_every_steps,
                                device)
    default_params = fl_params(fl)

    def round_step(state: RoundState, batches,
                   params: Optional[FLParams] = None,
                   draws: Optional[RoundDraws] = None,
                   update_gate: Optional[torch.Tensor] = None
                   ) -> Tuple[RoundState, RoundMetrics]:
        pr = default_params if params is None else params
        if float(pr.plan_code) != 0.0:
            raise NotImplementedError(
                f"plan_code {pr.plan_code} is not ported yet")
        lanes, metrics = lane_step(
            stack_states([state]), {k: v[None] for k, v in batches.items()},
            pr,
            None if draws is None else RoundDraws(*(t[None] for t in draws)),
            None if update_gate is None else update_gate.reshape(1))
        return lane_state(lanes, 0), RoundMetrics(*(t[0] for t in metrics))

    return round_step
