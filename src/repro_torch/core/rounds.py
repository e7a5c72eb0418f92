"""The FL round engine — Algorithm 1 as one PyTorch round step: the port's
copy of ``repro/core/rounds.py``'s ``client_parallel`` plan at plan code 0.

Clients live on the leading axis of every batch tensor.  Local training
runs for all clients at once (``torch.func.vmap`` of ``grad_and_value``
over the functional params, the counterpart of the reference's
``jax.vmap(local_train)``), the updates are flattened to ``[n, P]`` in leaf
order, privatised by the fused clip+noise kernel (``core/dp.py`` →
``kernels/ops.py``), and aggregated as a masked weighted mean.  The other
plan codes (buffered_async, hierarchical) raise: they are not ported yet.

Fault tolerance: failure times come from ``fault/process.py``; a client
that fails at step f keeps ``c·⌊f/c⌋`` steps of work with checkpoints every
``c`` steps, or nothing without fault tolerance.

Random draws: torch cannot reproduce JAX's threefry stream.  A round's
variates form a :class:`RoundDraws` bundle; ``round_step(state, batches,
draws=None)`` draws it from the state's ``torch.Generator`` on the device,
or takes one a caller built (the parity tests rebuild the reference's own
draws from its keys).  This is the port's counterpart of the key argument.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import FLConfig, FLParams, fl_params
from repro_torch.core import aggregation as agg
from repro_torch.core import dp as dp_lib
from repro_torch.core import selection as sel_lib
from repro_torch.core.plans import get_plan
from repro_torch.device import resolve_device
from repro_torch.fault import process as fault_proc
from repro_torch.optim.optimizers import make_server_optimizer
from repro_torch.tree import flatten_rows, tree_map, unflatten_rows


class RoundState(NamedTuple):
    """Carried across communication rounds."""

    params: Dict[str, Any]       # nested dict of tensors (the global model)
    server_opt_state: Any        # over the flat [P] global model
    util: sel_lib.UtilityState
    kctl: sel_lib.KControllerState
    round_idx: int
    rng: torch.Generator         # on the state's device
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
    """

    avail_u: torch.Tensor
    sel_noise: torch.Tensor
    fault_u: torch.Tensor
    fault_steps: torch.Tensor
    dp_noise: torch.Tensor

    def to(self, device) -> "RoundDraws":
        return RoundDraws(*(t.to(device) for t in self))


def draw_round(gen: torch.Generator, n: int, local_steps: int, n_params: int,
               selection: str) -> RoundDraws:
    """Draw one round's :class:`RoundDraws` from ``gen`` on its device."""
    dev = gen.device
    avail_u = torch.rand(n, generator=gen, device=dev)
    u = torch.rand(n, generator=gen, device=dev)
    if sel_lib.NOISE_KIND[selection] == "gumbel":
        tiny = torch.finfo(torch.float32).tiny
        sel_noise = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    else:
        sel_noise = u
    return RoundDraws(
        avail_u=avail_u,
        sel_noise=sel_noise,
        fault_u=torch.rand(4, n, generator=gen, device=dev),
        fault_steps=torch.randint(0, local_steps, (3, n), generator=gen,
                                  device=dev),
        dp_noise=torch.randn(n, n_params, generator=gen, device=dev),
    )


def init_round_state(params, fl: FLConfig, gen: torch.Generator,
                     n_clients=None, **util_kw) -> RoundState:
    """Fresh state on ``gen.device``; ``gen`` draws the utility state's
    compute/comm costs now and the round variates later."""
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


def _local_train_fn(loss_fn: Callable):
    """All clients' local SGD at once, with step masking
    (``effective_steps`` implements checkpoint-recovery truncation).
    Returns ``(delta [n, P], loss at the first step, loss at the last)``."""
    grad_and_loss = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def local_train(global_params, step_batches, effective_steps, lr):
        n, local_steps = step_batches["x"].shape[:2]
        p = tree_map(lambda a: a.expand(n, *a.shape), global_params)
        losses = []
        for s in range(local_steps):
            grads, loss = grad_and_loss(
                p, {k: v[:, s] for k, v in step_batches.items()})
            live = s < effective_steps

            def step(a, g):
                keep = live.reshape((-1,) + (1,) * (a.dim() - 1))
                return torch.where(keep, a - lr * g, a)

            p = tree_map(step, p, grads)
            losses.append(loss)
        delta = flatten_rows(p) - flatten_rows(global_params, 0)
        return delta, losses[0], losses[-1]

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


def _dp_sigma(fl: FLConfig, pr: FLParams) -> float:
    """Noise scale: ``dp_sigma`` in paper mode, the Gaussian mechanism's σ
    for ``dp_clip`` and ``dp_epsilon`` when clipped."""
    if fl.dp_mode == "paper" or fl.dp_scheduled:
        return pr.dp_sigma
    return dp_lib.gaussian_sigma_rt(pr.dp_epsilon, fl.dp_delta, pr.dp_clip)


def make_parallel_round(loss_fn: Callable, fl: FLConfig, n_clients: int,
                        ckpt_every_steps: int = 2, device=None):
    """Build ``round_step(state, batches, params=None, draws=None) ->
    (state, metrics)`` for ``device`` (``cuda`` unless ``"cpu"`` is asked).

    batches: ``{"x": [n, local_steps, b, d] f32, "y": [n, local_steps, b]
    int}`` on the device.  ``params``: runtime :class:`FLParams` (``None``
    uses ``fl``'s).  ``draws``: a :class:`RoundDraws` on the device, or
    ``None`` to draw from ``state.rng``."""
    device = resolve_device(device)
    plan = get_plan(fl.plan)
    if plan.family != "client_parallel" or plan.code != 0.0:
        raise NotImplementedError(
            f"the PyTorch port builds only the synchronous client_parallel "
            f"plan (code 0); plan {fl.plan!r} is not ported yet")
    strategy = sel_lib.get_strategy(fl.selection)
    local_train = _local_train_fn(loss_fn)
    k_max = int(fl.k_max or n_clients)
    default_params = fl_params(fl)

    def round_step(state: RoundState, batches,
                   params: Optional[FLParams] = None,
                   draws: Optional[RoundDraws] = None
                   ) -> Tuple[RoundState, RoundMetrics]:
        pr = default_params if params is None else params
        if float(pr.plan_code) != 0.0:
            raise NotImplementedError(
                f"plan_code {pr.plan_code} is not ported yet")
        flat_params = flatten_rows(state.params, 0)
        if flat_params.device != device:
            raise ValueError(f"state is on {flat_params.device}, the round "
                             f"step was built for {device}")
        server = make_server_optimizer(fl.server_opt, pr.server_lr)
        local_steps = batches["x"].shape[1]
        if draws is None:
            n_noise = flat_params.numel() if fl.dp_enabled else 0
            draws = draw_round(state.rng, n_clients, local_steps, n_noise,
                               fl.selection)

        # ---- GetAvailableClients (Alg.1 line 3) ----
        avail_p = torch.tensor(float(pr.avail_prob), device=device)
        avail = (draws.avail_u < avail_p).float()

        # ---- ComputeUtility + SelectTopK (line 4) ----
        # record_function spans name the reference's jax.named_scope phases
        # in a torch.profiler trace; outside a trace they cost ~1 us each
        with record_function("selection"):
            utility = sel_lib.compute_utility(state.util, fl,
                                              fault_w=pr.fault_util_w)
            k_eff = (state.kctl.k if fl.adaptive_k
                     else torch.tensor(float(fl.clients_per_round),
                                       device=device))
            sel_mask = strategy(draws.sel_noise, state.util, utility, avail,
                                k_eff, k_max, pr.explore_noise)

        # ---- failure injection + checkpoint-recovery truncation ----
        fail_at, slow, new_fault = fault_proc.fault_step(
            state.fault, draws.fault_u, draws.fault_steps, pr, n_clients,
            local_steps)
        eff_steps, failed = _effective_steps(
            fail_at, local_steps, ckpt_every_steps, fl.fault_tolerance)

        # ---- local training, in parallel over clients (line 5) ----
        with record_function("local_train"):
            deltas, pre_loss, post_loss = local_train(state.params, batches,
                                                      eff_steps, pr.local_lr)

        # ---- DP: noise on updates, not on scores (lines 8-9) ----
        with record_function("dp_privatize"):
            if fl.dp_enabled:
                deltas, norms = dp_lib.privatize_rows(
                    deltas, draws.dp_noise, mode=fl.dp_mode, clip=pr.dp_clip,
                    sigma=_dp_sigma(fl, pr))
            else:
                norms = torch.sqrt(torch.sum(deltas * deltas, dim=1))

        # drop clients whose surviving work is zero
        contrib_mask = sel_mask * (eff_steps > 0)

        # ---- aggregation + server update (line 18) ----
        with record_function("aggregate"):
            agg_delta = agg.aggregate_stacked(deltas, contrib_mask,
                                              state.util.data_size)
            new_flat, new_server_state = agg.apply_server_update(
                server, flat_params, state.server_opt_state, agg_delta)

        # ---- update-coherence (data-quality observable): cos(Δ_i, Δ_agg) ----
        if fl.coherence_scoring:
            agg_norm = torch.sqrt(torch.clamp(torch.sum(agg_delta * agg_delta),
                                              min=1e-18))
            nrm = torch.sqrt(torch.clamp(torch.sum(deltas * deltas, dim=1),
                                         min=1e-18))
            num = torch.sum(deltas * agg_delta, dim=1)
            coherence = num / (nrm * agg_norm) * contrib_mask
        else:
            coherence = None

        # ---- bookkeeping ----
        sel_denom = torch.clamp(torch.sum(contrib_mask), min=1.0)
        global_loss = torch.sum(post_loss * contrib_mask) / sel_denom
        failed_f = failed.float()
        util = sel_lib.update_utility_state(state.util, contrib_mask, pre_loss,
                                            post_loss, fl, coherence=coherence,
                                            attempted=sel_mask, failed=failed_f)
        kctl = sel_lib.update_k(state.kctl, global_loss, fl,
                                tol=pr.k_tol, patience=pr.k_patience)

        new_state = RoundState(unflatten_rows(new_flat, state.params),
                               new_server_state, util, kctl,
                               state.round_idx + 1, state.rng, new_fault)
        metrics = RoundMetrics(sel_mask, avail, failed_f, pre_loss, post_loss,
                               global_loss, k_eff, norms, slow)
        return new_state, metrics

    return round_step
