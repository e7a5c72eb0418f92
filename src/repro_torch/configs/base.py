"""Federated-learning configuration: the port's copy of the FL half of
``repro/configs/base.py`` (``FLConfig``, ``FLParams``, ``RUNTIME_FIELDS``,
``fl_params``, ``fl_static``).  The language-model ``ModelConfig`` and the
mesh configs are not ported yet.

Field names, defaults and the static/runtime split are the reference's, so
one config reads the same in both packages.  STATIC fields shape the code
path (plan, strategy, booleans); RUNTIME fields are the scalar knobs the
round step reads from an :class:`FLParams` argument.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple


@dataclass(frozen=True)
class FLConfig:
    """Hyper-parameters of Algorithm 1 and its substrate."""

    # detector architecture (STATIC): a name in models/spec.py's registry
    model: str = "mlp"
    n_clients: int = 40
    clients_per_round: int = 8          # K (initial value when adaptive)
    adaptive_k: bool = True
    k_min: int = 2
    k_max: int = 0                      # 0 -> n_clients
    rounds: int = 200
    local_epochs: int = 5
    local_batch: int = 64
    local_lr: float = 0.05
    selection: str = "adaptive_utility"  # see core/selection.py registry
    # utility score weights
    alpha: float = 1.0                  # accuracy weight in F(S_t)
    gamma: float = 0.1                  # cost weight in F(S_t)
    utility_ema: float = 0.5
    explore_noise: float = 0.05         # selection temperature (Gumbel scale)
    avail_prob: float = 0.95            # per-client per-round availability
    k_tol: float = 1e-3                 # adaptive-K plateau tolerance
    k_patience: float = 3.0             # adaptive-K plateau patience (rounds)
    coherence_scoring: bool = True      # cos(Δ_i, Δ_agg) data-quality signal
    # --- differential privacy ---
    dp_enabled: bool = True
    dp_epsilon: float = 8.0
    dp_delta: float = 1e-5
    dp_clip: float = 1.0
    dp_mode: str = "clipped"            # "paper" (fixed sigma, no clip) | "clipped"
    dp_sigma: float = 0.01              # used in "paper" mode
    # scheduled budget accounting: a feature of the reference's compiled
    # engine, not ported yet (run_fl_legacy rejects it, as the
    # reference's run_fl_legacy does)
    dp_scheduled: bool = False
    dp_budget: float = 50.0
    dp_sched: float = 0.0
    dp_sched_rate: float = 0.3
    dp_stall_tol: float = 1e-3
    # --- fault tolerance ---
    fault_tolerance: bool = True        # STATIC checkpoint-recovery gate
    failure_prob: float = 0.05          # marginal per-client per-round rate
    fault_process: float = 0.0          # 0 iid | 1 markov | 2 weibull | 3 straggler
    fault_burst: float = 3.0            # markov: expected outage length (rounds)
    straggler_slow: float = 4.0         # straggler: round-time stretch factor
    fault_util_w: float = 0.0           # utility penalty on the failure EMA
    weibull_scale: float = 600.0        # lambda (seconds; cost model)
    weibull_shape: float = 1.2          # k (cost model AND lifetime process)
    recovery_time: float = 30.0         # t_r (seconds)
    checkpoint_every: int = 0           # rounds; 0 -> derive from Weibull model
    # --- server ---
    server_opt: str = "sgd"             # sgd | fedavgm | fedadam
    server_lr: float = 1.0
    # --- execution plan (core/plans.py registry) ---
    plan: str = "client_parallel"
    serial_clients_in_step: int = 4
    local_steps_in_step: int = 1
    async_buffer: float = 0.0
    async_staleness_pow: float = 0.5
    hier_comm_frac: float = 0.3
    hierarchy_edges: int = 4

    def __post_init__(self):
        from repro_torch.core.plans import validate_plan
        validate_plan(self)


class FLParams(NamedTuple):
    """The RUNTIME half of :class:`FLConfig`: plain floats the round step
    reads instead of closing over them."""

    local_lr: float = 0.05
    server_lr: float = 1.0
    dp_epsilon: float = 8.0
    dp_sigma: float = 0.01
    dp_clip: float = 1.0
    dp_budget: float = 50.0
    dp_sched: float = 0.0
    dp_sched_rate: float = 0.3
    dp_stall_tol: float = 1e-3
    failure_prob: float = 0.05
    fault_process: float = 0.0
    fault_burst: float = 3.0
    straggler_slow: float = 4.0
    fault_util_w: float = 0.0
    weibull_shape: float = 1.2
    recovery_time: float = 30.0
    avail_prob: float = 0.95
    explore_noise: float = 0.05
    k_tol: float = 1e-3
    k_patience: float = 3.0
    async_buffer: float = 0.0
    async_staleness_pow: float = 0.5
    hier_comm_frac: float = 0.3
    # derived from the plan name (core/plans.py), not an FLConfig field
    plan_code: float = 0.0


RUNTIME_FIELDS = tuple(f for f in FLParams._fields if f != "plan_code")


def fl_params(fl: FLConfig) -> FLParams:
    """The runtime knobs of ``fl``; ``plan_code`` comes from the plan name."""
    from repro_torch.core.plans import plan_code
    return FLParams(plan_code=plan_code(fl.plan),
                    **{f: getattr(fl, f) for f in RUNTIME_FIELDS})


def fl_static(fl: FLConfig) -> FLConfig:
    """The STATIC part of ``fl``: runtime fields reset to their defaults and
    the plan name canonicalised to its program family."""
    from repro_torch.core.plans import plan_family
    defaults = {f: FLConfig.__dataclass_fields__[f].default
                for f in RUNTIME_FIELDS}
    return dataclasses.replace(fl, plan=plan_family(fl.plan), **defaults)
