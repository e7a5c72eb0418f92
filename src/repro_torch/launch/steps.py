"""Execution-profile policy: the single-device half of the reference's
``repro/launch/steps.py``.

Execution profiles (the reference's policy):
    param_count < 10B  → client_parallel (clients on the data axes)
    otherwise          → client_serial  (whole mesh per client, FSDP)
grad_accum is chosen so the per-chip activation microbatch is ~1-2
sequences for the ≥10B models.

:func:`choose_plan`, :func:`choose_grad_accum` and :func:`make_fl_config`
are here.  The reference's sharded half — ``StepBundle``,
``build_train_step`` with its param and batch shardings,
``_scan_correction`` (XLA's scan-trip correction of cost analysis) and the
prefill and decode bundles — waits for the sharding slice.
"""
from __future__ import annotations

from repro_torch.configs.base import FLConfig, ModelConfig

PARALLEL_PLAN_MAX_PARAMS = 10e9


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
