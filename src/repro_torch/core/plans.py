"""The execution-plan registry: the port's copy of ``repro/core/plans.py``.

A :class:`RoundPlan` names what the engine needs to know about a plan: its
STATIC program family, the runtime lane ``code`` within it, the round-step
builder, the time model, and config-build-time validation
(``FLConfig.__post_init__`` calls :func:`validate_plan`).  The registry is
the reference's, entry for entry, so a config is accepted or rejected alike
in both packages.  The port builds only ``client_parallel`` at code 0;
``core/rounds.py`` raises for the others.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class RoundPlan:
    name: str
    family: str              # STATIC program family (fl_static canonical form)
    code: float              # runtime lane value (FLParams.plan_code)
    builder: str             # round-step builder attribute in core/rounds.py
    time_model: str          # simulate_round_time semantics tag
    fault_arrivals: bool = False
    driver_capable: bool = True
    cohort_capable: bool = False
    description: str = ""
    requires: Optional[Callable] = field(default=None, compare=False,
                                         repr=False)


_REGISTRY: Dict[str, RoundPlan] = {}


def register_plan(plan: RoundPlan) -> RoundPlan:
    if plan.name in _REGISTRY:
        raise ValueError(f"plan {plan.name!r} is already registered")
    _REGISTRY[plan.name] = plan
    return plan


def plan_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_plan(name: str) -> RoundPlan:
    plan = _REGISTRY.get(name)
    if plan is None:
        raise ValueError(
            f"unknown FLConfig.plan {name!r}; registered plans: "
            f"{', '.join(sorted(_REGISTRY))}")
    return plan


def plan_family(name: str) -> str:
    return get_plan(name).family


def plan_code(name: str) -> float:
    return get_plan(name).code


def validate_plan(fl) -> None:
    """Reject unknown plan names and plan/feature combinations the registry
    marks incompatible, at config-build time."""
    plan = get_plan(fl.plan)
    if plan.requires is not None:
        msg = plan.requires(fl)
        if msg:
            raise ValueError(f"FLConfig.plan={fl.plan!r}: {msg}")
    if plan.name != "buffered_async" and float(fl.async_buffer) > 0:
        raise ValueError(
            f"FLConfig.plan={fl.plan!r} is not the buffered_async plan but "
            f"async_buffer={fl.async_buffer} is set — the buffer K only has "
            "meaning on the async plan (use plan='buffered_async', or leave "
            "async_buffer at 0)")


def _require_async_buffer(fl) -> Optional[str]:
    if float(fl.async_buffer) < 1:
        return (f"needs async_buffer >= 1 (the K of K-of-cohort "
                f"aggregation), got {fl.async_buffer}")
    return None


def _require_edges(fl) -> Optional[str]:
    if int(fl.hierarchy_edges) < 1:
        return (f"needs hierarchy_edges >= 1 (the static edge-aggregator "
                f"count), got {fl.hierarchy_edges}")
    return None


def _require_cohort_kmax(fl) -> Optional[str]:
    if not fl.k_max or int(fl.k_max) <= 0:
        return ("needs an explicit positive k_max (the static cohort size "
                "gathered to the compute lanes)")
    return None


register_plan(RoundPlan(
    name="client_parallel", family="client_parallel", code=0.0,
    builder="make_parallel_round", time_model="sync_slowest",
    driver_capable=True, cohort_capable=True,
    description="synchronous FedAvg over all clients at once; the paper's plan"))

register_plan(RoundPlan(
    name="client_serial", family="client_serial", code=0.0,
    builder="make_serial_round", time_model="sync_slowest",
    driver_capable=False, cohort_capable=False,
    description="one client at a time with the whole mesh"))

register_plan(RoundPlan(
    name="client_cohort", family="client_cohort", code=0.0,
    builder="make_cohort_round", time_model="sync_slowest",
    driver_capable=False, cohort_capable=True,
    requires=_require_cohort_kmax,
    description="population-scale plan: on-device cohort top-k"))

register_plan(RoundPlan(
    name="buffered_async", family="client_parallel", code=1.0,
    builder="make_parallel_round", time_model="async_kth_arrival",
    fault_arrivals=True, driver_capable=True, cohort_capable=False,
    requires=_require_async_buffer,
    description="FedBuff-style buffered async with staleness discount"))

register_plan(RoundPlan(
    name="hierarchical", family="client_parallel", code=2.0,
    builder="make_parallel_round", time_model="hier_two_tier",
    driver_capable=True, cohort_capable=False,
    requires=_require_edges,
    description="two-tier edge->cloud FedAvg"))
