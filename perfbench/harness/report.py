"""What every run prints, and the checks made before it prints.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` a ``breakdown``, and last ``checks``: each number that decided
``correct`` beside its limit.  The same numbers and limits are the last
lines of standard error.  No result is printed, and the exit code is
not 0, where the process has loaded JAX, Flax or the JAX package.
"""
from __future__ import annotations

import json
import math
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Result(NamedTuple):
    attempted: int
    failed: int
    metrics: Dict[str, float]          # produced values by metric name
    device: dict
    checks: Dict[str, Tuple[float, float]]  # name -> (number, limit)
    breakdown: Optional[dict] = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def device_info(device: torch.device, count: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": peak}


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name, compared whole,
    is JAX's, Flax's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def correct(checks: Dict[str, Tuple[float, float]]) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def line(res: Result, wanted: List[dict], trace: bool) -> dict:
    """The result object; ``wanted`` are the cell's metric entries of
    ``BENCHMARK.json`` for this kind of run."""
    metrics = {}
    for m in wanted:
        v = res.metrics.get(m["name"])
        if v is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} not produced")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct(res.checks), "attempted": res.attempted,
           "failed": res.failed, "metrics": metrics, "device": res.device}
    if res.breakdown is not None:
        out["breakdown"] = res.breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in res.checks.items()}
    return out


def emit(res: Result, wanted: List[dict], trace: bool) -> int:
    """Print the result (exit code 0), or, where a forbidden module was
    loaded, name it on standard error and print nothing (exit code 3)."""
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    out = line(res, wanted, trace)
    for k, (v, lim) in res.checks.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
