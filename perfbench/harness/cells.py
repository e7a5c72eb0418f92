"""Finding a cell and what belongs to it, by the names in
``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each lives in a file of its own (``configs/<name>.json``,
``traffic/<name>.json``), as do the cell's limits on the numbers that
decide ``correct`` (``limits/<cell>.json``) and each per-layer metric's
reader (``metrics/<metric>.py``).  A later cell, mix or metric is added
as files and entries, without an edit here.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(BENCHMARK_JSON)


def config_file(bench: dict, name: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def find(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and the
    end-to-end and per-layer metrics it reports."""
    bench = benchmark() if bench is None else bench
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(config_file(bench, w["config"])),
                traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str) -> Callable:
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"]) for m in cell.per_layer}
