"""Observability: the port's copy of ``repro/obs``.

All three pieces are HOST-side: nothing here synchronises with the card or
reads a device tensor, so every lane computes the same bits with telemetry
on or off (``tests/test_torch_fl_ops.py`` checks it, and ``chip_smoke.py``
on the card under sync debug mode "error"):

* ``obs/trace.py`` — nested host spans (wall + process time), runner- and
  scorer-cache miss events, JSONL emission (``REPRO_TRACE=<path>``) and
  ``torch.profiler`` glue (``profile_trace``; spans double as
  ``record_function`` markers while any profiler runs).
* ``obs/stats.py`` — the :class:`StatsRegistry`: ``fl_driver.RUNNER_STATS``
  and ``serve.engine.SERVE_STATS`` are registry views, their dict-style
  call sites unchanged.
* ``obs/store.py`` — the indexed single-file SQLite experiment store, in
  the reference's schema.
"""
from repro_torch.obs.stats import STATS, Counters, StatsRegistry
from repro_torch.obs.trace import (TRACER, Tracer, event, profile_trace,
                                   span, spans)
from repro_torch.obs.store import (ExperimentStore, default_store,
                                   default_store_path)

__all__ = [
    "STATS", "Counters", "StatsRegistry",
    "TRACER", "Tracer", "event", "profile_trace", "span", "spans",
    "ExperimentStore", "default_store", "default_store_path",
]
