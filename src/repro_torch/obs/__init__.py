"""Observability: the port's copy of ``repro/obs``, plus device phases.

Nothing here synchronises with the card or reads a device tensor, so
every lane computes the same bits with telemetry on or off
(``tests/test_torch_fl_ops.py`` and ``tests/test_torch_obs_phases.py``
check it, and ``chip_smoke.py`` on the card under sync debug mode
"error"):

* ``obs/trace.py`` — nested host spans (process time, and entry and exit
  in Unix nanoseconds, the profiler's clock), runner- and scorer-cache
  miss events, JSONL emission (``REPRO_TRACE=<path>``) and
  ``torch.profiler`` glue (``profile_trace``; spans double as
  ``record_function`` markers while any profiler runs); the device
  phases ``phase`` (the round step's) and ``phase_call`` (a model
  sublayer's, forward and ``.bwd``), entered only while a profiler
  records.
* ``obs/stats.py`` — the :class:`StatsRegistry`: ``fl_driver.RUNNER_STATS``
  and ``serve.engine.SERVE_STATS`` are registry views, their dict-style
  call sites unchanged.
* ``obs/store.py`` — the indexed single-file SQLite experiment store, in
  the reference's schema.
"""
from repro_torch.obs.stats import STATS, Counters, StatsRegistry
from repro_torch.obs.trace import (TRACER, Tracer, event, phase, phase_call,
                                   profile_trace, span, spans)
from repro_torch.obs.store import (ExperimentStore, default_store,
                                   default_store_path)

__all__ = [
    "STATS", "Counters", "StatsRegistry",
    "TRACER", "Tracer", "event", "phase", "phase_call", "profile_trace",
    "span", "spans",
    "ExperimentStore", "default_store", "default_store_path",
]
