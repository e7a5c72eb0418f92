"""Host-side tracer: nested spans, compile events, JSONL, profiler glue —
the port's copy of ``repro/obs/trace.py``.

* **Bitwise neutrality** — spans time HOST phases (upload, dispatch,
  readback, runner builds) with wall and process clocks.  A span never
  synchronises with the card or reads a device tensor, so it may sit
  around the engines' round loop, which runs under
  ``torch.cuda.set_sync_debug_mode("error")`` on a card, and the traced
  run computes the same bits as the untraced one.  The device-side phase
  markers are the ``record_function`` calls placed at the round step's
  sites themselves (``core/rounds.py``).
* **Zero cost when off** — the tracer is disabled by default and
  :func:`span` returns a shared no-op context manager unless it is enabled
  or a ``torch.profiler`` trace is active.
* **Structured emission** — spans and events append to an in-memory
  buffer and, when enabled with a path (or ``REPRO_TRACE=<path>`` in the
  environment), stream to JSONL one object per line: ``{"type": "span" |
  "event", "name", "t0", "wall_s", "cpu_s", "depth", "parent",
  ...attrs}``, the reference's schema.
* **Profiler integration** — :func:`profile_trace` runs ``torch.profiler``
  over a block and writes a Chrome trace (the ``--profile`` flag of
  ``python -m repro_torch.serve``).  While any ``torch.profiler`` trace is
  active, whoever started it, every span ALSO enters
  ``torch.profiler.record_function`` under its name, so host phases line
  up with the device timeline.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@dataclass
class Span:
    """One closed host span (or an open one still on the stack)."""

    name: str
    t0: float                      # time.time() at entry (epoch seconds)
    wall_s: float = 0.0            # perf_counter delta
    cpu_s: float = 0.0             # process_time delta
    depth: int = 0
    index: int = 0                 # position in the tracer's span list
    parent: int = -1               # index of the enclosing span (-1 = root)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"type": "span", "name": self.name, "t0": self.t0,
                "wall_s": self.wall_s, "cpu_s": self.cpu_s,
                "depth": self.depth, "index": self.index,
                "parent": self.parent, **self.attrs}


class _NullCm:
    """Reusable no-op context manager — the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCm()


def _torch_profiling() -> bool:
    """Whether a ``torch.profiler`` trace is recording in this process."""
    return torch._C._autograd._profiler_enabled()


class Tracer:
    """The host tracer.  One global instance (:data:`TRACER`); tests may
    construct private ones.  A lock guards the buffers (the serving feed
    thread never opens spans)."""

    def __init__(self):
        self.enabled = False
        self.spans: List[Span] = []
        self.events: List[Dict[str, Any]] = []
        self._stack: List[Span] = []
        self._lock = threading.Lock()
        self._jsonl = None          # open file handle when streaming

    # -- lifecycle --------------------------------------------------------

    def enable(self, jsonl_path: Optional[str] = None) -> None:
        """Turn span/event recording on; ``jsonl_path`` streams every
        closed span and event to disk as it happens."""
        with self._lock:
            if jsonl_path:
                d = os.path.dirname(jsonl_path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._jsonl = open(jsonl_path, "a")
            self.enabled = True

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None

    def clear(self) -> None:
        with self._lock:
            self.spans = []
            self.events = []
            self._stack = []

    # -- recording --------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager timing a nested host phase.  No-op (shared null
        object, no allocation) while the tracer is disabled and no
        profiler trace is active."""
        if not (self.enabled or _torch_profiling()):
            return _NULL
        return self._span_cm(name, attrs)

    @contextmanager
    def _span_cm(self, name: str, attrs: Dict[str, Any]):
        ann = None
        if _torch_profiling():      # host phase marker on the timeline
            ann = record_function(name)
            ann.__enter__()
        if not self.enabled:        # profiling only: annotate, don't record
            try:
                yield None
            finally:
                ann.__exit__(None, None, None)
            return
        with self._lock:
            sp = Span(name=name, t0=time.time(), depth=len(self._stack),
                      index=len(self.spans),
                      parent=self._stack[-1].index if self._stack else -1,
                      attrs=dict(attrs))
            self.spans.append(sp)
            self._stack.append(sp)
        w0, c0 = time.perf_counter(), time.process_time()
        try:
            yield sp
        finally:
            sp.wall_s = time.perf_counter() - w0
            sp.cpu_s = time.process_time() - c0
            with self._lock:
                if self._stack and self._stack[-1] is sp:
                    self._stack.pop()
                if self._jsonl is not None:
                    self._jsonl.write(json.dumps(sp.to_json()) + "\n")
                    self._jsonl.flush()
            if ann is not None:
                ann.__exit__(None, None, None)

    def event(self, name: str, **attrs) -> None:
        """Record a point event (e.g. a runner-cache miss).  No-op while
        disabled."""
        if not self.enabled:
            return
        with self._lock:
            ev = {"type": "event", "name": name, "t0": time.time(),
                  "depth": len(self._stack),
                  "parent": self._stack[-1].index if self._stack else -1,
                  **attrs}
            self.events.append(ev)
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(ev) + "\n")
                self._jsonl.flush()

    # -- introspection ----------------------------------------------------

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def dump_jsonl(self, path: str) -> str:
        """Write the whole in-memory buffer to ``path`` (one JSON object
        per line, spans then events in record order)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for sp in self.spans:
                f.write(json.dumps(sp.to_json()) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return path


TRACER = Tracer()
if os.environ.get("REPRO_TRACE"):
    TRACER.enable(os.environ["REPRO_TRACE"])


def span(name: str, **attrs):
    """Module-level alias of :meth:`Tracer.span` on the global tracer —
    the instrumentation sites' one-liner."""
    return TRACER.span(name, **attrs)


def event(name: str, **attrs) -> None:
    TRACER.event(name, **attrs)


def spans(name: Optional[str] = None) -> List[Span]:
    return TRACER.find(name) if name else list(TRACER.spans)


@contextmanager
def profile_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (the host, and the card when
    there is one), written as a Chrome trace to ``logdir/trace.json`` when
    it exits.  While active, host spans double as ``record_function``
    phase markers beside the round step's own."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
