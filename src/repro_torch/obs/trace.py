"""Host-side tracer and device-phase markers: nested spans, compile
events, JSONL, profiler glue — the port's copy of
``repro/obs/trace.py``, plus the device phases the port's benchmark reads.

* **Bitwise neutrality** — spans time HOST phases (upload, dispatch,
  readback, runner builds).  A span never synchronises with the card or
  reads a device tensor, so it may sit around the engines' round loop,
  which runs under ``torch.cuda.set_sync_debug_mode("error")`` on a card,
  and the traced run computes the same bits as the untraced one.
* **Device phases** — :func:`phase` and :func:`phase_call` name the
  round step's phases (``core/rounds.py``) and the model's sublayers
  (``models/transformer.py``, ``models/attention.py``,
  ``models/moe.py``) for a
  ``torch.profiler`` trace, forward and backward.  They never write host
  spans: the host wall time of work launched asynchronously on the card
  means nothing.
* **Zero cost when off** — the tracer is disabled by default;
  :func:`span` and :func:`phase` return a shared no-op context manager
  and :func:`phase_call` is a plain call unless a ``torch.profiler``
  trace is recording (or, for :func:`span`, the tracer is enabled).
* **One clock** — spans and events carry ``t0_ns`` (and a span
  ``t1_ns``) in Unix nanoseconds, ``time.time_ns()``, the clock the
  profiler's events are on, so a JSONL span lies over a
  :func:`profile_trace` Chrome trace of the same run; ``t0`` is the same
  instant in seconds and ``wall_s`` is ``(t1_ns - t0_ns) / 1e9``.
* **Structured emission** — spans and events append to an in-memory
  buffer and, when enabled with a path (or ``REPRO_TRACE=<path>`` in the
  environment), stream to JSONL one object per line: ``{"type": "span" |
  "event", "name", "t0", "t0_ns", "t1_ns" (spans), "wall_s", "cpu_s",
  "depth", "parent", ...attrs}``, the reference's schema with the two
  integer stamps added.
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
    t0_ns: int                     # time.time_ns() at entry (Unix ns)
    t1_ns: int = 0                 # time.time_ns() at exit (0 while open)
    cpu_s: float = 0.0             # process_time delta
    depth: int = 0
    index: int = 0                 # position in the tracer's span list
    parent: int = -1               # index of the enclosing span (-1 = root)
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def t0(self) -> float:
        """Entry in epoch seconds."""
        return self.t0_ns * 1e-9

    @property
    def wall_s(self) -> float:
        return max(self.t1_ns - self.t0_ns, 0) * 1e-9

    def to_json(self) -> Dict[str, Any]:
        return {"type": "span", "name": self.name, "t0": self.t0,
                "t0_ns": self.t0_ns, "t1_ns": self.t1_ns,
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


def phase(name: str):
    """``record_function(name)`` while a ``torch.profiler`` trace is
    recording, else the shared no-op: a device phase (the round step's,
    a model sublayer's) named on the profiler's timeline.  Never a host
    span."""
    if not _torch_profiling():
        return _NULL
    return record_function(name)


class _BackwardRange:
    """``<name>.bwd`` on the thread that runs the backward pass: opened
    by a hook on the phase's output when its gradient is ready (just
    before the node that made the output runs backward; of several
    outputs, the first), closed by the first hook on an input whose
    gradient is ready, and not opened again.  The sublayer's
    nodes were all made after its inputs', so autograd, which runs the
    ready node made last first, runs every one of them in between."""

    __slots__ = ("name", "rf", "closed")

    def __init__(self, name: str):
        self.name, self.rf, self.closed = name, None, False

    def open(self, grad):
        if self.rf is None and not self.closed:
            self.rf = record_function(self.name)
            self.rf.__enter__()

    def close(self, grad):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf, self.closed = None, True


def _tensors(out) -> list:
    """The tensors of a sublayer's output: one, or nested tuples and lists
    of them."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return [out] if isinstance(out, torch.Tensor) else []


def phase_call(name: str, fn, *inputs):
    """``fn(*inputs)``, the sublayer ``name``, with its forward under
    :func:`phase` and, while a trace records and grad is on, its backward
    under ``<name>.bwd``, opened by the first of its output tensors'
    hooks (a sublayer may return several, nested in tuples and lists) and
    closed, once, by the first of its inputs'.  The backward range hangs on tensor hooks, not
    on identity ``autograd.Function`` markers: a marker node between an
    input and the sublayer would sum the sublayer's gradients of that
    input before they meet the skip path's, an f32 re-association
    wherever the sublayer reads the input more than once (RMSNorm in f32
    does, three times), so the grads would no longer be bitwise the
    untraced ones.  A hook adds no node and reads no value.  The range
    is opened only where an input requires grad, so an input's hook is
    there to close it.  Under ``remat="full"`` (or ``"dots"``) the
    recomputed forward nests inside ``.bwd``.  With no profiler this is
    a plain call."""
    if not _torch_profiling():
        return fn(*inputs)
    with record_function(name):
        out = fn(*inputs)
    outs = [t for t in _tensors(out) if t.requires_grad]
    if torch.is_grad_enabled() and outs:
        ins = [t for t in inputs if getattr(t, "requires_grad", False)]
        if ins:
            rng = _BackwardRange(name + ".bwd")
            for t in outs:
                t.register_hook(rng.open)
            for t in ins:
                t.register_hook(rng.close)
    return out


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
        with phase(name):           # host phase marker on the timeline
            if not self.enabled:    # profiling only: annotate, don't record
                yield None
                return
            with self._lock:
                sp = Span(name=name, t0_ns=time.time_ns(),
                          depth=len(self._stack), index=len(self.spans),
                          parent=self._stack[-1].index if self._stack
                          else -1, attrs=dict(attrs))
                self.spans.append(sp)
                self._stack.append(sp)
            c0 = time.process_time()
            try:
                yield sp
            finally:
                sp.t1_ns = time.time_ns()
                sp.cpu_s = time.process_time() - c0
                with self._lock:
                    if self._stack and self._stack[-1] is sp:
                        self._stack.pop()
                    if self._jsonl is not None:
                        self._jsonl.write(json.dumps(sp.to_json()) + "\n")
                        self._jsonl.flush()

    def event(self, name: str, **attrs) -> None:
        """Record a point event (e.g. a runner-cache miss).  No-op while
        disabled."""
        if not self.enabled:
            return
        with self._lock:
            t_ns = time.time_ns()
            ev = {"type": "event", "name": name, "t0": t_ns * 1e-9,
                  "t0_ns": t_ns,
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
