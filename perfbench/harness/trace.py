"""Reducing a ``torch.profiler`` run of the window to what the per-layer
readers take.

From the profiler's events: the device operations (kernels, copies,
sets) with their start and end on the device's timeline; the program's
``record_function`` annotations as they appear there (the device
interval from their first operation to their last); the host events.
Busy time is the union of the device operations' intervals, not the sum
of their durations.  Device time "under" an annotation is the busy time
that falls inside its intervals.  ``KINDS`` sorts operations by name for
the breakdown; idle gaps are labelled by the innermost host event that
was open at the middle of the gap.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

# kernel kinds, the first pattern that matches a name wins; the f32
# products are cuBLAS's single-precision GEMMs (TF32 off): the plain
# attention's score and value products and the f32 logits
KINDS = (("K1", r"sumsq_rows|scale_noise_rows"),
         ("K3", r"flash_attention_mma_kernel"),
         ("f32 GEMMs", r"f32f32|sgemm"),
         ("GEMMs", r"gemm|xmma|cutlass|nvjet|cublas"),
         ("softmax", r"[Ss]oft[Mm]ax"),
         ("noise draw", r"normal|philox|distribution"),
         ("copies and casts", r"copy|Memcpy|Memset"),
         ("other", r""))

SHORT_GAP_S = 10e-6

Interval = Tuple[float, float]


class Trace(NamedTuple):
    ops: List[Tuple[float, float, str]]          # device ops, seconds
    annotations: Dict[str, List[Interval]]       # name -> device intervals
    host: List[Tuple[float, float, str, int]]    # host events
    window: Interval                             # the window on this clock


def _kind_of(name: str) -> str:
    return next(k for k, pat in KINDS if re.search(pat, name))


def from_profiler(prof, window_name: str, span_names: Sequence[str]) -> Trace:
    """The window's events from a finished ``torch.profiler.profile``.
    ``window_name`` is the host ``record_function`` around the window."""
    from torch.autograd import DeviceType
    ops, ann, host = [], {}, []
    window = None
    for e in prof.profiler.kineto_results.events():
        t0, t1 = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name in span_names:
                ann.setdefault(name, []).append((t0, t1))
            else:
                ops.append((t0, t1, name))
        elif e.device_type() == DeviceType.CPU:
            if name == window_name:
                window = (t0, t1)
            host.append((t0, t1, name, e.start_thread_id()))
    if window is None:
        raise RuntimeError(f"no host event {window_name!r} in the trace")
    ops.sort()
    return Trace(ops, {k: merge(v) for k, v in ann.items()}, host, window)


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(tr: Trace) -> List[Interval]:
    """The union of the device operations' intervals, inside the window."""
    w0, w1 = tr.window
    return merge([(max(a, w0), min(b, w1)) for a, b, _ in tr.ops
                  if b > w0 and a < w1])


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy(tr))


def overlap_s(xs: Sequence[Interval], ys: Sequence[Interval]) -> float:
    """Length of the intersection of two merged, sorted interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def busy_under(tr: Trace, annotation: str) -> Optional[float]:
    """Device busy seconds inside ``annotation``'s intervals; None where
    the trace has no such annotation."""
    if annotation not in tr.annotations:
        return None
    return overlap_s(busy(tr), tr.annotations[annotation])


def op_seconds(tr: Trace, pattern: str) -> Tuple[int, float]:
    """(count, summed device seconds) of the operations whose name
    matches ``pattern``."""
    hits = [b - a for a, b, n in tr.ops if re.search(pattern, n)]
    return len(hits), sum(hits)


def by_kind(tr: Trace) -> List[Tuple[str, float]]:
    out = {k: 0.0 for k, _ in KINDS}
    for a, b, n in tr.ops:
        out[_kind_of(n)] += b - a
    return sorted(((k, v) for k, v in out.items() if v > 0),
                  key=lambda kv: -kv[1])


def idle_gaps(tr: Trace, top: int = 10) -> List[Tuple[str, float]]:
    """Idle device seconds inside the window, summed by the innermost
    host event open at each gap's middle (gaps under ``SHORT_GAP_S`` are
    summed as one entry), largest first."""
    w0, w1 = tr.window
    gaps, prev = [], w0
    for a, b in busy(tr):
        if a > prev:
            gaps.append((prev, min(a, w1)))
        prev = max(prev, b)
        if prev >= w1:
            break
    if prev < w1:
        gaps.append((prev, w1))
    totals: Dict[str, float] = {}
    label_at = _labeller(tr.host)
    for a, b in gaps:
        if b - a < SHORT_GAP_S:
            key = "short gaps (<10 us)"
        else:
            key = label_at((a + b) / 2) or "no host event"
        totals[key] = totals.get(key, 0.0) + (b - a)
    return sorted(totals.items(), key=lambda kv: -kv[1])[:top]


def breakdown(tr: Trace) -> dict:
    """The result line's ``breakdown``: device seconds by kind and idle
    seconds by host event, at most 10 entries each."""
    return {"device_ops": [list(x) for x in by_kind(tr)][:10],
            "idle_gaps": [list(x) for x in idle_gaps(tr)]}


def _labeller(host):
    """``label(t)`` for increasing ``t``: the name of the latest-starting
    host event open at ``t`` (per thread a stack of nested events)."""
    events = sorted(host)
    starts = [e[0] for e in events]
    stacks: Dict[int, list] = {}
    pos = [0]

    def label(t: float) -> Optional[str]:
        while pos[0] < len(events) and starts[pos[0]] <= t:
            e = events[pos[0]]
            st = stacks.setdefault(e[3], [])
            while st and st[-1][1] < e[0]:
                st.pop()
            st.append(e)
            pos[0] += 1
        best = None
        for st in stacks.values():
            while st and st[-1][1] < t:
                st.pop()
            if st and (best is None or st[-1][0] > best[0]):
                best = st[-1]
        return None if best is None else best[2]

    return label
