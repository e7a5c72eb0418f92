"""Padded dynamic batching for the streaming scorer: the port's copy of
``repro/serve/batching.py`` (NumPy only).

A serving process sees windows arrive in arbitrary-sized chunks (per-frame
CAN captures, NetFlow export batches).  They are cut into a small set of
static **batch buckets**: every chunk is split into full max-bucket
batches plus one padded remainder batch, so steady-state traffic runs at
the largest bucket with no padding and each (model, bucket, route) scorer
is built once (``engine.SERVE_STATS`` counts it).

Padding is free on the score path: every detector computes row by row over
the batch axis, so padded rows never reach the valid rows' scores.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

# Two buckets cover the latency/throughput trade well: a small one so a
# trickle of windows is not padded 16x, a large one for steady-state rate.
DEFAULT_BUCKETS = (16, 128)


def normalize_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] <= 0:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    return out


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` windows (``n`` ≤ max bucket)."""
    bs = normalize_buckets(buckets)
    for b in bs:
        if b >= n:
            return b
    raise ValueError(f"{n} windows exceed the largest bucket {bs[-1]}; "
                     "split with plan_chunks first")


def plan_chunks(n: int, buckets: Sequence[int]) -> List[int]:
    """Greedy split of ``n`` windows into bucket-sized batches: full
    max-bucket batches while they fit, then one bucket covering the
    remainder.  ``sum(chunks) >= n`` and every chunk is a bucket."""
    bs = normalize_buckets(buckets)
    out: List[int] = []
    while n >= bs[-1]:
        out.append(bs[-1])
        n -= bs[-1]
    if n > 0:
        out.append(bucket_for(n, bs))
    return out


def pad_to(x: np.ndarray, bucket: int) -> Tuple[np.ndarray, int]:
    """Zero-pad ``x`` [n, d] up to [bucket, d]; returns (padded, n_valid)."""
    n = x.shape[0]
    if n > bucket:
        raise ValueError(f"{n} rows do not fit bucket {bucket}")
    if n == bucket:
        return x, n
    padded = np.zeros((bucket,) + x.shape[1:], x.dtype)
    padded[:n] = x
    return padded, n


class Bucketer:
    """Accumulate stream chunks, emit bucket-shaped batches.

    ``add`` emits zero-copy full max-bucket batches as soon as enough
    windows are queued; ``flush`` drains the remainder as padded batches.
    Emission order preserves arrival order, so concatenating the valid rows
    of every emitted batch reproduces the input stream exactly.
    """

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.buckets = normalize_buckets(buckets)
        self._pending: List[np.ndarray] = []
        self._n = 0

    @property
    def pending(self) -> int:
        return self._n

    def add(self, windows: np.ndarray) -> List[Tuple[np.ndarray, int]]:
        windows = np.asarray(windows)
        if windows.ndim == 1:
            windows = windows[None]
        self._pending.append(windows)
        self._n += windows.shape[0]
        out: List[Tuple[np.ndarray, int]] = []
        big = self.buckets[-1]
        if self._n >= big:
            buf = np.concatenate(self._pending, axis=0)
            while buf.shape[0] >= big:
                out.append((buf[:big], big))
                buf = buf[big:]
            self._pending = [buf] if buf.shape[0] else []
            self._n = buf.shape[0]
        return out

    def flush(self) -> List[Tuple[np.ndarray, int]]:
        if not self._n:
            return []
        buf = np.concatenate(self._pending, axis=0)
        self._pending, self._n = [], 0
        out = []
        for chunk in plan_chunks(buf.shape[0], self.buckets):
            take = min(chunk, buf.shape[0])
            out.append(pad_to(buf[:take], chunk))
            buf = buf[take:]
        return out


def batches_of(stream: Iterable[np.ndarray],
               buckets: Sequence[int] = DEFAULT_BUCKETS):
    """Generator: stream of [m, d] chunks → bucket-shaped (batch, n_valid)
    pairs, flushing the tail when the stream ends."""
    bk = Bucketer(buckets)
    for chunk in stream:
        yield from bk.add(chunk)
    yield from bk.flush()
