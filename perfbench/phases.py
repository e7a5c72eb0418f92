"""Device time under the program's device phases (``repro_torch.obs``
``phase_call``): the forward annotation ``<name>`` and its backward
partner ``<name>.bwd``, which the thread that runs the backward pass opens
and closes.  A phase nested in another (``block.attend`` in
``block.attention``) is counted in both: an annotation's device interval
runs from its first operation to its last."""
from __future__ import annotations

from typing import Optional

from perfbench.harness import trace


def busy_s(tr: trace.Trace, name: str) -> Optional[float]:
    """Device busy seconds under the union of ``name``'s and
    ``name.bwd``'s intervals; None where the trace has no ``name``."""
    if name not in tr.annotations:
        return None
    spans = trace.merge(tr.annotations[name]
                        + tr.annotations.get(name + ".bwd", []))
    return trace.overlap_s(trace.busy(tr), spans)


def ms_a_round(ctx, name: str) -> Optional[float]:
    s, rounds = busy_s(ctx.trace, name), ctx.counters.get("rounds")
    return None if s is None or not rounds else s / rounds * 1e3


def ms_a_batch(ctx, name: str) -> Optional[float]:
    s, batches = busy_s(ctx.trace, name), ctx.counters.get("batches")
    return None if s is None or not batches else s / len(batches) * 1e3
