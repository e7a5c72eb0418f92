"""The phase readers (``perfbench/phases.py`` and the ``metrics/`` files
that call it) on traces built by hand: device busy ms under the union of
a phase's forward and ``.bwd`` intervals, a round or a batch, and None
where the program left no such annotation."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import phases
from perfbench.harness import cells, trace

TRAIN = {"attention_ms.train": "block.attention",
         "attend_ms.train": "block.attend",
         "mlp_ms.train": "block.mlp",
         "head_ms.train": "lm.head",
         "sgd_ms.train": "local.sgd",
         "update_row_ms.train": "local.update_row"}
SERVE = {"attention_ms.serve": "block.attention",
         "mlp_ms.serve": "block.mlp",
         "head_ms.serve": "lm.head"}


def _trace(name: str, bwd: bool = True) -> trace.Trace:
    """Forward [0, 4] and [10, 12], backward [5, 9]; operations over
    [1, 3], [2, 6] (overlapping), [8, 11] and [13, 14] (outside), in a
    window of [0, 20] seconds."""
    ops = [(1.0, 3.0, "a"), (2.0, 6.0, "b"), (8.0, 11.0, "c"),
           (13.0, 14.0, "d")]
    ann = {name: [(0.0, 4.0), (10.0, 12.0)], "other": [(0.0, 20.0)]}
    if bwd:
        ann[name + ".bwd"] = [(5.0, 9.0)]
    return trace.Trace(ops, {k: trace.merge(v) for k, v in ann.items()},
                       [], (0.0, 20.0))


def test_busy_s_is_the_union_of_forward_and_bwd():
    # busy [1, 6] ∪ [8, 11] ∪ [13, 14]; under [0, 4] ∪ [5, 9] ∪ [10, 12]:
    # [1, 4] + [5, 6] + [8, 9] + [10, 11] = 6 s
    assert phases.busy_s(_trace("p"), "p") == pytest.approx(6.0)
    # forward alone (a prefill: no grad, no .bwd): [1, 4] + [10, 11]
    assert phases.busy_s(_trace("p", bwd=False), "p") == pytest.approx(4.0)
    assert phases.busy_s(_trace("p"), "q") is None
    # the union counts the overlap of the two once
    tr = _trace("p")
    tr.annotations["p.bwd"] = trace.merge([(3.0, 9.0)])
    assert phases.busy_s(tr, "p") == pytest.approx(3.0 + 2.0 + 1.0 + 1.0)


@pytest.mark.parametrize("metric,phase", sorted(TRAIN.items()))
def test_train_readers_ms_a_round(metric, phase):
    read = cells.reader(metric)
    ctx = SimpleNamespace(trace=_trace(phase), counters={"rounds": 3})
    assert read(ctx) == pytest.approx(6.0 / 3 * 1e3)
    assert read(SimpleNamespace(trace=_trace("elsewhere"),
                                counters={"rounds": 3})) is None
    assert read(SimpleNamespace(trace=_trace(phase),
                                counters={"rounds": 0})) is None


@pytest.mark.parametrize("metric,phase", sorted(SERVE.items()))
def test_serve_readers_ms_a_batch(metric, phase):
    read = cells.reader(metric)
    batches = [(8, 512), (8, 1024), (8, 2048), (8, 4096)]
    ctx = SimpleNamespace(trace=_trace(phase, bwd=False),
                          counters={"batches": batches})
    assert read(ctx) == pytest.approx(4.0 / 4 * 1e3)
    assert read(SimpleNamespace(trace=_trace("elsewhere", bwd=False),
                                counters={"batches": batches})) is None


def test_each_phase_metric_is_in_the_benchmark_for_its_cell():
    bench = cells.benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for group, cell, moves in ((TRAIN, "granite-3-8b-l8.silo",
                                "train_tokens_per_s"),
                               (SERVE, "granite-3-8b-l8.prefill",
                                "ttft_ms_p95")):
        for name in group:
            m = per_layer[name]
            assert m["workloads"] == [cell] and m["moves"] == moves
            assert (m["unit"], m["better"], m["source"]) == (
                "ms", "lower", "device_trace")
