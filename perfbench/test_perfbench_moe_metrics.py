"""The expert layer's readers (``metrics/moe_ms.train.py``,
``moe_route_ms.train.py``, ``experts_ms.train.py`` and
``experts_roofline.train.py``) on traces built by hand, and their
entries in ``BENCHMARK.json``: the MoE cell's alone."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import counts
from perfbench.harness import cells
from perfbench.test_perfbench_phases import _trace

CELL = "phi3.5-moe-l4e8.silo"
MS = {"moe_ms.train": "block.moe", "moe_route_ms.train": "moe.route",
      "experts_ms.train": "moe.experts"}


def _ctx(phase: str, rounds: int = 3):
    cell = cells.find(CELL)
    return SimpleNamespace(trace=_trace(phase), counters={"rounds": rounds},
                           model=cell.config["model"], traffic=cell.traffic)


@pytest.mark.parametrize("metric,phase", sorted(MS.items()))
def test_ms_a_round(metric, phase):
    """6 busy seconds under the phase and its ``.bwd`` (the hand-built
    trace's), over 3 rounds; None where the program left no such
    annotation (a parent without the phases) or ran no round."""
    read = cells.reader(metric)
    assert read(_ctx(phase)) == pytest.approx(6.0 / 3 * 1e3)
    assert read(_ctx("block.mlp")) is None
    assert read(_ctx(phase, rounds=0)) is None


def test_experts_roofline_counts_the_held_share_of_the_routed_work():
    """3 rounds × 2 slots × 4 steps × [4, 1,024] tokens, each to 2 of 16
    experts, 8 held: one expert a token on average, 3 · 4,096 · 6,400
    weights, 6 FLOPs a weight, 4 layers; over 6 busy seconds at 989
    TFLOP/s.  None without the phase."""
    read = cells.reader("experts_roofline.train")
    tokens = 3 * 2 * 4 * 4 * 1024
    flops = 6 * tokens * 1 * 3 * 4096 * 6400 * 4
    want = 100.0 * flops / 6.0 / counts.PEAK_BF16_FLOPS
    assert read(_ctx("moe.experts")) == pytest.approx(want)
    assert read(_ctx("block.moe")) is None
    assert read(_ctx("moe.experts", rounds=0)) is None


def test_entries_are_the_moe_cells():
    bench = cells.benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in list(MS) + ["experts_roofline.train"]:
        m = per_layer[name]
        assert m["workloads"] == [CELL]
        assert (m["layer"], m["moves"], m["source"]) == (
            "expert layer", "train_tokens_per_s", "device_trace")
        assert (m["unit"], m["better"]) == (
            ("%", "higher") if "roofline" in name else ("ms", "lower"))
    assert "block.moe" not in {m["name"] for m in bench["per_layer"]}
    assert CELL not in per_layer["mlp_ms.train"]["workloads"]
