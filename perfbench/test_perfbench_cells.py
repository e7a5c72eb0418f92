"""The harness finds every cell's configuration, traffic, limits and
per-layer readers by name, and ``BENCHMARK.json`` keeps to the shape the
harness and its readers assume."""
from __future__ import annotations

import re

import pytest

from perfbench.harness import cells
from perfbench.reference import layout
from perfbench.test_perfbench_reference import TRAIN_NUMBERS

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = cells.find(name)
    assert cell.traffic["kind"] in ("fl_rounds", "prefill_closed")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)
    for name_, fn in cells.readers(cell).items():
        assert callable(fn), name_
    numbers = set(cell.limits["numbers"])
    moe = cell.config["model"]["family"] == "moe"
    want = (set(TRAIN_NUMBERS) | ({"route_gap"} if moe else set())
            if cell.traffic["kind"] == "fl_rounds" else {"logit_gap"})
    assert numbers == want
    for v in cell.limits["numbers"].values():
        assert v["limit"] > 0


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    data = cells.load_json(cells.ROOT / conf["file"])
    assert data["source"] == conf["source"]
    assert set(data["reduced"]) == set(conf["reduced"])
    assert not set(data["departures"]["keys"]) & set(conf["reduced"])
    m = data["model"]
    lv = layout.leaves(m)
    pad = layout.padded_vocab(m["vocab_size"]) - m["vocab_size"]
    tables = 1 if m["tie_embeddings"] else 2
    assert layout.n_elements(lv) - pad * m["d_model"] * tables == data["parameters"]


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert all(set(m.get("workloads", CELLS)) <= set(CELLS)
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_every_cell_reports_a_metric_besides_setup():
    for name in CELLS:
        cell = cells.find(name)
        assert len(cell.end_to_end) >= 3  # setup_s, peak_mem_gb and one more
