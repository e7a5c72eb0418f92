"""The port's FL operations layer on the CPU, against the JAX reference:

* the fault model's host half (``core/fault.py``): the Weibull failure
  probability, both checkpoint-cost forms, the t_c* search and the MLE fit
  bitwise the reference's over hypothesis draws on the ranges of
  ``tests/test_core_properties.py``; ``FailureModel`` in distribution
  (10^5 draws on the CPU generator); the ``fault`` namespace;
* ``Checkpointer``: directories written by either package restored by the
  other, rotation, the ``interval_rounds`` skip, an empty directory;
* ``export_personalized`` against the reference's on a small ``mlp``
  carried over by ``convert.py``; ``spent_epsilon``'s warning and value;
* ``obs``: the reference's ``tests/test_obs.py`` cases on the port's
  tracer and registry, the ``torch.profiler`` markers, ``REPRO_TRACE``,
  telemetry neutrality of ``run_fl_batch(device="cpu")``, and the SQLite
  store read across packages;
* the FL CLI (``launch/fl_train.py``) against the reference's at a small
  size: printed fields, JSON keys, ``eps_spent``.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.profiler import ProfilerActivity, profile

import repro.fault as j_fault_ns
from repro.checkpoint import checkpoint as j_ckpt
from repro.configs.base import FLConfig as JFLConfig
from repro.core import fault as j_fault
from repro.data import synthetic as j_syn
from repro.launch import fl_train as j_fl_train
from repro.models.spec import get_model_spec as j_get_spec
from repro.models.spec import meta_for as j_meta_for
from repro.obs.store import ExperimentStore as JExperimentStore
from repro.privacy.accountant import accounted_epsilon as j_accounted_epsilon
from repro.train import fl_driver as j_fl_driver

import repro_torch.fault as t_fault_ns
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.configs.base import FLConfig
from repro_torch.core import fault as t_fault
from repro_torch.data import synthetic as t_syn
from repro_torch.launch import fl_train as t_fl_train
from repro_torch.models.spec import DataMeta, get_model_spec, meta_for
from repro_torch.obs import STATS, TRACER, profile_trace
from repro_torch.obs.stats import StatsRegistry
from repro_torch.obs.store import ExperimentStore
from repro_torch.obs.trace import Tracer
from repro_torch.privacy.accountant import accounted_epsilon
from repro_torch.serve import (ServeEngine, batches_of,
                               save_serving_checkpoint)
from repro_torch.serve import engine as t_serve_engine
from repro_torch.serve.engine import _get_scorer
from repro_torch.train import fl_driver as t_fl_driver
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SET = dict(max_examples=25, deadline=None)


# ---------------------------------------------------------------------------
# the fault model's host half: bitwise the reference's
# ---------------------------------------------------------------------------


@given(st.floats(1.0, 5000.0), st.floats(0.5, 4.0))
@settings(**SET)
def test_weibull_failure_prob_bitwise(lam, k):
    ts = np.linspace(0.1, 10 * lam, 50)
    got = t_fault.weibull_failure_prob(ts, lam, k)
    assert np.array_equal(got, j_fault.weibull_failure_prob(ts, lam, k))
    assert ((got >= 0) & (got <= 1)).all()


@given(st.floats(100.0, 5000.0), st.floats(0.6, 3.0), st.floats(0.5, 20.0))
@settings(**SET)
def test_checkpoint_cost_and_interval_bitwise(lam, k, w):
    """Both cost forms on a grid and t_c* for both, with the reference's
    bracket minimum property on the renewal form."""
    T, t_r = 3600.0, 30.0
    ts = np.linspace(0.5, max(T, 4 * lam), 40)
    for wc in (None, w):
        assert np.array_equal(t_fault.checkpoint_cost(ts, T, t_r, lam, k, wc),
                              j_fault.checkpoint_cost(ts, T, t_r, lam, k, wc))
        tc = t_fault.optimal_checkpoint_interval(T, t_r, lam, k,
                                                 write_cost=wc)
        assert tc == j_fault.optimal_checkpoint_interval(T, t_r, lam, k,
                                                         write_cost=wc)
    hi = max(T, 4.0 * lam)
    assert 0 < tc <= hi * (1 + 1e-6)
    c_star = t_fault.checkpoint_cost(tc, T, t_r, lam, k, w)
    for other in (tc * 0.5, tc * 2.0):
        if 1e-3 <= other <= hi:
            assert c_star <= t_fault.checkpoint_cost(other, T, t_r, lam, k,
                                                     w) * (1 + 1e-6)


@given(st.lists(st.floats(1.0, 1000.0), min_size=30, max_size=200))
@settings(**SET)
def test_fit_weibull_bitwise(samples):
    lam, k = t_fault.fit_weibull(samples)
    assert (lam, k) == j_fault.fit_weibull(samples)
    assert lam > 0 and k > 0


def test_fit_weibull_recovers_parameters_and_edge_cases():
    rng = np.random.default_rng(3)
    for true_k in (0.8, 1.5, 2.5):
        x = 200.0 * rng.weibull(true_k, 4000)
        lam, k = t_fault.fit_weibull(x)
        assert (lam, k) == j_fault.fit_weibull(x)
        assert abs(k - true_k) / true_k < 0.1
        assert abs(lam - 200.0) / 200.0 < 0.1
    for few in ([], [5.0], [0.0, -1.0, 7.0]):
        assert t_fault.fit_weibull(few) == j_fault.fit_weibull(few)
    assert t_fault.recovery_overhead(30.0) == j_fault.recovery_overhead(30.0)


def test_fault_namespace_reexports_both_halves():
    assert set(j_fault_ns.__all__) <= set(t_fault_ns.__all__)
    assert t_fault_ns.optimal_checkpoint_interval is \
        t_fault.optimal_checkpoint_interval
    assert t_fault_ns.process_code("markov") == j_fault_ns.process_code(
        "markov") == 1.0
    assert t_fault_ns.PROCESSES == j_fault_ns.PROCESSES


@pytest.mark.parametrize("mode", ["bernoulli", "weibull"])
def test_failure_model_rates_match_the_reference(mode):
    """Over 10^5 draws the port's failure rate is within 3σ of the
    reference's (σ of the difference of two binomial means), and both are
    within 3σ of the analytic rate."""
    n = 100_000
    kw = dict(p_fail=0.05, mode=mode, lam=600.0, k=1.2, round_time=30.0)
    got = t_fault.FailureModel(**kw, device="cpu").sample(
        torch.Generator().manual_seed(0), n).double().mean().item()
    want = float(j_fault.FailureModel(**kw).sample(jax.random.key(0), n)
                 .mean())
    p = 0.05 if mode == "bernoulli" else float(
        t_fault.weibull_failure_prob(30.0, 600.0, 1.2))
    sd = math.sqrt(p * (1 - p) / n)
    assert abs(got - want) <= 3 * math.sqrt(2) * sd, (got, want)
    assert abs(got - p) <= 3 * sd and abs(want - p) <= 3 * sd


def test_failure_step_is_uniform_for_failures():
    n, steps = 100_000, 5
    fm = t_fault.FailureModel(p_fail=0.3, device="cpu")
    out = fm.failure_step(torch.Generator().manual_seed(1), n, steps)
    assert out.dtype == torch.int64 and out.shape == (n,)
    fails = out[out < steps]
    assert int((out == steps).sum()) + fails.numel() == n
    counts = torch.bincount(fails, minlength=steps).double()
    expect = fails.numel() / steps
    sd = math.sqrt(fails.numel() * (1 / steps) * (1 - 1 / steps))
    assert bool(((counts - expect).abs() <= 4 * sd).all()), counts
    assert abs(fails.numel() / n - 0.3) <= 3 * math.sqrt(0.3 * 0.7 / n)


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mlp_params():
    """A small ``mlp``'s reference params and their port copy."""
    fed = j_syn.make_federated(0, "unsw", n_samples=600, n_clients=4)
    jmeta = j_meta_for(fed)
    jspec = j_get_spec("mlp", jmeta)
    jparams = jspec.init(jax.random.key(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    return fed, jspec, jparams, get_model_spec("mlp", DataMeta(*jmeta)), \
        tparams


def _bitwise(tree_a, tree_b) -> bool:
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(tree_a),
                                                 tree_leaves(tree_b)))


def test_checkpointer_port_to_reference_and_back(tmp_path, mlp_params):
    _, _, jparams, _, tparams = mlp_params
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    ck = t_ckpt.Checkpointer(str(port_dir), keep=3)
    for r in range(5):
        ck.maybe_save(r, tree_map(lambda t: t + r, tparams), {"note": "x"})
    rnd, restored = j_ckpt.Checkpointer(str(port_dir)).restore_latest(jparams)
    assert rnd == 4
    for a, b in zip(jax.tree.leaves(restored),
                    tree_leaves(tree_map(lambda t: t + 4, tparams))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert t_ckpt.load_manifest(ck.latest()[1])["metadata"] == {
        "round": 4, "note": "x"}

    jck = j_ckpt.Checkpointer(str(ref_dir), keep=2)
    for r in (3, 7):
        jck.maybe_save(r, jax.tree.map(lambda a: a * r, jparams))
    rnd, restored = t_ckpt.Checkpointer(str(ref_dir)).restore_latest(tparams)
    assert rnd == 7
    assert _bitwise(restored, convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a * 7), jparams), "cpu"))
    assert all(l.device.type == "cpu" and l.dtype == torch.float32
               for l in tree_leaves(restored))


def test_checkpointer_rotates_skips_and_restores_nothing(tmp_path,
                                                         mlp_params):
    tparams = mlp_params[4]
    empty = t_ckpt.Checkpointer(str(tmp_path / "empty"))
    assert empty.latest() is None
    assert empty.restore_latest(tparams) == (None, None)

    ck = t_ckpt.Checkpointer(str(tmp_path / "rot"), keep=3,
                             interval_rounds=2)
    saved = [ck.maybe_save(r, tparams) for r in range(9)]
    assert [s is None for s in saved] == [r % 2 == 1 for r in range(9)]
    assert ck.saves == 5
    assert sorted(r for r, _ in ck._list()) == [4, 6, 8]
    names = sorted(os.listdir(tmp_path / "rot"))
    assert names == [f"ckpt_{r:08d}.npz{ext}" for r in (4, 6, 8)
                     for ext in ("", ".json")]
    # the reference's Checkpointer lists the same directory the same way
    assert sorted(j_ckpt.Checkpointer(str(tmp_path / "rot"))._list()) == \
        sorted(ck._list())
    rnd, restored = ck.restore_latest(tparams)
    assert rnd == 8 and _bitwise(restored, tparams)


# ---------------------------------------------------------------------------
# personalised export and spent_epsilon
# ---------------------------------------------------------------------------


def test_export_personalized_matches_the_reference(mlp_params):
    fed_j, jspec, jparams, tspec, tparams = mlp_params
    fed_t = t_syn.make_federated(0, "unsw", n_samples=600, n_clients=4)
    want = j_fl_driver.export_personalized(jparams, fed_j, jspec)
    got = t_fl_driver.export_personalized(tparams, fed_t, tspec)
    for path in (("l1", "w"), ("l2", "b"), ("out", "w")):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert isinstance(g, np.ndarray) and g.shape == w.shape
        assert g.shape[0] == fed_t.n_clients
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
    # each stacked slice is that client's personalised tree
    per_client = t_fl_driver.personalized_client_params(tparams, fed_t, tspec)
    last = tree_map(lambda h: torch.from_numpy(h[-1]), got)
    assert _bitwise(last, per_client[-1])


def test_exported_heads_serve_bitwise(tmp_path, mlp_params):
    """The reference's ``tests/test_serve.py`` personalised-heads case on
    the port: the exported NumPy stack, given to ``ServeEngine`` directly
    or through a serving checkpoint, scores each client bitwise as the
    scorer does on that client's personalised tree."""
    _, _, _, tspec, tparams = mlp_params
    fed = t_syn.make_federated(0, "unsw", n_samples=600, n_clients=4)
    meta = meta_for(fed)
    heads = t_fl_driver.export_personalized(tparams, fed, tspec)
    per_client = t_fl_driver.personalized_client_params(tparams, fed, tspec)
    path = save_serving_checkpoint(str(tmp_path / "serve_p"), tparams, "mlp",
                                   meta, heads=heads)
    x = np.asarray(fed.test_x[:11], np.float32)
    for eng in (ServeEngine(tspec, meta, tparams, heads=heads, buckets=(8, 32),
                            device="cpu"),
                ServeEngine.from_checkpoint(path, buckets=(8, 32),
                                            device="cpu")):
        assert eng.n_personalized == fed.n_clients
        for ci in (0, fed.n_clients - 1):
            want = np.concatenate([
                _get_scorer(tspec, meta, xb.shape[0], eng.route)(
                    per_client[ci], torch.as_tensor(xb))[:n].numpy()
                for xb, n in batches_of([x], eng.buckets)])
            assert np.array_equal(eng.score(x, client=ci), want)


def test_spent_epsilon_warns_and_matches_the_accountant():
    fl = FLConfig(dp_mode="clipped", dp_epsilon=8.0)
    with pytest.warns(DeprecationWarning, match="spent_epsilon"):
        eps = t_fl_driver.spent_epsilon(fl, 10)
    assert eps == accounted_epsilon(fl, 10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = j_fl_driver.spent_epsilon(JFLConfig(dp_mode="clipped",
                                                   dp_epsilon=8.0), 10)
    assert want == j_accounted_epsilon(JFLConfig(dp_mode="clipped",
                                                 dp_epsilon=8.0), 10)
    assert abs(eps - want) <= 1e-9 * want


# ---------------------------------------------------------------------------
# obs: tracer, registry, profiler markers, neutrality, store
# ---------------------------------------------------------------------------


def test_spans_nest_with_depth_and_parent():
    tr = Tracer()
    tr.enable()
    with tr.span("outer", k=1):
        with tr.span("inner"):
            pass
        with tr.span("inner"):
            tr.event("tick", n=7)
    outer = tr.find("outer")[0]
    inners = tr.find("inner")
    assert len(inners) == 2
    assert outer.depth == 0 and outer.parent == -1
    assert all(s.depth == 1 and s.parent == outer.index for s in inners)
    assert outer.wall_s >= max(s.wall_s for s in inners) >= 0.0
    assert outer.attrs == {"k": 1}
    (ev,) = tr.events
    assert ev["name"] == "tick" and ev["n"] == 7 and ev["depth"] == 2


def test_disabled_tracer_records_nothing_and_returns_shared_noop():
    tr = Tracer()
    cm1, cm2 = tr.span("a"), tr.span("b")
    assert cm1 is cm2
    with tr.span("a"):
        tr.event("e")
    assert tr.spans == [] and tr.events == []


def test_jsonl_dump_and_stream_round_trip(tmp_path):
    tr = Tracer()
    tr.enable(str(tmp_path / "stream.jsonl"))
    with tr.span("phase", rep=0):
        tr.event("compile", engine="sweep")
    tr.disable()
    path = tr.dump_jsonl(str(tmp_path / "trace.jsonl"))
    for p in (path, tmp_path / "stream.jsonl"):
        rows = [json.loads(ln) for ln in Path(p).read_text().splitlines()]
        assert {r["type"] for r in rows} == {"span", "event"}
        assert len(rows) == 2
        sp = next(r for r in rows if r["type"] == "span")
        assert sp["name"] == "phase" and sp["rep"] == 0 and sp["wall_s"] >= 0
        assert set(sp) == {"type", "name", "t0", "t0_ns", "t1_ns", "wall_s",
                           "cpu_s", "depth", "index", "parent", "rep"}
        assert sp["wall_s"] == (sp["t1_ns"] - sp["t0_ns"]) * 1e-9
        assert sp["t0"] == sp["t0_ns"] * 1e-9


def test_repro_trace_env_streams_jsonl(tmp_path):
    out = tmp_path / "env.jsonl"
    code = ("from repro_torch.obs import span, event\n"
            "with span('env.phase', a=1):\n    event('env.tick')\n")
    env = {**os.environ, "REPRO_TRACE": str(out),
           "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [(r["type"], r["name"]) for r in rows] == [
        ("event", "env.tick"), ("span", "env.phase")]


def test_spans_mark_any_torch_profiler_and_profile_trace(tmp_path):
    """With the tracer off, a span still enters ``record_function`` under
    its name while a profiler someone else started is recording, and
    ``profile_trace`` writes a Chrome trace holding the span."""
    tr = Tracer()
    assert tr.span("x") is tr.span("y")       # no profiler: the null object
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("obs.outside"):
            torch.ones(4).sum()
    assert "obs.outside" in {e.name for e in prof.events()}
    assert tr.spans == []
    with profile_trace(str(tmp_path / "prof")) as d:
        with TRACER.span("obs.inside"):
            torch.ones(4).sum()
    assert "obs.inside" in (Path(d) / "trace.json").read_text()


def test_counters_behave_like_the_dicts_they_replaced():
    reg = StatsRegistry()
    stats = reg.counters("runner", misses=0, hits=0)
    m0 = stats["misses"]
    stats["misses"] += 1
    stats["hits"] += 3
    assert stats["misses"] - m0 == 1
    assert dict(stats) == {"misses": 1, "hits": 3}
    assert reg.counters("runner") is stats
    reg.reset("runner")
    assert dict(stats) == {"misses": 0, "hits": 0}


def test_registry_delta_and_expect():
    reg = StatsRegistry()
    st_ = reg.counters("ns", a=0, b=0)
    with reg.delta("ns") as d:
        st_["a"] += 2
    assert d == {"a": 2, "b": 0}
    with reg.expect("ns", a=1):
        st_["a"] += 1
    with pytest.raises(AssertionError):
        with reg.expect("ns", a=1):
            pass


def test_live_registries_are_registered_namespaces():
    snap = STATS.snapshot()
    assert "runner" in snap and "serve" in snap
    assert dict(t_fl_driver.RUNNER_STATS) == snap["runner"]
    assert dict(t_serve_engine.SERVE_STATS) == snap["serve"]
    assert STATS.counters("runner") is t_fl_driver.RUNNER_STATS


def test_telemetry_is_bitwise_neutral():
    """``run_fl_batch(device="cpu")`` with the tracer on equals it with the
    tracer off, bitwise, and the traced run records one runner miss, its
    build span and one of each ``sweep.*`` span."""
    fed = t_syn.make_federated(0, "unsw", n_samples=600, n_clients=6)
    fl = FLConfig(n_clients=6, clients_per_round=3, rounds=4, local_epochs=2,
                  local_batch=32, local_lr=0.1, dp_enabled=True,
                  dp_mode="clipped", dp_epsilon=1000.0, dp_clip=1.0,
                  fault_tolerance=True, failure_prob=0.1)

    def go():
        t_fl_driver._RUNNER_CACHE.clear()
        res = t_fl_driver.run_fl_batch(fed, fl, "proposed", seeds=(0, 1),
                                       rounds=4, eval_every=2,
                                       return_params=True, device="cpu")
        return res

    was = TRACER.enabled
    TRACER.disable()
    off = go()
    TRACER.clear()
    TRACER.enable()
    try:
        with STATS.expect("runner", misses=1, hits=0):
            on = go()
        names = [s.name for s in TRACER.spans]
        events = [e["name"] for e in TRACER.events]
    finally:
        TRACER.disable()
        TRACER.clear()
        if was:
            TRACER.enable()
    assert events == ["compile.runner_miss"]
    assert sorted(names) == sorted(["runner.build", "sweep.prepare",
                                    "sweep.execute", "sweep.readback"])
    for a, b in zip(off, on):
        assert a.history == b.history
        assert (a.accuracy, a.auc, a.eps_spent, a.sim_time_s) == \
            (b.accuracy, b.auc, b.eps_spent, b.sim_time_s)
        assert _bitwise(a.params, b.params)


def _fill_store(store, backend):
    rid = store.begin_run(engine_rev="models4", backend=backend, mode="test",
                          sha="sha0")
    store.record_cell(rid, "engine", "batch_warm", statics_key="abc123",
                      wall_cold_s=9.0, warm_walls=[1.01, 1.02],
                      lane_params={"rounds": 4},
                      metrics={"auc_mean": (0.9, 1), "ratio": (1.1, -1),
                               "info": 42.0})
    return rid


def test_store_is_read_across_packages(tmp_path):
    port = ExperimentStore(str(tmp_path / "port.sqlite"))
    rid = _fill_store(port, None)             # the port records its backend
    port.close()
    ref = JExperimentStore(str(tmp_path / "port.sqlite"))
    (cell,) = ref.cells_of_run(rid)
    assert cell["metrics"]["auc_mean"] == {"value": 0.9, "direction": 1}
    assert cell["wall_warm_s"] == 1.01 and cell["lane_params"] == {
        "rounds": 4}
    backend = ref._conn.execute("SELECT backend FROM runs").fetchone()[0]
    assert backend == ("cuda" if torch.cuda.is_available() else "cpu")
    assert ref.query_plan_uses_index()
    ref.close()

    ref = JExperimentStore(str(tmp_path / "ref.sqlite"))
    rid = _fill_store(ref, "cpu")
    want = ref.cells_of_run(rid)
    ref.close()
    port = ExperimentStore(str(tmp_path / "ref.sqlite"))
    assert port.cells_of_run(rid) == want
    assert port.metric_history("engine", "batch_warm", "auc_mean") == [
        (rid, 0.9)]
    assert port.lanes("engine") == [("engine", "batch_warm")]
    port.close()


# ---------------------------------------------------------------------------
# the FL CLI against the reference's
# ---------------------------------------------------------------------------


def _shape(text: str) -> list:
    """The printed lines with every number replaced by ``#``."""
    return [re.sub(r"-?\d+(\.\d+)?", "#", ln) for ln in text.splitlines()
            if ln.strip()]


def test_fl_cli_matches_the_reference_cli(tmp_path, capsys, monkeypatch):
    small = ["--rounds", "4", "--clients", "8", "--samples", "1200"]
    t_json, j_json = tmp_path / "port.json", tmp_path / "ref.json"
    res = t_fl_train.main(small + ["--device", "cpu", "--json-out",
                                   str(t_json)])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["fl_train"] + small +
                        ["--json-out", str(j_json)])
    j_fl_train.main()
    ref_out = capsys.readouterr().out
    assert _shape(port_out.replace(str(t_json), "OUT")) == \
        _shape(ref_out.replace(str(j_json), "OUT"))
    got, want = json.loads(t_json.read_text()), json.loads(j_json.read_text())
    assert set(got) == set(want) and got["params"] is None
    assert set(got["history"]) == set(want["history"])
    assert got["history"]["round"] == want["history"]["round"] == [1, 2, 3, 4]
    assert abs(got["eps_spent"] - want["eps_spent"]) <= 1e-9 * want[
        "eps_spent"]
    assert (got["method"], got["dataset"], got["seed"], got["rounds"]) == (
        want["method"], want["dataset"], want["seed"], want["rounds"])
    # in-process, the result carries the final params on the device
    assert res.params is not None and all(
        l.device.type == "cpu" for l in tree_leaves(res.params))
    assert dataclasses.replace(res, params=None).eps_spent == got["eps_spent"]


# ---------------------------------------------------------------------------
# the two-sided test the own-RNG check gates on
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift", [0.0, 0.5, 2.0])
def test_two_sided_mannwhitney_matches_scipy(shift):
    from scipy import stats as sp_stats

    from repro_torch.stats import compare_finals, mannwhitney_two_sided
    rng = np.random.default_rng(7)
    a, b = rng.normal(shift, 1.0, 10), rng.normal(0.0, 1.0, 10)
    want = sp_stats.mannwhitneyu(a, b, alternative="two-sided").pvalue
    assert mannwhitney_two_sided(a, b) == pytest.approx(want, rel=1e-12)
    assert mannwhitney_two_sided(b, a) == pytest.approx(want, rel=1e-12)
    (med_a, med_b, p), = compare_finals([{"x": v} for v in a],
                                        [{"x": v} for v in b],
                                        keys=("x",)).values()
    assert (med_a, med_b, p) == (np.median(a), np.median(b),
                                 mannwhitney_two_sided(a, b))
