"""The device phases of ``repro_torch.obs.trace`` (``phase``,
``phase_call``) on the CPU: the model's sublayer phases and the local
step's, forward and ``.bwd``, under a ``torch.profiler`` trace; the same
loss and grads, bit for bit, with the profiler off, the tracer on, and
under a profiler; no autograd node added; and host spans on the
profiler's clock.
"""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.granite_3_8b import smoke_config
from repro_torch.configs.phi3p5_moe_42b import smoke_config as moe_smoke
from repro_torch.core import rounds as t_rounds
from repro_torch.models import attention as t_attn
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_tr
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import TRACER, Tracer, phase, profile_trace
from repro_torch.tree import tree_leaves, tree_map

SUBLAYER = ("block.attention", "block.attend", "block.mlp", "lm.head")
STEPS = 2


def _model(dtype: str = "float32"):
    cfg = dataclasses.replace(smoke_config(), dtype=dtype)
    m = t_model.build(cfg)
    return m, m.init(0, device="cpu")


def _batch(cfg, seed: int, b: int = 2, s: int = 16):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _vag(m, remat: str = "none"):
    return t_rounds.value_and_grad(lambda p, b: m.loss(p, b, remat=remat))


def _host_events(prof):
    """(name, start ns, end ns) of every host event, sorted by start."""
    from torch.autograd import DeviceType
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU),
                  key=lambda e: e[1])


def _names(events):
    out = {}
    for n, _, _ in events:
        out[n] = out.get(n, 0) + 1
    return out


def _inside(inner, outer) -> bool:
    """Every ``inner`` interval lies in some ``outer`` interval."""
    return all(any(a0 <= b0 and b1 <= a1 for a0, a1 in outer)
               for b0, b1 in inner)


def _intervals(events, name):
    return [(a, b) for n, a, b in events if n == name]


@pytest.mark.parametrize("dtype,remat", [("float32", "none"),
                                         ("bfloat16", "none"),
                                         ("float32", "full")])
def test_loss_and_grads_bitwise_off_on_and_under_a_profiler(dtype, remat):
    """The phases leave ``Model.loss`` and every grad bitwise: with no
    profiler, with the host tracer on, and under a CPU profiler (where
    the ``.bwd`` ranges hang on tensor hooks).  In f32 the RMSNorm reads
    its input three times, which an identity marker node would
    re-associate."""
    m, params = _model(dtype)
    batch = _batch(m.cfg, 1)
    vag = _vag(m, remat)
    ref_loss, ref_g = vag(params, batch)

    def same(loss, g):
        assert torch.equal(loss, ref_loss) and loss.dtype == ref_loss.dtype
        for a, b in zip(tree_leaves(g), tree_leaves(ref_g)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    tr_was = TRACER.enabled
    TRACER.enable()
    try:
        same(*vag(params, batch))
    finally:
        if not tr_was:
            TRACER.disable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = vag(params, batch)
    same(*got)
    names = _names(_host_events(prof))
    layers = m.cfg.n_layers
    assert names.get("block.attention.bwd") == layers
    assert names.get("lm.head.bwd") == 1


def test_profiler_sees_each_phase_and_its_bwd_once_a_layer_a_step():
    """Under a profiler, the local step shows each sublayer phase and its
    ``.bwd`` partner layers × steps times (the head once a step),
    ``local.sgd`` once a step and ``local.update_row`` once; the attend
    nests in the attention, forward and backward; every ``.bwd`` falls
    in its step's backward pass, after that step's head."""
    m, params = _model()
    batch = _batch(m.cfg, 2)
    steps = {k: torch.stack([v] * STEPS) for k, v in batch.items()}
    local_train = t_rounds._local_train_tree_fn(
        lambda p, b: m.loss(p, b, remat="none"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        local_train(params, steps, torch.tensor(STEPS), 1e-3)
    ev = _host_events(prof)
    names = _names(ev)
    layers = m.cfg.n_layers
    for n in SUBLAYER:
        per_step = 1 if n == "lm.head" else layers
        assert names.get(n) == per_step * STEPS, (n, names.get(n))
        assert names.get(n + ".bwd") == per_step * STEPS, (n, names)
    assert names.get("local.sgd") == STEPS
    assert names.get("local.update_row") == 1
    assert _inside(_intervals(ev, "block.attend"),
                   _intervals(ev, "block.attention"))
    assert _inside(_intervals(ev, "block.attend.bwd"),
                   _intervals(ev, "block.attention.bwd"))
    heads = _intervals(ev, "lm.head")
    sgd = _intervals(ev, "local.sgd")
    for s in range(STEPS):
        lo, hi = heads[s][1], sgd[s][0]
        for n in SUBLAYER:
            got = [iv for iv in _intervals(ev, n + ".bwd")
                   if lo <= iv[0] and iv[1] <= hi]
            assert len(got) == (1 if n == "lm.head" else layers), (s, n)
    # backward runs the layers last to first: each layer's MLP before its
    # attention, the head first of all
    bwd = [n for n, _, _ in ev if n.endswith(".bwd")
           and n != "block.attend.bwd"]
    one = (["lm.head.bwd"]
           + ["block.mlp.bwd", "block.attention.bwd"] * layers)
    assert bwd == one * STEPS


MOE_PHASES = ("block.moe", "moe.route", "moe.experts")


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_phases_and_their_bwd_leave_the_step_bitwise(impl, monkeypatch):
    """A MoE step that holds 2 of its router's 4 experts, under a
    profiler: ``block.moe`` and, inside it, ``moe.route`` and
    ``moe.experts``, forward and ``.bwd``, once a layer; the loss and
    every grad bitwise the untraced step's.  The route returns several
    tensors (``phase_call`` hooks each output that needs a grad)."""
    monkeypatch.setattr(t_tr, "MOE_IMPL", [impl])
    cfg = dataclasses.replace(moe_smoke(), dtype="float32", n_experts=2,
                              router_experts=4)
    m = t_model.build(cfg)
    params = m.init(0, device="cpu")
    batch = _batch(cfg, 5)
    vag = _vag(m)
    ref_loss, ref_g = vag(params, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, g = vag(params, batch)
    assert torch.equal(loss, ref_loss)
    for a, b in zip(tree_leaves(g), tree_leaves(ref_g), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ev = _host_events(prof)
    names = _names(ev)
    for n in MOE_PHASES:
        assert names.get(n) == names.get(n + ".bwd") == cfg.n_layers, (n, names)
    assert "block.mlp" not in names
    for inner in MOE_PHASES[1:]:
        for sfx in ("", ".bwd"):
            assert _inside(_intervals(ev, inner + sfx),
                           _intervals(ev, "block.moe" + sfx)), inner + sfx


def test_no_grad_prefill_shows_the_forward_phases_only():
    m, params = _model("bfloat16")
    toks = _batch(m.cfg, 3)["tokens"]
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        m.forward(params, {"tokens": toks}, last_only=True)
    names = _names(_host_events(prof))
    layers = m.cfg.n_layers
    assert {n: names.get(n) for n in SUBLAYER} == {
        "block.attention": layers, "block.attend": layers,
        "block.mlp": layers, "lm.head": 1}
    assert not [n for n in names if n.endswith(".bwd")]


def _graph(t):
    """The names of the autograd graph's nodes, depth first from
    ``t.grad_fn``, each node once."""
    seen, out, stack = set(), [], [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        out.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return out


def test_phase_call_adds_no_autograd_node(monkeypatch):
    """The loss's graph is node for node the one built with the phases
    replaced by plain calls: with no profiler, and under one (hooks, not
    marker nodes)."""
    m, params = _model()
    batch = _batch(m.cfg, 4)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)

    def graph():
        return _graph(m.loss(leaves, batch, remat="none"))

    off = graph()
    with profile(activities=[ProfilerActivity.CPU]):
        on = graph()
    plain = lambda name, fn, *xs: fn(*xs)  # noqa: E731
    monkeypatch.setattr(t_tr, "phase_call", plain)
    monkeypatch.setattr(t_attn, "phase_call", plain)
    assert off == graph() == on


def test_phase_is_the_shared_noop_without_a_profiler():
    assert phase("local.sgd") is phase("local.update_row")
    calls = []
    assert obs_trace.phase_call("x", lambda a: calls.append(a) or 3, 7) == 3
    assert calls == [7]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with phase("obs.phase"):
            torch.ones(4).sum()
    assert "obs.phase" in _names(_host_events(prof))


def test_spans_are_on_the_profilers_clock(tmp_path):
    """A host span recorded while ``profile_trace`` runs overlaps its own
    profiler event in the Chrome trace, their starts under 1 ms apart;
    ``wall_s`` is the span's two stamps apart.  The first
    ``record_function`` of a process pays a one-off set-up of about a
    millisecond inside whichever span opens it, so a warm span goes
    first."""
    tr = Tracer()
    tr.enable()
    with profile_trace(str(tmp_path / "prof")) as d:
        with tr.span("obs.warm"):
            pass
        with tr.span("obs.clock"):
            torch.ones(4096).sum()
    sp = tr.find("obs.clock")[0]
    assert sp.t1_ns > sp.t0_ns
    assert sp.wall_s == (sp.t1_ns - sp.t0_ns) * 1e-9
    assert sp.t0 == sp.t0_ns * 1e-9
    chrome = json.loads((tmp_path / "prof" / "trace.json").read_text())
    (ev,) = [e for e in chrome["traceEvents"] if e.get("name") == "obs.clock"]
    e0 = chrome["baseTimeNanoseconds"] + round(ev["ts"] * 1e3)
    e1 = e0 + round(ev["dur"] * 1e3)
    assert e0 < sp.t1_ns and sp.t0_ns < e1
    assert abs(sp.t0_ns - e0) < 1_000_000
    assert d == str(tmp_path / "prof")
