"""``correct`` comes out false with the timed path broken underneath, and
for the control, at a size the CPU holds.

Each fault is planted in the program for one run of the harness (the
look for a chip skipped): a round step that returns its state unchanged,
half of each batch left out of the loss, the DP clip skipped, the clean
updates left out of the aggregate, a MoE's last expert choice moved to
the next-best expert, a served token altered, half of a prefill batch
never computed.  The control is the reference with float8 products in
the program's place, judged, with the reference's own faults, against
every training cell's limits, and on a MoE by a reference that follows
its expert choices.
"""
from __future__ import annotations

import pytest
import torch

from perfbench.harness import check, report, traffic
from perfbench.harness.cells import BENCH_DIR, load_json
from perfbench.control import MOE_VARIANTS, VARIANTS, train_readings
from perfbench.reference import layout
from perfbench.run import run_cell
from perfbench.test_perfbench_reference import tiny_cell, tiny_model

SEED = 2**31 + 101


def _correct(cell) -> bool:
    return report.correct(run_cell(cell, SEED, 0.0, False, "cpu").checks)


def test_sound_runs_are_correct():
    assert _correct(tiny_cell("fl_rounds"))
    assert _correct(tiny_cell("prefill_closed"))


def test_state_unchanged(monkeypatch):
    from repro_torch.core import rounds
    real = rounds.make_serial_round

    def broken(*a, **kw):
        step = real(*a, **kw)

        def still(state, *args, **kwargs):
            return state, step(state, *args, **kwargs)[1]
        return still

    monkeypatch.setattr(rounds, "make_serial_round", broken)
    assert not _correct(tiny_cell("fl_rounds"))


def test_half_batch_in_training(monkeypatch):
    from repro_torch.models.model import Model
    real = Model.loss

    def half(self, params, batch, **kw):
        n = batch["tokens"].shape[0] // 2
        return real(self, params, {k: v[:n] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(Model, "loss", half)
    assert not _correct(tiny_cell("fl_rounds"))


def _clip_noise(monkeypatch, fault: str) -> None:
    """The program's clip and noise of a slot's update, broken: the clip
    skipped, or the clean update left out (the pre-clip norm reported as
    before, the noise alone aggregated)."""
    from repro_torch.kernels import ops
    real = ops.dp_clip_noise

    def broken(x, noise, clip, sigma, out=None):
        if fault == "no_clip":
            return real(x, noise, 1e30, sigma, out=out)
        norm = torch.linalg.vector_norm(x.float())
        res, _ = real(x.mul_(0.0), noise, clip, sigma, out=out)
        return res, norm

    monkeypatch.setattr(ops, "dp_clip_noise", broken)


@pytest.mark.parametrize("fault", ["no_clip", "noise_only"])
def test_clip_and_aggregate_faults(monkeypatch, fault):
    """At a local rate where the clip (10) binds in round 2 (update norms
    17–39 there at this size, 3–4 in round 1), a sound run is correct and
    each fault is not."""
    cell = tiny_cell("fl_rounds", local_lr=0.5)
    assert _correct(cell)
    _clip_noise(monkeypatch, fault)
    assert not _correct(cell)


def test_route_shift(monkeypatch):
    """The program's MoE moves each token's last expert choice to the
    next-best expert: the run fails ``route_gap``, which reads the gap
    between the two experts' router logits."""
    import torch.nn.functional as F
    from repro_torch.models import moe
    cell = tiny_cell("fl_rounds", "moe")
    value, limit = run_cell(cell, SEED, 0.0, False, "cpu").checks["route_gap"]
    assert value <= limit
    real = moe._choose

    def shifted(router_w, x, cfg):
        gates, idxs, masks, gvals, aux = real(router_w, x, cfg)
        g = gates
        for mask in masks:
            g = g * (1.0 - mask)
        idx = torch.argmax(g, dim=-1)
        mask = F.one_hot(idx, cfg.n_experts).float()
        return (gates, idxs[:-1] + [idx], masks[:-1] + [mask],
                gvals[:-1] + [torch.sum(gates * mask, dim=-1)], aux)

    monkeypatch.setattr(moe, "_choose", shifted)
    checks = run_cell(cell, SEED, 0.0, False, "cpu").checks
    value, limit = checks["route_gap"]
    assert value > 10 * limit, checks


def test_route_record_short(monkeypatch):
    """The program's recorded expert choices cover only half of each
    batch: the reference cannot follow them, and ``route_gap`` reads
    inf."""
    from perfbench.harness import fl
    real = fl.ExpertChoices.keyed

    def short(self, *a):
        return {k: [c[:1] for c in v] for k, v in real(self, *a).items()}

    monkeypatch.setattr(fl.ExpertChoices, "keyed", short)
    checks = run_cell(tiny_cell("fl_rounds", "moe"), SEED, 0.0, False,
                      "cpu").checks
    assert checks["route_gap"][0] == float("inf"), checks


@pytest.mark.parametrize("fault", ["token_altered", "half_batch"])
def test_prefill_faults(monkeypatch, fault):
    from repro_torch.models.model import Model
    real = Model.forward

    def broken(self, params, batch, **kw):
        logits = real(self, params, batch, **kw)
        if fault == "token_altered":
            return logits.roll(1, dims=-1)
        out = logits.clone()
        out[out.shape[0] // 2:] = 0.0
        return out

    monkeypatch.setattr(Model, "forward", broken)
    assert not _correct(tiny_cell("prefill_closed"))


@pytest.mark.parametrize("variant", ["control_fp8", "fault_half_batch",
                                     "fault_noise_only"])
@pytest.mark.parametrize("cell", [w["name"] for w in load_json(
    BENCH_DIR.parent / "BENCHMARK.json")["workloads"]
    if w["traffic"].startswith("silo")])
def test_control_fails_training_limits(cell, variant):
    """The reference in the program's place, in bf16 at a size the CPU
    holds, fails the cell's limits with float8 products, half of each
    batch left out, or the clean updates left out."""
    limits = load_json(BENCH_DIR / "limits" / f"{cell}.json")
    c = tiny_cell("fl_rounds", "dense", "bfloat16", limits)
    wanted = [v for v in VARIANTS if v[0] == variant]
    got = train_readings(c, SEED, "cpu", variants=wanted)[variant]
    got.pop("detail")
    assert not report.correct(check.with_limits(got, limits)), got


@pytest.mark.parametrize("variant,number", [("control_fp8", "agg1"),
                                            ("fault_route_shift", "route_gap")])
def test_control_fails_on_a_moe(variant, number):
    """On the tiny MoE in bf16, the reference in the program's place with
    float8 products, each variant followed on its own expert choices by
    the float32 reference, fails the silo cell's ``agg1`` limit; with each
    token's last choice moved to the next-best expert, ``route_gap`` reads
    the gap between the experts, far over a rounding of a logit."""
    limits = load_json(BENCH_DIR / "limits" / "granite-3-8b-l8.silo.json")
    # route_gap: the limit proposed for phi3.5-moe-l4e8.silo
    limit = dict(limits["numbers"], route_gap={"limit": 0.15})[number]
    c = tiny_cell("fl_rounds", "moe", "bfloat16", limits)
    wanted = [v for v in VARIANTS + MOE_VARIANTS if v[0] == variant]
    got = train_readings(c, SEED, "cpu", variants=wanted)[variant]
    assert got[number] > limit["limit"], got


def test_control_separates_in_prefill():
    """The prefill control at a size the CPU holds (width 1,024, 4
    layers; its readings at the cell's own size are the chip's): its
    widest gap is over three times the program's on the same prompts."""
    from perfbench.harness.prefill import reference_logits
    m = dict(tiny_model(dtype="bfloat16", d_model=1024, vocab=4000),
             n_layers=4)
    base = tiny_cell("prefill_closed")
    t = dict(base.traffic, batch=4, pool_batches=2)
    cell = base._replace(config={"model": m}, traffic=t,
                         limits={"numbers": {"logit_gap": {"limit": 1.0}}})
    prog = run_cell(cell, SEED, 0.5, False, "cpu").checks["logit_gap"][0]
    lv = layout.leaves(m)
    pool = traffic.prompt_pool(t, m["vocab_size"], SEED, "cpu")
    keys = {(length, j) for length in pool.lengths for j in range(2)}
    ref = reference_logits(m, lv, SEED, pool, keys, "cpu")
    low = reference_logits(m, lv, SEED, pool, keys, "cpu", precision="fp8")
    gap = max(check.logit_gap(low[k].argmax(-1), ref[k]) for k in keys)
    assert gap > 3 * prog and gap > 0, (gap, prog)
