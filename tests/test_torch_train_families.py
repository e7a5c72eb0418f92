"""Federated training of the MoE, VLM and encoder-decoder families through
the port's train CLI, against the JAX reference.

The frontend batches of the train CLI (``launch/train.py``
``round_batches``/``eval_batch``) bitwise the reference CLI's
``_round_batches``/``_eval_batch``; ``train(..., device="cpu")`` on
qwen2-vl's and seamless's smoke configs with those frontends; the
``client_serial`` round on the phi3.5-moe, qwen2-vl and seamless smoke
LMs, 2 rounds on the reference's draws and the reference CLI's batches;
``microbatched_value_and_grad`` under every remat on the three; and the
package names the reference exports (``strategy_names``, the privacy
subpackage).

Tolerances: f32 at 1e-5, grads at 1e-4 of each leaf's largest magnitude
(``tests/test_torch_train.py``).  After a round of clipped DP noise the
LMs' softmaxes saturate (the loss goes from ~6.3 to 27–50), and the next
round amplifies any f32 difference in its input far past 1e-5
(seamless's update norms by 1.4e-3 of their size).  So each value of a
noised round after the first is held at ``REASSOC_MULT`` times its state
gap, read in the same test: the port's same round, on the same draws and
data, from the reference's state before it against from its own (two
states within 1e-5 of each other: the port's own amplification of that
difference), never under 1e-5.  The bar holds the port to the
reference's round while the witness runs the port's code alone.
``chip_smoke.py`` holds the noised rounds card against CPU so too; its
other witness there, the same round at ``grad_accum`` 2, re-associates
almost nothing on the CPU at a batch of 2 (at most 6e-8 here).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.core import rounds as j_rounds
from repro.core import selection as j_sel
from repro.launch import train as j_train
from repro.models import model as j_model

import repro.privacy as j_privacy
import repro_torch.privacy as t_privacy
from repro_torch.configs import base as t_base
from repro_torch.core import rounds as t_rounds
from repro_torch.core import selection as t_sel
from repro_torch.launch import train as t_train
from repro_torch.models import model as t_model
from repro_torch.models import transformer as t_tr
from repro_torch.tree import tree_leaves

from test_torch_train import (RTOL, _close, _grads_close, _np, _serial_state,
                              _to_torch, _train_fl, reference_serial_draws)

torch.set_num_threads(1)

FAMILIES = ("phi3p5_moe_42b", "qwen2_vl_72b", "seamless_m4t_large_v2")
FRONTENDS = ("qwen2_vl_72b", "seamless_m4t_large_v2")
REASSOC_MULT = 8.0
SEQ = 16


def _cfgs(arch: str, dtype: str = "float32"):
    jc = dataclasses.replace(j_base.get_arch(arch, smoke=True), dtype=dtype)
    return jc, t_base.ModelConfig(**dataclasses.asdict(jc))


def _lm(arch: str):
    jc, tc = _cfgs(arch)
    jm = j_model.build(jc)
    jp = jm.init(jax.random.key(0))
    return jm, jp, t_model.build(tc), _to_torch(jp)


def _args(batch: int = 2, seq: int = SEQ):
    """The reference CLI's parsed flags that its batch builders read."""
    return types.SimpleNamespace(batch=batch, seq=seq)


def _cli_rounds(jm, fl, batch: int = 2, seq: int = SEQ, seed: int = 0):
    """Round ``r``'s batches as the reference CLI builds them (seed · 100 +
    r), for both packages."""
    def batches(r):
        jb = j_train._round_batches(jm, jm.cfg, fl, _args(batch, seq),
                                    seed * 100 + r)
        return jb, {k: torch.as_tensor(np.asarray(v)) for k, v in jb.items()}
    return batches


# ---------------------------------------------------------------------------
# the frontend batches (the train CLI's F1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("arch", FRONTENDS + ("granite_3_8b",
                                              "phi3p5_moe_42b"))
def test_cli_batches_are_bitwise_the_reference_clis(arch, seed):
    """``round_batches`` and ``eval_batch`` equal the reference CLI's
    arrays bitwise, ``frontend`` included where the config has one: the
    VLM's patches ``[K, steps, b, frontend_tokens, d]`` from the round's
    seed, the encoder-decoder's frames ``[.., enc_seq, d]``, the eval
    batch's from seed 0 whatever the run's seed."""
    jc, tc = _cfgs(arch)
    jfl, fl = _train_fl(local_steps_in_step=2)
    got = t_train.round_batches(tc, fl, 2, SEQ, seed * 100 + 1)
    want = j_train._round_batches(None, jc, jfl, _args(), seed * 100 + 1)
    got_eval = t_train.eval_batch(tc, 2, SEQ, seed)
    want_eval = j_train._eval_batch(None, jc, 2, SEQ, seed)
    has = arch in FRONTENDS
    assert t_train.has_frontend(tc) == has
    for g, w in ((got, want), (got_eval, want_eval)):
        assert set(g) == set(w) == ({"tokens", "labels"}
                                    | ({"frontend"} if has else set()))
        for k in g:
            assert g[k].dtype == np.asarray(w[k]).dtype
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    if has:
        n = tc.enc_seq if tc.enc_layers else tc.frontend_tokens
        assert got["frontend"].shape == (2, 2, 2, n, tc.d_model)
        assert got_eval["frontend"].shape == (2, n, tc.d_model)
        np.testing.assert_array_equal(
            got_eval["frontend"],
            t_train.eval_batch(tc, 2, SEQ, seed + 1)["frontend"])


@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_cli_trains_with_the_frontend(arch, capsys):
    """The CLI on the CPU for qwen2-vl and seamless with ``--dp``: finite
    losses; the eval loss is ``Model.loss`` on the eval batch with its
    frontend (a VLM's patches' logits dropped: the cross-entropy of the
    text positions' logits alone), and differs from the text alone."""
    out = t_train.main(["--arch", arch, "--device", "cpu", "--rounds", "2",
                        "--seq", str(SEQ), "--dp"])
    assert "final eval loss:" in capsys.readouterr().out
    assert np.isfinite(out["initial_eval_loss"])
    assert np.isfinite(out["final_eval_loss"])
    assert all(np.isfinite(r["local_loss"]) for r in out["rounds"])
    model, params = out["model"], out["state"].params
    batch = {k: torch.as_tensor(v)
             for k, v in t_train.eval_batch(model.cfg, 2, SEQ, 0).items()}
    with torch.no_grad():
        loss = float(model.loss(params, batch, remat="none"))
        assert loss == out["final_eval_loss"]
        if arch == "qwen2_vl_72b":
            logits = model.forward(params, batch)
            n = model.cfg.frontend_tokens
            assert logits.shape[1] == n + SEQ
            text = t_tr.xent(logits[:, n:], batch["labels"])
            assert float(text) == pytest.approx(loss, rel=1e-6)
            no_front = float(model.loss(params, {
                k: v for k, v in batch.items() if k != "frontend"},
                remat="none"))
            assert no_front != loss


# ---------------------------------------------------------------------------
# the client_serial round on the three families
# ---------------------------------------------------------------------------


def _round_values(state, metrics) -> dict:
    """The values of a serial round compared across packages, by name."""
    out = {f: [getattr(metrics, f)] for f in
           ("pre_loss", "post_loss", "global_loss", "k_effective",
            "update_norms")}
    out["params"] = list(tree_leaves(state.params))
    out["util"] = list(state.util)
    out["kctl"] = list(state.kctl)
    return out


def _rel_err(a, b) -> float:
    """max |a − b| over max(1, max |b|)."""
    a, b = _np(a), _np(b)
    if not b.size:
        return 0.0
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _diff(va: dict, vb: dict) -> dict:
    return {k: max(_rel_err(a, b) for a, b in zip(va[k], vb[k])) for k in va}


def _run_family_rounds(arch: str, dp: bool, rounds: int = 2):
    """``rounds`` serial rounds of the reference's step and the port's on
    the reference's draws and the reference CLI's batches: sel_mask and
    failed equal every round; without DP every value within 1e-5
    (relative, and absolute of max(1, |x|)); with DP, the first round
    within 1e-5 and each later one within REASSOC_MULT times its state
    gap: the port's same round from the reference's state before it
    against from its own.  Returns the readings (name, err, bar)."""
    jm, jp, tm, tp = _lm(arch)
    jfl, fl = _train_fl(dp_enabled=dp)
    n = fl.n_clients
    jstate = j_rounds.init_round_state(jp, jfl, jax.random.key(11),
                                       n_clients=n)
    tstate = _serial_state(jstate, fl)
    jstep = j_rounds.make_serial_round(
        lambda p, b: jm.loss(p, b, remat="none"), jfl, n)
    tstep = t_rounds.make_serial_round(
        lambda p, b: tm.loss(p, b, remat="none"), fl, n, device="cpu")
    shapes = [tuple(l.shape) for l in jax.tree.leaves(jp)]
    batches = _cli_rounds(jm, jfl)
    readings = []
    for r in range(rounds):
        jb, tb = batches(r)
        if "frontend" in tb:
            assert tb["frontend"].dtype == torch.float32
            assert tb["frontend"].shape[:3] == (2, 1, 2)
        draws, _ = reference_serial_draws(
            jstate.rng, n, fl.serial_clients_in_step, 1, shapes)
        swapped = None
        if dp and r > 0:  # the port's round from the reference's state
            swapped = _round_values(*tstep(_serial_state(jstate, fl)._replace(
                round_idx=tstate.round_idx), tb, draws=draws))
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb, draws=draws)
        np.testing.assert_array_equal(_np(tmet.sel_mask), _np(jmet.sel_mask))
        np.testing.assert_array_equal(_np(tmet.failed), _np(jmet.failed))
        got = _round_values(tstate, tmet)
        gaps = None if swapped is None else _diff(swapped, got)
        for k, err in _diff(got, _round_values(jstate, jmet)).items():
            bar = RTOL if gaps is None else max(RTOL, REASSOC_MULT * gaps[k])
            readings.append((f"round {r} {k}", err, bar))
        assert tstate.round_idx == r + 1
    for what, err, bar in readings:
        assert err <= bar, (what, err, bar, readings)
    return readings


@pytest.mark.parametrize("dp", [False, True], ids=["no_dp", "clipped_dp"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serial_round_families_match_reference(arch, dp):
    """phi3.5-moe (top-2 over 4 experts), qwen2-vl (16 patches a row on
    M-RoPE positions) and seamless (16 frames a row through the encoder)
    at their smoke configs in f32, under the train CLI's config (8
    clients, 2 slots, 1 local step, failures 0.05), 2 rounds: without DP
    at 1e-5 throughout; with clipped DP (ε 50, clip 10) the first round at
    1e-5 and the noised second at its state-gap bar."""
    readings = _run_family_rounds(arch, dp)
    assert len(readings) == 2 * 8


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_microbatched_value_and_grad_families_match_jax(arch, grad_accum,
                                                        remat):
    """Loss (1e-5) and grads (1e-4 of max|g|) of each family's smoke LM in
    f32 on the reference CLI's eval batch (its frontend included) split
    into ``grad_accum`` microbatches, under each remat policy, against the
    reference's ``microbatched_value_and_grad`` at remat "none"."""
    jm, jp, tm, tp = _lm(arch)
    jb = j_train._eval_batch(jm, jm.cfg, 2, SEQ, 5)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in jb.items()}
    jloss, jg = j_rounds.microbatched_value_and_grad(
        lambda p, b: jm.loss(p, b, remat="none"), grad_accum)(jp, jb)
    tloss, tg = t_rounds.microbatched_value_and_grad(
        lambda p, b: tm.loss(p, b, remat=remat), grad_accum)(tp, tb)
    _close(tloss, jloss)
    _grads_close(tg, jg, "float32")
    assert [g.dtype for g in tree_leaves(tg)] == \
        [p.dtype for p in tree_leaves(tp)]


# ---------------------------------------------------------------------------
# package names
# ---------------------------------------------------------------------------


def test_strategy_names_and_privacy_exports_match_the_reference():
    """``strategy_names()`` in the reference's order, each resolving to a
    strategy; ``repro_torch.privacy`` exports the reference's 22 names,
    each the object its module defines."""
    assert t_sel.strategy_names() == j_sel.strategy_names()
    assert all(callable(t_sel.get_strategy(n))
               for n in t_sel.strategy_names())

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")} - {
            "accountant", "schedule"}

    names = public(j_privacy)
    assert len(names) == 22 and public(t_privacy) == names
    for n in names:
        home = (t_privacy.accountant if hasattr(t_privacy.accountant, n)
                else t_privacy.schedule)
        assert getattr(t_privacy, n) is getattr(home, n)


def test_dp_clip_noise_in_place_is_the_same_row():
    """The serial round noises its flat update row where it lies
    (``dp_clip_noise(..., out=flat)``): bitwise the result out of place,
    written into the row given, one σ or one a row."""
    from repro_torch.kernels import dp_clip_noise as t_dpk
    from repro_torch.kernels import ops as t_ops

    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal(1001).astype(np.float32))
    nz = torch.as_tensor(rng.standard_normal(1001).astype(np.float32))
    want, norm = t_ops.dp_clip_noise(x, nz, 10.0, 0.7)
    row = x.clone()
    got, got_norm = t_ops.dp_clip_noise(row, nz, 10.0, 0.7, out=row)
    assert got.data_ptr() == row.data_ptr()
    assert torch.equal(got, want) and torch.equal(got_norm, norm)
    rows, noise = x.view(7, 143), nz.view(7, 143)
    scale, sigma = torch.rand(7), torch.rand(7)
    want = t_dpk.scale_noise_rows(rows, noise, scale, sigma)
    into = rows.clone()
    assert torch.equal(t_dpk.scale_noise_rows(into, noise, scale, sigma,
                                              out=into), want)
    assert torch.equal(into, want)
