"""The LM ``client_parallel`` round (``core/rounds.py`` ``make_parallel_round``
on a param tree) against the reference's ``make_parallel_round``.

Both sides run on the CPU in f32 from the same initial state (the
reference's, carried across with ``convert``), on the same batches (the
train CLI's builders at ``n`` clients) and on the reference's own draws:
``reference_draws`` rebuilds the 5-way split of ``state.rng``, the fault
process's ``fold_in(k_fail, 1..7)`` and, per client, ``split(k_dp, n)``
split again into one key a leaf, at the LM's leaf shapes.  Cases: the
granite and phi3.5-moe smoke LMs at ``grad_accum`` 1 and 2, with DP off
and with clipped DP at 1 and at 2 local steps, and the seamless smoke LM
with its ``frontend`` batch; 4 clients, 2 rounds, coherence scoring on.

Bars: masks and failures equal every round; without DP every value within
1e-5 (relative, and absolute of max(1, max|x|)); with DP the first round
within 1e-5 and the noised second within ``F64_MULT`` times the port's own
distance from its f64 run of the same rounds (the smoke config at
``dtype="float64"``, from the same state and draws: ``chip_smoke.py``'s
bar for mamba2's f32 layers), never under 1e-5.  After a round of clipped
noise the loss saturates (6.2 → 26–29) and the next round amplifies any
change of f32 order: the f64 run reads how far this round's f32 rounding
alone carries it.  An update norm is also allowed one half-ulp flip an
element at the round's largest parameter magnitude (Δ = p_final −
p_global cancels in f32): √P·2^-24·max|p|, ``tests/test_torch_train.py``'s
floor for the serial round's norms, read from the round's own input
params.  Every bar must stay under ``BAR_CEIL`` of max(1, max|x|): a round
so chaotic that its f32 rounding alone moves it further holds no
comparison, and fails rather than passing anything.  seamless's noised
round is therefore held at 1 local step: at 2 the port's own round moves
its update norms by 0.64 of max(1, |x|) and its params by 2.8e-2 when its
input state moves by 4.3e-8 (the reference's state before the round
against the port's own), so no bar under max|x| holds it there.  And
the detector route of ``make_parallel_round`` is bitwise the lane step,
as before the tree route existed.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.core import rounds as j_rounds

from repro_torch.configs.base import FLConfig
from repro_torch.core import rounds as t_rounds
from repro_torch.data.synthetic import make_federated
from repro_torch.data.synthetic import round_batches as t_round_batches
from repro_torch.launch import train as t_train
from repro_torch.models import model as t_model
from repro_torch.models.spec import get_model_spec, meta_for
from repro_torch.tree import tree_leaves, tree_map

from test_torch_parity import reference_draws
from test_torch_train import RTOL, _np, _serial_state
from test_torch_train_families import _cfgs, _diff, _lm, _round_values

torch.set_num_threads(1)

N, STEPS, BATCH, SEQ = 4, 2, 2, 16
F64_MULT = 4.0
BAR_CEIL = 0.25


def _fl(dp: bool, **extra):
    kw = dict(n_clients=N, clients_per_round=2, local_lr=0.005,
              dp_enabled=dp, dp_mode="clipped", dp_epsilon=50.0,
              dp_clip=10.0, failure_prob=0.05, **extra)
    return JFLConfig(**kw), FLConfig(**kw)


def _batches(cfg, fl, r: int, steps: int = STEPS):
    """Round ``r``'s batches ``[n, steps, batch, ...]`` by the train CLI's
    builder (frontend included) for both packages."""
    many = dataclasses.replace(fl, serial_clients_in_step=N,
                               local_steps_in_step=steps)
    data = t_train.round_batches(cfg, many, BATCH, SEQ, 300 + r)
    return ({k: jax.numpy.asarray(v) for k, v in data.items()},
            {k: torch.as_tensor(v) for k, v in data.items()})


class _F64(torch.overrides.TorchFunctionMode):
    """Under this mode the model's f32 pins (``Tensor.float``, as the moe
    router casts its input) give f64."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float:
            func = torch.Tensor.double
        return func(*args, **(kwargs or {}))


def _f64_step(arch: str, fl, grad_accum: int):
    """The port's round on the smoke config at ``dtype="float64"``."""
    tm = t_model.build(_cfgs(arch, "float64")[1])

    def loss(p, b):
        with _F64():
            return tm.loss(p, b, remat="none")

    return t_rounds.make_parallel_round(loss, fl, N, device="cpu",
                                        grad_accum=grad_accum, lm=True)


def _to_f64(tree):
    return tree_map(lambda t: t.double() if t.is_floating_point() else t,
                    tree)


def _run_parallel_rounds(arch: str, dp: bool, grad_accum: int,
                         rounds: int = 2, steps: int = STEPS, **extra):
    """``rounds`` rounds of both packages' parallel round at ``steps``
    local steps (``extra``: more FLConfig fields); returns the readings
    (name, err, bar) after asserting them."""
    jm, jp, tm, _ = _lm(arch)
    jfl, fl = _fl(dp, **extra)
    jstate = j_rounds.init_round_state(jp, jfl, jax.random.key(11),
                                       n_clients=N)
    tstate = _serial_state(jstate, fl)
    jstep = j_rounds.make_parallel_round(
        lambda p, b: jm.loss(p, b, remat="none"), jfl, N,
        grad_accum=grad_accum)
    tstep = t_rounds.make_parallel_round(
        lambda p, b: tm.loss(p, b, remat="none"), fl, N, device="cpu",
        grad_accum=grad_accum, lm=True)
    if dp:
        step64 = _f64_step(arch, fl, grad_accum)
        state64 = tstate._replace(params=_to_f64(tstate.params))
    shapes = [tuple(l.shape) for l in jax.tree.leaves(jp)]
    readings = []
    for r in range(rounds):
        jb, tb = _batches(tm.cfg, fl, r, steps)
        leaves = tree_leaves(tstate.params)
        norm_floor = (np.sqrt(sum(t.numel() for t in leaves)) * 2.0 ** -24
                      * max(float(t.abs().max()) for t in leaves))
        draws, _ = reference_draws(jstate.rng, N, steps, shapes)
        if not dp:
            draws = draws._replace(dp_noise=None)
        jstate, jmet = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb, draws=draws)
        np.testing.assert_array_equal(_np(tmet.sel_mask), _np(jmet.sel_mask))
        np.testing.assert_array_equal(_np(tmet.failed), _np(jmet.failed))
        assert float(tmet.sel_mask.sum()) > 0
        got = _round_values(tstate, tmet)
        gap = {}
        if dp:
            state64, met64 = step64(state64, _to_f64(tb), draws=draws)
            assert torch.equal(met64.sel_mask, tmet.sel_mask)
            if r > 0:
                gap = _diff(got, _round_values(state64, met64))
        for k, err in _diff(got, _round_values(jstate, jmet)).items():
            bar = max(RTOL, F64_MULT * gap.get(k, 0.0))
            if k == "update_norms" and r > 0:
                bar = max(bar, norm_floor)
            readings.append((f"round {r} {k}", err, bar))
        assert tstate.round_idx == r + 1
    for what, err, bar in readings:
        assert bar < BAR_CEIL, (what, err, bar, readings)
        assert err <= bar, (what, err, bar, readings)
    return readings


@pytest.mark.parametrize("dp,steps", [(False, 2), (True, 1), (True, 2)],
                         ids=["no_dp", "clipped_dp_1step", "clipped_dp"])
@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ["granite_3_8b", "phi3p5_moe_42b"])
def test_parallel_round_lm_matches_reference(arch, grad_accum, dp, steps):
    """granite (dense) and phi3.5-moe (top-2 over 4 experts), each
    client's local steps in ``grad_accum`` microbatches, 2 rounds."""
    readings = _run_parallel_rounds(arch, dp, grad_accum, steps=steps)
    assert len(readings) == 2 * 8


@pytest.mark.parametrize("dp,steps", [(False, 2), (True, 1)],
                         ids=["no_dp", "clipped_dp"])
def test_parallel_round_seamless_frontend_matches_reference(dp, steps):
    """seamless (encoder-decoder) with its ``frontend`` frames [n, steps,
    batch, enc_seq, d_model] in every client's batch; its noised second
    round at 1 local step (the module docstring says why)."""
    _, _, tm, _ = _lm("seamless_m4t_large_v2")
    jb, _ = _batches(tm.cfg, _fl(dp)[1], 0, steps)
    assert jb["frontend"].shape[:3] == (N, steps, BATCH)
    _run_parallel_rounds("seamless_m4t_large_v2", dp, 1, steps=steps)


@pytest.mark.parametrize("plan,extra", [
    ("buffered_async", {"async_buffer": 1.0}),
    ("hierarchical", {"hierarchy_edges": 3})])
def test_parallel_round_lm_plans_match_reference(plan, extra):
    """The other plans of the family on the granite smoke LM: the
    staleness-weighted mean (code 1) and the edges' then the cloud's mean
    (code 2), each as per-client weights of one sum over the rows."""
    readings = _run_parallel_rounds("granite_3_8b", False, 1, plan=plan,
                                    **extra)
    assert len(readings) == 2 * 8


def test_tree_round_draws_itself_and_rejects_misuse():
    """Without draws the round draws from the state's generator (the DP
    noise last, once the rows exist): the same seed gives the same round,
    bitwise; the detector route (``lm=False``) refuses ``grad_accum`` and
    ``delta_constraint`` when it is built."""
    _, _, tm, tp = _lm("granite_3_8b")
    _, fl = _fl(True)
    step = t_rounds.make_parallel_round(
        lambda p, b: tm.loss(p, b, remat="none"), fl, N, device="cpu",
        lm=True)
    _, tb = _batches(tm.cfg, fl, 0)
    outs = []
    for _ in range(2):
        state = t_rounds.init_serial_state(
            tp, fl, torch.Generator().manual_seed(4), n_clients=N)
        outs.append(step(state, tb))
    (s0, m0), (s1, m1) = outs
    for f in m0._fields:
        assert torch.equal(getattr(m0, f), getattr(m1, f)), f
    for a, b in zip(tree_leaves(s0.params),
                    tree_leaves(s1.params)):
        assert torch.equal(a, b)
    assert float(m0.update_norms.max()) > 0
    fed = make_federated(0, "unsw", n_samples=200, n_clients=N)
    spec = get_model_spec("mlp", meta_for(fed, hidden=8))
    for kw in ({"grad_accum": 2}, {"delta_constraint": object()}):
        with pytest.raises(ValueError, match="lm=True"):
            t_rounds.make_parallel_round(spec.loss, fl, N, device="cpu",
                                         **kw)


@pytest.mark.parametrize("plan", ["client_parallel", "buffered_async",
                                  "hierarchical"])
def test_detector_route_is_the_lane_step(plan):
    """The detector route of ``make_parallel_round`` is bitwise the lane
    step at L = 1, and lane 0 of a two-lane step on the same draws (its
    second lane another seed), for each plan code: the tree route and the
    helpers it shares with the lane step change nothing on the detector
    path."""
    fed = make_federated(1, "unsw", n_samples=400, n_clients=6)
    fl = FLConfig(n_clients=6, clients_per_round=3, local_epochs=2,
                  local_batch=8, dp_enabled=True, dp_mode="clipped",
                  dp_epsilon=50.0, dp_clip=5.0, failure_prob=0.2,
                  plan=plan, hierarchy_edges=2,
                  async_buffer=2.0 if plan == "buffered_async" else 0.0)
    spec = get_model_spec("mlp", meta_for(fed, hidden=16))
    sizes = fed.data_sizes()
    kw = dict(n_clients=6, data_size=torch.as_tensor(sizes / sizes.mean()),
              data_quality=torch.as_tensor(fed.label_entropy()))
    states = []
    for seed in (3, 4):
        gen = torch.Generator().manual_seed(seed)
        states.append(t_rounds.init_round_state(spec.init(gen), fl, gen,
                                                **kw))
    rng = np.random.default_rng(2)
    one = t_rounds.make_parallel_round(spec.loss, fl, 6, device="cpu")
    lane = t_rounds.make_lane_round(spec.loss, fl, 6, device="cpu")
    pr = t_rounds.fl_params(fl)
    n_p = sum(t.numel() for t in tree_leaves(states[0].params))
    s_one, s_two = states[0], t_rounds.stack_states(states)
    for _ in range(3):
        b = {k: torch.as_tensor(v) for k, v in
             t_round_batches(rng, fed, 2, 8).items()}
        d = t_rounds.draw_round([torch.Generator().manual_seed(9),
                                 torch.Generator().manual_seed(10)],
                                6, 2, n_p, fl.selection)
        s_one, m_one = one(s_one, b, draws=d.lane(0))
        s_two, m_two = lane(s_two, {k: torch.stack([v, v]) for k, v in
                                    b.items()}, pr, d)
        for f in m_one._fields:
            assert torch.equal(getattr(m_one, f), getattr(m_two, f)[0]), f
        for a, b2 in zip(tree_leaves(s_one.params),
                         tree_leaves(s_two.params)):
            assert torch.equal(a, b2[0])
        for a, b2 in zip(s_one.util, s_two.util):
            assert torch.equal(a, b2[0])
