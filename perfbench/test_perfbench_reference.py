"""The plain reference against the program on tiny float32 cuts on the
CPU: the loss of the same weights and tokens, one training round of each
family through the harness, and one prefill; and the reference's MoE on
its own: a share of the experts against the whole layer, and replayed
expert choices."""
from __future__ import annotations

import pytest
import torch

from perfbench.harness import cells
from perfbench.reference import layout
from perfbench.reference import lm as ref_lm
from perfbench.run import run_cell

FL = {"clients": 4, "slots": 2, "clients_per_round": 2, "local_steps": 2,
      "local_lr": 0.05, "server_lr": 1.0, "dp_epsilon": 50.0, "dp_delta": 1e-5,
      "dp_clip": 10.0, "failure_prob": 0.05, "ckpt_every_steps": 2, "k_min": 2,
      "k_tol": 0.001, "k_patience": 3.0}


TRAIN_NUMBERS = ("loss1", "update_norm1", "grad1", "change", "agg1",
                 "update_scale")


def tiny_model(family: str = "dense", dtype: str = "float32",
               d_model: int = 64, vocab: int = 300) -> dict:
    m = {"name": f"tiny-{family}", "family": family, "n_layers": 2,
         "d_model": d_model, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": d_model // 4, "d_ff": d_model * 3 // 2,
         "vocab_size": vocab, "act": "swiglu",
         "tie_embeddings": family == "dense", "rope_theta": 10000.0,
         "norm_eps": 1e-6, "dtype": dtype}
    if family == "moe":
        m.update(n_experts=4, experts_per_token=2, capacity_factor=1.25,
                 router_aux_coef=0.01)
    return m


def tiny_cell(kind: str, family: str = "dense", dtype: str = "float32",
              limits: dict = None, **fl) -> cells.Cell:
    """A cell at a size the CPU runs in a second: two layers of width 64;
    ``fl`` overrides the training settings."""
    if kind == "fl_rounds":
        t = {"kind": kind, "fl": dict(FL, **fl), "batch": 2, "seq": 16,
             "tokens": {"dist": "zipf", "exponent": 1.0}, "pool_rounds": 3,
             "variate_rounds": 5, "check_rounds": 2}
        names = TRAIN_NUMBERS + (("route_gap",) if family == "moe" else ())
    else:
        t = {"kind": kind, "batch": 2, "lengths": [8, 16], "pool_batches": 1,
             "tokens": {"dist": "uniform"}}
        names = ("logit_gap",)
    lim = limits or {"numbers": {k: {"limit": 1e-3} for k in names}}
    return cells.Cell("tiny", 1, {"model": tiny_model(family, dtype)}, t, lim,
                      [], [])


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_loss_matches_program(family):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import build
    m = tiny_model(family)
    lv = layout.leaves(m)
    w = layout.make_weights(lv, 7, "cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, m["vocab_size"], (2, 17), generator=gen)
    prog = build(ModelConfig(**m)).loss(layout.as_tree(w),
                                        {"tokens": tokens[:, :-1],
                                         "labels": tokens[:, 1:]},
                                        remat="none")
    ref = ref_lm.loss(w, m, tokens[:, :-1], tokens[:, 1:], torch.matmul)
    assert abs(float(prog) - float(ref)) < 1e-5 * abs(float(ref))


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_train_round_matches_program(family):
    """A round of each family matches; a dense cell's numbers are the six
    of ``TRAIN_NUMBERS``, a MoE's add ``route_gap``."""
    res = run_cell(tiny_cell("fl_rounds", family), 2**31 + 11, 0.0, False,
                   "cpu")
    assert res.attempted == 2
    want = TRAIN_NUMBERS + (("route_gap",) if family == "moe" else ())
    assert list(res.checks) == list(want)
    for name, (value, _) in res.checks.items():
        assert value < 1e-3, (name, value)


def _moe_layer(seed: int = 4):
    """The tiny MoE's first layer: its f32 weights and an input."""
    m = tiny_model("moe")
    w = layout.make_weights(layout.leaves(m), seed, "cpu")
    p = {name: w[("stack", 0, "b0", "moe", name)][0].float()
         for name in ("router", "wi", "wg", "wo")}
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(2, 16, m["d_model"], generator=gen)
    return m, p, h


def test_expert_share_is_its_part_of_the_layer():
    """A reference holding experts [0, 2) of the 4 routed (top-2) gives
    the whole layer's output with experts 2 and 3's ``wo`` zeroed: the
    same routing, capacity, renormalisation over every kept choice and aux
    loss; its held experts' weight gradients are the whole layer's slices
    of them."""
    m, p, h = _moe_layer()
    r = torch.randn(h.shape, generator=torch.Generator().manual_seed(1))

    def run(model, params):
        params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        out, aux, taken, _, _ = ref_lm.moe(h, params, model, torch.matmul)
        grads = torch.autograd.grad((out * r).sum(),
                                    [params[k] for k in ("wi", "wg", "wo")])
        return out.detach(), aux.detach(), taken, grads

    share = dict(m, n_experts=2, router_experts=4)
    lv = {x.path[-1]: x.shape for x in layout.leaves(share)
          if x.path[-2] == "moe"}
    assert lv["router"][-1] == 4 and lv["wi"][:2] == (2, 2)
    o, a, t, g = run(share, {k: (v if k == "router" else v[:2])
                             for k, v in p.items()})
    zeroed = dict(p, wo=torch.cat([p["wo"][:2], torch.zeros_like(p["wo"][2:])]))
    out, aux, taken, _ = run(m, zeroed)
    assert torch.equal(o, out) and torch.equal(a, aux)
    assert all(torch.equal(x, y) for x, y in zip(t, taken))
    # every expert's tokens are kept somewhere: the layer's other half
    # carries weight, so the share's renormalisation is not over its own
    assert any(bool((x >= 2).any()) for x in taken)
    _, _, _, grads = run(m, p)
    for gs, gw in zip(g, grads):
        torch.testing.assert_close(gs, gw[:2], rtol=1e-6, atol=0.0)


def test_whole_share_keys_are_the_default():
    """A MoE that states it holds all its experts (``router_experts`` the
    experts) computes bitwise what one without the key does: the loss and
    every gradient."""
    m = tiny_model("moe")
    w = layout.make_weights(layout.leaves(m), 7, "cpu")
    tokens = torch.randint(0, m["vocab_size"], (2, 17),
                           generator=torch.Generator().manual_seed(3))

    def grads(model):
        p32 = ref_lm.f32_leaves(w)
        loss = ref_lm.loss(p32, model, tokens[:, :-1], tokens[:, 1:],
                           torch.matmul)
        return [loss] + list(torch.autograd.grad(loss, list(p32.values())))

    a = grads(m)
    b = grads(dict(m, router_experts=m["n_experts"]))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_replaying_its_own_choices_is_bitwise():
    """The reference following its own recorded expert choices computes
    its loss and gradients bitwise, at a route gap of 0; moving each
    token's last choice to the next-best expert reads the gap between
    them."""
    m = tiny_model("moe")
    w = layout.make_weights(layout.leaves(m), 8, "cpu")
    tokens = torch.randint(0, m["vocab_size"], (2, 17),
                           generator=torch.Generator().manual_seed(5))

    def run(route):
        p32 = ref_lm.f32_leaves(w)
        loss = ref_lm.loss(p32, m, tokens[:, :-1], tokens[:, 1:],
                           torch.matmul, route)
        return [loss] + list(torch.autograd.grad(loss, list(p32.values())))

    own = ref_lm.Route()
    first = run(own)
    again = ref_lm.Route(replay=own.taken)
    assert all(torch.equal(x, y) for x, y in zip(first, run(again)))
    assert again.gap == 0.0 and again.flips == 0
    assert again.choices == m["n_layers"] * 2 * 16 * m["experts_per_token"]
    shifted = ref_lm.Route(shift=True)
    run(shifted)
    # the first layer's input is the same: its first choices agree, and
    # every last choice moved
    assert torch.equal(shifted.taken[0][0], own.taken[0][0])
    assert bool((shifted.taken[0][1] != own.taken[0][1]).all())
    judged = ref_lm.Route(replay=shifted.taken)
    run(judged)
    assert judged.gap > 1e-2 and judged.flips == m["n_layers"] * 2 * 16
    half = ref_lm.Route(replay=[[c[:1] for c in t] for t in own.taken])
    run(half)
    assert half.gap == float("inf")


def test_prefill_matches_program():
    res = run_cell(tiny_cell("prefill_closed"), 2**31 + 12, 0.0, False, "cpu")
    assert res.checks["logit_gap"][0] == 0.0
    assert res.attempted == 2


def test_weights_repeat_and_differ_by_seed():
    lv = layout.leaves(tiny_model())
    a, b = (layout.make_weights(lv, s, "cpu") for s in (5, 5))
    c = layout.make_weights(lv, 6, "cpu")
    key = ("stack", 0, "b0", "attn", "wq", "w")
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    assert torch.all(a[("final_ln", "scale")] == 1)


@pytest.mark.parametrize("failure_prob", [0.0, 1.0])
def test_reference_judges_its_own_states_sound(failure_prob):
    """The reference judging its own stored states reads no gap: ``agg1``
    0 and every round's ``scale`` 1, also where every slot fails before
    its first checkpoint and no round moves the weights."""
    from perfbench.harness import check, traffic
    from perfbench.reference import fl as ref_fl
    cell = tiny_cell("fl_rounds", "dense", "bfloat16")
    m, t = cell.config["model"], cell.traffic
    f = dict(t["fl"], failure_prob=failure_prob)
    lv = layout.leaves(m)
    pool = traffic.fl_pool(t, m["vocab_size"], 5, "cpu")

    def follow(**kw):
        return ref_fl.run_rounds(
            m, f, lv, layout.make_weights(lv, 5, "cpu"),
            batch=lambda r: (pool.batch(r)["tokens"], pool.batch(r)["labels"]),
            variates=pool.variates, noise_seed=9, rounds=t["check_rounds"],
            **kw)

    first = follow(keep=True)
    ref = follow(judge={"self": first["states"]})
    numbers = check.train_numbers(first, ref, "self")
    assert numbers["agg1"] == 0.0 and numbers["update_scale"] == 0.0
    assert ref["judged"]["self"]["scale"] == [1.0] * t["check_rounds"]
