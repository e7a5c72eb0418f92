"""The plain reference against the program on tiny float32 cuts on the
CPU: the loss of the same weights and tokens, one training round of each
family through the harness, and one prefill."""
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
        names = TRAIN_NUMBERS
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
    res = run_cell(tiny_cell("fl_rounds", family), 2**31 + 11, 0.0, False,
                   "cpu")
    assert res.attempted == 2
    for name, (value, _) in res.checks.items():
        assert value < 1e-3, (name, value)


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
