"""An expert layer that holds a share of its router's experts
(``ModelConfig.router_experts``; ``models/moe.py``), against the plain
reference the benchmark judges the program by (``perfbench/reference/
lm.py`` ``moe``), on seeded random f32 weights at a small size: d 64, 4
experts held of the router's 8, top-2, 32 tokens a sequence.

- the share's output, aux loss and the weights', router's and input's
  gradients equal the reference share's, on both dispatches;
- two shares, the second the first share of a model whose router columns
  put experts 4–7 first, sum to the uncut reference layer, and each
  gives the whole layer's aux loss;
- a layer that states it holds all its experts is bitwise the layer
  with the key unset, and so are the smoke presets' models;
- ``_choose`` returns global expert ids and runs once a layer call;
- the ``moe`` counters count each call's shapes.

Tolerances: f32 at rtol 1e-5 and an absolute 1e-6 of the compared
tensor's largest magnitude; the two sides sum the same terms in other
orders (einsums, ``index_add``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.reference import lm as ref_lm  # noqa: E402

from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.obs import STATS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

IMPLS = ("einsum", "scatter")
D, F, HELD, ROUTED, K, B, S = 64, 96, 4, 8, 2, 2, 32
WEIGHTS = ("router", "wi", "wg", "wo")


@pytest.fixture(autouse=True)
def _einsum_dispatch():
    """Every test leaves the shipped dispatch in place."""
    yield
    t_tr.MOE_IMPL[0] = "einsum"


def _cfg(held: int = HELD, routed: int = ROUTED, cf: float = 1.25,
         **kw) -> t_base.ModelConfig:
    return t_base.ModelConfig(
        name="moe-share", family="moe", n_layers=1, d_model=D, n_heads=4,
        n_kv_heads=2, d_ff=F, vocab_size=128, n_experts=held,
        router_experts=routed, experts_per_token=K, capacity_factor=cf,
        dtype="float32", **kw)


def _ref_model(cfg) -> dict:
    """The reference's ``model`` dict of ``cfg``'s MoE layer."""
    return {"n_experts": cfg.n_experts,
            "router_experts": cfg.resolved_router_experts,
            "experts_per_token": cfg.experts_per_token,
            "capacity_factor": cfg.capacity_factor,
            "router_aux_coef": cfg.router_aux_coef}


def _weights(seed: int = 0, experts: int = ROUTED) -> dict:
    """Every expert of the uncut layer and its router, f32."""
    g = torch.Generator().manual_seed(seed)
    return {"router": torch.randn(D, ROUTED, generator=g) / math.sqrt(D),
            "wi": torch.randn(experts, D, F, generator=g) / math.sqrt(D),
            "wg": torch.randn(experts, D, F, generator=g) / math.sqrt(D),
            "wo": torch.randn(experts, F, D, generator=g) / math.sqrt(F)}


def _share(w: dict, first: int, held: int = HELD, order=None) -> dict:
    """Experts ``[first, first + held)`` of ``w``, under a router whose
    columns are ``order`` (default: as they are)."""
    router = w["router"] if order is None else w["router"][:, order]
    return {"router": router,
            **{k: w[k][first:first + held] for k in ("wi", "wg", "wo")}}


def _x(seed: int = 1) -> torch.Tensor:
    return torch.randn(B, S, D, generator=torch.Generator().manual_seed(seed))


def _probe(seed: int = 2) -> torch.Tensor:
    """A fixed cotangent for the output, so every output element moves the
    loss."""
    return torch.randn(B, S, D, generator=torch.Generator().manual_seed(seed))


def _close(got, want):
    tol = 1e-6 * max(float(want.abs().max()), 1e-30)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)


def _program(params, x, cfg, impl):
    """(out, aux, grads {name: grad}) of the program's layer."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xr = x.clone().requires_grad_(True)
    out, aux = t_moe.moe_mlp(leaves, xr, cfg, impl=impl)
    ((out * _probe()).sum() + aux).backward()
    grads = {k: v.grad for k, v in leaves.items()}
    grads["x"] = xr.grad
    return out.detach(), aux.detach(), grads


def _reference(params, x, cfg):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xr = x.clone().requires_grad_(True)
    out, aux, taken, _, _ = ref_lm.moe(xr, leaves, _ref_model(cfg),
                                       torch.matmul)
    ((out * _probe()).sum() + aux).backward()
    grads = {k: v.grad for k, v in leaves.items()}
    grads["x"] = xr.grad
    return out.detach(), aux.detach(), grads, taken


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("impl", IMPLS)
def test_share_matches_the_reference_share(impl, cf):
    """The program's share of 4 of 8 experts: output, aux loss and every
    gradient equal to the reference's share, at a capacity the tokens
    fill (1.25: 10 slots an expert for 64 choices over 8) and one they
    overflow (0.5: 4 slots); some choices fall on experts not held."""
    cfg = _cfg(cf=cf)
    params = _share(_weights(), 0)
    x = _x()
    out, aux, grads = _program(params, x, cfg, impl)
    r_out, r_aux, r_grads, taken = _reference(params, x, cfg)
    assert any(bool((t >= HELD).any()) for t in taken)
    _close(out, r_out)
    _close(aux, r_aux)
    assert set(grads) == set(r_grads) == set(WEIGHTS) | {"x"}
    for k in grads:
        _close(grads[k], r_grads[k])


@pytest.mark.parametrize("impl", IMPLS)
def test_two_shares_sum_to_the_uncut_layer(impl):
    """Experts 0–3 and, as the first share of a model whose router puts
    experts 4–7 first, experts 4–7: their outputs sum to the uncut
    reference layer's (all 8 held), and each share's aux loss is the
    whole layer's, counted once."""
    w = _weights()
    x = _x()
    cfg = _cfg()
    order = list(range(HELD, ROUTED)) + list(range(HELD))
    out_a, aux_a, _ = _program(_share(w, 0), x, cfg, impl)
    out_b, aux_b, _ = _program(_share(w, HELD, order=order), x, cfg, impl)
    whole, whole_aux, _, _ = _reference(w, x, _cfg(held=ROUTED))
    _close(out_a + out_b, whole)
    _close(aux_a, whole_aux)
    _close(aux_b, whole_aux)


def _model_loss(cfg, impl: str, remat: str = "none"):
    t_tr.MOE_IMPL[0] = impl
    m = t_model.build(cfg)
    params = m.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, grads = t_rounds.value_and_grad(
        lambda p, b: m.loss(p, b, remat=remat))(params, batch)
    return params, loss, grads


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["phi3p5_moe_42b", "llama4_maverick_400b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_share_is_bitwise_the_key_unset(arch, dtype, impl):
    """``router_experts == n_experts`` is the layer with the key unset,
    bit for bit: the smoke presets' weights, loss and every gradient."""
    unset = dataclasses.replace(t_base.get_arch(arch, smoke=True),
                                dtype=dtype)
    assert unset.router_experts == 0
    whole = dataclasses.replace(unset, router_experts=unset.n_experts)
    p0, l0, g0 = _model_loss(unset, impl)
    p1, l1, g1 = _model_loss(whole, impl)
    _bitwise(tree_leaves(p0), tree_leaves(p1))
    _bitwise([l0] + tree_leaves(g0), [l1] + tree_leaves(g1))


@pytest.mark.parametrize("impl", IMPLS)
def test_whole_share_layer_is_bitwise_the_key_unset(impl):
    w = _weights(experts=ROUTED)
    x = _x()
    a = _program(w, x, _cfg(held=ROUTED, routed=0), impl)
    b = _program(w, x, _cfg(held=ROUTED, routed=ROUTED), impl)
    _bitwise([a[0], a[1]] + [a[2][k] for k in sorted(a[2])],
             [b[0], b[1]] + [b[2][k] for k in sorted(b[2])])


@pytest.mark.parametrize("impl", IMPLS)
def test_choose_gives_global_ids_once_a_layer_call(impl, monkeypatch):
    """``_choose`` (which the benchmark's ``ExpertChoices`` records) runs
    once a layer call on either dispatch, and its choices are expert ids
    of the router, ``[0, router_experts)``, experts not held among
    them."""
    calls = []
    real = t_moe._choose

    def spy(router_w, x, cfg):
        out = real(router_w, x, cfg)
        calls.append(out[1])
        return out

    monkeypatch.setattr(t_moe, "_choose", spy)
    cfg = _cfg()
    t_moe.moe_mlp(_share(_weights(), 0), _x(), cfg, impl=impl)
    assert len(calls) == 1 and len(calls[0]) == K
    ids = torch.stack(calls[0])
    assert int(ids.min()) >= 0 and int(ids.max()) < ROUTED
    assert bool((ids >= HELD).any())
    calls.clear()
    lm = dataclasses.replace(cfg, n_layers=3)
    _model_loss(lm, impl)
    assert len(calls) == lm.n_layers


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_counters_count_one_step_from_shapes(impl):
    """One training step of a 3-layer share: ``calls`` a layer, ``routed``
    b·s·k and ``expert_rows`` held experts × b × capacity a layer."""
    cfg = dataclasses.replace(_cfg(), n_layers=3)
    with STATS.delta("moe") as d:
        _model_loss(cfg, impl)
    c = t_moe._capacity(cfg, 16)
    assert c == max(int(1.25 * 16 * K / ROUTED), K)
    assert d == {"calls": 3, "routed": 3 * 2 * 16 * K,
                 "expert_rows": 3 * HELD * 2 * c}


def test_share_config_is_checked_and_counted():
    """A share holds at most the router's experts; ``param_count`` counts
    the router at its width and the experts held, ``active_param_count``
    the held share of the top-k on average; a share refuses a sharded
    step."""
    with pytest.raises(ValueError, match="held"):
        _cfg(held=ROUTED + 1)
    cfg = _cfg()
    whole = _cfg(held=ROUTED)
    expert = 3 * D * F
    assert cfg.resolved_router_experts == whole.resolved_router_experts == 8
    assert whole.param_count() - cfg.param_count() == (ROUTED - HELD) * expert
    assert (whole.param_count() - whole.active_param_count()
            == (ROUTED - K) * expert)
    # a share holds half the experts, so a token uses one of them, on average
    assert (cfg.param_count() - cfg.active_param_count()
            == (HELD - K * HELD // ROUTED) * expert)
    assert dataclasses.replace(cfg, router_experts=0).resolved_router_experts == HELD


def test_chip_smoke_training_counts_are_param_count():
    """``chip_smoke.py`` phase 20 holds each family's ``param_count`` at
    its first training cut to ``TF_PARAMS``; the MoE's includes its
    routers."""
    spec = importlib.util.spec_from_file_location("_chip_smoke_tf",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for arch in cs.TF_FAMILIES:
        cfg = cs.tf_cfg(arch, cs.TF_CUTS[arch][0])
        assert cfg.param_count() == cs.TF_PARAMS[arch], arch
    moe = cs.tf_cfg(cs.FAM_MOE, cs.TF_CUTS[cs.FAM_MOE][0])
    # the reference's count there, which leaves the routers out
    assert (cs.TF_PARAMS[cs.FAM_MOE] - 2_863_136_768
            == moe.n_layers * moe.d_model * moe.resolved_router_experts)


def test_share_refuses_a_sharded_step(monkeypatch):
    monkeypatch.setattr(t_moe, "is_dtensor", lambda x: True)
    with pytest.raises(ValueError, match="one device"):
        t_moe.moe_mlp(_share(_weights(), 0), _x(), _cfg())
