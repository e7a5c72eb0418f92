"""The LM head's f32 logits on the bf16 tensor cores
(``repro_torch.models.layers``: ``split3``, ``head_grads``,
``HeadProduct``, ``logits_f32``).

On the CPU, where ``aten::mm.dtype`` has no kernel, ``mm_f32`` sums the
same exact bf16 products in an f32 GEMM, so the product's maths (the
three-term split, the blocks of vocab columns, the stacked GEMM of dW, the
transposes of a tied table, the one bf16 rounding of each gradient) is
held here against f64 and against the plain f32 path that the CPU keeps.
The ``card`` test holds the tensor-core GEMMs themselves at granite-3-8b's
head shapes: ``python -m pytest -q -m card tests/test_torch_head_gemm.py``
on a machine with a CUDA card.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

#: Max error against f64 allowed of the split product, over the plain f32
#: path's own: the two sum the same exact products in other orders.
F64_MULT = 2.0


def _wide_f32(n: int, lo: int, hi: int, seed: int) -> torch.Tensor:
    """``n`` f32 values with random 24-bit significands, both signs and
    exponents uniform in [lo, hi], and a run of +0 and −0."""
    g = torch.Generator().manual_seed(seed)
    mant = torch.randint(0, 1 << 23, (n,), generator=g).double()
    sig = 1.0 + mant / (1 << 23)
    exp = torch.randint(lo, hi + 1, (n,), generator=g).double()
    sign = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0).double()
    v = (sign * sig * torch.exp2(exp)).float()
    v[:64] = 0.0
    v[64:128] = -0.0
    return v


def _operands(tied: bool, n: int = 192, d: int = 256, v: int = 1000,
              seed: int = 0):
    """bf16 hidden states, the head (a tied [V, d] table or a [d, V]
    matrix) and an f32 logits gradient: softmax minus one-hot over N, as
    the cross-entropy gives, plus a spread of magnitudes."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g).bfloat16()
    shape = (v, d) if tied else (d, v)
    w = (0.02 * torch.randn(shape, generator=g)).bfloat16()
    p = torch.softmax(3 * torch.randn(n, v, generator=g), dim=-1)
    p[torch.arange(n), torch.randint(0, v, (n,), generator=g)] -= 1.0
    dl = p / n + 1e-6 * torch.randn(n, v, generator=g)
    return x, w, dl


def _err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.double() - ref).abs().max())


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["wide", "edges"])
def test_split3_exact(case):
    """hi + mid + lo is g, bitwise, in f64 and summed in f32, and each
    term is a bf16 value."""
    if case == "wide":
        g = _wide_f32(1 << 20, -60, 20, seed=1)
    else:   # ties, powers of two, bf16's largest finite and f32 neighbours
        base = torch.tensor([1.0, 1.0 + 2.0 ** -8, 1.0 + 2.0 ** -16,
                             1.0 + 2.0 ** -8 + 2.0 ** -16, 2.0 ** -110,
                             3.3895313892515355e38, 1.0 - 2.0 ** -24,
                             2.0 ** 20 - 1.0, 0.1, 1.0 / 3.0],
                            dtype=torch.float64).float()
        g = torch.cat([base, -base, torch.nextafter(base, 2 * base),
                       torch.nextafter(-base, -2 * base)])
    t = L.split3(g)
    assert t.dtype == torch.bfloat16 and t.shape == (3,) + tuple(g.shape)
    f = t.float()
    assert torch.equal(f[0].double() + f[1].double() + f[2].double(),
                       g.double())
    assert torch.equal((f[0] + f[1]) + f[2], g)
    assert torch.equal(torch.signbit(g[g == 0]), torch.signbit(f[0][g == 0]))


# ---------------------------------------------------------------------------
# The product's maths against f64 and the plain path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split_elems,tc_k", [(1 << 26, 1024), (1 << 14, 64)],
                         ids=["whole", "pieces"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_head_grads_against_f64(tied, split_elems, tc_k, monkeypatch):
    """dx and dw within F64_MULT × the plain f32 path's own distance from
    f64; the forward bitwise the plain path in one GEMM, and within that
    bar in pieces.  "pieces": blocks of 1 << 14 elements (86 vocab
    columns, the last short) and GEMMs of at most 64 products of hi (d 256
    in 4 pieces)."""
    monkeypatch.setattr(L, "SPLIT_ELEMS", split_elems)
    monkeypatch.setattr(L, "TC_K", tc_k)
    x, w, dl = _operands(tied)
    wt = w.t() if tied else w
    plain = torch.matmul(x.float(), w.float().t() if tied else w.float())
    got = L.HeadProduct.apply(x, wt)
    if tc_k >= x.shape[1]:
        assert torch.equal(got, plain)
    ref = x.double() @ wt.double()
    assert _err(got, ref) <= F64_MULT * _err(plain, ref)

    dx, dw = L.head_grads(dl, x, wt, dtype=torch.float32)
    assert dw.shape == wt.shape and dw.stride() == wt.stride()
    gd, xd, wd = dl.double(), x.double(), wt.double()
    want_dx, want_dw = gd @ wd.t(), xd.t() @ gd
    plain_dx, plain_dw = dl @ wt.float().t(), x.float().t() @ dl
    for got, f32, ref in ((dx, plain_dx, want_dx), (dw, plain_dw, want_dw)):
        bar = F64_MULT * _err(f32, ref)
        assert 0 < _err(got, ref) <= bar, (_err(got, ref), bar)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_one_term_refused(tied):
    """The control: dlogits rounded once to bf16 (a lower precision) is
    refused by the bar the split passes."""
    x, w, dl = _operands(tied)
    wt = (w.t() if tied else w).float()
    one = dl.bfloat16().float()
    gd, xd, wd = dl.double(), x.double(), wt.double()
    for got, f32, ref in ((one @ wt.t(), dl @ wt.t(), gd @ wd.t()),
                          (x.float().t() @ one, x.float().t() @ dl,
                           xd.t() @ gd)):
        assert _err(got, ref) > 100 * F64_MULT * _err(f32, ref)


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of ``t`` (its exponent's)."""
    a = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _close_to_plain(got: torch.Tensor, want: torch.Tensor,
                    f32_err: float) -> None:
    """The bf16 ``got`` equals the plain path's ``want`` on ≥ 99.9 % of
    elements and is one bf16 ulp from it on the rest.  Where a sum cancels
    to far below its terms, the f32 sums' own error (``f32_err``: the
    plain path's max distance from f64; the split's is held to F64_MULT ×
    that) exceeds the ulp of the result, so the bar there is that ulp plus
    (1 + F64_MULT) × ``f32_err``."""
    same = got == want
    assert float(same.float().mean()) >= 0.999
    gap = (got.float() - want.float()).abs()
    ulp = _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    bar = ulp + (1 + F64_MULT) * f32_err
    assert bool((gap[~same] <= bar[~same]).all())


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_head_product_autograd(tied):
    """Through autograd: the bf16 grads are ``head_grads``' f32 rounded
    once, bitwise; a tied table's grad meets the embedding's after that
    rounding, as the plain path's does; against the plain path they agree
    on ≥ 99.9 % of elements and within one bf16 ulp elsewhere.  Counted
    once a forward and once a backward."""
    x, w, dl = _operands(tied, n=256)
    ids = torch.randint(0, 1000, (64,),
                        generator=torch.Generator().manual_seed(5))
    ge = torch.randn(64, 256, generator=torch.Generator().manual_seed(6))

    def run(product):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = (product(xr, wr.t() if tied else wr) * dl).sum()
        if tied:
            out = out + (F.embedding(ids, wr).float() * ge).sum()
        out.backward()
        return xr.grad, wr.grad

    L.reset_head_gemms()
    gx, gw = run(L.HeadProduct.apply)
    assert L.HEAD_GEMMS == {"forward": 1, "split_backward": 1}
    assert gx.dtype == gw.dtype == torch.bfloat16
    px, pw = run(lambda a, b: torch.matmul(a.float(), b.float()))
    dx, dw = L.head_grads(dl, x, w.t() if tied else w, dtype=torch.float32)
    assert torch.equal(gx, dx.bfloat16())
    if tied:
        emb = torch.zeros_like(w).index_add_(0, ids, ge.bfloat16())
        assert torch.equal(gw, dw.t().bfloat16() + emb)
    else:
        assert torch.equal(gw, dw.bfloat16())
    gd, xd, wd = dl.double(), x.double(), (w.t() if tied else w).double()
    _close_to_plain(gx, px, _err(dl @ wd.float().t(), gd @ wd.t()))
    _close_to_plain(gw, pw, _err(x.float().t() @ dl, xd.t() @ gd))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_logits_f32_cpu_is_plain(tied):
    """CPU operands keep the plain f32 path bitwise, grads included, and
    never reach the product."""
    x, w, dl = _operands(tied)
    L.reset_head_gemms()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = L.logits_f32(xr, wr, tied=tied)
    (out * dl).sum().backward()
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.matmul(xp.float(),
                        wp.float().t() if tied else wp.float())
    (want * dl).sum().backward()
    assert torch.equal(out, want)
    assert torch.equal(xr.grad, xp.grad) and torch.equal(wr.grad, wp.grad)
    assert L.HEAD_GEMMS == {"forward": 0, "split_backward": 0}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.card
def test_head_product_on_card():
    """At granite-3-8b's head (x [4,096, 4,096], table [49,408, 4,096]):
    forward logits no farther from f64 than the TF32-off f32 path; dx and
    dtable within F64_MULT × the f32 path's distance from f64, and after
    the bf16 rounding equal to the plain path's on ≥ 99.9 % of elements
    and within one bf16 ulp elsewhere; one forward and one split backward
    counted a training step of a bf16 model."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: aten::mm.dtype runs only there")
    from repro_torch.configs.granite_3_8b import smoke_config
    from repro_torch.core import rounds as t_rounds
    from repro_torch.device import resolve_device
    from repro_torch.models import model as t_model

    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, d, v = 4096, 4096, 49408
    x = torch.randn(n, d, generator=g, device=dev).bfloat16()
    table = (0.02 * torch.randn(v, d, generator=g, device=dev)).bfloat16()
    got = L.logits_f32(x, table, tied=True)
    plain = torch.matmul(x.float(), table.float().t())
    ref = x.double() @ table.double().t()
    readings = {"logits": (_err(got, ref), _err(plain, ref),
                           _err(got, plain.double()))}
    del ref
    assert readings["logits"][0] <= readings["logits"][1], readings

    p = torch.softmax(plain, dim=-1)
    del got, plain
    p[torch.arange(n, device=dev),
      torch.randint(0, v, (n,), generator=g, device=dev)] -= 1.0
    dl = p.div_(n)
    dx, dw = L.head_grads(dl, x, table.t(), dtype=torch.float32)
    plain_dx, plain_dw = dl @ table.float(), x.float().t() @ dl
    for got_g, f32, ref in ((dx, plain_dx, dl.double() @ table.double()),
                            (dw, plain_dw, x.double().t() @ dl.double())):
        f32_err, err = _err(f32, ref), _err(got_g, ref)
        readings["dx" if got_g is dx else "dtable"] = (err, f32_err)
        del ref
        assert err <= F64_MULT * f32_err, readings
        _close_to_plain(got_g.bfloat16(), f32.bfloat16(), f32_err)
    print("max |error| against f64 (split, f32 path[, split − f32]):",
          readings)
    del dx, dw, plain_dx, plain_dw, dl, p

    cfg = dataclasses.replace(smoke_config(), dtype="bfloat16")
    m = t_model.build(cfg)
    params = m.init(0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g, device=dev)
    L.reset_head_gemms()
    t_rounds.value_and_grad(lambda q, b: m.loss(q, b, remat="none"))(
        params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert L.HEAD_GEMMS == {"forward": 1, "split_backward": 1}
