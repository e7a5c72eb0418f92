"""Each operation and byte count against a count by hand at one shape,
and the per-layer readers on a trace built by hand."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import counts
from perfbench.harness import cells, trace

M = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 4,
     "n_kv_heads": 2, "head_dim": 2, "d_ff": 16, "vocab_size": 10}
MOE = dict(M, family="moe", n_experts=4, experts_per_token=2)


def test_matmul_params_by_hand():
    # attention 8·8 + 2·8·4 + 8·8 = 192; MLP 3·8·16 = 384; unembed 80
    assert counts.matmul_params(M) == 2 * (192 + 384) + 80
    assert counts.matmul_params(M, unembed=False) == 2 * (192 + 384)
    # MoE: 2 experts of 384 and the router's 8·4
    assert counts.matmul_params(MOE) == 2 * (192 + 768 + 32) + 80
    # 4 of 8 routed experts held: 2 · 4/8 = 1 expert a token, router 8·8
    share = dict(MOE, router_experts=8)
    assert counts.matmul_params(share) == 2 * (192 + 384 + 64) + 80


def test_attention_flops_by_hand():
    # seq 3: 6 causal pairs; 2·2 FLOPs · 4 heads · head dim 2 a pair
    assert counts.attention_flops(M, batch=1, seq=3) == 4 * 4 * 2 * 6 * 2
    assert counts.k3_flops(M, batch=2, seq=3) == 4 * 4 * 2 * 6 * 2


def test_train_and_prefill_flops_by_hand():
    n, attn = counts.matmul_params(M), counts.attention_flops(M, 2, 3)
    assert counts.train_step_flops(M, 2, 3) == 6 * n * 6 + 3 * attn
    body = counts.matmul_params(M, unembed=False)
    assert counts.prefill_flops(M, 2, 3) == 2 * body * 6 + 2 * 8 * 10 * 2 + attn


def test_k1_and_k3_bytes_by_hand():
    # sumsq: row 4P + its sum 4; scale_noise: row, noise, scale, out
    assert counts.k1_bytes(10) == 44 + 40 + 40 + 4 + 40
    # q 4 heads, k and v 2, out 4: 12 head rows of 2 bf16 values a token
    assert counts.k3_bytes(M, batch=1, seq=3) == 3 * 2 * 2 * 12
    assert counts.k3_bound_s(M, 1, 3) == max(
        counts.k3_bytes(M, 1, 3) / counts.PEAK_HBM_BYTES,
        counts.k3_flops(M, 1, 3) / counts.PEAK_BF16_FLOPS)


def test_granite_k3_bound_matches_the_kernel_table():
    # the table of kernels: K3 at [1, 4096, 32 | 8, 128] is bound by its
    # operations at 139.00 us
    g = {"n_heads": 32, "n_kv_heads": 8, "head_dim": 128, "d_model": 4096}
    assert counts.k3_bound_s(g, 1, 4096) * 1e6 == pytest.approx(139.00, abs=0.01)
    # and K1's rows at P = 1,796,280,320: 2,144.8 + 6,434.4 us
    p = 1_796_280_320
    assert counts.k1_bytes(p) / counts.PEAK_HBM_BYTES * 1e6 == pytest.approx(
        2144.8 + 6434.4, abs=0.2)


def _trace():
    ops = [(0.0, 1.0, "void sumsq_rows_split_kernel"),
           (0.5, 2.0, "sm90_xmma_gemm_bf16bf16"),
           (3.0, 4.0, "flash_attention_mma_kernel<128>"),
           (4.0, 6.0, "scale_noise_rows_kernel")]
    ann = {"local_train": [(0.0, 2.5)], "dp_privatize": [(3.5, 10.0)]}
    host = [(0.0, 10.0, "bench.window", 1), (2.0, 3.0, "aten::item", 1)]
    return trace.Trace(ops, ann, host, (0.0, 10.0))


def test_trace_union_and_annotations():
    tr = _trace()
    assert trace.busy(tr) == [(0.0, 2.0), (3.0, 6.0)]
    assert trace.busy_s(tr) == 5.0
    assert trace.busy_under(tr, "local_train") == 2.0
    assert trace.busy_under(tr, "dp_privatize") == 2.5
    assert trace.busy_under(tr, "aggregate") is None
    assert trace.op_seconds(tr, "sumsq_rows|scale_noise_rows") == (2, 3.0)
    kinds = dict(trace.by_kind(tr))
    assert kinds == {"K1": 3.0, "K3": 1.0, "GEMMs": 1.5}
    gaps = dict(trace.idle_gaps(tr))
    assert gaps == {"aten::item": 1.0, "bench.window": 4.0}


def test_readers_on_a_hand_trace():
    tr = _trace()
    m = {"n_layers": 1, "n_heads": 32, "n_kv_heads": 8, "head_dim": 128,
         "d_model": 4096, "family": "dense", "d_ff": 8, "vocab_size": 4}
    t = {"fl": {"slots": 1, "local_steps": 1}, "batch": 1, "seq": 4}
    ctx = SimpleNamespace(trace=tr, model=m, traffic=t, window_s=10.0,
                          counters={"rounds": 2, "k1_rows": 2, "n_params": 100,
                                    "batches": [(1, 4096)]})
    read = {n: cells.reader(n)(ctx) for n in (
        "local_train_ms.train", "dp_ms.train", "aggregate_ms.train",
        "k1_roofline.train", "device_idle_share.train", "k3_roofline.serve",
        "mfu.train", "mfu.serve", "device_idle_share.serve")}
    assert read["local_train_ms.train"] == 1000.0
    assert read["dp_ms.train"] == 1250.0
    assert read["aggregate_ms.train"] is None
    assert read["k1_roofline.train"] == pytest.approx(
        100 * 2 * counts.k1_bytes(100) / counts.PEAK_HBM_BYTES / 3.0)
    assert read["device_idle_share.train"] == pytest.approx(50.0)
    assert read["k3_roofline.serve"] == pytest.approx(
        100 * counts.k3_bound_s(m, 1, 4096) / 1.0)
    assert read["mfu.serve"] == pytest.approx(
        100 * counts.prefill_flops(m, 1, 4096) / 10.0 / counts.PEAK_BF16_FLOPS)
