"""Operation and byte counts from shapes, and the H100's peaks they are
set against.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM.

``m`` is a configuration's ``model`` dict.  A FLOP is a multiply or an
add: one multiply-add is 2.
"""
from __future__ import annotations

from perfbench.reference.layout import head_dim, router_experts

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def matmul_params(m: dict, unembed: bool = True) -> int:
    """Weights a token multiplies by in one forward pass: the attention
    projections, the MLP (a MoE layer: the router and ``experts_per_token``
    experts, not the capacity padding; of a layer that holds a share of
    its experts, that share of them) and, with ``unembed``, the
    unembedding over the real vocabulary.  The embedding lookup and the
    norms are not products."""
    d, f, hd = m["d_model"], m["d_ff"], head_dim(m)
    hq, hkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    attn = d * hq + 2 * d * hkv + hq * d
    if m["family"] == "moe":
        e = router_experts(m)
        ffn = (m["experts_per_token"] * 3 * d * f * m["n_experts"] // e
               + d * e)
    else:
        ffn = 3 * d * f
    return m["n_layers"] * (attn + ffn) + (d * m["vocab_size"] if unembed else 0)


def attention_flops(m: dict, batch: int, seq: int) -> int:
    """One forward pass's causal attention products, q·k and p·v over the
    seq·(seq + 1)/2 query-key pairs a head and a sequence, every layer."""
    pairs = seq * (seq + 1) // 2
    return 2 * 2 * m["n_heads"] * head_dim(m) * pairs * batch * m["n_layers"]


def train_step_flops(m: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step on ``[batch, seq]``: 6 × the
    product weights a token uses × the tokens (forward 2, backward 4),
    plus 3 × the forward attention products.  Recomputation, the MoE's
    one-hot dispatch and combine and its capacity padding are not
    counted."""
    return 6 * matmul_params(m) * batch * seq + 3 * attention_flops(m, batch, seq)


def prefill_flops(m: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one prefill of ``[batch, seq]`` that returns the
    last position's logits: 2 × the body's product weights × the tokens,
    the unembedding on the last position only, and the forward attention
    products."""
    return (2 * matmul_params(m, unembed=False) * batch * seq
            + 2 * m["d_model"] * m["vocab_size"] * batch
            + attention_flops(m, batch, seq))


def k1_bytes(p: int) -> int:
    """K1 on one ``[1, P]`` f32 update row: ``sumsq_rows`` reads the row
    and writes its one sum; ``scale_noise_rows`` reads the row, its noise
    and the row's scale and writes the row.  Each input byte read once,
    each output byte written once."""
    return (4 * p + 4) + (4 * p + 4 * p + 4 + 4 * p)


def k3_flops(m: dict, batch: int, seq: int) -> int:
    """K3 on one layer's causal ``[batch, seq]`` prefill: the q·k and p·v
    products over the query-key pairs at or before each query."""
    return attention_flops(dict(m, n_layers=1), batch, seq)


def k3_bytes(m: dict, batch: int, seq: int, itemsize: int = 2) -> int:
    """K3's bf16 operands read once (q, k, v) and its output written
    once."""
    hd = head_dim(m)
    return batch * seq * hd * itemsize * (2 * m["n_heads"] + 2 * m["n_kv_heads"])


def k3_bound_s(m: dict, batch: int, seq: int) -> float:
    """The least time one K3 call could take: the larger of its bytes over
    the HBM rate and its operations over the bf16 peak."""
    return max(k3_bytes(m, batch, seq) / PEAK_HBM_BYTES,
               k3_flops(m, batch, seq) / PEAK_BF16_FLOPS)
