"""The held experts' share of the H100's bf16 peak, in %: the expert
products' work over the device seconds under ``moe.experts`` and its
``.bwd`` at 989 TFLOP/s.  The work is counted the same whatever computes
it: every token of every slot's every local step of the window's rounds
routed to ``experts_per_token`` experts, the held share of them
(``n_experts`` of ``router_experts``) on average, three ``d × d_ff``
products each, forward 2 and backward 4 FLOPs a weight, every layer;
the capacity padding is not counted."""
from perfbench import counts, phases
from perfbench.reference.layout import router_experts


def read(ctx):
    s, rounds = phases.busy_s(ctx.trace, "moe.experts"), ctx.counters.get("rounds")
    if not s or not rounds:
        return None
    m, t = ctx.model, ctx.traffic
    f = t["fl"]
    tokens = rounds * f["slots"] * f["local_steps"] * t["batch"] * t["seq"]
    flops = (6 * tokens * m["experts_per_token"] * m["n_experts"]
             / router_experts(m) * 3 * m["d_model"] * m["d_ff"]
             * m["n_layers"])
    return 100.0 * flops / s / counts.PEAK_BF16_FLOPS
