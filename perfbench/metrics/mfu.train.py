"""The whole round's share of the H100's bf16 peak, in %: the model FLOPs
of the window's rounds (``counts.train_step_flops`` for every slot's
every local step) over the window's seconds and 989 TFLOP/s; read only from a trace with
device operations in it."""
from perfbench import counts


def read(ctx):
    rounds = ctx.counters.get("rounds")
    if not rounds or not ctx.trace.ops:
        return None
    t, m = ctx.traffic, ctx.model
    f = t["fl"]
    flops = (rounds * f["slots"] * f["local_steps"]
             * counts.train_step_flops(m, t["batch"], t["seq"]))
    return 100.0 * flops / ctx.window_s / counts.PEAK_BF16_FLOPS
