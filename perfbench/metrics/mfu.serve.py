"""The prefill step's share of the H100's bf16 peak, in %: the model
FLOPs of the window's prefills (``counts.prefill_flops``) over the
window's seconds and 989 TFLOP/s; read only from a trace with
device operations in it."""
from perfbench import counts


def read(ctx):
    batches = ctx.counters.get("batches")
    if not batches or not ctx.trace.ops:
        return None
    flops = sum(counts.prefill_flops(ctx.model, b, length)
                for b, length in batches)
    return 100.0 * flops / ctx.window_s / counts.PEAK_BF16_FLOPS
