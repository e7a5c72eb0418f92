"""The share of the traced window, in %, in which no operation ran on the
device: 1 − the union of the device operations' intervals over the
window."""
from perfbench.harness import trace


def read(ctx):
    w0, w1 = ctx.trace.window
    if not ctx.trace.ops or w1 <= w0:
        return None
    return 100.0 * (1.0 - trace.busy_s(ctx.trace) / (w1 - w0))
