"""Device ms a round under the program's ``dp_privatize`` annotation (the
slots' noise draws and K1's clip and noise)."""
from perfbench.harness import trace


def read(ctx):
    s = trace.busy_under(ctx.trace, "dp_privatize")
    if s is None or not ctx.counters.get("rounds"):
        return None
    return s / ctx.counters["rounds"] * 1e3
