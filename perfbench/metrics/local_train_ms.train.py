"""Device ms a round under the program's ``local_train`` annotation (the
clients' local steps: forward, backward, the SGD step and the f32
update row), from the trace's device timeline."""
from perfbench.harness import trace


def read(ctx):
    s = trace.busy_under(ctx.trace, "local_train")
    if s is None or not ctx.counters.get("rounds"):
        return None
    return s / ctx.counters["rounds"] * 1e3
