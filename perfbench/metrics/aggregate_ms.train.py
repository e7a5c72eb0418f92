"""Device ms a round under the program's ``aggregate`` annotation (the
streamed FedAvg accumulate and finalize, and the server update)."""
from perfbench.harness import trace


def read(ctx):
    s = trace.busy_under(ctx.trace, "aggregate")
    if s is None or not ctx.counters.get("rounds"):
        return None
    return s / ctx.counters["rounds"] * 1e3
