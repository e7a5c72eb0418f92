"""Device ms a round under the program's ``moe.experts`` phase and its
``.bwd`` (the held experts' three products and their activation,
capacity padding included), a part of ``moe_ms.train``."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_round(ctx, "moe.experts")
