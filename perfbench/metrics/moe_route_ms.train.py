"""Device ms a round under the program's ``moe.route`` phase and its
``.bwd`` (the f32 router product, softmax, top-k, capacity queues and
the dispatch and combine tensors or indices), a part of
``moe_ms.train``."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_round(ctx, "moe.route")
