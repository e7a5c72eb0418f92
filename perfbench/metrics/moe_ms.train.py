"""Device ms a round under the program's ``block.moe`` phase and its
``.bwd`` (``ln2``, the routing, the dispatch product, the held experts
and the combine product, forward and backward, every layer, slot and
local step); ``moe_route_ms.train`` and ``experts_ms.train`` are parts
of it, and the dispatch and combine products the rest."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_round(ctx, "block.moe")
