"""Device ms a round under the program's ``block.attention`` phase and its
``.bwd`` (``ln1``, the q/k/v projections, rope, the attend, the output
projection: forward and backward, every layer, slot and local step)."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_round(ctx, "block.attention")
