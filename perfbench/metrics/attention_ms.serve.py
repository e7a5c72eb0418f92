"""Device ms a batch under the program's ``block.attention`` phase
(``ln1``, the q/k/v projections, rope, K3, the output projection; every
layer)."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_batch(ctx, "block.attention")
