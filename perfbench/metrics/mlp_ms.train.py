"""Device ms a round under the program's ``block.mlp`` phase and its ``.bwd``
(``ln2`` and the SwiGLU MLP, forward and backward)."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_round(ctx, "block.mlp")
