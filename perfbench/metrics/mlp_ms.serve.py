"""Device ms a batch under the program's ``block.mlp`` phase (``ln2`` and
the SwiGLU MLP; every layer)."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_batch(ctx, "block.mlp")
