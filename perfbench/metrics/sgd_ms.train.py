"""Device ms a round under the program's ``local.sgd`` phase (``tree_sgd``'s
update of the param tree and the ``torch.where`` landing, each local
step)."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_round(ctx, "local.sgd")
