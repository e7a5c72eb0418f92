"""Device ms a round under the program's ``lm.head`` phase and its ``.bwd``
(the final norm, the f32 copy of the tied table, the f32 logits and the
cross-entropy, forward and backward)."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_round(ctx, "lm.head")
