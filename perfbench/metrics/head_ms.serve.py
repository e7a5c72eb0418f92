"""Device ms a batch under the program's ``lm.head`` phase (the final norm
and the f32 logits of the last position)."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_batch(ctx, "lm.head")
