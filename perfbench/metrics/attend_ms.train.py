"""Device ms a round under the program's ``block.attend`` phase and its
``.bwd`` (the mask, the f32 scores, softmax and values of
``_softmax_attend``, forward and backward), a part of
``attention_ms.train``."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_round(ctx, "block.attend")
