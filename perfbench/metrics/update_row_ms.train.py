"""Device ms a round under the program's ``local.update_row`` phase (each
slot's f32 update row, the local params minus the global ones)."""
from perfbench import phases


def read(ctx):
    return phases.ms_a_round(ctx, "local.update_row")
