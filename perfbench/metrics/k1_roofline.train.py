"""K1's share of its roofline, in %: the bytes bound of every privatised
slot's ``[1, P]`` row (``counts.k1_bytes`` at 3.35 TB/s) over the device
time of K1's kernels (``sumsq_rows*`` and ``scale_noise_rows*``)."""
from perfbench import counts
from perfbench.harness import trace


def read(ctx):
    n, s = trace.op_seconds(ctx.trace, r"sumsq_rows|scale_noise_rows")
    rows = ctx.counters.get("k1_rows")
    if not n or not rows or s <= 0:
        return None
    bound = rows * counts.k1_bytes(ctx.counters["n_params"]) / counts.PEAK_HBM_BYTES
    return 100.0 * bound / s
