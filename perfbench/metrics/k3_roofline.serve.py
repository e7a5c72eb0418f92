"""K3's share of its roofline, in %: the sum over the window's calls (one
a layer a batch) of ``counts.k3_bound_s`` (the larger of its bytes at
3.35 TB/s and its causal bf16 operations at 989 TFLOP/s) over the
device time of ``flash_attention_mma_kernel``."""
from perfbench import counts
from perfbench.harness import trace


def read(ctx):
    n, s = trace.op_seconds(ctx.trace, r"flash_attention_mma_kernel")
    batches = ctx.counters.get("batches")
    if not n or not batches or s <= 0:
        return None
    m = ctx.model
    bound = sum(m["n_layers"] * counts.k3_bound_s(m, b, length)
                for b, length in batches)
    return 100.0 * bound / s
