"""A prefill cell: a closed loop of prompt batches through the program's
prefill step, ``Model.forward(params, {"tokens": …}, impl="flash",
last_only=True)``, each request's first token the argmax of its last
position's logits.

Set-up makes the weights and the prompt pool from the seed and serves
one batch of each prompt length (the only shapes the window uses).  The
window sends batch after batch, each once the last one's tokens are on
the host side of a synchronise, until ``--seconds`` have passed.  A
request's time to first token is its batch's time from the call to the
synchronised argmax; ``ttft_ms_p95`` is the 95th percentile (nearest
rank) over every request of the window.  After the window the plain
reference computes the last position's logits of every prompt the
window served, and each served token is judged against them
(``harness/check.py``).
"""
from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace
from typing import Dict

import torch
from torch.profiler import record_function

from perfbench.harness import check, report
from perfbench.harness import trace as trace_lib
from perfbench.harness import traffic as traffic_lib
from perfbench.harness.fl import (WINDOW, profiler, print_top_kernels,
                                  check_layout, model_config)
from perfbench.reference import layout
from perfbench.reference import lm as ref_lm


def p95(values) -> float:
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def reference_logits(m, lv, seed, pool, served_keys, device,
                     precision: str = "f32") -> Dict[tuple, torch.Tensor]:
    """The reference's last-position logits [B, V] of each served pool
    batch ``(length, entry)``, one prompt at a time."""
    ref_lm.no_tf32()
    mm = ref_lm.make_mm(precision)
    w = layout.make_weights(lv, seed, device)
    out = {}
    for length, j in sorted(served_keys):
        toks = pool.prompts[length][j]
        out[(length, j)] = torch.cat([ref_lm.last_logits(w, m, toks[b:b + 1], mm)
                                      for b in range(toks.shape[0])])
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        readers: Dict) -> report.Result:
    from repro_torch.device import resolve_device
    from repro_torch.kernels import flash_attention
    from repro_torch.models.model import build

    dev = resolve_device(device)
    report.reset_peak(dev)
    m, t = cell.config["model"], cell.traffic
    model = build(model_config(cell.config))
    lv = layout.leaves(m)
    check_layout(model, lv)
    params = layout.as_tree(layout.make_weights(lv, seed, dev))
    pool = traffic_lib.prompt_pool(t, m["vocab_size"], seed, dev)

    def serve(tokens):
        with torch.no_grad():
            logits = model.forward(params, {"tokens": tokens}, impl="flash",
                                   last_only=True)
        return logits[:, -1].argmax(-1)

    for length in pool.lengths:
        serve(pool.prompts[length][0])
    report.sync(dev)
    setup_s = time.perf_counter() - t_start

    prof = profiler(dev) if trace else None
    flash_attention.reset_launches()
    ttft, served, shapes = [], [], []
    batch = t["batch"]
    if prof is not None:
        prof.__enter__()
    report.sync(dev)
    t0 = time.perf_counter()
    with record_function(WINDOW):
        i = 0
        while True:
            length, j, toks = pool.batch(i)
            ta = time.perf_counter()
            tok = serve(toks)
            report.sync(dev)
            tb = time.perf_counter()
            ttft.extend([tb - ta] * batch)
            served.append((length, j, tok))
            shapes.append((batch, length))
            i += 1
            if tb - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    calls = flash_attention.LAUNCHES["flash_attention"]
    peak = report.peak_bytes(dev)
    if dev.type == "cuda" and calls != m["n_layers"] * len(served):
        raise RuntimeError(f"{calls} K3 launches for {len(served)} batches "
                           f"of {m['n_layers']} layers")
    metrics = {"ttft_ms_p95": p95(ttft) * 1e3, "peak_mem_gb": peak / 1e9,
               "setup_s": setup_s}
    dev_info = report.device_info(dev, cell.chips, peak)
    breakdown = None
    if prof is not None:
        tr = trace_lib.from_profiler(prof, WINDOW, ())
        ctx = SimpleNamespace(trace=tr, model=m, traffic=t, window_s=window_s,
                              counters={"batches": shapes})
        metrics = {name: fn(ctx) for name, fn in readers.items()}
        dev_info.update(busy_s=trace_lib.busy_s(tr),
                        window_s=tr.window[1] - tr.window[0])
        breakdown = trace_lib.breakdown(tr)
        print_top_kernels(tr)
        del prof, tr
    del params, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_logits(m, lv, seed, pool, {(L, j) for L, j, _ in served},
                           dev)
    gap = max(check.logit_gap(tok, ref[(L, j)]) for L, j, tok in served)
    checks = check.with_limits({"logit_gap": gap}, cell.limits)
    return report.Result(attempted=batch * len(served), failed=0,
                         metrics=metrics, device=dev_info, checks=checks,
                         breakdown=breakdown)
