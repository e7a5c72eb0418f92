#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one CUDA card (an H100).

Run from the repo root with no arguments:  python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself and imports only ``repro_torch``
(no JAX).  Phases, each of which fails the run with a traceback:

1. report the card (name and power limit, as nvidia-smi gives them);
2. build the four CUDA libraries from the sources in the checkout (one
   nvcc per source, all at once, sm_90a), print ptxas' registers and
   spills, and require no spill in ``flash_attention_kernel`` and
   ``flash_decode_lanes_kernel`` (the head dims up to 32),
   ``rglru_scan_tiles_kernel`` and ``sumsq_rows_cluster_kernel``;
3. hold the DP kernels against their plain PyTorch versions on the card, at
   the paper config's shape [40, 13890] and at ragged shapes (P ≡ 1, 2, 3
   mod 4, a base pointer one element off, rows shorter than a cluster's
   blocks, one row of 10⁶, 1,000 rows), require ``sumsq_rows`` to repeat
   bitwise, and require its cluster and one-block plans and every load
   branch (head, 16-byte body, tail, empty block) to run;
4. drive the FL path: ``run_fl_legacy`` on the paper's config (40 clients,
   hidden 128, unsw) for 10 rounds, counting kernel launches;
5. run 3 rounds on the card and on the CPU from the same state with the
   same draws, and compare;
6. time the DP kernels, their plain versions and the library yardsticks
   with CUDA events;
7. profile 3 warm FL rounds with ``torch.profiler`` (device busy share,
   spans, heaviest kernels);
8. hold ``flash_attention`` (and require two calls to agree bitwise),
   ``flash_decode`` (q, k and v dense, q broadcast or strided, or all
   three off 16-byte alignment, so that every staging branch runs; two
   calls bitwise equal, rows of length 0, its shard partials and their
   merge) and
   ``rglru_scan`` (bitwise, and bitwise across runs; a, x and h0 dense and
   one element off 16-byte alignment, so that every branch of its plan
   runs) against their plain versions on the card;
9. drive the serving path for ``attn`` and ``ssm``: train a checkpoint with
   ``run_fl_legacy`` on ``road_raw`` at hidden 64, load it into a
   ``ServeEngine`` with buckets (16, 128) and stream 9,000 windows in
   bursts of 37, counting kernel launches; check the scores against the
   scorer on the same bucket batches (bitwise), one unpadded call (1e-6)
   and the CPU engine (1e-5); time the batch-1 loop; profile one pass
   (and require ``attn``'s decode to run ``flash_decode_lanes_kernel``);
10. time a launch's own floor (``add_`` on a one-element tensor), the
   sequence kernels at the serving path's shapes (B = 128; ``rglru_scan``
   also at the rglru detector's [128, 64, 16]), ``flash_attention`` and
   ``flash_decode`` beside SDPA (the ratios printed), and ``flash_decode``'s
   eager time as the detector calls it with and without the first port's
   per-call conversions; print each kernel's time less the floor beside its
   bound, and the ``kernels`` JSON line for all five kernels with the
   floor.

The last line is ``{"ok": true, "device": {...}}``.  A fuller record is
written to ``chiprun_out/chip_smoke.json``.  Without a card, or without the
rest of the repo, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM data sheet, fp32 outside tensor cores
SLICE_ROWS, SLICE_P = 40, 13_890
PAPER_EPS_10_ROUNDS = 11.345620277107383  # reference accounted_epsilon(fl, 10)
ROUNDS = 10
SERVE_ROUNDS = 30          # the serve CLI's default training rounds
SERVE_REPEAT = 6           # replays of the 1,500 test windows: 9,000 windows
SERVE_BUCKETS = (16, 128)
SERVE_CHUNK = 37
SPANS = ("fl.batches", "fl.round_step", "fl.sim_time", "fl.eval",
         "selection", "local_train", "dp_privatize", "aggregate")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def eager_ms(fn, iters: int = 200, reps: int = 7) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls issued back
    to back from Python, by CUDA events: the time a caller that launches
    one call at a time sees, host dispatch included."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int = 100, reps: int = 7) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, timed by CUDA events (median over ``reps`` replays).  The
    graph removes the host's dispatch, so this is the card's own time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def launch_floor_ms(torch) -> float:
    """A launch's own floor: the device time per call of a stock kernel
    that does next to nothing (``add_`` on a one-element tensor), by the
    :func:`device_ms` protocol that times the kernels."""
    t = torch.zeros(1, device="cuda")
    return device_ms(lambda: t.add_(1))


def bound(bytes_moved, flops):
    """The least time (ms) the card could take: bytes over HBM bandwidth or
    fp32 operations over the fp32 peak, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sumsq_bound(r: int, p: int):
    """``sumsq_rows``' bound on [r, p]: x read, one sum a row written, a
    multiply and an add an element."""
    return bound(4 * r * p + 4 * r, 2 * r * p)


def scan_bound(case):
    """``rglru_scan``'s bound on an ``RG_CASES`` case: a and x read and h
    written, [B, L, W] each; h0 read (when given) and h_last written,
    [B, W] each; a multiply and an add an element."""
    b, l, w, with_h0 = case
    return bound(4 * (3 * b * l * w + (2 if with_h0 else 1) * b * w),
                 2 * b * l * w)


def timed(kernel, plain, library):
    """Device times (CUDA-graph replay) of the kernel, its plain version and
    the library yardstick, and the same calls issued one by one."""
    out = {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
           "library_ms": None if library is None else device_ms(library),
           "eager_ms": eager_ms(kernel), "eager_plain_ms": eager_ms(plain)}
    if library is not None:
        out["eager_library_ms"] = eager_ms(library)
    return out


# (r, p, offset): x [r, p] starting `offset` elements past a 16-byte
# boundary.  The paper config's update (P ≡ 2 mod 4: every other row starts
# 8 bytes off), the grid of PR 11, P ≡ 1 and 3, the update one element off,
# rows shorter than a cluster's blocks (empty blocks), one row of 10⁶ and
# 1,000 rows (one block a row)
SQ_CASES = [(SLICE_ROWS, SLICE_P, 0)] + [
    (r, p, 0) for p in (64, 1000, 40_000) for r in (1, 7)] + [
    (5, 1001, 0), (5, 4099, 0), (SLICE_ROWS, SLICE_P, 1), (5, 4099, 1),
    (3, 5, 0), (2, 30, 3), (1, 1_000_000, 0), (1000, SLICE_P, 0)]
SQ_BRANCHES = {"cluster", "one block", "head", "float4", "tail", "empty"}


def sumsq_branches(dpk, x) -> set:
    """The branches ``sumsq_rows_cluster_kernel`` takes on ``x [R, P]``:
    a cluster of blocks a row or one block, and per block a scalar head,
    16-byte loads, a scalar tail or no columns at all."""
    r, p = x.shape
    plan = dpk.sumsq_plan(r, p)
    out = {"cluster" if plan.cluster > 1 else "one block"}
    for row in range(min(r, 4)):  # row starts repeat mod 4
        start = x.data_ptr() % 16 // 4 + row * p
        for head, vec4s, tail in dpk.sumsq_segments(plan, p, start):
            out |= {name for name, n in (("head", head), ("float4", vec4s),
                                         ("tail", tail)) if n}
            if head + vec4s + tail == 0:
                out.add("empty")
    return out


def offset_copy(torch, x, offset: int):
    """A contiguous copy of ``x`` that starts ``offset`` elements past a
    16-byte boundary (a fresh allocation starts on one)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def phase_kernels_vs_plain(torch, dpk, ref, ops):
    """Phase 3.  Returns the max abs error per kernel at [40, 13890]."""
    gen = torch.Generator().manual_seed(0)
    errs = {"sumsq_rows": 0.0, "scale_noise_rows": 0.0}
    branches = set()
    for r, p, offset in SQ_CASES:
        x = offset_copy(torch, (torch.randn(r, p, generator=gen) * 3).cuda(),
                        offset)
        nz = torch.randn(r, p, generator=gen).cuda()
        branches |= sumsq_branches(dpk, x)
        sq = dpk.sumsq_rows(x)
        sq_ref = ref.sumsq_rows_ref(x)
        torch.testing.assert_close(sq, sq_ref, rtol=1e-5, atol=0)
        check(torch.equal(sq, dpk.sumsq_rows(x)),
              f"sumsq_rows not bitwise repeatable at [{r}, {p}] + {offset}")
        for clip, sigma in ((1.0, 0.0), (0.5, 0.1), (100.0, 1.0)):
            scale = ref.clip_scale(torch.sqrt(sq_ref), clip)
            o = dpk.scale_noise_rows(x, nz, scale, sigma)
            o_ref = ref.scale_noise_rows_ref(x, nz, scale, sigma)
            torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-5)
            out, norm = ops.dp_clip_noise_rows(x, nz, clip, sigma)
            out_ref, norm_ref = ref.dp_clip_noise_rows_ref(x, nz, clip, sigma)
            torch.testing.assert_close(norm, norm_ref, rtol=1e-5, atol=0)
            torch.testing.assert_close(out, out_ref, rtol=1e-5, atol=1e-5)
            if (r, p, offset) == (SLICE_ROWS, SLICE_P, 0):
                errs["scale_noise_rows"] = max(errs["scale_noise_rows"],
                                               max_abs(o, o_ref))
        if (r, p, offset) == (SLICE_ROWS, SLICE_P, 0):
            errs["sumsq_rows"] = max_abs(sq, sq_ref)
        print(f"  [{r:>4}, {p:>7}] + {offset}  "
              f"C={dpk.sumsq_plan(r, p).cluster}  sumsq max|err| "
              f"{max_abs(sq, sq_ref):.3e}  bitwise repeat ok  "
              f"scale_noise/dp_clip_noise ok")
    check(SQ_BRANCHES <= branches,
          f"sumsq_rows branches not run: {sorted(SQ_BRANCHES - branches)}")
    print(f"  sumsq_rows branches run: {sorted(branches)}")
    torch.cuda.synchronize()
    return errs


def phase_main_path(torch, fed, fl, run_fl_legacy, dpk, accounted_epsilon):
    """Phase 4: the paper's config through ``run_fl_legacy`` on the card."""
    walls, last = [], [0.0]

    def on_round(r, state, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append((now - last[0]) * 1e3)
        last[0] = now
        print(f"  round {r + 1:>2}: K={float(m.k_effective):5.2f} "
              f"selected={int(m.sel_mask.sum())} "
              f"failures={int(m.failed.sum())} "
              f"loss={float(m.global_loss):.4f} wall={walls[-1]:.1f} ms")

    dpk.reset_launches()
    last[0] = time.perf_counter()
    res = run_fl_legacy(fed, fl, "proposed", seed=0, rounds=ROUNDS,
                        eval_every=1, hidden=128, device="cuda",
                        on_round=on_round)
    torch.cuda.synchronize()
    launches = dict(dpk.LAUNCHES)
    h = res.history
    for r in range(ROUNDS):
        print(f"  round {h['round'][r]:>2}: acc={h['acc'][r]:.4f} "
              f"auc={h['auc'][r]:.4f} fail={h['fail'][r]:.3f} "
              f"cum_sim_time={h['cum_time'][r]:.3f} s")
    print(f"  eps_spent={res.eps_spent!r}  launches={launches}")
    check(len(h["round"]) == ROUNDS, "history does not cover every round")
    check(all(math.isfinite(v) for k in ("loss", "acc", "auc", "k", "fail",
                                        "cum_time") for v in h[k]),
          "history has non-finite values")
    check(all(0.0 <= a <= 1.0 for a in h["acc"]), "accuracy out of [0, 1]")
    check(all(fl.k_min <= k <= fl.n_clients for k in h["k"]), "K out of range")
    check(abs(res.eps_spent - accounted_epsilon(fl, ROUNDS)) <= 1e-6,
          "eps_spent differs from the host accountant")
    check(abs(res.eps_spent - PAPER_EPS_10_ROUNDS) <= 1e-6,
          "eps_spent differs from the reference's accounted epsilon")
    from repro_torch.tree import tree_leaves
    check(all(bool(torch.isfinite(l).all()) for l in tree_leaves(res.params)),
          "non-finite params")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched on the main path")
        check(n == ROUNDS, f"kernel {name}: {n} launches in {ROUNDS} rounds")
    return res, launches, walls


def phase_card_vs_cpu(torch, fed, fl, dpk):
    """Phase 5: 3 rounds on the card and on the CPU, same state and draws."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.data.synthetic import round_batches
    from repro_torch.models.spec import get_model_spec, meta_for
    from repro_torch.tree import flatten_rows

    n = fed.n_clients
    spec = get_model_spec(fl.model, meta_for(fed, hidden=128))
    gen = torch.Generator().manual_seed(1)
    sizes = fed.data_sizes()
    state0 = rounds_lib.init_round_state(
        spec.init(gen), fl, gen, n_clients=n,
        data_size=torch.as_tensor(sizes / sizes.mean()),
        data_quality=torch.as_tensor(fed.label_entropy()))
    states = {dev: convert.round_state_from_jax(
        state0.params, state0.util, state0.kctl, state0.fault, fl, dev)
        for dev in ("cpu", "cuda")}
    steps = {dev: rounds_lib.make_parallel_round(spec.loss, fl, n, device=dev)
             for dev in states}
    n_params = flatten_rows(state0.params, 0).numel()
    draw_gen = torch.Generator().manual_seed(2)
    rng = np.random.default_rng(3)
    launches0 = sum(dpk.LAUNCHES.values())
    for r in range(3):
        draws = rounds_lib.draw_round(draw_gen, n, fl.local_epochs, n_params,
                                      fl.selection)
        b = round_batches(rng, fed, fl.local_epochs, fl.local_batch)
        metrics = {}
        for dev in states:
            batches = {"x": torch.as_tensor(b["x"], device=dev),
                       "y": torch.as_tensor(b["y"], device=dev).long()}
            states[dev], metrics[dev] = steps[dev](states[dev], batches,
                                                   draws=draws.to(dev))
        cpu, gpu = states["cpu"], states["cuda"]
        check(torch.equal(metrics["cpu"].sel_mask,
                          metrics["cuda"].sel_mask.cpu()),
              f"sel_mask differs on round {r + 1}")
        worst = 0.0
        pairs = [(flatten_rows(gpu.params, 0), flatten_rows(cpu.params, 0))]
        pairs += list(zip(gpu.util, cpu.util)) + list(zip(gpu.kctl, cpu.kctl))
        for a, c in pairs:
            torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-6)
            worst = max(worst, max_abs(a.cpu(), c))
        print(f"  round {r + 1}: sel_mask equal "
              f"({int(metrics['cpu'].sel_mask.sum())} selected), "
              f"params/util/K max|card-cpu| {worst:.3e}")
    check(sum(dpk.LAUNCHES.values()) - launches0 == 6,
          "the card's round steps did not go through the kernels")


def phase_timing(torch, dpk, ref, errs, launches):
    """Phase 6: times at [40, 13890] (rows of the kernels JSON line).

    ``ms``/``plain_ms``/``library_ms`` are device times (CUDA-graph replay);
    the ``eager_*`` keys are the same calls issued one by one from Python.
    The 2.2 MB operands stay in the 50 MB L2 between calls, as the freshly
    written updates do on the main path."""
    gen = torch.Generator().manual_seed(4)
    r, p = SLICE_ROWS, SLICE_P
    x = torch.randn(r, p, generator=gen).cuda()
    nz = torch.randn(r, p, generator=gen).cuda()
    sigma = 0.6
    scale = ref.clip_scale(torch.sqrt(ref.sumsq_rows_ref(x)), 1.0)
    sn = sigma * nz
    scale_col = scale[:, None]

    rows = []
    b_sq, by_sq = sumsq_bound(r, p)
    rows.append({
        "name": "sumsq_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dp_clip_noise.cu",
        "replaces": "src/repro/kernels/dp_clip_noise.py:62",
        "launches": launches["sumsq_rows"],
        "max_abs_err": errs["sumsq_rows"],
        "bound_ms": b_sq, "bound_by": by_sq,
        **timed(lambda: dpk.sumsq_rows(x), lambda: ref.sumsq_rows_ref(x),
                lambda: torch.linalg.vector_norm(x, dim=1)),
    })
    b_sn, by_sn = bound(12 * r * p + 4 * r, 3 * r * p)
    rows.append({
        "name": "scale_noise_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dp_clip_noise.cu",
        "replaces": "src/repro/kernels/dp_clip_noise.py:81",
        "launches": launches["scale_noise_rows"],
        "max_abs_err": errs["scale_noise_rows"],
        "bound_ms": b_sn, "bound_by": by_sn,
        # no single PyTorch call takes (x, noise, scale, σ), so library_ms is
        # null; addcmul on σ·n prepared outside the timed region is the
        # yardstick instead
        **timed(lambda: dpk.scale_noise_rows(x, nz, scale, sigma),
                lambda: ref.scale_noise_rows_ref(x, nz, scale, sigma), None),
        "addcmul_ms": device_ms(lambda: torch.addcmul(sn, x, scale_col)),
    })
    return rows


def profile_summary(events, span_names):
    """From ``torch.profiler`` events: the device-side events (kernels and
    copies; the ``record_function`` spans also show up on the device
    timeline, as annotations, and are left out), their busy ms, the host
    ms of each span, and (calls, device ms) per kernel name."""
    from torch.autograd import DeviceType
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name not in span_names]
    busy_ms = sum(e.device_time_total for e in device) / 1e3
    spans = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in span_names:
            spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total / 1e3
    by_kernel = {}
    for e in device:
        n, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, t + e.device_time_total / 1e3)
    return device, busy_ms, spans, by_kernel


def phase_profile(torch, fed, fl, run_fl_legacy, rounds: int = 3):
    """Phase 7: where a round's time goes.  ``torch.profiler`` over a warm
    3-round run: the card's busy share of the wall, run_fl_legacy's and round
    step's spans (host time per round), and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_fl_legacy(fed, fl, "proposed", seed=1, rounds=rounds,
                      eval_every=1, hidden=128, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device, busy_ms, spans, by_kernel = profile_summary(prof.events(), SPANS)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    out = {
        "rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
        "device_busy_ms_per_round": busy_ms / rounds if device else None,
        "device_busy_share": busy_ms / wall_ms if device else None,
        "device_launches_per_round": len(device) / rounds,
        "span_host_ms_per_round": {k: v / rounds for k, v in spans.items()},
        "top_kernels": [{"name": k[:80], "calls": n, "device_ms": t}
                        for k, (n, t) in top],
        "dp_kernel_device_us": {
            name: 1e3 * t / n for k, (n, t) in by_kernel.items()
            for name in ("sumsq_rows", "scale_noise_rows") if name in k},
    }
    print(f"  wall {out['wall_ms_per_round']:.2f} ms/round, device busy "
          f"{out['device_busy_ms_per_round']} ms/round "
          f"(share {out['device_busy_share']}), "
          f"{out['device_launches_per_round']:.0f} device ops/round")
    for k, v in out["span_host_ms_per_round"].items():
        print(f"  span {k}: {v:.2f} ms/round (host)")
    for k in out["top_kernels"]:
        print(f"  kernel {k['name']}: {k['calls']} calls, "
              f"{k['device_ms']:.3f} ms")
    print(f"  dp kernels, device us per launch: {out['dp_kernel_device_us']}")
    return out


# (b, s, t, hq, hkv, d, causal, window): the grid of tests/test_kernels.py,
# the attn detector's path shape, a ragged S = T = 100, a causal offset,
# S > T (rows with no valid key), GQA at the detector's width and D = 32
# with a window
FA_PATH = (128, 64, 64, 2, 2, 8, True, None)
FA_CASES = [(1, 128, 128, 4, 4, 64, True, None),
            (2, 256, 256, 8, 2, 64, True, None),
            (1, 256, 256, 4, 1, 128, True, 64),
            (1, 128, 128, 4, 2, 32, False, None),
            (2, 192, 192, 6, 3, 64, True, None),
            FA_PATH,
            (3, 100, 100, 4, 2, 16, True, None),
            (2, 64, 128, 2, 2, 8, True, 24),
            (2, 96, 64, 2, 2, 8, True, None),
            (4, 64, 64, 4, 1, 8, True, None),
            (2, 64, 64, 2, 2, 32, True, 16)]
# flash_attention_kernel<T, DMAX, G> in ptxas' mangled names
FA_KERNEL_NAME = re.compile(
    r"22flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E")
# (b, hq, hkv, d, t, length): length is one for every row or one per row.
# The grid of PR 12 (head dims 64 and 128), the attn read-out's path shape,
# T = 100 (a ragged last key tile), GQA at the detector's width (4 q heads
# over 1 kv head), D = 32, a batch with a row of length 0, D = 12 (padded
# to DMAX 16: staged key row by key row, and bf16 rows copied by element)
# and 64 kv heads (a block stages 8 or 16 of them: key row by key row)
FD_PATH = (128, 2, 2, 8, 64, 64)
FD_CASES = [(1, 4, 4, 64, 256, 256), (2, 8, 2, 64, 512, 300),
            (3, 4, 1, 128, 256, 17), FD_PATH,
            (2, 4, 2, 16, 100, 100), (4, 4, 1, 8, 64, 64),
            (2, 4, 2, 32, 128, 90), (3, 2, 2, 8, 64, (0, 64, 17)),
            (2, 4, 2, 12, 100, (100, 31)), (2, 64, 64, 8, 64, 64)]
# flash_decode_lanes_kernel<T, DMAX> in ptxas' mangled names
SEQ_KERNEL_NAMES = r"flash_attention|flash_decode|rglru_scan"
FD_KERNEL_NAME = re.compile(
    r"25flash_decode_lanes_kernelI(f|13__nv_bfloat16)Li(\d+)EE")
# (b, l, w, h0): the grid of PR 12, the ssm detector's path shape (4 lanes
# a thread), the rglru detector's (B = 128 at hidden 64: one lane a thread,
# rows packed), L not a multiple of the tile, L = 1, W % 4 != 0 and B·W
# smaller than one block.
# Each runs dense and with a, x and h0 one element off 16-byte alignment.
RG_PATH = (128, 4, 512, True)
RG_RGLRU = (128, 64, 16, False)
RG_CASES = [(1, 128, 128, False), (2, 64, 96, True), (3, 64, 512, True),
            (1, 4, 512, False), RG_PATH, RG_RGLRU, (2, 100, 64, True),
            (3, 1, 64, True), (2, 20, 18, True), (1, 9, 8, False),
            (2, 3, 18, True), (128, 20, 512, False), (2048, 40, 16, True)]
RG_BRANCHES = {"4 lanes, 16-byte loads", "1 lane, 4-byte loads",
               "one row a block", "rows packed", "one tile", "two tiles",
               "more tiles", "ragged tile", "idle threads", "h0", "no h0"}
# rglru_scan_tiles_kernel<VEC> and sumsq_rows_cluster_kernel
RG_KERNEL_NAME = re.compile(r"23rglru_scan_tiles_kernelILi(\d+)EE")
SQ_KERNEL_NAME = re.compile(r"25sumsq_rows_cluster_kernel()")


def check_ptxas(log: str, name_re, kernel: str, n_instances: int) -> dict:
    """Phase 2: ptxas' report (``-Xptxas -v``) of each instantiation of a
    kernel, ``"<template arguments>"`` (the name's groups; f32 or bf16 for a
    type) -> registers and the bytes of spill stores and loads.  All
    ``n_instances`` must be reported, without a spill."""
    types = {"f": "f32", "13__nv_bfloat16": "bf16"}
    report, current = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            m = name_re.search(line)
            current = None if m is None else ", ".join(
                types.get(g, g) for g in m.groups())
            if current is not None:
                report.setdefault(current, {})
        elif current is not None and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            report[current].update(spill_stores=int(stores),
                                   spill_loads=int(loads))
        elif current is not None and "registers" in line:
            report[current]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    for name, info in sorted(report.items()):
        print(f"  {kernel}<{name}>: {info}" if name else f"  {kernel}: {info}")
    check(len(report) == n_instances and all(
        {"registers", "spill_stores", "spill_loads"} <= set(info)
        for info in report.values()),
        f"ptxas did not report the {n_instances} {kernel} instances: "
        f"{report}")
    check(all(info["spill_stores"] == info["spill_loads"] == 0
              for info in report.values()),
          f"{kernel} spills: {report}")
    return report


def check_fa_ptxas(log: str) -> dict:
    """``flash_attention_kernel``: f32 and bf16 at DMAX 8, 16, 32 (G = 4)."""
    return check_ptxas(log, FA_KERNEL_NAME, "flash_attention_kernel", 6)


def check_fd_ptxas(log: str) -> dict:
    """``flash_decode_lanes_kernel``: f32 and bf16 at DMAX 8, 16, 32
    (G = 32)."""
    return check_ptxas(log, FD_KERNEL_NAME, "flash_decode_lanes_kernel", 6)


def check_rg_ptxas(log: str) -> dict:
    """``rglru_scan_tiles_kernel``: 4 lanes a thread (16-byte loads) and 1."""
    return check_ptxas(log, RG_KERNEL_NAME, "rglru_scan_tiles_kernel", 2)


def check_sq_ptxas(log: str) -> dict:
    """``sumsq_rows_cluster_kernel``: one instance."""
    return check_ptxas(log, SQ_KERNEL_NAME, "sumsq_rows_cluster_kernel", 1)


def check_flash_attention(torch, fak, ref, randn) -> float:
    """Phase 8 for ``flash_attention``: every case of :data:`FA_CASES` in
    f32 (2e-5) and bf16 (2e-2) against the plain version, and two calls
    bitwise equal.  Returns the f32 max abs error at :data:`FA_PATH`."""
    err = None
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for case in FA_CASES:
            b, s, t, hq, hkv, d, causal, window = case
            q, k, v = (randn(b, s, hq, d, dtype=dtype),
                       randn(b, t, hkv, d, dtype=dtype),
                       randn(b, t, hkv, d, dtype=dtype))
            o = fak.flash_attention(q, k, v, causal=causal, window=window)
            o_ref = ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window)
            check(o.dtype == dtype, "flash_attention output dtype")
            torch.testing.assert_close(o.float(), o_ref.float(), rtol=tol,
                                       atol=tol)
            check(torch.equal(o, fak.flash_attention(q, k, v, causal=causal,
                                                     window=window)),
                  f"flash_attention not bitwise repeatable at {case}")
            if case == FA_PATH and dtype == torch.float32:
                err = max_abs(o, o_ref)
            print(f"  flash_attention {str(dtype)[6:]:>8} {case}: max|err| "
                  f"{max_abs(o, o_ref):.2e}, bitwise repeat")
    return err


def decode_lengths(torch, case):
    """The int32 [b] lengths of an ``FD_CASES`` case, on the card."""
    b, length = case[0], case[5]
    lengths = length if isinstance(length, tuple) else (length,) * b
    return torch.tensor(lengths, dtype=torch.int32, device="cuda")


def decode_layouts(torch, q, k, v) -> dict:
    """The same inputs as a caller may hand them to ``flash_decode``:
    dense; one query broadcast over the batch (batch stride 0, as the attn
    detector passes it); q a strided slice of a larger batch; and q, k and
    v each one element past a 16-byte boundary, so that copies fall to the
    element size."""
    b, hq, d = q.shape
    wide = torch.zeros((2 * b, hq, d), dtype=q.dtype, device=q.device)
    wide[::2] = q
    return {"dense": (q, k, v), "broadcast q": (q[:1].expand(b, hq, d), k, v),
            "strided q": (wide[::2], k, v),
            "unaligned": tuple(offset_copy(torch, x, 1) for x in (q, k, v))}


def decode_branch(fdk, q, k, v):
    """The lanes kernel's staging branch for these inputs, as the wrapper's
    plan picks it: ``(flat, copy width)`` (flat: a row's key tile is one
    contiguous range), or None for the thread-per-key kernel."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    q_bstride = q.stride(0) if b > 1 else hq * d
    aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v)) and \
        q_bstride * q.element_size() % 16 == 0
    plan = fdk.launch_plan(b, t, hq, hkv, d, q.dtype, aligned)
    if plan.lanes == 1:
        return None
    return (plan.kv_heads == hkv and d == plan.dmax, plan.copy_width)


def check_flash_decode(torch, fdk, ref, randn) -> float:
    """Phase 8 for ``flash_decode``: every case of :data:`FD_CASES` in f32
    (2e-5) and bf16 (2e-2 in o; m and l at 2e-5), in every layout of
    :func:`decode_layouts`, against the plain version on the same inputs;
    two calls bitwise equal in o, m and l, and the call without partials
    bitwise equal in o.  A row of length 0 must give m = -1e30 and l = T
    exactly.  Every staging branch of the lanes kernel (a flat or a
    key-row-by-key-row tile, copies of 16 bytes, 4 bytes or one bf16) must
    run.  Returns the f32 max abs error at :data:`FD_PATH`, dense."""
    err, branches = None, set()
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for case in FD_CASES:
            b, hq, hkv, d, t, _ = case
            ln = decode_lengths(torch, case)
            dense = (randn(b, hq, d, dtype=dtype),
                     randn(b, t, hkv, d, dtype=dtype),
                     randn(b, t, hkv, d, dtype=dtype))
            worst = 0.0
            for layout, (q, k, v) in decode_layouts(torch, *dense).items():
                branches.add(decode_branch(fdk, q, k, v))
                want = ref.flash_decode_ref(q, k, v, ln, return_partials=True)
                o, m, l = fdk.flash_decode(q, k, v, ln, return_partials=True)
                check(o.dtype == dtype, "flash_decode output dtype")
                again = fdk.flash_decode(q, k, v, ln, return_partials=True)
                check(all(torch.equal(a, z) for a, z in zip((o, m, l), again)),
                      f"flash_decode not bitwise repeatable at {case}, "
                      f"{layout}")
                check(torch.equal(o, fdk.flash_decode(q, k, v, ln)),
                      f"flash_decode without partials differs at {case}, "
                      f"{layout}")
                torch.testing.assert_close(o.float(), want[0].float(),
                                           rtol=tol, atol=tol)
                torch.testing.assert_close(m, want[1], rtol=2e-5, atol=2e-5)
                torch.testing.assert_close(l, want[2], rtol=2e-5, atol=2e-5)
                empty = ln == 0
                check(bool((m[empty] == -1e30).all())
                      and bool((l[empty] == t).all()),
                      f"a row of length 0 must give m = -1e30 and l = T "
                      f"({case}, {layout})")
                worst = max(worst, max_abs(o, want[0]))
                if case == FD_PATH and dtype == torch.float32 and \
                        layout == "dense":
                    err = max_abs(o, want[0])
            print(f"  flash_decode    {str(dtype)[6:]:>8} {case}: max|err| "
                  f"{worst:.2e} over dense, broadcast q, strided q and "
                  f"unaligned; bitwise repeat")
    want = {(flat, width) for flat in (True, False) for width in (16, 4, 2)}
    check(want <= branches, f"flash_decode staging branches not run: "
          f"{sorted(want - branches)}")
    print(f"  flash_decode    staging branches run (flat, copy bytes): "
          f"{sorted(x for x in branches if x)}")
    return err


def check_decode_shards(torch, fdk, ref, ops, randn, shape, lengths):
    """Phase 8: a cache of ``shape`` (b, hq, hkv, d, t) split into 4
    shards, the last one empty for the first row (``lengths``): each
    shard's partials against the plain version, m = -1e30 and l = T
    exactly for the empty one, and their merge against the unsharded plain
    decode."""
    b, hq, hkv, d, t = shape
    shards = 4
    q, k, v = randn(b, hq, d), randn(b, t, hkv, d), randn(b, t, hkv, d)
    length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    per = t // shards
    parts = []
    for sh in range(shards):
        ln = torch.clamp(length - sh * per, 0, per).to(torch.int32)
        sl = slice(sh * per, (sh + 1) * per)
        got = fdk.flash_decode(q, k[:, sl], v[:, sl], ln, return_partials=True)
        want = ref.flash_decode_ref(q, k[:, sl], v[:, sl], ln,
                                    return_partials=True)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=2e-5, atol=2e-5)
        parts.append(got)
    check(float(parts[-1][1][0, 0]) == float(torch.tensor(-1e30))
          and float(parts[-1][2][0, 0]) == per,
          "an empty shard must give m = -1e30 and l = T")
    merged = ops.combine_decode_partials(
        *(torch.stack([pt[i] for pt in parts]) for i in range(3)))
    full = ref.flash_decode_ref(q, k, v, length)
    check(bool(torch.isfinite(merged).all()), "merged partials not finite")
    torch.testing.assert_close(merged, full, rtol=2e-5, atol=2e-5)
    print(f"  flash_decode 4-shard partials + combine (empty shard) at "
          f"{shape}: max|err| {max_abs(merged, full):.2e}")


def phase_seq_kernels_vs_plain(torch, fak, fdk, rgk, ref, ops):
    """Phase 8.  Returns the max abs error of the attention kernels at the
    path shapes (f32)."""
    gen = torch.Generator().manual_seed(7)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    errs = {"flash_attention": check_flash_attention(torch, fak, ref, randn)}
    errs["flash_decode"] = check_flash_decode(torch, fdk, ref, randn)
    for shape, lengths in (((2, 8, 2, 64, 512), (300, 512)),
                           ((2, 2, 2, 8, 256), (150, 256))):
        check_decode_shards(torch, fdk, ref, ops, randn, shape, lengths)
    check_rglru_scan(torch, rgk, ref, randn)
    torch.cuda.synchronize()
    return errs


def scan_branches(rgk, case, aligned: bool) -> set:
    """The branches ``rglru_scan_tiles_kernel`` takes on a case of
    :data:`RG_CASES`, as the wrapper's plan picks them."""
    b, l, w, with_h0 = case
    plan = rgk.launch_plan(b, l, w, aligned)
    (tx, ty), (gx, gy) = plan.block, plan.grid
    tiles = -(-l // plan.tile)
    out = {"4 lanes, 16-byte loads" if plan.vec == 4 else
           "1 lane, 4-byte loads",
           "rows packed" if ty > 1 else "one row a block",
           "h0" if with_h0 else "no h0",
           "one tile" if tiles == 1 else "two tiles" if tiles == 2
           else "more tiles"}
    if l % plan.tile:
        out.add("ragged tile")
    if gy * ty > b or gx * tx * plan.vec >= w + plan.vec:
        out.add("idle threads")
    return out


def check_rglru_scan(torch, rgk, ref, randn) -> None:
    """Phase 8 for ``rglru_scan``: every case of :data:`RG_CASES`, dense and
    with a, x and h0 one element off 16-byte alignment, bitwise equal to the
    plain version and bitwise repeatable; every branch of
    :data:`RG_BRANCHES` must run."""
    branches = set()
    for case in RG_CASES:
        b, l, w, with_h0 = case
        dense = (torch.sigmoid(randn(b, l, w)), randn(b, l, w),
                 randn(b, w) if with_h0 else None)
        off = tuple(None if t is None else offset_copy(torch, t, 1)
                    for t in dense)
        for layout, (a, x, h0) in (("dense", dense), ("unaligned", off)):
            branches |= scan_branches(rgk, case, all(
                t.data_ptr() % 16 == 0 for t in (a, x, h0) if t is not None))
            h, h_last = rgk.rglru_scan(a, x, h0)
            h_ref, hl_ref = ref.rglru_scan_ref(a, x, h0)
            check(torch.equal(h, h_ref) and torch.equal(h_last, hl_ref),
                  f"rglru_scan not bitwise equal to the plain version at "
                  f"{case}, {layout}")
            h2, hl2 = rgk.rglru_scan(a, x, h0)
            check(torch.equal(h, h2) and torch.equal(h_last, hl2),
                  f"rglru_scan not bitwise repeatable at {case}, {layout}")
        print(f"  rglru_scan {case}: dense and unaligned bitwise equal to "
              f"plain, bitwise repeat")
    check(RG_BRANCHES <= branches,
          f"rglru_scan branches not run: {sorted(RG_BRANCHES - branches)}")
    print(f"  rglru_scan branches run: {sorted(branches)}")


def phase_serve(torch, name, fed, seq_kernels):
    """Phase 9, one model: train a checkpoint, serve the test windows
    through the engine on the card, count launches, check the scores."""
    import numpy as np

    from repro_torch.configs.base import FLConfig
    from repro_torch.models.spec import meta_for
    from repro_torch.serve import (ServeEngine, batches_of,
                                   save_serving_checkpoint)
    from repro_torch.serve.engine import _get_scorer
    from repro_torch.train.fl_driver import run_fl_legacy

    # the serve CLI's training config (python -m repro_torch.serve)
    fl = FLConfig(n_clients=fed.n_clients,
                  clients_per_round=max(4, fed.n_clients // 5),
                  rounds=SERVE_ROUNDS, local_epochs=2, local_batch=32,
                  local_lr=0.08, dp_enabled=False, fault_tolerance=False,
                  model=name)
    t0 = time.perf_counter()
    res = run_fl_legacy(fed, fl, "random", seed=0, rounds=SERVE_ROUNDS,
                        eval_every=max(SERVE_ROUNDS // 4, 1),
                        dataset="road_raw", hidden=64, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print(f"  trained {name} for {SERVE_ROUNDS} rounds in {train_s:.1f} s: "
          f"acc={res.accuracy:.4f} auc={res.auc:.4f}")
    path = save_serving_checkpoint(
        str(ROOT / "chiprun_out" / "serve_ckpt" / f"serve_{name}_road_raw"),
        res.params, name, meta_for(fed, hidden=64))
    eng = ServeEngine.from_checkpoint(path, buckets=SERVE_BUCKETS)
    eng.warmup()
    windows = np.asarray(fed.test_x, np.float32)

    def stream(repeat=SERVE_REPEAT):
        for _ in range(repeat):
            for i in range(0, windows.shape[0], SERVE_CHUNK):
                yield windows[i:i + SERVE_CHUNK]

    for mod in seq_kernels:
        mod.reset_launches()
    rep = eng.score_stream(stream())
    torch.cuda.synchronize()
    launches = {k: n for mod in seq_kernels for k, n in mod.LAUNCHES.items()}

    n = windows.shape[0]
    check(rep.n_windows == SERVE_REPEAT * n, f"{name}: n_windows "
          f"{rep.n_windows} != {SERVE_REPEAT * n}")
    check(bool(np.all(np.isfinite(rep.scores))), f"{name}: non-finite scores")
    check(bool(np.all((rep.scores >= 0) & (rep.scores <= 1))),
          f"{name}: scores outside [0, 1]")
    want = ({"flash_attention": rep.n_batches, "flash_decode": rep.n_batches,
             "rglru_scan": 0} if name == "attn" else
            {"flash_attention": 0, "flash_decode": 0,
             "rglru_scan": 2 * rep.n_batches})
    check(launches == want, f"{name}: launches {launches} != {want} for "
          f"{rep.n_batches} batches")
    check(all(v > 0 for v in want.values() if v) and rep.n_batches > 0,
          f"{name}: a kernel of the path was never launched")
    # batching and the feed change no bits: the same scorer on the same
    # padded bucket batches
    again = []
    for xb, n_valid in batches_of(stream(), eng.buckets):
        scorer = _get_scorer(eng.spec, eng.meta, xb.shape[0], eng.route)
        again.append(scorer(eng.params, torch.as_tensor(xb, device="cuda")
                            )[:n_valid].cpu().numpy())
    check(np.array_equal(np.concatenate(again), rep.scores),
          f"{name}: served scores differ from the scorer on the same batches")
    with torch.no_grad():
        single = eng.spec.predict_proba_routed(
            eng.params, torch.as_tensor(windows, device="cuda"),
            "kernel")[:, 1].cpu().numpy()
    err_single = float(np.abs(single - rep.scores[:n]).max())
    check(err_single <= 1e-6, f"{name}: served vs one unpadded call "
          f"{err_single:.3e} > 1e-6")
    cpu_scores = ServeEngine.from_checkpoint(
        path, buckets=SERVE_BUCKETS, device="cpu").score(windows)
    err_cpu = float(np.abs(cpu_scores - rep.scores[:n]).max())
    check(err_cpu <= 1e-5, f"{name}: card vs CPU scores {err_cpu:.3e} > 1e-5")
    naive = eng.score_naive(windows[:384])
    err_naive = float(np.abs(naive.scores - rep.scores[:384]).max())
    check(err_naive <= 1e-6, f"{name}: batch-1 vs served {err_naive:.3e}")
    prof = serve_profile(torch, eng, lambda: stream(1))
    if name == "attn":  # the read-out runs the lanes kernel, once a batch
        decode = {k: v for k, v in prof["seq_kernels"].items()
                  if "flash_decode" in k}
        check(len(decode) == 1 and "flash_decode_lanes_kernel" in
              next(iter(decode)) and next(iter(decode.values()))["calls"]
              == prof["batches"],
              f"attn: the profiled decode kernels are {decode}")
    out = {
        "model": name, "train_rounds": SERVE_ROUNDS, "train_s": train_s,
        "train_acc": res.accuracy, "train_auc": res.auc,
        "n_windows": rep.n_windows, "n_batches": rep.n_batches,
        "windows_per_s": rep.windows_per_sec, "p50_ms": rep.p50_s * 1e3,
        "p99_ms": rep.p99_s * 1e3, "wall_s": rep.wall_s,
        "launches": launches, "max_abs_vs_unpadded": err_single,
        "max_abs_card_vs_cpu": err_cpu,
        "naive_windows_per_s": naive.windows_per_sec,
        "naive_p50_ms": naive.p50_s * 1e3, "profile": prof,
    }
    print(f"  {name}: {rep.n_windows} windows in {rep.n_batches} batches: "
          f"{rep.windows_per_sec:,.0f} windows/s, "
          f"p50 {rep.p50_s * 1e3:.3f} ms, p99 {rep.p99_s * 1e3:.3f} ms; "
          f"batch-1 loop {naive.windows_per_sec:,.0f} windows/s")
    print(f"  {name}: launches {launches}; served = scorer on the same "
          f"batches (bitwise); vs one unpadded call {err_single:.2e}; card vs "
          f"CPU {err_cpu:.2e}; batch-1 vs served {err_naive:.2e}")
    return out


def serve_profile(torch, eng, stream):
    """``torch.profiler`` over one pass of the stream: the card's busy share
    of the wall and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    spans = ("serve.score_stream", "serve.dispatch")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.score_stream(stream())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device, busy_ms, span_ms, by_kernel = profile_summary(prof.events(), spans)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:6]
    out = {"windows": rep.n_windows, "batches": rep.n_batches,
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "device_ops_per_batch": len(device) / rep.n_batches,
           "span_host_ms": span_ms,
           "top_kernels": [{"name": k[:80], "calls": c, "device_ms": t}
                           for k, (c, t) in top],
           # the port's sequence kernels by their full names
           "seq_kernels": {k: {"calls": c, "device_us": 1e3 * t / c}
                           for k, (c, t) in by_kernel.items()
                           if re.search(SEQ_KERNEL_NAMES, k)}}
    print(f"  {eng.spec.name} profile: {rep.n_windows} windows, wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.2f} ms (share "
          f"{busy_ms / wall_ms:.3f}), "
          f"{out['device_ops_per_batch']:.0f} device ops per batch")
    for k in out["top_kernels"]:
        print(f"    kernel {k['name']}: {k['calls']} calls, "
              f"{k['device_ms']:.3f} ms")
    for k, info in out["seq_kernels"].items():
        print(f"    sequence kernel {k}: {info['calls']} calls, "
              f"{info['device_us']:.2f} us each")
    return out


def decode_eager(torch, fdk, q, k, v, ln) -> dict:
    """Phase 10 for ``flash_decode`` at :data:`FD_PATH`: eager us as the
    attn detector calls it (one learned query broadcast over the batch, an
    int32 length on the card), with and without the first port's per-call
    conversions (length through ``as_tensor``/``to``/``expand``/
    ``contiguous``, q, k and v copied, m and l allocated) in front."""
    b, hq, d = q.shape
    qb = q[:1].expand(b, hq, d)

    def with_conversions():
        length = torch.as_tensor(ln, device=qb.device).to(torch.int32)
        return fdk.flash_decode(qb.contiguous(), k.contiguous(),
                                v.contiguous(), length.expand(b).contiguous(),
                                return_partials=True)

    after = eager_ms(lambda: fdk.flash_decode(qb, k, v, ln))
    before = eager_ms(with_conversions)
    after_again = eager_ms(lambda: fdk.flash_decode(qb, k, v, ln))
    return {"eager_detector_us": [after * 1e3, after_again * 1e3],
            "eager_detector_with_conversions_us": before * 1e3}


def phase_seq_timing(torch, fak, fdk, rgk, ref, errs, launches):
    """Phase 10: the sequence kernels at the serving path's shapes (the
    128-window bucket), rows of the kernels JSON line."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(9)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    rows = []
    b, s, t, hq, hkv, d, _, _ = FA_PATH
    q, k, v = randn(b, s, hq, d), randn(b, t, hkv, d), randn(b, t, hkv, d)
    qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
    pairs = s * (s + 1) // 2          # causal (query, key) pairs, S = T
    b_fa, by_fa = bound(4 * 4 * b * s * hq * d, 4 * d * pairs * b * hq)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:103",
        "launches": launches["flash_attention"],
        "max_abs_err": errs["flash_attention"],
        "bound_ms": b_fa, "bound_by": by_fa,
        **timed(lambda: fak.flash_attention(q, k, v, causal=True),
                lambda: ref.flash_attention_ref(q, k, v, causal=True),
                lambda: sdpa(qt, kt, vt, is_causal=True)),
    })
    b, hq, hkv, d, t, length = FD_PATH
    q, k, v = randn(b, hq, d), randn(b, t, hkv, d), randn(b, t, hkv, d)
    ln = torch.full((b,), length, dtype=torch.int32, device="cuda")
    q4 = q[:, :, None, :].contiguous()
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(t, device="cuda")[None] < ln[:, None])[:, None, None]
    # q and o, k and v, length: the timed call returns no partials
    b_fd, by_fd = bound(4 * (2 * b * hq * d + 2 * b * t * hkv * d) + 4 * b,
                        4 * d * length * b * hq)
    rows.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:102",
        "launches": launches["flash_decode"],
        "max_abs_err": errs["flash_decode"],
        "bound_ms": b_fd, "bound_by": by_fd,
        **timed(lambda: fdk.flash_decode(q, k, v, ln),
                lambda: ref.flash_decode_ref(q, k, v, ln),
                lambda: sdpa(q4, kt, vt, attn_mask=mask)),
        **decode_eager(torch, fdk, q, k, v, ln),
    })
    for name, case, n in (("rglru_scan", RG_PATH, launches["rglru_scan"]),
                          # no port path runs the rglru detector yet
                          ("rglru_scan_rglru_shape", RG_RGLRU, 0)):
        b, l, w, with_h0 = case
        a, x = torch.sigmoid(randn(b, l, w)), randn(b, l, w)
        h0 = randn(b, w) if with_h0 else None
        h_ref = ref.rglru_scan_ref(a, x, h0)[0]
        b_rg, by_rg = scan_bound(case)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan.py:60",
            "shape": list(case[:3]), "launches": n,
            "max_abs_err": max_abs(rgk.rglru_scan(a, x, h0)[0], h_ref),
            "bound_ms": b_rg, "bound_by": by_rg,
            # no single PyTorch call computes a sequential linear recurrence
            **timed(lambda: rgk.rglru_scan(a, x, h0),
                    lambda: ref.rglru_scan_ref(a, x, h0), None),
        })
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs.paper_mlp import paper_fl_config
    from repro_torch.data.synthetic import make_federated
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import dp_clip_noise as dpk
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as rgk
    from repro_torch.privacy.accountant import accounted_epsilon
    from repro_torch.train.fl_driver import fl_for_method, run_fl_legacy

    t_all = time.perf_counter()
    card = card_line()
    print(f"== 1. card: {card}  (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)})")

    t0 = time.perf_counter()
    for lib in _nvcc.BUILD_DIR.glob("lib*.so"):  # build from the sources
        lib.unlink()
    builds = _nvcc.build("dp_clip_noise", "flash_attention", "flash_decode",
                         "rglru_scan")
    print(f"== 2. built {len(builds)} libraries in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib, info in builds.items():
        print(f"  {info['path'].name}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "Compiling entry" in line or \
                    "spill" in line:
                print(f"    {line.strip()}")
    ptxas = {
        "flash_attention": check_fa_ptxas(builds["flash_attention"]["log"]),
        "flash_decode": check_fd_ptxas(builds["flash_decode"]["log"]),
        "rglru_scan": check_rg_ptxas(builds["rglru_scan"]["log"]),
        "sumsq_rows": check_sq_ptxas(builds["dp_clip_noise"]["log"])}

    print("== 3. DP kernels vs plain versions on the card")
    errs = phase_kernels_vs_plain(torch, dpk, ref, ops)

    print(f"== 4. FL path: run_fl_legacy, paper config, {ROUNDS} rounds")
    fed = make_federated(0, "unsw")
    fl = fl_for_method(paper_fl_config(), "proposed")
    res, launches, walls = phase_main_path(torch, fed, fl, run_fl_legacy, dpk,
                                           accounted_epsilon)

    print("== 5. card vs CPU on the same draws, 3 rounds")
    phase_card_vs_cpu(torch, fed, fl, dpk)

    print("== 6. DP kernel times at [40, 13890] (CUDA events)")
    kernels = phase_timing(torch, dpk, ref, errs, launches)

    print("== 7. profile of 3 warm FL rounds (torch.profiler)")
    profile = phase_profile(torch, fed, fl, run_fl_legacy)

    print("== 8. sequence kernels vs plain versions on the card")
    errs.update(phase_seq_kernels_vs_plain(torch, fak, fdk, rgk, ref, ops))

    print(f"== 9. serving path: attn and ssm on road_raw, hidden 64, buckets "
          f"{SERVE_BUCKETS}  ({card})")
    road = make_federated(0, "road_raw", n_samples=6000, n_clients=20)
    serve = {}
    for name in ("attn", "ssm"):
        serve[name] = phase_serve(torch, name, road, (fak, fdk, rgk))
    serve_launches = {
        "flash_attention": serve["attn"]["launches"]["flash_attention"],
        "flash_decode": serve["attn"]["launches"]["flash_decode"],
        "rglru_scan": serve["ssm"]["launches"]["rglru_scan"]}

    print("== 10. sequence kernel times at the serving shapes (CUDA events)")
    floor_ms = launch_floor_ms(torch)
    print(f"  launch floor (add_ on a one-element tensor): device "
          f"{floor_ms * 1e3:.3f} us  ({card})")
    kernels += phase_seq_timing(torch, fak, fdk, rgk, ref, errs,
                                serve_launches)
    fa = next(k for k in kernels if k["name"] == "flash_attention")
    print(f"  flash_attention / SDPA device time at {FA_PATH}: "
          f"{fa['ms'] / fa['library_ms']:.3f} ({fa['ms'] * 1e3:.2f} us / "
          f"{fa['library_ms'] * 1e3:.2f} us)  ({card})")
    fd = next(k for k in kernels if k["name"] == "flash_decode")
    print(f"  flash_decode / SDPA device time at {FD_PATH}: "
          f"{fd['ms'] / fd['library_ms']:.3f} ({fd['ms'] * 1e3:.2f} us / "
          f"{fd['library_ms'] * 1e3:.2f} us)  ({card})")
    eager = fd["eager_detector_us"]
    print(f"  flash_decode eager us as the detector calls it: "
          f"{eager[0]:.2f} and {eager[1]:.2f}; with the first port's "
          f"per-call conversions "
          f"{fd['eager_detector_with_conversions_us']:.2f}")
    for k in kernels:
        lib = ("none" if k["library_ms"] is None
               else f"{k['library_ms'] * 1e3:.2f} us")
        print(f"  {k['name']}: device {k['ms'] * 1e3:.2f} us (less the floor "
              f"{(k['ms'] - floor_ms) * 1e3:.2f}; bound "
              f"{k['bound_ms'] * 1e3:.3f} us, {k['bound_by']}) (eager "
              f"{k['eager_ms'] * 1e3:.2f})  plain "
              f"{k['plain_ms'] * 1e3:.2f} us (eager "
              f"{k['eager_plain_ms'] * 1e3:.2f})  library {lib}  launches "
              f"{k['launches']}")

    steady = walls[1:]
    record = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": {lib: info["seconds"] for lib, info in builds.items()},
        "ptxas": ptxas, "launch_floor_ms": floor_ms, "kernels": kernels,
        "round_wall_ms": walls, "profile": profile,
        "round_wall_ms_median_after_first": statistics.median(steady),
        "history": res.history, "eps_spent": res.eps_spent, "serve": serve,
        "total_s": time.perf_counter() - t_all,
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"  FL per-round wall (rounds 2-{ROUNDS}, median): "
          f"{record['round_wall_ms_median_after_first']:.2f} ms; "
          f"total {record['total_s']:.1f} s")

    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor_ms}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
