#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one CUDA card (an H100).

Run from the repo root with no arguments:  python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself and imports only ``repro_torch``
(no JAX).  Phases, each of which fails the run with a traceback:

1. report the card (name and power limit, as nvidia-smi gives them);
2. build the CUDA kernels from the sources in the checkout (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card, at the
   paper config's shape [40, 13890] and at ragged shapes, and require
   ``sumsq_rows`` to repeat bitwise;
4. drive the main path: ``run_fl_legacy`` on the paper's config (40
   clients, hidden 128, unsw) for 10 rounds, counting kernel launches;
5. run 3 rounds on the card and on the CPU from the same state with the
   same draws, and compare;
6. time each kernel, its plain version and the library yardstick with CUDA
   events and print the ``kernels`` JSON line;
7. profile 3 warm rounds with ``torch.profiler`` (device busy share, spans,
   heaviest kernels).

The last line is ``{"ok": true, "device": {...}}``.  A fuller record is
written to ``chiprun_out/chip_smoke.json``.  Without a card, or without the
rest of the repo, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
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


def phase_kernels_vs_plain(torch, dpk, ref, ops):
    """Phase 3.  Returns the max abs error per kernel at [40, 13890]."""
    gen = torch.Generator().manual_seed(0)
    errs = {"sumsq_rows": 0.0, "scale_noise_rows": 0.0}
    shapes = [(SLICE_ROWS, SLICE_P)] + [(r, p) for p in (64, 1000, 40_000)
                                        for r in (1, 7)]
    for r, p in shapes:
        x = (torch.randn(r, p, generator=gen) * 3).cuda()
        nz = torch.randn(r, p, generator=gen).cuda()
        sq = dpk.sumsq_rows(x)
        sq_ref = ref.sumsq_rows_ref(x)
        torch.testing.assert_close(sq, sq_ref, rtol=1e-5, atol=0)
        check(torch.equal(sq, dpk.sumsq_rows(x)),
              f"sumsq_rows not bitwise repeatable at [{r}, {p}]")
        for clip, sigma in ((1.0, 0.0), (0.5, 0.1), (100.0, 1.0)):
            scale = ref.clip_scale(torch.sqrt(sq_ref), clip)
            o = dpk.scale_noise_rows(x, nz, scale, sigma)
            o_ref = ref.scale_noise_rows_ref(x, nz, scale, sigma)
            torch.testing.assert_close(o, o_ref, rtol=1e-5, atol=1e-5)
            out, norm = ops.dp_clip_noise_rows(x, nz, clip, sigma)
            out_ref, norm_ref = ref.dp_clip_noise_rows_ref(x, nz, clip, sigma)
            torch.testing.assert_close(norm, norm_ref, rtol=1e-5, atol=0)
            torch.testing.assert_close(out, out_ref, rtol=1e-5, atol=1e-5)
            if (r, p) == (SLICE_ROWS, SLICE_P):
                errs["scale_noise_rows"] = max(errs["scale_noise_rows"],
                                               max_abs(o, o_ref))
        if (r, p) == (SLICE_ROWS, SLICE_P):
            errs["sumsq_rows"] = max_abs(sq, sq_ref)
        print(f"  [{r:>2}, {p:>6}]  sumsq max|err| {max_abs(sq, sq_ref):.3e}  "
              f"bitwise repeat ok  scale_noise/dp_clip_noise ok")
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
    """Phase 6: times at [40, 13890] and the kernels JSON line.

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

    def bound(bytes_moved, flops):
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def timed(kernel, plain, library):
        out = {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
               "library_ms": None if library is None else device_ms(library),
               "eager_ms": eager_ms(kernel), "eager_plain_ms": eager_ms(plain)}
        if library is not None:
            out["eager_library_ms"] = eager_ms(library)
        return out

    rows = []
    b_sq, by_sq = bound(4 * r * p + 4 * r, 2 * r * p)
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


def phase_profile(torch, fed, fl, run_fl_legacy, rounds: int = 3):
    """Phase 7: where a round's time goes.  ``torch.profiler`` over a warm
    3-round run: the card's busy share of the wall, run_fl_legacy's and round
    step's spans (host time per round), and the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_fl_legacy(fed, fl, "proposed", seed=1, rounds=rounds,
                      eval_every=1, hidden=128, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # device-side activity: kernels and copies (the record_function spans
    # also show up on the device timeline, as annotations; leave them out)
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name not in SPANS]
    busy_ms = sum(e.device_time_total for e in device) / 1e3
    spans = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in SPANS:
            spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total / 1e3
    by_kernel = {}
    for e in device:
        n, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, t + e.device_time_total / 1e3)
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
            for name in ("sumsq_rows", "scale_noise_rows")
            if f"{name}_kernel" in k},
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs.paper_mlp import paper_fl_config
    from repro_torch.data.synthetic import make_federated
    from repro_torch.kernels import dp_clip_noise as dpk
    from repro_torch.kernels import ops, ref
    from repro_torch.privacy.accountant import accounted_epsilon
    from repro_torch.train.fl_driver import fl_for_method, run_fl_legacy

    t_all = time.perf_counter()
    card = card_line()
    print(f"== 1. card: {card}  (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)})")

    info = dpk.build()
    print(f"== 2. built {info['path'].name} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  {line.strip()}")

    print("== 3. kernels vs plain versions on the card")
    errs = phase_kernels_vs_plain(torch, dpk, ref, ops)

    print(f"== 4. main path: run_fl_legacy, paper config, {ROUNDS} rounds")
    fed = make_federated(0, "unsw")
    fl = fl_for_method(paper_fl_config(), "proposed")
    res, launches, walls = phase_main_path(torch, fed, fl, run_fl_legacy, dpk,
                                           accounted_epsilon)

    print("== 5. card vs CPU on the same draws, 3 rounds")
    phase_card_vs_cpu(torch, fed, fl, dpk)

    print("== 6. kernel times at [40, 13890] (CUDA events)")
    kernels = phase_timing(torch, dpk, ref, errs, launches)
    for k in kernels:
        print(f"  {k['name']}: device {k['ms'] * 1e3:.2f} us (eager "
              f"{k['eager_ms'] * 1e3:.2f})  plain {k['plain_ms'] * 1e3:.2f} us "
              f"(eager {k['eager_plain_ms'] * 1e3:.2f})  bound "
              f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']})")

    print("== 7. profile of 3 warm rounds (torch.profiler)")
    profile = phase_profile(torch, fed, fl, run_fl_legacy)

    steady = walls[1:]
    record = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": info["seconds"], "kernels": kernels,
        "round_wall_ms": walls, "profile": profile,
        "round_wall_ms_median_after_first": statistics.median(steady),
        "history": res.history, "eps_spent": res.eps_spent,
        "total_s": time.perf_counter() - t_all,
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"  per-round wall (rounds 2-{ROUNDS}, median): "
          f"{record['round_wall_ms_median_after_first']:.2f} ms; "
          f"total {record['total_s']:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
