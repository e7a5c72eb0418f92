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
   ``flash_attention_mma_kernel`` (bf16 at DMAX 64, 96, 128, 256),
   ``rglru_scan_tiles_kernel`` and ``sumsq_rows``' three
   (``sumsq_rows_cluster_kernel``, and the split plan's
   ``sumsq_rows_split_kernel`` and ``sumsq_rows_finish_kernel``), and
   record (without a gate) those of
   ``flash_attention_row_kernel`` (f32 at head dims 64 and 128, which
   spills at 128);
3. hold the DP kernels against their plain PyTorch versions on the card, at
   the paper config's shape [40, 13890] and at ragged shapes (P ≡ 1, 2, 3
   mod 4, a base pointer one element off, rows shorter than a cluster's
   blocks, one row of 10⁶, 1,000 rows, rows of 8.4–9 million), require
   ``sumsq_rows`` to repeat bitwise, and require its cluster, one-block
   and split plans and every load branch (head, 16-byte body, tail, empty
   block) to run;
4. drive the FL path: ``run_fl_legacy`` on the paper's config (40 clients,
   hidden 128, unsw) for 10 rounds, counting kernel launches;
5. run 3 rounds on the card and on the CPU from the same state with the
   same draws, and compare;
6. time the DP kernels, their plain versions and the library yardsticks
   with CUDA events;
7. profile 3 warm FL rounds with ``torch.profiler`` (device busy share,
   spans, heaviest kernels);
7b. drive the sweep engine: ``run_fl_sweep`` on the paper's config over
   Fig. 3's ε column (30, 100, 300, 1000) × seeds 0-9 (40 lanes, 1,600
   client rows), 20 rounds, eval every 10, counting kernel launches (one
   of each a round for all lanes); require one runner build and a hit on
   a second call, the round loop under ``torch.cuda.set_sync_debug_mode
   ("error")``, ε per cell equal to the host accountant and different
   across cells, and lanes (0, 0) and (3, 9) equal to ``run_fl`` of their
   cell and seed (atol 1e-5 in accuracy, rtol 1e-5 in simulated time);
   run the lane step on the card and on the CPU from the same states and
   draws (2 cells, iid and Markov, × 2 seeds, 3 rounds: equal
   ``sel_mask``, state within rtol 1e-4 / atol 1e-6); profile 3 warm
   sweep rounds; hold the DP kernels at [1600, 13890] against their plain
   versions (``scale_noise_rows`` with one σ a row bitwise) and time them;
8. hold ``flash_attention`` (and require two calls to agree bitwise; f32
   at D = 256 refused; the bf16 cases at D > 32 are chosen to reach every
   branch of the tensor-core kernel: a cut staged range, a warp skipping a
   tile, ragged rows and keys, rows with no valid key, the prefix offset,
   non-causal, a window shorter than a key tile, GQA and MQA, D padded and
   copied 2 bytes at a time, each DMAX; ``tests/test_torch_fa_mma.py``
   checks that on a Python copy of the kernel's walk),
   ``flash_decode`` (q, k and v dense, q broadcast or strided, or all
   three off 16-byte alignment, so that every staging branch runs; two
   calls bitwise equal, rows of length 0, its shard partials and their
   merge) and
   ``rglru_scan`` (bitwise, and bitwise across runs; a, x and h0 dense and
   one element off 16-byte alignment, so that every branch of its plan
   runs) against their plain versions on the card;
9. drive the serving path for ``attn``, ``ssm``, ``rglru`` and ``cnn``:
   train a checkpoint with ``run_fl`` on ``road_raw`` at hidden 64, as the
   serve CLI does, load it into a ``ServeEngine`` with buckets (16, 128)
   and stream 9,000 windows in bursts of 37, counting kernel launches
   (``attn``: attention and decode once a batch; ``ssm``: two scans a
   batch; ``rglru``: one scan a batch on its ``"kernel"`` route; ``cnn``:
   none); check the scores against the scorer on the same bucket batches
   (bitwise), one unpadded call (1e-6) and the CPU engine (1e-5); time the
   batch-1 loop; profile one pass (and require ``attn``'s decode to run
   ``flash_decode_lanes_kernel`` and ``rglru``'s scan the one-lane
   ``rglru_scan_tiles_kernel<1>``, once a batch);
10. time a launch's own floor (``add_`` on a one-element tensor), the
   sequence kernels at the serving path's shapes (B = 128; ``rglru_scan``
   also at the rglru detector's [128, 64, 16], with its launches and
   profiled device time on the ``rglru`` path), ``flash_attention`` and
   ``flash_decode`` beside SDPA (the ratios printed), and ``flash_decode``'s
   eager time as the detector calls it with and without the first port's
   per-call conversions; print each kernel's time less the floor beside its
   bound, and the ``kernels`` JSON line for all five kernels (the DP
   kernels also at the sweep's shape) with the floor;
11. the model grid of ``benchmarks/bench_models.py`` at its full settings
   (unsw/mlp and road_raw mlp, cnn, rglru, ssm, attn × seeds 0-2, 12
   clients, 2,400 samples, 40 rounds): each cell through ``run_fl_batch``,
   one runner build and a warm rerun that is a pure cache hit; fail on a
   non-finite loss or AUC or a mean AUC <= 0.5; print each mean AUC beside
   ``BENCH_models.json``'s (JAX on the CPU) and the warm wall; run the lane
   step of ``cnn`` and ``rglru`` on the card and on the CPU from the same
   states and draws (2 rounds: equal ``sel_mask``, state within rtol 1e-4
   / atol 1e-6);
12. the privacy frontier of ``benchmarks/bench_privacy.py`` at its full
   settings (unsw, 24 clients, 60 rounds, the adaptive schedule, budgets
   300/1,000/3,000/10,000 × seeds 0-3: 16 lanes, one runner build):
   every lane's ε within its budget, a lane's params bitwise frozen in
   every round it is not live, the DP kernels once a round, the in-loop ε
   of a uniform fixed-K lane equal to the host f64 composition (1e-6
   relative); the scheduled lane step on the card against the CPU with the
   same draws (``live`` and ``sel_mask`` equal, σ_t and state within rtol
   1e-4 / atol 1e-6); the warm wall a round with ``dp_scheduled`` on and
   off;
13. the plan frontier of ``benchmarks/bench_async.py`` at its full settings
   (unsw, 24 clients, 50 rounds; sync, ``buffered_async`` at K = 2 and 4,
   ``hierarchical`` at E = 4, × Markov and straggler lanes × seeds 0-3: 32
   lanes in one ``run_fl_sweep``): one runner build and warm hits, the
   loop under sync debug mode "error", the DP kernels once a round, every
   straggler lane's async time under sync's and hier's mean under flat's;
   each cell beside ``BENCH_async.json`` (JAX on the CPU), the warm wall
   and the async gate's Mann-Whitney p (printed, not gated); the lane step
   at plan codes 1 and 2 card vs CPU (equal ``sel_mask``, state within
   rtol 1e-4 / atol 1e-6); the DP kernels at the path's rows [768, P];
14. the population engine at ``benchmarks/bench_scale.py``'s full settings
   (pool 8,000, 32 members, k_max 16, 8 rounds, seeds 0-1) over 10^3,
   10^4, 10^5 and 10^6 clients through ``run_fl_population``: one runner
   build per population and hits after, finite accuracy, the loop under
   sync debug mode "error", generation/cold/warm walls, DP launches a
   round, the device busy share of a warm call, ``core/scale.py``'s
   predicted bytes beside the peak allocated; the sublinear gate (warm
   round wall 10^5/10^3 < 20); ``cohort_topk`` at [2, 10^6] bitwise equal
   to ``cohort_topk_host``, chunked (4, 16) and not; the cohort step card
   vs CPU (equal ``cohort_idx``/``take``, state within rtol 1e-4 / atol
   1e-6); the DP kernels at the cohort rows [32, P];
15. the dense LM serving path: granite-3-8b's ``config()`` (40 layers,
   d_model 4096, bf16, 8.2 B params) built on the card layer by layer from
   a seed; the prefill step ``forward(impl="flash", last_only=True)`` at
   B = 4, S = 512 with ``flash_attention``'s count set to 0 just before it
   and 40 launches required (one a layer), its warm wall, profile (device
   busy share, K3's device time: 40 calls of ``flash_attention_mma_kernel``
   required) and agreement with ``impl="ref"`` (bf16: 2e-2 relative and of
   max(1, max|logit|)); the same step at [1, 4096]; the serve CLI's path
   (``prefill_scan`` of 128-token prompts, then 32 greedy tokens: tok/s)
   with its last prefill logits against the prefill step's (the same
   tolerance counts the elements beyond it: no more than the scan has
   against the plain prefill, ``impl="ref"``, that pair's own floor; every
   argmax of both equal); phi3-mini's prefill at [1, 512] (32 launches,
   32 kernel calls); a 2-layer f32 variant at full
   width, card (K3's f32 row kernel) vs CPU (plain) within 1e-4; K3 at
   granite's [4, 512, 32 | 8, 128], phi3's [1, 512, 32 | 32, 96] and
   granite's long [1, 4096, 32 | 8, 128] (bf16, causal) against its plain
   version (2e-2, bitwise repeat), timed beside it, SDPA (GQA) and the
   bound;
16. the FL operations layer at the FL CLI's defaults (``python -m
   repro_torch.launch.fl_train``: unsw, 40 clients, ``mlp`` at hidden 64,
   clipped DP at ε 50, 100 rounds; nothing cut): the CLI in-process with
   ``--json-out`` and the tracer streaming JSONL into the output directory
   (the DP kernels 100 launches each, counted from 0 just before; the
   loop under sync debug mode "error"; ``eps_spent`` equal to the host
   accountant; one ``compile.runner_miss``, one ``runner.build`` and one
   of each ``sweep.*`` span in the JSONL), its warm round wall and the
   card's busy share of 10 profiled rounds; ``run_fl_batch`` at 4 lanes ×
   20 rounds with the tracer off and on, bitwise equal (histories and
   params) under sync debug mode "error", the walls recorded; the per-round
   driver at the same config saving the CUDA params every round through
   ``Checkpointer(keep=3)`` (3 kept, ``restore_latest`` onto CUDA bitwise),
   with ``fit_weibull`` over the run's failure gaps and
   ``optimal_checkpoint_interval`` printed; ``export_personalized`` of the
   CLI's params served by ``ServeEngine(heads=...)``, clients 0 and 39
   bitwise their ``personalized_client_params``' scores; the own-RNG
   check: ``run_fl_batch`` on the card's generators at seeds 0-9 against
   ``tests/golden/torch_rng_reference.json`` (the reference's finals),
   two-sided Mann-Whitney p >= 0.01 on final accuracy and ε within 1e-9,
   the α = 0.05 verdict and the AUC and mean-K tests printed; the DP
   kernels at the CLI's rows [40, 4,898] and the check's [400, 4,898]
   against their plain versions, timed beside ``vector_norm`` and the
   bound;
17. federated LM training: ``launch/train.py``'s ``train`` at the CLI's
   defaults with ``--dp`` (8 clients, 2 client slots a round, 1 local step,
   batch 2, seq 64, lr 0.005, clipped DP at ε 50 and clip 10, failures
   0.05, 3 rounds, remat "none") on granite-3-8b at full width with its
   depth cut 40 -> 8 (1,795,174,400 params, a row of 1,796,280,320
   elements with the norms and the vocab padding, bf16): the ``client_serial``
   round with K1a/K1b once per privatised slot (6, counted from 0 just
   before), finite losses, the eval loss before and after, the warm round
   wall, peak memory, a client step's forward+backward, one profiled round
   (busy share, spans, heaviest kernels); K1 at the update's row [1, P]
   against its plain versions (``sumsq_rows`` on its split plan to a
   relative 1e-6 and bitwise repeatable, ``scale_noise_rows`` bitwise),
   timed beside them, ``vector_norm``, ``addcmul`` on σ·n, the bound and
   ``sumsq_rows`` on the cluster plan; a 2-layer f32 cut at the same
   widths, 2 serial rounds with DP card vs CPU on the same draws and
   ``grad_accum`` 2 and remat "full"/"dots" against the plain step on the
   card, within 1e-4;
18. the recurrent LM families at full width and depth in bf16, after
   phases 15 and 17 have freed their models: recurrentgemma-9b's
   ``config()`` (38 layers, 26 ``rec`` and 12 local attention, 9,396,408,320
   elements, 20.54 GB) built on the card; its prefill step
   ``forward(impl="flash", last_only=True)`` at [4, 512] and [1, 4096]
   (where the window of 2048 binds) with both counts set to 0 just before
   it and 26 ``rglru_scan`` and 12 ``flash_attention`` launches required,
   its warm walls, profile (busy share; device ms of K2, K3, the cuBLAS
   GEMMs in f32 (the RG-LRU gates) and in bf16 by kernel name, and the
   rest) and agreement with ``impl="ref"`` (phase 15's bf16 bar, every
   argmax equal); the serve path (``generate``:
   128-token prompts at B = 4, 32 greedy tokens; ms a prefill_scan and a
   decode step, tok/s, peak) against the prefill step at phase 15's
   floor; a 2-layer f32 cut (``("rec", "rec")``, no attention: K3 refuses
   f32 above D = 128) card vs CPU within 1e-4 (the forward at both impls,
   2 K2 launches at ``"flash"``, 8 decode steps with their caches); K2 at
   [4, 512, 4096] and [1, 4096, 4096] bitwise its plain version, timed
   beside it and its bound; K3 at [4, 512, 16 | 1, 256] and [1, 4096, 16
   | 1, 256] with window 2048 beside SDPA (a boolean mask).  Then
   mamba2-130m: the serve CLI's ``main(["--arch", "mamba2_130m",
   "--full"])`` in-process at its defaults (no kernel launched, as the
   reference's LM routes none), its prefill step at [4, 512], and f32
   copies at full width card vs CPU (the forward at [2, 128] and 8 decode
   steps with their caches): 2 layers within 1e-4; all 24 also against
   the same weights in f64 on the CPU, the card's values held at 4 times
   the CPU's f32 distance from f64, read in the run;
19. the remaining one-card families in bf16, one model on the card at a
   time, each built after the last is freed (``memory_allocated``
   printed before each build, the element count held to the
   reference's): qwen2.5-32b whole (64 layers, 32,763,876,352 elements,
   65.53 GB): the prefill step at [4, 512] and [1, 4096] with 64
   ``flash_attention`` launches counted from 0 (busy share, device ms
   by kind), K3 against ``impl="ref"`` at bf16's floor read in the run
   (the plain bf16 prefill against the same weights walked in f32 one
   layer at a time: no logit further apart than twice its distance,
   every argmax equal), the serve path (``generate`` at B = 4, 128-token
   prompts, 32 greedy tokens) against both prefills at that floor;
   phi3.5-moe cut to 16 layers (21,069,172,736 elements) on both
   dispatches (16 launches each; the prefill bitwise repeatable; the
   first layer's routing bitwise alike), K3 and the scatter dispatch
   held at bf16's floor on the einsum run's replayed expert choices
   (free flips recorded, each within the runs' gate gap), its serve
   path; qwen2-vl-72b
   cut to 16 layers (16,534,380,544 elements) with 1,024 stub patches
   before 512 tokens at B = 2 on M-RoPE positions (16 launches), at
   bf16's floor, its serve path (text only); seamless-m4t-large-v2 whole
   (1,632,233,472 elements) through the serve CLI at ``--full`` (no
   kernel), then encode [4, 1024] frames + decode_train [4, 128]; a
   2-layer f32 cut of each card vs CPU within 1e-4 (the forward with its
   patches or frames, 4 decode steps on f32 caches; phi3.5-moe's on both
   dispatches, rows held until a routing flip); then the two whose
   whole weights need several cards, cut in depth: mistral-large-123b at
   16 of 88 layers (22,951,636,992 elements, 45.90 GB) as qwen2.5 (16
   launches; no long prefill) and llama4-maverick-400b at 2 of 48, one
   ("attn", "moe") pair (18,429,404,160 elements; top-1 over 128
   experts, 5 slots an expert a sequence) as phi3.5-moe (2 launches on
   each dispatch; the bound of reading its 32.2 GB of experts printed;
   the f32 walk casts 16 experts at a time), its f32 check a pair with
   the experts cut to 8; K3 at qwen2.5's [4, 512, 40 | 8, 128],
   qwen2-vl's [2, 1536, 64 | 8, 128] and mistral's [4, 512, 96 | 8, 128]
   against its plain version, timed beside SDPA and its bound;
20. federated training of the MoE, VLM and encoder-decoder families:
   ``launch/train.py``'s ``train`` at phase 17's settings (the CLI's
   defaults with ``--dp``) on phi3.5-moe at 2 layers, qwen2-vl-72b at 1
   layer (1,024 stub patches a row) and seamless-m4t-large-v2 whole
   (1,024 stub frames a row), one at a time, each at the deepest cut
   the card holds: K1a/K1b once a privatised slot (6, counted from 0),
   finite losses, the eval loss before and after, the warm round wall,
   peak memory, one profiled round; K1 at each family's row [1, P]
   (2,864,861,184, 3,369,109,504 and 1,632,233,472 elements: the first
   past 2^31) against its plain versions as phase 17, also in place; an
   f32 check of each (1 layer, full d_model, a cut vocabulary: a check
   only) card vs CPU on the same draws: a round without DP and the first
   noised round within 1e-4, the second within 8 times the larger of the
   card's grad_accum and state gaps.
21. the sharding layer (``launch/steps.py``, DTensor placements from the
   rule tables) on one-device meshes over a world-size-1 NCCL group
   (in-process store, no network): granite-3-8b whole, the prefill
   bundle at [4, 512] and the decode bundle (B = 4, a 512-token cache, 8
   steps) on the (1, 1) and the multi-pod (1, 1, 1) meshes against the
   unsharded ``forward(impl="ref", last_only=True)`` and ``decode_step``
   (bitwise, or the first difference printed and phase 15's bf16 bar),
   both walls printed; the ``client_serial`` train bundle on phase 17's
   8-layer cut and settings with ``--dp`` against phase 17's
   ``make_serial_round`` on the same state and draws (bitwise, or within
   8 times its grad_accum gap), K1a/K1b once a privatised slot on the
   rank's local row; then ``launch/dryrun.py`` on this torch, each pair
   in a subprocess of its own on a fake 256-rank group: mistral-large-123b
   and llama4-maverick-400b at ``prefill_32k`` and ``decode_32k``, their
   per-rank bytes against 80 GB, flops, collective bytes and wall;
22. the ``client_parallel`` round (the LM ``make_parallel_round``:
   clients one after another, each update one row of ``[n, P]``, K1 on
   the rows) and its train bundle, over a world-size-1 NCCL group:
   (a) the bundle on the (1, 1) mesh on phase 17's granite-3-8b cut to 8
   layers (bf16) with ``make_fl_config``'s clipped DP, one client a data
   rank, against the unsharded round on the same weights and draws
   (bitwise, or within 8 times its grad_accum gap), K1a/K1b once a
   client, both walls and peaks; (b) the unsharded round at 4 clients on
   the same cut: walls, busy share, peak, K1 once a round on [4,
   1,796,280,320] (counted from 0), then K1 at that shape against its
   plain versions (``sumsq_rows`` on the split plan to a relative 1e-6;
   ``scale_noise_rows`` in place, bitwise, every element checked against
   inputs that are closed forms of their index), timed by CUDA events
   beside ``vector_norm`` / ``addcmul_`` and the bound; a 1-layer f32 cut
   at 4 clients card vs CPU on the same draws (masks equal, values
   within 1e-4); (c) the sweep and population engines on one rank
   re-run phase 7b's grid and phase 14's 10^3 and 10^6 populations,
   bitwise their histories.  The lane and lane × client meshes need two
   ranks or more, which one card does not give: they are checked by the
   gloo suite on the CPU only.

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
OUT_DIR = ROOT / "chiprun_out"   # the run's record, traces and checkpoints
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM data sheet, fp32 outside tensor cores
BF16_FLOP_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
SLICE_ROWS, SLICE_P = 40, 13_890
PAPER_EPS_10_ROUNDS = 11.345620277107383  # reference accounted_epsilon(fl, 10)
ROUNDS = 10
SERVE_ROUNDS = 30          # the serve CLI's default training rounds
SERVE_REPEAT = 6           # replays of the 1,500 test windows: 9,000 windows
SERVE_BUCKETS = (16, 128)
SERVE_CHUNK = 37
SERVE_MODELS = ("attn", "ssm", "rglru", "cnn")
SPANS = ("fl.batches", "fl.round_step", "fl.sim_time", "fl.eval",
         "selection", "local_train", "dp_privatize", "aggregate",
         "async_buffer", "hier_aggregate")
# phase 7b: Fig. 3's ε column (benchmarks/bench_fig3.py) × REPRO_FULL's 10
# seeds on the paper's config: 40 lanes of 40 clients, 1,600 client rows
SWEEP_EPS = (30.0, 100.0, 300.0, 1000.0)
SWEEP_SEEDS = tuple(range(10))
SWEEP_ROUNDS, SWEEP_EVAL = 20, 10
SWEEP_SPANS = ("sweep.prepare", "sweep.execute", "sweep.readback",
               "selection", "local_train", "dp_privatize", "aggregate",
               "async_buffer", "hier_aggregate", "eval_block")


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


def timed(kernel, plain, library, iters: int = 100):
    """Device times (CUDA-graph replay of ``iters`` calls) of the kernel,
    its plain version and the library yardstick, and the same calls issued
    one by one (``2·iters`` of them)."""
    dev = lambda fn: device_ms(fn, iters)  # noqa: E731
    eager = lambda fn: eager_ms(fn, 2 * iters)  # noqa: E731
    out = {"ms": dev(kernel), "plain_ms": dev(plain),
           "library_ms": None if library is None else dev(library),
           "eager_ms": eager(kernel), "eager_plain_ms": eager(plain)}
    if library is not None:
        out["eager_library_ms"] = eager(library)
    return out


# (r, p, offset): x [r, p] starting `offset` elements past a 16-byte
# boundary.  The paper config's update (P ≡ 2 mod 4: every other row starts
# 8 bytes off), the grid of PR 11, P ≡ 1 and 3, the update one element off,
# rows shorter than a cluster's blocks (empty blocks), one row of 10⁶ and
# 1,000 rows (one block a row); then rows the split plan takes: one row
# just past its threshold, one element off, and 3 rows with P ≡ 2 mod 4
SQ_CASES = [(SLICE_ROWS, SLICE_P, 0)] + [
    (r, p, 0) for p in (64, 1000, 40_000) for r in (1, 7)] + [
    (5, 1001, 0), (5, 4099, 0), (SLICE_ROWS, SLICE_P, 1), (5, 4099, 1),
    (3, 5, 0), (2, 30, 3), (1, 1_000_000, 0), (1000, SLICE_P, 0),
    (1, 8_388_613, 1), (3, 9_000_002, 0)]
SQ_BRANCHES = {"cluster", "one block", "split", "head", "float4", "tail",
               "empty"}


def sumsq_branches(dpk, x) -> set:
    """The branches ``sumsq_rows`` takes on ``x [R, P]``: a cluster of
    blocks a row, one block, or the split plan, and per block a scalar
    head, 16-byte loads, a scalar tail or no columns at all."""
    r, p = x.shape
    plan = dpk.sumsq_plan(r, p)
    out = {"split" if plan.split > 1
           else "cluster" if plan.cluster > 1 else "one block"}
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
        plan = dpk.sumsq_plan(r, p)
        print(f"  [{r:>4}, {p:>7}] + {offset}  "
              f"C={plan.cluster} S={plan.split}  sumsq max|err| "
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
        draws = rounds_lib.draw_round([draw_gen], n, fl.local_epochs,
                                      n_params, fl.selection).lane(0)
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
    copies; the ``record_function`` spans, the program's device phases
    among them, also show up on the device timeline, as annotations, and
    are left out), their busy ms, the host ms of each span, and (calls,
    device ms) per kernel name."""
    from torch.autograd import DeviceType
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name not in span_names
              and not getattr(e, "is_user_annotation", False)]
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


def sweep_cells(fl):
    import dataclasses
    return [dataclasses.replace(fl, dp_epsilon=e) for e in SWEEP_EPS]


class SyncModeSpy:
    """Records the modes ``torch.cuda.set_sync_debug_mode`` is set to while
    it is entered: the engines set "error" around their round loops."""

    def __init__(self, torch):
        self.torch, self.modes = torch, []

    def __enter__(self):
        self.original = self.torch.cuda.set_sync_debug_mode

        def spy(mode):
            self.modes.append(mode)
            self.original(mode)

        self.torch.cuda.set_sync_debug_mode = spy
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode = self.original

    def ok(self) -> bool:
        return self.modes[:1] == ["error"] and len(self.modes) % 2 == 0


def check_sync_debug_raises(torch) -> None:
    """The mode the sweep engine runs its round loop under catches a host
    synchronisation in this build: ``.item()`` raises under it."""
    t = torch.zeros(1, device="cuda")
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t.item()
    except RuntimeError:
        return
    finally:
        torch.cuda.set_sync_debug_mode(before)
    raise AssertionError("sync debug mode 'error' did not catch .item()")


def phase_sweep(torch, fed, fl, dpk, accounted_epsilon, legacy_walls):
    """Phase 7b: ``run_fl_sweep`` on the paper's config over Fig. 3's ε
    column × 10 seeds (40 lanes, 1,600 client rows), 20 rounds, eval every
    10, then the checks and walls.  Returns the phase's record; the DP
    kernels' launches are those of the first sweep's run."""
    import numpy as np

    from repro_torch.train import fl_driver

    cells = sweep_cells(fl)
    lanes = len(cells) * len(SWEEP_SEEDS)
    kw = dict(seeds=SWEEP_SEEDS, rounds=SWEEP_ROUNDS, eval_every=SWEEP_EVAL,
              hidden=128, device="cuda")
    check_sync_debug_raises(torch)
    stats0 = dict(fl_driver.RUNNER_STATS)
    torch.cuda.synchronize()
    dpk.reset_launches()
    with SyncModeSpy(torch) as spy:
        t0 = time.perf_counter()
        res = fl_driver.run_fl_sweep(fed, fl, cells, **kw)
        cold_s = time.perf_counter() - t0
    launches = dict(dpk.LAUNCHES)
    check(spy.ok() and len(spy.modes) == 2, f"the round loop did not run "
          f"under sync debug mode 'error': {spy.modes}")
    check(fl_driver.RUNNER_STATS["misses"] == stats0["misses"] + 1,
          "the grid did not build exactly one runner")
    t0 = time.perf_counter()
    again = fl_driver.run_fl_sweep(fed, fl, cells, **kw)
    warm_s = time.perf_counter() - t0
    check(fl_driver.RUNNER_STATS["hits"] == stats0["hits"] + 1 and
          fl_driver.RUNNER_STATS["misses"] == stats0["misses"] + 1,
          "a second call of the same grid did not hit the runner cache")
    for name, n in launches.items():
        check(n == SWEEP_ROUNDS, f"kernel {name}: {n} launches in "
              f"{SWEEP_ROUNDS} sweep rounds (want one a round for all "
              f"{lanes} lanes)")
    check(len(res) == len(cells) and all(len(r) == len(SWEEP_SEEDS)
                                         for r in res), "result shape")
    keys = ("loss", "acc", "auc", "k", "fail", "cum_time")
    for row in res:
        for r in row:
            check(r.history["round"] == [SWEEP_EVAL, SWEEP_ROUNDS],
                  "eval rounds")
            check(all(math.isfinite(v) for k in keys for v in r.history[k]),
                  "sweep history has non-finite values")
            check(all(0.0 <= a <= 1.0 for a in r.history["acc"]),
                  "accuracy out of [0, 1]")
    eps = [row[0].eps_spent for row in res]
    for cell, row in zip(cells, res):
        want = accounted_epsilon(cell, SWEEP_ROUNDS)
        check(all(abs(r.eps_spent - want) <= 1e-12 for r in row),
              f"eps_spent differs from the host accountant at "
              f"ε={cell.dp_epsilon}")
    check(len(set(eps)) == len(cells),
          f"ε does not differ across cells: {eps}")
    # lanes against single runs of their cell and seed, at the reference's
    # tolerances (tests/test_sweep.py): atol 1e-5 on accuracy, rtol 1e-5 on
    # the simulated time
    singles = {}
    for ci, si in ((0, 0), (len(cells) - 1, len(SWEEP_SEEDS) - 1)):
        one = fl_driver.run_fl(fed, cells[ci], seed=SWEEP_SEEDS[si],
                               rounds=SWEEP_ROUNDS, eval_every=SWEEP_EVAL,
                               hidden=128, device="cuda")
        lane = res[ci][si]
        check(one.eps_spent == lane.eps_spent, "run_fl ε differs from lane")
        np.testing.assert_allclose(lane.history["acc"], one.history["acc"],
                                   atol=1e-5)
        np.testing.assert_allclose(lane.history["cum_time"],
                                   one.history["cum_time"], rtol=1e-5)
        singles[f"{ci},{si}"] = {
            k: [lane.history[k], one.history[k]] for k in keys}
        print(f"  lane ({ci}, {si}) = run_fl(ε={cells[ci].dp_epsilon}, "
              f"seed={SWEEP_SEEDS[si]}): acc {lane.history['acc']} / "
              f"{one.history['acc']}, loss {lane.history['loss']} / "
              f"{one.history['loss']}")
    legacy_ms = statistics.median(legacy_walls[1:])
    out = {
        "lanes": lanes, "client_rows": lanes * fed.n_clients,
        "rounds": SWEEP_ROUNDS, "eval_every": SWEEP_EVAL,
        "launches": launches, "cold_s": cold_s, "warm_s": warm_s,
        "warm_ms_per_round": 1e3 * warm_s / SWEEP_ROUNDS,
        "warm_ms_per_lane_round": 1e3 * warm_s / SWEEP_ROUNDS / lanes,
        "legacy_round_ms_median": legacy_ms,
        "eps_per_cell": eps, "lanes_vs_run_fl": singles,
        "final_acc_mean_per_cell": [
            float(np.mean([r.accuracy for r in row])) for row in res],
        "final_auc_mean_per_cell": [
            float(np.mean([r.auc for r in row])) for row in res],
        "histories": [[r.history for r in row] for row in res],
        "repeat_equal": all(a.history == b.history for ra, rb in
                            zip(res, again) for a, b in zip(ra, rb)),
    }
    print(f"  {lanes} lanes x {fed.n_clients} clients, {SWEEP_ROUNDS} "
          f"rounds: one runner build, a hit on the second call; launches "
          f"{launches}; loop under sync debug mode 'error'")
    print(f"  eps per cell {eps}; mean final acc per cell "
          f"{out['final_acc_mean_per_cell']}")
    print(f"  wall: first call {cold_s:.2f} s, second {warm_s:.2f} s = "
          f"{out['warm_ms_per_round']:.2f} ms a round, "
          f"{out['warm_ms_per_lane_round']:.3f} ms a lane-round; "
          f"run_fl_legacy (phase 4) {legacy_ms:.2f} ms a round; "
          f"second call bitwise equal to the first: {out['repeat_equal']}")
    return out


def phase_sweep_profile(torch, fed, fl, rounds: int = 3):
    """Phase 7b: ``torch.profiler`` over a warm 3-round sweep of the same
    40 lanes (one eval block): the card's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import fl_driver

    kw = dict(seeds=SWEEP_SEEDS, rounds=rounds, eval_every=rounds,
              hidden=128, device="cuda")
    fl_driver.run_fl_sweep(fed, fl, sweep_cells(fl), **kw)  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fl_driver.run_fl_sweep(fed, fl, sweep_cells(fl), **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device, busy_ms, spans, by_kernel = profile_summary(prof.events(),
                                                        SWEEP_SPANS)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    out = {"rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
           "device_busy_ms_per_round": busy_ms / rounds,
           "device_busy_share": busy_ms / wall_ms,
           "device_ops_per_round": len(device) / rounds,
           "span_host_ms_per_round": {k: v / rounds
                                      for k, v in spans.items()},
           "top_kernels": [{"name": k[:80], "calls": n, "device_ms": t}
                           for k, (n, t) in top]}
    print(f"  profile, {rounds} warm sweep rounds: wall "
          f"{out['wall_ms_per_round']:.2f} ms a round, device busy "
          f"{out['device_busy_ms_per_round']:.3f} ms a round (share "
          f"{out['device_busy_share']:.3f}), "
          f"{out['device_ops_per_round']:.0f} device ops a round")
    for k, v in out["span_host_ms_per_round"].items():
        print(f"  span {k}: {v:.2f} ms a round (host)")
    for k in out["top_kernels"]:
        print(f"  kernel {k['name']}: {k['calls']} calls, "
              f"{k['device_ms']:.3f} ms")
    return out


def lane_steps_card_vs_cpu(torch, dpk, small, fl, cells, hidden: int,
                           rounds: int, label: str):
    """The lane step on the card and on the CPU from the same states with
    the same draws and batches: ``cells`` × seeds 0 and 1 (cell-major),
    ``rounds`` rounds on the federation ``small``.  Under
    ``fl.dp_scheduled`` each round goes through ``scheduled_round`` (a
    ``rounds``-round plan).  Each round: equal ``sel_mask`` (and ``live``),
    and params, utility, K and fault state (and σ_t, the accountant and
    the scheduler) within rtol 1e-4 / atol 1e-6; on the card the DP
    kernels launch once each a round.  Returns ``(max |card − cpu|, the
    live gates per round or None)``."""
    from repro_torch import convert
    from repro_torch.configs.base import params_lanes
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.data.synthetic import (draw_batch_indices,
                                            sample_round_batches,
                                            stack_federation)
    from repro_torch.models.spec import get_model_spec, meta_for
    from repro_torch.privacy import accountant as acct_lib
    from repro_torch.train import fl_driver
    from repro_torch.tree import flatten_rows

    scheduled = fl.dp_enabled and fl.dp_scheduled
    n = small.n_clients
    spec = get_model_spec(fl.model, meta_for(small, hidden=hidden))
    sizes = small.data_sizes()
    cpu_states = []
    for seed in (0, 1):
        gen = torch.Generator().manual_seed(seed)
        cpu_states.append(rounds_lib.init_round_state(
            spec.init(gen), fl, gen, n_clients=n,
            data_size=torch.as_tensor(sizes / sizes.mean()),
            data_quality=torch.as_tensor(small.label_entropy())))
    lanes = [cpu_states[i % 2] for i in range(2 * len(cells))]
    states = {"cpu": rounds_lib.stack_states(lanes),
              "cuda": rounds_lib.stack_states([
                  convert.round_state_from_jax(s.params, s.util, s.kctl,
                                               s.fault, fl, "cuda")
                  for s in lanes])}
    steps = {dev: rounds_lib.make_lane_round(spec.loss, fl, n, device=dev)
             for dev in states}
    prs = {dev: params_lanes(cells, 2, dev) for dev in states}
    stacks = {dev: stack_federation(small, dev) for dev in states}
    if scheduled:
        grids = {dev: acct_lib.order_grid(fl.dp_delta, dev)
                 for dev in states}
        privs = {dev: fl_driver.init_privacy(fl, prs[dev], grids[dev], n,
                                             rounds) for dev in states}
    n_params = flatten_rows(cpu_states[0].params, 0).numel()
    launches0 = sum(dpk.LAUNCHES.values())
    worst, lives = 0.0, []
    for r in range(rounds):
        gens = [torch.Generator().manual_seed(10 * r + i)
                for i in range(len(lanes))]
        idx = draw_batch_indices(gens, stacks["cpu"].sizes, fl.local_epochs,
                                 fl.local_batch)
        draws = rounds_lib.draw_round(gens, n, fl.local_epochs, n_params,
                                      fl.selection)
        metrics, extra, gates = {}, {}, {}
        for dev in states:
            batches = sample_round_batches(stacks[dev], idx.to(dev))
            if scheduled:
                states[dev], metrics[dev], privs[dev], sigma, live = \
                    fl_driver.scheduled_round(
                        steps[dev], fl, states[dev], batches, prs[dev],
                        draws.to(dev), privs[dev], grids[dev], rounds)
                extra[dev] = [sigma, *privs[dev].acct[:2],
                              *privs[dev].sched]
                gates[dev] = live.cpu()
            else:
                states[dev], metrics[dev] = steps[dev](
                    states[dev], batches, prs[dev], draws.to(dev))
                extra[dev] = []
        check(torch.equal(metrics["cpu"].sel_mask,
                          metrics["cuda"].sel_mask.cpu()),
              f"{label}: lane sel_mask differs on round {r + 1}")
        if scheduled:
            check(torch.equal(gates["cpu"], gates["cuda"]),
                  f"{label}: live differs on round {r + 1}")
            lives.append(gates["cpu"].tolist())
        cpu, gpu = states["cpu"], states["cuda"]
        pairs = [(flatten_rows(gpu.params), flatten_rows(cpu.params))]
        pairs += list(zip(gpu.util, cpu.util)) + list(zip(gpu.kctl, cpu.kctl))
        pairs += list(zip(gpu.fault, cpu.fault))
        pairs += list(zip(extra["cuda"], extra["cpu"]))
        for a, c in pairs:
            torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-6)
            worst = max(worst, max_abs(a.cpu(), c))
        print(f"  {label} round {r + 1}: sel_mask equal "
              f"({metrics['cpu'].sel_mask.sum(dim=1).tolist()} selected a "
              f"lane)" + (f", live {lives[-1]} equal" if scheduled
                          else "") +
              f"; state max|card-cpu| {worst:.3e}")
    if fl.dp_enabled:
        check(sum(dpk.LAUNCHES.values()) - launches0 == 2 * rounds,
              f"{label}: the card's lane steps did not go through the "
              f"DP kernels")
    return worst, (lives if scheduled else None)


def phase_sweep_card_vs_cpu(torch, dpk):
    """Phase 7b: the lane step card vs CPU, 2 cells (iid at ε = 100,
    Markov outages) × 2 seeds, 3 rounds, at a small size."""
    import dataclasses

    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import make_federated

    small = make_federated(0, "unsw", n_samples=2_000, n_clients=10)
    fl = FLConfig(n_clients=10, clients_per_round=4, local_epochs=3,
                  local_batch=32, dp_epsilon=100.0, dp_clip=5.0,
                  failure_prob=0.2)
    cells = [fl, dataclasses.replace(fl, fault_process=1.0)]
    return lane_steps_card_vs_cpu(torch, dpk, small, fl, cells, 32, 3,
                                  "lane step")[0]


def phase_sweep_kernels(torch, dpk, ref, launches):
    """Phase 7b: the DP kernels at the sweep's shape [1600, 13890] against
    their plain versions (``scale_noise_rows`` with one σ a row, from the
    cells' ε, bitwise; ``sumsq_rows`` to rtol 1e-5), and their rows of the
    kernels JSON line: device times by the ``device_ms`` protocol (20
    calls a graph: an 89 MB array a call), the bytes bound, the library
    call and the sweep's launches."""
    from repro_torch.configs.base import params_lanes
    from repro_torch.configs.paper_mlp import paper_fl_config
    from repro_torch.core import dp as dp_lib

    fl = paper_fl_config()
    r, p = len(SWEEP_EPS) * len(SWEEP_SEEDS) * fl.n_clients, SLICE_P
    gen = torch.Generator().manual_seed(12)
    x = (torch.randn(r, p, generator=gen) * 0.05).cuda()
    nz = torch.randn(r, p, generator=gen).cuda()
    pr = params_lanes(sweep_cells(fl), len(SWEEP_SEEDS), "cuda")
    sigma = dp_lib.gaussian_sigma_rt(pr.dp_epsilon, fl.dp_delta,
                                     pr.dp_clip).repeat_interleave(
                                         fl.n_clients).contiguous()
    sq = dpk.sumsq_rows(x)
    sq_ref = ref.sumsq_rows_ref(x)
    torch.testing.assert_close(sq, sq_ref, rtol=1e-5, atol=0)
    check(dpk.sumsq_plan(r, p).cluster == 1, "sumsq plan at R = 1600")
    scale = ref.clip_scale(torch.sqrt(sq_ref), 1.0)
    o = dpk.scale_noise_rows(x, nz, scale, sigma)
    o_ref = ref.scale_noise_rows_ref(x, nz, scale, sigma)
    check(torch.equal(o, o_ref), "scale_noise_rows with one σ a row is not "
          "bitwise its plain version at [1600, 13890]")
    check(torch.equal(dpk.scale_noise_rows(x, nz, scale, 0.6),
                      dpk.scale_noise_rows(x, nz, scale,
                                           torch.full((r,), 0.6,
                                                      device="cuda"))),
          "the scalar-σ and per-row-σ entries differ at one σ")
    errs = {"sumsq_rows": max_abs(sq, sq_ref),
            "scale_noise_rows": max_abs(o, o_ref)}
    print(f"  [{r}, {p}]: sumsq_rows max|err| {errs['sumsq_rows']:.3e} "
          f"(C = 1); scale_noise_rows (one σ a row) bitwise equal to plain; "
          f"scalar and per-row σ entries bitwise equal")
    sn = sigma[:, None] * nz
    scale_col = scale[:, None]

    def times(kernel, plain, library):
        """:func:`timed` with 20 calls a graph and 50 eager calls a rep."""
        out = {"ms": device_ms(kernel, iters=20),
               "plain_ms": device_ms(plain, iters=20),
               "library_ms": (None if library is None
                              else device_ms(library, iters=20)),
               "eager_ms": eager_ms(kernel, iters=50),
               "eager_plain_ms": eager_ms(plain, iters=50)}
        if library is not None:
            out["eager_library_ms"] = eager_ms(library, iters=50)
        return out

    rows = []
    b_sq, by_sq = sumsq_bound(r, p)
    rows.append({
        "name": "sumsq_rows_sweep_shape", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dp_clip_noise.cu",
        "replaces": "src/repro/kernels/dp_clip_noise.py:62",
        "shape": [r, p], "launches": launches["sumsq_rows"],
        "max_abs_err": errs["sumsq_rows"],
        "bound_ms": b_sq, "bound_by": by_sq,
        **times(lambda: dpk.sumsq_rows(x), lambda: ref.sumsq_rows_ref(x),
                lambda: torch.linalg.vector_norm(x, dim=1)),
    })
    # x, noise, out [R, P]; scale and σ [R]
    b_sn, by_sn = bound(12 * r * p + 8 * r, 3 * r * p)
    rows.append({
        "name": "scale_noise_rows_sweep_shape", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dp_clip_noise.cu",
        "replaces": "src/repro/kernels/dp_clip_noise.py:81",
        "shape": [r, p], "launches": launches["scale_noise_rows"],
        "max_abs_err": errs["scale_noise_rows"],
        "bound_ms": b_sn, "bound_by": by_sn,
        # no single PyTorch call takes (x, noise, scale, σ): addcmul on σ·n
        # prepared outside the timed region is the yardstick
        **times(lambda: dpk.scale_noise_rows(x, nz, scale, sigma),
                lambda: ref.scale_noise_rows_ref(x, nz, scale, sigma), None),
        "addcmul_ms": device_ms(lambda: torch.addcmul(sn, x, scale_col),
                                iters=20),
    })
    for k in rows:
        yardstick = ("library %.2f us" % (k["library_ms"] * 1e3)
                     if k["library_ms"] is not None else
                     "addcmul %.2f us" % (k["addcmul_ms"] * 1e3))
        print(f"  {k['name']}: device {k['ms'] * 1e3:.2f} us, bound "
              f"{k['bound_ms'] * 1e3:.2f} us ({k['bound_by']}), plain "
              f"{k['plain_ms'] * 1e3:.2f} us, {yardstick}, launches "
              f"{k['launches']}")
    return rows


# (b, s, t, hq, hkv, d, causal, window): the grid of tests/test_kernels.py,
# the attn detector's path shape, a ragged S = T = 100, a causal offset,
# S > T (rows with no valid key), GQA at the detector's width, D = 32
# with a window, and phi3's D = 96 with a ragged last block of rows.  Then
# the tensor-core kernel's cases (bf16 at D > 32; f32 there runs the row
# kernel, and is refused at D = 256): S > T, T > S (the prefix offset), S
# and T not multiples of the tiles, a window shorter than a key tile,
# non-causal, GQA 4 and MQA, D = 256 (recurrentgemma's local attention),
# and D = 36 (padded into DMAX 64, copied 2 bytes at a time)
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
            (2, 64, 64, 2, 2, 32, True, 16),
            (1, 200, 200, 4, 4, 96, True, None),
            (1, 96, 64, 4, 1, 128, True, None),
            (2, 64, 192, 8, 2, 96, True, None),
            (1, 200, 200, 8, 2, 128, True, None),
            (1, 256, 256, 4, 2, 128, True, 16),
            (2, 100, 130, 4, 4, 64, False, None),
            (1, 64, 200, 4, 4, 96, True, 40),
            (8, 256, 256, 16, 4, 64, True, None),
            (1, 300, 300, 16, 1, 256, True, 64),
            (1, 130, 130, 8, 2, 256, False, None),
            (1, 96, 64, 16, 1, 256, True, None),
            (1, 70, 90, 2, 2, 36, True, 20)]
# flash_attention_kernel<T, DMAX, G> and flash_attention_row_kernel<T, DMAX>
# in ptxas' mangled names
FA_KERNEL_NAME = re.compile(
    r"22flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E")
FA_ROW_KERNEL_NAME = re.compile(
    r"26flash_attention_row_kernelI(f|13__nv_bfloat16)Li(\d+)EE")
# flash_attention_mma_kernel<DMAX>, and the name the profiler reports its
# launches under
FA_MMA_KERNEL_NAME = re.compile(r"26flash_attention_mma_kernelILi(\d+)EEEv")
FA_MMA_KERNEL = "flash_attention_mma_kernel"
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
# rglru_scan_tiles_kernel<VEC>, and sumsq_rows' cluster kernel and the
# split plan's two
RG_KERNEL_NAME = re.compile(r"23rglru_scan_tiles_kernelILi(\d+)EE")
SQ_KERNEL_NAME = re.compile(r"\d\dsumsq_rows_(cluster|split|finish)_kernel")


def ptxas_report(log: str, name_re, kernel: str) -> dict:
    """Phase 2: ptxas' report (``-Xptxas -v``) of each instantiation of a
    kernel, ``"<template arguments>"`` (the name's groups; f32 or bf16 for a
    type) -> registers and the bytes of spill stores and loads, printed."""
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
    return report


def check_ptxas(log: str, name_re, kernel: str, n_instances: int) -> dict:
    """:func:`ptxas_report`, requiring all ``n_instances`` reported and no
    spill in any."""
    report = ptxas_report(log, name_re, kernel)
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


def check_fa_mma_ptxas(log: str) -> dict:
    """``flash_attention_mma_kernel``: DMAX 64, 96, 128, 256."""
    return check_ptxas(log, FA_MMA_KERNEL_NAME, FA_MMA_KERNEL, 4)


def check_fd_ptxas(log: str) -> dict:
    """``flash_decode_lanes_kernel``: f32 and bf16 at DMAX 8, 16, 32
    (G = 32)."""
    return check_ptxas(log, FD_KERNEL_NAME, "flash_decode_lanes_kernel", 6)


def check_rg_ptxas(log: str) -> dict:
    """``rglru_scan_tiles_kernel``: 4 lanes a thread (16-byte loads) and 1."""
    return check_ptxas(log, RG_KERNEL_NAME, "rglru_scan_tiles_kernel", 2)


def check_sq_ptxas(log: str) -> dict:
    """``sumsq_rows_{cluster,split,finish}_kernel``: one instance each."""
    return check_ptxas(log, SQ_KERNEL_NAME, "sumsq_rows", 3)


def check_flash_attention(torch, fak, ref, randn) -> float:
    """Phase 8 for ``flash_attention``: every case of :data:`FA_CASES` in
    f32 (2e-5) and bf16 (2e-2) against the plain version, and two calls
    bitwise equal (f32 at D > 128 must be refused).  Returns the f32 max
    abs error at :data:`FA_PATH`."""
    err = None
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for case in FA_CASES:
            b, s, t, hq, hkv, d, causal, window = case
            q, k, v = (randn(b, s, hq, d, dtype=dtype),
                       randn(b, t, hkv, d, dtype=dtype),
                       randn(b, t, hkv, d, dtype=dtype))
            if dtype == torch.float32 and d > fak.MAX_HEAD_DIM_F32:
                try:
                    fak.flash_attention(q, k, v, causal=causal, window=window)
                except ValueError as e:
                    print(f"  flash_attention float32 {case}: refused ({e})")
                    continue
                raise AssertionError(f"f32 at D = {d} was not refused")
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
    from repro_torch.train.fl_driver import run_fl

    # the serve CLI's training config (python -m repro_torch.serve)
    fl = FLConfig(n_clients=fed.n_clients,
                  clients_per_round=max(4, fed.n_clients // 5),
                  rounds=SERVE_ROUNDS, local_epochs=2, local_batch=32,
                  local_lr=0.08, dp_enabled=False, fault_tolerance=False,
                  model=name)
    t0 = time.perf_counter()
    res = run_fl(fed, fl, "random", seed=0, rounds=SERVE_ROUNDS,
                 eval_every=max(SERVE_ROUNDS // 4, 1), dataset="road_raw",
                 hidden=64, return_params=True, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print(f"  trained {name} for {SERVE_ROUNDS} rounds in {train_s:.1f} s: "
          f"acc={res.accuracy:.4f} auc={res.auc:.4f}")
    path = save_serving_checkpoint(
        str(OUT_DIR / "serve_ckpt" / f"serve_{name}_road_raw"),
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
    # attn: attention + decode a batch; ssm: two scans a batch (two
    # time-rolled views); rglru: one scan a batch; cnn: no kernel
    scans = {"ssm": 2, "rglru": 1}.get(name, 0)
    attn = rep.n_batches if name == "attn" else 0
    want = {"flash_attention": attn, "flash_decode": attn,
            "rglru_scan": scans * rep.n_batches}
    check(launches == want, f"{name}: launches {launches} != {want} for "
          f"{rep.n_batches} batches")
    check(rep.n_batches > 0 and (name == "cnn" or any(want.values())),
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
    if name == "rglru":  # one lane a thread at [bucket, 64, 16], once a batch
        scan = {k: v for k, v in prof["seq_kernels"].items()
                if "rglru_scan" in k}
        check(len(scan) == 1 and re.search(r"rglru_scan_tiles_kernel<1\b",
                                           next(iter(scan))) and
              next(iter(scan.values()))["calls"] == prof["batches"],
              f"rglru: the profiled scan kernels are {scan}")
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


def phase_seq_timing(torch, fak, fdk, rgk, ref, errs, serve):
    """Phase 10: the sequence kernels at the serving path's shapes (the
    128-window bucket), rows of the kernels JSON line; launches are the
    serving path's (phase 9), ``rglru_scan`` on the ``ssm`` path at
    [128, 4, 512] and on the ``rglru`` path at [128, 64, 16], the latter
    also with its device time in the ``rglru`` path's profile."""
    launches = {
        "flash_attention": serve["attn"]["launches"]["flash_attention"],
        "flash_decode": serve["attn"]["launches"]["flash_decode"]}
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
    for name, case, path in (("rglru_scan", RG_PATH, "ssm"),
                             ("rglru_scan_rglru_shape", RG_RGLRU, "rglru")):
        b, l, w, with_h0 = case
        a, x = torch.sigmoid(randn(b, l, w)), randn(b, l, w)
        h0 = randn(b, w) if with_h0 else None
        h_ref = ref.rglru_scan_ref(a, x, h0)[0]
        b_rg, by_rg = scan_bound(case)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan.py:60",
            "shape": list(case[:3]),
            "launches": serve[path]["launches"]["rglru_scan"],
            "max_abs_err": max_abs(rgk.rglru_scan(a, x, h0)[0], h_ref),
            "bound_ms": b_rg, "bound_by": by_rg,
            # no single PyTorch call computes a sequential linear recurrence
            **timed(lambda: rgk.rglru_scan(a, x, h0),
                    lambda: ref.rglru_scan_ref(a, x, h0), None),
            # per-call device µs in the path's profile (buckets 16 and 128)
            "path_profile_device_us": {
                k: v["device_us"] for k, v in
                serve[path]["profile"]["seq_kernels"].items()
                if "rglru_scan" in k},
        })
    return rows


# phase 11: benchmarks/bench_models.py's full settings (its GRID and
# _bench_fl), each cell through the port's run_fl_batch
GRID_CELLS = (("unsw", "mlp"), ("road_raw", "mlp"), ("road_raw", "cnn"),
              ("road_raw", "rglru"), ("road_raw", "ssm"), ("road_raw", "attn"))
GRID_CLIENTS, GRID_SAMPLES, GRID_ROUNDS = 12, 2_400, 40
GRID_SEEDS, GRID_EVAL = (0, 1, 2), 10


def grid_config(model: str):
    """``bench_models._bench_fl``: 12 clients, K₀ = 4, 3 local steps of 32,
    clipped DP at ε = 1000, iid failures with checkpoint recovery."""
    from repro_torch.configs.base import FLConfig
    return FLConfig(
        n_clients=GRID_CLIENTS, clients_per_round=4, rounds=GRID_ROUNDS,
        local_epochs=3, local_batch=32, local_lr=0.1, dp_enabled=True,
        dp_mode="clipped", dp_epsilon=1000.0, dp_clip=1.0,
        fault_tolerance=True, failure_prob=0.05, model=model)


def phase_model_grid(torch, kernel_mods):
    """Phase 11: the model grid of ``benchmarks/bench_models.py`` at its
    full settings (6 cells × seeds 0–2, 12 clients, 2,400 samples, 40
    rounds, eval every 10): each cell through ``run_fl_batch`` once (one
    runner build) and again (a pure cache hit, the warm wall).  The port
    draws its own batches, so each mean AUC is set beside the reference's
    (``BENCH_models.json``, JAX on the CPU) and not held to its ordering;
    a non-finite loss or AUC, or a mean AUC ≤ 0.5, fails."""
    import numpy as np

    from repro_torch.data.synthetic import make_federated
    from repro_torch.train import fl_driver

    bench = json.loads((ROOT / "BENCH_models.json").read_text())
    ref_auc = {(c["dataset"], c["model"]): c["auc_mean"]
               for c in bench["grid"]}
    feds = {ds: make_federated(0, ds, n_samples=GRID_SAMPLES,
                               n_clients=GRID_CLIENTS)
            for ds in sorted({ds for ds, _ in GRID_CELLS})}
    kw = dict(seeds=GRID_SEEDS, rounds=GRID_ROUNDS, eval_every=GRID_EVAL,
              device="cuda")
    cells = []
    for ds, model in GRID_CELLS:
        fed, cfg = feds[ds], grid_config(model)
        stats0 = dict(fl_driver.RUNNER_STATS)
        for mod in kernel_mods:
            mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fl_driver.run_fl_batch(fed, cfg, "proposed", **kw)
        cold_s = time.perf_counter() - t0
        launches = {k: n for mod in kernel_mods
                    for k, n in mod.LAUNCHES.items() if n}
        check(fl_driver.RUNNER_STATS["misses"] == stats0["misses"] + 1,
              f"({ds}, {model}): the seed batch did not build one runner")
        t0 = time.perf_counter()
        again = fl_driver.run_fl_batch(fed, cfg, "proposed", **kw)
        warm_s = time.perf_counter() - t0
        check(fl_driver.RUNNER_STATS["misses"] == stats0["misses"] + 1 and
              fl_driver.RUNNER_STATS["hits"] == stats0["hits"] + 1,
              f"({ds}, {model}): the warm rerun was not a pure cache hit")
        check(all(math.isfinite(v) for r in res
                  for k in ("loss", "auc") for v in r.history[k]),
              f"({ds}, {model}): non-finite loss or AUC")
        auc = float(np.mean([r.auc for r in res]))
        check(auc > 0.5, f"({ds}, {model}): mean AUC {auc:.4f} <= 0.5")
        check(launches.get("sumsq_rows") == GRID_ROUNDS and
              launches.get("scale_noise_rows") == GRID_ROUNDS,
              f"({ds}, {model}): DP kernel launches {launches}")
        cells.append({
            "dataset": ds, "model": model, "auc_mean": auc,
            "auc_per_seed": [r.auc for r in res],
            "acc_mean": float(np.mean([r.accuracy for r in res])),
            "reference_auc_mean_cpu_jax": ref_auc.get((ds, model)),
            "cold_s": cold_s, "warm_s": warm_s,
            "warm_ms_per_round": 1e3 * warm_s / GRID_ROUNDS,
            "launches": launches,
            "warm_repeat_equal": all(a.history == b.history
                                     for a, b in zip(res, again))})
        print(f"  ({ds}, {model}): mean AUC {auc:.4f} (reference, JAX on "
              f"the CPU: {ref_auc.get((ds, model)):.4f}); first call "
              f"{cold_s:.2f} s, warm {warm_s:.2f} s = "
              f"{cells[-1]['warm_ms_per_round']:.1f} ms a round for "
              f"{len(GRID_SEEDS)} lanes; launches {launches}")
    return cells


# phase 12: benchmarks/bench_privacy.py's full settings: the adaptive
# budget frontier, 4 budgets × seeds 0-3 = 16 lanes of 24 clients
PRIV_CLIENTS, PRIV_SAMPLES, PRIV_ROUNDS, PRIV_EVAL = 24, 6_000, 60, 10
PRIV_BUDGETS = (300.0, 1000.0, 3000.0, 10000.0)
PRIV_SEEDS = (0, 1, 2, 3)


def privacy_config(**kw):
    """``bench_privacy._bench_config``."""
    from repro_torch.configs.base import FLConfig
    return FLConfig(
        n_clients=PRIV_CLIENTS, clients_per_round=4, rounds=PRIV_ROUNDS,
        local_epochs=5, local_batch=32, local_lr=0.08, dp_enabled=True,
        dp_mode="clipped", dp_epsilon=1000.0, dp_clip=1.0,
        fault_tolerance=True, failure_prob=0.05, **kw)


def phase_privacy_frontier(torch, dpk):
    """Phase 12: the privacy frontier of ``benchmarks/bench_privacy.py`` at
    its full settings (unsw, 24 clients, 6,000 samples, 60 rounds, eval
    every 10, the adaptive schedule, budgets 300/1,000/3,000/10,000 ×
    seeds 0–3: 16 lanes in one ``run_fl_sweep``, one runner build).
    Checks: every lane's final ε within its budget; in every round a lane
    is not live, its params stay bitwise (a spy on the engine's
    ``scheduled_round``); the DP kernels launch once a round for all lanes,
    gated or not; a uniform, fixed-K lane's ε equals the host f64
    composition at the engine's own σ within 1e-6 relative (the
    reference's ``offline_check``).  Prints, per budget, the mean AUC, ε,
    the first and last σ and the live share beside ``BENCH_privacy.json``
    (JAX on the CPU), and the warm wall a round with ``dp_scheduled`` on
    and off for the same cell (a measurement, not a gate)."""
    import numpy as np

    from repro_torch.data.synthetic import make_federated
    from repro_torch.privacy import accountant as acct_lib
    from repro_torch.privacy import schedule as sched_lib
    from repro_torch.train import fl_driver
    from repro_torch.tree import flatten_rows

    bench = json.loads((ROOT / "BENCH_privacy.json").read_text())
    ref = {c["budget"]: c for c in bench["frontier"]["cells"]}
    fed = make_federated(0, "unsw", n_samples=PRIV_SAMPLES,
                         n_clients=PRIV_CLIENTS)
    fl = privacy_config(dp_scheduled=True,
                        dp_sched=sched_lib.schedule_code("adaptive"))
    cells = [{"dp_budget": b} for b in PRIV_BUDGETS]
    kw = dict(seeds=PRIV_SEEDS, rounds=PRIV_ROUNDS, eval_every=PRIV_EVAL,
              device="cuda")

    # the spy keeps, on the card, each round's live gate and each lane's
    # flat params before and after the round
    rounds_seen, original = [], fl_driver.scheduled_round

    def spy(step, fl_, state, *args, **kwargs):
        before = flatten_rows(state.params).clone()
        out = original(step, fl_, state, *args, **kwargs)
        rounds_seen.append((before, flatten_rows(out[0].params).clone(),
                            out[4].clone()))
        return out

    stats0 = dict(fl_driver.RUNNER_STATS)
    dpk.reset_launches()
    fl_driver.scheduled_round = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fl_driver.run_fl_sweep(fed, fl, cells, **kw)
        cold_s = time.perf_counter() - t0
    finally:
        fl_driver.scheduled_round = original
    launches = dict(dpk.LAUNCHES)
    check(fl_driver.RUNNER_STATS["misses"] == stats0["misses"] + 1,
          "the budget frontier did not build exactly one runner")
    check(all(n == PRIV_ROUNDS for n in launches.values()),
          f"DP kernel launches {launches}: want one a round for all lanes, "
          f"gated or not")
    check(len(rounds_seen) == PRIV_ROUNDS, "the spy missed rounds")
    lanes = len(cells) * len(PRIV_SEEDS)
    live = torch.stack([r[2] for r in rounds_seen]).cpu()     # [rounds, L]
    frozen_ok, first_dead = True, []
    for lane in range(lanes):
        dead = [r for r in range(PRIV_ROUNDS) if live[r, lane] == 0]
        first_dead.append(dead[0] + 1 if dead else None)
        for r in dead:
            before, after, _ = rounds_seen[r]
            frozen_ok &= bool(torch.equal(before[lane], after[lane]))
    check(frozen_ok, "a lane that was not live moved its params")
    out_cells = []
    for budget, row in zip(PRIV_BUDGETS, res):
        check(all(r.eps_spent <= budget for r in row),
              f"budget {budget}: ε {[r.eps_spent for r in row]} overshoots")
        check(all(math.isfinite(v) for r in row for k in ("loss", "auc",
                                                          "eps", "sigma")
                  for v in r.history[k]), f"budget {budget}: non-finite")
        c = {"budget": budget,
             "auc_mean": float(np.mean([r.auc for r in row])),
             "acc_mean": float(np.mean([r.accuracy for r in row])),
             "eps_spent_mean": float(np.mean([r.eps_spent for r in row])),
             "sigma_first": row[0].history["sigma"][0],
             "sigma_last": row[0].history["sigma"][-1],
             "live_frac_last": float(np.mean([r.history["live"][-1]
                                              for r in row])),
             "live_share": float(np.mean([np.mean(r.history["live"])
                                          for r in row]))}
        out_cells.append(c)
        b = ref[budget]
        print(f"  budget {budget:>7.0f}: AUC {c['auc_mean']:.4f} (reference "
              f"{b['auc_mean']:.4f}), ε {c['eps_spent_mean']:.2f} "
              f"({b['eps_spent_mean']:.2f}), σ {c['sigma_first']:.5f} -> "
              f"{c['sigma_last']:.5f} ({b['sigma_first']:.5f} -> "
              f"{b['sigma_last']:.5f}), live share {c['live_share']:.3f}, "
              f"last block {c['live_frac_last']:.3f} "
              f"({b['live_frac_last']:.3f})")
    print(f"  16 lanes: one runner build, {cold_s:.2f} s; DP launches "
          f"{launches}; first round not live per lane {first_dead}; gated "
          f"lanes' params bitwise frozen")

    # the reference's offline check: uniform schedule, fixed K
    fixed = privacy_config(dp_scheduled=True, adaptive_k=False)
    one = fl_driver.run_fl_batch(fed, fixed, seeds=(0,), **{
        k: v for k, v in kw.items() if k != "seeds"})[0]
    blocks = [PRIV_EVAL] * (PRIV_ROUNDS // PRIV_EVAL)
    released = int(round(sum(f * b for f, b in zip(one.history["live"],
                                                   blocks))))
    check(released >= PRIV_ROUNDS - 1,
          f"uniform calibration released only {released}/{PRIV_ROUNDS}")
    z = float(np.float32(one.history["sigma"][0])) / fixed.dp_clip
    q = float(np.float32(fixed.clients_per_round / fixed.n_clients))
    eps_host = acct_lib.compose_epsilon(z, q, released, fixed.dp_delta)
    rel = abs(one.eps_spent - eps_host) / max(1.0, abs(eps_host))
    check(rel <= 1e-6, f"in-loop ε {one.eps_spent} vs host f64 {eps_host} "
          f"(rel {rel:.2e})")
    print(f"  offline check: uniform fixed-K lane released {released} "
          f"rounds, in-loop ε {one.eps_spent!r} vs host f64 "
          f"{eps_host!r} (rel {rel:.2e}; reference run "
          f"{bench['offline_check']['rel_err']:.2e})")

    # warm wall a round, scheduled against fixed σ, same cell, in turns
    walls = {"fixed": [], "scheduled": []}
    configs = {"fixed": privacy_config(),
               "scheduled": privacy_config(dp_scheduled=True)}
    for name in ("fixed", "scheduled"):   # first calls build the runners
        fl_driver.run_fl_batch(fed, configs[name], **kw)
    for name in ("fixed", "scheduled", "scheduled", "fixed") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fl_driver.run_fl_batch(fed, configs[name], **kw)
        walls[name].append(1e3 * (time.perf_counter() - t0) / PRIV_ROUNDS)
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"  warm wall a round, 4 lanes: dp_scheduled off "
          f"{med['fixed']:.2f} ms, on {med['scheduled']:.2f} ms (ratio "
          f"{med['scheduled'] / med['fixed']:.3f}; runs {walls})")
    return {"lanes": lanes, "cold_s": cold_s, "launches": launches,
            "cells": out_cells, "first_round_not_live": first_dead,
            "offline_check": {"released": released, "z": z, "q": q,
                              "eps_in_loop": one.eps_spent,
                              "eps_host_f64": eps_host, "rel_err": rel},
            "wall_ms_per_round": walls, "wall_ms_per_round_median": med}


def phase_privacy_card_vs_cpu(torch, dpk):
    """Phase 12: the scheduled lane step card vs CPU (adaptive schedule;
    budgets 0.01, which no release fits, 60 and 400 × 2 seeds, 4 rounds of
    a 4-round plan at a small size): ``live`` and ``sel_mask`` equal, σ_t
    and the state (accountant and scheduler included) within rtol 1e-4 /
    atol 1e-6, and both gated and live rounds covered."""
    import dataclasses

    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import make_federated

    small = make_federated(0, "unsw", n_samples=2_000, n_clients=10)
    fl = FLConfig(n_clients=10, clients_per_round=4, local_epochs=3,
                  local_batch=32, dp_clip=5.0, failure_prob=0.2,
                  dp_scheduled=True, dp_sched=2.0, dp_stall_tol=10.0)
    cells = [dataclasses.replace(fl, dp_budget=b) for b in (0.01, 60.0,
                                                            400.0)]
    worst, lives = lane_steps_card_vs_cpu(torch, dpk, small, fl, cells, 32,
                                          4, "scheduled lane step")
    check(any(v == 0.0 for row in lives for v in row) and
          any(v == 1.0 for row in lives for v in row),
          "the card-vs-CPU lanes did not cover both live and gated rounds")
    return {"max_abs": worst, "live": lives}


def phase_grid_card_vs_cpu(torch, dpk):
    """Phase 11: the lane step of the window detectors ``cnn`` and
    ``rglru`` card vs CPU (``bench_models``' config on a small
    ``road_raw`` federation, 1 cell × 2 seeds, 2 rounds): the conv's and
    the log-depth scan's batching under ``vmap`` and their gradients on
    the card, against the CPU's."""
    import dataclasses

    from repro_torch.data.synthetic import make_federated

    small = make_federated(0, "road_raw", n_samples=600, n_clients=6)
    out = {}
    for model in ("cnn", "rglru"):
        fl = dataclasses.replace(grid_config(model), n_clients=6)
        out[model] = lane_steps_card_vs_cpu(torch, dpk, small, fl, [fl], 64,
                                            2, f"{model} lane step")[0]
    return out


# phase 13: benchmarks/bench_async.py's full settings: the plan frontier,
# 4 plans × 2 fault lanes × seeds 0-3 = 32 lanes of 24 clients
ASYNC_CLIENTS, ASYNC_SAMPLES, ASYNC_ROUNDS, ASYNC_EVAL = 24, 6_000, 50, 10
ASYNC_SEEDS = (0, 1, 2, 3)
ASYNC_RATE, ASYNC_BURST, ASYNC_SLOW = 0.4, 6.0, 8.0
ASYNC_BUFFERS, ASYNC_POW = (2.0, 4.0), 0.5
GATE_SEEDS, GATE_ROUNDS, GATE_K = tuple(range(8)), 40, 2.0
FAULT_LANES = (("markov", {"fault_process": 1.0, "fault_burst": ASYNC_BURST}),
               ("straggler", {"fault_process": 3.0,
                              "straggler_slow": ASYNC_SLOW}))
PLAN_VARIANTS = (("sync", {}),) + tuple(
    (f"async_k{int(k)}", {"plan": "buffered_async", "async_buffer": k,
                          "async_staleness_pow": ASYNC_POW})
    for k in ASYNC_BUFFERS) + (("hier", {"plan": "hierarchical"}),)


def async_config(**kw):
    """``bench_async._bench_config``."""
    from repro_torch.configs.base import FLConfig
    return FLConfig(
        n_clients=ASYNC_CLIENTS, clients_per_round=max(4, ASYNC_CLIENTS // 3),
        rounds=ASYNC_ROUNDS, local_epochs=5, local_batch=32, local_lr=0.08,
        fault_tolerance=True, failure_prob=ASYNC_RATE, **kw)


def param_count(dataset: str, hidden: int) -> int:
    """P of the ``mlp`` detector on ``dataset``'s features at ``hidden``:
    the width of a client's flat update, a DP row."""
    from repro_torch.data.synthetic import make_federated
    from repro_torch.models.spec import get_model_spec, meta_for
    fed = make_federated(0, dataset, n_samples=200, n_clients=2)
    return get_model_spec("mlp", meta_for(fed, hidden=hidden)).param_bytes() \
        // 4


def check_dp_rows(torch, dpk, ref, r: int, p: int, label: str) -> dict:
    """The DP kernels at a path's row shape [r, p] against their plain
    versions (``sumsq_rows`` to rtol 1e-5, ``scale_noise_rows`` with one σ
    a row bitwise), and their device times by :func:`device_ms` beside
    the bytes bound."""
    gen = torch.Generator().manual_seed(r)
    x = (torch.randn(r, p, generator=gen) * 0.05).cuda()
    nz = torch.randn(r, p, generator=gen).cuda()
    sigma = (torch.rand(r, generator=gen) + 0.01).cuda()
    sq, sq_ref = dpk.sumsq_rows(x), ref.sumsq_rows_ref(x)
    torch.testing.assert_close(sq, sq_ref, rtol=1e-5, atol=0)
    scale = ref.clip_scale(torch.sqrt(sq_ref), 1.0)
    o = dpk.scale_noise_rows(x, nz, scale, sigma)
    check(torch.equal(o, ref.scale_noise_rows_ref(x, nz, scale, sigma)),
          f"{label}: scale_noise_rows is not bitwise its plain version at "
          f"[{r}, {p}]")
    err = max_abs(sq, sq_ref)
    times = {"sumsq_rows": timed(lambda: dpk.sumsq_rows(x),
                                 lambda: ref.sumsq_rows_ref(x),
                                 lambda: torch.linalg.vector_norm(x, dim=1)),
             "scale_noise_rows": timed(
                 lambda: dpk.scale_noise_rows(x, nz, scale, sigma),
                 lambda: ref.scale_noise_rows_ref(x, nz, scale, sigma),
                 None)}
    bounds = {"sumsq_rows": sumsq_bound(r, p)[0],
              "scale_noise_rows": bound(12 * r * p + 8 * r, 3 * r * p)[0]}

    def show(k):
        t = times[k]
        lib = ("" if t["library_ms"] is None
               else f", library {t['library_ms'] * 1e3:.2f}")
        return (f"{k} {t['ms'] * 1e3:.2f} us (bound {bounds[k] * 1e3:.2f}, "
                f"plain {t['plain_ms'] * 1e3:.2f}{lib}; eager "
                f"{t['eager_ms'] * 1e3:.2f} / {t['eager_plain_ms'] * 1e3:.2f})")

    print(f"  {label} DP rows [{r}, {p}]: sumsq_rows max|err| {err:.3e}, "
          f"scale_noise_rows (one σ a row) bitwise equal to plain; device "
          + ", ".join(show(k) for k in times))
    return {"shape": [r, p], "sumsq_rows_max_abs": err,
            "ms": {k: t["ms"] for k, t in times.items()}, "times": times,
            "bound_ms": bounds}


def phase_plan_frontier(torch, dpk, ref, card):
    """Phase 13: the plan frontier of ``benchmarks/bench_async.py`` at its
    full settings through ``run_fl_sweep`` (unsw, 24 clients, 6,000
    samples, 50 rounds, eval every 10, rate 0.4; sync, buffered_async at
    K = 2 and 4 with staleness power 0.5, and hierarchical at E = 4, ×
    Markov (burst 6) and straggler (slow 8) lanes × seeds 0-3: 32 lanes).
    Checks: one runner build and warm reruns that hit; the loop under sync
    debug mode "error"; the DP kernels once a round for all lanes; on every
    straggler lane each async K's simulated time under sync's, and hier's
    mean under flat's (as the bench asserts); the DP kernels at the path's
    rows.  Prints the warm wall, each cell beside ``BENCH_async.json`` (the
    reference, JAX on the CPU) and the async gate's Mann-Whitney p (K = 2,
    pooled fault lanes, seeds 0-7, 40 rounds) by ``repro_torch.stats``,
    printed, not gated."""
    import numpy as np

    from repro_torch.data.synthetic import make_federated
    from repro_torch.stats import mannwhitney_greater
    from repro_torch.train import fl_driver

    bench = json.loads((ROOT / "BENCH_async.json").read_text())
    ref_cells = {(c["plan"], c["fault"]): c
                 for c in bench["frontier"]["cells"]}
    fed = make_federated(0, "unsw", n_samples=ASYNC_SAMPLES,
                         n_clients=ASYNC_CLIENTS)
    fl = async_config()
    cells = [{**plan_kw, **fault_kw, "failure_prob": ASYNC_RATE}
             for _, plan_kw in PLAN_VARIANTS for _, fault_kw in FAULT_LANES]
    labels = [(pl, fa) for pl, _ in PLAN_VARIANTS for fa, _ in FAULT_LANES]
    kw = dict(seeds=ASYNC_SEEDS, rounds=ASYNC_ROUNDS, eval_every=ASYNC_EVAL,
              device="cuda")
    stats0 = dict(fl_driver.RUNNER_STATS)
    torch.cuda.synchronize()
    dpk.reset_launches()
    with SyncModeSpy(torch) as spy:
        t0 = time.perf_counter()
        res = fl_driver.run_fl_sweep(fed, fl, cells, **kw)
        cold_s = time.perf_counter() - t0
    launches = dict(dpk.LAUNCHES)
    check(spy.ok(), f"the frontier loop did not run under sync debug mode "
          f"'error': {spy.modes}")
    check(fl_driver.RUNNER_STATS["misses"] == stats0["misses"] + 1,
          "the plan frontier did not build exactly one runner")
    check(all(n == ASYNC_ROUNDS for n in launches.values()),
          f"DP kernel launches {launches}: want one a round for all lanes")
    warm = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fl_driver.run_fl_sweep(fed, fl, cells, **kw)
        warm.append(time.perf_counter() - t0)
    check(fl_driver.RUNNER_STATS["misses"] == stats0["misses"] + 1 and
          fl_driver.RUNNER_STATS["hits"] == stats0["hits"] + 2,
          "warm frontier reruns were not cache hits")
    by = dict(zip(labels, res))
    for row in res:
        check(all(math.isfinite(v) for r in row
                  for k in ("loss", "acc", "auc", "cum_time")
                  for v in r.history[k]), "frontier history not finite")
    sync_s = by[("sync", "straggler")]
    for k in ASYNC_BUFFERS:
        asyn = by[(f"async_k{int(k)}", "straggler")]
        check(all(a.sim_time_s < s.sim_time_s for a, s in zip(asyn, sync_s)),
              f"K={k:.0f}: a straggler lane's K-th arrival did not undercut "
              f"sync's slowest client")
    hier_t = [r.sim_time_s for r in by[("hier", "straggler")]]
    sync_t = [r.sim_time_s for r in sync_s]
    check(np.mean(hier_t) < np.mean(sync_t),
          "hier's two edge hops did not undercut the flat WAN hop")
    out_cells = []
    for (pl, fa), row in by.items():
        c = {"plan": pl, "fault": fa,
             "acc_mean": float(np.mean([r.accuracy for r in row])),
             "auc_mean": float(np.mean([r.auc for r in row])),
             "sim_time_mean": float(np.mean([r.sim_time_s for r in row]))}
        out_cells.append(c)
        b = ref_cells[(pl, fa)]
        print(f"  {pl:>8s} on {fa:>9s}: acc {c['acc_mean']:.4f} AUC "
              f"{c['auc_mean']:.4f} sim time {c['sim_time_mean']:.2f} s "
              f"(reference, JAX on the CPU: acc {b['acc_mean']:.4f} AUC "
              f"{b['auc_mean']:.4f} sim time {b['sim_time_mean']:.2f} s)")
    print(f"  hier vs sync on straggler lanes, per seed: {hier_t} vs "
          f"{sync_t}")

    gate_cells = [{**fault_kw, "failure_prob": ASYNC_RATE, **arm}
                  for _, fault_kw in FAULT_LANES
                  for arm in ({}, {"plan": "buffered_async",
                                   "async_buffer": GATE_K,
                                   "async_staleness_pow": ASYNC_POW})]
    gate = fl_driver.run_fl_sweep(fed, fl, gate_cells, seeds=GATE_SEEDS,
                                  rounds=GATE_ROUNDS, eval_every=ASYNC_EVAL,
                                  device="cuda")
    t_sync = [r.sim_time_s for row in gate[0::2] for r in row]
    t_async = [r.sim_time_s for row in gate[1::2] for r in row]
    auc_sync = [r.auc for row in gate[0::2] for r in row]
    auc_async = [r.auc for row in gate[1::2] for r in row]
    u, p_time, _ = mannwhitney_greater(t_sync, t_async)
    _, p_auc, _ = mannwhitney_greater(auc_sync, auc_async)
    ref_gate = bench["async_gate"]
    lanes = len(cells) * len(ASYNC_SEEDS)
    warm_s = min(warm)
    print(f"  {lanes} lanes x {ASYNC_ROUNDS} rounds: one runner build, "
          f"warm reruns hit; DP launches {launches}; loop under sync debug "
          f"mode 'error'")
    print(f"  wall: first call {cold_s:.3f} s, warm {warm} s (min "
          f"{warm_s:.3f} s = {1e3 * warm_s / ASYNC_ROUNDS:.2f} ms a round)  "
          f"({card})")
    print(f"  async gate (K=2, pooled Markov+straggler, seeds 0-7, "
          f"{GATE_ROUNDS} rounds): sim time {np.mean(t_async):.2f} s vs sync "
          f"{np.mean(t_sync):.2f} s, Mann-Whitney U {u}, p {p_time:.3e}; "
          f"AUC {np.mean(auc_async):.4f} vs {np.mean(auc_sync):.4f} "
          f"(sync-better p {p_auc:.3f}); reference p "
          f"{ref_gate['p_value_time']:.3e}, sync-better p "
          f"{ref_gate['p_value_auc_sync_better']:.3f} (JAX on the CPU)")
    return {"lanes": lanes, "cold_s": cold_s, "warm_s": warm,
            "warm_ms_per_round": 1e3 * warm_s / ASYNC_ROUNDS,
            "launches": launches, "cells": out_cells,
            "hier_vs_sync_straggler": [hier_t, sync_t],
            "gate": {"u": u, "p_time": p_time, "p_auc_sync_better": p_auc,
                     "sim_time_sync": t_sync, "sim_time_async": t_async}}


def phase_plan_card_vs_cpu(torch, dpk):
    """Phase 13: the lane step at plan codes 1 and 2 card vs CPU (sync,
    buffered_async at K = 2 on stragglers, hierarchical at E = 3 on Markov
    outages, × 2 seeds, 3 rounds, at a small size): equal ``sel_mask``,
    state within rtol 1e-4 / atol 1e-6."""
    import dataclasses

    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import make_federated

    small = make_federated(0, "unsw", n_samples=2_000, n_clients=10)
    fl = FLConfig(n_clients=10, clients_per_round=5, local_epochs=3,
                  local_batch=32, dp_epsilon=100.0, dp_clip=5.0,
                  failure_prob=0.3, hierarchy_edges=3)
    cells = [fl, dataclasses.replace(fl, plan="buffered_async",
                                     async_buffer=2.0, fault_process=3.0),
             dataclasses.replace(fl, plan="hierarchical", fault_process=1.0)]
    return lane_steps_card_vs_cpu(torch, dpk, small, fl, cells, 32, 3,
                                  "plan lane step")[0]


# phase 14: benchmarks/bench_scale.py's full settings, and a population of
# 10^6 clients (the top of make_population's stated range)
POP_SIZES = (1_000, 10_000, 100_000, 1_000_000)
POP_POOL, POP_MEMBERS, POP_KMAX, POP_ROUNDS = 8_000, 32, 16, 8
POP_SEEDS, POP_WARM = (0, 1), 3
POP_SPANS = ("population.prepare", "population.execute",
             "population.readback", "selection", "cohort_topk",
             "sample_cohort_batches", "local_train", "dp_privatize",
             "aggregate", "eval_block")


def scale_config(n: int):
    """``bench_scale.scale_fl``."""
    from repro_torch.configs.base import FLConfig
    return FLConfig(
        n_clients=n, clients_per_round=POP_KMAX, k_max=POP_KMAX,
        rounds=POP_ROUNDS, local_epochs=2, local_batch=32, local_lr=0.08,
        fault_tolerance=True, failure_prob=0.05)


def phase_population(torch, dpk, card):
    """Phase 14: ``run_fl_population`` at ``bench_scale``'s full settings
    (pool 8,000, 32 members, k_max = K = 16, 8 rounds, 2 local steps × 32,
    failure 0.05, seeds 0-1, ``mlp`` at hidden 64) over 10^3, 10^4, 10^5
    and 10^6 clients.  Per population: generation, cold and warm (min of
    3) walls; one runner build and hits after; finite accuracy; the loop
    under sync debug mode "error"; DP launches a round; the device busy
    share of a warm call by ``torch.profiler``; ``core/scale.py``'s
    predicted bytes beside ``torch.cuda.max_memory_allocated()``.  Then
    bench_scale's sublinear gate: warm round wall(10^5)/wall(10^3) < 20."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import rounds as rounds_lib
    from repro_torch.core import scale as scale_lib
    from repro_torch.data.synthetic import make_population
    from repro_torch.models.spec import get_model_spec, meta_for
    from repro_torch.train import fl_driver

    rows, stats0 = [], dict(fl_driver.RUNNER_STATS)
    for i, n in enumerate(POP_SIZES):
        fl = scale_config(n)
        t0 = time.perf_counter()
        pop = make_population(0, n_clients=n, pool_samples=POP_POOL,
                              members_per_client=POP_MEMBERS)
        gen_s = time.perf_counter() - t0
        kw = dict(seeds=POP_SEEDS, rounds=POP_ROUNDS, eval_every=POP_ROUNDS,
                  device="cuda")
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dpk.reset_launches()
        with SyncModeSpy(torch) as spy:
            t0 = time.perf_counter()
            res = fl_driver.run_fl_population(pop, fl, **kw)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
        launches = dict(dpk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base_bytes
        check(spy.ok(), f"N={n}: the population loop did not run under "
              f"sync debug mode 'error': {spy.modes}")
        check(all(v == POP_ROUNDS for v in launches.values()),
              f"N={n}: DP launches {launches}, want one a round")
        warm = []
        for _ in range(POP_WARM):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fl_driver.run_fl_population(pop, fl, **kw)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        check(fl_driver.RUNNER_STATS["misses"] == stats0["misses"] + i + 1,
              f"N={n}: not one runner build per population shape")
        acc = [r.accuracy for r in res[0]]
        check(all(math.isfinite(a) for a in acc), f"N={n}: accuracy {acc}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fl_driver.run_fl_population(pop, fl, **kw)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        _, busy_ms, spans, _ = profile_summary(prof.events(), POP_SPANS)
        model = get_model_spec(fl.model, meta_for(pop)).param_bytes()
        lanes = len(POP_SEEDS)
        predicted = {
            "resident": scale_lib.population_resident_bytes(
                n, POP_MEMBERS, lanes, model),
            "selection_transients": lanes * scale_lib.
            selection_transient_bytes(n),
            "cohort_batches": lanes * scale_lib.cohort_batch_bytes(
                POP_KMAX, 2, 32, pop.n_features)}
        # the port's per-round buffers core/scale.py does not count: the
        # population vectors of CohortDraws and cohort_topk's stable sort
        # (f32 keys and int64 indices), by shape
        draws = rounds_lib.CohortDraws.empty(lanes, n, POP_KMAX, 2, 32, 0,
                                             "meta")
        uncounted = {"cohort_draws": sum(t.nbytes for t in draws[:4]),
                     "topk_sort": lanes * n * (4 + 8)}
        chunks_card = scale_lib.auto_chunks(n, scale_lib.DEVICE_MEMORY_BYTES,
                                            POP_MEMBERS, lanes, model)
        row = {"n_clients": n, "gen_s": gen_s, "cold_s": cold_s,
               "auto_chunks_whole_card": chunks_card,
               "warm_s": warm, "warm_round_ms": 1e3 * min(warm) / POP_ROUNDS,
               "accuracy": acc, "launches": launches,
               "launches_per_round": {k: v / POP_ROUNDS
                                      for k, v in launches.items()},
               "busy_share": busy_ms / prof_ms,
               "profiled_ms_per_round": prof_ms / POP_ROUNDS,
               "busy_ms_per_round": busy_ms / POP_ROUNDS,
               "span_host_ms_per_round": {k: v / POP_ROUNDS
                                          for k, v in spans.items()},
               "predicted_bytes": predicted, "uncounted_bytes": uncounted,
               "peak_allocated_bytes": peak,
               "histories": [[r.history for r in row] for row in res]}
        rows.append(row)
        print(f"  N={n:>9,d}: generation {gen_s:.3f} s, cold {cold_s:.3f} s, "
              f"warm round {row['warm_round_ms']:.2f} ms (walls {warm}); acc "
              f"{acc}; DP launches a round {row['launches_per_round']}; "
              f"device busy {row['busy_share']:.3f} of a profiled call "
              f"({row['busy_ms_per_round']:.3f} ms a round); predicted "
              f"resident {predicted['resident']:,} B + selection transients "
              f"{predicted['selection_transients']:,} B (not counted there: "
              f"draw buffers {uncounted['cohort_draws']:,} B, top-k sort "
              f"{uncounted['topk_sort']:,} B), peak allocated "
              f"{peak:,} B; selection chunks at the card's 80 GB "
              f"{chunks_card}  ({card})")
        print(f"    spans (host ms a round): " + ", ".join(
            f"{k} {v:.2f}" for k, v in row["span_host_ms_per_round"].items()))
    check(fl_driver.RUNNER_STATS["hits"] >= stats0["hits"] +
          len(POP_SIZES) * (POP_WARM + 1), "warm population calls missed")
    lo = next(r for r in rows if r["n_clients"] == 1_000)
    hi = next(r for r in rows if r["n_clients"] == 100_000)
    ratio = hi["warm_round_ms"] / lo["warm_round_ms"]
    check(ratio < 20.0, f"warm round wall 10^5/10^3 = {ratio:.2f}, not < 20")
    top = rows[-1]["warm_round_ms"] / lo["warm_round_ms"]
    print(f"  sublinear: warm round wall 10^5/10^3 = {ratio:.3f} (< 20), "
          f"10^6/10^3 = {top:.3f}  ({card})")
    return {"populations": rows, "wall_ratio_1e5_1e3": ratio,
            "wall_ratio_1e6_1e3": top}


def phase_cohort_topk(torch):
    """Phase 14: ``cohort_topk`` on the card at 10^6 clients × 2 lanes
    bitwise equal to ``cohort_topk_host``, unchunked and with 4 and 16
    chunks; f32 uniforms (ties occur at 10^6) and scores quantised to 1/64
    (ties at the top), 95 % available, k_eff 16 and 12.5."""
    from repro_torch.core.selection import cohort_topk, cohort_topk_host

    gen = torch.Generator().manual_seed(14)
    n, k_max = 1_000_000, POP_KMAX
    u = torch.rand(2, n, generator=gen)
    avail = (torch.rand(2, n, generator=gen) < 0.95).float()
    k_eff = torch.tensor([16.0, 12.5])
    out = {}
    for name, scores in (("uniform", u), ("quantised",
                                          torch.floor(u * 64) / 64)):
        h_idx, h_take = cohort_topk_host(scores.numpy(), avail.numpy(),
                                         k_eff.numpy(), k_max)
        ties = int((scores.numpy()[0, h_idx[0, :1]] ==
                    scores.numpy()[0]).sum())
        for chunks in (1, 4, 16):
            idx, take = cohort_topk(scores.cuda(), avail.cuda(),
                                    k_eff.cuda(), k_max, chunks=chunks)
            check(torch.equal(idx.cpu(), torch.as_tensor(h_idx)) and
                  torch.equal(take.cpu(), torch.as_tensor(h_take)),
                  f"cohort_topk ({name}, chunks {chunks}) is not bitwise "
                  f"cohort_topk_host at 10^6")
        out[name] = {"clients_tied_with_the_top": ties}
        print(f"  cohort_topk at [2, 10^6] ({name}; {ties} clients tie with "
              f"lane 0's top score): card bitwise equal to the host oracle, "
              f"chunks 1, 4 and 16")
    return out


def phase_cohort_card_vs_cpu(torch, dpk, rounds: int = 3):
    """Phase 14: the cohort step card vs CPU on the same draws (10^3
    clients, k_max 16; Markov at ε 8 and stragglers at ε 50, × 2 seeds,
    3 rounds): equal ``cohort_idx`` and ``take``, state within rtol 1e-4 /
    atol 1e-6, the DP kernels once each a round on the card."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs.base import params_lanes
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.data.synthetic import make_population
    from repro_torch.models.spec import get_model_spec, meta_for
    from repro_torch.tree import flatten_rows

    n = 1_000
    host = make_population(0, n_clients=n, pool_samples=2_000,
                           members_per_client=16)
    fl = dataclasses.replace(scale_config(n), clients_per_round=12,
                             failure_prob=0.2, fault_process=1.0)
    cells = [fl, dataclasses.replace(fl, fault_process=3.0, dp_epsilon=50.0)]
    spec = get_model_spec(fl.model, meta_for(host, hidden=64))
    pops = {dev: host.to(dev) for dev in ("cpu", "cuda")}
    cpu_states = []
    for seed in (0, 1):
        gen = torch.Generator().manual_seed(seed)
        cpu_states.append(rounds_lib.init_round_state(
            spec.init(gen), fl, gen, n_clients=n,
            data_size=pops["cpu"].data_size,
            data_quality=pops["cpu"].data_quality))
    lanes = [cpu_states[i % 2] for i in range(2 * len(cells))]
    states = {"cpu": rounds_lib.stack_states(lanes),
              "cuda": rounds_lib.stack_states([
                  convert.round_state_from_jax(s.params, s.util, s.kctl,
                                               s.fault, fl, "cuda")
                  for s in lanes])}
    steps = {dev: rounds_lib.make_cohort_round(spec.loss, fl, n, device=dev)
             for dev in states}
    prs = {dev: params_lanes(cells, 2, dev) for dev in states}
    n_params = flatten_rows(cpu_states[0].params, 0).numel()
    launches0 = sum(dpk.LAUNCHES.values())
    worst = 0.0
    for r in range(rounds):
        gens = [torch.Generator().manual_seed(10 * r + i)
                for i in range(len(lanes))]
        draws = rounds_lib.draw_cohort_round(gens, n, fl.k_max,
                                             fl.local_epochs, fl.local_batch,
                                             n_params, fl.selection)
        m = {}
        for dev in states:
            states[dev], m[dev] = steps[dev](states[dev], pops[dev],
                                             prs[dev], draws.to(dev))
        for name in ("cohort_idx", "take"):
            check(torch.equal(getattr(m["cpu"], name),
                              getattr(m["cuda"], name).cpu()),
                  f"cohort step: {name} differs on round {r + 1}")
        cpu, gpu = states["cpu"], states["cuda"]
        pairs = [(flatten_rows(gpu.params), flatten_rows(cpu.params))]
        pairs += list(zip(gpu.util, cpu.util)) + list(zip(gpu.kctl, cpu.kctl))
        pairs += list(zip(gpu.fault, cpu.fault))
        for a, c in pairs:
            torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-6)
            worst = max(worst, max_abs(a.cpu(), c))
        print(f"  cohort step round {r + 1}: cohort_idx and take equal "
              f"({m['cpu'].take.sum(dim=1).tolist()} trained a lane); state "
              f"max|card-cpu| {worst:.3e}")
    check(sum(dpk.LAUNCHES.values()) - launches0 == 2 * rounds,
          "the card's cohort steps did not go through the DP kernels")
    return worst



# phase 15: the dense LM serving path at granite-3-8b's full width and depth
LM_ARCH, LM_PHI3 = "granite_3_8b", "phi3_mini_3p8b"
LM_PREFILL = (4, 512)       # B, S of the prefill step
LM_PHI3_PREFILL = (1, 512)
LM_LONG_PREFILL = (1, 4096)  # granite at a long prompt
LM_PROMPT, LM_NEW = 128, 32  # the serve path: prompt tokens, greedy tokens
LM_CARD_CPU = (2, 128)      # B, S of the 2-layer f32 card-vs-CPU forward
LM_BF16_TOL = 2e-2          # bf16: relative, and of max(1, max|logit|)
LM_F32_TOL = 1e-4
# (name, (b, s, hq, hkv, d), window, the prefill whose launches count): K3
# at granite's and phi3's prefill shapes and granite's long prefill, causal
# bf16 (recurrentgemma-9b's local attention: phase 18's REC_FA_CASES)
LM_FA_CASES = (
    ("flash_attention_lm_granite", (4, 512, 32, 8, 128), None, "prefill"),
    ("flash_attention_lm_phi3", (1, 512, 32, 32, 96), None, "phi3_prefill"),
    ("flash_attention_lm_granite_long", (1, 4096, 32, 8, 128), None,
     "long_prefill"))


def lm_close(torch, got, want, tol: float, what: str,
             gate: bool = True) -> dict:
    """``got`` within ``tol`` of ``want`` relatively and within ``tol`` of
    max(1, max|want|) absolutely (bf16's error reaches every element at the
    scale of the largest); the max abs error, the elements beyond the
    tolerance, the relative Frobenius error and the rows whose argmax
    agree.  With ``gate`` False the caller checks the result."""
    got, want = got.float(), want.float()
    atol = tol * max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    bad = int((err > atol + tol * want.abs()).sum())
    top2 = want.topk(2, dim=-1).values
    out = {"max_abs_err": float(err.max()), "atol": atol, "beyond": bad,
           "rel_fro_err": float(err.norm() / want.norm()),
           "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum()),
           "rows": int(want[..., 0].numel()),
           "top2_gap_min": float((top2[..., 0] - top2[..., 1]).min())}
    print(f"  {what}: max|err| {out['max_abs_err']:.3e} (atol {atol:.3e}), "
          f"{bad} beyond, rel fro {out['rel_fro_err']:.3e}, argmax equal "
          f"{out['argmax_equal']}/{out['rows']} (least top-2 gap "
          f"{out['top2_gap_min']:.3e})")
    if gate:
        check(bad == 0, f"{what}: {bad} elements beyond tolerance {tol}")
    return out


def tree_list(tree) -> list:
    """The tensors of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for sub in tree for t in tree_list(sub)]
    return [tree]


def tree_bytes(tree) -> tuple:
    """(elements, bytes) of a tree of dicts and lists of tensors."""
    leaves = tree_list(tree)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def tree_to(tree, where):
    """Every tensor of the tree ``.to(where)``: a device or a dtype."""
    if isinstance(tree, dict):
        return {k: tree_to(v, where) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, where) for v in tree]
    return tree.to(where)


def lm_tokens(torch, cfg, b: int, s: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")


def lm_profiled(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: its host wall (ms, to a
    synchronise), the device events, their busy ms and (calls, ms) by
    kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device, busy_ms, _, by_kernel = profile_summary(prof.events(), ())
    return wall, device, busy_ms, by_kernel


def lm_prefill(torch, fak, model, params, tokens, card):
    """The prefill step (``forward(impl="flash", last_only=True)``): the
    main-path call with K3's count set to 0 just before it and read just
    after; three warm calls timed by the host clock around a synchronise;
    one profiled call (device busy share, K3's device time)."""
    def step():
        return model.forward(params, {"tokens": tokens}, impl="flash",
                             last_only=True)

    fak.reset_launches()
    logits = step()
    torch.cuda.synchronize()
    launches = fak.LAUNCHES["flash_attention"]
    check(launches == model.cfg.n_layers,
          f"{launches} flash_attention launches in one prefill of "
          f"{model.cfg.n_layers} layers")
    check(bool(torch.isfinite(logits[..., :model.cfg.vocab_size]).all()),
          "non-finite prefill logits")
    walls = []
    for _ in range(3):
        fak.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(fak.LAUNCHES["flash_attention"] == model.cfg.n_layers,
              "flash_attention launches a warm prefill")
    prof_wall, device, busy_ms, by_kernel = lm_profiled(torch, step)
    k3 = [(n, t) for k, (n, t) in by_kernel.items()
          if FA_MMA_KERNEL in k]
    k3_ms = sum(t for _, t in k3)
    check(sum(n for n, _ in k3) == model.cfg.n_layers,
          f"{sum(n for n, _ in k3)} {FA_MMA_KERNEL} calls in a profiled "
          f"prefill of {model.cfg.n_layers} layers")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:6]
    out = {"launches": launches, "warm_wall_ms": walls,
           "warm_wall_ms_median": statistics.median(walls),
           "profiled_wall_ms": prof_wall, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / prof_wall,
           "device_ops": len(device),
           "k3_calls": sum(n for n, _ in k3), "k3_device_ms": k3_ms,
           "k3_share_of_wall": k3_ms / statistics.median(walls),
           "k3_share_of_busy": k3_ms / busy_ms if busy_ms else None,
           "top_kernels": [{"name": k[:80], "calls": n, "device_ms": t}
                           for k, (n, t) in top]}
    b, s = tokens.shape
    print(f"  {model.cfg.name} prefill [{b}, {s}] (impl=flash, last_only): "
          f"{launches} flash_attention launches a call; warm wall "
          f"{out['warm_wall_ms_median']:.2f} ms ({', '.join(f'{w:.2f}' for w in walls)}); "
          f"profiled {prof_wall:.2f} ms, device busy {busy_ms:.2f} ms "
          f"(share {out['device_busy_share']:.3f}, {len(device)} ops); "
          f"K3 {out['k3_calls']} calls {k3_ms:.2f} ms device "
          f"({100 * out['k3_share_of_wall']:.1f} % of the warm wall)  ({card})")
    for k in out["top_kernels"]:
        print(f"    kernel {k['name']}: {k['calls']} calls, "
              f"{k['device_ms']:.3f} ms")
    return logits, out


def check_lm_kernel(torch, fak, ref, name, case, window, launches, ptxas):
    """K3 at an LM shape (bf16, causal, S = T, optional window): held
    against its plain version at phase 8's bf16 bar (2e-2), timed beside the
    plain version, SDPA (GQA, on the [B, H, S, D] layout; with a window, a
    boolean mask) and the bound; a row of the kernels JSON line."""
    b, s, hq, hkv, d = case
    gen = torch.Generator().manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)

    q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
    o = fak.flash_attention(q, k, v, causal=True, window=window)
    o_ref = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=2e-2, atol=2e-2)
    check(torch.equal(o, fak.flash_attention(q, k, v, causal=True,
                                              window=window)),
          f"{name}: flash_attention not bitwise repeatable")
    qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        def library():
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        i = torch.arange(s, device="cuda")[:, None]
        j = torch.arange(s, device="cuda")[None, :]
        mask = (j <= i) & (j > i - window)

        def library():
            return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    # the (query, key) pairs the mask keeps, S = T
    pairs = sum(min(r + 1, window or s) for r in range(s))
    bytes_moved = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    flops = 4 * d * pairs * b * hq
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_bf16 = flops / BF16_FLOP_PER_S * 1e3
    plan = fak.launch_plan(b, s, s, hq, hkv, d, torch.bfloat16, True)
    row = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:103",
        "shape": [b, s, s, hq, hkv, d], "dtype": "bf16", "causal": True,
        "window": window, "launches": launches,
        "on_path": launches > 0, "max_abs_err": max_abs(o, o_ref),
        "bound_ms": max(t_bytes, t_bf16),
        "bound_by": "bytes" if t_bytes >= t_bf16 else "operations",
        "bound_bytes_ms": t_bytes, "bound_bf16_ms": t_bf16,
        "bound_f32_fma_ms": flops / FP32_FLOP_PER_S * 1e3,
        "bytes": bytes_moved, "flops": flops,
        "plan": plan._asdict(),
        "ptxas": ptxas.get(str(plan.dmax)),
        **timed(lambda: fak.flash_attention(q, k, v, causal=True,
                                            window=window),
                lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                window=window),
                library, iters=10),
    }
    print(f"  {name} {case} window {window} bf16 causal: device "
          f"{row['ms'] * 1e3:.1f} us, eager {row['eager_ms'] * 1e3:.1f} us; "
          f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}; bytes "
          f"{t_bytes * 1e3:.2f}, bf16 {t_bf16 * 1e3:.2f}, f32 FMA "
          f"{row['bound_f32_fma_ms'] * 1e3:.1f}); plain "
          f"{row['plain_ms'] * 1e3:.1f} us; SDPA "
          f"{row['library_ms'] * 1e3:.1f} us; max|err| "
          f"{row['max_abs_err']:.2e}; launches {launches} a prefill")
    return row


def phase_lm(torch, fak, ref, card, ptxas_rows):
    """Phase 15: granite-3-8b at full width and depth in bf16 on the card:
    the build, the prefill step on K3 (40 launches a call) against
    ``impl="ref"``, the serve path (``prefill_scan`` of 128-token prompts,
    32 greedy tokens) against the prefill step, at the floor of the plain
    prefill's agreement with it, phi3-mini's prefill (32
    launches), a 2-layer f32 variant card vs CPU, and K3 at both prefill
    shapes and granite's long prefill beside SDPA and its bound."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build

    out = {}
    cfg = get_arch(LM_ARCH)
    model = build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n, nbytes = tree_bytes(params)
    out["build"] = {"seconds": time.perf_counter() - t0, "params": n,
                    "bytes": nbytes, "param_count": cfg.param_count(),
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
    check(abs(n - cfg.param_count()) / n < 0.01, "granite parameter count")
    print(f"  built {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n:,} params ({cfg.param_count():,} by "
          f"param_count), {nbytes / 1e9:.2f} GB bf16 in "
          f"{out['build']['seconds']:.2f} s; max allocated "
          f"{out['build']['max_memory_allocated'] / 1e9:.2f} GB")

    tokens = lm_tokens(torch, cfg, *LM_PREFILL, seed=1)
    logits, out["prefill"] = lm_prefill(torch, fak, model, params, tokens,
                                        card)
    v = cfg.vocab_size
    ref_logits = model.forward(params, {"tokens": tokens}, impl="ref",
                               last_only=True)
    out["prefill"]["flash_vs_ref"] = lm_close(
        torch, logits[..., :v], ref_logits[..., :v], LM_BF16_TOL,
        "prefill impl=flash vs impl=ref (bf16)")
    long_tokens = lm_tokens(torch, cfg, *LM_LONG_PREFILL, seed=5)
    _, out["long_prefill"] = lm_prefill(torch, fak, model, params,
                                        long_tokens, card)

    prompts = lm_tokens(torch, cfg, LM_PREFILL[0], LM_PROMPT, seed=2)
    gen = generate(model, params, prompts, LM_NEW)
    fwd = model.forward(params, {"tokens": prompts}, impl="flash",
                        last_only=True)
    serve = {"batch": LM_PREFILL[0], "prompt": LM_PROMPT, "new": LM_NEW,
             "prefill_scan_s": gen["prefill_s"], "decode_s": gen["decode_s"],
             "tok_per_s": LM_PREFILL[0] * LM_NEW / gen["decode_s"],
             "decode_step_ms": gen["decode_s"] / LM_NEW * 1e3,
             "prefill_scan_step_ms": gen["prefill_s"] / LM_PROMPT * 1e3,
             "max_memory_allocated": torch.cuda.max_memory_allocated()}
    check(tuple(gen["tokens"].shape) == (LM_PREFILL[0], LM_NEW) and bool(
        ((gen["tokens"] >= 0) & (gen["tokens"] < v)).all()), "greedy tokens")
    # The scan (decode steps over bf16 caches; no K3) against the prefill
    # step on K3 and against the plain prefill (impl="ref"): across 40 bf16
    # layers two paths that round apart differ past LM_BF16_TOL in a few
    # logits, the plain pair too (PERF.md §6).  So K3's bar is that floor:
    # no more elements beyond the tolerance than the plain prefill has, and
    # every argmax of both equal.
    plain = model.forward(params, {"tokens": prompts}, impl="ref",
                          last_only=True)
    for key, want, what in (("scan_vs_forward_ref", plain, "ref"),
                            ("scan_vs_forward", fwd, "flash")):
        serve[key] = lm_close(
            torch, gen["prefill_logits"][..., :v], want[..., :v],
            LM_BF16_TOL, f"prefill_scan last logits vs forward({what}, "
            f"last_only) (bf16)", gate=False)
        check(serve[key]["argmax_equal"] == LM_PREFILL[0],
              f"prefill_scan and forward({what}) disagree on an argmax")
    beyond = serve["scan_vs_forward"]["beyond"]
    floor = serve["scan_vs_forward_ref"]["beyond"]
    check(beyond <= floor,
          f"prefill_scan vs forward(flash): {beyond} elements beyond "
          f"{LM_BF16_TOL}, more than the plain prefill's {floor}")
    last = LM_PROMPT + LM_NEW - 1  # rewrite the last slot: any index fits
    wall, device, busy_ms, _ = lm_profiled(torch, lambda: model.decode_step(
        params, gen["tokens"][:, -1:], gen["caches"], last))
    serve["decode_profile"] = {"wall_ms": wall, "device_busy_ms": busy_ms,
                               "device_busy_share": busy_ms / wall,
                               "device_ops": len(device)}
    print(f"  one profiled decode step: wall {wall:.2f} ms, device busy "
          f"{busy_ms:.2f} ms (share {busy_ms / wall:.3f}) over "
          f"{len(device)} device ops")
    out["serve"] = serve
    print(f"  serve path: prefill_scan of {LM_PROMPT} tokens x "
          f"{LM_PREFILL[0]} in {gen['prefill_s']:.3f} s "
          f"({serve['prefill_scan_step_ms']:.2f} ms a step); {LM_NEW} greedy "
          f"tokens in {gen['decode_s']:.3f} s ({serve['decode_step_ms']:.2f} "
          f"ms a step, {serve['tok_per_s']:.1f} tok/s); max allocated "
          f"{serve['max_memory_allocated'] / 1e9:.2f} GB  ({card})")
    del params, logits, ref_logits, gen, fwd
    torch.cuda.empty_cache()

    phi3 = build(get_arch(LM_PHI3))
    params = phi3.init(0, device="cuda")
    phi3_tokens = lm_tokens(torch, phi3.cfg, *LM_PHI3_PREFILL, seed=3)
    _, out["phi3_prefill"] = lm_prefill(torch, fak, phi3, params, phi3_tokens,
                                        card)
    del params
    torch.cuda.empty_cache()

    small = build(dataclasses.replace(cfg, n_layers=2, dtype="float32"))
    params = small.init(0, device="cuda")
    toks = lm_tokens(torch, cfg, *LM_CARD_CPU, seed=4)
    on_card = small.forward(params, {"tokens": toks}, impl="flash",
                            last_only=True).cpu()
    on_cpu = small.forward(tree_to(params, "cpu"), {"tokens": toks.cpu()},
                           impl="flash", last_only=True)
    err = max_abs(on_card[..., :v], on_cpu[..., :v])
    out["card_vs_cpu_2layer_f32_max_abs"] = err
    print(f"  2-layer full-width f32 [{LM_CARD_CPU[0]}, {LM_CARD_CPU[1]}]: "
          f"card (K3) vs CPU (plain) last logits max|err| {err:.2e} "
          f"(tolerance {LM_F32_TOL})")
    check(err <= LM_F32_TOL, f"2-layer f32 card vs CPU: {err}")
    del params
    torch.cuda.empty_cache()

    rows = [check_lm_kernel(torch, fak, ref, name, case, window,
                            out[key]["launches"], ptxas_rows)
            for name, case, window, key in LM_FA_CASES]
    for row in rows:
        row["sdpa_ratio"] = row["ms"] / row["library_ms"]
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out, rows


# phase 16: the FL operations layer at the FL CLI's defaults
# (python -m repro_torch.launch.fl_train: unsw, 12,000 samples, 40 clients,
# α 0.5, mlp at hidden 64, K₀ 8 adaptive, 5 local steps × 32, clipped DP at
# ε 50 and clip 5, iid failures 0.05 with checkpoint recovery, 100 rounds,
# eval every 5): nothing cut
CLI_SPANS = ("runner.build", "sweep.prepare", "sweep.execute",
             "sweep.readback")
CLI_PROFILE_ROUNDS = 10
NEUTRAL_SEEDS, NEUTRAL_ROUNDS = (0, 1, 2, 3), 20
CKPT_KEEP = 3
CKPT_WRITE_S = 0.08     # simulate_round_time's ckpt_write: one write
RNG_GOLDEN = ROOT / "tests" / "golden" / "torch_rng_reference.json"
RNG_P_GATE, RNG_EPS_TOL = 0.01, 1e-9


def cli_setup():
    """The FL CLI's defaults: ``(args, fed, FLConfig, eval_every)``."""
    from repro_torch.launch import fl_train
    args = fl_train.parse_args([])
    return (args, *fl_train.cli_config(args))


def jsonl_names(path) -> dict:
    """Counts of each span and event name in a tracer JSONL file."""
    counts = {}
    for line in Path(path).read_text().splitlines():
        name = json.loads(line)["name"]
        counts[name] = counts.get(name, 0) + 1
    return counts


def phase_fl_cli(torch, dpk, card):
    """Phase 16a: ``repro_torch.launch.fl_train.main`` in-process at its
    defaults with ``--json-out``, the tracer on and streaming JSONL into
    the output directory: K1a and K1b once a round (100 each, counts set to 0
    just before), the loop under sync debug mode "error", ``eps_spent``
    equal to the host accountant, one runner miss, one build span and one
    of each ``sweep.*`` span in the JSONL; then the warm round wall (the
    same config again, a cache hit) and the card's busy share of a
    profiled warm call of 10 rounds."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import fl_train
    from repro_torch.obs import trace as obs_trace
    from repro_torch.privacy.accountant import accounted_epsilon
    from repro_torch.train import fl_driver

    args, fed, fl, eval_every = cli_setup()
    OUT_DIR.mkdir(exist_ok=True)
    jsonl, json_out = OUT_DIR / "fl_cli_trace.jsonl", OUT_DIR / "fl_cli.json"
    jsonl.unlink(missing_ok=True)
    stats0 = dict(fl_driver.RUNNER_STATS)
    obs_trace.TRACER.enable(str(jsonl))
    try:
        torch.cuda.synchronize()
        dpk.reset_launches()
        with SyncModeSpy(torch) as spy:
            t0 = time.perf_counter()
            res = fl_train.main(["--json-out", str(json_out)])
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
        launches = dict(dpk.LAUNCHES)
    finally:
        obs_trace.TRACER.disable()
        obs_trace.TRACER.clear()
    names = jsonl_names(jsonl)
    print(f"  CLI: launches {launches}; JSONL {names}; cold "
          f"{cold_s:.2f} s  ({card})")
    check(spy.ok() and len(spy.modes) == 2, f"the CLI's round loop did not "
          f"run under sync debug mode 'error': {spy.modes}")
    check(launches == {"sumsq_rows": args.rounds,
                       "scale_noise_rows": args.rounds},
          f"the CLI did not go through the DP kernels once a round: "
          f"{launches}")
    check(fl_driver.RUNNER_STATS["misses"] == stats0["misses"] + 1,
          "the CLI did not build exactly one runner")
    want = {"compile.runner_miss": 1, **{n: 1 for n in CLI_SPANS}}
    check(names == want, f"the CLI's JSONL holds {names}, want {want}")
    eps_host = accounted_epsilon(fl_driver.fl_for_method(fl, args.method),
                                 args.rounds)
    check(res.eps_spent == eps_host, f"CLI eps_spent {res.eps_spent!r} != "
          f"the host accountant's {eps_host!r}")
    saved = json.loads(json_out.read_text())
    check(saved["eps_spent"] == res.eps_spent and saved["params"] is None
          and saved["history"]["round"] == list(range(eval_every,
                                                     args.rounds + 1,
                                                     eval_every)),
          "the CLI's --json-out differs from its result")
    h = res.history
    check(all(math.isfinite(v) for k in ("loss", "acc", "auc", "k", "fail",
                                        "cum_time") for v in h[k]),
          "the CLI's history has non-finite values")
    from repro_torch.tree import tree_leaves
    check(all(l.is_cuda and bool(torch.isfinite(l).all())
              for l in tree_leaves(res.params)),
          "the CLI's params are not finite CUDA tensors")

    kw = dict(seed=args.seed, eval_every=eval_every, dataset=args.dataset,
              device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = fl_driver.run_fl(fed, fl, args.method, rounds=args.rounds, **kw)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3 / args.rounds
    check(again.history == res.history,
          "a warm rerun of the CLI's config differs from the CLI's run")
    fl_driver.run_fl(fed, fl, args.method, rounds=CLI_PROFILE_ROUNDS, **kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fl_driver.run_fl(fed, fl, args.method, rounds=CLI_PROFILE_ROUNDS,
                         **kw)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    device, busy_ms, spans, by_kernel = profile_summary(prof.events(),
                                                        SWEEP_SPANS)
    for name in ("sweep.prepare", "sweep.execute", "sweep.readback"):
        check(name in spans, f"span {name} missing from the profile")
    dp_calls = {k: n for k, (n, _) in by_kernel.items()
                if re.search(r"sumsq_rows|scale_noise_rows", k)}
    check(sum(dp_calls.values()) == 2 * CLI_PROFILE_ROUNDS,
          f"profiled DP kernel calls {dp_calls}, want 2 a round")
    out = {"launches": launches, "cold_s": cold_s,
           "warm_round_ms": warm_ms, "eps_spent": res.eps_spent,
           "accuracy": res.accuracy, "auc": res.auc,
           "sim_time_s": res.sim_time_s, "jsonl": names,
           "profile": {"rounds": CLI_PROFILE_ROUNDS,
                       "wall_ms_per_round": prof_ms / CLI_PROFILE_ROUNDS,
                       "device_busy_ms_per_round":
                           busy_ms / CLI_PROFILE_ROUNDS,
                       "device_busy_share": busy_ms / prof_ms,
                       "device_ops_per_round":
                           len(device) / CLI_PROFILE_ROUNDS,
                       "span_host_ms": spans, "dp_kernel_calls": dp_calls}}
    print(f"  CLI at its defaults: acc={res.accuracy:.4f} auc={res.auc:.4f} "
          f"eps_spent={res.eps_spent!r} (host {eps_host!r}); warm round "
          f"wall {warm_ms:.2f} ms; profiled {CLI_PROFILE_ROUNDS} warm "
          f"rounds: {prof_ms / CLI_PROFILE_ROUNDS:.2f} ms a round, device "
          f"busy {busy_ms / CLI_PROFILE_ROUNDS:.3f} ms a round (share "
          f"{busy_ms / prof_ms:.4f}), "
          f"{len(device) / CLI_PROFILE_ROUNDS:.0f} device ops a round  "
          f"({card})")
    return out, res, fed, fl


def phase_tracer_neutral(torch, fed, fl, card):
    """Phase 16b: ``run_fl_batch`` with 4 lanes × 20 rounds, tracer off
    then on (streaming JSONL): histories and final params bitwise equal,
    each loop under sync debug mode "error"; the walls (a warm call first,
    then off, on, on, off), recorded, not gated."""
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train import fl_driver
    from repro_torch.tree import tree_leaves

    kw = dict(seeds=NEUTRAL_SEEDS, rounds=NEUTRAL_ROUNDS, eval_every=5,
              return_params=True, device="cuda")
    jsonl = OUT_DIR / "neutral_trace.jsonl"
    jsonl.unlink(missing_ok=True)

    def go(traced: bool):
        if traced:
            obs_trace.TRACER.enable(str(jsonl))
        try:
            with SyncModeSpy(torch) as spy:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fl_driver.run_fl_batch(fed, fl, "proposed", **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            obs_trace.TRACER.disable()
            obs_trace.TRACER.clear()
        check(spy.ok() and len(spy.modes) == 2, f"tracer {traced}: the loop "
              f"did not run under sync debug mode 'error': {spy.modes}")
        return res, wall

    go(False)                                # builds the runner
    walls = {False: [], True: []}
    runs = {}
    for traced in (False, True, True, False):
        runs[traced], wall = go(traced)
        walls[traced].append(wall)
    off, on = runs[False], runs[True]
    for a, b in zip(off, on):
        check(a.history == b.history and a.sim_time_s == b.sim_time_s,
              "the tracer changed a lane's history")
        check(all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                    tree_leaves(b.params))),
              "the tracer changed a lane's final params")
    names = jsonl_names(jsonl)
    check(names.get("sweep.execute") == 2 and "compile.runner_miss" not in
          names, f"the traced calls' JSONL holds {names}")
    ratio = min(walls[True]) / min(walls[False])
    print(f"  tracer on/off: {len(NEUTRAL_SEEDS)} lanes x {NEUTRAL_ROUNDS} "
          f"rounds bitwise equal (histories, params) under sync debug mode "
          f"'error'; walls off {walls[False]} s, on {walls[True]} s; min "
          f"on/off {ratio:.4f}  ({card})")
    return {"walls_off_s": walls[False], "walls_on_s": walls[True],
            "min_on_over_off": ratio, "jsonl": names}


def failure_gaps(failed_rounds) -> list:
    """Each client's gaps in rounds between failures (from round 0), from
    the per-round ``[n]`` failure masks."""
    import numpy as np
    f = np.stack(failed_rounds) > 0
    gaps = []
    for c in range(f.shape[1]):
        at = np.flatnonzero(f[:, c]) + 1
        gaps.extend(np.diff(np.concatenate([[0], at])).tolist())
    return gaps


def phase_checkpointer(torch, fed, fl, card):
    """Phase 16c: the per-round driver (``run_fl_legacy``, which reads each
    round back; the sweep engine reads nothing back inside its loop) at
    the CLI's config on the card, saving the CUDA params every round
    through ``Checkpointer(keep=3)``: 3 checkpoints remain, and
    ``restore_latest(like=the CUDA params)`` returns CUDA tensors bitwise
    equal to the final params.  Then the paper's host-side analysis,
    printed only: ``fit_weibull`` over the run's per-client failure gaps
    (rounds × the mean simulated round time) and
    ``optimal_checkpoint_interval`` with the renewal form."""
    import shutil

    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.core import fault as fault_lib
    from repro_torch.train import fl_driver
    from repro_torch.tree import tree_leaves

    args, _, _, eval_every = cli_setup()
    ckpt_dir = OUT_DIR / "fl_cli_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ck = Checkpointer(str(ckpt_dir), keep=CKPT_KEEP, interval_rounds=1)
    failed = []

    def on_round(r, state, m):
        ck.maybe_save(r, state.params)
        failed.append(m.failed.cpu().numpy())

    t0 = time.perf_counter()
    res = fl_driver.run_fl_legacy(fed, fl, args.method, seed=args.seed,
                                  rounds=args.rounds, eval_every=eval_every,
                                  device="cuda", on_round=on_round)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    files = sorted(p.name for p in ckpt_dir.iterdir())
    check(ck.saves == args.rounds and len(files) == 2 * CKPT_KEEP,
          f"{ck.saves} saves left {files}")
    rnd, restored = ck.restore_latest(res.params)
    check(rnd == args.rounds - 1, f"latest checkpoint is round {rnd}")
    pairs = list(zip(tree_leaves(restored), tree_leaves(res.params)))
    check(all(a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
              for a, b in pairs),
          "restore_latest onto CUDA params is not bitwise equal on the card")
    round_s = res.sim_time_s / args.rounds
    gaps = failure_gaps(failed)
    lam, k = fault_lib.fit_weibull([g * round_s for g in gaps])
    t_c = fault_lib.optimal_checkpoint_interval(
        res.sim_time_s, fl.recovery_time, lam, k, write_cost=CKPT_WRITE_S)
    out = {"saves": ck.saves, "files": files, "latest_round": rnd,
           "legacy_wall_s": wall_s, "sim_time_s": res.sim_time_s,
           "n_gaps": len(gaps), "weibull_lam_s": lam, "weibull_k": k,
           "t_c_s": t_c, "t_c_rounds": t_c / round_s}
    print(f"  Checkpointer: {ck.saves} saves of the CUDA params (one a "
          f"round), {len(files) // 2} kept {files[::2]}, restore_latest "
          f"bitwise onto CUDA; run_fl_legacy {wall_s:.2f} s with the saves  "
          f"({card})")
    print(f"  fault model: fit_weibull over {len(gaps)} failure gaps -> "
          f"lambda {lam:.2f} s, k {k:.4f}; t_c* (renewal, w = "
          f"{CKPT_WRITE_S} s, t_r = {fl.recovery_time} s, T = "
          f"{res.sim_time_s:.1f} s) = {t_c:.2f} s = "
          f"{t_c / round_s:.2f} rounds (printed, not gated)")
    return out


def phase_personalized(torch, fed, params, card):
    """Phase 16d: ``export_personalized`` of the CLI's params, served by
    ``ServeEngine(..., heads=...)`` on the card: ``score(x, client=i)``
    of the first and last client bitwise equal to the scorer on that
    client's ``personalized_client_params`` over the same bucket
    batches."""
    import numpy as np

    from repro_torch.models.spec import get_model_spec, meta_for
    from repro_torch.serve import ServeEngine, batches_of
    from repro_torch.serve.engine import _get_scorer
    from repro_torch.train import fl_driver

    meta = meta_for(fed, hidden=64)
    spec = get_model_spec("mlp", meta)
    heads = fl_driver.export_personalized(params, fed, spec)
    per_client = fl_driver.personalized_client_params(params, fed, spec)
    eng = ServeEngine(spec, meta, params, heads=heads,
                      buckets=SERVE_BUCKETS, device="cuda")
    check(eng.n_personalized == fed.n_clients, "heads' client axis")
    x = np.asarray(fed.test_x, np.float32)
    for ci in (0, fed.n_clients - 1):
        got = eng.score(x, client=ci)
        want = np.concatenate([
            _get_scorer(spec, meta, xb.shape[0], eng.route)(
                per_client[ci], torch.as_tensor(xb, device="cuda")
            )[:n].cpu().numpy() for xb, n in batches_of([x], eng.buckets)])
        check(np.array_equal(got, want), f"client {ci}: served personalised "
              f"scores differ from its personalized_client_params'")
    print(f"  personalised heads: {eng.n_personalized} clients exported, "
          f"clients 0 and {fed.n_clients - 1} served bitwise on "
          f"{x.shape[0]} windows  ({card})")
    return {"n_clients": eng.n_personalized, "windows": int(x.shape[0])}


def phase_rng_check(torch, dpk, ref, fed, fl, card):
    """Phase 16e: the own-RNG distribution check (ROADMAP Queue 1 item 2):
    ``run_fl_batch`` on the card's own generators at seeds 0-9 (one lane a
    seed, DP rows [400, 4,898]) against the reference's per-seed finals in
    ``tests/golden/torch_rng_reference.json``: two-sided Mann-Whitney p >=
    0.01 on final accuracy and ε within 1e-9 (gates); the paper's α = 0.05
    verdict, AUC and mean-K tests printed.  Then K1 at the CLI's rows [40,
    4,898] and this check's [400, 4,898] against its plain versions, timed
    beside ``vector_norm`` and the bounds."""
    import numpy as np

    from repro_torch.stats import compare_finals
    from repro_torch.train import fl_driver

    golden = json.loads(RNG_GOLDEN.read_text())
    args, _, _, eval_every = cli_setup()
    cfg = golden["config"]
    check((cfg["rounds"], cfg["eval_every"], cfg["n_clients"],
           cfg["n_samples"]) == (args.rounds, eval_every, args.clients,
                                 args.samples) and
          all(cfg["fl"][k] == getattr(fl, k) for k in cfg["fl"]),
          "the golden file's config is not the CLI's")
    seeds = cfg["seeds"]
    dpk.reset_launches()
    t0 = time.perf_counter()
    res = fl_driver.run_fl_batch(fed, fl, args.method, seeds=seeds,
                                 rounds=args.rounds, eval_every=eval_every,
                                 dataset=args.dataset, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(dpk.LAUNCHES)
    check(launches == {"sumsq_rows": args.rounds,
                       "scale_noise_rows": args.rounds},
          f"the check's lanes did not share one DP launch a round: "
          f"{launches}")
    rows = [{"accuracy": r.accuracy, "auc": r.auc,
             "mean_k": float(np.mean(r.history["k"])),
             "eps_spent": r.eps_spent} for r in res]
    ref_rows = golden["rows"]
    finals = compare_finals(rows, ref_rows)
    med = {k: v[:2] for k, v in finals.items()}
    p = {k: v[2] for k, v in finals.items()}
    eps_err = max(abs(a["eps_spent"] - b["eps_spent"])
                  for a, b in zip(rows, ref_rows))
    print(f"  own-RNG check, seeds {seeds[0]}-{seeds[-1]}, {wall_s:.2f} s: "
          f"medians card/reference {med}; two-sided Mann-Whitney p "
          f"accuracy {p['accuracy']:.4f} (gate >= {RNG_P_GATE}), auc "
          f"{p['auc']:.4f}, mean K {p['mean_k']:.4f}; paper's alpha 0.05 "
          f"verdict on accuracy: "
          f"{'differ' if p['accuracy'] < 0.05 else 'no difference'}; "
          f"eps max|err| {eps_err:.3e}  ({card})")
    check(eps_err <= RNG_EPS_TOL, f"eps_spent differs from the reference's "
          f"by {eps_err:.3e}")
    check(p["accuracy"] >= RNG_P_GATE, f"own-RNG final accuracy differs "
          f"from the reference's: two-sided p {p['accuracy']:.4f}")
    p_mlp = param_count(args.dataset, 64)
    dp_rows = {"cli": check_dp_rows(torch, dpk, ref, args.clients, p_mlp,
                                    "FL CLI"),
               "rng_check": check_dp_rows(torch, dpk, ref,
                                          len(seeds) * args.clients, p_mlp,
                                          "own-RNG check")}
    return {"seeds": seeds, "wall_s": wall_s, "launches": launches,
            "p": p, "medians": med, "eps_max_abs": eps_err,
            "rows": rows, "dp_rows": dp_rows}


# phase 17: federated LM training through the train CLI's function at its
# defaults with --dp (python -m repro_torch.launch.train: 8 clients, 2
# client slots a round, 1 local step, batch 2, seq 64, lr 0.005, clipped DP
# at ε 50 and clip 10, failures 0.05, 3 rounds, remat "none", seed 0) on
# granite-3-8b at full width, its depth cut 40 -> 8 (the serial round holds
# ~28 bytes a parameter at its peak in the reference's reckoning: 229 GB at
# 40 layers, 50 GB at 8)
LMT_LAYERS = 8
LMT_PARAMS = 1_795_174_400  # ModelConfig.param_count() at 8 layers
# the update's flat row: the tree's elements, with the norm scales and the
# vocab padding (49,408 rows) that param_count leaves out
LMT_ROW = 1_796_280_320
LMT_ROUNDS = 3
LMT_SLOTS = 2               # the CLI's --clients-per-step
LMT_CUT = 2                 # layers of the f32 card-vs-CPU cut
LMT_CUT_ROUNDS = 2
LMT_CUT_SEEDS = (1, 3)      # each seed its own params, state, data, draws
LMT_TOL = 1e-4
# After a round of DP noise (σ ≈ 0.97 an element against weights of 0.02)
# the softmaxes saturate (loss ~220, scores of 1e3-1e4), so the same f32
# sums taken in another order move the next round's values far more than
# 1e-4.  Each value of a round after the first is therefore held at
# LMT_REASSOC_MULT times its re-association gap, read in the same run: the
# larger of the card's and the CPU's difference between that same round at
# grad_accum 2 and at 1 (same state, same draws), and never under LMT_TOL.
# That split re-associates only the sum over the batch; card against CPU
# re-associates every GEMM's reduction as well, hence the multiple
LMT_REASSOC_MULT = 8.0
LMT_SQ_RTOL = 1e-6
LMT_SPANS = ("selection", "local_train", "dp_privatize", "aggregate")
# a profiled round's device time by kind: the first pattern a kernel's name
# matches (cuBLAS names its H100 GEMMs nvjet_*, sm90_xmma_*)
LMT_KINDS = (("K1", r"sumsq_rows|scale_noise_rows"),
             ("GEMMs", r"gemm|xmma|cutlass|nvjet|cublas"),
             ("noise draw", r"normal|philox|distribution"),
             ("copies and casts", r"copy|Memcpy|Memset"),
             ("other", r""))


def lm_train_profiled(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: its host wall (ms, to a
    synchronise), the device busy ms (the round's spans left out), the
    spans' host ms and the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device, busy_ms, spans, by_kernel = profile_summary(prof.events(),
                                                        LMT_SPANS)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    kinds = {kind: 0.0 for kind, _ in LMT_KINDS}
    for name, (_, ms) in by_kernel.items():
        kind = next(k for k, pat in LMT_KINDS if re.search(pat, name))
        kinds[kind] += ms
    return {"wall_ms": wall, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall, "device_ops": len(device),
            "spans_host_ms": spans, "device_ms_by_kind": kinds,
            "top_kernels": [{"name": k[:80], "calls": n, "device_ms": t}
                            for k, (n, t) in top]}


def lm_train_k1(torch, dpk, ref, launches, card, p: int = LMT_ROW,
                tag: str = "lm_train"):
    """K1a and K1b at the LM update's row [1, P] against their plain
    versions (``sumsq_rows`` to a relative 1e-6 and bitwise repeatable;
    ``scale_noise_rows`` bitwise, compared a slice of columns at a time:
    at P > 2^31 the whole plain output would not fit beside the kernel's),
    timed by CUDA events over 5 calls each (ms a call: host dispatch is
    ~20 us of it) beside the plain versions, ``vector_norm`` / ``addcmul``
    on σ·n and the bytes bound; ``sumsq_rows`` also on the cluster plan,
    the one a row of this width took before the split plan (8 blocks).
    Rows ``sumsq_rows_<tag>`` and ``scale_noise_rows_<tag>``."""
    from repro_torch.core.dp import gaussian_sigma

    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn(1, p, generator=gen, device="cuda") * 1e-3
    nz = torch.randn(1, p, generator=gen, device="cuda")
    plan = dpk.sumsq_plan(1, p)
    check(plan.split > 1, f"sumsq plan at [1, {p}]: {plan}")
    cluster = dpk.cluster_plan(1, p)
    sq, sq_ref = dpk.sumsq_rows(x), ref.sumsq_rows_ref(x)
    sq_cluster = dpk._launch_sumsq(x, cluster)
    rel = float((sq.double() - sq_ref.double()).abs() / sq_ref.double())
    rel_cluster = float((sq_cluster.double() - sq_ref.double()).abs()
                        / sq_ref.double())
    check(rel <= LMT_SQ_RTOL, f"sumsq_rows at [1, {p}]: relative {rel}")
    check(torch.equal(sq, dpk.sumsq_rows(x)),
          f"sumsq_rows not bitwise repeatable at [1, {p}]")
    sigma = gaussian_sigma(50.0, 1e-5, 10.0)
    scale = ref.clip_scale(torch.sqrt(sq_ref), 10.0)
    o = dpk.scale_noise_rows(x, nz, scale, sigma)
    step = 1 << 28
    check(all(torch.equal(o[:, a:a + step], ref.scale_noise_rows_ref(
        x[:, a:a + step], nz[:, a:a + step], scale, sigma))
        for a in range(0, p, step)),
        f"scale_noise_rows is not bitwise its plain version at [1, {p}]")
    # in place, as the serial round noises its update row
    xi = x.clone()
    check(torch.equal(dpk.scale_noise_rows(xi, nz, scale, sigma, out=xi), o),
          f"scale_noise_rows in place differs at [1, {p}]")
    del o, xi
    torch.cuda.empty_cache()

    def ms(fn):
        return eager_ms(fn, iters=5, reps=3)

    t_sq = {"ms": ms(lambda: dpk.sumsq_rows(x)),
            "plain_ms": ms(lambda: ref.sumsq_rows_ref(x)),
            "library_ms": ms(lambda: torch.linalg.vector_norm(x, dim=1)),
            "cluster_plan_ms": ms(lambda: dpk._launch_sumsq(x, cluster))}
    t_sn = {"ms": ms(lambda: dpk.scale_noise_rows(x, nz, scale, sigma)),
            "plain_ms": ms(lambda: ref.scale_noise_rows_ref(x, nz, scale,
                                                            sigma)),
            "library_ms": None}
    sn, scale_col = sigma * nz, scale[:, None]
    t_sn["addcmul_ms"] = ms(lambda: torch.addcmul(sn, x, scale_col))
    del sn
    common = {"route": "cuda", "shape": [1, p],
              "source": "src/repro_torch/kernels/csrc/dp_clip_noise.cu",
              "timing": "CUDA events, 5 back-to-back calls, median of 3"}
    b_sq, by_sq = sumsq_bound(1, p)
    b_sn, by_sn = bound(12 * p + 4, 3 * p)
    rows = [
        {"name": f"sumsq_rows_{tag}", **common,
         "replaces": "src/repro/kernels/dp_clip_noise.py:62",
         "launches": launches["sumsq_rows"],
         "max_abs_err": float((sq.double() - sq_ref.double()).abs()),
         "rel_err": rel, "cluster_plan_rel_err": rel_cluster,
         "plan": list(plan), "bound_ms": b_sq, "bound_by": by_sq, **t_sq},
        {"name": f"scale_noise_rows_{tag}", **common,
         "replaces": "src/repro/kernels/dp_clip_noise.py:81",
         "launches": launches["scale_noise_rows"], "max_abs_err": 0.0,
         "bound_ms": b_sn, "bound_by": by_sn, **t_sn}]
    print(f"  K1 at [1, {p:,}] ({card}): sumsq_rows (split plan, "
          f"{plan.split} blocks) rel err {rel:.2e} (cluster plan "
          f"{rel_cluster:.2e}), bitwise repeatable; {t_sq['ms']:.3f} ms "
          f"(bound {b_sq:.3f} ms, {by_sq}; cluster plan "
          f"{t_sq['cluster_plan_ms']:.3f} ms; plain {t_sq['plain_ms']:.3f}; "
          f"vector_norm {t_sq['library_ms']:.3f}); scale_noise_rows bitwise "
          f"its plain version, {t_sn['ms']:.3f} ms (bound {b_sn:.3f} ms; "
          f"plain {t_sn['plain_ms']:.3f}; addcmul on σ·n "
          f"{t_sn['addcmul_ms']:.3f})")
    return rows


def lmt_round_values(state, metrics):
    """The values of a serial round that the card and the CPU must agree
    on, by name: each a list of tensors."""
    from repro_torch.tree import tree_leaves

    out = {f: [getattr(metrics, f)]
           for f in ("pre_loss", "post_loss", "global_loss", "update_norms")}
    out["util"] = list(state.util)
    out["params"] = tree_leaves(state.params)
    return out


def lmt_rel_err(a, b, scale_by=None) -> float:
    """max |a − b| over ``scale_by``, by default max(1, max |b|), on
    ``b``'s device in ``b``'s dtype (f32: a − b is exact where a and b
    are within a factor of 2, and otherwise off by 2^-24 of the larger,
    far under any bar here; an f64 copy of the 600 M params would cost
    seconds a comparison on the host)."""
    b = b.detach()
    if not b.numel():
        return 0.0
    a = a.detach().to(b.device, b.dtype)
    scale = max(1.0, float(b.abs().max())) if scale_by is None else scale_by
    return float((a - b).abs().max()) / scale


def lmt_diff(va, vb) -> dict:
    """:func:`lmt_rel_err` of two :func:`lmt_round_values`, name by name
    (the largest over a name's tensors)."""
    return {k: max(lmt_rel_err(a, b) for a, b in zip(va[k], vb[k]))
            for k in va}


def lm_train_card_vs_cpu(torch, card):
    """The 2-layer f32 cut at granite's width: ``grad_accum`` 2 against 1
    and remat "full" and "dots" against "none" on the card at the first
    seed's initial params (LMT_TOL, grads of each leaf's max|g|); then, at
    each of LMT_CUT_SEEDS, 2 serial rounds with clipped DP on the card and
    on the CPU from the same state and the same ``SerialDraws`` (the DP
    noise drawn on the card, one row a slot): sel_mask and failed equal,
    the first round's values within LMT_TOL (relative, and absolute of
    max(1, |x|)), the noised second round's within LMT_REASSOC_MULT times
    their re-association gap read in this run (the same round at
    grad_accum 2 on each device).  Every reading is printed before any bar
    is checked."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.data.tokens import lm_round_batches
    from repro_torch.launch.train import train_fl_config
    from repro_torch.models.model import build
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=LMT_CUT,
                              dtype="float32")
    model = build(cfg)
    fl = train_fl_config(dp=True)
    n = fl.n_clients

    def loss(remat="none"):
        return lambda p, b: model.loss(p, b, remat=remat)

    steps = {(dev, ga): rounds_lib.make_serial_round(
        loss(), fl, n, device=dev, grad_accum=ga)
        for dev in ("cuda", "cpu") for ga in (1, 2)}
    readings = []  # (what, err, bar)

    params = model.init(LMT_CUT_SEEDS[0], device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = {k: torch.as_tensor(v, device="cuda")[0, 0] for k, v in
             lm_round_batches(cfg.vocab_size, 1, 1, 2, 64, 9).items()}
    base_loss, base_g = rounds_lib.microbatched_value_and_grad(
        loss(), 1)(params, batch)
    variants = {"grad_accum=2": rounds_lib.microbatched_value_and_grad(
        loss(), 2)}
    variants.update({f"remat={m}": rounds_lib.value_and_grad(loss(m))
                     for m in ("full", "dots")})
    for name, vag in variants.items():
        v_loss, v_g = vag(params, batch)
        readings.append((f"{name} loss", lmt_rel_err(v_loss, base_loss),
                         LMT_TOL))
        readings.append((f"{name} grads", max(
            lmt_rel_err(a, b, max(float(b.abs().max()), 1e-30))
            for a, b in zip(tree_leaves(v_g), tree_leaves(base_g))),
            LMT_TOL))
    del base_g, v_g, params

    mismatch, seed_s = [], []
    for seed in LMT_CUT_SEEDS:
        t0 = time.perf_counter()
        params = model.init(seed, device="cuda")
        card_state = rounds_lib.init_serial_state(
            params, fl, torch.Generator(device="cuda").manual_seed(seed))
        cpu_state = card_state._replace(
            params=tree_to(params, "cpu"),
            util=type(card_state.util)(*(t.cpu() for t in card_state.util)),
            kctl=type(card_state.kctl)(*(t.cpu() for t in card_state.kctl)),
            rng=torch.Generator().manual_seed(seed),
            fault=type(card_state.fault)(*(t.cpu()
                                           for t in card_state.fault)))
        del params
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        for r in range(LMT_CUT_ROUNDS):
            data = {k: torch.as_tensor(v) for k, v in lm_round_batches(
                cfg.vocab_size, LMT_SLOTS, 1, 2, 64, 100 * seed + r).items()}
            data_c = {k: v.cuda() for k, v in data.items()}
            draws = rounds_lib.draw_serial_round(gen, n, LMT_SLOTS, 1,
                                                 fl.selection)._replace(
                dp_noise=torch.randn(LMT_SLOTS, n_params, generator=gen,
                                     device="cuda"))
            draws_h = draws.to("cpu")
            bars, out, gaps = {}, {}, {}
            for dev, st, d, dr in (("cuda", card_state, data_c, draws),
                                   ("cpu", cpu_state, data, draws_h)):
                out[dev] = steps[dev, 1](st, d, draws=dr)
                if r > 0:  # the same round at grad_accum 2
                    gaps[dev] = lmt_diff(
                        lmt_round_values(*steps[dev, 2](st, d, draws=dr)),
                        lmt_round_values(*out[dev]))
            for k in gaps.get("cuda", {}):
                gap = max(gaps["cuda"][k], gaps["cpu"][k])
                bars[k] = max(LMT_TOL, LMT_REASSOC_MULT * gap)
                readings.append((f"seed {seed} round {r} {k} grad_accum "
                                 f"gap: card {gaps['cuda'][k]:.2e}, CPU "
                                 f"{gaps['cpu'][k]:.2e}", gap, None))
            (card_state, mc), (cpu_state, mh) = out["cuda"], out["cpu"]
            del out
            del draws, draws_h, data_c
            if not (torch.equal(mc.sel_mask.cpu(), mh.sel_mask)
                    and torch.equal(mc.failed.cpu(), mh.failed)):
                mismatch.append(f"seed {seed} round {r}")
            for k, err in lmt_diff(lmt_round_values(card_state, mc),
                                   lmt_round_values(cpu_state, mh)).items():
                readings.append((f"seed {seed} round {r} {k}", err,
                                 bars.get(k, LMT_TOL)))
        del card_state, cpu_state
        torch.cuda.empty_cache()
        seed_s.append(time.perf_counter() - t0)
    print(f"  2-layer f32 cut ({n_params:,} params; "
          f"{' + '.join(f'{t:.1f}' for t in seed_s)} s a seed): "
          f"seeds {LMT_CUT_SEEDS}, {LMT_CUT_ROUNDS} serial rounds with DP "
          f"card vs CPU on the same draws (sel_mask and failed "
          f"{'equal' if not mismatch else 'DIFFER: ' + ', '.join(mismatch)}"
          f"), grad_accum 2 and remat full, dots vs none on the card; "
          f"relative errors against their bars (LMT_TOL {LMT_TOL}; after a "
          f"noised round {LMT_REASSOC_MULT:g} x the larger grad_accum gap):")
    for what, err, bar in readings:
        print(f"    {what}: {err:.2e}"
              + ("" if bar is None else f" (bar {bar:.2e})"))
    check(not mismatch, f"sel_mask/failed differ card vs CPU: {mismatch}")
    for what, err, bar in readings:
        if bar is not None:
            check(err <= bar, f"{what}: {err:.3e} over its bar {bar:.3e}")
    return {"params": n_params, "seeds": list(LMT_CUT_SEEDS),
            "readings": [{"what": w, "err": e, "bar": b}
                         for w, e, b in readings],
            "seed_s": seed_s}


def phase_lm_train(torch, dpk, ref, card):
    """Phase 17: federated LM training on granite-3-8b at full width and 8
    layers (bf16), through ``launch/train.py``'s ``train`` at the CLI's
    defaults with ``--dp``: K1a/K1b once per privatised slot (counted from
    0 just before), finite losses, the eval loss before and after, the
    warm round wall, peak memory, a client step's forward+backward, one
    profiled round (busy share, spans, heaviest kernels); K1 at [1, P]
    against its plain versions and timed; the 2-layer f32 cut card vs
    CPU."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.data.tokens import lm_round_batches
    from repro_torch.launch.train import train

    out = {}
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=LMT_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dpk.reset_launches()
    res = train(cfg, rounds=LMT_ROUNDS, dp=True, seed=0, device="cuda")
    torch.cuda.synchronize()
    launches = dict(dpk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    model, step, state = res["model"], res["step"], res["state"]
    n, nbytes = tree_bytes(state.params)
    check(cfg.param_count() == LMT_PARAMS and n == LMT_ROW,
          f"{cfg.param_count()} params ({n} elements) at {LMT_LAYERS} "
          f"layers")
    losses = ([res["initial_eval_loss"], res["final_eval_loss"]]
              + [r["local_loss"] for r in res["rounds"]])
    check(all(math.isfinite(v) for v in losses), f"LM losses {losses}")
    slots = LMT_ROUNDS * LMT_SLOTS
    check(launches == {"sumsq_rows": slots, "scale_noise_rows": slots},
          f"K1 launches {launches} for {slots} privatised slots")
    walls = [r["wall_s"] * 1e3 for r in res["rounds"]]
    out.update(layers=LMT_LAYERS, params=n, param_bytes=nbytes,
               launches=launches, eval_loss=[losses[0], losses[1]],
               rounds=[{k: v for k, v in r.items()} for r in res["rounds"]],
               round_wall_ms=walls,
               warm_round_wall_ms=statistics.median(walls[1:]),
               max_memory_allocated=peak)

    data = {k: torch.as_tensor(v, device="cuda") for k, v in
            lm_round_batches(cfg.vocab_size, LMT_SLOTS, 1, 2, 64,
                             7).items()}
    vag = rounds_lib.value_and_grad(lambda p, b: model.loss(p, b,
                                                            remat="none"))
    batch = {k: v[0, 0] for k, v in data.items()}
    fb = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vag(state.params, batch)
        torch.cuda.synchronize()
        fb.append((time.perf_counter() - t0) * 1e3)
    out["fwd_bwd_ms"] = fb
    out["fwd_bwd_ms_median_warm"] = statistics.median(fb[1:])

    def one_round():
        nonlocal state
        state, _ = step(state, data)

    out["profile"] = lm_train_profiled(torch, one_round)
    prof = out["profile"]
    print(f"  {cfg.name} at {LMT_LAYERS} layers: {cfg.param_count():,} "
          f"params, {n:,} elements ({nbytes / 1e9:.2f} GB bf16); eval loss {losses[0]:.4f} -> "
          f"{losses[1]:.4f}; round walls "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms (warm "
          f"{out['warm_round_wall_ms']:.1f}); K1 launches {launches}; peak "
          f"allocated {peak / 1e9:.2f} GB; client step forward+backward "
          f"{out['fwd_bwd_ms_median_warm']:.2f} ms; profiled round "
          f"{prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms (share "
          f"{prof['device_busy_share']:.3f}, {prof['device_ops']} ops)  "
          f"({card})")
    for name, ms in sorted(prof["spans_host_ms"].items()):
        print(f"    span {name}: {ms:.2f} ms host")
    for kind, ms in prof["device_ms_by_kind"].items():
        print(f"    device {kind}: {ms:.2f} ms")
    for k in prof["top_kernels"]:
        print(f"    kernel {k['name']}: {k['calls']} calls, "
              f"{k['device_ms']:.3f} ms")
    del res, model, step, state, vag, data, batch
    torch.cuda.empty_cache()

    rows = lm_train_k1(torch, dpk, ref, launches, card)
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = lm_train_card_vs_cpu(torch, card)
    torch.cuda.empty_cache()
    return out, rows


# phase 18: the recurrent LM families at full width and depth in bf16:
# recurrentgemma-9b (38 layers: 26 rec with K2 in the prefill, 12 local
# attention with K3 at D = 256, window 2048) and mamba2-130m (24 ssd
# layers, no kernel, as in the reference's LM) through the serve CLI
REC_ARCH, SSD_ARCH = "recurrentgemma_9b", "mamba2_130m"
REC_ELEMENTS = 9_396_408_320   # lm_param_shapes' elements (wa/wx included)
REC_K2, REC_K3 = 26, 12        # launches a prefill step: rec, attn layers
REC_CUT = 2                    # layers of the f32 cut: ("rec", "rec")
REC_CUT_TOKENS = (2, 128)      # B, S of the f32 cut's forward
REC_DECODE_STEPS = 8           # decode steps card vs CPU (each f32 model)
SSD_ELEMENTS = 129_100_224
SSD_PREFILL = (4, 512)
SSD_CUT = 2                    # layers of mamba2's f32 cut at 1e-4
# mamba2's f32 copy at all 24 layers is held, card against CPU and card
# against f64, at COND_MULT times the CPU's own f32 distance from its f64
# run of the same weights (read in the run, never under 1e-4): two f32
# runs each g from the exact result may differ by 2g, and the card's
# reduction order may be the less accurate one by as much again
COND_MULT = 4.0
# K2 at the rec prefill's two shapes (no h0) and K3 at its local
# attention's (16 | 1 heads of 256, window 2048), with the prefill whose
# launches count
REC_K2_CASES = (
    ("rglru_scan_recurrentgemma_prefill", (4, 512, 4096), "prefill"),
    ("rglru_scan_recurrentgemma_long", (1, 4096, 4096), "long_prefill"))
REC_FA_CASES = (
    ("flash_attention_recurrentgemma_prefill", (4, 512, 16, 1, 256), 2048,
     "prefill"),
    ("flash_attention_recurrentgemma_local", (1, 4096, 16, 1, 256), 2048,
     "long_prefill"))
REC_GEMM = LMT_KINDS[1][1]     # cuBLAS kernel names
REC_GEMM_F32 = r"f32f32|sgemm"  # of those, the f32 products' (TF32 off)


def device_by_kind(by_kernel) -> dict:
    """(calls, device ms) of a profile's kernels by kind: K2, K3, the
    cuBLAS GEMMs in f32 (TF32 off) and in bf16 by kernel name, and the
    rest."""
    kinds = {k: [0, 0.0] for k in ("K2", "K3", "f32 GEMMs", "bf16 GEMMs",
                                    "other")}
    for name, (n, t) in by_kernel.items():
        kind = ("K2" if "rglru_scan" in name else
                "K3" if FA_MMA_KERNEL in name else
                "other" if not re.search(REC_GEMM, name) else
                "f32 GEMMs" if re.search(REC_GEMM_F32, name) else
                "bf16 GEMMs")
        kinds[kind][0] += n
        kinds[kind][1] += t
    return kinds


def rec_prefill(torch, fak, rgk, model, params, tokens, card):
    """recurrentgemma-9b's prefill step (``forward(impl="flash",
    last_only=True)``): K2's and K3's counts set to 0 just before the
    main-path call and read just after (26 and 12); three warm calls by
    the host clock, counted again; one profiled call (busy share; device
    ms of K2, K3 (26 and 12 calls), the cuBLAS GEMMs by kernel name in f32
    (the RG-LRU gates' two a ``rec`` layer, TF32 off) and in bf16, and
    the rest)."""
    def step():
        return model.forward(params, {"tokens": tokens}, impl="flash",
                             last_only=True)

    def reset():
        rgk.reset_launches()
        fak.reset_launches()

    def counts():
        return (rgk.LAUNCHES["rglru_scan"], fak.LAUNCHES["flash_attention"])

    reset()
    logits = step()
    torch.cuda.synchronize()
    launches = counts()
    check(launches == (REC_K2, REC_K3),
          f"(rglru_scan, flash_attention) launches {launches} in one "
          f"prefill, not {(REC_K2, REC_K3)}")
    check(bool(torch.isfinite(logits[..., :model.cfg.vocab_size]).all()),
          "non-finite prefill logits")
    walls = []
    for _ in range(3):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(counts() == (REC_K2, REC_K3), "launches of a warm prefill")
    prof_wall, device, busy_ms, by_kernel = lm_profiled(torch, step)
    kinds = device_by_kind(by_kernel)
    check((kinds["K2"][0], kinds["K3"][0]) == (REC_K2, REC_K3),
          f"K2, K3 kernel calls in a profiled prefill: {kinds}")
    warm = statistics.median(walls)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:6]
    out = {"launches": {"rglru_scan": launches[0],
                        "flash_attention": launches[1]},
           "warm_wall_ms": walls, "warm_wall_ms_median": warm,
           "profiled_wall_ms": prof_wall, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / prof_wall,
           "device_ops": len(device),
           "device_ms_by_kind": {k: {"calls": n, "ms": t}
                                 for k, (n, t) in kinds.items()},
           "top_kernels": [{"name": k[:80], "calls": n, "device_ms": t}
                           for k, (n, t) in top]}
    b, s = tokens.shape
    print(f"  {model.cfg.name} prefill [{b}, {s}] (impl=flash, last_only): "
          f"{launches[0]} rglru_scan and {launches[1]} flash_attention "
          f"launches a call; warm wall {warm:.2f} ms "
          f"({', '.join(f'{w:.2f}' for w in walls)}); profiled "
          f"{prof_wall:.2f} ms, device busy {busy_ms:.2f} ms (share "
          f"{busy_ms / prof_wall:.3f}, {len(device)} ops)  ({card})")
    for kind, (n, t) in kinds.items():
        print(f"    device {kind}: {n} calls, {t:.3f} ms "
              f"({100 * t / busy_ms:.1f} % of busy)")
    for k in out["top_kernels"]:
        print(f"    kernel {k['name']}: {k['calls']} calls, "
              f"{k['device_ms']:.3f} ms")
    return logits, out


def check_rec_scan(torch, rgk, ref, name, case, launches, ptxas):
    """K2 at a recurrentgemma prefill shape (a, x [B, L, W] f32, no h0):
    bitwise its plain version and bitwise repeatable, timed beside it
    (CUDA-graph replay of 5 calls) and its bound; no PyTorch call computes
    a sequential recurrence, so no library time."""
    b, l, w = case
    gen = torch.Generator().manual_seed(13)
    a = torch.sigmoid(torch.randn(b, l, w, generator=gen)).cuda()
    x = torch.randn(b, l, w, generator=gen).cuda()
    h, h_last = rgk.rglru_scan(a, x)
    h_ref, hl_ref = ref.rglru_scan_ref(a, x)
    check(torch.equal(h, h_ref) and torch.equal(h_last, hl_ref),
          f"{name}: rglru_scan not bitwise equal to its plain version")
    h2, hl2 = rgk.rglru_scan(a, x)
    check(torch.equal(h, h2) and torch.equal(h_last, hl2),
          f"{name}: rglru_scan not bitwise repeatable")
    b_rg, by_rg = scan_bound((b, l, w, False))
    plan = rgk.launch_plan(b, l, w, True)
    row = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:60",
        "shape": [b, l, w], "launches": launches,
        "max_abs_err": max_abs(h, h_ref), "bound_ms": b_rg,
        "bound_by": by_rg, "plan": plan._asdict(),
        "ptxas": ptxas.get(str(plan.vec)),
        **timed(lambda: rgk.rglru_scan(a, x),
                lambda: ref.rglru_scan_ref(a, x), None, iters=5),
    }
    print(f"  {name} [{b}, {l}, {w}]: bitwise its plain version and "
          f"repeatable; device {row['ms'] * 1e3:.1f} us (eager "
          f"{row['eager_ms'] * 1e3:.1f}); bound {b_rg * 1e3:.2f} us "
          f"({by_rg}, {100 * b_rg / row['ms']:.1f} % of it); plain "
          f"{row['plain_ms'] * 1e3:.1f} us; library none; plan "
          f"{plan.vec} lane(s) a thread, block {plan.block}, grid "
          f"{plan.grid}; launches {launches} a prefill")
    return row


def f64_mode(torch):
    """A ``TorchFunctionMode`` under which the port's f32 pins
    (``Tensor.float`` and ``torch.float32`` passed as an argument) give
    f64; ``f32_ops`` names every op that still returned an f32 tensor."""
    class F64(torch.overrides.TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.f32_ops = set()

        def __torch_function__(self, func, types, args=(), kwargs=None):
            def widen(v):
                return torch.float64 if v is torch.float32 else v

            if func is torch.Tensor.float:
                func = torch.Tensor.double
            out = func(*map(widen, args),
                       **{k: widen(v) for k, v in (kwargs or {}).items()})
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                    self.f32_ops.add(getattr(func, "__name__", str(func)))
            return out

    return F64()


def cut_card_vs_cpu(torch, model, params, tokens, steps: int, what: str,
                    impls=("flash", "ref"), k2=None,
                    exact: bool = False, extra=None,
                    f32_caches: bool = False) -> dict:
    """An f32 model on the card against its copy on the CPU: the last
    logits of ``forward`` at each impl (with ``k2``, ``rglru_scan``'s
    launches on the card counted: one a ``rec`` layer at ``"flash"``, none
    at ``"ref"``), then ``steps`` decode steps from zero caches, the logits
    and every cache compared after each: the max abs error of each, and
    the largest magnitude beside it, each within LM_F32_TOL.  With
    ``exact`` the CPU also runs the same weights in f64
    (:func:`f64_mode`), and both f32 runs are read against it: each value
    of the card's, against the CPU's and against f64, is then held at
    COND_MULT times the CPU's own f32 distance from f64, and never under
    LM_F32_TOL.  ``extra`` adds entries to the forward's batch (a
    frontend's stub embeddings); with ``f32_caches`` both devices' caches
    are f32 (:func:`f32_cache`)."""
    v = model.cfg.vocab_size
    cpu_params = tree_to(params, "cpu")
    batch = {"tokens": tokens, **(extra or {})}
    cpu_batch = {k: t.cpu() for k, t in batch.items()}
    n_rec = model.cfg.pattern().count("rec")
    out = {}
    if exact:
        mode = f64_mode(torch)
        params64 = tree_to(cpu_params, torch.float64)

    def note(key, got, want):
        err, mag = max_abs(got, want), float(want.abs().max())
        old = out.get(key, (0.0, 0.0))
        out[key] = (max(old[0], err), max(old[1], mag))

    def note_all(key, card, cpu, f64=None):
        note(key, card, cpu)
        if f64 is not None:
            note(f"{key}_card_vs_f64", card, f64)
            note(f"{key}_cpu_vs_f64", cpu, f64)

    for impl in impls:
        if k2 is not None:
            k2.reset_launches()
        on_card = model.forward(params, batch, impl=impl, last_only=True)
        torch.cuda.synchronize()
        if k2 is not None:
            want = n_rec if impl == "flash" else 0
            check(k2.LAUNCHES["rglru_scan"] == want,
                  f"{what} forward({impl}): {k2.LAUNCHES['rglru_scan']} "
                  f"rglru_scan launches, not {want}")
        on_cpu = model.forward(cpu_params, cpu_batch, impl=impl,
                               last_only=True)
        f64 = None
        if exact:
            with mode:
                f64 = model.forward(params64, cpu_batch, impl=impl,
                                    last_only=True)[..., :v]
        note_all(f"forward_{impl}", on_card.cpu()[..., :v], on_cpu[..., :v],
                 f64)
    card_c = model.init_cache(tokens.shape[0], steps, params=params)
    cpu_c = model.init_cache(tokens.shape[0], steps, params=cpu_params)
    if f32_caches:
        card_c, cpu_c = f32_cache(torch, card_c), f32_cache(torch, cpu_c)
    if exact:
        with mode:
            c64 = model.init_cache(tokens.shape[0], steps, params=params64)
    for t in range(steps):
        lc, _ = model.decode_step(params, tokens[:, t:t + 1], card_c, t)
        lp, _ = model.decode_step(cpu_params, tokens[:, t:t + 1].cpu(),
                                  cpu_c, t)
        l64 = None
        if exact:
            with mode:
                l64 = model.decode_step(params64, tokens[:, t:t + 1].cpu(),
                                        c64, t)[0][..., :v]
        note_all("decode_logits", lc.cpu()[..., :v], lp[..., :v], l64)
        cpu_list = tree_list(cpu_c)
        f64_list = tree_list(c64) if exact else [None] * len(cpu_list)
        for a, c, e in zip(tree_list(card_c), cpu_list, f64_list):
            note_all("decode_caches", a.cpu(), c, e)
    bars = {k: LM_F32_TOL for k in out if not k.endswith("_cpu_vs_f64")}
    if exact:
        check(not mode.f32_ops, f"{what}: the f64 run returned f32 from "
              f"{sorted(mode.f32_ops)}")
        for k in bars:
            base = k.removesuffix("_card_vs_f64")
            bars[k] = max(LM_F32_TOL, COND_MULT * out[f"{base}_cpu_vs_f64"][0])
    print(f"  {what}, card vs CPU (f32): " + ", ".join(
        f"{k} max|err| {e:.2e} (max|x| {m:.3g}"
        + (f", bar {bars[k]:.2e})" if k in bars else ")")
        for k, (e, m) in out.items()) + f"; {steps} decode steps")
    for k, bar in bars.items():
        check(out[k][0] <= bar, f"{what} {k}: {out[k][0]} over {bar}")
    return {k: {"max_abs_err": e, "max_abs": m, "bar": bars.get(k)}
            for k, (e, m) in out.items()}


def f32_cache(torch, caches):
    """The caches with every bf16 k/v buffer in f32.  An f32 model's
    decode writes its k/v into bf16 caches (the reference's layout), and
    a value the card and the CPU compute 1e-6 apart can round to bf16 an
    ulp apart: 7.8e-3 at 4.3 in qwen2.5-32b's f32 cut, which moved the
    next logits by 1.4e-3 (NVIDIA H100 80GB HBM3).  The card-vs-CPU
    decode of an f32 cut with attention keeps them in f32 on both
    devices, as the CPU tests keep an f32 model's caches."""
    return tree_to(caches, torch.float32)


def rec_bf16_floor(torch, cfg, params, token_sets) -> dict:
    """For each token set: the bf16 model's plain prefill (``impl="ref"``,
    last logits) against the same weights cast to f32 (an exact cast),
    by :func:`lm_close` ungated: the elements bf16's own rounding puts past
    LM_BF16_TOL.  The f32 copy (37.6 GB) is freed before returning."""
    import dataclasses

    from repro_torch.models.model import build

    model = build(cfg)
    model32 = build(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_to(params, torch.float32)
    v = cfg.vocab_size
    out = {}
    for key, tokens in token_sets.items():
        want = model32.forward(params32, {"tokens": tokens}, impl="ref",
                               last_only=True)
        got = model.forward(params, {"tokens": tokens}, impl="ref",
                            last_only=True)
        out[key] = lm_close(
            torch, got[..., :v], want[..., :v], LM_BF16_TOL,
            f"bf16's floor {list(tokens.shape)}: impl=ref bf16 vs f32 "
            f"weights", gate=False)
        del want, got
    del params32
    torch.cuda.empty_cache()
    return out


def phase_recurrent_lm(torch, fak, rgk, ref, card, ptxas):
    """Phase 18: recurrentgemma-9b's ``config()`` in bf16 on the card:
    the tree (9,396,408,320 elements), the prefill step at [4, 512] and
    [1, 4096] on K2 and K3 (26 and 12 launches a step) against
    ``impl="ref"``, the serve path
    (``generate``: 128-token prompts, 32 greedy tokens) against the prefill
    step at phase 15's floor, a 2-layer f32 cut card vs CPU, K2 and K3 at
    the prefill's shapes; then mamba2-130m through the serve CLI at
    ``--full``, its prefill step at [4, 512] (no kernel) and f32 copies
    card vs CPU."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build

    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["allocated_at_start"] = torch.cuda.memory_allocated()
    cfg = get_arch(REC_ARCH)
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n, nbytes = tree_bytes(params)
    f32_bytes = sum(t.numel() * 4 for t in tree_list(params)
                    if t.dtype == torch.float32)
    out["build"] = {"seconds": time.perf_counter() - t0, "params": n,
                    "bytes": nbytes, "f32_bytes": f32_bytes,
                    "param_count": cfg.param_count(),
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
    check(n == REC_ELEMENTS, f"{cfg.name}: {n} elements")
    print(f"  built {cfg.name}: {cfg.n_layers} layers {cfg.segments()}, "
          f"{n:,} elements ({cfg.param_count():,} by param_count, which "
          f"leaves the gates' wa/wx out), {nbytes / 1e9:.2f} GB ("
          f"{f32_bytes / 1e9:.2f} GB of it f32) in "
          f"{out['build']['seconds']:.2f} s; allocated before it "
          f"{out['allocated_at_start'] / 1e9:.2f} GB, max "
          f"{out['build']['max_memory_allocated'] / 1e9:.2f} GB  ({card})")
    v = cfg.vocab_size

    # bf16's own rounding floor, read in this run: the plain prefill
    # (impl="ref") in bf16 against the same weights run in f32 (impl="ref":
    # K3 refuses f32 at D = 256).  Two bf16 paths that round apart differ
    # past LM_BF16_TOL in many logits here (the scan's order alone does),
    # so a kernel path is held to have no more elements beyond the bar
    # from the plain path than the plain path has from f32
    token_sets = {"prefill": lm_tokens(torch, cfg, *LM_PREFILL, seed=1),
                  "long_prefill": lm_tokens(torch, cfg, *LM_LONG_PREFILL,
                                            seed=5)}
    floor = rec_bf16_floor(torch, cfg, params, token_sets)
    out["bf16_floor"] = floor

    for key, shape in (("prefill", LM_PREFILL),
                       ("long_prefill", LM_LONG_PREFILL)):
        tokens = token_sets[key]
        logits, out[key] = rec_prefill(torch, fak, rgk, model, params,
                                       tokens, card)
        plain = model.forward(params, {"tokens": tokens}, impl="ref",
                              last_only=True)
        out[key]["flash_vs_ref"] = lm_close(
            torch, logits[..., :v], plain[..., :v], LM_BF16_TOL,
            f"prefill {list(shape)} impl=flash vs impl=ref (bf16)",
            gate=False)
        out[key]["ref_vs_f32"] = floor[key]
        beyond = out[key]["flash_vs_ref"]["beyond"]
        check(beyond <= floor[key]["beyond"],
              f"prefill {shape}: flash vs ref {beyond} elements beyond "
              f"{LM_BF16_TOL}, more than bf16's floor "
              f"{floor[key]['beyond']}")
        check(out[key]["flash_vs_ref"]["argmax_equal"] == shape[0],
              f"prefill {shape}: flash and ref disagree on an argmax")
        del logits, plain, tokens

    del token_sets
    prompts = lm_tokens(torch, cfg, LM_PREFILL[0], LM_PROMPT, seed=2)
    torch.cuda.reset_peak_memory_stats()  # the floor's f32 copy is freed
    gen = generate(model, params, prompts, LM_NEW)
    fwd = model.forward(params, {"tokens": prompts}, impl="flash",
                        last_only=True)
    plain = model.forward(params, {"tokens": prompts}, impl="ref",
                          last_only=True)
    serve = {"batch": LM_PREFILL[0], "prompt": LM_PROMPT, "new": LM_NEW,
             "prefill_scan_s": gen["prefill_s"], "decode_s": gen["decode_s"],
             "tok_per_s": LM_PREFILL[0] * LM_NEW / gen["decode_s"],
             "decode_step_ms": gen["decode_s"] / LM_NEW * 1e3,
             "prefill_scan_step_ms": gen["prefill_s"] / LM_PROMPT * 1e3,
             "max_memory_allocated": torch.cuda.max_memory_allocated()}
    check(tuple(gen["tokens"].shape) == (LM_PREFILL[0], LM_NEW) and bool(
        ((gen["tokens"] >= 0) & (gen["tokens"] < v)).all()), "greedy tokens")
    for key, want, what in (("scan_vs_forward_ref", plain, "ref"),
                            ("scan_vs_forward", fwd, "flash")):
        serve[key] = lm_close(
            torch, gen["prefill_logits"][..., :v], want[..., :v],
            LM_BF16_TOL, f"prefill_scan last logits vs forward({what}, "
            f"last_only) (bf16)", gate=False)
        check(serve[key]["argmax_equal"] == LM_PREFILL[0],
              f"prefill_scan and forward({what}) disagree on an argmax")
    # phase 15's floor: the scan no further from the prefill step than
    # from the plain prefill
    beyond = serve["scan_vs_forward"]["beyond"]
    check(beyond <= serve["scan_vs_forward_ref"]["beyond"],
          f"prefill_scan vs forward(flash): {beyond} elements beyond "
          f"{LM_BF16_TOL}, more than the plain prefill's "
          f"{serve['scan_vs_forward_ref']['beyond']}")
    last = LM_PROMPT + LM_NEW - 1
    wall, device, busy_ms, _ = lm_profiled(torch, lambda: model.decode_step(
        params, gen["tokens"][:, -1:], gen["caches"], last))
    serve["decode_profile"] = {"wall_ms": wall, "device_busy_ms": busy_ms,
                               "device_busy_share": busy_ms / wall,
                               "device_ops": len(device)}
    out["serve"] = serve
    print(f"  serve path: prefill_scan of {LM_PROMPT} tokens x "
          f"{LM_PREFILL[0]} in {gen['prefill_s']:.3f} s "
          f"({serve['prefill_scan_step_ms']:.2f} ms a step); {LM_NEW} "
          f"greedy tokens in {gen['decode_s']:.3f} s "
          f"({serve['decode_step_ms']:.2f} ms a step, "
          f"{serve['tok_per_s']:.1f} tok/s); one profiled decode step "
          f"{wall:.2f} ms, busy {busy_ms:.2f} ms (share "
          f"{busy_ms / wall:.3f}, {len(device)} ops); max allocated "
          f"{serve['max_memory_allocated'] / 1e9:.2f} GB  ({card})")
    del params, gen, fwd, plain, prompts
    torch.cuda.empty_cache()

    small = build(dataclasses.replace(cfg, n_layers=REC_CUT,
                                      dtype="float32"))
    check(small.cfg.segments() == ((("rec", "rec"), 1),),
          f"the f32 cut's segments {small.cfg.segments()}")
    params = small.init(0, device="cuda")
    toks = lm_tokens(torch, cfg, *REC_CUT_TOKENS, seed=4)
    out["card_vs_cpu_2layer_f32"] = cut_card_vs_cpu(
        torch, small, params, toks, REC_DECODE_STEPS,
        f"{cfg.name} cut to {REC_CUT} rec layers [{REC_CUT_TOKENS[0]}, "
        f"{REC_CUT_TOKENS[1]}]", k2=rgk)
    del params, toks
    torch.cuda.empty_cache()

    rows = [check_rec_scan(torch, rgk, ref, name, case,
                           out[key]["launches"]["rglru_scan"],
                           ptxas["rglru_scan"])
            for name, case, key in REC_K2_CASES]
    rows += [check_lm_kernel(torch, fak, ref, name, case, window,
                             out[key]["launches"]["flash_attention"],
                             ptxas["flash_attention_mma"])
             for name, case, window, key in REC_FA_CASES]
    for row in rows:
        if row["library_ms"] is not None:
            row["sdpa_ratio"] = row["ms"] / row["library_ms"]
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    rgk.reset_launches()
    fak.reset_launches()
    cli = serve_cli.main(["--arch", SSD_ARCH, "--full"])
    torch.cuda.synchronize()
    ssd_cfg = get_arch(SSD_ARCH)
    toks = cli["tokens"]
    first = cli["prefill_logits"][:, 0, :ssd_cfg.vocab_size].argmax(-1)
    check(tuple(toks.shape) == (4, 32) and bool(
        ((toks >= 0) & (toks < ssd_cfg.vocab_size)).all())
        and torch.equal(toks[:, 0], first), "mamba2 CLI tokens")
    check(rgk.LAUNCHES["rglru_scan"] == fak.LAUNCHES["flash_attention"] == 0,
          "the mamba2 serve CLI launched a kernel")
    ssd = {"cli": {"prefill_s": cli["prefill_s"], "decode_s": cli["decode_s"],
                   "tok_per_s": cli["tok_per_s"],
                   "decode_step_ms": cli["decode_s"] / 32 * 1e3,
                   "prefill_scan_step_ms": cli["prefill_s"] / 16 * 1e3,
                   "max_memory_allocated": torch.cuda.max_memory_allocated()}}
    print(f"  {ssd_cfg.name} serve CLI --full (B 4, 16-token prompts, 32 "
          f"tokens): prefill_scan {cli['prefill_s']:.3f} s "
          f"({ssd['cli']['prefill_scan_step_ms']:.2f} ms a step), decode "
          f"{ssd['cli']['decode_step_ms']:.2f} ms a step, "
          f"{cli['tok_per_s']:.1f} tok/s, max allocated "
          f"{ssd['cli']['max_memory_allocated'] / 1e9:.3f} GB; no kernel "
          f"launched  ({card})")
    model = build(ssd_cfg)
    params = model.init(0, device="cuda")
    n, nbytes = tree_bytes(params)
    check(n == SSD_ELEMENTS, f"{ssd_cfg.name}: {n} elements")
    tokens = lm_tokens(torch, ssd_cfg, *SSD_PREFILL, seed=6)

    def step():
        return model.forward(params, {"tokens": tokens}, impl="flash",
                             last_only=True)

    rgk.reset_launches()
    fak.reset_launches()
    logits = step()
    torch.cuda.synchronize()
    check(rgk.LAUNCHES["rglru_scan"] == fak.LAUNCHES["flash_attention"] == 0,
          "mamba2's prefill launched a kernel")
    check(bool(torch.isfinite(logits[..., :ssd_cfg.vocab_size]).all()),
          "non-finite mamba2 prefill logits")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof_wall, device, busy_ms, _ = lm_profiled(torch, step)
    ssd["params"], ssd["bytes"] = n, nbytes
    ssd["prefill"] = {"warm_wall_ms": walls,
                      "warm_wall_ms_median": statistics.median(walls),
                      "profiled_wall_ms": prof_wall,
                      "device_busy_ms": busy_ms,
                      "device_busy_share": busy_ms / prof_wall,
                      "device_ops": len(device)}
    print(f"  {ssd_cfg.name}: {n:,} elements, {nbytes / 1e9:.3f} GB bf16; "
          f"prefill {list(SSD_PREFILL)} warm wall "
          f"{ssd['prefill']['warm_wall_ms_median']:.2f} ms "
          f"({', '.join(f'{w:.2f}' for w in walls)}); profiled "
          f"{prof_wall:.2f} ms, busy {busy_ms:.2f} ms (share "
          f"{busy_ms / prof_wall:.3f}, {len(device)} ops)  ({card})")
    del params, logits, tokens
    torch.cuda.empty_cache()
    # an f32 copy at full width: at SSD_CUT layers within 1e-4, as the
    # other f32 cuts; at full depth against an f64 run as well, at the bar
    # that run sets (the chunk scan's segment sums are differences of
    # cumsums that reach ~1e3 over a chunk, ~1e-4 of the decay in f32)
    toks = lm_tokens(torch, ssd_cfg, *LM_CARD_CPU, seed=7)
    for layers, exact in ((SSD_CUT, False), (ssd_cfg.n_layers, True)):
        small = build(dataclasses.replace(ssd_cfg, n_layers=layers,
                                          dtype="float32"))
        params = small.init(0, device="cuda")
        ssd[f"card_vs_cpu_f32_{layers}_layers"] = cut_card_vs_cpu(
            torch, small, params, toks, REC_DECODE_STEPS,
            f"{ssd_cfg.name} in f32 at {layers} layers [{LM_CARD_CPU[0]}, "
            f"{LM_CARD_CPU[1]}]", impls=("ref",), exact=exact)
        del params
        torch.cuda.empty_cache()
    del toks
    out["mamba2"] = ssd
    return out, rows


# phase 19: the remaining one-card model families at full width in bf16:
# qwen2.5-32b whole (64 dense attn layers, QKV bias, 40 | 8 heads of 128),
# phi3.5-moe cut to 16 of its 32 layers (16 experts, top-2; both
# dispatches), qwen2-vl-72b cut to 16 of its 80 layers (1,024 stub patch
# embeddings before the text, M-RoPE positions, 64 | 8 heads of 128) and
# seamless-m4t-large-v2 whole (24 + 24 encoder-decoder layers on 1,024
# stub frame embeddings; no kernel, as the reference's encoder-decoder)
FAM_QWEN, FAM_MOE, FAM_VL, FAM_ED = ("qwen2p5_32b", "phi3p5_moe_42b",
                                     "qwen2_vl_72b", "seamless_m4t_large_v2")
# and the two whose whole weights need several cards (245 and 789 GB in
# bf16), at full width cut in depth: mistral-large-123b (dense, 96 | 8
# heads of 128, a GQA group of 12) to 16 of its 88 layers and
# llama4-maverick-400b to 2 of its 48, one ("attn", "moe") pair (128
# experts of d_ff 8192, top-1, capacity factor 1.25: 5 slots an expert a
# sequence of 512)
FAM_MISTRAL, FAM_LLAMA4 = "mistral_large_123b", "llama4_maverick_400b"
# lm_param_shapes' elements (the reference's, at each depth run here)
FAM_ELEMENTS = {FAM_QWEN: 32_763_876_352, FAM_MOE: 21_069_172_736,
                FAM_VL: 16_534_380_544, FAM_ED: 1_632_233_472,
                FAM_MISTRAL: 22_951_636_992, FAM_LLAMA4: 18_429_404_160}
# depth cuts (32, 80, 88 and 48 layers published)
FAM_LAYERS = {FAM_MOE: 16, FAM_VL: 16, FAM_MISTRAL: 16, FAM_LLAMA4: 2}
FAM_K3 = {FAM_QWEN: 64, FAM_MOE: 16, FAM_VL: 16, FAM_ED: 0,
          FAM_MISTRAL: 16, FAM_LLAMA4: 2}
# llama4's f32 card-vs-CPU check: its ("attn", "moe") pair at full width
# with the experts cut 128 -> 8 (one f32 moe layer of 128 experts is 64
# GB); a check only, in no table of configurations
LLAMA4_CHECK_EXPERTS = 8
# the f32 walk casts a moe layer's experts this many at a time
FAM_EXPERT_CHUNK = 16
VL_PREFILL = (2, 1024, 512)    # B, stub patches, text tokens
ED_PREFILL = (4, 1024, 128)    # B, stub frames, teacher-forced tokens
FAM_CUT = 2                    # layers of each f32 cut (encoder: 2 + 2)
FAM_CUT_TOKENS = (2, 128)      # B, S of the f32 cuts' forward
FAM_CUT_FRONT = 64             # the f32 cuts' patches / frames
FAM_CUT_STEPS = 4              # decode steps card vs CPU of each f32 cut
MOE_IMPLS = ("einsum", "scatter")
# two bf16 paths each no further from the f32 result than the plain bf16
# prefill (the floor read in the run) lie at most twice that apart
FLOOR_MULT = 2.0
# K3 at the new prefill shapes (phi3.5-moe's is granite's shape: its 16
# launches go on phase 15's row; llama4's is qwen2.5's: its 2 on that row)
FAM_FA_CASES = (
    ("flash_attention_lm_qwen2p5", (4, 512, 40, 8, 128), None, FAM_QWEN),
    ("flash_attention_lm_qwen2_vl", (2, 1536, 64, 8, 128), None, FAM_VL),
    ("flash_attention_lm_mistral", (4, 512, 96, 8, 128), None, FAM_MISTRAL))


class RoutingSpy:
    """Records the router's softmax gates [b, s, e] and the top-k expert
    choices of every ``moe`` block call (``models/moe.py`` ``_choose``,
    which both dispatches call) while entered, in call order, on the
    host.  Given ``replay`` (another run's ``choices``), each call takes
    that run's experts in place of its own argmaxes: its gates, and so its
    gate values and aux loss, are its own; its dispatch, capacity drops
    and queue positions follow the replayed choices.  Two runs that round
    apart then route alike, and differ by their rounding alone."""

    def __init__(self, replay=None):
        from repro_torch.models import moe
        self.moe, self.replay = moe, replay
        self.gates, self.choices = [], []

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        choose, replay = self.moe._choose, iter(self.replay or ())

        def spy(router_w, x, cfg):
            if self.replay is None:
                out = choose(router_w, x, cfg)
            else:
                gates = torch.softmax(torch.einsum(
                    "bsd,de->bse", x.float(), router_w), dim=-1)
                idxs = [i.to(gates.device) for i in next(replay)]
                masks = [F.one_hot(i, cfg.n_experts).float() for i in idxs]
                gvals = [torch.sum(gates * m, dim=-1) for m in masks]
                aux = cfg.n_experts * torch.sum(
                    torch.mean(masks[0], dim=(0, 1)) *
                    torch.mean(gates, dim=(0, 1))) * cfg.router_aux_coef
                out = gates, idxs, masks, gvals, aux
            self.gates.append(out[0].detach().float().cpu())
            self.choices.append([i.detach().cpu() for i in out[1]])
            return out

        self.choose, self.moe._choose = choose, spy
        return self

    def __exit__(self, *exc):
        self.moe._choose = self.choose


def routing_compare(torch, a, b, k: int) -> dict:
    """Two runs' top-``k`` expert sets, call by call: the share of (token,
    call) sets that agree, each batch row's first position where a set
    differs in any call (S where none), and each flip's gate margin (the
    smaller of the two runs' gaps between their k-th and (k+1)-th gate)
    beside the two runs' gate gap at that token (the largest difference of
    a gate).  A flip is accepted only where its margin is within that
    gap: the runs' gates order the experts apart."""
    check(len(a) == len(b) > 0, f"routing calls {len(a)} and {len(b)}")
    bsz, s, _ = a[0].shape
    first = [s] * bsz
    agree = total = 0
    flips = []
    for ga, gb in zip(a, b):
        sa, ia = ga.sort(dim=-1, descending=True, stable=True)
        sb, ib = gb.sort(dim=-1, descending=True, stable=True)
        same = (ia[..., :k].sort(-1).values ==
                ib[..., :k].sort(-1).values).all(-1)
        agree += int(same.sum())
        total += same.numel()
        for r, p in (~same).nonzero().tolist():
            first[r] = min(first[r], p)
            margin = min(float(sa[r, p, k - 1] - sa[r, p, k]),
                         float(sb[r, p, k - 1] - sb[r, p, k]))
            gap = float((ga[r, p] - gb[r, p]).abs().max())
            flips.append((margin, gap))
    out = {"share": agree / total, "flips": len(flips), "first": first,
           "s": s, "k": k,
           "rows_without_flip": sum(f == s for f in first),
           "min_flip_margin": min((m for m, _ in flips), default=None),
           "gap_at_min_margin": min(flips)[1] if flips else None}
    for margin, gap in flips:
        check(margin <= gap, f"a routing flip at margin {margin} over the "
              f"runs' gate gap {gap}")
    return out


def routing_line(what: str, r: dict) -> str:
    extra = (f", least flip margin {r['min_flip_margin']:.3e} (gate gap "
             f"{r['gap_at_min_margin']:.3e})" if r["flips"] else "")
    return (f"  {what}: top-{r['k']} sets agree {100 * r['share']:.3f} %, "
            f"{r['flips']} flips{extra}; rows without a flip "
            f"{r['rows_without_flip']}/{len(r['first'])}")


def fam_build(torch, arch: str, card) -> tuple:
    """The model and its params on the card from seed 0, after printing
    what is allocated; the element count held to the reference's."""
    from repro_torch.models.model import build

    cfg = get_cfg(arch)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n, nbytes = tree_bytes(params)
    want = FAM_ELEMENTS[arch]
    out = {"allocated_before": before, "seconds": time.perf_counter() - t0,
           "elements": n, "reference_elements": want, "bytes": nbytes,
           "n_layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
           "param_count": cfg.param_count(),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print(f"  built {cfg.name}: {cfg.n_layers} layers"
          + (f" + {cfg.enc_layers} encoder layers" if cfg.enc_layers else "")
          + f", d_model {cfg.d_model}, {n:,} elements (the reference's "
          f"{want:,}; param_count {cfg.param_count():,}), "
          f"{nbytes / 1e9:.2f} GB in {out['seconds']:.2f} s; allocated "
          f"before it {before / 1e9:.2f} GB, max "
          f"{out['max_memory_allocated'] / 1e9:.2f} GB  ({card})")
    check(n == want, f"{cfg.name}: {n} elements, the reference's {want}")
    return model, params, out


def get_cfg(arch: str):
    """The architecture's ``config()`` at the depth phase 19 runs."""
    import dataclasses

    from repro_torch.configs.base import get_arch

    cfg = get_arch(arch)
    if arch in FAM_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FAM_LAYERS[arch])
    return cfg


def fam_batch(torch, cfg, b: int, s: int, n_front: int, seed: int) -> dict:
    """Tokens [b, s] and, where the config has a frontend, ``n_front``
    stub embeddings [b, n_front, d] in the model's dtype, drawn from
    ``seed`` on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device="cuda")}
    if n_front:
        batch["frontend"] = torch.randn(
            b, n_front, cfg.d_model, generator=gen, device="cuda").to(
            getattr(torch, cfg.dtype))
    return batch


def fam_prefill(torch, fak, model, params, batch, card, what: str,
                k3: int):
    """A prefill step (``forward(impl="flash", last_only=True)``): K3's
    count set to 0 just before the main-path call and read just after
    (``k3`` launches); three warm calls by the host clock, counted again;
    one profiled call (busy share, device ms by kind, K3's calls)."""

    def step():
        return model.forward(params, batch, impl="flash", last_only=True)

    fak.reset_launches()
    logits = step()
    torch.cuda.synchronize()
    launches = fak.LAUNCHES["flash_attention"]
    check(launches == k3, f"{what}: {launches} flash_attention launches, "
          f"not {k3}")
    check(bool(torch.isfinite(logits[..., :model.cfg.vocab_size]).all()),
          f"{what}: non-finite logits")
    walls = []
    for _ in range(3):
        fak.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(fak.LAUNCHES["flash_attention"] == k3,
              f"{what}: launches of a warm prefill")
    prof_wall, device, busy_ms, by_kernel = lm_profiled(torch, step)
    kinds = device_by_kind(by_kernel)
    check(kinds["K3"][0] == k3, f"{what}: {kinds['K3'][0]} K3 kernel calls "
          f"in a profiled prefill, not {k3}")
    warm = statistics.median(walls)
    out = {"launches": launches, "warm_wall_ms": walls,
           "warm_wall_ms_median": warm, "profiled_wall_ms": prof_wall,
           "device_busy_ms": busy_ms, "device_busy_share": busy_ms / prof_wall,
           "device_ops": len(device),
           "device_ms_by_kind": {k: {"calls": n, "ms": t}
                                 for k, (n, t) in kinds.items()},
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print(f"  {what}: {launches} flash_attention launches a call; warm wall "
          f"{warm:.2f} ms ({', '.join(f'{w:.2f}' for w in walls)}); "
          f"profiled {prof_wall:.2f} ms, device busy {busy_ms:.2f} ms "
          f"(share {busy_ms / prof_wall:.3f}, {len(device)} ops); max "
          f"allocated {out['max_memory_allocated'] / 1e9:.2f} GB  ({card})")
    for kind, (n, t) in kinds.items():
        if n:
            print(f"    device {kind}: {n} calls, {t:.3f} ms "
                  f"({100 * t / busy_ms:.1f} % of busy)")
    return logits, out


def f32_walk(torch, model, params, batch, last_only: bool = True):
    """The plain prefill's (``impl="ref"``) logits (the last position's, or
    every one) of the bf16 params run in f32, one layer cast to f32 at a
    time (an exact cast; a moe layer's experts FAM_EXPERT_CHUNK at a time:
    llama4's 128 in f32 are 64 GB), so no f32 copy of the model is held:
    bf16's own rounding is what the bf16 run adds to it."""
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    from repro_torch.models import moe as M

    cfg = model.cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    x = L.embed(params["embed"], batch["tokens"]).float()
    if "frontend" in batch:
        x = torch.cat([batch["frontend"].float(), x], dim=1)
    pos = model._vlm_positions(batch)
    if pos is None:
        b, s = x.shape[:2]
        pos = T._positions(cfg, torch.arange(
            s, dtype=torch.int32, device=x.device).expand(b, s))
    experts = M._experts_forward

    def experts_by_chunk(p, xe, cfg_):
        """The experts' products with their bf16 weights cast to f32
        FAM_EXPERT_CHUNK experts at a time (each expert's product is its
        own: the same math as the whole cast)."""
        out = torch.empty_like(xe)
        for e0 in range(0, xe.shape[0], FAM_EXPERT_CHUNK):
            e1 = e0 + FAM_EXPERT_CHUNK
            out[e0:e1] = experts({k: p[k][e0:e1].float() for k in
                                  ("wi", "wg", "wo") if k in p},
                                 xe[e0:e1], cfg_)
        return out

    M._experts_forward = experts_by_chunk
    try:
        for si, (kinds, reps) in enumerate(cfg.segments()):
            for r in range(reps):
                layer = {}
                for bk, blk in T._index(params["stack"][si], r).items():
                    layer[bk] = tree_to({k: v for k, v in blk.items()
                                         if k != "moe"}, torch.float32)
                    if "moe" in blk:  # the experts stay bf16 here
                        layer[bk]["moe"] = {k: v if k in ("wi", "wg", "wo")
                                            else v.float()
                                            for k, v in blk["moe"].items()}
                for i, kind in enumerate(kinds):
                    x, _, _ = T.apply_block(layer[f"b{i}"], kind, x, pos,
                                            cfg32, mode="prefill",
                                            impl="ref")
                del layer
    finally:
        M._experts_forward = experts
    head = {k: tree_to(params[k], torch.float32)
            for k in ("final_ln", "head", "embed") if k in params}
    return T.lm_logits(head, cfg32, x[:, -1:] if last_only else x)


def fam_floor(torch, model, params, batch, what: str) -> tuple:
    """bf16's floor read in the run: the plain prefill's last logits
    (``impl="ref"``) against the same weights run in f32
    (:func:`f32_walk`).  Returns (the plain logits, the :func:`lm_close`
    record of the pair)."""
    v = model.cfg.vocab_size
    plain = model.forward(params, batch, impl="ref", last_only=True)
    f32 = f32_walk(torch, model, params, batch)
    floor = lm_close(torch, plain[..., :v], f32[..., :v], LM_BF16_TOL,
                     f"{what}: bf16's floor, impl=ref bf16 vs the f32 walk",
                     gate=False)
    return plain, floor


def at_floor(torch, got, want, floor: dict, what: str,
             ties: bool = False) -> dict:
    """``got`` against ``want`` (both bf16 paths' last logits) at bf16's
    floor: no element further apart than FLOOR_MULT times the plain path's
    largest distance from f32 (``floor``: two paths each as close to exact
    as the plain one lie at most twice that apart), and every argmax
    equal; with ``ties``, every argmax of a row whose top-2 logits lie
    further apart than twice the pair's largest difference (a closer pair
    may reorder within it).  The count past LM_BF16_TOL is recorded beside
    the floor's."""
    out = lm_close(torch, got, want, LM_BF16_TOL, what, gate=False)
    bar, err = FLOOR_MULT * floor["max_abs_err"], out["max_abs_err"]
    eq = got.argmax(-1) == want.argmax(-1)
    if ties:
        top2 = want.topk(2, dim=-1).values
        eq |= top2[..., 0] - top2[..., 1] <= 2 * err
    out.update({"floor_bar": bar, "floor_beyond": floor["beyond"]})
    print(f"    max|err| {err:.3e} against the floor's bar {bar:.3e} "
          f"({FLOOR_MULT:g} x {floor['max_abs_err']:.3e}); {out['beyond']} "
          f"beyond {LM_BF16_TOL} (the floor's {floor['beyond']})")
    check(err <= bar, f"{what}: {err} past bf16's floor {bar}")
    check(bool(eq.all()), f"{what}: an argmax differs")
    return out


def fam_flash_vs_ref(torch, model, params, batch, flash, what: str) -> dict:
    """The prefill step on K3 against the plain prefill (``impl="ref"``)
    at bf16's floor (:func:`at_floor`)."""
    v = model.cfg.vocab_size
    plain, floor = fam_floor(torch, model, params, batch, what)
    return {"ref_vs_f32": floor, "flash_vs_ref": at_floor(
        torch, flash[..., :v], plain[..., :v], floor,
        f"{what}: impl=flash vs impl=ref (bf16)")}


def moe_checks(torch, model, params, batch, last, spies, what: str) -> dict:
    """phi3.5-moe's prefill in bf16 on both dispatches.  Left to route
    freely, 16 layers of top-2 routing turn bf16's rounding into routing
    flips (each within the runs' gate gap, :func:`routing_compare`) that
    move every later position of the row: K3's prefill (``last["einsum"]``)
    against the plain one, and the scatter dispatch against the einsum
    one, are recorded so.  Then each is held at bf16's floor
    (:func:`at_floor`, every row) with every run replaying the einsum
    prefill's expert choices (:class:`RoutingSpy`): the plain prefill,
    the same weights walked in f32 (the floor), the scatter dispatch."""
    from repro_torch.models import transformer as T

    v, k = model.cfg.vocab_size, model.cfg.experts_per_token
    with RoutingSpy() as free_ref:
        model.forward(params, batch, impl="ref", last_only=True)
    out = {"routing_flash_vs_ref": routing_compare(
        torch, free_ref.gates, spies["einsum"].gates, k),
        "routing_scatter_vs_einsum": routing_compare(
        torch, spies["einsum"].gates, spies["scatter"].gates, k)}
    for key in ("routing_flash_vs_ref", "routing_scatter_vs_einsum"):
        print(routing_line(f"{what}: {key[8:]}, routed freely", out[key]))
    replay = spies["einsum"].choices
    with RoutingSpy(replay):
        plain = model.forward(params, batch, impl="ref", last_only=True)
    with RoutingSpy(replay):
        f32 = f32_walk(torch, model, params, batch)
    floor = lm_close(torch, plain[..., :v], f32[..., :v], LM_BF16_TOL,
                     f"{what}: bf16's floor, impl=ref bf16 vs the f32 walk "
                     "(routing replayed)", gate=False)
    out["ref_vs_f32"] = floor
    out["flash_vs_ref"] = at_floor(
        torch, last["einsum"][..., :v], plain[..., :v], floor,
        f"{what}: impl=flash vs impl=ref (bf16, routing replayed)")
    try:
        T.MOE_IMPL[0] = "scatter"
        with RoutingSpy(replay):
            scatter = model.forward(params, batch, impl="flash",
                                    last_only=True)
    finally:
        T.MOE_IMPL[0] = "einsum"
    # the dispatches round the combine apart (one bf16 rounding of a
    # two-term sum, against three): a row whose top-2 logits lie closer
    # than that difference may reorder (on an H100 80GB HBM3, one row of
    # four: a gap of 0.061 under a difference of 0.211)
    out["scatter_vs_einsum"] = at_floor(
        torch, scatter[..., :v], last["einsum"][..., :v], floor,
        f"{what}: scatter vs einsum dispatch (bf16, routing replayed)",
        ties=True)
    return out


def fam_serve(torch, model, params, card, what: str,
              forward_floor: bool) -> dict:
    """The serve path (``generate``: 128-token prompts at B = 4, 32 greedy
    tokens): ms a prefill_scan step and a decode step, tok/s, peak, one
    profiled decode step.  With ``forward_floor`` (where the text-only
    prefill step computes the scan's math: not a MoE, whose prefill step
    drops tokens past an expert's capacity that a one-token step never
    does) its last prefill logits against the prefill step's and the
    plain prefill's at bf16's floor at the prompts (:func:`at_floor`)."""
    from repro_torch.launch.serve import generate

    v = model.cfg.vocab_size
    prompts = lm_tokens(torch, model.cfg, LM_PREFILL[0], LM_PROMPT, seed=2)
    torch.cuda.reset_peak_memory_stats()
    gen = generate(model, params, prompts, LM_NEW)
    serve = {"batch": LM_PREFILL[0], "prompt": LM_PROMPT, "new": LM_NEW,
             "prefill_scan_s": gen["prefill_s"], "decode_s": gen["decode_s"],
             "tok_per_s": LM_PREFILL[0] * LM_NEW / gen["decode_s"],
             "decode_step_ms": gen["decode_s"] / LM_NEW * 1e3,
             "prefill_scan_step_ms": gen["prefill_s"] / LM_PROMPT * 1e3,
             "max_memory_allocated": torch.cuda.max_memory_allocated()}
    check(tuple(gen["tokens"].shape) == (LM_PREFILL[0], LM_NEW) and bool(
        ((gen["tokens"] >= 0) & (gen["tokens"] < v)).all()),
        f"{what}: greedy tokens")
    check(bool(torch.isfinite(gen["prefill_logits"][..., :v]).all()),
          f"{what}: non-finite prefill_scan logits")
    if forward_floor:
        batch = {"tokens": prompts}
        plain, serve["ref_vs_f32"] = fam_floor(
            torch, model, params, batch, f"{what} prompts")
        flash = model.forward(params, batch, impl="flash", last_only=True)
        for key, want, impl in (("scan_vs_forward_ref", plain, "ref"),
                                ("scan_vs_forward", flash, "flash")):
            serve[key] = at_floor(
                torch, gen["prefill_logits"][..., :v], want[..., :v],
                serve["ref_vs_f32"], f"{what}: prefill_scan last logits vs "
                f"forward({impl}, last_only) (bf16)")
        del plain, flash
    last = LM_PROMPT + LM_NEW - 1
    wall, device, busy_ms, _ = lm_profiled(torch, lambda: model.decode_step(
        params, gen["tokens"][:, -1:], gen["caches"], last))
    serve["decode_profile"] = {"wall_ms": wall, "device_busy_ms": busy_ms,
                               "device_busy_share": busy_ms / wall,
                               "device_ops": len(device)}
    print(f"  {what} serve path: prefill_scan of {LM_PROMPT} tokens x "
          f"{LM_PREFILL[0]} in {gen['prefill_s']:.3f} s "
          f"({serve['prefill_scan_step_ms']:.2f} ms a step); {LM_NEW} greedy "
          f"tokens in {gen['decode_s']:.3f} s ({serve['decode_step_ms']:.2f} "
          f"ms a step, {serve['tok_per_s']:.1f} tok/s); one profiled decode "
          f"step {wall:.2f} ms, busy {busy_ms:.2f} ms (share "
          f"{busy_ms / wall:.3f}, {len(device)} ops); max allocated "
          f"{serve['max_memory_allocated'] / 1e9:.2f} GB  ({card})")
    del gen
    return serve


def fam_cut(torch, arch: str, what: str, extra_front: int = 0,
            impls=("flash", "ref")) -> dict:
    """The architecture's f32 cut (FAM_CUT layers at full width; the
    encoder-decoder's encoder cut alike) on the card against its copy on
    the CPU (:func:`cut_card_vs_cpu`, with ``extra_front`` stub patches or
    frames in the forward)."""
    import dataclasses

    from repro_torch.models.model import build

    cfg = get_cfg(arch)
    cut = dataclasses.replace(cfg, n_layers=FAM_CUT, dtype="float32",
                              enc_layers=FAM_CUT if cfg.enc_layers else 0)
    model = build(cut)
    params = model.init(0, device="cuda")
    batch = fam_batch(torch, cut, *FAM_CUT_TOKENS, extra_front, seed=4)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    out = cut_card_vs_cpu(torch, model, params, batch["tokens"],
                          FAM_CUT_STEPS, what, impls=impls, extra=extra,
                          f32_caches=True)
    del params
    torch.cuda.empty_cache()
    return out


def moe_cut(torch, arch: str, what: str, **cut) -> dict:
    """A MoE's f32 cut (FAM_CUT layers at full width, with ``cut``'s
    fields replaced) on the card against the CPU on both dispatches: the
    forward's last logits (K3's f32 row kernel on the card), then
    FAM_CUT_STEPS decode steps with their caches; a row is held within
    LM_F32_TOL until the two devices route one of its tokens apart, each
    such flip within the runs' gate gap (:func:`routing_compare`)."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.models.model import build

    cfg = dataclasses.replace(get_cfg(arch), n_layers=FAM_CUT,
                              dtype="float32", **cut)
    model = build(cfg)
    params = model.init(0, device="cuda")
    cpu_params = tree_to(params, "cpu")
    tokens = lm_tokens(torch, cfg, *FAM_CUT_TOKENS, seed=4)
    v, k = cfg.vocab_size, cfg.experts_per_token
    out = {"elements": tree_bytes(params)[0], "n_experts": cfg.n_experts}
    try:
        for impl in MOE_IMPLS:
            T.MOE_IMPL[0] = impl
            with RoutingSpy() as a:
                card_l = model.forward(params, {"tokens": tokens},
                                       impl="flash", last_only=True).cpu()
            with RoutingSpy() as b:
                cpu_l = model.forward(cpu_params, {"tokens": tokens.cpu()},
                                      impl="flash", last_only=True)
            r = routing_compare(torch, a.gates, b.gates, k)
            rows = [i for i, f in enumerate(r["first"]) if f == r["s"]]
            err = max_abs(card_l[rows, :, :v], cpu_l[rows, :, :v]) \
                if rows else 0.0
            out[f"forward_{impl}"] = {"max_abs_err": err, "rows": len(rows),
                                      "routing": r}
            print(routing_line(f"{what} forward ({impl}), card vs CPU", r))
    finally:
        T.MOE_IMPL[0] = "einsum"
    b = tokens.shape[0]
    card_c = f32_cache(torch, model.init_cache(b, FAM_CUT_STEPS,
                                               params=params))
    cpu_c = f32_cache(torch, model.init_cache(b, FAM_CUT_STEPS,
                                              params=cpu_params))
    rows = list(range(b))
    dec = {"logits": 0.0, "caches": 0.0}
    for t in range(FAM_CUT_STEPS):
        with RoutingSpy() as a:
            lc, _ = model.decode_step(params, tokens[:, t:t + 1], card_c, t)
        with RoutingSpy() as bb:
            lp, _ = model.decode_step(cpu_params, tokens[:, t:t + 1].cpu(),
                                      cpu_c, t)
        r = routing_compare(torch, a.gates, bb.gates, k)
        rows = [i for i in rows if r["first"][i] == 1]
        if not rows:
            break
        dec["logits"] = max(dec["logits"], max_abs(lc.cpu()[rows, :, :v],
                                                   lp[rows, :, :v]))
        for x, y in zip(tree_list(card_c), tree_list(cpu_c)):
            dec["caches"] = max(dec["caches"], max_abs(x.cpu()[:, rows],
                                                       y[:, rows]))
    dec["rows_held"] = len(rows)
    out["decode"] = dec
    print(f"  {what}, card vs CPU (f32): " + ", ".join(
        f"forward_{i} max|err| {out[f'forward_{i}']['max_abs_err']:.2e} "
        f"over {out[f'forward_{i}']['rows']} rows" for i in MOE_IMPLS)
        + f"; {FAM_CUT_STEPS} decode steps: logits {dec['logits']:.2e}, "
        f"caches {dec['caches']:.2e} over {len(rows)} rows (tolerance "
        f"{LM_F32_TOL})")
    for i in MOE_IMPLS:
        check(out[f"forward_{i}"]["rows"] > 0 and
              out[f"forward_{i}"]["max_abs_err"] <= LM_F32_TOL,
              f"{what} forward ({i}) card vs CPU: {out[f'forward_{i}']}")
    check(rows and dec["logits"] <= LM_F32_TOL and
          dec["caches"] <= LM_F32_TOL, f"{what} decode card vs CPU: {dec}")
    del params, cpu_params, card_c, cpu_c
    torch.cuda.empty_cache()
    return out


def fam_dense(torch, fak, arch: str, card, long_prefill: bool = False):
    """A dense family at its depth in bf16: the build, the prefill step at
    [4, 512] on K3 (FAM_K3 launches) against ``impl="ref"`` at bf16's
    floor, with ``long_prefill`` the step at [1, 4096] too, the serve path
    at B = 4 against both prefills, then the f32 cut card vs CPU."""
    t0 = time.perf_counter()
    model, params, info = fam_build(torch, arch, card)
    name = model.cfg.name
    q = {"build": info}
    batch = fam_batch(torch, model.cfg, *LM_PREFILL, 0, seed=1)
    logits, q["prefill"] = fam_prefill(
        torch, fak, model, params, batch, card,
        f"{name} prefill {list(LM_PREFILL)}", FAM_K3[arch])
    q["prefill"].update(fam_flash_vs_ref(torch, model, params, batch, logits,
                                         f"{name} {list(LM_PREFILL)}"))
    del logits, batch
    if long_prefill:
        torch.cuda.reset_peak_memory_stats()
        batch = fam_batch(torch, model.cfg, *LM_LONG_PREFILL, 0, seed=5)
        _, q["long_prefill"] = fam_prefill(
            torch, fak, model, params, batch, card,
            f"{name} prefill {list(LM_LONG_PREFILL)}", FAM_K3[arch])
        del batch
    q["serve"] = fam_serve(torch, model, params, card, name, True)
    del params, model
    q["cut_f32"] = fam_cut(torch, arch, f"{name} cut to {FAM_CUT} "
                           f"layers {list(FAM_CUT_TOKENS)}")
    q["seconds"] = time.perf_counter() - t0
    return q


def fam_moe(torch, fak, arch: str, card, **check_cut) -> dict:
    """A MoE family at its depth in bf16 on both dispatches: the build,
    the prefill step at [4, 512] on K3 (FAM_K3 launches each; bitwise
    repeatable; the first layer's routing bitwise alike on the two),
    :func:`moe_checks` (free routing flips recorded, K3 and the scatter
    dispatch at bf16's floor on replayed expert choices), the serve path
    at B = 4, then the f32 cut card vs CPU (``check_cut``'s fields
    replaced)."""
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    model, params, info = fam_build(torch, arch, card)
    name = model.cfg.name
    m = {"build": info}
    expert_bytes = sum(t.numel() * t.element_size() for seg in params["stack"]
                       for blk in seg.values() if "moe" in blk
                       for k, t in blk["moe"].items() if k != "router")
    m["expert_bytes"] = expert_bytes
    m["expert_read_bound_ms"] = expert_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  {name}: the experts' weights are {expert_bytes / 1e9:.2f} GB, "
          f"read in full by every prefill and every decode step: "
          f"{m['expert_read_bound_ms']:.2f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, the bound of each")
    batch = fam_batch(torch, model.cfg, *LM_PREFILL, 0, seed=1)
    last, spies = {}, {}
    try:
        for impl in MOE_IMPLS:
            T.MOE_IMPL[0] = impl
            last[impl], m[f"prefill_{impl}"] = fam_prefill(
                torch, fak, model, params, batch, card,
                f"{name} prefill {list(LM_PREFILL)} ({impl})", FAM_K3[arch])
            with RoutingSpy() as spies[impl]:
                again = model.forward(params, batch, impl="flash",
                                      last_only=True)
            check(torch.equal(again, last[impl]), f"{name} ({impl}): the "
                  "prefill step is not bitwise repeatable")
    finally:
        T.MOE_IMPL[0] = "einsum"
    check(torch.equal(spies["einsum"].gates[0], spies["scatter"].gates[0]),
          f"{name}: the first layer routes apart on the two dispatches")
    m["bf16"] = moe_checks(torch, model, params, batch, last, spies,
                           f"{name} {list(LM_PREFILL)}")
    del last, spies, again, batch
    m["serve"] = fam_serve(torch, model, params, card, name, False)
    del params, model
    label = ", ".join(f"{k} {v}" for k, v in check_cut.items())
    m["cut_f32"] = moe_cut(torch, arch, f"{name} cut to {FAM_CUT} layers "
                           f"{list(FAM_CUT_TOKENS)}"
                           + (f" ({label}: a check only)" if label else ""),
                           **check_cut)
    m["seconds"] = time.perf_counter() - t0
    return m


def phase_families(torch, fak, ref, card, ptxas) -> tuple:
    """Phase 19: qwen2.5-32b, phi3.5-moe (16 layers), qwen2-vl-72b (16
    layers), seamless-m4t-large-v2, mistral-large-123b (16 layers) and
    llama4-maverick-400b (2 layers) at full width in bf16 on the card,
    one at a time: the build (elements beside the reference's), the
    prefill step on K3 (64, 16, 16, 0, 16 and 2 launches) against
    ``impl="ref"`` at bf16's floor, the serve path at B = 4, an f32 cut
    card vs CPU; the MoEs on both dispatches; K3 at qwen2.5's, qwen2-vl's
    and mistral's prefill shapes beside SDPA and its bound."""
    from repro_torch.launch import serve as serve_cli

    out = {}
    t_phase = time.perf_counter()

    # qwen2.5-32b, nothing cut: 65.5 GB of bf16 weights, the card alone
    out[FAM_QWEN] = fam_dense(torch, fak, FAM_QWEN, card, long_prefill=True)

    # phi3.5-moe at 16 of 32 layers (42.1 GB), on both dispatches
    out[FAM_MOE] = fam_moe(torch, fak, FAM_MOE, card)

    # qwen2-vl-72b at 16 of 80 layers (33.1 GB): stub patches, M-RoPE
    t0 = time.perf_counter()
    model, params, info = fam_build(torch, FAM_VL, card)
    name = model.cfg.name
    vl = out[FAM_VL] = {"build": info}
    b, n_front, n_text = VL_PREFILL
    batch = fam_batch(torch, model.cfg, b, n_text, n_front, seed=1)
    logits, vl["prefill"] = fam_prefill(
        torch, fak, model, params, batch, card,
        f"{name} prefill [{b}, {n_front} patches + {n_text} tokens]",
        FAM_K3[FAM_VL])
    vl["prefill"].update(fam_flash_vs_ref(
        torch, model, params, batch, logits, f"{name} {list(VL_PREFILL)}"))
    del logits, batch
    vl["serve"] = fam_serve(torch, model, params, card, name, True)
    del params, model
    vl["cut_f32"] = fam_cut(torch, FAM_VL, f"{get_cfg(FAM_VL).name} cut to "
                            f"{FAM_CUT} layers {list(FAM_CUT_TOKENS)} + "
                            f"{FAM_CUT_FRONT} patches", FAM_CUT_FRONT)
    vl["seconds"] = time.perf_counter() - t0

    # seamless-m4t-large-v2, nothing cut: the serve CLI (zero encoder
    # output, as the reference's), then encode + teacher-forced decode
    t0 = time.perf_counter()
    fak.reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cli = serve_cli.main(["--arch", FAM_ED, "--full"])
    torch.cuda.synchronize()
    cfg = get_cfg(FAM_ED)
    toks = cli["tokens"]
    first = cli["prefill_logits"][:, 0, :cfg.vocab_size].argmax(-1)
    check(tuple(toks.shape) == (4, 32) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
        and torch.equal(toks[:, 0], first), f"{cfg.name} CLI tokens")
    check(fak.LAUNCHES["flash_attention"] == 0,
          f"the {cfg.name} serve CLI launched flash_attention")
    ed = out[FAM_ED] = {"cli": {
        "prefill_s": cli["prefill_s"], "decode_s": cli["decode_s"],
        "tok_per_s": cli["tok_per_s"],
        "decode_step_ms": cli["decode_s"] / 32 * 1e3,
        "prefill_scan_step_ms": cli["prefill_s"] / 16 * 1e3,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}}
    print(f"  {cfg.name} serve CLI --full (B 4, 16-token prompts, 32 "
          f"tokens): prefill_scan {cli['prefill_s']:.3f} s "
          f"({ed['cli']['prefill_scan_step_ms']:.2f} ms a step), decode "
          f"{ed['cli']['decode_step_ms']:.2f} ms a step, "
          f"{cli['tok_per_s']:.1f} tok/s, max allocated "
          f"{ed['cli']['max_memory_allocated'] / 1e9:.3f} GB; no kernel "
          f"launched  ({card})")
    del cli, toks
    model, params, ed["build"] = fam_build(torch, FAM_ED, card)
    b, n_front, n_tok = ED_PREFILL
    batch = fam_batch(torch, cfg, b, n_tok, n_front, seed=1)
    logits, ed["forward"] = fam_prefill(
        torch, fak, model, params, batch, card,
        f"{cfg.name} encode [{b}, {n_front} frames] + decode_train "
        f"[{b}, {n_tok}]", FAM_K3[FAM_ED])
    full = model.forward(params, batch)
    check(tuple(full.shape) == (b, n_tok, full.shape[-1]) and bool(
        torch.isfinite(full[..., :cfg.vocab_size]).all()),
        f"{cfg.name}: the teacher-forced logits")
    del logits, full, batch, params, model
    ed["cut_f32"] = fam_cut(torch, FAM_ED, f"{cfg.name} cut to {FAM_CUT} + "
                            f"{FAM_CUT} layers {list(FAM_CUT_TOKENS)} + "
                            f"{FAM_CUT_FRONT} frames", FAM_CUT_FRONT,
                            impls=("ref",))
    ed["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # mistral-large-123b at 16 of 88 layers (45.9 GB), llama4-maverick at
    # 2 of 48 (36.9 GB; its moe layer reads 32.2 GB of expert weights in
    # every prefill and every decode step)
    out[FAM_MISTRAL] = fam_dense(torch, fak, FAM_MISTRAL, card)
    out[FAM_LLAMA4] = fam_moe(torch, fak, FAM_LLAMA4, card,
                              n_experts=LLAMA4_CHECK_EXPERTS)
    torch.cuda.empty_cache()

    rows = [check_lm_kernel(torch, fak, ref, kname, case, window,
                            out[arch]["prefill"]["launches"],
                            ptxas["flash_attention_mma"])
            for kname, case, window, arch in FAM_FA_CASES]
    for row in rows:
        row["sdpa_ratio"] = row["ms"] / row["library_ms"]
    out["seconds"] = time.perf_counter() - t_phase
    return out, rows


# phase 20: federated training of the MoE, VLM and encoder-decoder
# families through the train CLI's train() at its defaults with --dp
# (phase 17's settings), bf16, one model on the card at a time: phi3.5-moe
# at 2 of its 32 layers, qwen2-vl-72b at 1 of its 80 (1,024 stub patches a
# row on M-RoPE positions) and seamless-m4t-large-v2 whole (1,024 stub
# frames a row); each family's cuts from the deepest, the next taken only
# if the card runs out
TF_FAMILIES = (FAM_MOE, FAM_VL, FAM_ED)
TF_CUTS = {FAM_MOE: (2, 1), FAM_VL: (1,), FAM_ED: (None,)}
# the update's flat row at the first cut (lm_param_shapes' elements, the
# norm scales and the vocab padding included) and the reference's
# param_count there (train() prints it; seamless's leaves out its encoder
# norms, cross-attention's and the padding: 1,531,342,848)
TF_ROW = {FAM_MOE: 2_864_861_184, FAM_VL: 3_369_109_504,
          FAM_ED: 1_632_233_472}
TF_PARAMS = {FAM_MOE: 2_863_136_768, FAM_VL: 3_369_074_688,
             FAM_ED: 1_531_342_848}
# The f32 card-vs-CPU checks (checks only, in no table of configurations):
# each family at full d_model and heads, 1 layer (seamless 1 + 1), 64 stub
# patches or frames a row as phase 19's f32 cuts, the vocabulary cut to
# 8,192, phi3.5-moe's experts to 4 (top-2 kept) and qwen2-vl's d_ff to a
# quarter, ~0.4 B elements at most.  At the training cuts the f32 round
# would not fit the card (qwen2-vl's 1 layer: 13.5 GB of f32 weights,
# ~7 copies at the round's peak with the [2, P] noise), and the CPU takes
# ~100 ns an element for the 3 rounds (phi3.5-moe's check: 45.0 s for
# 423,653,376 elements on an H100 host)
TF_CHECK = {
    FAM_MOE: {"n_layers": 1, "n_experts": 4, "vocab_size": 8192},
    FAM_VL: {"n_layers": 1, "frontend_tokens": FAM_CUT_FRONT,
             "vocab_size": 8192, "d_ff": 29568 // 4},
    FAM_ED: {"n_layers": 1, "enc_layers": 1, "enc_seq": FAM_CUT_FRONT,
             "vocab_size": 8192}}
TF_CHECK_SEED = 1


def tf_cfg(arch: str, layers):
    """The architecture's ``config()`` at ``layers`` (None: whole)."""
    import dataclasses

    from repro_torch.configs.base import get_arch

    cfg = get_arch(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def tf_card_vs_cpu(torch, arch: str, card) -> dict:
    """The family's f32 check (TF_CHECK) on the card against the CPU from
    the same state, the same data (the train CLI's, frontend included)
    and the same ``SerialDraws`` (the DP noise drawn on the card, one row
    a slot): a round without DP, then 2 serial rounds with clipped DP;
    sel_mask and failed equal, the round without DP and the first noised
    round within LMT_TOL, the second within LMT_REASSOC_MULT times its
    gap read on the card: the larger of phase 17's re-association gap
    (the same round at grad_accum 2; the CPU's is ~1e-7) and the state
    gap (the same round from the CPU's state before it, moved to the
    card: how far the card's own round amplifies the first round's f32
    difference).  Every reading is printed before any bar is checked."""
    import dataclasses

    from repro_torch.core import rounds as rounds_lib
    from repro_torch.launch.train import round_batches, train_fl_config
    from repro_torch.models.model import build
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = dataclasses.replace(tf_cfg(arch, None), dtype="float32",
                              **TF_CHECK[arch])
    model = build(cfg)
    fls = {"dp": train_fl_config(dp=True), "plain": train_fl_config()}
    n = fls["dp"].n_clients

    def step(dev, kind, ga=1):
        return rounds_lib.make_serial_round(
            lambda p, b: model.loss(p, b, remat="none"), fls[kind], n,
            device=dev, grad_accum=ga)

    seed = TF_CHECK_SEED
    params = model.init(seed, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    card0 = rounds_lib.init_serial_state(
        params, fls["dp"], torch.Generator(device="cuda").manual_seed(seed))
    cpu0 = card0._replace(
        params=tree_to(params, "cpu"),
        util=type(card0.util)(*(t.cpu() for t in card0.util)),
        kctl=type(card0.kctl)(*(t.cpu() for t in card0.kctl)),
        rng=torch.Generator().manual_seed(seed),
        fault=type(card0.fault)(*(t.cpu() for t in card0.fault)))
    del params
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    readings, mismatch = [], []
    cpu_s = 0.0
    states = {"plain": (card0, cpu0), "dp": (card0, cpu0)}
    for kind, r in (("plain", 0), ("dp", 0), ("dp", 1)):
        fl = fls[kind]
        data = {k: torch.as_tensor(v) for k, v in round_batches(
            cfg, fl, 2, 64, 100 * seed + r).items()}
        data_c = {k: v.cuda() for k, v in data.items()}
        draws = rounds_lib.draw_serial_round(gen, n, LMT_SLOTS, 1,
                                             fl.selection)
        if kind == "dp":
            draws = draws._replace(dp_noise=torch.randn(
                LMT_SLOTS, n_params, generator=gen, device="cuda"))
        card_st, cpu_st = states[kind]
        card_new, mc = step("cuda", kind)(card_st, data_c, draws=draws)
        t1 = time.perf_counter()
        cpu_new, mh = step("cpu", kind)(cpu_st, data, draws=draws.to("cpu"))
        cpu_s += time.perf_counter() - t1
        bars = {}
        if r > 0:
            mine = lmt_round_values(card_new, mc)
            ga = lmt_diff(lmt_round_values(*step("cuda", kind, 2)(
                card_st, data_c, draws=draws)), mine)
            swapped = card_st._replace(
                params=tree_to(cpu_st.params, "cuda"),
                **{f: type(getattr(cpu_st, f))(*(
                    t.cuda() for t in getattr(cpu_st, f)))
                   for f in ("util", "kctl", "fault")})
            state_gap = lmt_diff(lmt_round_values(*step("cuda", kind)(
                swapped, data_c, draws=draws)), mine)
            del swapped, mine
            for k in ga:
                gap = max(ga[k], state_gap[k])
                bars[k] = max(LMT_TOL, LMT_REASSOC_MULT * gap)
                readings.append((f"{kind} round {r} {k} gaps on the card: "
                                 f"grad_accum {ga[k]:.2e}, state "
                                 f"{state_gap[k]:.2e}", gap, None))
        states[kind] = card_new, cpu_new
        del draws, data_c
        if not (torch.equal(mc.sel_mask.cpu(), mh.sel_mask)
                and torch.equal(mc.failed.cpu(), mh.failed)):
            mismatch.append(f"{kind} round {r}")
        for k, err in lmt_diff(lmt_round_values(card_new, mc),
                               lmt_round_values(cpu_new, mh)).items():
            readings.append((f"{kind} round {r} {k}", err,
                             bars.get(k, LMT_TOL)))
    del states, card0, cpu0
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    cut = ", ".join(f"{k} {v}" for k, v in TF_CHECK[arch].items())
    print(f"  {cfg.name} f32 check ({cut}; {n_params:,} params; a check "
          f"only) card vs CPU on the same "
          f"draws, a round without DP and {LMT_CUT_ROUNDS} with DP in "
          f"{seconds:.1f} s ({cpu_s:.1f} s of CPU rounds): sel_mask and "
          f"failed {'equal' if not mismatch else 'DIFFER: ' + ', '.join(mismatch)}; "
          f"relative errors against their bars (LMT_TOL {LMT_TOL}; after "
          f"a noised round {LMT_REASSOC_MULT:g} x the larger of the card's "
          f"grad_accum and state gaps):")
    for what, err, bar in readings:
        print(f"    {what}: {err:.2e}"
              + ("" if bar is None else f" (bar {bar:.2e})"))
    check(not mismatch, f"{cfg.name}: sel_mask/failed differ card vs CPU: "
          f"{mismatch}")
    for what, err, bar in readings:
        if bar is not None:
            check(err <= bar, f"{cfg.name} {what}: {err:.3e} over its bar "
                  f"{bar:.3e}")
    return {"params": n_params, "cut": TF_CHECK[arch], "seed": seed,
            "readings": [{"what": w, "err": e, "bar": b}
                         for w, e, b in readings],
            "seconds": seconds, "cpu_round_s": cpu_s}


def tf_train(torch, dpk, arch: str, card) -> dict:
    """One family through ``train`` at the CLI's defaults with ``--dp`` at
    the deepest of its TF_CUTS the card holds: K1a/K1b once a privatised
    slot (counted from 0 just before), finite losses, the eval loss
    before and after, the warm round wall and peak, one profiled round
    (busy share, spans, device ms by kind, heaviest kernels)."""
    from repro_torch.launch.train import round_batches, train

    out = {"out_of_memory": []}
    for layers in TF_CUTS[arch]:
        cfg = tf_cfg(arch, layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dpk.reset_launches()
        try:
            res = train(cfg, rounds=LMT_ROUNDS, dp=True, seed=0,
                        device="cuda")
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError as err:
            peak = torch.cuda.max_memory_allocated()
            out["out_of_memory"].append({"layers": layers, "peak": peak,
                                         "error": str(err)[:400]})
            print(f"  {cfg.name} at {layers} layers: out of card memory at "
                  f"a peak of {peak / 1e9:.2f} GB: {str(err)[:400]}  "
                  f"({card})")
            torch.cuda.empty_cache()
    else:
        check(False, f"{arch}: no cut in {TF_CUTS[arch]} fits the card")
    launches = dict(dpk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    model, step, state = res["model"], res["step"], res["state"]
    n, nbytes = tree_bytes(state.params)
    if layers == TF_CUTS[arch][0]:
        check(cfg.param_count() == TF_PARAMS[arch] and n == TF_ROW[arch],
              f"{cfg.name}: {cfg.param_count()} params ({n} elements), the "
              f"reference's {TF_PARAMS[arch]} ({TF_ROW[arch]})")
    losses = ([res["initial_eval_loss"], res["final_eval_loss"]]
              + [r["local_loss"] for r in res["rounds"]])
    check(all(math.isfinite(v) for v in losses), f"{cfg.name} losses "
          f"{losses}")
    slots = LMT_ROUNDS * LMT_SLOTS
    check(launches == {"sumsq_rows": slots, "scale_noise_rows": slots},
          f"{cfg.name}: K1 launches {launches} for {slots} privatised slots")
    walls = [r["wall_s"] * 1e3 for r in res["rounds"]]
    out.update(layers=cfg.n_layers, enc_layers=cfg.enc_layers,
               param_count=cfg.param_count(), row=n, param_bytes=nbytes,
               launches=launches, eval_loss=losses[:2],
               rounds=res["rounds"], round_wall_ms=walls,
               warm_round_wall_ms=statistics.median(walls[1:]),
               max_memory_allocated=peak)
    data = {k: torch.as_tensor(v, device="cuda") for k, v in round_batches(
        cfg, res["fl"], 2, 64, 7).items()}

    def one_round():
        nonlocal state
        state, _ = step(state, data)

    out["profile"] = prof = lm_train_profiled(torch, one_round)
    front = ("" if "frontend" not in data else
             f", {data['frontend'].shape[3]:,} stub "
             f"{'frames' if cfg.enc_layers else 'patches'} a row")
    print(f"  {cfg.name} at {cfg.n_layers} layers"
          + (f" + {cfg.enc_layers} encoder layers" if cfg.enc_layers else "")
          + f"{front}: train() printed {cfg.param_count():,} params "
          f"(param_count, the reference's), a row of {n:,} elements "
          f"(lm_param_shapes; {nbytes / 1e9:.2f} GB bf16); eval loss "
          f"{losses[0]:.4f} -> {losses[1]:.4f}; round walls "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms (warm "
          f"{out['warm_round_wall_ms']:.1f}); K1 launches {launches}; peak "
          f"allocated {peak / 1e9:.2f} GB; profiled round "
          f"{prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms (share "
          f"{prof['device_busy_share']:.3f}, {prof['device_ops']} ops)  "
          f"({card})")
    for name, ms in sorted(prof["spans_host_ms"].items()):
        print(f"    span {name}: {ms:.2f} ms host")
    for kind, ms in prof["device_ms_by_kind"].items():
        print(f"    device {kind}: {ms:.2f} ms")
    for k in prof["top_kernels"]:
        print(f"    kernel {k['name']}: {k['calls']} calls, "
              f"{k['device_ms']:.3f} ms")
    del res, model, step, state, data
    torch.cuda.empty_cache()
    return out


def phase_train_families(torch, dpk, ref, card) -> tuple:
    """Phase 20: phi3.5-moe, qwen2-vl-72b and seamless-m4t-large-v2 trained
    through ``launch/train.py``'s ``train`` (:func:`tf_train`), one at a
    time; K1 at each family's row [1, P] against its plain versions
    (:func:`lm_train_k1`: the first rows past 2^31 elements, where the
    split plan's int64 offsets are held); the f32 check card vs CPU
    (:func:`tf_card_vs_cpu`)."""
    out, rows = {}, []
    for arch in TF_FAMILIES:
        t0 = time.perf_counter()
        fam = out[arch] = tf_train(torch, dpk, arch, card)
        rows += lm_train_k1(torch, dpk, ref, fam["launches"], card,
                            p=fam["row"], tag=f"lm_train_{arch}")
        torch.cuda.empty_cache()
        fam["card_vs_cpu"] = tf_card_vs_cpu(torch, arch, card)
        fam["seconds"] = time.perf_counter() - t0
    return out, rows


# phase 21: the sharding layer (launch/steps.py, models/shardctx.py) on the
# card.  One H100, so the sharded code runs for real on a one-device mesh
# (a world-size-1 NCCL group from an in-process store, no network): the
# ("data", "model") (1, 1) mesh and the multi-pod (1, 1, 1) form; the
# 256-rank layouts run through the dry-run (launch/dryrun.py) on a fake
# group in a subprocess (a card's NCCL group cannot share its process)
SH_PREFILL = (4, 512)       # B, S of the prefill bundle
SH_DECODE = (4, 512, 8)     # B, cache length, decode steps
# the dry-run pairs run here: the serve shapes of the two largest configs
# on the 16 x 16 mesh.  Their train_4k pairs (the serial round over 16
# microbatches of 88 and 48 layers) take 13-20 minutes of CPU each under
# fake tensors, past this script's limit: the CPU dry-run table holds them
SH_DRY = (("mistral_large_123b", "prefill_32k"),
          ("mistral_large_123b", "decode_32k"),
          ("llama4_maverick_400b", "prefill_32k"),
          ("llama4_maverick_400b", "decode_32k"))


def sh_meshes(torch):
    """The one-device meshes over a world-size-1 NCCL group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import mesh_from_shape
    torch.cuda.set_device(0)
    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", 0))
    return {"single": mesh_from_shape((1, 1), ("data", "model"), "cuda"),
            "multi": mesh_from_shape((1, 1, 1), ("pod", "data", "model"),
                                     "cuda")}


def sh_wall(torch, fn, reps: int = 2):
    """(result of the last call, its wall ms): the first call warms."""
    out, ms = None, None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return out, ms


def sh_equal(torch, got, want, what: str, tol: float = LM_BF16_TOL) -> dict:
    """Bitwise, or the first difference printed and the pair held to
    phase 15's bf16 bar."""
    got, want = got.float(), want.float()
    if torch.equal(got, want):
        print(f"  {what}: bitwise equal")
        return {"bitwise": True}
    idx = (got != want).nonzero()[0].tolist()
    print(f"  {what}: not bitwise; first difference at {idx}: "
          f"{float(got[tuple(idx)]):.6e} vs {float(want[tuple(idx)]):.6e}")
    return {"bitwise": False, "first_difference": idx,
            "bar": lm_close(torch, got, want, tol, what)}


def sh_serve(torch, meshes, card) -> dict:
    """(a): granite-3-8b whole in bf16, the prefill bundle at [4, 512] and
    the decode bundle at B = 4 on a 512-token cache for 8 steps, on each
    one-device mesh, against the unsharded ``forward(impl="ref",
    last_only=True)`` and ``decode_step`` on the same weights."""
    from repro_torch.configs.base import MeshConfig, ShapeConfig, get_arch
    from repro_torch.launch import steps
    from repro_torch.models.model import build

    cfg = get_arch(LM_ARCH)
    model = build(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, device="cuda")
    b, s = SH_PREFILL
    tokens = lm_tokens(torch, cfg, b, s, seed=1)
    want, plain_ms = sh_wall(torch, lambda: model.forward(
        params, {"tokens": tokens}, impl="ref", last_only=True))
    db, c, n_steps = SH_DECODE
    step_tokens = [lm_tokens(torch, cfg, db, 1, seed=10 + i)
                   for i in range(n_steps)]
    caches = model.init_cache(db, c, params=params)
    t0 = time.perf_counter()
    want_dec = []
    for i, tok in enumerate(step_tokens):
        lg, caches = model.decode_step(params, tok, caches, i)
        want_dec.append(lg)
    torch.cuda.synchronize()
    plain_dec_ms = (time.perf_counter() - t0) * 1e3
    out = {"prefill_plain_ms": plain_ms, "decode_plain_ms": plain_dec_ms}
    for kind, mesh in meshes.items():
        mc = MeshConfig(multi_pod=(kind == "multi"))
        bp = steps.build_prefill_step(cfg, ShapeConfig("prefill", s, b,
                                                       "prefill"), mc, mesh)
        dp = steps.place(params, bp.in_shardings[0], mesh)
        dbatch = steps.place({"tokens": tokens}, bp.in_shardings[1], mesh)
        got, ms = sh_wall(torch, lambda: bp.fn(dp, dbatch))
        row = {"prefill_ms": ms,
               "prefill": sh_equal(torch, got.to_local(), want,
                                   f"{kind} mesh prefill bundle vs forward")}
        bd = steps.build_decode_step(cfg, ShapeConfig("decode", c, db,
                                                      "decode"), mc, mesh)
        dcaches = steps.place(model.init_cache(db, c, params=params),
                              bd.in_shardings[2], mesh)
        got_dec = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, tok in enumerate(step_tokens):
            lg, dcaches = bd.fn(dp, steps.place(tok, bd.in_shardings[1], mesh),
                                dcaches, i)
            got_dec.append(lg.to_local())
        torch.cuda.synchronize()
        row["decode_ms"] = (time.perf_counter() - t0) * 1e3
        row["decode"] = sh_equal(torch, torch.stack(got_dec),
                                 torch.stack(want_dec),
                                 f"{kind} mesh decode bundle vs decode_step, "
                                 f"{n_steps} steps")
        row["caches"] = sh_equal(
            torch, torch.cat([t.to_local().float().flatten()
                              for t in tree_list(dcaches)]),
            torch.cat([t.float().flatten() for t in tree_list(caches)]),
            f"{kind} mesh caches after {n_steps} steps")
        print(f"  {kind} mesh: prefill [{b}, {s}] bundle {ms:.2f} ms vs "
              f"unsharded {plain_ms:.2f} ms; decode {n_steps} steps bundle "
              f"{row['decode_ms']:.2f} ms vs unsharded {plain_dec_ms:.2f} ms "
              f"(walls, sync'd)  ({card})")
        out[kind] = row
        del dp, dbatch, dcaches, got, got_dec
    del params, caches, want, want_dec
    torch.cuda.empty_cache()
    return out


def sh_train(torch, dpk, mesh, card) -> dict:
    """(b): the client_serial train bundle (``plan="client_serial"``) on
    the (1, 1) mesh, on phase 17's granite cut to 8 layers and the train
    CLI's settings with --dp, against phase 17's ``make_serial_round`` on
    the same state and draws: bitwise, or within 8x the round's
    re-association gap (the same round at grad_accum 2 against 1, read
    here); K1a and K1b once each per privatised slot on the local row."""
    import dataclasses

    from repro_torch.configs.base import MeshConfig, ShapeConfig, get_arch
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.launch import steps
    from repro_torch.launch.train import (_tensors, round_batches,
                                          train_fl_config)
    from repro_torch.models.model import build

    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=LMT_LAYERS)
    fl = train_fl_config(8, LMT_SLOTS, 1, 0.005, True)
    model = build(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, device="cuda")
    data = _tensors(round_batches(cfg, fl, 2, 64, 0), "cuda")

    def loss(p, b):
        return model.loss(p, b, remat="none")

    def plain_round(grad_accum: int):
        state = rounds_lib.init_serial_state(
            params, fl, torch.Generator(device="cuda").manual_seed(1),
            n_clients=fl.n_clients)
        step = rounds_lib.make_serial_round(loss, fl, fl.n_clients,
                                            grad_accum=grad_accum,
                                            device="cuda")
        return step(state, data)

    dpk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_m = plain_round(1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_launches = dict(dpk.LAUNCHES)

    bt = steps.build_train_step(cfg, ShapeConfig("train", 64, 2, "train"),
                                MeshConfig(), mesh, plan="client_serial",
                                grad_accum=1, remat="none", fl=fl)
    dparams = steps.place(params, bt.in_shardings[0], mesh)
    layout = rounds_lib._ShardLayout(dparams)
    check(layout.n_local == LMT_ROW and layout.n_owned == LMT_ROW,
          f"local row {layout.n_local} (owned {layout.n_owned}) of "
          f"{LMT_ROW}")
    state = rounds_lib.init_serial_state(
        dparams, fl, torch.Generator(device="cuda").manual_seed(1),
        n_clients=fl.n_clients)
    dbatch = steps.place(data, bt.in_shardings[1], mesh)
    dpk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, got_m = bt.fn(state, dbatch)
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(dpk.LAUNCHES)
    check(launches == {"sumsq_rows": LMT_SLOTS, "scale_noise_rows": LMT_SLOTS}
          and plain_launches == launches,
          f"K1 launches {launches} (unsharded {plain_launches}) for "
          f"{LMT_SLOTS} privatised slots")
    check(torch.equal(got_m.sel_mask, want_m.sel_mask)
          and torch.equal(got_m.failed, want_m.failed),
          "sharded round's selection and failures")
    diffs = [float((g.to_local().float() - w.float()).abs().max())
             for g, w in zip(tree_list(got.params), tree_list(want.params))]
    out = {"layers": LMT_LAYERS, "row": layout.n_local, "launches": launches,
           "round_ms": sharded_ms, "plain_round_ms": plain_ms,
           "max_abs_diff": max(diffs), "bitwise": max(diffs) == 0.0,
           "norms": [float(x) for x in got_m.update_norms],
           "plain_norms": [float(x) for x in want_m.update_norms]}
    if not out["bitwise"]:
        alt, _ = plain_round(2)
        gap = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(tree_list(alt.params),
                                  tree_list(want.params)))
        out["reassoc_gap"] = gap
        check(out["max_abs_diff"] <= LMT_REASSOC_MULT * max(gap, LMT_TOL),
              f"sharded round {out['max_abs_diff']:.3e} past "
              f"{LMT_REASSOC_MULT} x its re-association gap {gap:.3e}")
        del alt
    print(f"  {cfg.name} at {LMT_LAYERS} layers, serial round with DP: "
          f"sharded (1, 1) {sharded_ms:.1f} ms vs unsharded {plain_ms:.1f} "
          f"ms (first calls); params max|diff| {out['max_abs_diff']:.3e} "
          f"({'bitwise' if out['bitwise'] else 'gap ' + str(out.get('reassoc_gap'))}); "
          f"K1 launches {launches} on a local row of {layout.n_local:,}  "
          f"({card})")
    del params, dparams, state, got, want, dbatch, data
    torch.cuda.empty_cache()
    return out


def sh_dryrun(torch, card) -> dict:
    """(c): ``launch/dryrun.py`` on this torch, each pair in a subprocess
    of its own (fake 16 x 16 group, fake tensors), all at once."""
    import os
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    out_dir = OUT_DIR / "dryrun"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")

    def one(pair):
        arch, shape = pair
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out-dir",
             str(out_dir)], capture_output=True, text=True, env=env,
            timeout=600)
        return pair, res, time.perf_counter() - t0

    rows = {}
    with ThreadPoolExecutor(len(SH_DRY)) as pool:
        for (arch, shape), res, wall in pool.map(one, SH_DRY):
            check(res.returncode == 0,
                  f"dry-run {arch} {shape}: {res.stdout[-1500:]}"
                  f"{res.stderr[-1500:]}")
            r = json.loads((out_dir / f"{arch}__{shape}__single.json")
                           .read_text())
            mem = r["memory"]
            rows[f"{arch}/{shape}"] = {
                "argument_bytes": mem["argument_bytes"],
                "peak_bytes": mem["peak_bytes"], "flops": r["cost"]["flops"],
                "collective_bytes": r["collectives"]["total"],
                "collectives": r["collectives"], "run_s": r["run_s"],
                "process_s": wall, "torch": r["torch"],
                "fits_h100_80gb": r["fits_h100_80gb"]}
            print(f"  dry-run {arch} {shape} (16 x 16, fake tensors, torch "
                  f"{r['torch']}): per rank args "
                  f"{mem['argument_bytes'] / 1e9:.2f} GB, est. peak "
                  f"{mem['peak_bytes'] / 1e9:.2f} GB of 80 "
                  f"({'fits' if r['fits_h100_80gb'] else 'does not fit'}), "
                  f"{r['cost']['flops']:.3e} flops, collectives "
                  f"{r['collectives']['total'] / 1e9:.2f} GB "
                  f"({r['collectives']['counts']}); step {r['run_s']:.1f} s, "
                  f"process {wall:.1f} s")
    return rows


def phase_sharding(torch, dpk, card) -> dict:
    """Phase 21: (a) the serve bundles and (b) the serial train bundle on
    one-device meshes against the unsharded path, (c) the dry-run of the
    two largest configs' serve shapes on this torch."""
    t0 = time.perf_counter()
    meshes = sh_meshes(torch)   # the group lives on into phase 22
    with torch.no_grad():
        out = {"serve": sh_serve(torch, meshes, card)}
    out["train"] = sh_train(torch, dpk, meshes["single"], card)
    out["dryrun"] = sh_dryrun(torch, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 21: {out['seconds']:.1f} s")
    return out

# Phase 22: the client_parallel round on an LM and its train bundle
PL_CLIENTS = 4              # clients of the unsharded round at 8 layers
PL_ROUNDS = 2
PL_CUT = 1                  # layers of the f32 card-vs-CPU cut
PL_SEQ, PL_BATCH = 64, 2    # phase 17's sequence and batch a client
PL_POPS = (1_000, 1_000_000)  # phase 14's populations re-run in (c)


def pl_data(torch, cfg, fl, n: int, seed: int, device="cuda"):
    """The train CLI's tokens for ``n`` clients, ``[n, 1, PL_BATCH,
    PL_SEQ]``."""
    import dataclasses

    from repro_torch.launch.train import _tensors, round_batches
    many = dataclasses.replace(fl, serial_clients_in_step=n)
    return _tensors(round_batches(cfg, many, PL_BATCH, PL_SEQ, seed), device)


def pl_measure(torch, dpk, fn):
    """``fn()``'s result, wall ms (to a synchronise), K1 launches counted
    from 0 and peak allocated bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dpk.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3, dict(dpk.LAUNCHES),
            torch.cuda.max_memory_allocated())


def pl_bundle(torch, dpk, mesh, card) -> dict:
    """(a): the client_parallel train bundle on the (1, 1) mesh (one
    client on the one data rank) against the unsharded
    ``make_parallel_round`` on the same weights and generator seed."""
    import dataclasses

    from repro_torch.configs.base import MeshConfig, ShapeConfig, get_arch
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.launch import steps
    from repro_torch.models.model import build

    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=LMT_LAYERS)
    model = build(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, device="cuda")
    bt = steps.build_train_step(cfg, ShapeConfig("train", PL_SEQ, PL_BATCH,
                                                 "train"), MeshConfig(), mesh,
                                remat="none")
    fl = bt.meta["fl"]
    check(bt.meta["plan"] == "client_parallel" and fl.n_clients == 1
          and fl.dp_enabled and fl.dp_mode == "clipped",
          f"bundle {bt.meta['plan']}, {fl.n_clients} clients, DP "
          f"{fl.dp_enabled}/{fl.dp_mode}")
    data = pl_data(torch, cfg, fl, 1, 0)

    def loss(p, b):
        return model.loss(p, b, remat="none")

    def plain(grad_accum: int = 1):
        state = rounds_lib.init_serial_state(
            params, fl, torch.Generator(device="cuda").manual_seed(1),
            n_clients=1)
        return rounds_lib.make_parallel_round(
            loss, fl, 1, device="cuda", grad_accum=grad_accum,
            lm=True)(state, data)

    (want, want_m), plain_ms, plain_launches, plain_peak = pl_measure(
        torch, dpk, plain)
    dparams = steps.place(params, bt.in_shardings[0], mesh)
    state = rounds_lib.init_serial_state(
        dparams, fl, torch.Generator(device="cuda").manual_seed(1),
        n_clients=1)
    dbatch = steps.place(data, bt.in_shardings[1], mesh)
    (got, got_m), ms, launches, peak = pl_measure(
        torch, dpk, lambda: bt.fn(state, dbatch))
    check(launches == {"sumsq_rows": 1, "scale_noise_rows": 1}
          and plain_launches == launches,
          f"K1 launches {launches} (unsharded {plain_launches}) for one "
          f"client")
    check(torch.equal(got_m.sel_mask, want_m.sel_mask)
          and torch.equal(got_m.failed, want_m.failed),
          "bundle's selection and failures")
    check(all(math.isfinite(float(x)) for x in got_m.post_loss),
          f"bundle losses {got_m.post_loss}")
    diffs = [float((g.to_local().float() - w.float()).abs().max())
             for g, w in zip(tree_list(got.params), tree_list(want.params))]
    out = {"layers": LMT_LAYERS, "launches": launches, "round_ms": ms,
           "plain_round_ms": plain_ms, "peak_bytes": peak,
           "plain_peak_bytes": plain_peak, "max_abs_diff": max(diffs),
           "bitwise": max(diffs) == 0.0 and torch.equal(
               got_m.update_norms, want_m.update_norms),
           "norms": [float(x) for x in got_m.update_norms],
           "plain_norms": [float(x) for x in want_m.update_norms]}
    if not out["bitwise"]:
        del got, dparams, state
        (alt, _), _, _, _ = pl_measure(torch, dpk, lambda: plain(2))
        gap = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(tree_list(alt.params),
                                  tree_list(want.params)))
        out["reassoc_gap"] = gap
        check(out["max_abs_diff"] <= LMT_REASSOC_MULT * max(gap, LMT_TOL),
              f"bundle {out['max_abs_diff']:.3e} past {LMT_REASSOC_MULT} x "
              f"its re-association gap {gap:.3e}")
    print(f"  (a) {cfg.name} at {LMT_LAYERS} layers, client_parallel bundle "
          f"(1, 1), one client, clipped DP: {ms:.1f} ms (peak "
          f"{peak / 1e9:.2f} GB) vs unsharded {plain_ms:.1f} ms (peak "
          f"{plain_peak / 1e9:.2f} GB), first calls; params max|diff| "
          f"{out['max_abs_diff']:.3e} "
          f"({'bitwise' if out['bitwise'] else 'gap ' + str(out.get('reassoc_gap'))}); "
          f"K1 launches {launches}  ({card})")
    del params, want, dbatch, data
    torch.cuda.empty_cache()
    return out


def pl_round(torch, dpk, card) -> dict:
    """(b): the unsharded LM round at PL_CLIENTS clients on the 8-layer
    cut with make_fl_config's clipped DP, PL_ROUNDS rounds (K1 counted
    from 0: once a round on the [n, P] rows), then one profiled round."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.launch import steps
    from repro_torch.models.model import build

    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=LMT_LAYERS)
    model = build(cfg)
    torch.cuda.empty_cache()
    params = model.init(0, device="cuda")
    fl = steps.make_fl_config(cfg, "client_parallel", PL_CLIENTS)
    step = rounds_lib.make_parallel_round(
        lambda p, b: model.loss(p, b, remat="none"), fl, PL_CLIENTS,
        device="cuda", lm=True)
    state = rounds_lib.init_serial_state(
        params, fl, torch.Generator(device="cuda").manual_seed(2),
        n_clients=PL_CLIENTS)
    del params
    data = [pl_data(torch, cfg, fl, PL_CLIENTS, r) for r in range(PL_ROUNDS)]
    walls, metrics = [], []
    torch.cuda.reset_peak_memory_stats()
    dpk.reset_launches()
    for r in range(PL_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data[r])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = dict(dpk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches == {"sumsq_rows": PL_ROUNDS,
                       "scale_noise_rows": PL_ROUNDS},
          f"K1 launches {launches} in {PL_ROUNDS} rounds of "
          f"{PL_CLIENTS} clients (want one a round on the [n, P] rows)")
    for m in metrics:
        check(all(math.isfinite(float(x)) for x in m.post_loss)
              and float(m.sel_mask.sum()) > 0,
              f"round losses {m.post_loss}, selected {m.sel_mask}")
    prof = lm_train_profiled(torch, lambda: step(state, data[0]))
    out = {"clients": PL_CLIENTS, "layers": LMT_LAYERS,
           "round_ms": walls, "peak_bytes": peak, "launches": launches,
           "losses": [[float(x) for x in m.post_loss] for m in metrics],
           "selected": [[float(x) for x in m.sel_mask] for m in metrics],
           "norms": [[float(x) for x in m.update_norms] for m in metrics],
           "profile": prof}
    print(f"  (b) {cfg.name} at {LMT_LAYERS} layers, the unsharded "
          f"client_parallel round at {PL_CLIENTS} clients with clipped DP: "
          f"walls {', '.join(f'{w:.1f}' for w in walls)} ms, peak "
          f"{peak / 1e9:.2f} GB, K1 launches {launches}; profiled round "
          f"{prof['wall_ms']:.1f} ms, busy {prof['device_busy_share']:.3f}, "
          f"by kind {dict((k, round(v, 2)) for k, v in prof['device_ms_by_kind'].items())} ms; "
          f"losses {out['losses']}  ({card})")
    del state, step, data, metrics
    torch.cuda.empty_cache()
    return out


def pl_k1(torch, dpk, ref, launches, card) -> list:
    """K1 at the round's rows [PL_CLIENTS, LMT_ROW] against its plain
    versions.  x and the noise are closed forms of each element's index
    (so any block can be rebuilt): ``sumsq_rows`` on the split plan to a
    relative LMT_SQ_RTOL of the plain version row by row, bitwise
    repeatable; ``scale_noise_rows`` in place, every element bitwise the
    plain version on its rebuilt block.  Timed by CUDA events (5 calls,
    median of 3) beside the plain versions (over 16 column blocks: at
    [4, P] their temporaries would not fit beside the rows),
    ``vector_norm`` and an in-place ``addcmul_`` on σ·n.  Rows
    ``sumsq_rows_lm_parallel`` and ``scale_noise_rows_lm_parallel``."""
    from repro_torch.core.dp import gaussian_sigma

    r, p = PL_CLIENTS, LMT_ROW
    plan = dpk.sumsq_plan(r, p)
    check(plan.split > 1, f"sumsq plan at [{r}, {p}]: {plan}")
    step = 1 << 26

    def block(a: int, b: int):
        k = (torch.arange(a, b, device="cuda")[None]
             + torch.arange(r, device="cuda")[:, None] * p)
        return (((k * 7919) % 20011 - 10005).float() * 1e-7,
                ((k * 104729) % 30011 - 15005).float() * 6.66e-5)

    torch.cuda.empty_cache()
    x = torch.empty(r, p, device="cuda")
    nz = torch.empty(r, p, device="cuda")
    for a in range(0, p, step):
        x[:, a:a + step], nz[:, a:a + step] = block(a, min(a + step, p))
    sq = dpk.sumsq_rows(x)
    sq_ref = torch.stack([ref.sumsq_rows_ref(x[i:i + 1])[0]
                          for i in range(r)])
    rel = float(((sq.double() - sq_ref.double()).abs()
                 / sq_ref.double()).max())
    check(rel <= LMT_SQ_RTOL, f"sumsq_rows at [{r}, {p}]: relative {rel}")
    check(torch.equal(sq, dpk.sumsq_rows(x)),
          f"sumsq_rows not bitwise repeatable at [{r}, {p}]")
    sigma = gaussian_sigma(8.0, 1e-5, 1.0)
    scale = ref.clip_scale(torch.sqrt(sq_ref), 1.0)
    pieces = [(i, a, min(a + p // 4 + 1, p)) for i in range(r)
              for a in range(0, p, p // 4 + 1)]

    def ms(fn):
        return eager_ms(fn, iters=5, reps=3)

    def plain_sq():
        for i, a, b in pieces:
            ref.sumsq_rows_ref(x[i, a:b][None])

    def plain_sn():
        for i, a, b in pieces:
            ref.scale_noise_rows_ref(x[i, a:b][None], nz[i, a:b][None],
                                     scale[i:i + 1], sigma)

    t_sq = {"ms": ms(lambda: dpk.sumsq_rows(x)), "plain_ms": ms(plain_sq),
            "library_ms": ms(lambda: torch.linalg.vector_norm(x, dim=1))}
    dpk.scale_noise_rows(x, nz, scale, sigma, out=x)
    bad = [a for a in range(0, p, step)
           if not torch.equal(x[:, a:a + step], ref.scale_noise_rows_ref(
               *block(a, min(a + step, p)), scale, sigma))]
    check(not bad, f"scale_noise_rows in place differs from its plain "
          f"version at [{r}, {p}] in {len(bad)} blocks from column {bad[:3]}")
    t_sn = {"ms": ms(lambda: dpk.scale_noise_rows(x, nz, scale, sigma,
                                                  out=x)),
            "plain_ms": ms(plain_sn), "library_ms": None}
    nz.mul_(sigma)
    scale_col = scale[:, None]
    t_sn["addcmul_ms"] = ms(lambda: nz.addcmul_(x, scale_col))
    del x, nz
    torch.cuda.empty_cache()
    common = {"route": "cuda", "shape": [r, p],
              "source": "src/repro_torch/kernels/csrc/dp_clip_noise.cu",
              "timing": "CUDA events, 5 back-to-back calls, median of 3"}
    b_sq, by_sq = sumsq_bound(r, p)
    b_sn, by_sn = bound(12 * r * p + 4 * r, 3 * r * p)
    rows = [
        {"name": "sumsq_rows_lm_parallel", **common,
         "replaces": "src/repro/kernels/dp_clip_noise.py:62",
         "launches": launches["sumsq_rows"],
         "max_abs_err": float((sq.double() - sq_ref.double()).abs().max()),
         "rel_err": rel, "plan": list(plan), "bound_ms": b_sq,
         "bound_by": by_sq, **t_sq},
        {"name": "scale_noise_rows_lm_parallel", **common,
         "replaces": "src/repro/kernels/dp_clip_noise.py:81",
         "launches": launches["scale_noise_rows"], "max_abs_err": 0.0,
         "bound_ms": b_sn, "bound_by": by_sn, **t_sn}]
    print(f"  K1 at [{r}, {p:,}] ({card}): sumsq_rows (split plan, "
          f"{plan.split} blocks a row) rel err {rel:.2e}, bitwise "
          f"repeatable; {t_sq['ms']:.3f} ms (bound {b_sq:.3f} ms, {by_sq}; "
          f"plain {t_sq['plain_ms']:.3f}; vector_norm "
          f"{t_sq['library_ms']:.3f}); scale_noise_rows in place bitwise its "
          f"plain version, {t_sn['ms']:.3f} ms (bound {b_sn:.3f} ms; plain "
          f"{t_sn['plain_ms']:.3f}; addcmul_ on σ·n {t_sn['addcmul_ms']:.3f})")
    return rows


def pl_cut(torch, card) -> dict:
    """(b): a 1-layer f32 cut at granite's width, the round at PL_CLIENTS
    clients with make_fl_config's clipped DP (coherence on: the cut is
    under 1e9 params) on the card and on the CPU from the same state and
    draws: masks and failures equal, every value within LMT_TOL."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.launch import steps
    from repro_torch.models.model import build
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=PL_CUT,
                              dtype="float32")
    model = build(cfg)
    fl = steps.make_fl_config(cfg, "client_parallel", PL_CLIENTS)
    params = model.init(5, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    card_state = rounds_lib.init_serial_state(
        params, fl, torch.Generator(device="cuda").manual_seed(7),
        n_clients=PL_CLIENTS)
    cpu_state = card_state._replace(
        params=tree_to(params, "cpu"),
        util=type(card_state.util)(*(t.cpu() for t in card_state.util)),
        kctl=type(card_state.kctl)(*(t.cpu() for t in card_state.kctl)),
        rng=torch.Generator().manual_seed(7),
        fault=type(card_state.fault)(*(t.cpu() for t in card_state.fault)))
    del params
    draws = rounds_lib.draw_round(
        [torch.Generator(device="cuda").manual_seed(6)], PL_CLIENTS, 1,
        n_params, fl.selection).lane(0)
    out = {}
    for dev, st, dr in (("cuda", card_state, draws),
                        ("cpu", cpu_state, draws.to("cpu"))):
        step = rounds_lib.make_parallel_round(
            lambda p, b: model.loss(p, b, remat="none"), fl, PL_CLIENTS,
            device=dev, lm=True)
        out[dev] = step(st, pl_data(torch, cfg, fl, PL_CLIENTS, 9, dev),
                        draws=dr)
    (cs, mc), (hs, mh) = out["cuda"], out["cpu"]
    same = (torch.equal(mc.sel_mask.cpu(), mh.sel_mask)
            and torch.equal(mc.failed.cpu(), mh.failed))
    errs = lmt_diff(lmt_round_values(cs, mc), lmt_round_values(hs, mh))
    seconds = time.perf_counter() - t0
    print(f"  (b) {PL_CUT}-layer f32 cut ({n_params:,} params), "
          f"{PL_CLIENTS} clients with clipped DP and coherence, card vs CPU "
          f"on the same draws ({seconds:.1f} s): sel_mask and failed "
          f"{'equal' if same else 'DIFFER'}; relative errors (bar "
          f"{LMT_TOL}): " + ", ".join(f"{k} {v:.2e}" for k, v in
                                      errs.items()))
    check(same, "sel_mask/failed differ card vs CPU")
    for k, v in errs.items():
        check(v <= LMT_TOL, f"{k}: {v:.3e} card vs CPU over {LMT_TOL}")
    del out, cs, hs, card_state, cpu_state, draws
    torch.cuda.empty_cache()
    return {"params": n_params, "errors": errs, "seconds": seconds}


def pl_engines(torch, fed, fl, sweep, population, card) -> dict:
    """(c): with a one-rank process group the engines take their unsharded
    path: phase 7b's grid and phase 14's populations again, bitwise the
    histories those phases printed."""
    import torch.distributed as dist

    from repro_torch.data.synthetic import make_population
    from repro_torch.train import fl_driver

    check(dist.is_initialized() and dist.get_world_size() == 1,
          "phase 22 (c) runs under a one-rank process group")
    t0 = time.perf_counter()
    res = fl_driver.run_fl_sweep(
        fed, fl, sweep_cells(fl), seeds=SWEEP_SEEDS, rounds=SWEEP_ROUNDS,
        eval_every=SWEEP_EVAL, hidden=128, device="cuda")
    same_sweep = [[r.history for r in row] for row in res] == \
        sweep["histories"]
    out = {"sweep_bitwise": same_sweep}
    for n in PL_POPS:
        pop = make_population(0, n_clients=n, pool_samples=POP_POOL,
                              members_per_client=POP_MEMBERS)
        res = fl_driver.run_fl_population(
            pop, scale_config(n), seeds=POP_SEEDS, rounds=POP_ROUNDS,
            eval_every=POP_ROUNDS, device="cuda")
        want = next(r for r in population["populations"]
                    if r["n_clients"] == n)["histories"]
        out[f"population_{n}_bitwise"] = \
            [[r.history for r in row] for row in res] == want
    out["seconds"] = time.perf_counter() - t0
    print(f"  (c) one rank: phase 7b's grid bitwise {same_sweep}; phase 14's "
          + ", ".join(f"N={n:,} bitwise {out[f'population_{n}_bitwise']}"
                      for n in PL_POPS)
          + f" ({out['seconds']:.1f} s).  The lane and lane x client meshes "
          f"need two ranks or more: not run on the card (one card gives "
          f"one rank); their check is the gloo suite on the CPU  ({card})")
    check(all(v for k, v in out.items() if k.endswith("bitwise")),
          f"an engine's one-rank run differs from its phase: {out}")
    return out


def phase_parallel(torch, dpk, ref, card, fed, fl, sweep, population):
    """Phase 22: the client_parallel bundle (a), the LM round at 4 clients
    and K1 at its rows (b), the engines on one rank (c), on phase 21's
    world-size-1 group, taken down at the end."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    mesh = sh_meshes(torch)["single"]
    try:
        out = {"bundle": pl_bundle(torch, dpk, mesh, card)}
        out["round"] = pl_round(torch, dpk, card)
        rows = pl_k1(torch, dpk, ref, out["round"]["launches"], card)
        out["cut"] = pl_cut(torch, card)
        out["engines"] = pl_engines(torch, fed, fl, sweep, population, card)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 22: {out['seconds']:.1f} s")
    return out, rows


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
        "flash_attention_mma": check_fa_mma_ptxas(
            builds["flash_attention"]["log"]),
        "flash_decode": check_fd_ptxas(builds["flash_decode"]["log"]),
        "rglru_scan": check_rg_ptxas(builds["rglru_scan"]["log"]),
        "sumsq_rows": check_sq_ptxas(builds["dp_clip_noise"]["log"]),
        # recorded, not gated: the f32 row kernel is known to spill at
        # DMAX 128 (no timed path runs it)
        "flash_attention_row": ptxas_report(builds["flash_attention"]["log"],
                                            FA_ROW_KERNEL_NAME,
                                            "flash_attention_row_kernel")}

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

    print(f"== 7b. sweep engine: run_fl_sweep, paper config, ε "
          f"{SWEEP_EPS} x seeds 0-{SWEEP_SEEDS[-1]}, {SWEEP_ROUNDS} rounds  "
          f"({card})")
    sweep = phase_sweep(torch, fed, fl, dpk, accounted_epsilon, walls)
    sweep["card_vs_cpu_max_abs"] = phase_sweep_card_vs_cpu(torch, dpk)
    sweep["profile"] = phase_sweep_profile(torch, fed, fl)
    kernels += phase_sweep_kernels(torch, dpk, ref, sweep["launches"])

    print("== 8. sequence kernels vs plain versions on the card")
    errs.update(phase_seq_kernels_vs_plain(torch, fak, fdk, rgk, ref, ops))

    print(f"== 9. serving path: {', '.join(SERVE_MODELS)} on road_raw, hidden "
          f"64, buckets {SERVE_BUCKETS}  ({card})")
    road = make_federated(0, "road_raw", n_samples=6000, n_clients=20)
    serve = {}
    for name in SERVE_MODELS:
        serve[name] = phase_serve(torch, name, road, (fak, fdk, rgk))
    serve_launches = {
        "flash_attention": serve["attn"]["launches"]["flash_attention"],
        "flash_decode": serve["attn"]["launches"]["flash_decode"],
        "rglru_scan": sum(serve[m]["launches"]["rglru_scan"]
                          for m in ("ssm", "rglru"))}

    print("== 10. sequence kernel times at the serving shapes (CUDA events)")
    floor_ms = launch_floor_ms(torch)
    print(f"  launch floor (add_ on a one-element tensor): device "
          f"{floor_ms * 1e3:.3f} us  ({card})")
    kernels += phase_seq_timing(torch, fak, fdk, rgk, ref, errs, serve)
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

    print(f"== 11. model grid: bench_models' full settings, 6 cells x seeds "
          f"0-{GRID_SEEDS[-1]}, {GRID_ROUNDS} rounds  ({card})")
    grid = {"cells": phase_model_grid(torch, (dpk, fak, fdk, rgk)),
            "card_vs_cpu_max_abs": phase_grid_card_vs_cpu(torch, dpk)}

    print(f"== 12. privacy frontier: bench_privacy's full settings, budgets "
          f"{PRIV_BUDGETS} x seeds 0-{PRIV_SEEDS[-1]}, adaptive, "
          f"{PRIV_ROUNDS} rounds  ({card})")
    privacy = phase_privacy_frontier(torch, dpk)
    privacy["card_vs_cpu"] = phase_privacy_card_vs_cpu(torch, dpk)

    print(f"== 13. plan frontier: bench_async's full settings, "
          f"{len(PLAN_VARIANTS)} plans x {len(FAULT_LANES)} fault lanes x "
          f"seeds 0-{ASYNC_SEEDS[-1]}, {ASYNC_ROUNDS} rounds  ({card})")
    plans = phase_plan_frontier(torch, dpk, ref, card)
    plans["card_vs_cpu_max_abs"] = phase_plan_card_vs_cpu(torch, dpk)
    p_mlp = param_count("unsw", 64)
    plans["dp_rows"] = check_dp_rows(
        torch, dpk, ref, plans["lanes"] * ASYNC_CLIENTS, p_mlp,
        "plan frontier")

    print(f"== 14. population: bench_scale's full settings at "
          f"{', '.join(f'{n:,}' for n in POP_SIZES)} clients, k_max "
          f"{POP_KMAX}, seeds 0-{POP_SEEDS[-1]}, {POP_ROUNDS} rounds  ({card})")
    population = phase_population(torch, dpk, card)
    population["cohort_topk"] = phase_cohort_topk(torch)
    population["card_vs_cpu_max_abs"] = phase_cohort_card_vs_cpu(torch, dpk)
    population["dp_rows"] = check_dp_rows(
        torch, dpk, ref, len(POP_SEEDS) * POP_KMAX, p_mlp, "population")
    for k in kernels:
        if k["name"] in ("sumsq_rows", "scale_noise_rows"):
            k["launches_plan_frontier"] = plans["launches"][k["name"]]
            k["launches_population_1e6"] = \
                population["populations"][-1]["launches"][k["name"]]

    print(f"== 15. LM serving path: {LM_ARCH} at full width and depth (bf16), "
          f"prefill {LM_PREFILL} on flash_attention, prefill_scan + "
          f"{LM_NEW} greedy tokens  ({card})")
    with torch.no_grad():
        lm, lm_rows = phase_lm(torch, fak, ref, card,
                               ptxas["flash_attention_mma"])
    kernels += lm_rows

    print(f"== 16. FL operations: the FL CLI at its defaults (traced), "
          f"tracer neutrality, Checkpointer, personalised heads, the own-RNG "
          f"check  ({card})")
    fl_ops, cli_res, cli_fed, cli_fl = phase_fl_cli(torch, dpk, card)
    fl_ops["tracer"] = phase_tracer_neutral(torch, cli_fed, cli_fl, card)
    fl_ops["checkpointer"] = phase_checkpointer(torch, cli_fed, cli_fl, card)
    fl_ops["personalized"] = phase_personalized(torch, cli_fed,
                                                cli_res.params, card)
    fl_ops["rng_check"] = phase_rng_check(torch, dpk, ref, cli_fed, cli_fl,
                                          card)
    for k in kernels:
        if k["name"] in ("sumsq_rows", "scale_noise_rows"):
            k["launches_fl_cli"] = fl_ops["launches"][k["name"]]
            k["launches_rng_check"] = \
                fl_ops["rng_check"]["launches"][k["name"]]

    print(f"== 17. LM training: the train CLI's defaults with --dp on "
          f"{LM_ARCH} at full width, {LMT_LAYERS} layers (cut from 40), "
          f"bf16, {LMT_ROUNDS} rounds  ({card})")
    lm_train, lm_train_rows = phase_lm_train(torch, dpk, ref, card)
    kernels += lm_train_rows
    for k in kernels:
        if k["name"] in ("sumsq_rows", "scale_noise_rows"):
            k["launches_lm_train"] = lm_train["launches"][k["name"]]

    print(f"== 18. recurrent LMs: {REC_ARCH} (prefill on rglru_scan and "
          f"flash_attention, serve path) and {SSD_ARCH} (the serve CLI at "
          f"--full), full width and depth, bf16  ({card})")
    with torch.no_grad():
        rec_lm, rec_rows = phase_recurrent_lm(torch, fak, rgk, ref, card,
                                              ptxas)
    kernels += rec_rows

    print(f"== 19. the remaining families at full width, bf16: "
          f"{FAM_QWEN} (whole), {FAM_MOE} ({FAM_LAYERS[FAM_MOE]} layers, "
          f"both dispatches), {FAM_VL} ({FAM_LAYERS[FAM_VL]} layers, stub "
          f"patches on M-RoPE), {FAM_ED} (whole), {FAM_MISTRAL} "
          f"({FAM_LAYERS[FAM_MISTRAL]} layers), {FAM_LLAMA4} "
          f"({FAM_LAYERS[FAM_LLAMA4]} layers, both dispatches)  ({card})")
    with torch.no_grad():
        families, fam_rows = phase_families(torch, fak, ref, card, ptxas)
    kernels += fam_rows
    for k in kernels:
        if k["name"] == "flash_attention_lm_granite":
            k["launches_phi3p5_moe"] = \
                families[FAM_MOE]["prefill_einsum"]["launches"]
        if k["name"] == "flash_attention_lm_qwen2p5":
            k["launches_llama4"] = \
                families[FAM_LLAMA4]["prefill_einsum"]["launches"]

    print(f"== 20. LM training of the MoE, VLM and encoder-decoder "
          f"families: the train CLI's defaults with --dp on {FAM_MOE} "
          f"({TF_CUTS[FAM_MOE][0]} layers), {FAM_VL} ({TF_CUTS[FAM_VL][0]} "
          f"layer, stub patches) and {FAM_ED} (whole, stub frames), bf16, "
          f"{LMT_ROUNDS} rounds each  ({card})")
    train_families, tf_rows = phase_train_families(torch, dpk, ref, card)
    kernels += tf_rows

    print(f"== 21. sharding: the prefill, decode and serial train bundles "
          f"on one-device meshes against the unsharded path, and the "
          f"dry-run of {', '.join(sorted({a for a, _ in SH_DRY}))} on a "
          f"fake 16 x 16 group  ({card})")
    sharding = phase_sharding(torch, dpk, card)

    print(f"== 22. the client_parallel round on {LM_ARCH} ({LMT_LAYERS} "
          f"layers, bf16, clipped DP): its train bundle on the (1, 1) mesh "
          f"against the unsharded round, the round at {PL_CLIENTS} clients "
          f"and K1 at its rows, a {PL_CUT}-layer f32 cut card vs CPU, the "
          f"sweep and population engines on one rank  ({card})")
    parallel, pl_rows = phase_parallel(torch, dpk, ref, card, fed, fl, sweep,
                                       population)
    kernels += pl_rows

    steady = walls[1:]
    record = {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": {lib: info["seconds"] for lib, info in builds.items()},
        "ptxas": ptxas, "launch_floor_ms": floor_ms, "kernels": kernels,
        "round_wall_ms": walls, "profile": profile,
        "round_wall_ms_median_after_first": statistics.median(steady),
        "history": res.history, "eps_spent": res.eps_spent, "sweep": sweep,
        "serve": serve, "serve_launches": serve_launches,
        "model_grid": grid, "privacy": privacy, "plan_frontier": plans,
        "population": population, "lm": lm, "fl_ops": fl_ops,
        "lm_train": lm_train, "recurrent_lm": rec_lm, "families": families,
        "train_families": train_families,
        "sharding": sharding, "parallel": parallel,
        "total_s": time.perf_counter() - t_all,
    }
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
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
