"""The readings that the limits on ``correct`` are set from, at a cell's
own size, several seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--program 1] [--control 1]

For each seed, with ``--program 1``: a sound run of the program (a
window of ``--seconds``: one round at 0; a prefill run needs 2 s to serve
every pool batch) and its numbers against the reference (the lower
readings).  With ``--control 1``: the control, the reference
itself computed with float8 products (``reference/lm.py``) in the
program's place, and the planted faults, each judged against the float32
reference on the same inputs (the upper readings).  Training cells: a
step that returns its state unchanged (its numbers need no run: the
program's change is nought), half of each batch left out (the loss the
mean over the other half), the clip skipped, the clean updates left out
of the aggregate (the noise alone) and, of a MoE, each token's last
expert choice moved to its next-best.  Of a MoE each variant records its
first round's expert choices, and the float32 reference that judges it
follows them, as it follows the program's in a run.  The prefill cell:
each served token altered (the next id), half of each batch left out
(its tokens never computed: id 0).  One JSON line a seed and kind; ``--out`` also appends them to a
file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench.harness import cells, check, traffic  # noqa: E402
from perfbench.reference import fl as ref_fl  # noqa: E402
from perfbench.reference import layout  # noqa: E402


VARIANTS = (("control_fp8", {"precision": "fp8"}),
            ("fault_half_batch", {"fault": "half_batch"}),
            ("fault_no_clip", {"fault": "no_clip"}),
            ("fault_noise_only", {"fault": "noise_only"}))
MOE_VARIANTS = (("fault_route_shift", {"fault": "route_shift"}),)


def train_readings(cell, seed: int, device, variants=None) -> dict:
    """Each variant of the reference in the program's place (``VARIANTS``,
    and of a MoE ``MOE_VARIANTS``, where not given), and a state left
    unchanged, judged by the float32 reference: one for all, or of a MoE
    one a variant that follows the variant's first-round expert
    choices."""
    m, t = cell.config["model"], cell.traffic
    f = t["fl"]
    moe = layout.block_kind(m) == "moe"
    if variants is None:
        variants = VARIANTS + (MOE_VARIANTS if moe else ())
    lv = layout.leaves(m)
    pool = traffic.fl_pool(t, m["vocab_size"], seed, device)

    def follow(**kw):
        return ref_fl.run_rounds(
            m, f, lv, layout.make_weights(lv, seed, device),
            batch=lambda r: (pool.batch(r)["tokens"], pool.batch(r)["labels"]),
            variates=pool.variates, noise_seed=layout.sub_seed(seed, "noise"),
            rounds=t["check_rounds"], **kw)

    def numbers(g, ref, name):
        return dict(check.train_numbers(g, ref, name),
                    detail=check.train_detail(g, ref, name))

    w0 = {k: v.cpu() for k, v in layout.make_weights(lv, seed, device).items()}
    # judged by the reference on its own routing: the state left unchanged,
    # and every variant of a dense model
    shared = {"fault_state_unchanged": [w0] * t["check_rounds"]}
    got, out = {}, {}
    for name, kw in variants:
        g = follow(keep=True, record=moe, **kw)
        if moe:  # judged at once, so one variant's states are held at a time
            out[name] = numbers(g, follow(judge={name: g.pop("states")},
                                          replay=g.pop("route")), name)
        else:
            shared[name], got[name] = g.pop("states"), g
    ref = follow(judge=shared)
    unchanged = dict(ref, change1=[0.0] * len(lv), change=[0.0] * len(lv))
    out = {"fault_state_unchanged": check.train_numbers(
        unchanged, ref, "fault_state_unchanged"), **out}
    for name, g in got.items():
        out[name] = numbers(g, ref, name)
    return out


def prefill_readings(cell, seed: int, device) -> dict:
    from perfbench.harness.prefill import reference_logits
    m, t = cell.config["model"], cell.traffic
    lv = layout.leaves(m)
    pool = traffic.prompt_pool(t, m["vocab_size"], seed, device)
    keys = {(length, j) for length in pool.lengths
            for j in range(t["pool_batches"])}
    ref = reference_logits(m, lv, seed, pool, keys, device)
    low = reference_logits(m, lv, seed, pool, keys, device, precision="fp8")
    out = {"control_fp8": max(check.logit_gap(low[k].argmax(-1), ref[k])
                              for k in keys)}
    out["fault_token_altered"] = max(
        check.logit_gap((ref[k].argmax(-1) + 1) % m["vocab_size"], ref[k])
        for k in keys)
    half = {}
    for k in keys:
        tok = ref[k].argmax(-1).clone()
        tok[tok.shape[0] // 2:] = 0
        half[k] = check.logit_gap(tok, ref[k])
    out["fault_half_batch"] = max(half.values())
    return {k: {"logit_gap": v} for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="the program's window (a prefill run's has to "
                         "serve every pool batch: 2 s)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench.run import run_cell
    cell = cells.find(args.workload)
    kind = cell.traffic["kind"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        rows = []
        if args.program:
            t0 = time.perf_counter()
            res = run_cell(cell, seed, args.seconds, False, args.device)
            rows.append({"kind": "program",
                         "numbers": {k: v for k, (v, _) in res.checks.items()},
                         "metrics": res.metrics})
            rows[-1]["seconds"] = time.perf_counter() - t0
        if args.control:
            t0 = time.perf_counter()
            read = train_readings if kind == "fl_rounds" else prefill_readings
            for name, numbers in read(cell, seed, args.device).items():
                rows.append({"kind": name, "numbers": numbers})
            rows[-1]["seconds"] = time.perf_counter() - t0
        for row in rows:
            row.update(cell=args.workload, seed=seed)
            text = json.dumps(row)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
