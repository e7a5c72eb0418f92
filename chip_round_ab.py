#!/usr/bin/env python3
"""Time the sweep engine's warm round against an earlier tree's, on one
CUDA card.

Run from the repo root with the earlier tree unpacked under a git-ignored
directory, e.g. that of commit 82784bd (the lane step before plan codes 1
and 2):

    mkdir -p .archive/parent
    git archive 82784bd | tar -x -C .archive/parent
    python3 chip_round_ab.py .archive/parent

The config is ``chip_smoke.py`` phase 7b's: the paper config over Fig. 3's
ε column × seeds 0-9 (40 lanes of 40 clients, all plan code 0), 20 rounds,
eval every 10, ``mlp`` at hidden 128.  Each side runs in a process of its
own with its tree's ``src`` first on the path, in turns (earlier, current,
current, earlier); a process makes one cold call and ``WARM`` warm calls of
``run_fl_sweep`` and reports the least warm wall a round.  Prints the card
and one JSON line, and writes ``chiprun_out/round_ab.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

WARM = 5


def child(src: str) -> None:
    """One side: the warm sweep round of the tree whose ``src`` is given."""
    sys.path.insert(0, src)
    import torch

    from repro_torch.configs.paper_mlp import paper_fl_config
    from repro_torch.data.synthetic import make_federated
    from repro_torch.train import fl_driver
    from repro_torch.train.fl_driver import fl_for_method

    import repro_torch
    cs.check(Path(repro_torch.__file__).resolve().is_relative_to(
        Path(src).resolve()), f"imported {repro_torch.__file__}, not {src}")
    fed = make_federated(0, "unsw")
    fl = fl_for_method(paper_fl_config(), "proposed")
    kw = dict(seeds=cs.SWEEP_SEEDS, rounds=cs.SWEEP_ROUNDS,
              eval_every=cs.SWEEP_EVAL, hidden=128, device="cuda")
    cells = cs.sweep_cells(fl)
    fl_driver.run_fl_sweep(fed, fl, cells, **kw)
    walls = []
    for _ in range(WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fl_driver.run_fl_sweep(fed, fl, cells, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / cs.SWEEP_ROUNDS)
    print(json.dumps({"src": src, "warm_ms_per_round": walls,
                      "min_ms_per_round": min(walls)}))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sides = {"earlier": str(Path(sys.argv[1]).resolve() / "src"),
             "current": str(cs.ROOT / "src")}
    card = cs.card_line()
    runs = []
    for side in ("earlier", "current", "current", "earlier"):
        out = subprocess.run(
            [sys.executable, __file__, "--child", sides[side]],
            capture_output=True, text=True, cwd=cs.ROOT)
        cs.check(out.returncode == 0, f"{side} failed:\n{out.stderr}")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append({"side": side, **run})
        print(f"  {side}: warm sweep round {run['min_ms_per_round']:.2f} ms "
              f"(min of {run['warm_ms_per_round']})  ({card})")
    record = {"card": card, "config": "chip_smoke phase 7b", "runs": runs}
    out_dir = cs.ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "round_ab.json").write_text(json.dumps(record, indent=1))
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
