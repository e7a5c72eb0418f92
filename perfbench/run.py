"""Run one cell of the benchmark of the PyTorch port (``repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix,
limits and per-layer metric readers are found by the names in
``BENCHMARK.json`` (``harness/cells.py``); the traffic's ``kind`` picks
the run (``harness/fl.py`` for federated training, ``harness/prefill.py``
for serving).  With ``--trace 0`` the last line of standard output
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
ones, read from a ``torch.profiler`` trace of the window
(``harness/report.py``).  Exits 2 and prints no result without as many
CUDA devices as the cell asks for.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench.harness import cells, report  # noqa: E402

KINDS = ("fl_rounds", "prefill_closed")


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None) -> report.Result:
    """One run of ``cell``: set-up, window, then the comparison with the
    reference."""
    from perfbench.harness import fl, prefill
    kind = cell.traffic["kind"]
    if kind not in KINDS:
        raise ValueError(f"traffic kind {kind!r}: one of {KINDS}")
    drive = fl.run if kind == "fl_rounds" else prefill.run
    return drive(cell, seed, seconds, trace, device,
                 time.perf_counter() if t_start is None else t_start,
                 cells.readers(cell) if trace else {})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")
    cell = cells.find(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    return report.emit(res, wanted, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
