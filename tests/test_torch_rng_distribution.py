"""The own-RNG distribution check: the port drawing from its own
``torch.Generator``s (no draws bundle) against the JAX reference, by the
paper's own test, at the FL CLI's defaults (``launch/fl_train.py``:
unsw, 12,000 samples, 40 clients, α 0.5, ``mlp`` at hidden 64, K₀ = 8
adaptive, 5 local epochs × 32, clipped DP at ε 50 and clip 5, iid failures
0.05 with checkpoint recovery, 100 rounds, eval every 5).

Torch cannot reproduce JAX's threefry stream, so without the reference's
draws fed in the two packages agree in distribution, not in bits.  The
reference side, ``repro.train.fl_driver.run_fl_batch`` at seeds 0-9, is
written once to ``tests/golden/torch_rng_reference.json`` (the card has no
JAX, so ``chip_smoke.py`` reads the same file):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_rng_distribution.py --write

The gate, here on the CPU and in ``chip_smoke.py`` on the card: a
two-sided Mann-Whitney p >= 0.01 on the per-seed final accuracy, and every
seed's ``eps_spent`` within 1e-9 of the reference's.  The paper's α = 0.05
verdict and the AUC and mean-K tests are printed, not gated: at 0.01 a
correct port fails 1 run in 100, not 1 in 20.  The seeds, rounds and data
are fixed.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.data import synthetic as j_syn
from repro.train import fl_driver as j_fl_driver

from repro_torch.launch import fl_train as t_fl_train
from repro_torch.stats import compare_finals
from repro_torch.train import fl_driver as t_fl_driver

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden" / \
    "torch_rng_reference.json"
SEEDS = tuple(range(10))
P_GATE = 0.01
EPS_TOL = 1e-9


def _cli():
    """The CLI's defaults: its parsed args, ``(fed, FLConfig,
    eval_every)`` in the port, and the reference's ``(fed, FLConfig)``."""
    args = t_fl_train.parse_args([])
    fed, fl, eval_every = t_fl_train.cli_config(args)
    j_fed = j_syn.make_federated(args.seed, args.dataset,
                                 n_samples=args.samples,
                                 n_clients=args.clients, alpha=args.alpha)
    j_fl = JFLConfig(**{k: getattr(fl, k) for k in
                        JFLConfig.__dataclass_fields__})
    return args, fed, fl, eval_every, j_fed, j_fl


def _row(res) -> dict:
    return {"seed": int(res.seed), "accuracy": float(res.accuracy),
            "auc": float(res.auc),
            "mean_k": float(np.mean(res.history["k"])),
            "eps_spent": float(res.eps_spent)}


def reference_rows(seeds):
    """The reference's per-seed finals at the CLI's defaults."""
    args, _, _, eval_every, j_fed, j_fl = _cli()
    res = j_fl_driver.run_fl_batch(j_fed, j_fl, args.method, seeds=seeds,
                                   rounds=args.rounds, eval_every=eval_every,
                                   dataset=args.dataset)
    return [_row(r) for r in res]


def write_golden() -> dict:
    args, _, fl, eval_every, _, _ = _cli()
    golden = {
        "what": "repro.train.fl_driver.run_fl_batch at the FL CLI's "
                "defaults (JAX on the CPU), one lane a seed",
        "config": {"dataset": args.dataset, "data_seed": args.seed,
                   "n_samples": args.samples, "n_clients": args.clients,
                   "alpha": args.alpha, "method": args.method,
                   "rounds": args.rounds, "eval_every": eval_every,
                   "hidden": 64, "seeds": list(SEEDS),
                   "fl": {k: getattr(fl, k) for k in
                          JFLConfig.__dataclass_fields__}},
        "rows": reference_rows(SEEDS),
    }
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    return golden


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_matches_the_cli_config_and_one_recomputed_seed(golden):
    """The golden file is not stale: its config is the CLI's, and one seed
    recomputed by the reference equals it within 1e-6."""
    args, _, fl, eval_every, _, _ = _cli()
    cfg = golden["config"]
    assert cfg["fl"] == {k: getattr(fl, k) for k in
                         JFLConfig.__dataclass_fields__}
    assert (cfg["rounds"], cfg["eval_every"], cfg["n_samples"],
            cfg["n_clients"], cfg["seeds"]) == (
        args.rounds, eval_every, args.samples, args.clients, list(SEEDS))
    (row,) = reference_rows((3,))
    want = golden["rows"][3]
    assert row["seed"] == want["seed"] == 3
    for k in ("accuracy", "auc", "mean_k", "eps_spent"):
        assert abs(row[k] - want[k]) <= 1e-6, (k, row[k], want[k])


def test_own_rng_port_matches_the_reference_in_distribution(golden):
    """``run_fl_batch(device="cpu")`` on the port's own generators, seeds
    0-9: two-sided Mann-Whitney p >= 0.01 on final accuracy against the
    reference, ε within 1e-9."""
    args, fed, fl, eval_every, _, _ = _cli()
    res = t_fl_driver.run_fl_batch(fed, fl, args.method, seeds=SEEDS,
                                   rounds=args.rounds, eval_every=eval_every,
                                   dataset=args.dataset, device="cpu")
    rows = [_row(r) for r in res]
    assert all(np.isfinite(r["accuracy"]) and np.isfinite(r["auc"])
               for r in rows)
    ref = golden["rows"]
    finals = compare_finals(rows, ref)     # key: (median, ref median, p)
    eps_err = max(abs(a["eps_spent"] - b["eps_spent"])
                  for a, b in zip(rows, ref))
    print(f"own-RNG check (CPU): {finals}; paper's alpha 0.05 differs: "
          f"{finals['accuracy'][2] < 0.05}; eps max|err| {eps_err:.3e}")
    assert eps_err <= EPS_TOL, eps_err
    assert finals["accuracy"][2] >= P_GATE, finals


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help=f"write {GOLDEN.name} from the reference")
    if not ap.parse_args().write:
        ap.print_help()
        sys.exit(2)
    print(json.dumps(write_golden()["rows"], indent=1))
