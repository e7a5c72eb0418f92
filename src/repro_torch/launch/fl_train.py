"""CLI: federated training for the paper's anomaly-detection use case — the
port's copy of ``repro/launch/fl_train.py``.

PYTHONPATH=src python -m repro_torch.launch.fl_train \\
    --dataset unsw --method proposed --rounds 100 --clients 40 \\
    [--no-dp] [--no-ft] [--eps 50] [--device cuda|cpu]

The reference's flags, defaults, ``FLConfig``, printed lines and
``--json-out`` (``dataclasses.asdict`` of the :class:`RunResult`, its
``params`` null), plus ``--device``: the card unless ``cpu`` is asked,
raising without one.  It trains through ``run_fl`` (the sweep engine, one
lane).  Called in-process, :func:`main` returns the result with the final
global params attached, on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import make_federated
from repro_torch.device import resolve_device
from repro_torch.train.fl_driver import METHODS, run_fl


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["unsw", "road"], default="unsw")
    ap.add_argument("--method", choices=METHODS, default="proposed")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--samples", type=int, default=12_000)
    ap.add_argument("--local-epochs", type=int, default=5)
    ap.add_argument("--eps", type=float, default=50.0)
    ap.add_argument("--clip", type=float, default=5.0)
    ap.add_argument("--no-dp", action="store_true")
    ap.add_argument("--no-ft", action="store_true")
    ap.add_argument("--fail-prob", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--alpha", type=float, default=0.5, help="Dirichlet non-IID")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    return ap.parse_args(argv)


def cli_config(args: argparse.Namespace):
    """The CLI's ``(fed, FLConfig, eval_every)`` for parsed ``args``."""
    fed = make_federated(args.seed, args.dataset, n_samples=args.samples,
                         n_clients=args.clients, alpha=args.alpha)
    fl = FLConfig(
        n_clients=args.clients, clients_per_round=max(4, args.clients // 5),
        rounds=args.rounds, local_epochs=args.local_epochs, local_batch=32,
        local_lr=0.08, dp_enabled=not args.no_dp, dp_mode="clipped",
        dp_epsilon=args.eps, dp_clip=args.clip,
        fault_tolerance=not args.no_ft, failure_prob=args.fail_prob,
    )
    return fed, fl, max(args.rounds // 20, 1)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    fed, fl, eval_every = cli_config(args)
    res = run_fl(fed, fl, args.method, seed=args.seed, rounds=args.rounds,
                 eval_every=eval_every, dataset=args.dataset,
                 return_params=True, device=device)
    print(f"\n{args.method} on {args.dataset}: acc={res.accuracy*100:.1f}% "
          f"auc={res.auc:.3f} sim_time={res.sim_time_s:.1f}s "
          f"eps_spent={res.eps_spent:.1f} wall={res.wall_time_s:.1f}s")
    for r, a, u, k in zip(res.history["round"], res.history["acc"],
                          res.history["auc"], res.history["k"]):
        print(f"  round {r:4d}: acc={a*100:5.1f}% auc={u:.3f} K={k:.0f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(dataclasses.asdict(dataclasses.replace(res, params=None)),
                      f, indent=1)
        print(f"wrote {args.json_out}")
    return res


if __name__ == "__main__":
    main()
