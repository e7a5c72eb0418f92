"""CLI: stream-score a test federation through the port's serving engine.

PYTHONPATH=src python -m repro_torch.serve \\
    --model attn --dataset road_raw --ckpt ckpt/serve_attn_road_raw \\
    [--buckets 16,128] [--route kernel|ref] [--rounds 30] [--chunk 37] \\
    [--device cuda|cpu]

Train-if-missing: when ``--ckpt`` does not exist yet, a short federated run
trains the detector and ``save_serving_checkpoint`` persists it; later
invocations go straight from checkpoint to traffic.  It trains with
``run_fl(..., return_params=True)`` (the sweep engine, one lane; same
``FLConfig`` and method ``"random"`` as the reference's CLI).  The stream
is the federation's test windows replayed in ``--chunk``-sized
arrival bursts, which the engine rebatches into its static buckets.
"""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import make_federated
from repro_torch.models.spec import meta_for
from repro_torch.obs import profile_trace
from repro_torch.serve.engine import ServeEngine, save_serving_checkpoint
from repro_torch.train.fl_driver import run_fl


def _train_checkpoint(args) -> str:
    fed = make_federated(args.seed, args.dataset, n_samples=args.samples,
                         n_clients=args.clients)
    fl = FLConfig(n_clients=args.clients,
                  clients_per_round=max(4, args.clients // 5),
                  rounds=args.rounds, local_epochs=2, local_batch=32,
                  local_lr=0.08, dp_enabled=False, fault_tolerance=False,
                  model=args.model)
    res = run_fl(fed, fl, "random", seed=args.seed, rounds=args.rounds,
                 eval_every=max(args.rounds // 4, 1), dataset=args.dataset,
                 hidden=args.hidden, return_params=True, device=args.device)
    print(f"trained {args.model}/{args.dataset}: acc={res.accuracy*100:.1f}% "
          f"auc={res.auc:.3f}")
    return save_serving_checkpoint(args.ckpt, res.params, args.model,
                                   meta_for(fed, hidden=args.hidden))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="mlp")
    ap.add_argument("--dataset", choices=["unsw", "road", "road_raw"],
                    default="unsw")
    ap.add_argument("--ckpt", default=None,
                    help="serving checkpoint path (default "
                         "ckpt/serve_<model>_<dataset>)")
    ap.add_argument("--buckets", default="16,128",
                    help="comma-separated static batch buckets")
    ap.add_argument("--route", choices=["kernel", "ref"], default=None,
                    help="score-path kernels for sequence models "
                         "(default: kernel)")
    ap.add_argument("--rounds", type=int, default=30,
                    help="training rounds when the checkpoint is missing")
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--samples", type=int, default=6_000)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=37,
                    help="windows per simulated arrival burst")
    ap.add_argument("--repeat", type=int, default=4,
                    help="replays of the test set through the stream")
    ap.add_argument("--client", type=int, default=None,
                    help="score with this client's personalized params")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--profile", nargs="?", const="profiles/serve",
                    default=None, metavar="LOGDIR",
                    help="write a torch.profiler Chrome trace of the "
                         "scoring stream to LOGDIR/trace.json "
                         "(default profiles/serve)")
    args = ap.parse_args(argv)
    if args.ckpt is None:
        args.ckpt = f"ckpt/serve_{args.model}_{args.dataset}"

    npz = args.ckpt if args.ckpt.endswith(".npz") else args.ckpt + ".npz"
    if not os.path.exists(npz):
        print(f"no checkpoint at {npz}; training one")
        _train_checkpoint(args)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    eng = ServeEngine.from_checkpoint(args.ckpt, buckets=buckets,
                                      route=args.route, device=args.device)
    eng.warmup()

    fed = make_federated(args.seed, args.dataset, n_samples=args.samples,
                         n_clients=args.clients)
    windows = np.asarray(fed.test_x, np.float32)

    def stream():
        for _ in range(args.repeat):
            for i in range(0, windows.shape[0], args.chunk):
                yield windows[i:i + args.chunk]

    prof = (profile_trace(args.profile) if args.profile
            else contextlib.nullcontext())
    with prof:
        report = eng.score_stream(stream(), client=args.client)
    if args.profile:
        print(f"profiler trace written to {args.profile}/trace.json")
    print(f"model={eng.spec.name} route={eng.route} buckets={eng.buckets} "
          f"device={eng.device} ckpt={npz}")
    print(f"scored {report.n_windows} windows in {report.n_batches} batches: "
          f"{report.windows_per_sec:,.0f} windows/s  "
          f"p50={report.p50_s*1e3:.3f}ms  p99={report.p99_s*1e3:.3f}ms")
    print(f"anomaly-score mean={report.scores.mean():.4f} "
          f"min={report.scores.min():.4f} max={report.scores.max():.4f}")
    return report


if __name__ == "__main__":
    main()
