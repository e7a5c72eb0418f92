"""Multi-pod dry-run: the port's counterpart of ``repro/launch/dryrun.py``.

For every (architecture × input shape) and both production meshes (16×16
single-pod, 2×16×16 multi-pod) this:

  1. sets up a fake process group of 256 or 512 ranks in this process
     (``torch.testing._internal.distributed.fake_pg``: collectives return
     at once and move nothing) and the ``DeviceMesh`` over it, as rank 0;
  2. builds the step (FL train round / serve prefill / serve decode) with
     its placements (``launch/steps.py``);
  3. makes every input a DTensor over an empty local shard under a
     ``FakeTensorMode`` (nothing is allocated) and runs the step's ``fn``
     once;
  4. records, per rank, from the local shards: argument and output bytes
     (exact), an estimated peak, flops, and the collectives DTensor
     issued, into ``dryrun_out/<arch>__<shape>__<mesh>.json`` (git-ignored).

Counting (:func:`counting`, a ``FakeTensorMode`` that sees every op on the
local shards): flops by ``torch.utils.flop_counter``'s formulas on the
local shapes; collective bytes by the reference's convention (the result
bytes of each ``_c10d_functional`` all-gather, all-reduce, reduce-scatter
and all-to-all: an all-gather counts the gathered size, an all-reduce its
buffer once); the peak as the argument bytes plus the most bytes of op
results alive at once (each result's local bytes from its creation until
the tensor is freed; views and in-place results add nothing; no allocator
rounding or fragmentation).  The ops DTensor runs on global-shape fake
tensors to infer an output's shape are not counted.  All of these are
counts from fake tensors, not measurements.  On a CPU mesh DTensor turns
an all-to-all into an all-gather and a chunk, so a resharding that a
card's group would do by all-to-all counts as an all-gather here.

Every pair builds, the ``client_parallel`` train rounds (clients across
the data ranks) as the ``client_serial`` ones; any failure exits 1.

Usage:
  python -m repro_torch.launch.dryrun --arch granite_3_8b --shape prefill_32k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, MeshConfig,
                                      get_arch, get_shape)
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import H100, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                       "..", "dryrun_out")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

PEAK_METHOD = ("argument bytes + the most local result bytes alive at once "
               "(fake-tensor op results tracked until freed; views and "
               "in-place results excluded; no allocator rounding)")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t)
               for t in _tensors(tree))


@contextlib.contextmanager
def counting():
    """A ``FakeTensorMode`` that counts what it runs on local shards
    (:class:`_Counter`), with DTensor's shape inference marked so that its
    global-shape ops are not counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if not hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached"):
        raise RuntimeError(
            "this torch's DTensor infers shapes elsewhere: the counter "
            "cannot tell its shape inference from the local ops")
    counter = _counter()
    original = ShardingPropagator._propagate_tensor_meta_non_cached

    def inferring(self, *a, **k):
        counter.inferring += 1
        try:
            return original(self, *a, **k)
        finally:
            counter.inferring -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = inferring
    try:
        with counter:
            yield counter
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = original


def _counter():
    from torch._subclasses.fake_tensor import (FakeTensor, FakeTensorMode,
                                               unset_fake_temporarily)
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    registry = FlopCounterMode(display=False).flop_registry

    class _Counter(FakeTensorMode):
        def __init__(self):
            super().__init__(allow_non_fake_inputs=True)
            self.flops = 0
            self.coll = {c: 0.0 for c in COLLECTIVES}
            self.counts = {c: 0 for c in COLLECTIVES}
            self.live = 0
            self.peak = 0
            self.inferring = 0
            self._seen = set()

        def _track(self, t):
            if t._is_view() or id(t) in self._seen:
                return
            n = _nbytes(t)
            self._seen.add(id(t))
            self.live += n
            self.peak = max(self.peak, self.live)
            key = id(t)

            def free(counter=self, n=n, key=key):
                counter.live -= n
                counter._seen.discard(key)

            weakref.finalize(t, free)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ts = list(_tensors((args, kwargs or {})))
            if ts and not any(isinstance(t, FakeTensor) for t in ts):
                # host-side work on real tensors (the mesh's coordinate
                # tables, the round's small selection state) runs for real
                with unset_fake_temporarily():
                    return func(*args, **(kwargs or {}))
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if self.inferring or any(issubclass(t, DTensor) for t in types):
                return out
            packet = func.overloadpacket
            if func.namespace == "_c10d_functional":
                kind = _KIND.get(packet.__name__)
                if kind is not None:
                    self.coll[kind] += sum(_nbytes(t) for t in _tensors(out))
                    self.counts[kind] += 1
            elif packet in registry:
                self.flops += registry[packet](
                    *args, **(kwargs or {}), out_val=out)
            for t in _tensors(out):
                self._track(t)
            return out

    return _Counter()


def setup_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks (this process rank 0),
    replacing one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs its own process: a "
                               f"{dist.get_backend()} group is set up")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=world_size,
                            rank=0)


def _quiet_dtensor_logs() -> None:
    for name in ("torch.distributed.tensor._redistribute",
                 "torch._logging._internal"):
        logging.getLogger(name).setLevel(logging.ERROR)


def _train_state(bundle, params, mesh):
    from repro_torch.core import rounds as rounds_lib
    fl = bundle.meta["fl"]
    gen = torch.Generator(device=mesh.device_type).manual_seed(0)
    return rounds_lib.init_serial_state(params, fl, gen,
                                        n_clients=bundle.meta["n_clients"])


def measure(bundle, mesh, mode: str) -> dict:
    """Run ``bundle.fn`` once on fake local shards of its inputs under the
    counter: per-rank argument, output and peak bytes, flops and
    collectives."""
    with counting() as counter:
        args = [steps_lib.abstract_inputs(spec, sh, mesh)
                if sh is not None else spec
                for spec, sh in zip(bundle.in_specs, bundle.in_shardings)]
        if mode == "decode":
            args[-1] = bundle.meta["index"]
        if mode == "train":
            args[0] = _train_state(bundle, args[0], mesh)
        arg_bytes = _local_bytes(args)
        counter.live = counter.peak = 0
        t0 = time.time()
        out = bundle.fn(*args)
        t_run = time.time() - t0
        out_bytes = _local_bytes(out)
    total = sum(counter.coll.values())
    return {
        "run_s": t_run,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "peak_bytes": arg_bytes + counter.peak,
            "peak_method": PEAK_METHOD,
        },
        "cost": {"flops": float(counter.flops)},
        "collectives": {**counter.coll, "total": total,
                        "counts": dict(counter.counts)},
    }


def run_one(arch: str, shape_name: str, mesh_kind: str, *, save: bool = True,
            step_kw=None, tag: str = "", out_dir: Optional[str] = None) -> dict:
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    mesh_cfg = MeshConfig(multi_pod=(mesh_kind == "multi"))
    setup_fake_group(mesh_cfg.n_devices)
    _quiet_dtensor_logs()
    mesh = make_production_mesh(multi_pod=mesh_cfg.multi_pod, device_type="cpu")

    t0 = time.time()
    bundle = steps_lib.build_step(cfg, shape, mesh_cfg, mesh, **(step_kw or {}))
    t_build = time.time() - t0
    m = measure(bundle, mesh, shape.mode)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "step": bundle.name,
        "meta": {k: v for k, v in bundle.meta.items() if k != "fl"},
        "devices": mesh_cfg.n_devices,
        "build_s": t_build,
        "torch": torch.__version__,
        "counts_from": "fake tensors (no data moved or computed)",
        **m,
        "model_params": cfg.param_count(),
        "model_active_params": cfg.active_param_count(),
        "fits_h100_80gb": m["memory"]["peak_bytes"] <= H100["hbm_bytes"],
    }
    if save:
        d = out_dir or OUT_DIR
        os.makedirs(d, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(d, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def _ok_line(r) -> str:
    return (f"[ok]   {r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} "
            f"run={r['run_s']:7.1f}s "
            f"flops={r['cost']['flops']:.3e} "
            f"args={r['memory']['argument_bytes'] / 1e9:.2f}GB "
            f"peak={r['memory']['peak_bytes'] / 1e9:.2f}GB "
            f"coll={r['collectives']['total'] / 1e9:.2f}GB "
            f"fits80={r['fits_h100_80gb']}")


def _run_parallel(todo, out_dir: str, jobs: int, failures) -> int:
    """Each pair in a process of its own (its own fake group), ``jobs`` at
    once, the train steps first (they take longest)."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    def one(task):
        arch, shape, mk = task
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mk, "--out-dir", out_dir],
            capture_output=True, text=True)
        return task, res

    order = sorted(todo, key=lambda t: get_shape(t[1]).mode != "train")
    built = 0
    with ThreadPoolExecutor(jobs) as pool:
        for (arch, shape, mk), res in pool.map(one, order):
            lines = [l for l in res.stdout.splitlines()
                     if l.startswith(("[ok]", "[FAIL]"))]
            print("\n".join(lines) or f"[FAIL] {arch} {shape} {mk}",
                  flush=True)
            if res.returncode == 0:
                built += 1
            else:
                failures.append((arch, shape, mk,
                                 (res.stdout + res.stderr)[-2000:]))
    return built


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="run the pairs in this many processes at once")
    args = ap.parse_args(argv)

    pairs = (
        [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
        if args.all
        else [(args.arch, args.shape)]
    )
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures, todo = [], []
    for mk in meshes:
        for arch, shape in pairs:
            path = os.path.join(args.out_dir, f"{arch}__{shape}__{mk}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {arch} {shape} {mk}")
                continue
            todo.append((arch, shape, mk))
    if args.jobs > 1 and len(todo) > 1:
        built = _run_parallel(todo, args.out_dir, args.jobs, failures)
    else:
        built = 0
        for arch, shape, mk in todo:
            try:
                r = run_one(arch, shape, mk, out_dir=args.out_dir)
                built += 1
                print(_ok_line(r), flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, shape, mk, repr(e)))
                print(f"[FAIL] {arch} {shape} {mk}: {e}", flush=True)
                traceback.print_exc()
    print(f"\n{built} built, {len(failures)} failed")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nALL BUILT DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
