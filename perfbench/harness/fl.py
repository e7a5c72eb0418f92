"""A training cell: federated rounds of an LM through the program's
``client_serial`` round, as ``launch/train.py`` builds it.

Set-up makes the weights, the data pool and the round variates from the
seed, builds the round step and its state once, and drives that state
through the traffic's ``check_rounds`` first rounds with the window's
own call and feed (they also warm every shape), keeping the stored
parameters after each on the host and, of a MoE, the program's expert
choices of every layer of every step of the first round
(:class:`ExpertChoices`), which the reference follows.  The window then runs
whole rounds on the same state until ``--seconds`` have passed, each
ending in a synchronise, as a training loop that reads its metrics
does.  ``train_tokens_per_s`` is every token of every slot's every
local step of the window's rounds over the window's seconds.  After the
window the program's state is freed and the plain reference follows the
first rounds from the same inputs (``harness/check.py``).
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

import torch
from torch.profiler import record_function

from perfbench.harness import check, report
from perfbench.harness import trace as trace_lib
from perfbench.harness import traffic as traffic_lib
from perfbench.reference import fl as ref_fl
from perfbench.reference import layout

SPANS = ("selection", "local_train", "dp_privatize", "aggregate")
WINDOW = "bench.window"


def model_config(config: dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**config["model"])


def check_layout(model, lv: List[layout.Leaf]) -> None:
    """The program's parameter tree is the layout the reference reads:
    the same paths in the same order, shapes and dtypes."""
    from repro_torch.tree import tree_leaves, tree_paths
    shapes = model.param_shapes()
    got = [(p, tuple(t.shape), t.dtype)
           for p, t in zip(tree_paths(shapes), tree_leaves(shapes))]
    want = [(x.path, x.shape, x.dtype) for x in lv]
    if got != want:
        raise RuntimeError(f"the program's parameter layout {got} is not "
                           f"the reference's {want}")


def fl_config(f: dict):
    """The train CLI's FLConfig for the traffic's ``fl`` settings, which it
    has to state as they are run."""
    from repro_torch.launch.train import train_fl_config
    fl = train_fl_config(f["clients"], f["slots"], f["local_steps"],
                         f["local_lr"], dp=True)
    expect = {"n_clients": f["clients"],
              "clients_per_round": f["clients_per_round"],
              "dp_epsilon": f["dp_epsilon"], "dp_delta": f["dp_delta"],
              "dp_clip": f["dp_clip"], "failure_prob": f["failure_prob"],
              "k_min": f["k_min"], "k_tol": f["k_tol"],
              "k_patience": f["k_patience"], "server_lr": f["server_lr"],
              "server_opt": "sgd", "dp_mode": "clipped", "dp_enabled": True,
              "adaptive_k": True, "fault_tolerance": True,
              "fault_process": 0.0, "dp_scheduled": False, "k_max": 0}
    wrong = {k: (getattr(fl, k), v) for k, v in expect.items()
             if getattr(fl, k) != v}
    if wrong:
        raise RuntimeError(f"the train CLI's FLConfig is not the traffic's: "
                           f"{wrong}")
    return fl


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def host_copy(params, lv) -> dict:
    """The program's stored parameters, ``{path: tensor}`` on the host (in
    page-locked memory from a card, which the reference reads back
    fastest)."""
    out = {}
    for x in lv:
        t = _at(params, x.path)
        out[x.path] = torch.empty(t.shape, dtype=t.dtype,
                                  pin_memory=t.is_cuda).copy_(t)
    return out


def change(params, lv, seed: int, device) -> List[float]:
    """‖w − w0‖ of every leaf of the program's ``params``, w0 made again
    from the seed."""
    w0 = layout.make_weights(lv, seed, device)
    out = ref_fl.leaf_norms({x.path: _at(params, x.path) for x in lv}, w0,
                            [x.path for x in lv])
    del w0
    return out


class ExpertChoices:
    """While entered, the top-k expert choices of every MoE layer call of
    the program (``models/moe.py`` ``_choose``, which both dispatches
    call), in call order; the program's own result passes through
    unchanged."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.calls = moe, moe._choose, []

        def choose(router_w, x, cfg):
            out = self.real(router_w, x, cfg)
            self.calls.append([i.detach() for i in out[1]])
            return out

        moe._choose = choose
        return self

    def __exit__(self, *exc):
        self.moe._choose = self.real

    def keyed(self, slots: int, steps: int, layers: int
              ) -> Dict[tuple, list]:
        """``{(slot, step, layer): choices}`` of one round on the host, in
        the round step's loop order (every slot runs every step, one call
        a layer with ``remat="none"``)."""
        keys = list(itertools.product(range(slots), range(steps),
                                      range(layers)))
        if len(self.calls) != len(keys):
            raise RuntimeError(f"{len(self.calls)} MoE routing calls in a "
                               f"round: not one a layer a step "
                               f"({len(keys)})")
        return {k: [i.cpu() for i in c] for k, c in zip(keys, self.calls)}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        readers: Dict) -> report.Result:
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.device import resolve_device
    from repro_torch.kernels import dp_clip_noise
    from repro_torch.models.model import build

    dev = resolve_device(device)
    report.reset_peak(dev)
    m, t = cell.config["model"], cell.traffic
    f = t["fl"]
    model = build(model_config(cell.config))
    lv = layout.leaves(m)
    check_layout(model, lv)
    n_params = layout.n_elements(lv)
    pool = traffic_lib.fl_pool(t, m["vocab_size"], seed, dev)
    fl = fl_config(f)
    state = rounds_lib.init_serial_state(
        layout.as_tree(layout.make_weights(lv, seed, dev)), fl,
        traffic_lib.generator(seed, "utility", dev), n_clients=f["clients"])
    state = state._replace(rng=traffic_lib.generator(seed, "noise", dev))
    step = rounds_lib.make_serial_round(
        lambda p, b: model.loss(p, b, remat="none"), fl, f["clients"],
        ckpt_every_steps=f["ckpt_every_steps"], device=dev)

    def call(state, r):
        v = pool.variates(r)
        return step(state, pool.batch(r), draws=rounds_lib.SerialDraws(
            v["avail_u"], v["sel_noise"], v["fail_u"], v["fail_step"]))

    rounds = t["check_rounds"]
    prog = {"global_loss": [], "pre_sum": [], "norms": [], "failed": []}
    states = []
    routed = None
    for r in range(rounds):
        with (ExpertChoices() if m["family"] == "moe" and r == 0
              else contextlib.nullcontext()) as choices:
            state, met = call(state, r)
        if choices is not None:
            routed = choices.keyed(f["slots"], f["local_steps"], m["n_layers"])
        prog["global_loss"].append(float(met.global_loss))
        prog["pre_sum"].append(float(met.pre_loss.sum()))
        prog["norms"].append([float(x) for x in met.update_norms])
        prog["failed"].append([bool(x) for x in met.failed])
        states.append(host_copy(state.params, lv))
        if r == 0:
            prog["change1"] = change(state.params, lv, seed, dev)
    prog["change"] = change(state.params, lv, seed, dev)
    del met
    gc.collect()
    report.sync(dev)
    setup_s = time.perf_counter() - t_start

    prof = profiler(dev) if trace else None
    dp_clip_noise.reset_launches()
    failed = torch.zeros((), device=dev)
    n = 0
    if prof is not None:
        prof.__enter__()
    report.sync(dev)
    t0 = time.perf_counter()
    with record_function(WINDOW):
        while True:
            state, met = call(state, rounds + n)
            failed += met.failed.sum()
            n += 1
            report.sync(dev)
            if time.perf_counter() - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    launches = dict(dp_clip_noise.LAUNCHES)
    peak = report.peak_bytes(dev)
    slots = f["slots"]
    if dev.type == "cuda" and launches != {"sumsq_rows": n * slots,
                                           "scale_noise_rows": n * slots}:
        raise RuntimeError(f"K1 launches {launches} for {n * slots} slots")
    metrics = {"train_tokens_per_s": n * traffic_lib.tokens_per_round(t)
               / window_s,
               "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    dev_info = report.device_info(dev, cell.chips, peak)
    breakdown = None
    if prof is not None:
        tr = trace_lib.from_profiler(prof, WINDOW, SPANS)
        ctx = SimpleNamespace(trace=tr, model=m, traffic=t, window_s=window_s,
                              counters={"rounds": n, "k1_rows": n * slots,
                                        "n_params": n_params})
        metrics = {name: fn(ctx) for name, fn in readers.items()}
        dev_info.update(busy_s=trace_lib.busy_s(tr),
                        window_s=tr.window[1] - tr.window[0])
        breakdown = trace_lib.breakdown(tr)
        print_top_kernels(tr)
        del prof, tr
    failed_n = int(failed)
    del state, step, met, model, failed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = ref_fl.run_rounds(
        m, f, lv, layout.make_weights(lv, seed, dev),
        batch=lambda r: (pool.batch(r)["tokens"], pool.batch(r)["labels"]),
        variates=pool.variates,
        noise_seed=layout.sub_seed(seed, "noise"), rounds=rounds,
        judge={"program": states}, replay=routed)
    print(f"reference: {time.perf_counter() - t_ref:.1f} s, device peak "
          f"{report.peak_bytes(dev) / 1e9:.2f} GB", file=sys.stderr)
    detail = check.train_detail(prog, ref, "program")
    print(f"rounds followed: {json.dumps(detail)}", file=sys.stderr)
    if "route_flips" in ref:
        flips, chosen = ref["route_flips"]
        print(f"route round 1: {flips} of the program's {chosen} choices "
              f"under the reference's k-th logit "
              f"({flips / max(chosen, 1):.2%}); later "
              f"rounds routed by the reference's own argmax", file=sys.stderr)
    checks = check.with_limits(check.train_numbers(prog, ref, "program"),
                               cell.limits)
    return report.Result(attempted=n * slots, failed=failed_n,
                         metrics=metrics, device=dev_info, checks=checks,
                         breakdown=breakdown)


def profiler(dev):
    """A ``torch.profiler`` of the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def print_top_kernels(tr, top: int = 15) -> None:
    """The heaviest device operations by name, on standard error."""
    by_name: Dict[str, float] = {}
    for a, b, name in tr.ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"kernel {s:.6f} s {name[:160]}", file=sys.stderr)
