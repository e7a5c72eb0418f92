"""The sharded step bundles (``launch/steps.py``) run on a real 4-process
gloo group on a ("data", "model") = (2, 2) mesh, held against the port's
unsharded path, which the other ``test_torch_*`` files hold against the
reference.

One spawn for the file: the fixture starts four copies of this file as
workers (``--worker``, ``file://`` rendezvous under ``tmp_path``), each
builds every case, and rank 0 writes the gathered results.  Cases, all in
f32: the prefill and decode bundles on the smoke configs of granite,
phi3.5-moe (experts over ``model``; its prefill on both dispatches), recurrentgemma (``h``/``conv``
caches), mamba2 (``ssm`` cache, ``ssm_shard="state"``) and seamless;
decode writes slots 0, 15, 16 and 31 of a 32-slot cache (f32) split
16 | 16 over ``model``, so both ranks' halves are written; the ``client_serial``
train bundle on the granite smoke config with clipped DP on the
reference's draws (``reference_serial_draws``) and ``grad_accum`` 2, and
without DP on granite and phi3.5-moe (the grads of the router's and the
experts' ``local_map``s, and of the vocab-split embedding); the
``client_parallel`` train bundle (one client a data rank, each trained on
its ``model`` sub-mesh, FedAvg one all-reduce over ``data``) on granite
(and at ``grad_accum`` 2), mamba2, seamless (its ``frontend``) and
phi3.5-moe, with clipped DP and coherence scoring on, on the reference's
draws, against the unsharded LM ``make_parallel_round``; the DP norm of a
tree with leaves replicated over ``model`` and over the whole mesh.  Bar:
within 1e-5 of the unsharded value's max|x| (a sharded product sums its
partial products in another order); masks and failures equal.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MeshConfig, ShapeConfig, get_arch
from repro_torch.core import rounds as t_rounds
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as T
from repro_torch.models.model import build

torch.set_num_threads(1)

ARCHS = ("granite_3_8b", "phi3p5_moe_42b", "recurrentgemma_9b",
         "mamba2_130m", "seamless_m4t_large_v2")
B, S, CACHE = 4, 16, 32
DECODE_AT = (0, 15, 16, 31)
GRAD_ACCUM, N_CLIENTS = 2, 40
# (arch, DP): the round with clipped DP on the reference's draws, and
# without DP (the deltas are then the grads' alone: a wrong placement of a
# grad cannot hide under the noise), on a dense and a MoE config
TRAIN_CASES = (("granite_3_8b", True), ("granite_3_8b", False),
               ("phi3p5_moe_42b", False))
# (arch, grad_accum) of the client_parallel bundle: two clients, one a
# data rank, with the make_fl_config settings (clipped DP; coherence on,
# as every smoke config is under 1e9 params)
PARALLEL_CASES = (("granite_3_8b", 1), ("granite_3_8b", 2),
                  ("mamba2_130m", 1), ("seamless_m4t_large_v2", 1),
                  ("phi3p5_moe_42b", 1))
WORLD = 4
TOL = 1e-5


def _cfg(arch):
    return dataclasses.replace(get_arch(arch, smoke=True), dtype="float32")


def _inputs(arch, specs, seed):
    """Tokens and frontend embeddings for ``specs`` from a NumPy seed."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(specs):
        s = specs[k]
        if s.is_floating_point():
            out[k] = torch.as_tensor(rng.standard_normal(tuple(s.shape)),
                                     dtype=s.dtype)
        else:
            out[k] = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                  tuple(s.shape)),
                                     dtype=s.dtype)
    return out


def _prefill_shape():
    return ShapeConfig("t", S, B, "prefill")


def _decode_shape():
    return ShapeConfig("t", CACHE, B, "decode")


def _decode_tokens(arch):
    rng = np.random.default_rng(7)
    return torch.as_tensor(rng.integers(0, _cfg(arch).vocab_size,
                                        (len(DECODE_AT), B, 1)),
                           dtype=torch.int32)


def _f32_caches(model, window, params):
    """Zeroed caches, every leaf f32: a bf16 k/v slot rounds an f32 value
    that the sharded product gave one ulp off to another bf16 value."""
    def f32(x):
        if isinstance(x, dict):
            return {k: f32(v) for k, v in x.items()}
        if isinstance(x, list):
            return [f32(v) for v in x]
        return x.float()

    return f32(model.init_cache(B, CACHE, window=window, params=params,
                                device="cpu"))


def _tree_full(x):
    if isinstance(x, dict):
        return {k: _tree_full(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree_full(v) for v in x]
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _leaves(x):
    if isinstance(x, dict):
        return [l for k in sorted(x) for l in _leaves(x[k])]
    if isinstance(x, list):
        return [l for v in x for l in _leaves(v)]
    return [x]


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------


def _norm_tree():
    rng = np.random.default_rng(3)
    return {"w": torch.as_tensor(rng.standard_normal((8, 6)),
                                 dtype=torch.float32),
            "r_model": torch.as_tensor(rng.standard_normal((4, 5)),
                                       dtype=torch.float32),
            "r_all": torch.as_tensor(rng.standard_normal(7),
                                     dtype=torch.float32)}


def _norm_case(mesh):
    """(sharded norm, K1's clipped norm) of :func:`_norm_tree` laid out
    with ``w`` split over both axes, ``r_model`` replicated over
    ``model`` and ``r_all`` over the whole mesh."""
    from torch.distributed.tensor import Replicate, Shard
    tree = _norm_tree()
    pl = {"w": (Shard(0), Shard(1)), "r_model": (Shard(0), Replicate()),
          "r_all": (Replicate(), Replicate())}
    dtree = t_steps.place(tree, pl, mesh)
    layout = t_rounds._ShardLayout(dtree)
    flat = layout.row()
    for v, t in zip(layout.views(flat), _leaves(dtree)):
        v.copy_(t.to_local())
    norm = t_rounds._sharded_norm(layout, flat)
    _, dp_norm = t_rounds._sharded_clip_noise(layout, flat.clone(),
                                              torch.zeros_like(flat), 1.0, 0.0)
    return norm, dp_norm


def _worker(rank: int, init: str, inputs: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=WORLD)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = build(cfg)
        params = model.init(0, device="cpu")
        bp = t_steps.build_prefill_step(cfg, _prefill_shape(), MeshConfig(),
                                        mesh)
        dparams = t_steps.place(params, bp.in_shardings[0], mesh)
        batch = _inputs(arch, bp.in_specs[1], 1)
        res[f"{arch}/prefill"] = bp.fn(
            dparams, t_steps.place(batch, bp.in_shardings[1], mesh)
        ).full_tensor()
        bd = t_steps.build_decode_step(cfg, _decode_shape(), MeshConfig(), mesh)
        caches = _f32_caches(model, bd.meta["window"], params)
        dcaches = t_steps.place(caches, bd.in_shardings[2], mesh)
        logits = []
        for tok, index in zip(_decode_tokens(arch), DECODE_AT):
            lg, dcaches = bd.fn(dparams,
                                t_steps.place(tok, bd.in_shardings[1], mesh),
                                dcaches, index)
            logits.append(lg.full_tensor())
        res[f"{arch}/decode"] = torch.stack(logits)
        res[f"{arch}/caches"] = _tree_full(dcaches)
    # phi3.5-moe's prefill on the scatter dispatch too
    T.MOE_IMPL[0] = "scatter"
    try:
        cfg = _cfg("phi3p5_moe_42b")
        bp = t_steps.build_prefill_step(cfg, _prefill_shape(), MeshConfig(),
                                        mesh)
        params = build(cfg).init(0, device="cpu")
        res["scatter/prefill"] = bp.fn(
            t_steps.place(params, bp.in_shardings[0], mesh),
            t_steps.place(_inputs("phi3p5_moe_42b", bp.in_specs[1], 1),
                          bp.in_shardings[1], mesh)).full_tensor()
    finally:
        T.MOE_IMPL[0] = "einsum"

    saved = torch.load(inputs, weights_only=False)
    for arch, dp in TRAIN_CASES:
        cfg = _cfg(arch)
        fl = _train_fl(cfg, dp)
        bt = t_steps.build_train_step(cfg, ShapeConfig("t", S, B, "train"),
                                      MeshConfig(), mesh,
                                      plan="client_serial",
                                      grad_accum=GRAD_ACCUM, fl=fl)
        params = build(cfg).init(0, device="cpu")
        dparams = t_steps.place(params, bt.in_shardings[0], mesh)
        state = t_rounds.init_serial_state(
            dparams, fl, torch.Generator().manual_seed(5),
            n_clients=N_CLIENTS)
        new, metrics = bt.fn(state, t_steps.place(
            saved[f"{arch}/batches"], bt.in_shardings[1], mesh),
            draws=saved[f"{arch}/{dp}/draws"])
        res[f"train/{arch}/{dp}/params"] = _tree_full(new.params)
        res[f"train/{arch}/{dp}/metrics"] = metrics
    for arch, ga in PARALLEL_CASES:
        cfg = _cfg(arch)
        bt = _parallel_bundle(cfg, mesh, ga)
        fl = bt.meta["fl"]
        assert bt.meta["n_clients"] == 2 and bt.meta["per_client_batch"] == 2
        params = build(cfg).init(0, device="cpu")
        state = t_rounds.init_serial_state(
            t_steps.place(params, bt.in_shardings[0], mesh), fl,
            torch.Generator().manual_seed(5), n_clients=fl.n_clients)
        new, metrics = bt.fn(state, t_steps.place(
            saved[f"parallel/{arch}/batches"], bt.in_shardings[1], mesh),
            draws=saved[f"parallel/{arch}/draws"])
        res[f"parallel/{arch}/{ga}/params"] = _tree_full(new.params)
        res[f"parallel/{arch}/{ga}/metrics"] = metrics
        res[f"parallel/{arch}/{ga}/util"] = new.util
    res["norm"] = _norm_case(mesh)
    if rank == 0:
        torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the unsharded side
# ---------------------------------------------------------------------------


def _train_fl(cfg, dp: bool):
    fl = t_steps.make_fl_config(cfg, "client_serial", N_CLIENTS)
    return dataclasses.replace(fl, dp_enabled=dp)


def _parallel_bundle(cfg, mesh, grad_accum):
    return t_steps.build_train_step(cfg, ShapeConfig("t", S, B, "train"),
                                    MeshConfig(), mesh,
                                    grad_accum=grad_accum)


def _parallel_setup(saved):
    """Each client_parallel case's batches ``[2, 1, B/2, ...]`` (the
    frontend too) and the reference's draws for two clients."""
    import jax
    from test_torch_parity import reference_draws
    for arch in sorted({a for a, _ in PARALLEL_CASES}):
        cfg = _cfg(arch)
        assert t_steps.choose_plan(cfg) == "client_parallel"
        specs = build(cfg).input_specs(ShapeConfig("t", S, B // 2, "train"))
        saved[f"parallel/{arch}/batches"] = _inputs(arch, {
            k: torch.empty((2, 1) + tuple(v.shape), dtype=v.dtype,
                           device="meta") for k, v in specs.items()}, 4)
        shapes = [tuple(t.shape) for t in _leaves(build(cfg).param_shapes())]
        saved[f"parallel/{arch}/draws"], _ = reference_draws(
            jax.random.key(6), 2, 1, shapes)


def _train_setup():
    """Each train case's batches and the reference's draws for its round
    (the port's serial round takes them as ``SerialDraws``; without DP
    they carry no noise)."""
    import jax
    from test_torch_train import reference_serial_draws
    saved = {}
    for arch, dp in TRAIN_CASES:
        cfg = _cfg(arch)
        fl = _train_fl(cfg, dp)
        specs = build(cfg).input_specs(ShapeConfig("t", S, B, "train"))
        rng = np.random.default_rng(2)
        toks = rng.integers(0, cfg.vocab_size,
                            (fl.serial_clients_in_step, 1, B, S + 1))
        batches = {"tokens": torch.as_tensor(toks[..., :-1],
                                             dtype=torch.int32),
                   "labels": torch.as_tensor(toks[..., 1:],
                                             dtype=torch.int32)}
        assert batches["tokens"].shape[2:] == specs["tokens"].shape
        shapes = ([tuple(t.shape) for t in
                   _leaves(build(cfg).param_shapes())] if dp else [])
        draws, _ = reference_serial_draws(jax.random.key(3), N_CLIENTS,
                                          fl.serial_clients_in_step, 1,
                                          shapes)
        saved[f"{arch}/batches"] = batches
        saved[f"{arch}/{dp}/draws"] = draws
    _parallel_setup(saved)
    return saved


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    saved = _train_setup()
    inputs, out = tmp / "inputs.pt", tmp / "sharded.pt"
    torch.save(saved, inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = str(Path(__file__).resolve().parent.parent / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(tmp / "rdzv"),
         str(inputs), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return torch.load(out, weights_only=False), saved


def _close(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(b.abs().max().item(), 1e-30)
    err = (a - b).abs().max().item()
    assert err <= TOL * scale, f"max|Δ| {err:.3e} > {TOL} × {scale:.3e}"


@pytest.mark.parametrize("arch,moe", [(a, "einsum") for a in ARCHS]
                         + [("phi3p5_moe_42b", "scatter")])
def test_prefill_bundle_matches_unsharded(sharded, arch, moe):
    """The last position's logits; phi3.5-moe on both dispatches (the
    sharded one runs each rank's experts in one ``local_map``)."""
    res, _ = sharded
    cfg = _cfg(arch)
    model = build(cfg)
    params = model.init(0, device="cpu")
    specs = model.input_specs(_prefill_shape())
    T.MOE_IMPL[0] = moe
    try:
        want = model.forward(params, _inputs(arch, specs, 1), last_only=True,
                             window=t_steps.effective_window(
                                 cfg, _prefill_shape()))
    finally:
        T.MOE_IMPL[0] = "einsum"
    key = f"{arch}/prefill" if moe == "einsum" else "scatter/prefill"
    _close(res[key], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_bundle_matches_unsharded(sharded, arch):
    """Every step's logits and, after the last, every cache leaf."""
    res, _ = sharded
    cfg = _cfg(arch)
    model = build(cfg)
    params = model.init(0, device="cpu")
    window = t_steps.effective_window(cfg, _decode_shape())
    caches = _f32_caches(model, window, params)
    for i, (tok, index) in enumerate(zip(_decode_tokens(arch), DECODE_AT)):
        lg, caches = model.decode_step(params, tok, caches, index,
                                       window=window)
        _close(res[f"{arch}/decode"][i], lg)
    for got, want in zip(_leaves(res[f"{arch}/caches"]), _leaves(caches)):
        _close(got, want)


@pytest.mark.parametrize("arch,dp", TRAIN_CASES)
def test_serial_train_bundle_matches_unsharded(sharded, arch, dp):
    """One round: the selection mask and failures equal; the slots'
    norms and losses, and every leaf's update (new − old), within 1e-5
    of the tree's largest update."""
    res, saved = sharded
    cfg = _cfg(arch)
    fl = _train_fl(cfg, dp)
    model = build(cfg)
    params = model.init(0, device="cpu")
    state = t_rounds.init_serial_state(
        params, fl, torch.Generator().manual_seed(5), n_clients=N_CLIENTS)
    step = t_rounds.make_serial_round(
        lambda p, b: model.loss(p, b, remat="full"), fl, N_CLIENTS,
        grad_accum=GRAD_ACCUM, delta_dtype=torch.float32, device="cpu")
    new, metrics = step(state, saved[f"{arch}/batches"],
                        draws=saved[f"{arch}/{dp}/draws"])
    got = res[f"train/{arch}/{dp}/metrics"]
    assert torch.equal(got.sel_mask, metrics.sel_mask)
    assert torch.equal(got.failed, metrics.failed)
    assert metrics.sel_mask.sum() > 0
    for name in ("update_norms", "pre_loss", "post_loss", "global_loss"):
        _close(getattr(got, name), getattr(metrics, name))
    old = _leaves(params)
    want = [w.double() - o.double() for w, o in zip(_leaves(new.params), old)]
    scale = max(d.abs().max().item() for d in want)
    assert scale > 0
    for g, w, o in zip(_leaves(res[f"train/{arch}/{dp}/params"]), want, old):
        # each side's f32 params round old + update once: an ulp of |old|
        ulp = 2.0 ** -23 * o.abs().max().item()
        err = (g.double() - o.double() - w).abs().max().item()
        assert err <= TOL * scale + ulp, \
            f"update off by {err:.3e} of {scale:.3e} (ulp {ulp:.1e})"


def test_replicated_leaves_count_once_in_the_dp_norm(sharded):
    """A leaf replicated over ``model`` (2 copies) and one over the whole
    mesh (4 copies) add their Σx² once: the all-reduced norm equals the
    unsharded tree's, on the plain norm and on K1's route."""
    res, _ = sharded
    want = torch.sqrt(sum(torch.sum(t.double() ** 2)
                          for t in _norm_tree().values()))
    norm, dp_norm = res["norm"]
    _close(norm, want)
    _close(dp_norm, want)


@pytest.mark.parametrize("arch,grad_accum", PARALLEL_CASES)
def test_parallel_train_bundle_matches_unsharded(sharded, arch, grad_accum):
    """One round of the client_parallel bundle on the (2, 2) mesh against
    the unsharded LM ``make_parallel_round`` on the same draws: the
    selection mask and failures equal; the clients' losses and norms, the
    utility state (coherence included) and every leaf's update within 1e-5
    of the largest."""
    res, saved = sharded
    cfg = _cfg(arch)
    fl = t_steps.make_fl_config(cfg, "client_parallel", 2)
    model = build(cfg)
    params = model.init(0, device="cpu")
    state = t_rounds.init_serial_state(
        params, fl, torch.Generator().manual_seed(5), n_clients=fl.n_clients)
    step = t_rounds.make_parallel_round(
        lambda p, b: model.loss(p, b, remat="full"), fl, fl.n_clients,
        device="cpu", grad_accum=grad_accum, lm=True)
    new, metrics = step(state, saved[f"parallel/{arch}/batches"],
                        draws=saved[f"parallel/{arch}/draws"])
    key = f"parallel/{arch}/{grad_accum}"
    got = res[f"{key}/metrics"]
    assert torch.equal(got.sel_mask, metrics.sel_mask)
    assert torch.equal(got.failed, metrics.failed)
    assert metrics.sel_mask.sum() > 0
    for name in ("update_norms", "pre_loss", "post_loss", "global_loss"):
        _close(getattr(got, name), getattr(metrics, name))
    for name, g, w in zip(new.util._fields, res[f"{key}/util"], new.util):
        _close(g, w)
    assert fl.coherence_scoring and float(new.util.coherence.abs().max()) > 0
    old = _leaves(params)
    want = [w.double() - o.double() for w, o in zip(_leaves(new.params), old)]
    scale = max(d.abs().max().item() for d in want)
    assert scale > 0
    for g, w, o in zip(_leaves(res[f"{key}/params"]), want, old):
        ulp = 2.0 ** -23 * o.abs().max().item()
        err = (g.double() - o.double() - w).abs().max().item()
        assert err <= TOL * scale + ulp, \
            f"update off by {err:.3e} of {scale:.3e} (ulp {ulp:.1e})"


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
