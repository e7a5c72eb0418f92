"""The dry-run (``launch/dryrun.py``) on fake process groups: every smoke
architecture × input shape builds its bundle on a fake 2 × 2 × 2
("pod", "data", "model") group with per-rank argument bytes equal to the
local shard sizes of the reference's own specs (``param_shardings``,
``cache_shardings`` and the batch specs, from JAX with 8 forced host
devices in a subprocess); the counter gives exact bytes and flops on a
known program (the FSDP all-gather of a product, and the all-reduce of a
row-parallel one); a bundle runs once under the counter; a production pair
writes its JSON; a ``client_parallel`` train pair (clients over the
data ranks) runs once under the counter; every one of the 80 (pair ×
mesh) bundles is listed to build, none waits.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, MeshConfig,
                                      get_arch, get_shape)
from repro_torch.launch import dryrun
from repro_torch.launch import steps as t_steps
from repro_torch.launch.mesh import mesh_from_shape
from repro_torch.models.shardctx import local_box

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMOKE_SEQ, SMOKE_BATCH = 64, 8


def _smoke_shape(name):
    return dataclasses.replace(INPUT_SHAPES[name], seq_len=SMOKE_SEQ,
                               global_batch=SMOKE_BATCH)


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    """This file's fake groups, taken down after it."""
    import torch.distributed as dist
    dryrun._quiet_dtensor_logs()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def pod_mesh():
    """A fake group of 8 ranks and its (2, 2, 2) mesh."""
    dryrun.setup_fake_group(8)
    return mesh_from_shape((2, 2, 2), ("pod", "data", "model"), "cpu")


_REF_BYTES = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, math
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ARCH_IDS, INPUT_SHAPES, get_arch
from repro.launch import steps
from repro.models.model import build
from repro.models.sharding import make_rules, sanitize_pspec

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
rules = make_rules("client_serial", True)
ab = rules["act_batch"]

def local(shape, dtype, sharding):
    return math.prod(sharding.shard_shape(tuple(shape))) * jax.numpy.dtype(dtype).itemsize

def lead(s, spec):
    full = P(*(tuple(spec) + (None,) * (len(s.shape) - len(spec))))
    return NamedSharding(mesh, sanitize_pspec(s.shape, full, mesh))

out = {}
for arch in ARCH_IDS:
    model = build(get_arch(arch, smoke=True))
    pshapes = model.param_shapes()
    pb = sum(local(s.shape, s.dtype, sh) for s, sh in zip(
        jax.tree.leaves(pshapes),
        jax.tree.leaves(steps.param_shardings(model, rules, mesh))))
    for name, shape in INPUT_SHAPES.items():
        shape = dataclasses.replace(shape, seq_len=SEQ, global_batch=BATCH)
        specs = model.input_specs(shape)
        if shape.mode == "decode":
            tok = specs["token"]
            ib = local(tok.shape, tok.dtype, lead(tok, (ab,)))
            cs = steps.cache_shardings(specs["caches"], rules, mesh, ssm_shard="state")
            ib += sum(local(s.shape, s.dtype, sh) for s, sh in zip(
                jax.tree.leaves(specs["caches"]), jax.tree.leaves(cs)))
        elif shape.mode == "prefill":
            ib = sum(local(s.shape, s.dtype, lead(s, (ab,))) for s in jax.tree.leaves(specs))
        else:
            ib = 0
            for s in jax.tree.leaves(specs):
                b = jax.ShapeDtypeStruct((2, 1) + tuple(s.shape), s.dtype)
                ib += local(b.shape, b.dtype, lead(b, (None, None, ab)))
        out[f"{arch}/{name}"] = [pb, ib]
print(json.dumps(out))
""".replace("SEQ", str(SMOKE_SEQ)).replace("BATCH", str(SMOKE_BATCH))


@pytest.fixture(scope="module")
def ref_bytes():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _REF_BYTES],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _local_bytes(specs, shardings, mesh) -> int:
    total = 0
    for spec, pl in zip(_leaves(specs), _leaves(shardings)):
        shape, _ = local_box(spec.shape, mesh, pl)
        total += math.prod(shape) * spec.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, list):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_smoke_bundle_builds_on_a_fake_pod_mesh(pod_mesh, ref_bytes,
                                                       arch):
    """Each input shape's bundle (the serial train round for every arch,
    by ``plan=``) builds on the (2, 2, 2) group, and its per-rank bytes of
    params and of inputs equal the reference's specs' local shards; the
    fake local shards the dry-run makes have those sizes."""
    cfg = get_arch(arch, smoke=True)
    for name in INPUT_SHAPES:
        shape = _smoke_shape(name)
        kw = {"plan": "client_serial"} if shape.mode == "train" else {}
        b = t_steps.build_step(cfg, shape, MeshConfig(multi_pod=True),
                               pod_mesh, **kw)
        params = _local_bytes(b.in_specs[0], b.in_shardings[0], pod_mesh)
        inputs = sum(_local_bytes(s, sh, pod_mesh) for s, sh in
                     zip(b.in_specs[1:], b.in_shardings[1:]) if sh is not None)
        assert [params, inputs] == ref_bytes[f"{arch}/{name}"], name
        fake = [t_steps.abstract_inputs(s, sh, pod_mesh)
                for s, sh in zip(b.in_specs, b.in_shardings) if sh is not None]
        assert dryrun._local_bytes(fake) == params + inputs


def _known_product(mesh):
    """x [32, 4096, 12288] (batch over data) @ w [12288, 28672] (FSDP over
    data, columns over model), then a row-parallel product whose partial
    sums are all-reduced."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.counting() as counter:
        def dt(shape, pl):
            local, _ = local_box(shape, mesh, pl)
            return DTensor.from_local(
                torch.empty(local, dtype=torch.bfloat16), mesh, pl,
                run_check=False, shape=shape,
                stride=torch.empty(shape, device="meta").stride())
        x = dt((32, 4096, 12288), (Shard(0), Replicate()))
        w = dt((12288, 28672), (Shard(0), Shard(1)))
        y = x @ w
        counter.flops = 0
        counter.coll = {k: 0.0 for k in counter.coll}
        counter.counts = {k: 0 for k in counter.counts}
        y = x @ w
        first = (counter.flops, dict(counter.coll), dict(counter.counts))
        wo = dt((28672, 12288), (Replicate(), Shard(0)))
        z = (y @ wo).redistribute(mesh, (Shard(0), Replicate()))
        second = (counter.flops - first[0], dict(counter.coll),
                  dict(counter.counts))
    return y, z, first, second


def test_counter_gives_exact_bytes_and_flops_on_a_known_program():
    """The counterpart of the reference's ``test_collective_bytes_parser``:
    on a 16 × 16 fake group the FSDP product all-gathers its weight's data
    shards once (12288 × 1792 bf16 gathered) and does 2·2·4096·12288·1792
    flops on each rank; the row-parallel product all-reduces its
    [2, 4096, 12288] bf16 partial sums once."""
    dryrun.setup_fake_group(256)
    mesh = mesh_from_shape((16, 16), ("data", "model"), "cpu")
    y, z, first, second = _known_product(mesh)
    from torch.distributed.tensor import Shard
    assert tuple(y.placements) == (Shard(0), Shard(2))
    flops, coll, counts = first
    assert flops == 2 * 2 * 4096 * 12288 * 1792
    assert counts == {"all-gather": 1, "all-reduce": 0, "reduce-scatter": 0,
                      "all-to-all": 0}
    assert coll["all-gather"] == 12288 * 1792 * 2
    flops2, coll2, counts2 = second
    assert flops2 == 2 * 2 * 4096 * 1792 * 12288
    assert counts2["all-reduce"] == 1
    assert coll2["all-reduce"] == 2 * 4096 * 12288 * 2
    assert coll2["all-gather"] == coll["all-gather"]


@pytest.mark.parametrize("name", ["prefill_32k", "decode_32k"])
def test_a_bundle_runs_once_under_the_counter(pod_mesh, name):
    """granite's smoke prefill and decode on the (2, 2, 2) group: the
    argument bytes are the local shards', the logits come out at their
    local size, and the step does flops and collectives."""
    cfg = get_arch("granite_3_8b", smoke=True)
    shape = _smoke_shape(name)
    b = t_steps.build_step(cfg, shape, MeshConfig(multi_pod=True), pod_mesh)
    m = dryrun.measure(b, pod_mesh, shape.mode)
    want = sum(_local_bytes(s, sh, pod_mesh) for s, sh in
               zip(b.in_specs, b.in_shardings) if sh is not None)
    assert m["memory"]["argument_bytes"] == want
    logits, _ = local_box((SMOKE_BATCH, 1, 512), pod_mesh,
                          b.out_shardings if name == "prefill_32k"
                          else b.out_shardings[0])
    out = m["memory"]["output_bytes"]
    assert out >= math.prod(logits) * 4
    assert m["memory"]["peak_bytes"] > want
    assert m["cost"]["flops"] > 0
    assert m["collectives"]["counts"]["all-gather"] > 0
    assert m["collectives"]["total"] > 0


def test_run_one_writes_the_reference_keys(tmp_path):
    """A production pair (mamba2 at long_500k on the 16 × 16 group) writes
    its JSON with the reference's keys and ``fits_h100_80gb``."""
    r = dryrun.run_one("mamba2_130m", "long_500k", "single",
                       out_dir=str(tmp_path))
    saved = json.loads((tmp_path / "mamba2_130m__long_500k__single.json")
                       .read_text())
    for key in ("arch", "shape", "mesh", "tag", "step", "meta", "devices",
                "memory", "cost", "collectives", "model_params",
                "model_active_params", "fits_h100_80gb"):
        assert key in saved, key
    assert saved["devices"] == 256 and saved["fits_h100_80gb"] is True
    assert saved["memory"]["argument_bytes"] == r["memory"]["argument_bytes"]
    assert set(saved["collectives"]["counts"]) == set(dryrun.COLLECTIVES)


def test_client_parallel_train_pair_runs_once_under_the_counter(pod_mesh):
    """A mini dry-run of granite's ``train_4k`` pair at the smoke config on
    the fake (2, 2, 2) group: the client_parallel bundle has the
    reference's meta (one client a (pod, data) rank, 8 // 4 sequences
    each, grad_accum 1), its batches split over (pod, data) and its params
    never over them; one round runs on the local shards with flops, the
    model's collectives over ``model`` and the FedAvg and norm all-reduces
    over the client axes."""
    from torch.distributed.tensor import Shard
    cfg = get_arch("granite_3_8b", smoke=True)
    shape = _smoke_shape("train_4k")
    b = t_steps.build_step(cfg, shape, MeshConfig(multi_pod=True), pod_mesh)
    assert b.meta["plan"] == t_steps.choose_plan(cfg) == "client_parallel"
    assert b.meta["n_clients"] == b.meta["clients_in_step"] == 4
    assert b.meta["per_client_batch"] == SMOKE_BATCH // 4
    assert b.meta["grad_accum"] == 1 and b.meta["scan"]["clients_scan"] == 1
    assert b.meta["tokens_per_step"] == 4 * 1 * 2 * SMOKE_SEQ
    for pl in b.in_shardings[1].values():
        assert pl[:2] == (Shard(0), Shard(0)) and not pl[2].is_shard()
    for pl in _leaves(b.in_shardings[0]):
        assert not pl[0].is_shard() and not pl[1].is_shard()
    m = dryrun.measure(b, pod_mesh, "train")
    want = sum(_local_bytes(s, sh, pod_mesh) for s, sh in
               zip(b.in_specs, b.in_shardings) if sh is not None)
    assert m["memory"]["argument_bytes"] >= want
    assert m["memory"]["peak_bytes"] > m["memory"]["argument_bytes"]
    assert m["cost"]["flops"] > 0
    assert m["collectives"]["counts"]["all-reduce"] >= 2
    assert m["collectives"]["counts"]["all-gather"] > 0


def test_every_pair_builds_none_waits(monkeypatch, capsys):
    """The waiting state is gone: ``--all --mesh both`` hands all 80 (pair
    × mesh) bundles to ``run_one`` (here a stub that records them), the
    train pairs of the five architectures under 10 B on the
    client_parallel plan among them, and reports none waiting."""
    assert not hasattr(dryrun, "waiting_reason")
    ran = []

    def stub(arch, shape, mk, **_):
        ran.append((arch, shape, mk))
        return {"arch": arch, "shape": shape, "mesh": mk, "run_s": 0.0,
                "cost": {"flops": 0.0}, "fits_h100_80gb": True,
                "memory": {"argument_bytes": 0, "peak_bytes": 0},
                "collectives": {"total": 0}}

    monkeypatch.setattr(dryrun, "run_one", stub)
    dryrun.main(["--all", "--mesh", "both"])
    out = capsys.readouterr().out
    assert len(set(ran)) == len(ran) == 2 * len(ARCH_IDS) * len(
        INPUT_SHAPES) == 80
    assert "80 built, 0 failed" in out and "wait" not in out
    parallel = {(a, s) for a, s, _ in ran if s == "train_4k"
                and t_steps.choose_plan(get_arch(a)) == "client_parallel"}
    assert parallel == {(a, "train_4k") for a in (
        "recurrentgemma_9b", "mamba2_130m", "seamless_m4t_large_v2",
        "granite_3_8b", "phi3_mini_3p8b")}
    assert get_shape("train_4k").mode == "train"
