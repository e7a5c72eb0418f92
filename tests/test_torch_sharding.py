"""The port's sharding layer against the reference's, with no execution:
``MeshConfig``/``RunConfig``/``all_pairs``, the rule tables, the spec
functions over hypothesis draws, every full config's param specs on both
production meshes leaf by leaf (and the decode caches' for ``decode_32k``
and ``long_500k`` under each ``ssm_shard``), PartitionSpec → DTensor
placements in JAX's major-to-minor order, the step inputs' specs, and the
context's refusals.

The reference's ``param_shardings``/``cache_shardings`` need a mesh of 256
or 512 devices: a subprocess forces 512 host devices (as the reference's
own tests force theirs) and prints the specs; they trace nothing.  The
reference's ``logical_to_pspec``, ``sanitize_pspec`` and
``divisibility_ok`` read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stub mesh serves both packages.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import base as j_base
from repro.core import plans as j_plans
from repro.models import model as j_model
from repro.models import sharding as j_sharding

from repro_torch.configs import base as t_base
from repro_torch.kernels import dp_clip_noise as t_dpk
from repro_torch.kernels import ops as t_kops
from repro_torch.launch import steps as t_steps
from repro_torch.models import model as t_model
from repro_torch.models import sharding as t_sharding
from repro_torch.models import shardctx
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
LOGICAL = ("embed", "mlp", "heads", "kv", "vocab", "experts", "layers",
           "act_batch", "act_seq", "ssm_state", "clients", "lanes")
TABLES = ("RULES_SERIAL", "RULES_PARALLEL", "RULES_POPULATION",
          "RULES_MODEL_SCALE")
SSM_SHARDS = ("heads", "state", "state_convrep")


class StubMesh:
    """Names and sizes only: what both packages' spec functions read."""

    def __init__(self, names, sizes):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = tuple(sizes)
        self.devices = np.empty(tuple(sizes), dtype=np.int8)
        self.ndim = len(sizes)


def _mesh_stub(multi_pod: bool) -> StubMesh:
    m = t_base.MeshConfig(multi_pod=multi_pod)
    return StubMesh(m.axes, m.shape)


def _norm(spec):
    """A spec as a tuple of tuples/None (either package's)."""
    return tuple(None if p is None else (p,) if isinstance(p, str)
                 else tuple(p) for p in tuple(spec))


# ---------------------------------------------------------------------------
# configs and rule tables
# ---------------------------------------------------------------------------


def test_mesh_and_run_configs_and_pairs_equal_the_reference():
    for mp in (False, True):
        j, t = j_base.MeshConfig(multi_pod=mp), t_base.MeshConfig(multi_pod=mp)
        assert (t.shape, t.axes, t.n_devices) == (j.shape, j.axes, j.n_devices)
    assert t_base.all_pairs() == j_base.all_pairs()
    assert len(t_base.all_pairs()) == 40
    j_fields = {f.name: f.default for f in dataclasses.fields(j_base.RunConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(t_base.RunConfig)}
    assert list(t_fields) == list(j_fields)
    for name in ("remat", "grad_accum", "attention_impl"):
        assert t_fields[name] == j_fields[name]
    cfg = t_base.get_arch("granite_3_8b", smoke=True)
    run = t_base.RunConfig(cfg, t_base.get_shape("train_4k"))
    assert run.mesh == t_base.MeshConfig() and run.fl == t_base.FLConfig()
    assert run.replace(attention_impl="flash").attention_impl == "flash"


@pytest.mark.parametrize("table", TABLES)
def test_rule_tables_equal_the_reference(table):
    assert getattr(t_sharding, table) == getattr(j_sharding, table)


def test_make_rules_equal_the_reference_for_every_plan():
    plans = sorted(j_plans._REGISTRY)
    assert plans
    for plan in plans:
        for mp in (False, True):
            assert t_sharding.make_rules(plan, mp) == \
                j_sharding.make_rules(plan, mp), (plan, mp)
            for family in ("client_serial", "client_parallel"):
                base = (t_sharding.RULES_SERIAL if family == "client_serial"
                        else t_sharding.RULES_PARALLEL)
                assert t_sharding.with_pod(base, mp, family) == \
                    j_sharding.with_pod(base, mp, family)


# ---------------------------------------------------------------------------
# the spec functions over hypothesis draws
# ---------------------------------------------------------------------------

AXIS_NAMES = ("pod", "data", "model")


@st.composite
def _case(draw):
    ndim = draw(st.integers(1, 3))
    names = AXIS_NAMES[-ndim:] if draw(st.booleans()) else AXIS_NAMES[:ndim]
    sizes = tuple(draw(st.sampled_from((1, 2, 3, 4, 8, 16)))
                  for _ in range(ndim))
    table = draw(st.sampled_from(TABLES[:2]))
    rules = dict(getattr(j_sharding, table))
    if draw(st.booleans()):
        rules = j_sharding.with_pod(rules, True, draw(st.sampled_from(
            ("client_serial", "client_parallel"))))
    rank = draw(st.integers(0, 5))
    axes = tuple(draw(st.sampled_from(LOGICAL + (None,))) for _ in range(rank))
    shape = tuple(draw(st.sampled_from((1, 2, 3, 6, 8, 16, 24, 48, 256)))
                  for _ in range(rank))
    return StubMesh(names, sizes), rules, axes, shape


@settings(max_examples=300, deadline=None)
@given(_case())
def test_spec_functions_equal_the_reference(case):
    mesh, rules, axes, shape = case
    jp = j_sharding.logical_to_pspec(axes, rules)
    tp = t_sharding.logical_to_pspec(axes, rules)
    assert tuple(tp) == tuple(jp)
    if any(p is not None and any(a not in mesh.axis_names
                                 for a in ((p,) if isinstance(p, str) else p))
           for p in tuple(jp)):
        return  # a rule naming an axis this mesh lacks: both raise KeyError
    assert t_sharding.divisibility_ok(shape, tp, mesh) == \
        j_sharding.divisibility_ok(shape, jp, mesh)
    assert tuple(t_sharding.sanitize_pspec(shape, tp, mesh)) == \
        tuple(j_sharding.sanitize_pspec(shape, jp, mesh))


def test_spec_helpers_read_a_mesh_config_as_its_production_mesh():
    spec = t_sharding.P(("pod", "data"), "model")
    assert t_sharding.divisibility_ok((64, 32), spec,
                                      t_base.MeshConfig(multi_pod=True))
    assert tuple(t_sharding.sanitize_pspec(
        (48, 8), spec, t_base.MeshConfig(multi_pod=True))) == ()


# ---------------------------------------------------------------------------
# PartitionSpec -> placements
# ---------------------------------------------------------------------------


def test_placements_keep_the_jax_major_to_minor_order():
    """A dim over ("pod", "data") on a (2, 2, 2) mesh: every rank's block
    from DTensor's placements is the block JAX's ``NamedSharding`` gives
    the device at that mesh coordinate (pod major, data minor)."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset

    names, sizes, shape = ("pod", "data", "model"), (2, 2, 2), (8, 6)
    for spec in (t_sharding.P(("pod", "data"), "model"),
                 t_sharding.P(("pod", "data")), t_sharding.P(None, "data")):
        pl = t_sharding.pspec_placements(spec, StubMesh(names, sizes))
        for coord in np.ndindex(*sizes):
            local, off = _compute_local_shape_and_global_offset(
                shape, sizes, list(coord), pl)
            want = _jax_block(spec, names, sizes, shape, coord)
            assert [(o, o + n) for o, n in zip(off, local)] == want, (spec, coord)
    with pytest.raises(ValueError, match="mesh's order"):
        t_sharding.pspec_placements(t_sharding.P(("data", "pod")),
                                    StubMesh(names, sizes))


def _jax_block(spec, names, sizes, shape, coord):
    """The [start, stop) per dim that JAX's ``NamedSharding`` gives the
    device at mesh coordinate ``coord``: for a dim over axes (a1, a2, ...)
    the block index is the row-major index of the coordinates on those
    axes, a1 major (checked against JAX itself below)."""
    blocks = []
    full = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for dim, part in zip(shape, full):
        if part is None:
            blocks.append((0, dim))
            continue
        axes = (part,) if isinstance(part, str) else part
        idx, n = 0, 1
        for a in axes:
            i = names.index(a)
            idx = idx * sizes[i] + coord[i]
            n *= sizes[i]
        blocks.append((idx * dim // n, (idx + 1) * dim // n))
    return blocks


def test_jax_block_rule_is_named_shardings_own():
    """The block rule above against JAX's ``NamedSharding`` on 8 forced
    host devices (a subprocess)."""
    code = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, json
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for name, spec in (("pd_m", P(("pod", "data"), "model")), ("pd", P(("pod", "data"))),
                   ("_d", P(None, "data"))):
    idx = NamedSharding(mesh, spec).devices_indices_map((8, 6))
    rows = []
    for coord in [(p, d, m) for p in range(2) for d in range(2) for m in range(2)]:
        dev = mesh.devices[coord]
        sl = idx[dev]
        rows.append([[s.start or 0, s.stop if s.stop is not None else n]
                     for s, n in zip(sl, (8, 6))])
    out[name] = rows
print(json.dumps(out))
"""
    got = json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, env=_jax_env()).stdout.strip().splitlines()[-1])
    names, sizes = ("pod", "data", "model"), (2, 2, 2)
    specs = {"pd_m": t_sharding.P(("pod", "data"), "model"),
             "pd": t_sharding.P(("pod", "data")),
             "_d": t_sharding.P(None, "data")}
    for name, spec in specs.items():
        for k, coord in enumerate(np.ndindex(*sizes)):
            want = [list(b) for b in _jax_block(spec, names, sizes, (8, 6),
                                                coord)]
            assert got[name][k] == want, (name, coord)


def _jax_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return env


# ---------------------------------------------------------------------------
# every full config's specs on both production meshes
# ---------------------------------------------------------------------------

_REF_SPECS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax
from repro.configs.base import ARCH_IDS, MeshConfig, get_arch, get_shape
from repro.launch import steps
from repro.launch.mesh import make_production_mesh
from repro.models.model import build
from repro.models.sharding import make_rules

def spec(s):
    return [None if p is None else [p] if isinstance(p, str) else list(p)
            for p in tuple(s.spec)]

out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    rules = make_rules("client_serial", mp)
    for arch in ARCH_IDS:
        model = build(get_arch(arch))
        out[f"{arch}/{mp}/params"] = [
            spec(s) for s in jax.tree.leaves(steps.param_shardings(model, rules, mesh))]
        for sname in ("decode_32k", "long_500k"):
            caches = model.input_specs(get_shape(sname))["caches"]
            for ss in ("heads", "state", "state_convrep"):
                out[f"{arch}/{mp}/{sname}/{ss}"] = [
                    spec(s) for s in jax.tree.leaves(
                        steps.cache_shardings(caches, rules, mesh, ssm_shard=ss))]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_specs():
    res = subprocess.run([sys.executable, "-c", _REF_SPECS],
                         capture_output=True, text=True, env=_jax_env(),
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _as_norm(rows):
    return [tuple(None if p is None else tuple(p) for p in r) for r in rows]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", t_base.ARCH_IDS)
def test_full_config_param_and_cache_specs_equal_the_reference(
        ref_specs, arch, multi_pod):
    """Every param leaf's spec and placements; the decode caches' for
    ``decode_32k`` and ``long_500k`` under each ``ssm_shard``."""
    mesh = _mesh_stub(multi_pod)
    rules = t_sharding.make_rules("client_serial", multi_pod)
    model = t_model.build(t_base.get_arch(arch))
    got = t_steps.param_pspecs(model, rules, mesh)
    want = _as_norm(ref_specs[f"{arch}/{multi_pod}/params"])
    assert [_norm(s) for s in tree_leaves(got)] == want
    placed = tree_leaves(t_steps.param_shardings(model, rules, mesh))
    assert placed == [t_sharding.pspec_placements(t_sharding.P(*s), mesh)
                      for s in want]
    for sname in ("decode_32k", "long_500k"):
        caches = model.input_specs(t_base.get_shape(sname))["caches"]
        for ss in SSM_SHARDS:
            got = t_steps.cache_pspecs(caches, rules, mesh, ssm_shard=ss)
            want = _as_norm(ref_specs[f"{arch}/{multi_pod}/{sname}/{ss}"])
            assert [_norm(s) for s in tree_leaves(got)] == want, (sname, ss)


# ---------------------------------------------------------------------------
# step inputs
# ---------------------------------------------------------------------------


def _j_leaves(tree):
    import jax
    return [(tuple(l.shape), str(l.dtype)) for l in jax.tree.leaves(tree)]


def _t_leaves(tree):
    def walk(x):
        if isinstance(x, dict):
            return [l for k in sorted(x) for l in walk(x[k])]
        if isinstance(x, list):
            return [l for v in x for l in walk(v)]
        return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))]
    return walk(tree)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", t_base.ARCH_IDS)
def test_input_specs_equal_the_reference(arch, smoke):
    """``input_specs`` (and so ``cache_specs``) for every shape: smoke
    configs at a reduced shape, as ``tests/test_launch.py`` builds them,
    and the full configs at the real shapes (``meta`` tensors on the
    port's side, ``eval_shape`` on the reference's)."""
    jm = j_model.build(j_base.get_arch(arch, smoke=smoke))
    tm = t_model.build(t_base.get_arch(arch, smoke=smoke))
    for sname, shape in t_base.INPUT_SHAPES.items():
        if smoke:
            shape = dataclasses.replace(shape, seq_len=64, global_batch=2)
        jshape = dataclasses.replace(j_base.get_shape(sname),
                                     seq_len=shape.seq_len,
                                     global_batch=shape.global_batch)
        got, want = tm.input_specs(shape), jm.input_specs(jshape)
        assert sorted(got) == sorted(want), (sname, sorted(got))
        for key in want:
            assert _t_leaves(got[key]) == _j_leaves(want[key]), (sname, key)
        for t in tree_leaves(got):
            assert t.device.type == "meta"


# ---------------------------------------------------------------------------
# the context and its refusals
# ---------------------------------------------------------------------------


def test_constrain_is_the_identity_outside_a_context():
    x = torch.randn(2, 3)
    assert not shardctx.active()
    assert shardctx.constrain(x, "act_batch", None) is x
    tree = {"w": x}
    assert shardctx.unshard(tree) is tree


def test_constrain_on_a_plain_tensor_inside_a_context_raises():
    with shardctx.sharding_ctx(t_sharding.RULES_SERIAL, None):
        assert shardctx.active()
        with pytest.raises(TypeError, match="plain"):
            shardctx.constrain(torch.randn(2, 3), "act_batch", None)
    assert not shardctx.active()


def test_kernel_wrappers_refuse_a_dtensor():
    """A DTensor never reaches a kernel or its plain version as if it were
    whole: the wrappers raise (a fake group of one rank builds one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("fake", store=FakeStore(), world_size=1,
                                rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        x = distribute_tensor(torch.randn(1, 8), mesh, [Replicate()])
        q = distribute_tensor(torch.randn(1, 4, 2, 8), mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            t_dpk.sumsq_rows(x)
        with pytest.raises(TypeError, match="DTensor"):
            t_dpk.scale_noise_rows(x, x, torch.ones(1), 0.5)
        with pytest.raises(TypeError, match="DTensor"):
            t_kops.flash_attention(q, q, q)
        with pytest.raises(TypeError, match="DTensor"):
            t_kops.rglru_scan(x[None], x[None])
        with pytest.raises(TypeError, match="DTensor"):
            t_kops.flash_decode(q[:, 0], q, q, 4)
    finally:
        if own:
            dist.destroy_process_group()
