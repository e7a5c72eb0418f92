"""The sweep and population engines laid across ranks (``train/fl_driver.py``)
on a real 4-process gloo group, held against the same engines on one
process, at the reference's own bars.

One spawn for the file: the fixture starts four copies of this file as
workers (``--worker``, ``file://`` rendezvous under ``tmp_path``); each
runs every case and saves its results, and the tests compare every rank's
with the unsharded runs made here.  Ports of three reference checks:

* ``tests/test_sweep.py:234``: ``run_fl_sweep`` of 2 cells × 2 seeds, one
  lane a rank on the 1-D ``("lane",)`` mesh, against ``run_fl`` of the
  same cell and seed (accuracy and its history within 1e-5); here also
  every lane against the unsharded sweep, and 6 lanes (padded to 8, two a
  rank) likewise;
* ``tests/test_scale.py:386``: ``run_fl_population`` on the
  ``(lane, client)`` meshes (4, 1), (2, 2) and (1, 4) against
  ``shard=False``: every history column bitwise but ``loss``, within
  5e-5; scheduled privacy on (2, 2) too, its ``eps`` bitwise;
* ``tests/test_models.py:390``: the ``ssm`` detector with the
  model-sharding hook forced (``model_replicated_max_bytes=0``) on (2, 2)
  and (1, 4) against the replicated run: ``loss`` within 1e-5, the rest
  bitwise.

And ``tests/test_models.py:270``'s structure test of ``param_axes``, with
``constrain_params`` the identity outside a sharding context.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import make_federated, make_population
from repro_torch.models.spec import DataMeta, get_model_spec
from repro_torch.train import fl_driver
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

WORLD = 4
POP_SHAPES = ((4, 1), (2, 2), (1, 4))
SSM_SHAPES = ((2, 2), (1, 4))
SEEDS = (0, 1, 2, 3)


def _fed():
    fed = make_federated(0, "unsw", n_samples=800, n_clients=6)
    fl = FLConfig(n_clients=6, clients_per_round=3, rounds=6, local_epochs=2,
                  local_batch=16, dp_enabled=True, dp_mode="clipped",
                  dp_epsilon=300.0, dp_clip=5.0, fault_tolerance=True)
    cells = [dataclasses.replace(fl, dp_epsilon=e) for e in (100.0, 300.0)]
    return fed, fl, cells


def _pop():
    pop = make_population(0, n_clients=64, pool_samples=600,
                          members_per_client=16)
    fl = FLConfig(n_clients=64, clients_per_round=8, k_max=8, rounds=6,
                  local_epochs=2, local_batch=16, fault_tolerance=True,
                  failure_prob=0.05)
    fl_dp = dataclasses.replace(fl, dp_enabled=True, dp_scheduled=True,
                                dp_mode="clipped", adaptive_k=True)
    return pop, fl, fl_dp


def _ssm():
    pop = make_population(0, dataset="road_raw", n_clients=32,
                          pool_samples=500, members_per_client=16)
    fl = FLConfig(n_clients=32, clients_per_round=4, k_max=4, rounds=4,
                  local_epochs=2, local_batch=16, model="ssm",
                  dp_enabled=False, fault_tolerance=True, failure_prob=0.05)
    return pop, fl


def _rows(res):
    """What a result grid is compared on: every history column, the final
    accuracy and AUC, the simulated time and ε, a lane at a time."""
    return [[{"history": r.history, "accuracy": r.accuracy, "auc": r.auc,
              "sim_time_s": r.sim_time_s, "eps_spent": r.eps_spent}
             for r in row] for row in res]


SWEEP = dict(rounds=6, eval_every=3, device="cpu")
POP = dict(seeds=SEEDS, rounds=6, eval_every=3, device="cpu")
SSM = dict(seeds=(0, 1), method="random", rounds=4, eval_every=2,
           dataset="road_raw", device="cpu")


def _cases(sharded: bool) -> dict:
    """Every case's results: on a group's ranks (``sharded``), or here on
    one process (the references)."""
    fed, fl, cells = _fed()
    out = {"sweep": _rows(fl_driver.run_fl_sweep(fed, fl, cells,
                                                 seeds=(0, 1), **SWEEP)),
           "sweep6": _rows(fl_driver.run_fl_sweep(fed, fl, cells,
                                                  seeds=(0, 1, 2), **SWEEP))}
    pop, flp, fl_dp = _pop()
    spop, fls = _ssm()
    if sharded:
        for shape in POP_SHAPES:
            out[f"pop{shape}"] = _rows(fl_driver.run_fl_population(
                pop, flp, mesh_shape=shape, **POP))
        out["pop_dp"] = _rows(fl_driver.run_fl_population(
            pop, fl_dp, mesh_shape=(2, 2), **POP))
        for shape in SSM_SHAPES:
            out[f"ssm{shape}"] = _rows(fl_driver.run_fl_population(
                spop, fls, mesh_shape=shape, model_replicated_max_bytes=0,
                **SSM))
    else:
        out["run_fl"] = _rows([[fl_driver.run_fl(fed, cells[0], seed=1,
                                                 **SWEEP)]])
        out["pop"] = _rows(fl_driver.run_fl_population(pop, flp, shard=False,
                                                       **POP))
        out["pop_dp"] = _rows(fl_driver.run_fl_population(
            pop, fl_dp, shard=False, **POP))
        out["ssm"] = _rows(fl_driver.run_fl_population(spop, fls,
                                                       shard=False, **SSM))
    return out


def _counting(cls, name: str, counts: dict):
    """Count the calls of ``cls.name`` (a witness that a layout ran)."""
    fn = getattr(cls, name)

    def counted(*a, **k):
        counts[cls.__name__] = counts.get(cls.__name__, 0) + 1
        return fn(*a, **k)

    setattr(cls, name, staticmethod(counted) if name == "over" else counted)


def _worker(rank: int, init: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.core import rounds as rounds_lib
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=WORLD)
    counts = {}
    _counting(fl_driver._LaneSplit, "over", counts)
    _counting(rounds_lib.ClientShard, "topk", counts)
    _counting(fl_driver._ModelSplit, "whole", counts)
    res = _cases(sharded=True)
    res["layouts"] = counts
    res["runner_stats"] = dict(fl_driver.RUNNER_STATS)
    torch.save(res, f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    out = tmp / "engines.pt"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = str(Path(__file__).resolve().parent.parent / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(tmp / "rdzv"),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    want = _cases(sharded=False)
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(f"{out}.{r}", weights_only=False)
             for r in range(WORLD)]
    return ranks, want


def _compare(got, want, tol: float, what: str):
    """The reference's ``compare``: every history column equal, ``loss``
    within ``tol``; the final scalars as their columns."""
    assert len(got) == len(want)
    for grow, wrow in zip(got, want):
        assert len(grow) == len(wrow)
        for g, w in zip(grow, wrow):
            for col, a in w["history"].items():
                b = g["history"][col]
                if col == "loss":
                    np.testing.assert_allclose(b, a, atol=tol, rtol=0,
                                               err_msg=f"{what} {col}")
                else:
                    assert a == b, (what, col, a, b)
            for k in ("accuracy", "auc", "sim_time_s", "eps_spent"):
                assert g[k] == w[k], (what, k, g[k], w[k])


def test_every_rank_returns_the_whole_results(runs):
    """Each rank reads back every lane: the four ranks' results are the
    same."""
    ranks, _ = runs
    for other in ranks[1:]:
        for key in ranks[0]:
            if key not in ("runner_stats", "layouts"):
                assert other[key] == ranks[0][key], key
    # the layouts ran: a lane split a sweep and a population call (7),
    # the client shard's top-k every round of the client-split runs
    # ((2, 2) and (1, 4) × 6 rounds, the scheduled one, the ssm ones ×
    # 4 rounds) and the model split's gather each round and eval
    counts = ranks[0]["layouts"]
    assert counts["_LaneSplit"] == 2 + len(POP_SHAPES) + 1 + len(SSM_SHAPES)
    assert counts["ClientShard"] == 6 * 2 + 6 + 4 * len(SSM_SHAPES)
    assert counts["_ModelSplit"] >= 4 * len(SSM_SHAPES)


@pytest.mark.parametrize("case", ["sweep", "sweep6"])
def test_sweep_lane_mesh_matches_one_process(runs, case):
    """``tests/test_sweep.py:234``: lane (cell 0, seed 1) of 4 lanes on 4
    ranks equals ``run_fl`` of that cell and seed (accuracy and its
    history within 1e-5; finite simulated times); and every lane, of 4 and
    of 6 (two a rank, the last repeated to pad 8), equals the unsharded
    sweep's within 1e-5 in every column."""
    ranks, want = runs
    got = ranks[0][case]
    if case == "sweep":
        one = want["run_fl"][0][0]
        np.testing.assert_allclose(got[0][1]["accuracy"], one["accuracy"],
                                   atol=1e-5)
        np.testing.assert_allclose(got[0][1]["history"]["acc"],
                                   one["history"]["acc"], atol=1e-5)
    assert len(got) == 2 and len(got[0]) == (2 if case == "sweep" else 3)
    for grow, wrow in zip(got, want[case]):
        for g, w in zip(grow, wrow):
            assert np.isfinite(g["sim_time_s"])
            for col, a in w["history"].items():
                np.testing.assert_allclose(g["history"][col], a, atol=1e-5,
                                           err_msg=f"{case} {col}")


@pytest.mark.parametrize("shape", POP_SHAPES)
def test_population_mesh_matches_one_process(runs, shape):
    """``tests/test_scale.py:386``: the population on a (lane, client)
    mesh, lanes over ``lane`` and the 64 clients' state over ``client``,
    reproduces ``shard=False``: every column bitwise but ``loss``, within
    5e-5."""
    ranks, want = runs
    _compare(ranks[0][f"pop{shape}"], want["pop"], 5e-5,
             f"population mesh {shape}")


def test_population_scheduled_privacy_on_a_mesh(runs):
    """The scheduled-privacy carries (the accountant, the scheduler) on the
    (2, 2) mesh: as above, and ``eps`` bitwise."""
    ranks, want = runs
    got = ranks[0]["pop_dp"]
    _compare(got, want["pop_dp"], 5e-5, "population scheduled (2, 2)")
    assert all(g["history"]["eps"] == w["history"]["eps"]
               for g, w in zip(got[0], want["pop_dp"][0]))
    assert "eps" in got[0][0]["history"]


@pytest.mark.parametrize("shape", SSM_SHAPES)
def test_sharded_ssm_matches_replicated(runs, shape):
    """``tests/test_models.py:390``: the ``ssm`` detector with its wide
    leaves split over ``client`` (the ``param_axes`` hook forced by
    ``model_replicated_max_bytes=0``) reproduces the replicated run:
    ``loss`` within 1e-5, every other column bitwise."""
    ranks, want = runs
    _compare(ranks[0][f"ssm{shape}"], want["ssm"], 1e-5, f"ssm {shape}")


def test_param_axes_structure_matches_init():
    """``tests/test_models.py:270``: ``param_axes()`` has ``init``'s tree,
    one tuple of names a leaf of that leaf's rank; ``constrain_params``
    outside any sharding context returns the same leaves; ``mlp`` opts
    out."""
    meta = DataMeta(n_features=384, n_classes=2, hidden=64,
                    feature_shape=(64, 6))
    for name in ("ssm", "attn"):
        spec = get_model_spec(name, meta)
        assert spec.param_axes is not None
        params = spec.init(torch.Generator().manual_seed(0))
        axes = spec.param_axes()
        leaves, ax = tree_leaves(params), tree_leaves(axes)
        assert len(ax) == len(leaves)
        for leaf, a in zip(leaves, ax):
            assert isinstance(a, tuple) and len(a) == leaf.dim(), (name, a)
        out = spec.constrain_params(params)
        assert all(a is b for a, b in zip(tree_leaves(out), leaves))
        assert any("mlp" in a or "heads" in a for a in ax)
    assert get_model_spec("mlp", meta).param_axes is None


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
