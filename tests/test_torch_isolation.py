"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``,
``chip_before_after.py`` or ``chip_round_ab.py``) imports JAX or the
reference package, and its entry points never run on the CPU unless asked
to."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import FLConfig, fl_params
from repro_torch.core import rounds as t_rounds
from repro_torch.data.synthetic import make_federated, make_population
from repro_torch.configs.base import get_arch
from repro_torch.core.fault import FailureModel
from repro_torch.device import resolve_device
from repro_torch.launch import fl_train as t_fl_train
from repro_torch.launch import serve as t_serve
from repro_torch.models.model import build as build_lm
from repro_torch.models import mlp as t_mlp
from repro_torch.train.fl_driver import (run_fl, run_fl_legacy,
                                         run_fl_population, run_fl_sweep)
from repro_torch.tree import flatten_rows, tree_map

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_before_after.py",
    ROOT / "chip_round_ab.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_reference():
    assert len(PORT_FILES) > 35
    bad = [(str(p.relative_to(ROOT)), m) for p in PORT_FILES
           for m in _imports(p) if _forbidden(m)]
    assert not bad, bad
    # the check itself: these are caught, the port's own package is not
    assert _forbidden("jax.numpy") and _forbidden("repro.core.dp")
    assert not _forbidden("repro_torch.core.dp")


def test_entry_points_default_to_cuda():
    """Without ``device=``, run_fl_legacy, run_fl, run_fl_sweep,
    run_fl_population, make_parallel_round, make_cohort_round,
    ``FailureModel`` and the FL CLI (``launch/fl_train.py`` without
    ``--device``) go to CUDA: on a machine without a card they raise
    instead of running on the CPU."""
    fed = make_federated(0, "unsw", n_samples=300, n_clients=4)
    fl = FLConfig(n_clients=4, clients_per_round=2, local_epochs=1,
                  local_batch=8)
    pop = make_population(0, n_clients=64, pool_samples=400,
                          members_per_client=8)
    pop_fl = FLConfig(n_clients=64, clients_per_round=4, k_max=4,
                      local_epochs=1, local_batch=8)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fl_legacy(fed, fl, rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fl(fed, fl, rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fl_sweep(fed, fl, [fl], seeds=(0,), rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fl_population(pop, pop_fl, rounds=1)
    assert run_fl(fed, fl, rounds=1, eval_every=1, device="cpu").rounds == 1
    assert run_fl_population(pop, pop_fl, rounds=1, eval_every=1,
                             device="cpu")[0][0].rounds == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        t_rounds.make_parallel_round(t_mlp.mlp_loss, fl, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_rounds.make_cohort_round(t_mlp.mlp_loss, pop_fl, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        FailureModel()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_fl_train.main(["--rounds", "1", "--clients", "4",
                         "--samples", "300"])
    assert FailureModel(device="cpu").sample(
        torch.Generator().manual_seed(0), 4).device.type == "cpu"
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_lm_entry_points_default_to_cuda():
    """``Model.init``, ``Model.init_cache`` without params and the LM serve
    CLI (``repro_torch.launch.serve.main``) go to CUDA unless given the
    CPU: without a card they raise."""
    model = build_lm(get_arch("granite_3_8b", smoke=True))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.main(["--arch", "granite_3_8b", "--batch", "1",
                      "--prompt-len", "2", "--new-tokens", "1"])
    params = model.init(0, device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
    assert model.init_cache(1, 4, params=params)[0]["b0"]["k"].device.type \
        == "cpu"


def test_round_step_rejects_unported_plans_and_foreign_state():
    """Plan codes 1 (buffered_async) and 2 (hierarchical) run through the
    one-run step, from the config or as a call's ``plan_code``; the
    ``client_serial`` and ``client_cohort`` families are not the lane
    step's and raise; a state on another device than the step's is
    refused."""
    fl = FLConfig(n_clients=4, clients_per_round=2, local_epochs=1,
                  local_batch=8)
    for other in (FLConfig(plan="client_serial"),
                  FLConfig(plan="client_cohort", k_max=2)):
        with pytest.raises(NotImplementedError):
            t_rounds.make_parallel_round(t_mlp.mlp_loss, other, 4,
                                         device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = t_rounds.init_round_state(t_mlp.init_mlp(gen, 42, 16), fl, gen)
    step = t_rounds.make_parallel_round(t_mlp.mlp_loss, fl, 4, device="cpu")
    batches = {"x": torch.zeros(4, 1, 8, 42),
               "y": torch.zeros(4, 1, 8, dtype=torch.long)}
    new_state, metrics = step(state, batches)  # draws from state.rng
    assert new_state.round_idx == 1 and metrics.sel_mask.shape == (4,)
    for code in (1.0, 2.0):
        coded, _ = step(state, batches, params=fl_params(fl)._replace(
            plan_code=code, async_buffer=2.0))
        assert coded.round_idx == 1
        assert torch.isfinite(flatten_rows(coded.params, 0)).all()
    hier = t_rounds.make_parallel_round(
        t_mlp.mlp_loss, FLConfig(n_clients=4, clients_per_round=2,
                                 plan="hierarchical", hierarchy_edges=3),
        4, device="cpu")
    assert hier(state, batches)[0].round_idx == 1
    foreign = state._replace(params=tree_map(lambda t: t.to("meta"),
                                             state.params))
    with pytest.raises(ValueError, match="built for"):
        step(foreign, batches)
