"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``
or ``chip_before_after.py``) imports JAX or the reference package, and its
entry points never run on the CPU unless asked to."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import FLConfig, fl_params
from repro_torch.core import rounds as t_rounds
from repro_torch.data.synthetic import make_federated
from repro_torch.device import resolve_device
from repro_torch.models import mlp as t_mlp
from repro_torch.train.fl_driver import run_fl, run_fl_legacy, run_fl_sweep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_before_after.py"]


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
    """Without ``device=``, run_fl_legacy, run_fl, run_fl_sweep and
    make_parallel_round go to CUDA: on a machine without a card they raise
    instead of running on the CPU."""
    fed = make_federated(0, "unsw", n_samples=300, n_clients=4)
    fl = FLConfig(n_clients=4, clients_per_round=2, local_epochs=1,
                  local_batch=8)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fl_legacy(fed, fl, rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fl(fed, fl, rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fl_sweep(fed, fl, [fl], seeds=(0,), rounds=1)
    assert run_fl(fed, fl, rounds=1, eval_every=1, device="cpu").rounds == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        t_rounds.make_parallel_round(t_mlp.mlp_loss, fl, 4)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_round_step_rejects_unported_plans_and_foreign_state():
    fl = FLConfig(n_clients=4, clients_per_round=2, local_epochs=1,
                  local_batch=8)
    with pytest.raises(NotImplementedError):
        t_rounds.make_parallel_round(
            t_mlp.mlp_loss, FLConfig(plan="hierarchical"), 4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = t_rounds.init_round_state(t_mlp.init_mlp(gen, 42, 16), fl, gen)
    step = t_rounds.make_parallel_round(t_mlp.mlp_loss, fl, 4, device="cpu")
    batches = {"x": torch.zeros(4, 1, 8, 42),
               "y": torch.zeros(4, 1, 8, dtype=torch.long)}
    new_state, metrics = step(state, batches)  # draws from state.rng
    assert new_state.round_idx == 1 and metrics.sel_mask.shape == (4,)
    with pytest.raises(NotImplementedError):
        step(state, batches, params=fl_params(fl)._replace(plan_code=1.0))
