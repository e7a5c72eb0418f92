"""Carry weights and round state across from the JAX package.

The inputs are NumPy values (``np.asarray`` of the JAX arrays, or anything
``np.asarray`` takes, such as CPU tensors): the MLP params as a nested dict
``{"l1": {"w", "b"}, ...}`` and the ``UtilityState`` / ``KControllerState``
/ ``FaultState`` NamedTuples (or mappings of their fields).  The layouts
are the reference's, so nothing is transposed.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import selection as sel_lib
from repro_torch.core.rounds import RoundState
from repro_torch.fault.process import FaultState
from repro_torch.optim.optimizers import make_server_optimizer
from repro_torch.tree import flatten_rows


def _fields(obj: Any) -> Mapping[str, Any]:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _tensor(value, device) -> torch.Tensor:
    return torch.as_tensor(np.array(value, dtype=np.float32), device=device)


def params_from_jax(tree: Mapping[str, Any], device) -> dict:
    """Nested dict of arrays -> nested dict of f32 tensors on ``device``."""
    return {k: (params_from_jax(v, device) if isinstance(v, Mapping)
                else _tensor(v, device)) for k, v in tree.items()}


def round_state_from_jax(params, util, kctl, fault, fl: FLConfig, device,
                         seed: int = 0, round_idx: int = 0) -> RoundState:
    """The port's :class:`RoundState` on ``device`` from the reference's
    params and states.  The server optimizer starts fresh, as the
    reference's ``init_round_state`` starts it; ``seed`` seeds the state's
    ``torch.Generator`` (used only when a round is not given its draws)."""
    device = torch.device(device)
    p = params_from_jax(params, device)
    server = make_server_optimizer(fl.server_opt, fl.server_lr)
    return RoundState(
        params=p,
        server_opt_state=server.init(flatten_rows(p, 0)),
        util=sel_lib.UtilityState(**{k: _tensor(v, device)
                                     for k, v in _fields(util).items()}),
        kctl=sel_lib.KControllerState(**{k: _tensor(v, device)
                                         for k, v in _fields(kctl).items()}),
        round_idx=int(round_idx),
        rng=torch.Generator(device=device).manual_seed(seed),
        fault=FaultState(**{k: _tensor(v, device)
                            for k, v in _fields(fault).items()}),
    )
