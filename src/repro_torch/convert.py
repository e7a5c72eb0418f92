"""Carry weights and round state across from the JAX package.

The inputs are NumPy values (``np.asarray`` of the JAX arrays, or anything
``np.asarray`` takes, such as CPU tensors): the MLP params as a nested dict
``{"l1": {"w", "b"}, ...}`` and the ``UtilityState`` / ``KControllerState``
/ ``FaultState`` NamedTuples (or mappings of their fields), cast to f32;
the language model's params and KV caches (nested dicts and lists), each
leaf in its own dtype; the ``client_serial`` plan's round state with its
server optimizer's state over the param tree.  The layouts are the
reference's, so nothing is transposed.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import selection as sel_lib
from repro_torch.core.rounds import RoundState
from repro_torch.fault.process import FaultState
from repro_torch.optim.optimizers import AdamState, make_server_optimizer
from repro_torch.tree import flatten_rows


def _fields(obj: Any) -> Mapping[str, Any]:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _tensor(value, device) -> torch.Tensor:
    return torch.as_tensor(np.array(value, dtype=np.float32), device=device)


def _leaf(value, device) -> torch.Tensor:
    """One array as a tensor of the same dtype.  A bf16 array (NumPy's
    ``bfloat16`` extension type) goes across by its bits."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def lm_params_from_jax(tree, device):
    """The LM's param tree (or any tree of dicts and lists of arrays) ->
    the same tree of tensors on ``device``, each leaf keeping its dtype."""
    if isinstance(tree, Mapping):
        return {k: lm_params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_from_jax(v, device) for v in tree]
    return _leaf(tree, device)


lm_caches_from_jax = lm_params_from_jax  # caches are trees of arrays too


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


def serial_round_state_from_jax(params, server_opt_state, util, kctl, fault,
                                fl: FLConfig, device, seed: int = 0,
                                round_idx: int = 0) -> RoundState:
    """The ``client_serial`` plan's :class:`RoundState` on ``device`` from
    the reference's: the param tree through :func:`lm_params_from_jax`
    (each leaf keeps its dtype), the server state over the tree (``()``
    for SGD, a momentum tree, or ``AdamState`` of trees and its count), the
    utility, K-controller and fault states in f32.  ``seed`` seeds the
    state's ``torch.Generator``."""
    device = torch.device(device)
    if hasattr(server_opt_state, "_fields"):
        server = AdamState(lm_params_from_jax(server_opt_state.mu, device),
                           lm_params_from_jax(server_opt_state.nu, device),
                           _leaf(server_opt_state.count, device))
    elif len(server_opt_state) == 0:
        server = ()
    else:
        server = lm_params_from_jax(server_opt_state, device)
    return RoundState(
        params=lm_params_from_jax(params, device),
        server_opt_state=server,
        util=sel_lib.UtilityState(**{k: _tensor(v, device)
                                     for k, v in _fields(util).items()}),
        kctl=sel_lib.KControllerState(**{k: _tensor(v, device)
                                         for k, v in _fields(kctl).items()}),
        round_idx=int(round_idx),
        rng=torch.Generator(device=device).manual_seed(seed),
        fault=FaultState(**{k: _tensor(v, device)
                            for k, v in _fields(fault).items()}),
    )
