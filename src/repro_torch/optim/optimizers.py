"""Optimizers as pairs of pure functions (the port's copy of
``repro/optim/optimizers.py``'s ``sgd`` and ``make_server_optimizer``).

``init(params) -> state`` and ``update(grads, state, params) ->
(new_params, new_state)`` act elementwise on one tensor: the round step
keeps the global model as one flat vector in leaf order, or a ``[L, P]``
matrix of a sweep's lanes (Adam then keeps one step count a lane).  ``lr``
is a float or a tensor that broadcasts against the params (``[L, 1]``: one
server lr a lane).  Server-side,
FedAvg is SGD(1.0) on the aggregated pseudo-gradient; FedAvgM and FedAdam
are the FedOpt variants.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    name: str


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return () if momentum == 0.0 else torch.zeros_like(params)

    def update(grads, state, params):
        if momentum == 0.0:
            return params - lr * grads.float(), ()
        new_m = momentum * state + grads.float()
        return params - lr * new_m, new_m

    return Optimizer(init, update, f"sgd(m={momentum})")


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = torch.zeros_like(params)
        return AdamState(z, torch.zeros_like(z),
                         torch.zeros((), dtype=torch.int32,
                                     device=params.device))

    def update(grads, state, params):
        c = state.count + 1
        g = grads.float()
        mu = b1 * state.mu + (1 - b1) * g
        nu = b2 * state.nu + (1 - b2) * g * g
        # one count a lane ([L]) against [L, P] moments
        cf = c.float().reshape(c.shape + (1,) * (g.dim() - c.dim()))
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        return params - lr * upd, AdamState(mu, nu, c)

    return Optimizer(init, update, "adam")


def make_server_optimizer(name: str, lr: float) -> Optimizer:
    if name == "sgd":  # FedAvg when lr == 1.0
        base = sgd(lr)
    elif name == "fedavgm":
        base = sgd(lr, momentum=0.9)
    elif name == "fedadam":
        base = adam(lr, b1=0.9, b2=0.99, eps=1e-3)
    else:
        raise ValueError(name)

    # server consumes a pseudo-gradient = -Δ (so that w <- w + lr·Δ for sgd)
    def update(agg_delta, state, params):
        return base.update(-agg_delta, state, params)

    return Optimizer(base.init, update, f"server_{base.name}")
