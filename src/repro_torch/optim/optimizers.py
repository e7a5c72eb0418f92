"""Optimizers as pairs of pure functions: the port's copy of
``repro/optim/optimizers.py``.

``init(params) -> state`` and ``update(grads, state, params) ->
(new_params, new_state)``, in two forms:

* the flat form (``sgd``, ``adam``, ``make_server_optimizer``) acts
  elementwise on one tensor: the lane step keeps the global model as one
  flat vector in leaf order, or a ``[L, P]`` matrix of a sweep's lanes
  (Adam then keeps one step count a lane).  ``lr`` is a float or a tensor
  that broadcasts against the params (``[L, 1]``: one server lr a lane).
* the tree form (``tree_sgd``, ``tree_adam``, ``tree_adamw``,
  ``make_tree_server_optimizer``) acts on a param tree (``tree.py``) with
  the reference's dtype rule: every step is computed in f32 and cast back
  to the leaf's dtype once, ``(p − lr·s).astype(p.dtype)``, so bf16 params
  round once a step.  The serial round (``core/rounds.py``
  ``make_serial_round``) trains and serves its LM trees with it.

Server-side, FedAvg is SGD(1.0) on the aggregated pseudo-gradient; FedAvgM
and FedAdam are the FedOpt variants.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


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


# ---------------------------------------------------------------------------
# Tree form, with the reference's dtype rule (repro/optim/optimizers.py)
# ---------------------------------------------------------------------------


def _weak(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as JAX's weak type makes it beside ``like``: rounded
    to ``like``'s dtype first (bf16·float multiplies two bf16 values)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def tree_sgd(lr: float, momentum: float = 0.0, nesterov: bool = False,
             weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def update(grads, state, params):
        if weight_decay:
            grads = tree_map(lambda g, p: g + _weak(weight_decay, g)
                             * p.to(g.dtype), grads, params)
        if momentum == 0.0:
            return tree_map(lambda p, g: (p.float() - lr * g.float())
                            .to(p.dtype), params, grads), ()
        new_m = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        step = (tree_map(lambda m, g: momentum * m + g.float(), new_m, grads)
                if nesterov else new_m)
        new_p = tree_map(lambda p, s: (p.float() - lr * s).to(p.dtype),
                         params, step)
        return new_p, new_m

    return Optimizer(init, update, f"sgd(lr={lr},m={momentum})")


def tree_adam(lr: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return AdamState(z, tree_map(torch.zeros_like, z),
                         torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device))

    def update(grads, state, params):
        c = state.count + 1
        gf = tree_map(lambda g: g.float(), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, gf)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, gf)
        cf = c.float()
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf

        def step(p, m, v):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        return tree_map(step, params, mu, nu), AdamState(mu, nu, c)

    return Optimizer(init, update, f"adam(lr={lr})")


def tree_adamw(lr: float, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    return tree_adam(lr, b1, b2, eps, weight_decay)._replace(
        name=f"adamw(lr={lr})")


def make_tree_server_optimizer(name: str, lr: float) -> Optimizer:
    """:func:`make_server_optimizer` over a param tree."""
    if name == "sgd":  # FedAvg when lr == 1.0
        base = tree_sgd(lr)
    elif name == "fedavgm":
        base = tree_sgd(lr, momentum=0.9)
    elif name == "fedadam":
        base = tree_adam(lr, b1=0.9, b2=0.99, eps=1e-3)
    else:
        raise ValueError(name)

    def update(agg_delta, state, params):
        return base.update(tree_map(lambda d: -d, agg_delta), state, params)

    return Optimizer(base.init, update, f"server_{base.name}")
