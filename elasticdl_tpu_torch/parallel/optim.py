"""Dense optimizers of the model zoo (``optax.adam``, ``optax.adamw``,
``optax.sgd`` with or without (Nesterov) momentum) over a dict of
parameter tensors, updated in place.

The operations and their order are optax's, so a step from the same
state and gradients gives the JAX trainer's values up to the rounding of
the ``pow`` in the bias correction:

    mu    = (1 - b1) * g + b1 * mu
    nu    = (1 - b2) * (g * g) + b2 * nu
    count = count + 1
    u     = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count) + 0) + eps)
    p     = p + (-lr) * u

``adamw`` is optax's chain in optax's order: the Adam direction ``u``
above, then ``add_decayed_weights`` over every parameter (``u + wd *
p``), then the scale by ``-lr``.

``torch.optim.Adam`` folds the corrections differently (``sqrt(v) /
sqrt(bc2) + eps``, then ``lr / bc1``), which changes the bits for
nothing, so it is not used.  Constants are rounded to f32 as JAX rounds
its weakly typed Python floats (``1 - b1`` formed in double).  The
per-tensor arithmetic runs as ``torch._foreach_*`` ops: the same
elementwise operations in fewer launches.  ``count`` stays a device
scalar, so a step never waits on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class DenseOptimizer:
    """init(params) -> state; apply(params, grads, state) updates params
    and state in place (under ``torch.no_grad``)."""

    name: str
    init: Callable[[Params], dict]
    apply: Callable[[Params, Params, dict], None]


def _scale_by_adam(b1: float, b2: float, eps: float):
    """optax ``scale_by_adam``: ``(init, direction)``, where
    ``direction(keys, grads, state)`` updates the moments and the count
    in place and returns the Adam direction ``mu_hat / (sqrt(nu_hat +
    0) + eps)`` per key."""
    b1f, b2f = _f32(b1), _f32(b2)
    omb1, omb2, epsf = _f32(1 - b1), _f32(1 - b2), _f32(eps)

    def init(params: Params) -> dict:
        device = next(iter(params.values())).device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    def direction(keys, grads: Params, state: dict):
        g = [grads[k] for k in keys]
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        torch._foreach_copy_(mu, torch._foreach_add(
            torch._foreach_mul(g, omb1), torch._foreach_mul(mu, b1f)))
        gg = torch._foreach_mul(g, g)
        torch._foreach_copy_(nu, torch._foreach_add(
            torch._foreach_mul(gg, omb2), torch._foreach_mul(nu, b2f)))
        count = state["count"]
        count.add_(1)
        exponent = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.full((), b1f, device=count.device), exponent)
        bc2 = 1.0 - torch.pow(torch.full((), b2f, device=count.device), exponent)
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(nu_hat, 0.0)), epsf)
        return torch._foreach_div(mu_hat, denom)

    return init, direction


def adam(
    learning_rate: float = 0.001, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8,
) -> DenseOptimizer:
    lr_neg = _f32(-learning_rate)
    init, direction = _scale_by_adam(b1, b2, eps)

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict) -> None:
        keys = list(params)
        updates = torch._foreach_mul(direction(keys, grads, state), lr_neg)
        torch._foreach_add_([params[k] for k in keys], updates)

    return DenseOptimizer("adam", init, apply)


def adamw(
    learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> DenseOptimizer:
    """optax ``adamw`` with ``mask=None`` (every parameter decays)."""
    lr_neg, wd = _f32(-learning_rate), _f32(weight_decay)
    init, direction = _scale_by_adam(b1, b2, eps)

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict) -> None:
        keys = list(params)
        p = [params[k] for k in keys]
        u = torch._foreach_add(direction(keys, grads, state), torch._foreach_mul(p, wd))
        torch._foreach_add_(p, torch._foreach_mul(u, lr_neg))

    return DenseOptimizer("adamw", init, apply)


def sgd(learning_rate: float = 0.01, momentum: Optional[float] = None,
        nesterov: bool = False) -> DenseOptimizer:
    """optax ``sgd``: ``chain(trace(momentum, nesterov), scale(-lr))``, or
    ``chain(identity, scale(-lr))`` without momentum.  With momentum the
    state is ``{"trace": {key: tensor}}``, optax's ``TraceState``:

        trace = g + momentum * trace
        u     = g + momentum * trace   if nesterov else trace
        p     = p + (-lr) * u
    """
    lr_neg = _f32(-learning_rate)
    decay = None if momentum is None else _f32(momentum)

    def init(params: Params) -> dict:
        if decay is None:
            return {}
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict) -> None:
        keys = list(params)
        g = [grads[k] for k in keys]
        if decay is not None:
            trace = [state["trace"][k] for k in keys]
            torch._foreach_copy_(trace, torch._foreach_add(g, torch._foreach_mul(trace, decay)))
            g = torch._foreach_add(g, torch._foreach_mul(trace, decay)) if nesterov else trace
        torch._foreach_add_([params[k] for k in keys], torch._foreach_mul(g, lr_neg))

    return DenseOptimizer("sgd", init, apply)
