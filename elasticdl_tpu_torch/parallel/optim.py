"""Dense optimizers of the model zoo (``optax.adam``, ``optax.sgd``) over a
dict of parameter tensors, updated in place.

The operations and their order are optax's, so a step from the same
state and gradients gives the JAX trainer's values up to the rounding of
the ``pow`` in the bias correction:

    mu    = (1 - b1) * g + b1 * mu
    nu    = (1 - b2) * (g * g) + b2 * nu
    count = count + 1
    u     = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count) + 0) + eps)
    p     = p + (-lr) * u

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
from typing import Callable, Dict

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


def adam(
    learning_rate: float = 0.001, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8,
) -> DenseOptimizer:
    lr_neg, b1f, b2f = _f32(-learning_rate), _f32(b1), _f32(b2)
    omb1, omb2, epsf = _f32(1 - b1), _f32(1 - b2), _f32(eps)

    def init(params: Params) -> dict:
        device = next(iter(params.values())).device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict) -> None:
        keys = list(params)
        p = [params[k] for k in keys]
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
        updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom), lr_neg)
        torch._foreach_add_(p, updates)

    return DenseOptimizer("adam", init, apply)


def sgd(learning_rate: float = 0.01) -> DenseOptimizer:
    lr_neg = _f32(-learning_rate)

    def init(params: Params) -> dict:
        return {}

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict) -> None:
        keys = list(params)
        torch._foreach_add_(
            [params[k] for k in keys],
            torch._foreach_mul([grads[k] for k in keys], lr_neg),
        )

    return DenseOptimizer("sgd", init, apply)
