"""Sparse row-wise optimizers over the port's embedding tables.

Counterpart of ``elasticdl_tpu/parallel/sparse_optim.py``.  Tables and
slots are ``[vocab_padded, dim_padded]`` f32 rows (``parallel/packed.py``);
``apply`` updates them IN PLACE through ``ops.sparse_embedding.
fused_dedup_apply``: the hand-written kernel on a CUDA tensor, its plain
version (the JAX scatter path, step for step) on a CPU tensor.

Semantics (the JAX package's, and the reference's sparse-apply
contract): duplicate ids within an apply contribute their SUMMED
gradient and cause one row update; rows whose summed gradient is exactly
zero are untouched (no moment decay, no step count); ids outside ``[0,
vocab_padded)`` are dropped.

``mode`` is accepted for the JAX signature's sake and selects nothing:
the JAX package's stream / scatter / fused engines all meet this one
contract (``tests/test_sparse_kernels.py``), and the port has one engine.
``mesh`` selects the dispatch route of the apply: a mesh of more than
one slot takes the sharded route of ``fused_dedup_apply`` (tables and
their slots split over the ``model`` axis).  ``remake(mode, mesh)``
rebuilds an optimizer with another mode and mesh and the same
hyperparameters, as the JAX trainer does to thread its mesh.
The streaming ``apply_acc`` (one step from an already accumulated
gradient table) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch

from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel.packed import PackedSpec

_MODES = ("auto", "stream", "scatter", "fused")


@dataclass(frozen=True)
class SparseOptimizer:
    """A row-wise optimizer over row-form tables.

    init_slots(spec, table) -> slots dict (zeros, on the table's device);
    apply(spec, table, slots, ids, grads) -> (table, slots), in place.
    ids: int32 [n] row ids; grads: f32 [n, dim].
    """

    name: str
    kind: str
    init_slots: Callable[..., Dict[str, torch.Tensor]]
    hyperparams: dict = field(default_factory=dict)
    mode: str = "auto"
    mesh: Any = None

    def apply(self, spec: PackedSpec, table, slots, ids, grads) -> Tuple:
        # Looked up at call time, so a caller can patch the module's
        # function (chip_smoke.py runs the plain version that way); a
        # one-card optimizer calls it with the one-card signature.
        mesh = {} if self.mesh is None else {"mesh": self.mesh}
        return ske.fused_dedup_apply(
            spec, self.kind, self.hyperparams, table, slots, ids, grads, **mesh
        )

    def remake(self, mode: str, mesh=None) -> "SparseOptimizer":
        """This optimizer with another ``mode`` and dispatch ``mesh``."""
        _check_mode(mode)
        return dataclasses.replace(self, mode=mode, mesh=mesh)


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")


def _zeros_slots(*names):
    def init_slots(spec: PackedSpec, table: torch.Tensor):
        return {name: torch.zeros_like(table) for name in names}

    return init_slots


def sgd(learning_rate: float = 0.01, mode: str = "auto", mesh=None) -> SparseOptimizer:
    _check_mode(mode)
    return SparseOptimizer(
        "sgd", "sgd", _zeros_slots(), {"learning_rate": learning_rate}, mode, mesh
    )


def momentum(
    learning_rate: float = 0.01, mu: float = 0.9, nesterov: bool = False,
    mode: str = "auto", mesh=None,
) -> SparseOptimizer:
    _check_mode(mode)
    hyper = {"learning_rate": learning_rate, "momentum": mu, "nesterov": nesterov}
    return SparseOptimizer("momentum", "momentum", _zeros_slots("momentum"), hyper, mode, mesh)


def adagrad(
    learning_rate: float = 0.01, epsilon: float = 1e-7, mode: str = "auto", mesh=None,
) -> SparseOptimizer:
    _check_mode(mode)
    hyper = {"learning_rate": learning_rate, "epsilon": epsilon}
    return SparseOptimizer("adagrad", "adagrad", _zeros_slots("accumulator"), hyper, mode, mesh)


def adam(
    learning_rate: float = 0.001,
    beta_1: float = 0.9,
    beta_2: float = 0.999,
    epsilon: float = 1e-8,
    mode: str = "auto",
    bias_correction: str = "per_row",
    mesh=None,
) -> SparseOptimizer:
    """Sparse Adam.  ``bias_correction="per_row"``: each row's correction
    uses its own touch count, slot ``t`` (f32, the count repeated over the
    row's real lanes, zero on pad lanes); ``"global"``: one shared apply
    counter, the scalar slot ``t_global``."""
    _check_mode(mode)
    if bias_correction not in ("per_row", "global"):
        raise ValueError(
            f"bias_correction must be per_row|global, got {bias_correction!r}"
        )
    per_row = bias_correction == "per_row"

    def init_slots(spec: PackedSpec, table: torch.Tensor):
        slots = {"m": torch.zeros_like(table), "v": torch.zeros_like(table)}
        if per_row:
            slots["t"] = torch.zeros_like(table)
        else:
            slots["t_global"] = torch.zeros((), dtype=torch.float32, device=table.device)
        return slots

    hyper = {"learning_rate": learning_rate, "beta_1": beta_1, "beta_2": beta_2,
             "epsilon": epsilon, "bias_correction": bias_correction}
    return SparseOptimizer(
        "adam", "adam" if per_row else "adam_global", init_slots, hyper, mode, mesh
    )


_BY_NAME = {"sgd": sgd, "momentum": momentum, "adagrad": adagrad, "adam": adam}


def by_name(name: str, **hyperparams) -> SparseOptimizer:
    if name not in _BY_NAME:
        raise ValueError(f"Unknown sparse optimizer {name!r}; have {sorted(_BY_NAME)}")
    return _BY_NAME[name](**hyperparams)
