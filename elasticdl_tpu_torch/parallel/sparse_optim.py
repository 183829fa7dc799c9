"""Sparse row-wise optimizers over the port's embedding tables.

Counterpart of ``elasticdl_tpu/parallel/sparse_optim.py``.  Tables and
slots are ``[vocab_padded, dim_padded]`` f32 rows (``parallel/packed.py``);
``apply`` and ``apply_acc`` update them IN PLACE and return ``(table,
slots)``.

Semantics (the JAX package's, and the reference's sparse-apply
contract): duplicate ids within an apply contribute their SUMMED
gradient and cause one row update; rows whose summed gradient is exactly
zero are untouched (no moment decay, no step count); ids outside ``[0,
vocab_padded)`` are dropped.

``mode`` selects the engine of each apply as in JAX (``select_mode``):

- ``fused``: the hand-written dedup+apply kernel (``ops.sparse_embedding.
  fused_dedup_apply``, K3) on a CUDA tensor, its plain version on a CPU
  one;
- ``stream``: ``grad_accumulate`` into a table-sized gradient, then one
  elementwise pass over the whole table with a touched-row mask
  (``apply_acc``);
- ``scatter``: ``dedup_representatives``, then gather, update and
  scatter only the touched rows (the JAX scatter path, step for step:
  ``fused_dedup_apply_plain``); sgd, linear in the gradient, scatters
  ``-lr * g`` once per occurrence in both engines, as JAX does;
- ``auto``: ``scatter`` when the table has more than ``_SCATTER_CROSSOVER``
  storage blocks per id of the apply, else ``stream``: the JAX package's
  rule, kept as its selection semantics.

The stream and scatter engines are plain PyTorch (JAX computes them
outside Pallas).  The trainer maps ``--sparse_kernel`` onto ``mode``
(``parallel/ps_trainer.py``): ``xla`` keeps the optimizer's mode, and
``fused`` and ``auto`` select K3 (in JAX ``auto`` resolves to ``xla``).

``mesh`` selects the dispatch route of the apply: a mesh of more than
one slot takes the sharded route (``ske._dedup_apply``), on which every
engine runs per shard on the shard's rows, the ids of every data shard
gathered first and the ids another shard owns dropped: K3, the scatter
engine, sgd's scatter-add and the stream engine (its accumulated
gradient and its elementwise pass are a shard's).  ``whole_mesh``
places the tables by the JAX xla engine's rule, over the whole ``(data,
model)`` mesh (the PS trainer sets it for ``--sparse_kernel=xla``),
else they split over ``model``.  ``apply_acc`` takes one table's
accumulated gradient.  ``remake(mode, mesh, whole_mesh)`` rebuilds an
optimizer with another mode and placement and the same
hyperparameters, as the JAX trainer does to thread its mesh.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch

from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel.packed import PackedSpec

_MODES = ("auto", "stream", "scatter", "fused")

#: ``auto``'s crossover: scatter above this many storage blocks per id
#: of the apply.  The JAX package's constant (its value was chosen on
#: that package's own hardware), copied as the selection rule; the
#: port's engines were not timed to choose it.
_SCATTER_CROSSOVER = 64


def _use_scatter(spec: PackedSpec, n_ids: int, mode: str) -> bool:
    if mode == "scatter":
        return True
    if mode == "stream":
        return False
    if mode != "auto":
        raise ValueError(f"mode must be auto|stream|scatter, got {mode!r}")
    return spec.num_blocks > _SCATTER_CROSSOVER * n_ids


def select_mode(spec: PackedSpec, n_ids: int, mode: str) -> str:
    """``'stream'`` | ``'scatter'`` | ``'fused'`` for one apply of
    ``n_ids`` ids (the JAX ``select_mode``)."""
    if mode == "fused":
        return "fused"
    return "scatter" if _use_scatter(spec, n_ids, mode) else "stream"


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
    whole_mesh: bool = False

    def apply(self, spec: PackedSpec, table, slots, ids, grads) -> Tuple:
        engine = select_mode(spec, ids.shape[0], self.mode)
        # Looked up at call time, so a caller can patch the module's
        # function (chip_smoke.py runs the plain version that way); a
        # one-card optimizer calls it with the one-card signature.
        mesh = {} if self.mesh is None else {"mesh": self.mesh, "whole_mesh": self.whole_mesh}
        if engine == "fused":
            return ske.fused_dedup_apply(
                spec, self.kind, self.hyperparams, table, slots, ids, grads, **mesh
            )
        if engine == "scatter" and self.kind != "sgd":
            return ske.fused_dedup_apply_plain(
                spec, self.kind, self.hyperparams, table, slots, ids, grads, **mesh
            )
        # sgd is linear in the gradient: one scatter-add is both engines.
        body = _sgd_body if self.kind == "sgd" else _stream_body
        return ske._dedup_apply(body, spec, self.kind, self.hyperparams, table, slots, ids,
                                 grads, **mesh)

    def apply_acc(self, spec: PackedSpec, table, slots, acc) -> Tuple:
        """One step from an ALREADY ACCUMULATED gradient table ``acc``
        (``grad_accumulate``'s ``[vocab_padded, dim_padded]``), in place:
        the stream engine.  The same contract as ``apply`` on the batch
        that produced ``acc``."""
        if tuple(acc.shape) != tuple(table.shape):
            raise ValueError(f"acc shape {tuple(acc.shape)} != table {tuple(table.shape)}")
        kind = ske._resolve_kind(self.kind, slots)
        if kind == "adam_global":
            slots["t_global"].add_(1.0)
        _stream_step(spec, kind, ske.apply_constants(kind, self.hyperparams), table, slots, acc)
        return table, slots

    def remake(self, mode: str, mesh=None, whole_mesh: bool = False) -> "SparseOptimizer":
        """This optimizer with another ``mode``, dispatch ``mesh`` and
        table placement (``whole_mesh``: the xla engine's)."""
        _check_mode(mode)
        return dataclasses.replace(self, mode=mode, mesh=mesh, whole_mesh=whole_mesh)


def _sgd_body(spec, kind, c, operands, t_global, ids, grads) -> None:
    """sgd on one table or shard: ``table[ids] += -lr * g`` per occurrence."""
    pk.scatter_add(spec, operands[0], ids, c["lr_neg"] * grads)


def _stream_body(spec, kind, c, operands, t_global, ids, grads) -> None:
    """The stream engine on one table or shard (``operands``: its rows,
    then the slots' in ``ske.KIND_SLOTS`` order; adam_global's count
    already advanced)."""
    slots = dict(zip(ske.KIND_SLOTS[kind], operands[1:]))
    if t_global is not None:
        slots["t_global"] = t_global
    _stream_step(spec, kind, c, operands[0], slots, pk.grad_accumulate(spec, operands[0],
                                                                       ids, grads))


def _stream_step(spec, kind, c, table, slots, acc) -> None:
    """The elementwise pass over ``table`` and its slots, in place."""
    new_table, new_slots = _STREAM[kind](spec, c, table, slots, acc)
    table.copy_(new_table)
    for name, value in new_slots.items():
        slots[name].copy_(value)


def _touched(spec: PackedSpec, acc):
    """f32 ``[vocab_padded, 1]``: 1 on rows whose summed gradient is
    nonzero (the JAX ``broadcast_rows(touched_mask(acc))``)."""
    return torch.any(acc != 0, dim=-1, keepdim=True).to(acc.dtype)


def _stream_sgd(spec, c, table, slots, acc):
    # SGD is linear in the gradient: the windowed apply IS the sum of
    # the per-step applies.
    lr = -c["lr_neg"]
    return table - lr * acc, {}


def _stream_momentum(spec, c, table, slots, acc):
    touched = _touched(spec, acc)
    v = slots["momentum"]
    v_new = touched * (c["mu"] * v + acc) + (1 - touched) * v
    step = (c["mu"] * v_new + acc) if c["nesterov"] else v_new
    lr = -c["lr_neg"]
    return table - lr * touched * step, {"momentum": v_new}


def _stream_adagrad(spec, c, table, slots, acc):
    new_acc = slots["accumulator"] + acc * acc
    update = c["lr_neg"] * acc / (torch.sqrt(new_acc) + c["eps"])
    return table + update, {"accumulator": new_acc}


def _stream_adam(spec, c, table, slots, acc):
    touched = _touched(spec, acc)
    new_slots = {}
    if "t" in slots:
        # Pad lanes stay zero (the scatter engine zero-pads its updates).
        t_new = slots["t"] + touched * pk.real_lane_mask(spec, table.dtype, table.device)
        t_rows = torch.clamp(t_new, min=1.0)
        new_slots["t"] = t_new
    else:
        t_rows = slots["t_global"]  # the apply's count, advanced by the caller
    m, v = slots["m"], slots["v"]
    m_new = touched * (c["b1"] * m + c["omb1"] * acc) + (1 - touched) * m
    v_new = touched * (c["b2"] * v + c["omb2"] * acc * acc) + (1 - touched) * v
    b1 = torch.full((), c["b1"], dtype=torch.float32, device=acc.device)
    b2 = torch.full((), c["b2"], dtype=torch.float32, device=acc.device)
    m_hat = m_new / (1.0 - torch.pow(b1, t_rows))
    v_hat = v_new / (1.0 - torch.pow(b2, t_rows))
    update = c["lr_neg"] * touched * m_hat / (torch.sqrt(v_hat) + c["eps"])
    new_slots["m"] = m_new
    new_slots["v"] = v_new
    return table + update, new_slots


#: The stream engine (the JAX ``stream_apply_acc``) by resolved kind.
_STREAM = {
    "sgd": _stream_sgd,
    "momentum": _stream_momentum,
    "adagrad": _stream_adagrad,
    "adam": _stream_adam,
    "adam_global": _stream_adam,
}


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
