"""Embedding layer over the port's lookup kernels.

Counterpart of ``elasticdl_tpu/layers/embedding.py`` ``Embedding``, with
its fixed-vocabulary contract: ids outside ``[0, vocab)`` contribute
zeros (negative ids are padding, ids ``>= vocab`` out of vocabulary).
They are replaced by the safe id 0 before the lookup and masked after it,
so the kernels' clamp rule never decides a result.

The table is the buffer ``embedding`` of shape ``[vocab_padded,
dim_padded]`` (``parallel/packed.py``).  There is no engine switch: on a
CUDA tensor the lookup IS the kernel, on a CPU tensor its plain version.
``mesh`` is the dispatch mesh of the lookups (``ops/sparse_embedding.py``
"Sharded dispatch"); a layer built without one resolves against the
process default ``ske.dispatch_mesh()`` at each call, as the JAX layer
does at trace time.  On a process mesh a trainer or loader places the
buffer first (``parallel/sharding.place_rows``): a table split over the
``model`` axis then holds this rank's rows only.

Training (the PS trainer's sparse-gradient capture): while a ``capture()``
context is open, each call makes a zeros tensor ``bet`` that requires
grad — the perturbation point of the JAX layer (the reference's
``tape.watch``) — and records it with the safe ids and the step's OOV
count (ids ``>= vocab_size``).  ``bet`` is added to the looked-up rows
BEFORE the validity mask (inside ``fused_lookup_fm`` on the merged path),
so padding positions get zero gradient, and its gradient IS the sparse
gradient: the table itself is a buffer, never differentiated.  One call
per layer per capture, as in the JAX layer.  Without a capture the layer
is the inference layer, and ``bet`` is None.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import torch
from torch import nn

from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel.packed import PackedSpec, oov_debug_enabled

logger = get_logger("layers.embedding")

#: The JAX ``default_embedding_init`` range (the reference's Keras
#: 'uniform' initializer).
INIT_SCALE = 0.05


@dataclass
class CaptureRecord:
    """One Embedding call under a capture: the ids its sparse gradient
    belongs to (safe ids, as the JAX layer sows them), the perturbation
    tensor whose ``.grad`` is that gradient, and its OOV count (a device
    scalar)."""

    ids: torch.Tensor
    bet: torch.Tensor
    oov: torch.Tensor


class SparseCapture:
    """The records of one training step, by Embedding layer."""

    def __init__(self):
        self.records: Dict[nn.Module, CaptureRecord] = {}

    def record(self, layer: nn.Module, rec: CaptureRecord) -> None:
        if layer in self.records:
            raise RuntimeError(
                f"{layer!r} was called twice in one capture; the sparse "
                "capture allows one call per Embedding layer per step"
            )
        self.records[layer] = rec


_local = threading.local()


def active_capture() -> Optional[SparseCapture]:
    return getattr(_local, "capture", None)


@contextlib.contextmanager
def capture() -> Iterator[SparseCapture]:
    """Record every Embedding call of one step (not nestable)."""
    if active_capture() is not None:
        raise RuntimeError("a sparse capture is already open on this thread")
    cap = SparseCapture()
    _local.capture = cap
    try:
        yield cap
    finally:
        _local.capture = None


def default_embedding_init(
    spec: PackedSpec, table: torch.Tensor, generator: torch.Generator
) -> torch.Tensor:
    """In place: uniform in ``[-0.05, 0.05)`` on real rows and lanes, from
    ``generator`` (on the table's device), zero on pad rows and lanes."""
    with torch.no_grad():
        table.uniform_(-INIT_SCALE, INIT_SCALE, generator=generator)
        table[:, spec.dim:] = 0.0
        table[spec.vocab_size:] = 0.0
    return table


class Embedding(nn.Module):
    """ids int [batch] or [batch, length] -> activations.

    combiner: None returns per-position vectors ``[..., dim]``;
    ``'sum'``/``'mean'`` reduce the trailing length axis.
    fm_interaction: the DeepFM merged-table mode: ids ``[batch, fields]``
    -> ``(acts [batch, fields, dim], first [batch], sum_v [batch,
    dim-1], sum_sq [batch, dim-1])`` from one ``fused_lookup_fm`` pass.
    """

    def __init__(
        self,
        vocab_size: int,
        embedding_dim: int,
        combiner: Optional[str] = None,
        fm_interaction: bool = False,
        mesh=None,
        device=None,
    ):
        super().__init__()
        if combiner not in (None, "sum", "mean"):
            raise ValueError(f"Unknown combiner {combiner!r}")
        if fm_interaction and combiner is not None:
            raise ValueError("fm_interaction excludes a combiner")
        self.spec = PackedSpec(vocab_size, embedding_dim)
        self.combiner = combiner
        self.fm_interaction = fm_interaction
        self.mesh = mesh
        # Uninitialised: a loader fills it (serving/convert.load_state) or
        # init_parameters draws it; at full width it is gigabytes, so it
        # is never zero-filled first.
        self.register_buffer(
            "embedding",
            torch.empty(self.spec.rows_shape, dtype=torch.float32, device=device),
        )

    def extra_repr(self) -> str:
        return (
            f"vocab_size={self.spec.vocab_size}, dim={self.spec.dim}, "
            f"combiner={self.combiner}, fm_interaction={self.fm_interaction}"
        )

    def init_parameters(self, generator: torch.Generator) -> None:
        default_embedding_init(self.spec, self.embedding, generator)

    def dispatch_mesh(self):
        """The mesh the lookups dispatch over: the layer's own, else the
        process default."""
        return self.mesh if self.mesh is not None else ske.dispatch_mesh()

    def forward(self, ids: torch.Tensor):
        spec = self.spec
        mesh = self.dispatch_mesh()
        ids = ids.to(torch.int32)
        valid = (ids >= 0) & (ids < spec.vocab_size)
        safe_ids = torch.where(valid, ids, torch.zeros_like(ids))
        if oov_debug_enabled():
            oov = int(torch.sum(ids >= spec.vocab_size))
            if oov:
                logger.warning(
                    "OOV diagnostics [%s]: %d ids >= vocab_size (%d) this step; they read "
                    "zeros and receive no update: hash open-vocabulary ids into fixed bins",
                    self.extra_repr(), oov, spec.vocab_size)
        bet = None
        cap = active_capture()
        if cap is not None:
            bet = torch.zeros(
                safe_ids.shape + (spec.dim,), dtype=torch.float32,
                device=ids.device, requires_grad=True,
            )
            oov = torch.sum(ids >= spec.vocab_size, dtype=torch.int32)
            cap.record(self, CaptureRecord(safe_ids, bet, oov))
        if self.fm_interaction:
            if ids.dim() != 2:
                raise ValueError("fm_interaction requires ids of shape [batch, fields]")
            return ske.fused_lookup_fm(spec, self.embedding, bet, safe_ids, valid, mesh=mesh)
        acts = ske.fused_lookup(spec, self.embedding, safe_ids.reshape(-1), mesh=mesh)
        acts = acts.reshape(safe_ids.shape + (spec.dim,))
        if bet is not None:
            acts = acts + bet
        acts = acts * valid[..., None].to(acts.dtype)
        if self.combiner is None:
            return acts
        if ids.dim() < 2:
            raise ValueError("combiner requires ids of shape [batch, length]")
        summed = torch.sum(acts, dim=-2)
        if self.combiner == "sum":
            return summed
        counts = torch.clamp(
            torch.sum(valid.to(acts.dtype), dim=-1, keepdim=True), min=1.0
        )
        return summed / counts
