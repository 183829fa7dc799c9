"""PS-mode trainer on one card: the port of ``ShardedEmbeddingTrainer``
(``elasticdl_tpu/parallel/ps_trainer.py``).

- Dense params: the model's ``nn.Parameter``s, updated by a dense
  optimizer (``parallel/optim.py``) in place.
- Embedding tables: each Embedding layer's ``[vocab_padded, dim_padded]``
  buffer, never differentiated.  The sparse gradient is captured at each
  layer's perturbation point (``layers/embedding.capture``) and applied
  by the sparse row-wise optimizer (``parallel/sparse_optim.py``), which
  on the card is the hand-written ``fused_dedup_apply`` kernel, in place.
- ``sparse_apply_every=W > 1``: the windowed apply.  Within a chunk of W
  steps dense params update every step, the sparse ``(ids, grads)`` are
  collected, and ONE apply runs on their concatenation at the chunk's
  end, so the forwards inside a chunk read the tables as of its start.
  ``"auto"`` resolves at ``ensure_initialized``: strict up to
  ``AUTO_APPLY_TABLE_ROWS`` embedding rows, ``AUTO_APPLY_W`` above.

A step is four parts, each its own method so a caller can time them
(``chip_smoke.py`` does, with CUDA events): ``forward`` (the model under
a capture, the mask-weighted mean of the per-example loss), ``backward``
(dense and sparse gradients), ``dense_update`` and ``sparse_apply``.

Not ported yet: multi-card placement (``mesh`` must be None or one
device; the sharded K1-K3 dispatch is ROADMAP Queue 1 item 5),
checkpoint save/restore, ``model_state`` collections (DeepFM has
none).  ``sparse_kernel`` is accepted and selects nothing: on the
card every sparse op is its kernel.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import (
    SPARSE_DISPATCH_ITEM,
    DeviceLike,
    require_one_device,
    resolve_device,
)
from elasticdl_tpu_torch.layers import embedding as emb
from elasticdl_tpu_torch.parallel import sparse_optim
from elasticdl_tpu_torch.parallel.dp_trainer import (
    clone_tree,
    copy_tree,
    per_example_loss_fn,
    to_device,
)
from elasticdl_tpu_torch.parallel.packed import PackedSpec

logger = logging.getLogger("elasticdl_tpu_torch.parallel.ps_trainer")

#: --sparse_apply_every=auto: strict per-step apply up to this many
#: embedding rows, the windowed W above (the JAX package's numbers).
AUTO_APPLY_TABLE_ROWS = 10_000_000
AUTO_APPLY_W = 32

_SPARSE_KERNELS = (None, "xla", "fused", "auto")


class PSTrainState(NamedTuple):
    step: int
    params: Dict[str, Any]                 # dense parameter name -> tensor
    opt_state: Dict[str, Any]              # the dense optimizer's state
    tables: Dict[str, Any]                 # "<module path>/embedding" -> rows
    slots: Dict[str, Dict[str, Any]]       # table key -> sparse slots


def clone_state(state: PSTrainState) -> PSTrainState:
    """A deep copy of a state's tensors (on their device)."""
    return PSTrainState(state.step, clone_tree(state.params), clone_tree(state.opt_state),
                        clone_tree(state.tables), clone_tree(state.slots))


class ShardedEmbeddingTrainer:
    """PS-mode trainer on one CUDA card (``device=None``) or, for the
    tests, on the CPU (``device="cpu"``)."""

    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn,
        optimizer,
        embedding_optimizer: Optional[sparse_optim.SparseOptimizer] = None,
        seed: int = 0,
        sparse_apply_every=1,
        sparse_kernel: Optional[str] = None,
        mesh=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        require_one_device(mesh, "the port's ShardedEmbeddingTrainer",
                           SPARSE_DISPATCH_ITEM)
        if sparse_kernel not in _SPARSE_KERNELS:
            raise ValueError(f"sparse_kernel must be one of {_SPARSE_KERNELS}, got {sparse_kernel!r}")
        self._model = model.to(self.device)
        self._loss_fn = loss_fn
        self._per_example_loss = per_example_loss_fn(loss_fn)
        self._tx = optimizer
        if embedding_optimizer is None:
            logger.warning(
                "No embedding_optimizer in the model spec; defaulting to "
                "sparse SGD(0.01) for embedding tables"
            )
            embedding_optimizer = sparse_optim.sgd(0.01)
        self._emb_tx = embedding_optimizer
        self._sparse_apply_every = (
            None if sparse_apply_every == "auto" else max(1, int(sparse_apply_every))
        )
        self._seed = seed
        self._params: Dict[str, torch.nn.Parameter] = dict(self._model.named_parameters())
        self._layers: Dict[str, emb.Embedding] = {
            name.replace(".", "/") + "/embedding": module
            for name, module in self._model.named_modules()
            if isinstance(module, emb.Embedding)
        }
        self._opt_state: Optional[dict] = None
        self._slots: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step = 0
        self._pending_oov: List[torch.Tensor] = []
        self._pending_restore: Optional[PSTrainState] = None

    # -- public surface -------------------------------------------------

    @property
    def model(self) -> torch.nn.Module:
        return self._model

    @property
    def sparse_apply_every(self) -> Optional[int]:
        return self._sparse_apply_every

    @property
    def table_specs(self) -> Dict[str, PackedSpec]:
        return {key: layer.spec for key, layer in self._layers.items()}

    @property
    def step(self) -> int:
        return self._step

    @property
    def state(self) -> Optional[PSTrainState]:
        """The live state (references to the trainer's tensors)."""
        if self._opt_state is None:
            return None
        return PSTrainState(
            self._step, dict(self._params), self._opt_state,
            {key: layer.embedding for key, layer in self._layers.items()},
            self._slots,
        )

    @state.setter
    def state(self, value: PSTrainState) -> None:
        """Copy ``value`` (tensors or numpy arrays, e.g. from
        ``serving.convert.trainer_state_from_jax``) into the trainer;
        before initialisation it is applied by ``ensure_initialized``."""
        value = PSTrainState(*value)
        if self._opt_state is None:
            self._pending_restore = value
            self._step = int(value.step)
            return
        live = self.state
        copy_tree(live.params, value.params)
        copy_tree(live.opt_state, value.opt_state)
        copy_tree(live.tables, value.tables)
        copy_tree(live.slots, value.slots)
        self._step = int(value.step)

    def ensure_initialized(self, features=None) -> PSTrainState:
        """Seeded init (or the pending restore), slots, optimizer state and
        the ``auto`` apply rule.  ``features`` is accepted for the JAX
        signature; the port's shapes do not depend on it."""
        if self._opt_state is not None:
            return self.state
        if self._pending_restore is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self._seed)
            self._model.init_parameters(generator)
        self._slots = {
            key: self._emb_tx.init_slots(layer.spec, layer.embedding)
            for key, layer in self._layers.items()
        }
        self._opt_state = self._tx.init(self._params)
        if self._pending_restore is not None:
            restore, self._pending_restore = self._pending_restore, None
            self.state = restore
        total_rows = sum(layer.spec.vocab_size for layer in self._layers.values())
        if self._sparse_apply_every is None:
            self._sparse_apply_every = (
                1 if total_rows <= AUTO_APPLY_TABLE_ROWS else AUTO_APPLY_W
            )
            logger.info("sparse_apply_every=auto -> %d (%.1fM embedding rows)",
                        self._sparse_apply_every, total_rows / 1e6)
        logger.info(
            "Initialized PS-mode model on %s: %d dense params, %d table(s) of "
            "%d rows [%s, sparse_apply_every=%d]", self.device,
            sum(p.numel() for p in self._params.values()), len(self._layers),
            total_rows, self._emb_tx.name, self._sparse_apply_every,
        )
        return self.state

    # -- the four parts of a step ---------------------------------------

    def forward(self, features, labels, mask):
        """The model under a sparse capture; returns ``(loss, capture)``
        with the mask-weighted mean of the per-example loss."""
        self._model.train()
        with emb.capture() as cap:
            outputs = self._model(features)
        losses = self._per_example_loss(labels, outputs)
        loss = torch.sum(losses * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return loss, cap

    def backward(self, loss, cap):
        """-> ``(dense_grads {name: grad}, sparse {table key: (ids [n],
        grads [n, dim])}, oov device scalar)``."""
        names = list(self._params)
        keys = list(self._layers)
        records = [cap.records[self._layers[key]] for key in keys]
        grads = torch.autograd.grad(
            loss, [self._params[n] for n in names] + [r.bet for r in records],
            allow_unused=True,
        )
        dense = {
            n: g if g is not None else torch.zeros_like(self._params[n])
            for n, g in zip(names, grads)
        }
        sparse = {}
        for key, rec, g in zip(keys, records, grads[len(names):]):
            spec = self._layers[key].spec
            g = torch.zeros_like(rec.bet) if g is None else g
            sparse[key] = (rec.ids.reshape(-1), g.reshape(-1, spec.dim))
        oov = sum((r.oov for r in records), torch.zeros((), dtype=torch.int32, device=self.device))
        return dense, sparse, oov

    def dense_update(self, dense_grads) -> None:
        self._tx.apply(self._params, dense_grads, self._opt_state)

    def sparse_apply(self, sparse) -> None:
        for key, (ids, grads) in sparse.items():
            self._emb_tx.apply(
                self._layers[key].spec, self._layers[key].embedding,
                self._slots[key], ids, grads,
            )

    # -- host-side entry points -----------------------------------------

    def stage_batch(self, features, labels, mask):
        """One batch onto the trainer's device."""
        return (
            to_device(features, self.device),
            to_device(labels, self.device),
            to_device(np.asarray(mask, np.float32) if not isinstance(mask, torch.Tensor)
                      else mask, self.device),
        )

    def train_step(self, features, labels):
        # One card holds the whole batch: no padding rows, an all-ones
        # mask (the JAX trainer pads to a multiple of its data-parallel
        # devices and masks the pad rows out of the loss).
        return self.train_step_local(features, labels, np.ones((len(labels),), np.float32))

    def train_step_local(self, features, labels, mask):
        self.ensure_initialized(features)
        return self.train_step_staged(self.stage_batch(features, labels, mask))

    def train_step_staged(self, staged):
        if self._opt_state is None:
            raise RuntimeError("train_step_staged requires ensure_initialized() first")
        loss, cap = self.forward(*staged)
        dense, sparse, oov = self.backward(loss, cap)
        self.dense_update(dense)
        self.sparse_apply(sparse)
        self._step += 1
        self._pending_oov.append(oov)
        return loss.detach()

    def stage_window(self, batches):
        """K ``(features, labels, mask)`` batches of one shape -> stacked
        ``[K, batch, ...]`` tensors on the device."""
        feats = {k: np.stack([np.asarray(b[0][k]) for b in batches]) for k in batches[0][0]}
        labels = np.stack([np.asarray(b[1]) for b in batches])
        masks = np.stack([np.asarray(b[2], np.float32) for b in batches])
        return self.stage_batch(feats, labels, masks)

    def train_window(self, window):
        """Run every batch of a staged window; returns the ``[K]`` losses.
        With ``sparse_apply_every=W > 1`` the window runs as chunks of W
        steps with one sparse apply each (a shorter last chunk included)."""
        if self._opt_state is None:
            raise RuntimeError("train_window requires ensure_initialized() first")
        feats, labels, masks = window
        k_steps = labels.shape[0]

        def batch(k):
            return {n: v[k] for n, v in feats.items()}, labels[k], masks[k]

        w = self._sparse_apply_every or 1
        if w <= 1:
            return torch.stack([self.train_step_staged(batch(k)) for k in range(k_steps)])
        losses = []
        for lo in range(0, k_steps, w):
            collected: Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]] = {}
            for k in range(lo, min(k_steps, lo + w)):
                loss, cap = self.forward(*batch(k))
                dense, sparse, oov = self.backward(loss, cap)
                self.dense_update(dense)
                for key, pair in sparse.items():
                    collected.setdefault(key, []).append(pair)
                self._step += 1
                self._pending_oov.append(oov)
                losses.append(loss.detach())
            self.sparse_apply({
                key: (torch.cat([p[0] for p in pairs]), torch.cat([p[1] for p in pairs]))
                for key, pairs in collected.items()
            })
        return torch.stack(losses)

    def consume_oov_count(self) -> int:
        """Out-of-vocabulary ids seen by train steps since the last call
        (waits on the device)."""
        total = sum(int(x) for x in self._pending_oov)
        self._pending_oov = []
        return total

    @torch.no_grad()
    def eval_step(self, features) -> np.ndarray:
        self.ensure_initialized(features)
        self._model.eval()
        try:
            out = self._model(to_device(features, self.device))
        finally:
            self._model.train()
        return out.cpu().numpy()

    def get_variables_numpy(self) -> Dict[str, np.ndarray]:
        """Flat ``{"params/<path>": array}`` in the JAX layout, tables
        LOGICAL ``[vocab, dim]`` (the export / serving view)."""
        from elasticdl_tpu_torch.serving import convert

        if self._opt_state is None:
            return {}
        return convert.flat_jax_variables(self._model)
