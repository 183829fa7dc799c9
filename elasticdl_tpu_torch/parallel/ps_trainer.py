"""PS-mode trainer: the port of ``ShardedEmbeddingTrainer``
(``elasticdl_tpu/parallel/ps_trainer.py``), on one card or over a
``parallel.mesh.Mesh``.

- Dense params: the model's ``nn.Parameter``s, updated by a dense
  optimizer (``parallel/optim.py``) in place, replicated over a mesh.
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

Over a mesh of more than one slot every sparse op takes the sharded
dispatch (``ops/sparse_embedding.py``; the route is logged at init), and
the tables and their slots are placed by the PS rule table
(``_partition_rules``, the JAX fused engine's branch): split over the
``model`` axis when their storage blocks divide it, else replicated.
The model must be built over the same mesh (``custom_model(...,
mesh=mesh)``), or its Embedding layers must resolve to it through
``ske.set_dispatch_mesh``.  The batch is padded to the ``data`` axis and
masked (``local_block``).

- An in-process mesh (``virtual_devices``): the slots share the card and
  the process, so a table stays one tensor whose model shards are row
  views, and nothing is reduced over ``data``.
- A process mesh (one rank per card with NCCL, gloo ranks on the CPU):
  every rank takes the global batch, pads it and computes the rows of
  its data index; its loss is its share of the global mask-weighted
  mean, so the sparse gradients it captures are those of the global
  mean; the dense gradients are all-reduced over ``data``; each rank
  holds only its rows of a split table and slot, and the apply gathers
  ``(ids, grads)`` over ``data`` first.  ``export_model``,
  ``get_variables_numpy`` and ``state_to_host`` gather the tables to
  full rows (collectives).

A step is four parts, each its own method so a caller can time them
(``chip_smoke.py`` does, with CUDA events): ``forward`` (the model under
a capture, the mask-weighted mean of the per-example loss), ``backward``
(dense and sparse gradients), ``dense_update`` and ``sparse_apply``.

Sharded checkpoints (``save_checkpoint``, ``set_sharded_restore``,
JAX ``ps_trainer.py:846-1029``) keep the JAX package's layout
(``checkpoint/sharded.py``), so either trainer restores what the other
wrote: arrays ``table|<key>`` and ``slot|<key>|<name>`` in rows of
storage blocks (``PackedSpec.packed_shape``; the port's row-form table
is the same bytes), and ``dense.pkl`` with ``step``, the flax-layout
``params`` (table placeholders included), the optax chain
``opt_state``, an empty ``model_state`` and the ``scalar_slots`` (adam's
``t_global``).  Each process writes and reads only its own block
interval; a restore copies into the trainer's own tensors in chunks.

Not ported: the JAX xla engine's whole-mesh table placement (over a
mesh of several slots the port's stream engine raises; K3 and the
scatter engine take the sharded route); several real cards driven from one
process (``resolve_mesh`` raises); ``model_state`` collections (DeepFM
has none).  ``sparse_kernel`` picks the embedding optimizer's engine
(``resolve_sparse_kernel``): ``xla`` keeps the optimizer's own mode (the
stream/scatter engines, ``parallel/sparse_optim.py``), ``fused`` runs K3,
and ``auto`` and None run K3 too, where JAX's ``auto`` resolves to
``xla`` (ROADMAP.md Queue 3 records the difference).  Lookups run K2 on
every setting.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.device import DeviceLike, resolve_device
from elasticdl_tpu_torch.layers import embedding as emb
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel import sparse_optim
from elasticdl_tpu_torch.parallel.compile import Rule, RuleTable
from elasticdl_tpu_torch.parallel.dp_trainer import (
    clone_tree,
    copy_tree,
    per_example_loss_fn,
    to_device,
)
from elasticdl_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_all_gather,
    axis_all_reduce,
    resolve_mesh,
)
from elasticdl_tpu_torch.parallel.packed import PackedSpec
from elasticdl_tpu_torch.parallel.sharding import (
    axis_rows,
    data_axis_size,
    gather_to_host,
    pad_batch,
    place_rows,
    shard_batch,
)

logger = logging.getLogger("elasticdl_tpu_torch.parallel.ps_trainer")

#: --sparse_apply_every=auto: strict per-step apply up to this many
#: embedding rows, the windowed W above (the JAX package's numbers).
AUTO_APPLY_TABLE_ROWS = 10_000_000
AUTO_APPLY_W = 32

_SPARSE_KERNELS = (None, "xla", "fused", "auto")


def resolve_sparse_kernel(requested: Optional[str]) -> str:
    """``'xla'`` or ``'fused'`` for a ``--sparse_kernel`` value.  None and
    ``'auto'`` resolve to ``'fused'``: the card's numbers for K3 stand in
    ``PERF.md``, the evidence JAX's ``AUTO_FUSED_READY`` waits for."""
    if requested not in _SPARSE_KERNELS:
        raise ValueError(f"sparse_kernel must be one of {_SPARSE_KERNELS}, got {requested!r}")
    return "xla" if requested == "xla" else "fused"


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


def _numel(value) -> int:
    return value.numel() if isinstance(value, torch.Tensor) else int(np.size(value))


class ShardedEmbeddingTrainer:
    """PS-mode trainer on one CUDA card (``device=None``), on the CPU for
    the tests (``device="cpu"``), or over a ``parallel.mesh.Mesh`` (on
    the mesh's device)."""

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
        self._mesh = resolve_mesh(mesh, "the port's ShardedEmbeddingTrainer")
        # A process mesh: this rank computes a data shard of the batch and
        # holds its model shard of each split table.
        self._world = self._mesh is not None and not self._mesh.in_process
        if self._mesh is None:
            self.device = resolve_device(device)
        else:
            if device is not None and torch.device(device) != self._mesh.device:
                raise ValueError(f"device {device} is not the mesh's {self._mesh.device}")
            self.device = self._mesh.device
        self._sparse_kernel = resolve_sparse_kernel(sparse_kernel)
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
        mode = "fused" if self._sparse_kernel == "fused" else embedding_optimizer.mode
        self._emb_tx = embedding_optimizer.remake(mode, mesh=self._mesh)
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
        self._route = ske.dispatch_route(self._mesh)
        for key, layer in self._layers.items():
            layer_mesh = layer.dispatch_mesh()
            if ske.dispatch_route(layer_mesh) != self._route or (
                    self._route == "shard_map" and layer_mesh is not self._mesh):
                raise ValueError(
                    f"the Embedding layer {key} dispatches over {layer_mesh!r}, the trainer "
                    f"over {self._mesh!r}: build the model over the trainer's mesh "
                    "(custom_model(..., mesh=mesh)) or register it with ske.set_dispatch_mesh"
                )
        #: table key -> the mesh axis its rows are split over (None: replicated)
        self._placement = self._partition_rules().match(
            {"tables": {key: layer.embedding for key, layer in self._layers.items()}}
        )[0]["tables"]
        logger.info("Sparse kernels dispatch route %s over %r; table placement %s",
                    self._route, self._mesh, self._placement)
        self._opt_state: Optional[dict] = None
        self._slots: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step = 0
        self._pending_oov: List[torch.Tensor] = []
        self._pending_restore: Optional[PSTrainState] = None
        self._pending_sharded_restore = None  # (saver, step)

    # -- public surface -------------------------------------------------

    @property
    def model(self) -> torch.nn.Module:
        return self._model

    @property
    def mesh(self):
        return self._mesh

    @property
    def sparse_route(self) -> str:
        """``single_device`` or ``shard_map``: the sparse ops' dispatch."""
        return self._route

    @property
    def sparse_apply_every(self) -> Optional[int]:
        return self._sparse_apply_every

    @property
    def table_specs(self) -> Dict[str, PackedSpec]:
        return {key: layer.spec for key, layer in self._layers.items()}

    @property
    def table_placement(self) -> Dict[str, Optional[str]]:
        """Table key -> the mesh axis its rows are split over, or None."""
        return dict(self._placement)

    @property
    def kernel_builds(self) -> Dict[str, int]:
        """The kernel library's build/load count (the JAX trainers'
        ``jitted_entrypoints``: what the step anatomy watches for compiles)."""
        return _build.build_counts()

    @property
    def step(self) -> int:
        return self._step

    def local_block(self, per_rank_batch: int) -> int:
        """The batch padded to a multiple of the data axis (every rank of
        a process mesh takes the global batch)."""
        dp = data_axis_size(self._mesh)
        return -(-per_rank_batch // dp) * dp

    # -- placement (the PS rule table, JAX ps_trainer.py:259-301) -------

    def _spec_of(self, path: str) -> PackedSpec:
        rest = path.split("/", 1)[1]
        for key, layer in self._layers.items():
            if rest == key or rest.startswith(key + "/"):
                return layer.spec
        raise KeyError(f"no table for {path!r}")

    def _partition_rules(self) -> RuleTable:
        """Dense state replicates; each table and its table-shaped slots
        split their rows over the ``model`` axis when their storage
        blocks divide it (``ske.table_partition_axis``), else replicate;
        scalar slots (adam's ``t_global``) replicate."""

        def table_blocks(path, shape):
            return ske.table_partition_axis(self._spec_of(path).num_blocks, self._mesh)

        return RuleTable(
            [Rule(r"^(tables|slots)(/|$)", table_blocks), Rule(".*", None)],
            name="ps-fused",
        )

    def _local_rows(self, key: str, value):
        """A table-shaped value as this process holds it: on a process
        mesh, its rows of a whole table (values already local pass)."""
        spec = self._layers[key].spec
        if not self._world or _numel(value) != spec.vocab_padded * spec.dim_padded:
            return value
        value = value.reshape(spec.rows_shape)
        return value[axis_rows(spec.vocab_padded, self._mesh, self._placement[key])]

    def _gather(self, key: str, value) -> np.ndarray:
        """A placed table-shaped tensor's full rows on the host."""
        return gather_to_host(value, self._mesh, self._placement[key])

    # -- state ----------------------------------------------------------

    @property
    def state(self) -> Optional[PSTrainState]:
        """The live state (references to the trainer's tensors; on a
        process mesh, this rank's rows of a split table)."""
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
        ``serving.convert.trainer_state_from_jax``; whole tables, or this
        rank's rows) into the trainer; before initialisation it is
        applied by ``ensure_initialized``."""
        value = PSTrainState(*value)
        if self._opt_state is None:
            self._pending_restore = value
            self._step = int(value.step)
            return
        live = self.state
        copy_tree(live.params, value.params)
        copy_tree(live.opt_state, value.opt_state)
        copy_tree(live.tables, {k: self._local_rows(k, v) for k, v in value.tables.items()})
        copy_tree(live.slots, {
            k: {name: self._local_rows(k, v) if np.ndim(v) else v for name, v in group.items()}
            for k, group in value.slots.items()
        })
        self._step = int(value.step)

    def state_to_host(self) -> Optional[PSTrainState]:
        """Host snapshot with numpy leaves, whole tables and slots
        (gathered on a process mesh: a collective); copies on every
        device, so a snapshot kept across a step does not change."""
        if self._opt_state is None:
            return None

        def host(tree):
            if isinstance(tree, dict):
                return {k: host(v) for k, v in tree.items()}
            return tree.detach().to("cpu", copy=True).numpy()

        return PSTrainState(
            self._step, host(dict(self._params)), host(self._opt_state),
            {key: self._gather(key, layer.embedding) for key, layer in self._layers.items()},
            {key: {name: self._gather(key, v) if v.dim() else v.detach().to("cpu", copy=True).numpy()
                   for name, v in group.items()}
             for key, group in self._slots.items()},
        )

    def ensure_initialized(self, features=None) -> PSTrainState:
        """Seeded init (or the pending restore), table placement, slots,
        optimizer state and the ``auto`` apply rule.  ``features`` is
        accepted for the JAX signature; the port's shapes do not depend
        on it."""
        if self._opt_state is not None:
            return self.state
        if self._pending_restore is None and self._pending_sharded_restore is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self._seed)
            self._model.init_parameters(generator)
            if self._world:  # one seed gives one init; rank 0's is the state
                self._reduce_flat(self._params.values(), broadcast=True)
        for key, layer in self._layers.items():
            layer.embedding = place_rows(layer.embedding, self._mesh, self._placement[key])
        self._slots = {
            key: self._emb_tx.init_slots(layer.spec, layer.embedding)
            for key, layer in self._layers.items()
        }
        self._opt_state = self._tx.init(self._params)
        if self._pending_sharded_restore is not None:
            self._pending_restore = None
            self._restore_sharded()
        elif self._pending_restore is not None:
            restore, self._pending_restore = self._pending_restore, None
            self.state = restore
        total_rows = sum(layer.spec.vocab_size for layer in self._layers.values())
        if self._sparse_apply_every is None:
            self._sparse_apply_every = (
                1 if total_rows <= AUTO_APPLY_TABLE_ROWS else AUTO_APPLY_W
            )
            logger.info("sparse_apply_every=auto -> %d (%.1fM embedding rows)",
                        self._sparse_apply_every, total_rows / 1e6)
        if self._sparse_apply_every == 1 and total_rows > AUTO_APPLY_TABLE_ROWS:
            # JAX ps_trainer.py:435-449: strict apply at this scale pays the
            # table-sized optimizer step every step; say so.
            logger.warning(
                "Strict per-step sparse apply with %.1fM embedding rows resident: "
                "--sparse_apply_every=16 amortizes the table-sized sparse optimizer step "
                "at this scale; strict mode stays exact per step if that is what you need",
                total_rows / 1e6)
        logger.info(
            "Initialized PS-mode model on %s: %d dense params, %d table(s) of "
            "%d rows [%s, sparse_apply_every=%d, route %s]", self.device,
            sum(p.numel() for p in self._params.values()), len(self._layers),
            total_rows, self._emb_tx.name, self._sparse_apply_every, self._route,
        )
        return self.state

    @torch.no_grad()
    def _reduce_flat(self, tensors, broadcast: bool = False) -> None:
        """All-reduce (SUM over ``data``) or broadcast from rank 0 the f32
        ``tensors`` in place, through one flat buffer (a process mesh)."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if broadcast:
            dist.broadcast(flat, src=0)
        else:
            flat = axis_all_reduce(self._mesh, DATA_AXIS, [flat])
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    # -- the four parts of a step ---------------------------------------

    def forward(self, features, labels, mask, denominator=None):
        """The model under a sparse capture; returns ``(loss, capture)``
        with the mask-weighted mean of the per-example loss.  On a process
        mesh (``stage_batch`` supplies ``denominator``, the global mask
        count) this rank's share of the global mean."""
        self._model.train()
        with emb.capture() as cap:
            outputs = self._model(features)
        losses = self._per_example_loss(labels, outputs)
        if denominator is None:
            denominator = torch.clamp(torch.sum(mask), min=1.0)
        return torch.sum(losses * mask) / denominator, cap

    def backward(self, loss, cap):
        """-> ``(dense_grads {name: grad}, sparse {table key: (ids [n],
        grads [n, dim])}, oov device scalar)``; on a process mesh the
        dense gradients are summed over ``data`` and the sparse ones are
        this rank's rows of the global mean's."""
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
        if self._world:
            self._reduce_flat(dense.values())
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
        """One apply per table (over a mesh, the sharded route: the ids and
        grads of every data shard, each model shard's rows)."""
        for key, (ids, grads) in sparse.items():
            self._emb_tx.apply(
                self._layers[key].spec, self._layers[key].embedding,
                self._slots[key], ids, grads,
            )

    # -- host-side entry points -----------------------------------------

    def stage_batch(self, features, labels, mask):
        """One batch onto the trainer's device; on a process mesh, this
        rank's rows of the global batch padded to the data axis, with the
        global mask count ``forward`` divides by."""
        if not isinstance(mask, torch.Tensor):
            mask = np.asarray(mask, np.float32)
        if not self._world:
            return (to_device(features, self.device), to_device(labels, self.device),
                    to_device(mask, self.device).to(torch.float32))
        mask = np.asarray(mask, np.float32)
        dp = data_axis_size(self._mesh)
        features, pad_mask = pad_batch(features, dp)
        labels = pad_batch(labels, dp)[0]
        mask = np.concatenate([mask, np.zeros(len(pad_mask) - len(mask), np.float32)])
        denominator = float(max(mask.sum(), 1.0))
        return (to_device(shard_batch(features, self._mesh), self.device),
                to_device(shard_batch(labels, self._mesh), self.device),
                to_device(shard_batch(mask, self._mesh), self.device), denominator)

    def train_step(self, features, labels):
        # The batch padded to the data axis (one card: as it is), the pad
        # rows masked out of the loss, as the JAX trainer pads.
        block = self.local_block(len(labels))
        features, mask = pad_batch(features, block)
        labels = pad_batch(labels, block)[0]
        return self.train_step_local(features, labels, mask)

    def train_step_local(self, features, labels, mask):
        self.ensure_initialized(features)
        return self.train_step_staged(self.stage_batch(features, labels, mask))

    def _global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        loss = loss.detach()
        if self._world:  # every data shard's share, summed
            loss = axis_all_reduce(self._mesh, DATA_AXIS, [loss])
        return loss

    def train_step_staged(self, staged):
        if self._opt_state is None:
            raise RuntimeError("train_step_staged requires ensure_initialized() first")
        loss, cap = self.forward(*staged)
        dense, sparse, oov = self.backward(loss, cap)
        self.dense_update(dense)
        self.sparse_apply(sparse)
        self._step += 1
        self._pending_oov.append(oov)
        return self._global_loss(loss)

    def stage_window(self, batches):
        """K ``(features, labels, mask)`` batches of one shape -> stacked
        ``[K, batch, ...]`` tensors on the device (on a process mesh, the
        K staged shares)."""
        if self._world:
            return [self.stage_batch(*b) for b in batches]
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
        if self._world:
            staged = list(window)
        else:
            feats, labels, masks = window
            staged = [({n: v[k] for n, v in feats.items()}, labels[k], masks[k])
                      for k in range(labels.shape[0])]
        w = self._sparse_apply_every or 1
        if w <= 1:
            return torch.stack([self.train_step_staged(batch) for batch in staged])
        losses = []
        for lo in range(0, len(staged), w):
            collected: Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]] = {}
            for batch in staged[lo:lo + w]:
                loss, cap = self.forward(*batch)
                dense, sparse, oov = self.backward(loss, cap)
                self.dense_update(dense)
                for key, pair in sparse.items():
                    collected.setdefault(key, []).append(pair)
                self._step += 1
                self._pending_oov.append(oov)
                losses.append(self._global_loss(loss))
            self.sparse_apply({
                key: (torch.cat([p[0] for p in pairs]), torch.cat([p[1] for p in pairs]))
                for key, pairs in collected.items()
            })
        return torch.stack(losses)

    def consume_oov_count(self) -> int:
        """Out-of-vocabulary ids seen by train steps since the last call
        (waits on the device; on a process mesh a collective over
        ``data``)."""
        total = sum(self._pending_oov, torch.zeros((), dtype=torch.int32, device=self.device))
        if self._world:
            total = axis_all_reduce(self._mesh, DATA_AXIS, [total])
        self._pending_oov = []
        return int(total)

    @torch.no_grad()
    def eval_step(self, features) -> np.ndarray:
        """The model's outputs on ``features``; on a process mesh each rank
        computes its data shard and the outputs are gathered (a
        collective)."""
        self.ensure_initialized(features)
        self._model.eval()
        try:
            if not self._world:
                return self._model(to_device(features, self.device)).cpu().numpy()
            n = len(next(iter(features.values())))
            padded = pad_batch(features, data_axis_size(self._mesh))[0]
            out = self._model(to_device(shard_batch(padded, self._mesh), self.device))
            return axis_all_gather(self._mesh, DATA_AXIS, out)[:n].cpu().numpy()
        finally:
            self._model.train()

    def eval_step_local(self, features) -> np.ndarray:
        """JAX ``ps_trainer.py:833``: the outputs of every row of the
        worker's batch, each rank's slice padded, in rank order (the
        port's trainers take the global batch); a collective on a
        process mesh, so every rank calls it."""
        return self.eval_step(features)

    # -- sharded checkpoints (JAX ps_trainer.py:846-1029) ---------------

    def _local_blocks(self, key: str) -> Tuple[int, int]:
        """This process's interval of a table's storage blocks."""
        spec = self._layers[key].spec
        rows = axis_rows(spec.vocab_padded, self._mesh, self._placement[key])
        return rows.start // spec.rows_per_block, rows.stop // spec.rows_per_block

    def _checkpoint_arrays(self) -> Dict[str, Tuple[str, torch.Tensor]]:
        """Checkpoint name -> (table key, this process's tensor) of every
        table and table-shaped slot; scalar slots ride the dense pickle."""
        out = {f"table|{key}": (key, layer.embedding) for key, layer in self._layers.items()}
        for key, group in self._slots.items():
            for name, value in group.items():
                if value.dim():
                    out[f"slot|{key}|{name}"] = (key, value)
        return out

    def save_checkpoint(self, saver, step: int) -> None:
        """COLLECTIVE sharded checkpoint (``checkpoint.sharded.
        ShardedCheckpointSaver``): every process calls it and writes only
        its own block interval of each table and slot (on a process mesh
        the ranks of data index 0, a replicated table rank 0 alone); rank
        0 writes the dense state in the JAX layout."""
        from elasticdl_tpu_torch.checkpoint.sharded import ShardedArray
        from elasticdl_tpu_torch.serving import convert

        if self._opt_state is None:
            return
        rank0 = not self._world or self._mesh.rank == 0
        dense = None
        if rank0:
            scalar = {key: {name: v for name, v in group.items() if not v.dim()}
                      for key, group in self._slots.items()}
            jax_state = convert.jax_trainer_state_from_port(
                PSTrainState(self._step, self._params, self._opt_state, {}, scalar),
                self._model, self._tx.name)
            dense = {"step": jax_state.step, "params": jax_state.params,
                     "opt_state": jax_state.opt_state, "model_state": {},
                     "scalar_slots": jax_state.slots}
        writes = not self._world or self._mesh.data_index == 0
        sharded = {}
        for name, (key, value) in self._checkpoint_arrays().items():
            spec = self._layers[key].spec
            lo, hi = self._local_blocks(key)
            parts = [(lo, hi, value.view(hi - lo, spec.block_width))] if writes else []
            sharded[name] = ShardedArray(spec.packed_shape, "float32", parts)
        saver.save(step, dense, sharded)

    def set_sharded_restore(self, saver, step: int) -> None:
        """Restore ``step`` of ``saver`` at ``ensure_initialized``, once
        the tables and slots exist."""
        self._pending_sharded_restore = (saver, step)
        self._step = step

    @torch.no_grad()
    def _restore_sharded(self) -> None:
        """Copy the checkpoint into the trainer's own tensors: the dense
        state from the pickle; each table and slot, this process's block
        interval only, in chunks of ``convert.CHUNK_ROWS`` rows."""
        from elasticdl_tpu_torch.serving import convert

        saver, step = self._pending_sharded_restore
        self._pending_sharded_restore = None
        arrays = saver.manifest(step).get("arrays", {})
        have = {name[len("table|"):] for name in arrays if name.startswith("table|")}
        if have != set(self._layers):
            raise ValueError(
                f"Checkpoint at step {step} holds embedding tables {sorted(have)} but this "
                f"build expects {sorted(self._layers)} — the model's table layout changed "
                "between save and restore (e.g. DeepFM's per-mode layout splits/merges tables "
                "when --sparse_apply_every crosses the strict/windowed boundary at >10M rows). "
                "Restore with the same sparse_apply_every, or pin the layout with "
                "--model_params split_tables=true|false"
            )
        dense = saver.load_dense(step)
        scalar_slots = dense.get("scalar_slots", {})
        for key, group in self._slots.items():
            for name, value in group.items():
                if not value.dim() and name not in scalar_slots.get(key, {}):
                    raise ValueError(
                        f"Checkpoint at step {step} has no scalar slot {key}/{name} — it was "
                        "written by a build with a different optimizer configuration (e.g. "
                        "adam bias_correction='per_row' vs 'global'); restore with the "
                        "matching configuration"
                    )
        targets = self._checkpoint_arrays()
        for name, (key, value) in targets.items():
            want = (list(self._layers[key].spec.packed_shape), "float32")
            meta = arrays.get(name)
            got = None if meta is None else (list(meta["shape"]), meta["dtype"])
            if got != want:
                raise ValueError(
                    f"Checkpoint slot/table {name} is {got} but this build expects {want} — "
                    "slot layouts or the vocabulary changed; re-train or migrate the checkpoint"
                )
        copy_tree(self._params, convert._dense_from_jax(dense["params"], self._model))
        copy_tree(self._opt_state, convert.port_opt_state(dense["opt_state"], self._model))
        for key, group in self._slots.items():
            for name, value in group.items():
                if not value.dim():
                    value.fill_(float(np.asarray(scalar_slots[key][name], np.float32)))
        try:
            for name, (key, value) in targets.items():
                spec = self._layers[key].spec
                lo, hi = self._local_blocks(key)
                blocks = value.view(hi - lo, spec.block_width)
                chunk = max(1, convert.CHUNK_ROWS // spec.rows_per_block)
                for start in range(lo, hi, chunk):
                    stop = min(hi, start + chunk)
                    rows = np.array(saver.load_rows(step, name, start, stop))  # writable copy
                    blocks[start - lo:stop - lo].copy_(torch.from_numpy(rows))
        finally:
            saver.release(step)  # the shard files close, the restore done or failed
        self._step = int(np.asarray(dense["step"]))
        logger.info("Restored sharded checkpoint at step %d (%d tables)", self._step,
                    len(self._layers))

    def jax_variables(self):
        """The weights in the JAX layout with whole tables, as
        ``serving/export.write_artifact`` takes them (on a process mesh a
        collective)."""
        from elasticdl_tpu_torch.serving import convert

        return convert.jax_variables_from_port(self._model, self._gather)

    def get_variables_numpy(self) -> Dict[str, np.ndarray]:
        """Flat ``{"params/<path>": array}`` in the JAX layout, tables
        LOGICAL ``[vocab, dim]`` (the export / serving view; on a process
        mesh a collective)."""
        from elasticdl_tpu_torch.serving import convert

        if self._opt_state is None:
            return {}
        return convert.flat_jax_variables(self._model, self._gather)
