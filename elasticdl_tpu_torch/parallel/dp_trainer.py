"""Data-parallel trainer: the port of ``DataParallelTrainer``
(``elasticdl_tpu/parallel/dp_trainer.py``), the AllReduce strategy's
trainer, which trains the transformer LM and the vision zoo.

On one card, or on an in-process mesh (``parallel.mesh.virtual_devices``,
whose slots share the card), there is nothing to reduce: the model's
``nn.Parameter``s are the dense params, updated in place by a dense
optimizer (``parallel/optim.py``; the LM's is AdamW), and a model built
with the mesh runs its ring attention inside the step.  The loss is the
mask-weighted mean of the per-example loss (``per_example_loss_fn``), so
padded rows contribute nothing, as in JAX.

On a process mesh (one rank per card, or gloo processes on the CPU)
every rank takes the global batch and:

1. pads it to the data axis with a mask (``sharding.pad_batch``);
2. takes the rows of its data index and, when the model's ``model`` axis
   carries the sequence, the positions of its model index
   (``model.sequence_positions``);
3. computes its share of the loss: its per-example losses (means over
   its tokens) times its share of the tokens, mask-weighted, over the
   global mask count, so the sum over ranks is JAX's global mean;
4. all-reduces the gradients with SUM over the world (one flat buffer);
5. applies the same AdamW; parameters stay replicated and identical.

``model_state`` holds a conv net's ``batch_stats`` (``{"batch_stats":
{"<module>.mean"|".var": buffer}}``, ``zoo/vision.batch_stats``): the
model's own buffers, updated by a training forward and read by
evaluation (JAX ``:318-337`` and ``:352``).  A model whose ``forward``
takes ``train`` is called with it (``model_apply``, JAX's
``_model_apply``).  JAX's SPMD step takes batch statistics over the
global batch.  On a process mesh each rank holds only its rows of that
batch (every rank stacks all ranks' slices, then keeps its own,
``stage_batch``), so each batch norm averages its per-rank ``[E[x],
E[x^2]]`` over the ranks (a differentiable all-reduce, ``stats_reduce``);
the ranks' rows are equal in number, so the average is the global
batch's, and the running averages stay identical on every rank.

A step is three parts, each its own method so a caller can time them
(``chip_smoke.py`` does, with CUDA events): ``forward`` (the model and
the loss), ``backward`` (the dense gradients, reduced on a process
mesh) and ``dense_update``.  The JAX ``train_window`` is a ``lax.scan``
over K steps in one program; here it is a Python loop over the staged
batches.

Checkpoints keep the JAX package's layout: ``state_to_jax_host`` is the
JAX ``TrainState(step, params, opt_state, model_state)`` with numpy
leaves and the optax chain, which ``checkpoint.CheckpointSaver.save``
writes as a JAX worker's ``state.pkl`` (``load_latest``, then
``serving.convert.dp_trainer_state_from_jax``, restores it); the sharded
pair ``save_checkpoint`` / ``set_sharded_restore`` (JAX
``dp_trainer.py:433-532``) writes every leaf replicated, as
``dense|<path>`` in ``dense.pkl``'s ``leaves``.

Not ported yet: ``dense_sharding="fsdp"`` raises
``NotImplementedError`` (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.device import FSDP_ITEM, DeviceLike, resolve_device
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, resolve_mesh
from elasticdl_tpu_torch.parallel.sharding import pad_batch

logger = logging.getLogger("elasticdl_tpu_torch.parallel.dp_trainer")


class DPTrainState(NamedTuple):
    step: int
    params: Dict[str, Any]       # parameter name -> tensor
    opt_state: Dict[str, Any]    # the dense optimizer's state
    model_state: Dict[str, Any]  # {"batch_stats": {name: tensor}}, or {}


def model_apply(model: torch.nn.Module, features, train: bool, **kwargs):
    """Call ``model``, passing ``train`` only where its ``forward`` takes
    it (JAX ``worker/trainer.py:47-57``, ``_model_apply``)."""
    if "train" in inspect.signature(model.forward).parameters:
        kwargs["train"] = train
    return model(features, **kwargs)


def model_state_of(model: torch.nn.Module) -> Dict[str, Any]:
    """The live ``model_state`` of ``model``: ``{"batch_stats": ...}`` for
    a conv net, ``{}`` for a model without batch norm."""
    from elasticdl_tpu_torch.zoo.vision import batch_stats

    stats = batch_stats(model)
    return {"batch_stats": stats} if stats else {}


def per_example_loss_fn(loss_fn):
    """Lift the zoo's batch-mean ``loss(labels, outputs)`` into a
    per-example loss: applied to singleton batches under ``vmap`` (the
    JAX ``per_example_loss_fn``), so padded rows can be masked exactly."""

    def singleton(label, output):
        return loss_fn(label[None], output[None])

    return torch.func.vmap(singleton)


def to_device(tree, device):
    """Arrays or tensors (a dict of them, or one) onto ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def clone_tree(tree):
    """A deep copy of a state's tensors (on their device)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def _take(tree, rows, positions=None):
    """Rows (and sequence positions) of every array of ``tree``."""
    if isinstance(tree, dict):
        return {k: _take(v, rows, positions) for k, v in tree.items()}
    x = tree[rows]
    return x if positions is None else x[:, positions]


@torch.no_grad()
def copy_tree(dst, src) -> None:
    """Copy a state tree (tensors or numpy leaves) into ``dst``'s own
    tensors, in place."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise KeyError(f"state keys {sorted(src)} != {sorted(dst)}")
        for key in dst:
            copy_tree(dst[key], src[key])
        return
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.array(src, dtype=np.asarray(src).dtype))
    dst.copy_(src.reshape(dst.shape))


class DataParallelTrainer:
    """Dense trainer on one CUDA card (``device=None``) or, for the tests,
    on the CPU (``device="cpu"``); over a ``parallel.mesh.Mesh`` it runs
    on the mesh's device."""

    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn,
        optimizer,
        mesh=None,
        seed: int = 0,
        dense_sharding: str = "replicated",
        device: DeviceLike = None,
    ):
        if dense_sharding not in ("replicated", "fsdp"):
            raise ValueError(
                f"dense_sharding must be 'replicated' or 'fsdp', got {dense_sharding!r}"
            )
        if dense_sharding == "fsdp":
            raise NotImplementedError(
                f"dense_sharding='fsdp' shards the state over cards: {FSDP_ITEM}"
            )
        self._mesh = resolve_mesh(mesh, "the port's DataParallelTrainer")
        # A process mesh: this rank holds a share of the batch (and of the
        # sequence) and the gradients are reduced over the world.
        self._world = self._mesh is not None and not self._mesh.in_process
        if self._mesh is None:
            self.device = resolve_device(device)
        else:
            if device is not None and torch.device(device) != self._mesh.device:
                raise ValueError(f"device {device} is not the mesh's {self._mesh.device}")
            self.device = self._mesh.device
            if self._world and self._mesh.shape[MODEL_AXIS] > 1 \
                    and getattr(model, "mesh", None) is not self._mesh:
                raise ValueError(
                    "the mesh's model axis shards the sequence: build the model over the "
                    "same mesh (custom_model(..., mesh=mesh))"
                )
        self._model = model.to(self.device)
        self._loss_fn = loss_fn
        self._per_example_loss = per_example_loss_fn(loss_fn)
        self._tx = optimizer
        self._seed = seed
        self._params: Dict[str, torch.nn.Parameter] = dict(self._model.named_parameters())
        self._model_state = model_state_of(self._model)
        if self._world and self._model_state:
            self._sync_batch_stats()
        self._opt_state: Optional[dict] = None
        self._step = 0
        self._pending_restore: Optional[DPTrainState] = None
        self._pending_sharded_restore = None  # (saver, step)

    def _sync_batch_stats(self) -> None:
        """Every batch norm takes the global batch's statistics: the mean
        of the ranks' ``[E[x], E[x^2]]`` (see the module docstring)."""
        from torch.distributed.nn.functional import all_reduce

        from elasticdl_tpu_torch.zoo.vision import BatchNorm

        if self._mesh.shape[MODEL_AXIS] > 1:
            raise ValueError("batch statistics need every rank to hold rows of the batch: "
                             "a model with batch norm trains on a mesh whose model axis is 1")
        world = self._mesh.shape[DATA_AXIS]
        for module in self._model.modules():
            if isinstance(module, BatchNorm):
                module.stats_reduce = lambda moments: all_reduce(moments) / world

    # -- state ----------------------------------------------------------

    @property
    def model(self) -> torch.nn.Module:
        return self._model

    @property
    def mesh(self):
        return self._mesh

    @property
    def kernel_builds(self) -> Dict[str, int]:
        """The kernel library's build/load count (the JAX trainers'
        ``jitted_entrypoints``: what the step anatomy watches for compiles)."""
        return _build.build_counts()

    @property
    def step(self) -> int:
        return self._step

    @property
    def state(self) -> Optional[DPTrainState]:
        """The live state (references to the trainer's tensors)."""
        if self._opt_state is None:
            return None
        return DPTrainState(self._step, dict(self._params), self._opt_state, self._model_state)

    @state.setter
    def state(self, value: DPTrainState) -> None:
        """Copy ``value`` (tensors or numpy arrays, e.g. from
        ``serving.convert.dp_trainer_state_from_jax``) into the trainer;
        before initialisation it is applied by ``ensure_initialized``."""
        value = DPTrainState(*value)
        if self._opt_state is None:
            self._pending_restore = value
            self._step = int(value.step)
            return
        copy_tree(self._params, value.params)
        copy_tree(self._opt_state, value.opt_state)
        copy_tree(self._model_state, value.model_state)
        self._step = int(value.step)

    def ensure_initialized(self, features=None) -> DPTrainState:
        """Seeded init (or the pending restore) and the optimizer state.
        ``features`` is accepted for the JAX signature; the port's shapes
        do not depend on it."""
        if self._opt_state is not None:
            return self.state
        if self._pending_restore is None and self._pending_sharded_restore is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self._seed)
            self._model.init_parameters(generator)
            if self._world:  # one seed gives one init; rank 0's is the state
                self._reduce_flat(self._params.values(), broadcast=True)
        self._opt_state = self._tx.init(self._params)
        if self._pending_sharded_restore is not None:
            self._pending_restore = None
            self._restore_sharded()
        elif self._pending_restore is not None:
            restore, self._pending_restore = self._pending_restore, None
            self.state = restore
        logger.info("Initialized model on %s: %d parameters [%s]", self.device,
                    sum(p.numel() for p in self._params.values()), self._tx.name)
        return self.state

    # -- the three parts of a step --------------------------------------

    def forward(self, features, labels, mask, positions=None, denominator=None,
                token_share: float = 1.0) -> torch.Tensor:
        """The model and the mask-weighted mean of the per-example loss.
        On a process mesh (``stage_batch`` supplies the rest): this
        rank's tokens at ``positions``, and its share of the global mean,
        over the global mask count ``denominator``."""
        self._model.train()
        if positions is None:
            outputs = model_apply(self._model, features, train=True)
        else:
            outputs = self._model(features, positions=positions)
        losses = self._per_example_loss(labels, outputs)
        if denominator is None:
            return torch.sum(losses * mask) / torch.clamp(torch.sum(mask), min=1.0)
        return torch.sum(losses * mask) * token_share / denominator

    def backward(self, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        """-> ``{parameter name: gradient}`` (zeros where unused), summed
        over the world on a process mesh."""
        names = list(self._params)
        grads = torch.autograd.grad(loss, [self._params[n] for n in names], allow_unused=True)
        grads = {
            n: g if g is not None else torch.zeros_like(self._params[n])
            for n, g in zip(names, grads)
        }
        if self._world:
            self._reduce_flat(grads.values())
        return grads

    @torch.no_grad()
    def _reduce_flat(self, tensors, broadcast: bool = False) -> None:
        """All-reduce (SUM over the world) or broadcast from rank 0 the
        f32 ``tensors`` in place, through one flat buffer."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if broadcast:
            dist.broadcast(flat, src=0)
        else:
            dist.all_reduce(flat)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def dense_update(self, grads: Dict[str, torch.Tensor]) -> None:
        self._tx.apply(self._params, grads, self._opt_state)

    # -- host-side entry points -----------------------------------------

    def stage_batch(self, features, labels, mask):
        """One batch onto the trainer's device; on a process mesh, this
        rank's share of the global batch with what ``forward`` needs to
        weigh it."""
        if self._world:
            feats, labels, mask, positions, denominator, share = self._local_batch(
                features, labels, mask)
            return (to_device(feats, self.device), to_device(labels, self.device),
                    to_device(mask, self.device), None if positions is None
                    else to_device(positions, self.device), denominator, share)
        if not isinstance(mask, torch.Tensor):
            mask = np.asarray(mask, np.float32)
        return (to_device(features, self.device), to_device(labels, self.device),
                to_device(mask, self.device).to(torch.float32))

    def _local_batch(self, features, labels, mask):
        """A process mesh: the global batch padded to the data axis, then
        this rank's rows and, when the sequence is sharded, its positions;
        the global mask count and this rank's share of the tokens."""
        data = self._mesh.shape[DATA_AXIS]
        features, pad_mask = pad_batch(features, data)
        mask = np.concatenate([np.asarray(mask, np.float32),
                               np.zeros(len(pad_mask) - len(mask), np.float32)])
        rows = len(mask) // data
        mine = slice(self._mesh.data_index * rows, (self._mesh.data_index + 1) * rows)
        seq_len = _seq_len(features)
        positions = self._sequence_positions(seq_len)
        share = 1.0 if positions is None else len(positions) / seq_len
        labels = None if labels is None else _take(pad_batch(labels, data)[0], mine, positions)
        return (_take(features, mine, positions), labels, mask[mine], positions,
                float(max(mask.sum(), 1.0)), share)

    def _sequence_positions(self, seq_len: int, index: Optional[int] = None):
        fn = getattr(self._model, "sequence_positions", None)
        return None if fn is None else fn(seq_len, index)

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
        loss = self.forward(*staged)
        self.dense_update(self.backward(loss))
        self._step += 1
        loss = loss.detach()
        if self._world:  # the global loss: every rank's share, summed
            loss = loss.clone()
            dist.all_reduce(loss)
        return loss

    def stage_window(self, batches):
        """K ``(features, labels, mask)`` batches of one shape -> stacked
        ``[K, batch, ...]`` tensors on the device (on a process mesh, the
        K staged shares)."""
        if self._world:
            return [self.stage_batch(*b) for b in batches]
        return self.stage_batch(*(
            np.stack([np.asarray(b[i]) for b in batches]) for i in range(3)
        ))

    def train_window(self, window):
        """Run every batch of a staged window; returns the ``[K]`` losses."""
        if self._opt_state is None:
            self.ensure_initialized()
        if self._world:
            return torch.stack([self.train_step_staged(staged) for staged in window])
        feats, labels, masks = window
        return torch.stack([
            self.train_step_staged((feats[k], labels[k], masks[k]))
            for k in range(labels.shape[0])
        ])

    @torch.no_grad()
    def eval_step(self, features) -> np.ndarray:
        """The model's outputs on the global ``features``; on a process
        mesh every rank computes its share and the outputs are gathered
        (a collective)."""
        self.ensure_initialized(features)
        self._model.eval()
        try:
            if self._world:
                return self._eval_world(features)
            out = model_apply(self._model, to_device(features, self.device), train=False)
        finally:
            self._model.train()
        return out.cpu().numpy()

    def eval_step_local(self, features) -> np.ndarray:
        """JAX ``dp_trainer.py:417``: the outputs of every row of the
        worker's global batch (a collective on a process mesh)."""
        return self.eval_step(features)

    def _eval_world(self, features) -> np.ndarray:
        n = len(np.asarray(features))
        feats, _, _, positions, _, _ = self._local_batch(features, None, np.ones(n))
        feats = to_device(feats, self.device)
        if positions is None:
            out = model_apply(self._model, feats, train=False)
            seq_len = out.shape[1]  # every rank holds whole rows
        else:
            out = self._model(feats, positions=to_device(positions, self.device))
            seq_len = _seq_len(features)
        full = self._mesh.gather_sequence(
            out, seq_len, lambda index: self._sequence_positions(seq_len, index))
        return full[:n].cpu().numpy()

    def state_to_host(self) -> Optional[DPTrainState]:
        """Host snapshot: the state with numpy leaves, copies on every device
        (a snapshot kept across a step does not change with it)."""
        if self._opt_state is None:
            return None

        def host(tree):
            if isinstance(tree, dict):
                return {k: host(v) for k, v in tree.items()}
            return tree.detach().to("cpu", copy=True).numpy()

        return DPTrainState(self._step, host(dict(self._params)), host(self._opt_state),
                            host(self._model_state))

    def state_to_jax_host(self):
        """Host snapshot in the JAX layout: the JAX ``TrainState`` with
        numpy leaves and the optax chain (``serving.convert.
        jax_dp_trainer_state_from_port``), what ``CheckpointSaver.save``
        writes for a JAX worker to restore."""
        from elasticdl_tpu_torch.serving import convert

        if self._opt_state is None:
            return None
        return convert.jax_dp_trainer_state_from_port(self.state, self._model, self._tx.name)

    # -- sharded checkpoints (JAX dp_trainer.py:433-532) ----------------

    def save_checkpoint(self, saver, step: int) -> None:
        """Sharded checkpoint (``checkpoint.sharded.ShardedCheckpointSaver``)
        with every leaf replicated: rank 0 writes ``{"step", "leaves":
        {"dense|<path>": leaf}}``, the JAX trainer's leaf names; every
        rank calls it (the save is collective)."""
        if self._opt_state is None:
            return
        dense = None
        if not self._world or self._mesh.rank == 0:
            dense = {"step": int(self._step), "leaves": dict(_leaf_items(self.state_to_jax_host()))}
        saver.save(step, dense, {})

    def set_sharded_restore(self, saver, step: int) -> None:
        """Restore ``step`` of ``saver`` at ``ensure_initialized``."""
        self._pending_sharded_restore = (saver, step)
        self._step = step

    def _restore_sharded(self) -> None:
        """Every leaf of this build from the checkpoint: from ``dense.pkl``,
        or read whole from the shard files where the JAX trainer wrote it
        sharded (FSDP); a missing leaf, or one of another shape or dtype,
        raises."""
        from elasticdl_tpu_torch.serving import convert

        saver, step = self._pending_sharded_restore
        self._pending_sharded_restore = None
        arrays = saver.manifest(step)["arrays"]
        dense = saver.load_dense(step)

        def fetch(key, template):
            if key in arrays:
                leaf = saver.load_rows(step, key, 0, arrays[key]["shape"][0])
            elif key in dense["leaves"]:
                leaf = dense["leaves"][key]
            else:
                raise KeyError(f"Checkpoint at step {step} missing leaf {key} "
                               "(model structure changed?)")
            leaf = np.asarray(leaf)
            if leaf.shape != template.shape or leaf.dtype != template.dtype:
                raise ValueError(f"Checkpoint leaf {key} is {leaf.dtype}{list(leaf.shape)}, "
                                 f"this build's {template.dtype}{list(template.shape)}")
            return leaf

        try:
            restored = _map_leaves(self.state_to_jax_host(), fetch)
        finally:
            saver.release(step)
        self.state = convert.dp_trainer_state_from_jax(restored, self._model)
        self._step = int(dense["step"])
        logger.info("Restored sharded checkpoint at step %d", self._step)

    def get_variables_numpy(self) -> Dict[str, np.ndarray]:
        """Flat ``{"params/<flax path>": array}`` (and ``"batch_stats/..."``)
        in the JAX layout."""
        from elasticdl_tpu_torch.serving import convert

        if self._opt_state is None:
            return {}
        return convert.flat_jax_variables(self._model)


def _leaf_items(tree):
    """("dense|<path>", leaf) of every leaf of a JAX-layout state: the
    JAX trainer's ``_leaf_key`` names, in ``jax.tree_util``'s order."""
    items = []
    _map_leaves(tree, lambda key, leaf: items.append((key, leaf)))
    return items


def _map_leaves(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn("dense|<path>", leaf)``,
    each path entry as ``jax.tree_util`` prints it: a NamedTuple field
    ``.name``, a tuple index ``[i]``, a dict key as it is (dicts in
    sorted key order)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(getattr(tree, f), fn, path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(c, fn, path + (f"[{i}]",)) for i, c in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _map_leaves(tree[k], fn, path + (str(k),)) for k in sorted(tree)}
    return fn("dense|" + "/".join(path), tree)


def _seq_len(features) -> int:
    first = next(iter(features.values())) if isinstance(features, dict) else features
    return int(np.asarray(first).shape[1])
