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
4. sums the gradients with one flat all-reduce per group: over the world
   the gradients that are parts of a sum over the model axis
   (``model.model_axis_partial()``: every one when the axis carries the
   sequence, the sliced ones under tensor parallelism), over ``data``
   the rest (under tensor parallelism the replicated leaves' gradients,
   and the loss, are whole on every model rank);
5. applies the same AdamW; parameters stay replicated and identical.

``dense_sharding="fsdp"`` (JAX ``:69,106-134``, ``parallel/fsdp.py``):
a parameter whose flax-layout dim 0 divides the data axis and that has
at least ``FSDP_MIN_LEAF`` elements is held as its dim-0 block of that
layout, and so are its optimizer slots; the optimizer (elementwise)
updates the blocks.  On a process mesh each rank holds its own block:
the blocks are all-gathered into the model's parameters before the
forward, the gradients reduce-scattered over ``data`` after the backward
(after the model-axis sum of a sliced one), and the gathered parameters'
memory is released until the next gather.  An in-process mesh holds
the data axis's blocks side by side and puts them back together for the
step, so its numbers are the replicated mode's bit for bit.  With no
mesh, or a data axis of one, FSDP is the replicated layout.  ``state``,
``state_to_host``, ``get_variables_numpy`` and ``jax_variables`` gather
(collectives on a process mesh, as in JAX).

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
``dp_trainer.py:433-532``) writes every replicated leaf as
``dense|<path>`` in ``dense.pkl``'s ``leaves``, and under FSDP each
process writes the flax-layout rows of its blocks of the sharded leaves
to its shard file, in JAX's layout, which JAX's
``ShardedCheckpointSaver`` reads back.
"""

from __future__ import annotations

import contextlib
import inspect
import logging
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.device import DeviceLike, resolve_device
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.parallel import fsdp
from elasticdl_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_all_gather,
    axis_reduce_scatter,
    resolve_mesh,
)
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

    FSDP_MIN_LEAF = fsdp.FSDP_MIN_LEAF

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
        self._dense_sharding = dense_sharding
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
                    "the mesh's model axis carries the sequence (context parallelism) or the "
                    "heads (tensor parallelism): build the model over the same mesh "
                    "(custom_model(..., mesh=mesh))"
                )
        self._model = model.to(self.device)
        # Under tensor parallelism the model ranks hold whole losses and
        # whole gradients of the replicated leaves: those sum over data.
        self._tp = self._world and getattr(model, "model_axis_mode", None) == "tp"
        #: parameter name -> its FSDP block layout (empty: replicated)
        self._fsdp: Dict[str, fsdp.FsdpLeaf] = (
            fsdp.plan(self._model, self._mesh.shape[DATA_AXIS])
            if dense_sharding == "fsdp" and self._mesh is not None else {})
        # An in-process mesh holds a sharded leaf as the data axis's blocks.
        self._blocks = 1 if self._world or not self._fsdp else self._mesh.shape[DATA_AXIS]
        from elasticdl_tpu_torch.serving.convert import _targets

        #: a sharded leaf by its flax path under ``params`` (the checkpoint's keys)
        self._fsdp_by_path = {jax_key[len("params/"):]: self._fsdp[port_key]
                              for jax_key, port_key, _, _ in _targets(self._model)
                              if port_key in self._fsdp}
        self._loss_fn = loss_fn
        self._per_example_loss = per_example_loss_fn(loss_fn)
        self._tx = optimizer
        self._seed = seed
        self._params: Dict[str, torch.nn.Parameter] = dict(self._model.named_parameters())
        #: parameters whose gradient a process rank holds as a part of a
        #: sum over the model axis (every one where the axis carries the
        #: sequence)
        self._model_partial = set()
        if self._mesh is not None and self._mesh.shape[MODEL_AXIS] > 1:
            partial = getattr(self._model, "model_axis_partial", None)
            self._model_partial = set(self._params) if partial is None else set(partial())
        self._model_state = model_state_of(self._model)
        if self._world and self._model_state:
            self._sync_batch_stats()
        # What the optimizer updates: the model's parameters, and under
        # FSDP the blocks of the sharded ones (key -> tensor).
        self._opt_params: Dict[str, torch.Tensor] = dict(self._params)
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
    def dense_sharding(self) -> str:
        return self._dense_sharding

    @property
    def fsdp_leaves(self) -> Dict[str, fsdp.FsdpLeaf]:
        """The parameters FSDP shards (name -> block layout); empty when
        the layout is the replicated one."""
        return dict(self._fsdp)

    @property
    def state(self) -> Optional[DPTrainState]:
        """The live state (references to the trainer's tensors); under
        FSDP the sharded leaves and their slots are whole copies, gathered
        (a collective on a process mesh)."""
        if self._opt_state is None:
            return None
        if not self._fsdp:
            return DPTrainState(self._step, dict(self._params), self._opt_state,
                                self._model_state)
        return DPTrainState(self._step, self._whole(self._opt_params),
                            self._map_param_dicts(self._opt_state, self._whole),
                            self._model_state)

    @property
    def local_state(self) -> Optional[DPTrainState]:
        """What this process holds: under FSDP each sharded leaf and its
        slots as their blocks (``name@i`` keys for an in-process mesh's),
        the rest as in ``state``."""
        if self._opt_state is None:
            return None
        return DPTrainState(self._step, dict(self._opt_params), self._opt_state,
                            self._model_state)

    @state.setter
    def state(self, value: DPTrainState) -> None:
        """Copy ``value`` (tensors or numpy arrays, e.g. from
        ``serving.convert.dp_trainer_state_from_jax``; whole leaves) into
        the trainer; before initialisation it is applied by
        ``ensure_initialized``."""
        value = DPTrainState(*value)
        if self._opt_state is None:
            self._pending_restore = value
            self._step = int(value.step)
            return
        copy_tree(self._opt_params, self._local(value.params))
        copy_tree(self._opt_state, self._map_param_dicts(value.opt_state, self._local,
                                                         set(self._params)))
        copy_tree(self._model_state, value.model_state)
        self._step = int(value.step)

    # -- FSDP blocks ----------------------------------------------------

    def _keys(self, name: str):
        """The optimizer's keys of parameter ``name``: ``name@i`` for each
        block an in-process mesh holds of a sharded leaf, else ``name``."""
        if name not in self._fsdp or self._blocks == 1:
            return [name]
        return [f"{name}@{i}" for i in range(self._blocks)]

    def _local(self, whole: Dict[str, Any]) -> Dict[str, Any]:
        """``{parameter name: whole value}`` -> ``{optimizer key: what this
        process holds}``: the blocks of the sharded leaves."""
        out = {}
        for name, value in whole.items():
            leaf = self._fsdp.get(name)
            if leaf is None:
                out[name] = value
                continue
            value = value if isinstance(value, torch.Tensor) else torch.from_numpy(
                np.array(value, dtype=np.asarray(value).dtype))
            value = value.reshape(self._params[name].shape)
            if self._world:
                out[name] = leaf.block(value, self._mesh.data_index)
            else:
                for i, key in enumerate(self._keys(name)):
                    out[key] = leaf.block(value, i)
        return out

    def _whole(self, local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inverse of ``_local``: whole port-layout tensors, the
        sharded ones gathered (a collective on a process mesh)."""
        out = {}
        for name in self._params:
            leaf = self._fsdp.get(name)
            if leaf is None:
                out[name] = local[name]
            elif self._world:
                out[name] = leaf.to_port(axis_all_gather(self._mesh, DATA_AXIS, local[name]))
            else:
                out[name] = leaf.to_port(torch.cat([local[k] for k in self._keys(name)]))
        return out

    def _map_param_dicts(self, tree, fn, keys=None):
        """``tree`` (an optimizer state) with each dict keyed by the
        parameters (``keys``; default the optimizer's keys) mapped by
        ``fn``."""
        keys = set(self._opt_params) if keys is None else keys
        if isinstance(tree, dict):
            if tree and set(tree) == keys:
                return fn(tree)
            return {k: self._map_param_dicts(v, fn, keys) for k, v in tree.items()}
        return tree

    @torch.no_grad()
    def _shard_params(self) -> None:
        """Under FSDP: the optimizer's blocks of the freshly initialised
        (whole, identical) parameters, then their gathered memory freed."""
        for name, leaf in self._fsdp.items():
            whole = self._params[name].detach()
            indices = [self._mesh.data_index] if self._world else range(self._blocks)
            blocks = [leaf.block(whole, i) for i in indices]
            del self._opt_params[name]
            self._opt_params.update(zip(self._keys(name), blocks))
            fsdp.free_storage(self._params[name])

    @torch.no_grad()
    def _gather_params(self) -> None:
        """The sharded parameters put back together in the model (an
        all-gather over ``data`` per leaf on a process mesh)."""
        whole = self._whole(self._opt_params)
        for name in self._fsdp:
            param = self._params[name]
            fsdp.alloc_storage(param)
            param.copy_(whole[name])

    def _release_params(self) -> None:
        for name in self._fsdp:
            fsdp.free_storage(self._params[name])

    @contextlib.contextmanager
    def _gathered(self):
        """The model with whole parameters for the body (FSDP: gathered,
        then released)."""
        if self._fsdp and self._opt_state is not None:
            self._gather_params()
            try:
                yield
            finally:
                self._release_params()
        else:
            yield

    def ensure_initialized(self, features=None) -> DPTrainState:
        """Seeded init (or the pending restore) and the optimizer state;
        returns ``local_state`` (under FSDP the blocks: gathering them at
        every step would undo it).  ``features`` is accepted for the JAX
        signature; the port's shapes do not depend on it."""
        if self._opt_state is not None:
            return self.local_state
        if self._pending_restore is None and self._pending_sharded_restore is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self._seed)
            self._model.init_parameters(generator)
            if self._world:  # one seed gives one init; rank 0's is the state
                self._reduce_flat(self._params.values(), broadcast=True)
        self._shard_params()
        self._opt_state = self._tx.init(self._opt_params)
        if self._pending_sharded_restore is not None:
            self._pending_restore = None
            self._restore_sharded()
        elif self._pending_restore is not None:
            restore, self._pending_restore = self._pending_restore, None
            self.state = restore
        logger.info("Initialized model on %s: %d parameters [%s, %s%s]", self.device,
                    sum(p.numel() for p in self._params.values()), self._tx.name,
                    self._dense_sharding,
                    f", {len(self._fsdp)} leaves sharded over data" if self._fsdp else "")
        return self.local_state

    # -- the three parts of a step --------------------------------------

    def forward(self, features, labels, mask, positions=None, denominator=None,
                token_share: float = 1.0) -> torch.Tensor:
        """The model and the mask-weighted mean of the per-example loss.
        On a process mesh (``stage_batch`` supplies the rest): this
        rank's tokens at ``positions``, and its share of the global mean,
        over the global mask count ``denominator``."""
        self._model.train()
        if self._fsdp:
            self._gather_params()
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
        over the mesh on a process mesh; under FSDP keyed like the
        optimizer's blocks, each a block of the gradient (reduce-scattered
        on a process mesh)."""
        names = list(self._params)
        grads = torch.autograd.grad(loss, [self._params[n] for n in names], allow_unused=True)
        grads = {
            n: g if g is not None else torch.zeros_like(self._params[n])
            for n, g in zip(names, grads)
        }
        if self._world:
            grads = self._reduce_grads(grads)
        elif self._fsdp:
            for name, leaf in self._fsdp.items():
                whole = grads.pop(name)
                for i, key in enumerate(self._keys(name)):
                    grads[key] = leaf.block(whole, i)
        if self._fsdp:
            self._release_params()
        return grads

    @torch.no_grad()
    def _reduce_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A process mesh's gradient sums (the module docstring, step 4):
        the model-axis parts over the world, the rest over ``data`` (the
        world when the model axis is 1); under FSDP a sharded leaf's
        model-axis part summed over ``model`` first, then every sharded
        leaf reduce-scattered over ``data`` in one flat buffer."""
        mesh = self._mesh
        dense = [n for n in grads if n not in self._fsdp]
        over_world = [n for n in dense if n in self._model_partial
                      or mesh.shape[MODEL_AXIS] == 1]
        self._reduce_flat([grads[n] for n in over_world])
        self._reduce_flat([grads[n] for n in dense if n not in over_world],
                          group=mesh.group(DATA_AXIS))
        sharded = list(self._fsdp)
        if not sharded:
            return grads
        self._reduce_flat([grads[n] for n in sharded if n in self._model_partial],
                          group=mesh.group(MODEL_AXIS))
        flat = torch.cat([self._fsdp[n].flax_blocks(grads[n]) for n in sharded], dim=1)
        mine = axis_reduce_scatter(mesh, DATA_AXIS, flat.reshape(-1))
        offset = 0
        for name in sharded:
            leaf = self._fsdp[name]
            size = int(np.prod(leaf.block_shape))
            grads[name] = mine[offset:offset + size].view(leaf.block_shape)
            offset += size
        return grads

    @torch.no_grad()
    def _reduce_flat(self, tensors, broadcast: bool = False, group=None) -> None:
        """All-reduce (SUM over ``group``, default the world) or broadcast
        from rank 0 the f32 ``tensors`` in place, through one flat
        buffer."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if broadcast:
            dist.broadcast(flat, src=0, group=dist.group.WORLD)
        else:
            dist.all_reduce(flat, group=group or dist.group.WORLD)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def dense_update(self, grads: Dict[str, torch.Tensor]) -> None:
        self._tx.apply(self._opt_params, grads, self._opt_state)

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

    def train_step_staged(self, staged):  # hot-path
        if self._opt_state is None:
            raise RuntimeError("train_step_staged requires ensure_initialized() first")
        loss = self.forward(*staged)
        self.dense_update(self.backward(loss))
        self._step += 1
        loss = loss.detach()
        if self._world:  # the global loss: every rank's share, summed
            loss = loss.clone()
            # Tensor parallelism: every model rank holds the same loss.
            dist.all_reduce(loss, group=self._mesh.group(DATA_AXIS) if self._tp
                            else dist.group.WORLD)
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
        return self._train_window(window)

    def _train_window(self, window) -> torch.Tensor:  # hot-path
        """The window step's device part (JAX ``_train_window_impl``)."""
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
            with self._gathered():
                if self._world:
                    return self._eval_world(features)
                out = self._eval_outputs(to_device(features, self.device))
        finally:
            self._model.train()
        return out.cpu().numpy()

    def _eval_outputs(self, features, positions=None) -> torch.Tensor:  # hot-path
        """The eval step's device part (JAX ``_eval_step_impl``): the
        model's outputs on staged ``features`` (at ``positions`` on a
        context-parallel mesh)."""
        if positions is None:
            return model_apply(self._model, features, train=False)
        return self._model(features, positions=positions)

    def eval_step_local(self, features) -> np.ndarray:
        """JAX ``dp_trainer.py:417``: the outputs of every row of the
        worker's global batch (a collective on a process mesh)."""
        return self.eval_step(features)

    def _eval_world(self, features) -> np.ndarray:
        n = len(np.asarray(features))
        feats, _, _, positions, _, _ = self._local_batch(features, None, np.ones(n))
        feats = to_device(feats, self.device)
        if positions is None:
            out = self._eval_outputs(feats)
            seq_len = out.shape[1]  # every rank holds whole rows
        else:
            out = self._eval_outputs(feats, to_device(positions, self.device))
            seq_len = _seq_len(features)
        full = self._mesh.gather_sequence(
            out, seq_len, lambda index: self._sequence_positions(seq_len, index))
        return full[:n].cpu().numpy()

    def state_to_host(self) -> Optional[DPTrainState]:
        """Host snapshot: the state with numpy leaves, copies on every device
        (a snapshot kept across a step does not change with it); whole
        leaves, gathered under FSDP (a collective on a process mesh)."""
        state = self.state
        if state is None:
            return None

        def host(tree):
            if isinstance(tree, dict):
                return {k: host(v) for k, v in tree.items()}
            return tree.detach().to("cpu", copy=True).numpy()

        return DPTrainState(self._step, host(state.params), host(state.opt_state),
                            host(state.model_state))

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
        """Sharded checkpoint (``checkpoint.sharded.ShardedCheckpointSaver``,
        JAX ``dp_trainer.py:448-480``): rank 0 writes ``{"step", "leaves":
        {"dense|<path>": leaf}}`` with the replicated leaves, the JAX
        trainer's leaf names; under FSDP each process writes the
        flax-layout rows of its blocks of the sharded leaves (on a
        process mesh the ranks of model index 0; an in-process mesh
        writes them whole), so no host gathers them.  Every rank calls it
        (the save is collective)."""
        from elasticdl_tpu_torch.checkpoint.sharded import ShardedArray

        if self._opt_state is None:
            return
        rank0 = not self._world or self._mesh.rank == 0
        writes = not self._world or self._mesh.model_index == 0
        dense_leaves, sharded = {}, {}
        for key, leaf in _leaf_items(self._local_jax_state()):
            rows = self._sharded_rows(key)
            if rows is None:
                if rank0:
                    dense_leaves[key] = leaf
                continue
            (lo, hi), n = rows
            sharded[key] = ShardedArray((n,) + tuple(leaf.shape[1:]), str(leaf.dtype),
                                        [(lo, hi, leaf)] if writes else [])
        dense = {"step": int(self._step), "leaves": dense_leaves} if rank0 else None
        saver.save(step, dense, sharded)

    def _local_jax_state(self):
        """This process's state in the JAX layout, numpy leaves: whole
        leaves, and on a process mesh under FSDP the flax-layout blocks
        of the sharded ones (an in-process mesh's blocks put together)."""
        from elasticdl_tpu_torch.serving import convert

        if not (self._world and self._fsdp):
            return self.state_to_jax_host()

        def port_form(local):
            return {name: leaf.to_port(local[name]) if (leaf := self._fsdp.get(name))
                    else local[name] for name in self._params}

        state = DPTrainState(self._step, port_form(self._opt_params),
                             self._map_param_dicts(self._opt_state, port_form),
                             self._model_state)
        return convert.jax_dp_trainer_state_from_port(state, self._model, self._tx.name)

    def _sharded_rows(self, key: str):
        """``((lo, hi), rows)`` of a JAX leaf key FSDP shards: this
        process's flax dim-0 rows of it and its whole dim 0; None for a
        replicated leaf.  A parameter's optimizer moments (``mu``, ``nu``,
        ``trace``) follow it."""
        parts = key[len("dense|"):].split("/")
        if parts[0] == ".params":
            sub = parts[1:]
        elif parts[0] == ".opt_state" and len(parts) > 3 and parts[2] in (".mu", ".nu", ".trace"):
            sub = parts[3:]
        else:
            return None
        leaf = self._fsdp_by_path.get("/".join(sub))
        if leaf is None:
            return None
        n = leaf.flax_shape[0]
        if not self._world:
            return (0, n), n
        lo = self._mesh.data_index * leaf.rows
        return (lo, lo + leaf.rows), n

    def set_sharded_restore(self, saver, step: int) -> None:
        """Restore ``step`` of ``saver`` at ``ensure_initialized``."""
        self._pending_sharded_restore = (saver, step)
        self._step = step

    def _restore_sharded(self) -> None:
        """Every leaf of this build from the checkpoint: a sharded array's
        rows this process holds (its FSDP block, else all of them) from
        the shard files, whoever wrote them, the rest from ``dense.pkl``;
        a missing leaf, or one of another shape or dtype, raises."""
        from elasticdl_tpu_torch.serving import convert

        saver, step = self._pending_sharded_restore
        self._pending_sharded_restore = None
        arrays = saver.manifest(step)["arrays"]
        dense = saver.load_dense(step)

        def fetch(key, template):
            rows = self._sharded_rows(key)
            if key in arrays:
                lo, hi = (0, arrays[key]["shape"][0]) if rows is None else rows[0]
                leaf = saver.load_rows(step, key, lo, hi)
            elif key in dense["leaves"]:
                leaf = dense["leaves"][key]
                if rows is not None:  # written replicated, held as a block
                    leaf = np.asarray(leaf)[rows[0][0]:rows[0][1]]
            else:
                raise KeyError(f"Checkpoint at step {step} missing leaf {key} "
                               "(model structure changed?)")
            leaf = np.asarray(leaf)
            if leaf.shape != template.shape or leaf.dtype != template.dtype:
                raise ValueError(f"Checkpoint leaf {key} is {leaf.dtype}{list(leaf.shape)}, "
                                 f"this build's {template.dtype}{list(template.shape)}")
            return leaf

        try:
            restored = _map_leaves(self._local_jax_state(), fetch)
        finally:
            saver.release(step)
        local = convert.dp_trainer_state_from_jax(restored, self._model)
        if self._world and self._fsdp:  # blocks, already this process's
            def flax_form(values):
                return {name: leaf.to_flax(torch.from_numpy(np.asarray(values[name])))
                        if (leaf := self._fsdp.get(name)) else values[name]
                        for name in values}

            copy_tree(self._opt_params, flax_form(local.params))
            copy_tree(self._opt_state, self._map_param_dicts(
                local.opt_state, flax_form, set(self._params)))
            copy_tree(self._model_state, local.model_state)
        else:
            self.state = local
        self._step = int(dense["step"])
        logger.info("Restored sharded checkpoint at step %d", self._step)

    def jax_variables(self):
        """The weights in the JAX layout, as ``serving/export.
        write_artifact`` takes them (gathered under FSDP: a collective on
        a process mesh)."""
        from elasticdl_tpu_torch.serving import convert

        with self._gathered():
            return convert.jax_variables_from_port(self._model)

    def get_variables_numpy(self) -> Dict[str, np.ndarray]:
        """Flat ``{"params/<flax path>": array}`` (and ``"batch_stats/..."``)
        in the JAX layout (gathered under FSDP: a collective on a process
        mesh)."""
        from elasticdl_tpu_torch.serving import convert

        if self._opt_state is None:
            return {}
        with self._gathered():
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
