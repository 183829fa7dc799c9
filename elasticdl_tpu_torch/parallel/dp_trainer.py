"""Data-parallel trainer on one card: the port of ``DataParallelTrainer``
(``elasticdl_tpu/parallel/dp_trainer.py``), the AllReduce strategy's
trainer, which trains the transformer LM.

On one card there is nothing to reduce: the model's ``nn.Parameter``s
are the dense params, updated in place by a dense optimizer
(``parallel/optim.py``; the LM's is AdamW).  The loss is the mask-weighted
mean of the per-example loss (``per_example_loss_fn``), so padded rows
contribute nothing, as in JAX.

A step is three parts, each its own method so a caller can time them
(``chip_smoke.py`` does, with CUDA events): ``forward`` (the model and
the loss), ``backward`` (the dense gradients) and ``dense_update``.  The
JAX ``train_window`` is a ``lax.scan`` over K steps in one program; here
it is a Python loop over the staged batches.

Not ported yet: a mesh of more than one device and
``dense_sharding="fsdp"`` (multi-card, ROADMAP Queue 1) raise
``NotImplementedError``; checkpoint save/restore is not ported;
``model_state`` collections are empty (the transformer has none).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import (
    MULTI_CARD_ITEM,
    DeviceLike,
    require_one_device,
    resolve_device,
)

logger = logging.getLogger("elasticdl_tpu_torch.parallel.dp_trainer")


class DPTrainState(NamedTuple):
    step: int
    params: Dict[str, Any]       # parameter name -> tensor
    opt_state: Dict[str, Any]    # the dense optimizer's state
    model_state: Dict[str, Any]  # non-trainable collections (none yet)


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
    on the CPU (``device="cpu"``)."""

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
                f"dense_sharding='fsdp' shards the state over cards: {MULTI_CARD_ITEM}"
            )
        require_one_device(mesh, "the port's DataParallelTrainer")
        self.device = resolve_device(device)
        self._model = model.to(self.device)
        self._loss_fn = loss_fn
        self._per_example_loss = per_example_loss_fn(loss_fn)
        self._tx = optimizer
        self._seed = seed
        self._params: Dict[str, torch.nn.Parameter] = dict(self._model.named_parameters())
        self._opt_state: Optional[dict] = None
        self._step = 0
        self._pending_restore: Optional[DPTrainState] = None

    # -- state ----------------------------------------------------------

    @property
    def model(self) -> torch.nn.Module:
        return self._model

    @property
    def step(self) -> int:
        return self._step

    @property
    def state(self) -> Optional[DPTrainState]:
        """The live state (references to the trainer's tensors)."""
        if self._opt_state is None:
            return None
        return DPTrainState(self._step, dict(self._params), self._opt_state, {})

    @state.setter
    def state(self, value: DPTrainState) -> None:
        """Copy ``value`` (tensors or numpy arrays, e.g. from
        ``serving.convert.dp_trainer_state_from_jax``) into the trainer;
        before initialisation it is applied by ``ensure_initialized``."""
        value = DPTrainState(*value)
        if value.model_state:
            raise KeyError(f"model_state collections are not ported: {sorted(value.model_state)}")
        if self._opt_state is None:
            self._pending_restore = value
            self._step = int(value.step)
            return
        copy_tree(self._params, value.params)
        copy_tree(self._opt_state, value.opt_state)
        self._step = int(value.step)

    def ensure_initialized(self, features=None) -> DPTrainState:
        """Seeded init (or the pending restore) and the optimizer state.
        ``features`` is accepted for the JAX signature; the port's shapes
        do not depend on it."""
        if self._opt_state is not None:
            return self.state
        if self._pending_restore is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self._seed)
            self._model.init_parameters(generator)
        self._opt_state = self._tx.init(self._params)
        if self._pending_restore is not None:
            restore, self._pending_restore = self._pending_restore, None
            self.state = restore
        logger.info("Initialized model on %s: %d parameters [%s]", self.device,
                    sum(p.numel() for p in self._params.values()), self._tx.name)
        return self.state

    # -- the three parts of a step --------------------------------------

    def forward(self, features, labels, mask) -> torch.Tensor:
        """The model and the mask-weighted mean of the per-example loss."""
        self._model.train()
        outputs = self._model(features)
        losses = self._per_example_loss(labels, outputs)
        return torch.sum(losses * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def backward(self, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        """-> ``{parameter name: gradient}`` (zeros where unused)."""
        names = list(self._params)
        grads = torch.autograd.grad(loss, [self._params[n] for n in names], allow_unused=True)
        return {
            n: g if g is not None else torch.zeros_like(self._params[n])
            for n, g in zip(names, grads)
        }

    def dense_update(self, grads: Dict[str, torch.Tensor]) -> None:
        self._tx.apply(self._params, grads, self._opt_state)

    # -- host-side entry points -----------------------------------------

    def stage_batch(self, features, labels, mask):
        """One batch onto the trainer's device."""
        if not isinstance(mask, torch.Tensor):
            mask = np.asarray(mask, np.float32)
        return (to_device(features, self.device), to_device(labels, self.device),
                to_device(mask, self.device).to(torch.float32))

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
        return loss.detach()

    def stage_window(self, batches):
        """K ``(features, labels, mask)`` batches of one shape -> stacked
        ``[K, batch, ...]`` tensors on the device."""
        return self.stage_batch(*(
            np.stack([np.asarray(b[i]) for b in batches]) for i in range(3)
        ))

    def train_window(self, window):
        """Run every batch of a staged window; returns the ``[K]`` losses."""
        if self._opt_state is None:
            self.ensure_initialized()
        feats, labels, masks = window
        return torch.stack([
            self.train_step_staged((feats[k], labels[k], masks[k]))
            for k in range(labels.shape[0])
        ])

    @torch.no_grad()
    def eval_step(self, features) -> np.ndarray:
        self.ensure_initialized(features)
        self._model.eval()
        try:
            out = self._model(to_device(features, self.device))
        finally:
            self._model.train()
        return out.cpu().numpy()

    def state_to_host(self) -> Optional[DPTrainState]:
        """Host snapshot: the state with numpy leaves."""
        if self._opt_state is None:
            return None

        def host(tree):
            if isinstance(tree, dict):
                return {k: host(v) for k, v in tree.items()}
            return tree.detach().cpu().numpy()

        return DPTrainState(self._step, host(dict(self._params)), host(self._opt_state), {})

    def get_variables_numpy(self) -> Dict[str, np.ndarray]:
        """Flat ``{"params/<flax path>": array}`` in the JAX layout."""
        from elasticdl_tpu_torch.serving import convert

        if self._opt_state is None:
            return {}
        return convert.flat_jax_variables(self._model)
