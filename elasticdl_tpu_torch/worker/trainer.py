"""The single-device training and evaluation step: the port of
``elasticdl_tpu/worker/trainer.py`` (``TrainState`` :28, ``Trainer``
:60-192), the Local strategy's trainer.

A step is the model's forward (``train=True`` where the model's
``forward`` takes it, ``parallel.dp_trainer.model_apply``), the zoo's
batch-mean ``loss``, the gradients of every parameter and the dense
optimizer's in-place update (``parallel/optim.py``; the vision zoo's is
SGD with (Nesterov) momentum).  A conv net's forward updates its
``batch_stats`` in training and reads them in evaluation.

The state is ``TrainState(step, params, opt_state, model_state)``, the
JAX one's fields: live references to the model's parameters, the
optimizer's state and ``{"batch_stats": ...}`` (``{}`` without batch
norm).  The step counter lives on the host, so no step waits on the
card to count.  ``serving.convert.local_trainer_state_from_jax`` carries
a JAX ``Trainer``'s state across, ``state_to_jax_host`` (``serving.
convert.jax_dp_trainer_state_from_port``: the JAX trainers share one
``TrainState``) goes back.  Initialisation
is seeded through an explicit ``torch.Generator`` (flax's default
initialisers, not JAX's random bits).  The trainer runs on the card
unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import DeviceLike, resolve_device
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.parallel.dp_trainer import (
    copy_tree,
    model_apply,
    model_state_of,
    to_device,
)

logger = logging.getLogger("elasticdl_tpu_torch.worker.trainer")


class TrainState(NamedTuple):
    step: int
    params: Dict[str, Any]
    opt_state: Dict[str, Any]
    model_state: Dict[str, Any]  # {"batch_stats": {name: tensor}}, or {}


class Trainer:
    """Owns a model's variables and its train and eval steps on one device."""

    #: The trainers of a process mesh have one; this one never does.
    mesh = None

    def __init__(self, model: torch.nn.Module, loss_fn, optimizer, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._model = model.to(self.device)
        self._loss_fn = loss_fn
        self._tx = optimizer
        self._seed = seed
        self._params: Dict[str, torch.nn.Parameter] = dict(self._model.named_parameters())
        self._model_state = model_state_of(self._model)
        self._opt_state: Optional[dict] = None
        self._pending_restore: Optional[TrainState] = None
        self._host_step = 0

    @property
    def model(self) -> torch.nn.Module:
        return self._model

    @property
    def kernel_builds(self) -> Dict[str, int]:
        """The kernel library's build/load count (the JAX trainers'
        ``jitted_entrypoints``: what the step anatomy watches for compiles)."""
        return _build.build_counts()

    @property
    def step(self) -> int:
        return self._host_step

    @property
    def state(self) -> Optional[TrainState]:
        if self._opt_state is None:
            return None
        return TrainState(self._host_step, dict(self._params), self._opt_state,
                          self._model_state)

    @state.setter
    def state(self, value: TrainState) -> None:
        """Copy ``value`` (tensors or numpy leaves) into the trainer;
        before initialisation, at ``ensure_initialized``."""
        value = TrainState(*value)
        self._host_step = int(value.step)
        if self._opt_state is None:
            self._pending_restore = value
            return
        copy_tree(self._params, value.params)
        copy_tree(self._opt_state, value.opt_state)
        copy_tree(self._model_state, value.model_state)

    def ensure_initialized(self, features=None) -> TrainState:
        """Seeded init (or the pending restore) and the optimizer state;
        ``features`` is accepted for the JAX signature."""
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

    def train_step(self, features, labels) -> torch.Tensor:
        """One step on a host batch; returns the loss (a device scalar)."""
        return self.train_step_staged(self.stage_batch(features, labels))

    def stage_batch(self, features, labels):
        """A host batch on the trainer's device (the worker times it)."""
        self.ensure_initialized(features)
        return to_device(features, self.device), to_device(labels, self.device)

    def train_step_staged(self, staged) -> torch.Tensor:
        features, labels = staged
        self.ensure_initialized(features)
        loss = self._loss_fn(labels, model_apply(self._model, features, train=True))
        names = list(self._params)
        grads = torch.autograd.grad(loss, [self._params[n] for n in names], allow_unused=True)
        self._tx.apply(self._params, {
            n: g if g is not None else torch.zeros_like(self._params[n])
            for n, g in zip(names, grads)
        }, self._opt_state)
        self._host_step += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, features) -> np.ndarray:
        """The model's outputs (running averages for batch norm) on host."""
        self.ensure_initialized(features)
        out = model_apply(self._model, to_device(features, self.device), train=False)
        return out.cpu().numpy()

    def state_to_jax_host(self):
        """The state in the JAX layout with numpy leaves (a JAX
        ``Trainer``'s ``state.pkl``)."""
        from elasticdl_tpu_torch.serving import convert

        if self._opt_state is None:
            return None
        return convert.jax_dp_trainer_state_from_port(self.state, self._model, self._tx.name)

    def get_variables_numpy(self) -> Dict[str, np.ndarray]:
        """Flat ``{"params/<flax path>": array, "batch_stats/...": array}``."""
        from elasticdl_tpu_torch.serving import convert

        if self._opt_state is None:
            return {}
        return convert.flat_jax_variables(self._model)
