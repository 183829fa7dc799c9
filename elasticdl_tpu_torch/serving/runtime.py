"""Serving replica runtime: batched inference on the card with hot-swap
model generations.

The port of ``elasticdl_tpu/serving/runtime.py``.  A ``ServingReplica``
owns the device side of one replica:

- **Loading.**  Each model generation is an artifact loaded with
  ``load_for_serving`` onto the replica's device (the CUDA card unless
  the caller passes another), or over the replica's ``mesh``: the model
  is built over it and each table placed by ``export.serving_rules`` (split
  over the ``model`` axis, a row view per model slot in process, or
  replicated), so the lookups take the sharded dispatch.
- **Executing.**  ``execute(features, n_valid)`` is the MicroBatcher's
  execute callable: the model's forward under ``torch.inference_mode``,
  host-to-device copy first; the ``.cpu()`` of the result is the device
  sync and happens outside every lock.  PyTorch runs eagerly, so there
  is no per-generation compile; ``warmup`` runs every bucket shape once
  so the first live request of a shape pays no first-use cost (kernel
  build, allocator growth).
- **Hot-swap.**  ``reload(model_dir)`` builds the NEW generation fully
  before an atomic pointer swap; dispatches already riding the old
  generation drain on its in-flight counter before it is released.  A
  failed build keeps the old generation serving and re-raises.  The new
  generation is loaded over the same mesh.

Not ported yet (ROADMAP): delta apply and the canary's
build/commit split, several real cards driven from one process, journal
events.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

from elasticdl_tpu_torch.common.device import DeviceLike, resolve_device
from elasticdl_tpu_torch.data.pipeline import pad_features
from elasticdl_tpu_torch.parallel.mesh import resolve_mesh
from elasticdl_tpu_torch.serving.export import ServingModel, load_for_serving

logger = logging.getLogger("elasticdl_tpu_torch.serving.runtime")


class Generation:
    """One loaded model generation plus an in-flight dispatch count, so
    a hot swap can drain it before release."""

    def __init__(self, gen_id: int, model_dir: str, served: ServingModel):
        self.gen_id = gen_id
        self.model_dir = model_dir
        self.served = served
        self._lock = threading.Lock()
        self._inflight = 0  # guarded-by: _lock
        self._idle = threading.Condition(self._lock)

    @property
    def step(self) -> int:
        return int(self.served.signature.get("step", 0))

    def begin(self):
        with self._lock:
            self._inflight += 1

    def end(self):
        with self._lock:
            self._inflight -= 1
            self._idle.notify_all()

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def drain(self, timeout_s: float = 30.0) -> int:
        """Block until in-flight dispatches finish (or timeout); returns
        the count still in flight (0 = fully drained)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._idle.wait(timeout=remaining)
            return self._inflight


class ServingReplica:
    """The device half of one serving replica."""

    def __init__(
        self,
        model_dir: str,
        mesh=None,
        device: DeviceLike = None,
        drain_timeout_s: float = 30.0,
    ):
        self._mesh = resolve_mesh(mesh, "the port's ServingReplica")
        if self._mesh is not None:
            if device is not None and resolve_device(device) != self._mesh.device:
                raise ValueError(f"device {device} is not the mesh's {self._mesh.device}")
            device = self._mesh.device
        self._device = resolve_device(device)
        self._drain_timeout_s = drain_timeout_s
        self._lock = threading.Lock()
        self._next_gen_id = 1  # guarded-by: _lock
        self._generation = self._load_generation(model_dir)  # guarded-by: _lock
        logger.info(
            "Serving replica up: generation %d (step %d) from %s on %s, mesh %r, tables %s",
            self._generation.gen_id, self._generation.step, model_dir,
            self._device, self._mesh, self._generation.served.placements,
        )

    def _load_generation(self, model_dir: str) -> Generation:
        served = load_for_serving(model_dir, device=self._device, mesh=self._mesh)
        with self._lock:
            gen_id = self._next_gen_id
            self._next_gen_id += 1
        return Generation(gen_id, model_dir, served)

    # -- the dispatch path ----------------------------------------------

    def _acquire(self) -> Generation:
        # begin() under the swap lock: a concurrent reload either sees
        # this dispatch in flight and drains it, or swapped first.
        with self._lock:
            gen = self._generation
            gen.begin()
            return gen

    @staticmethod
    def _run(gen: Generation, features: Dict[str, np.ndarray]) -> np.ndarray:
        try:
            return gen.served.predict(features)
        finally:
            gen.end()

    def execute(self, features: Dict[str, np.ndarray], n_valid: int) -> np.ndarray:
        """Run the current generation on one (padded) batch — the
        MicroBatcher's execute_fn.  Returns host outputs for every row,
        pad rows included (the batcher slices ``n_valid`` off)."""
        return self._run(self._acquire(), features)

    def warmup(self, features: Dict[str, np.ndarray], buckets: Sequence[int]):
        """Run every padded-bucket shape once before live traffic."""
        for size in buckets:
            self.execute(pad_features(features, size), n_valid=0)

    def shadow_execute(self, features: Dict[str, np.ndarray],
                       generation: Optional[Generation] = None) -> np.ndarray:
        """Run an EXPLICIT generation (default: the current one) without
        touching the serving pointer."""
        if generation is None:
            return self._run(self._acquire(), features)
        generation.begin()
        return self._run(generation, features)

    # -- hot swap --------------------------------------------------------

    def reload(self, model_dir: str) -> Generation:
        """Atomic generation swap: build the new generation fully, swap
        the pointer, then drain the old generation's in-flight
        dispatches.  A failed build never touches the pointer: the old
        generation keeps serving and the error is re-raised."""
        try:
            new_gen = self._load_generation(model_dir)
        except Exception:
            old_gen = self.generation
            logger.exception(
                "Reload from %s failed; generation %d (step %d) keeps serving",
                model_dir, old_gen.gen_id, old_gen.step,
            )
            raise
        with self._lock:
            old_gen = self._generation
            self._generation = new_gen
        inflight_at_swap = old_gen.inflight()
        leftover = old_gen.drain(self._drain_timeout_s)
        if leftover:
            logger.warning(
                "Generation %d still has %d dispatch(es) in flight after "
                "%.1fs drain", old_gen.gen_id, leftover, self._drain_timeout_s,
            )
        logger.info(
            "Hot-swapped generation %d (step %d) -> %d (step %d); drained %d "
            "in-flight dispatch(es)", old_gen.gen_id, old_gen.step,
            new_gen.gen_id, new_gen.step, inflight_at_swap,
        )
        return new_gen

    # -- readouts --------------------------------------------------------

    @property
    def device(self):
        return self._device

    @property
    def mesh(self):
        return self._mesh

    @property
    def generation(self) -> Generation:
        """The currently-serving generation."""
        with self._lock:
            return self._generation

    def stats(self) -> dict:
        """Bounded host-side snapshot of the replica."""
        gen = self.generation
        return {
            "generation": gen.gen_id,
            "step": gen.step,
            "model_dir": gen.model_dir,
            "inflight": gen.inflight(),
            "device": str(self._device),
            "mesh": repr(self._mesh),
            "tables": dict(gen.served.placements),
        }
