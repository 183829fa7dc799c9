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

- **Delta apply.**  ``build_delta_generation(delta_dir)`` builds, and
  ``commit_generation`` serves, the generation a published delta
  (``checkpoint/delta.py``) makes of the current one: the delta's
  integrity is checked (a corrupt delta is quarantined and raises) and
  its base step must be the served step; each table is a clone of the
  current one with the changed storage blocks written in
  (``index_copy_`` on the block view; on a process mesh, the blocks of
  this rank's rows), the dense params are the delta's, and the module is
  a copy of the current one that shares nothing with it but the mesh.
  The serving pointer moves only at ``commit_generation(new_gen,
  model_dir)``, through the swap ``reload`` uses; on failure the old
  generation keeps serving and the error is re-raised.  ``apply_delta``
  is both in one call.  ``serving.delta_apply`` is a fault site at the
  start of every build (an ``error`` fault fails it).
- **Journal.**  Every swap is a ``model_swap`` event (``kind`` full or
  delta, ``outcome`` applied or rolled_back, the new and the old
  generation and step), the JAX package's record; each generation keeps
  its event-time frontier (``event_time``: the full's signature, the
  delta manifest's), which ``stats()`` reports as ``model_event_time``.

Not ported yet (ROADMAP): several real cards driven from one process.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.device import DeviceLike, resolve_device
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.pipeline import pad_features
from elasticdl_tpu_torch.parallel.mesh import resolve_mesh
from elasticdl_tpu_torch.parallel.sharding import axis_rows
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.serving.export import ServingModel, load_for_serving

logger = get_logger("serving.runtime")


class Generation:
    """One loaded model generation, its event-time frontier (what the
    freshness tracker reads), plus an in-flight dispatch count, so a hot
    swap can drain it before release."""

    def __init__(self, gen_id: int, model_dir: str, served: ServingModel,
                 event_time: float = 0.0):
        self.gen_id = gen_id
        self.model_dir = model_dir
        self.served = served
        self.event_time = float(event_time)
        self._lock = make_lock("Generation._lock")
        self._inflight = 0  # guarded-by: _lock
        self._idle = threading.Condition(self._lock)

    @property
    def step(self) -> int:
        return int(self.served.signature.get("step", 0))

    def begin(self):
        with self._lock:
            self._inflight += 1

    def end(self):
        with self._lock:  # noqa-invariant: trace-purity (the in-flight count a hot swap drains on: taken once per dispatch after its outputs are on the host)
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
        model_zoo: str = "",
    ):
        # A user's model_def is imported from here (the artifact's
        # recorded zoo when empty), as JAX's ServingReplica does (:163).
        self._model_zoo = model_zoo
        self._mesh = resolve_mesh(mesh, "the port's ServingReplica")
        if self._mesh is not None:
            if device is not None and resolve_device(device) != self._mesh.device:
                raise ValueError(f"device {device} is not the mesh's {self._mesh.device}")
            device = self._mesh.device
        self._device = resolve_device(device)
        self._drain_timeout_s = drain_timeout_s
        self._lock = make_lock("ServingReplica._lock")
        self._next_gen_id = 1  # guarded-by: _lock
        self._executes = 0  # guarded-by: _lock
        self._generation = self._load_generation(model_dir)  # guarded-by: _lock
        logger.info(
            "Serving replica up: generation %d (step %d) from %s on %s, mesh %r, tables %s",
            self._generation.gen_id, self._generation.step, model_dir,
            self._device, self._mesh, self._generation.served.placements,
        )

    def _load_generation(self, model_dir: str) -> Generation:
        served = load_for_serving(model_dir, device=self._device, mesh=self._mesh,
                                  model_zoo=self._model_zoo)
        with self._lock:
            gen_id = self._next_gen_id
            self._next_gen_id += 1
        return Generation(gen_id, model_dir, served,
                          event_time=float(served.signature.get("event_time", 0.0)))

    # -- the dispatch path ----------------------------------------------

    def _acquire(self, count: bool = False) -> Generation:
        # begin() under the swap lock: a concurrent reload either sees
        # this dispatch in flight and drains it, or swapped first.
        with self._lock:
            self._executes += count
            gen = self._generation
            gen.begin()
            return gen

    @staticmethod
    def _run(gen: Generation, features: Dict[str, np.ndarray]) -> np.ndarray:  # hot-path
        served: ServingModel = gen.served
        try:
            return served.predict(features)
        finally:
            gen.end()

    def execute(self, features: Dict[str, np.ndarray], n_valid: int) -> np.ndarray:
        """Run the current generation on one (padded) batch — the
        MicroBatcher's execute_fn.  Returns host outputs for every row,
        pad rows included (the batcher slices ``n_valid`` off)."""
        return self._run(self._acquire(count=True), features)

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
        generation keeps serving, the rollback is journaled as a
        ``model_swap`` with ``outcome=rolled_back`` and the error is
        re-raised."""
        try:
            new_gen = self._load_generation(model_dir)
        except Exception as exc:
            old_gen = self.generation
            self._journal_rollback("full", old_gen, model_dir, exc)
            logger.exception(
                "Reload from %s failed; generation %d (step %d) keeps serving",
                model_dir, old_gen.gen_id, old_gen.step,
            )
            raise
        return self._swap(new_gen, model_dir, "full")

    @staticmethod
    def _journal_rollback(kind: str, old_gen: Generation, model_dir: str, exc: Exception):
        obs.journal().record(
            "model_swap", kind=kind, outcome="rolled_back",
            generation=old_gen.gen_id, step=old_gen.step,
            old_generation=old_gen.gen_id, old_step=old_gen.step,
            model_dir=model_dir, reason=repr(exc),
        )

    def _swap(self, new_gen: Generation, model_dir: str, kind: str) -> Generation:
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
            "Hot-swapped (%s) generation %d (step %d) -> %d (step %d); drained %d "
            "in-flight dispatch(es)", kind, old_gen.gen_id, old_gen.step,
            new_gen.gen_id, new_gen.step, inflight_at_swap,
        )
        obs.journal().record(
            "model_swap", kind=kind, outcome="applied",
            generation=new_gen.gen_id, step=new_gen.step,
            old_generation=old_gen.gen_id, old_step=old_gen.step,
            model_dir=model_dir, drained_inflight=inflight_at_swap,
            undrained=leftover, event_time=new_gen.event_time,
        )
        return new_gen

    # -- delta apply -----------------------------------------------------

    def build_delta_generation(self, delta_dir: str) -> Generation:
        """Build (but do not serve) the generation ``delta_dir`` makes of
        the current one; ``commit_generation`` serves it.  An injected
        ``serving.delta_apply`` fault, an integrity failure (the delta is
        quarantined), a chain gap (the delta's base step is not the
        served step) or any other error leaves the old generation
        serving, journals a ``model_swap`` with ``outcome=rolled_back``
        and re-raises."""
        from elasticdl_tpu_torch.checkpoint import delta as deltas
        from elasticdl_tpu_torch.checkpoint.saver import verify_integrity

        old_gen = self.generation
        try:
            spec = faults.fire("serving.delta_apply")
            if spec is not None and spec.kind == "error":
                raise RuntimeError(f"FAULT INJECTION: delta apply failed ({spec.arg or 'error'})")
            reason = verify_integrity(delta_dir)
            if reason is not None:
                deltas.quarantine_artifact(delta_dir, reason)
                raise ValueError(f"corrupt delta {delta_dir}: {reason}")
            loaded = deltas.load_delta(delta_dir)
            manifest = loaded["manifest"]
            if int(manifest["base_step"]) != old_gen.step:
                raise ValueError(
                    f"delta {delta_dir} chains from step {manifest['base_step']} but "
                    f"generation {old_gen.gen_id} serves step {old_gen.step}"
                )
            served = self._patched(old_gen.served, loaded)
            event_time = float(manifest.get("event_time", 0.0))
            served.signature["step"] = int(manifest["step"])
            served.signature["event_time"] = event_time
            with self._lock:
                if self._generation is not old_gen:
                    raise RuntimeError("generation changed under delta apply; re-resolve the "
                                       "chain")
                gen_id = self._next_gen_id
                self._next_gen_id += 1
        except Exception as exc:
            self._journal_rollback("delta", old_gen, delta_dir, exc)
            logger.exception("Delta apply from %s failed; generation %d (step %d) keeps "
                             "serving", delta_dir, old_gen.gen_id, old_gen.step)
            raise
        return Generation(gen_id, delta_dir, served, event_time=event_time)

    @torch.no_grad()
    def _patched(self, old: ServingModel, loaded: dict) -> ServingModel:
        """A copy of ``old`` with the delta's blocks written into clones of
        its tables and the delta's dense params."""
        modules = {key[len("params/"):]: module
                   for key, _, kind, module in convert._targets(old.model) if kind == "table"}
        if set(loaded["tables"]) != set(modules):
            raise ValueError(f"delta patches tables {sorted(loaded['tables'])}, the generation "
                             f"serves {sorted(modules)}")
        memo = {}
        for key, (rows, vals, meta) in loaded["tables"].items():
            spec = modules[key].spec
            if list(meta["packed_shape"]) != list(spec.packed_shape):
                raise ValueError(f"delta table {key} is {meta['packed_shape']}, the "
                                 f"generation's {list(spec.packed_shape)}")
            base = modules[key].embedding
            local = axis_rows(spec.vocab_padded, old.mesh, old.placements.get(key))
            lo, hi = local.start // spec.rows_per_block, local.stop // spec.rows_per_block
            mine = (rows >= lo) & (rows < hi)
            table = base.clone()
            table.view(hi - lo, spec.block_width).index_copy_(
                0, torch.from_numpy(rows[mine] - lo).to(table.device),
                torch.from_numpy(np.ascontiguousarray(vals[mine])).to(table.device))
            memo[id(base)] = table
        for module in old.model.modules():  # the copy shares the mesh
            if getattr(module, "mesh", None) is not None:
                memo[id(module.mesh)] = module.mesh
        model = copy.deepcopy(old.model, memo)
        targets = model.state_dict(keep_vars=True)
        for key, value in convert._dense_from_jax(loaded["dense"]["params"], model).items():
            if tuple(value.shape) != tuple(targets[key].shape):
                raise ValueError(f"delta param {key} is {tuple(value.shape)}, the "
                                 f"generation's {tuple(targets[key].shape)}")
            targets[key].data.copy_(torch.from_numpy(np.array(value, np.float32)))
        return ServingModel(model, dict(old.signature), old.device, old.mesh,
                            dict(old.placements))

    def commit_generation(self, new_gen: Generation, model_dir: str) -> Generation:
        """Serve a generation from ``build_delta_generation``: the swap
        and drain of ``reload`` (journaled ``model_swap`` kind="delta"
        outcome="applied", naming ``model_dir``)."""
        return self._swap(new_gen, model_dir, "delta")

    def apply_delta(self, delta_dir: str) -> Generation:
        """``build_delta_generation`` then ``commit_generation``."""
        return self.commit_generation(self.build_delta_generation(delta_dir), delta_dir)

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
        with self._lock:
            gen, executes = self._generation, self._executes
        return {
            "generation": gen.gen_id,
            "step": gen.step,
            "model_dir": gen.model_dir,
            "inflight": gen.inflight(),
            "device": str(self._device),
            "mesh": repr(self._mesh),
            "tables": dict(gen.served.placements),
            # Event-time frontier of the served model: the freshness
            # tracker's serving-side input (0.0 for pre-delta artifacts).
            "model_event_time": gen.event_time,
            # Dispatches through execute (warm-up included, shadow runs
            # not): what a launch count per dispatch divides by.
            "executes": executes,
        }
