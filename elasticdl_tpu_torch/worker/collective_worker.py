"""The cluster-mode worker's lockstep task loop: the port's copy of
``elasticdl_tpu/worker/collective_worker.py`` (``_run_task_loop`` :272,
``_local_batches`` :391, the window logic :461-520,
``_process_train_task`` :522, ``_process_eval_task`` :745,
``_process_train_end`` :798, ``_maybe_checkpoint`` :821).

- Rank 0 pulls tasks from the master and broadcasts them; every rank
  runs the same steps per task.
- Each global minibatch is the ranks' contiguous per-rank slices in rank
  order (``parallel/elastic.iter_local_batch_ranges``), every slice
  padded to ``minibatch_size`` rows and masked.  The port's trainers take
  the global batch and keep the rows of their data index
  (``stage_batch``), so on a world of W every rank parses the W slices;
  on one card (the world the card's machine has) that is its own.
- Batches are staged in dispatch windows: AUTO (0) is up to 400 steps,
  bounded by the task's batch count and a 1 GiB staged-bytes cap, and a
  multiple of the windowed sparse apply's interval; the window ratchets
  upward across tasks.
- On any worker's death the world dies and the pod manager re-launches
  it; this process restores the latest checkpoint at boot (the PS
  trainer's sharded one through ``set_sharded_restore``), checks every
  rank picked the same step, and the master's queue replays what was in
  flight (at-least-once).  A failed task is reported and the process
  exits, so the world re-forms.
- A task's batches come by one of two routes.  The columnar route
  (``data/columnar.py``), when the task's reader has ``read_columns``
  (the ETRF readers) and the zoo a ``columnar_dataset_fn``: the task is
  read and parsed as whole columns (on the ``ParsePool``'s threads with
  ``--parse_pool_workers``), shuffled by one permutation, and each
  batch is row-range views of it.  Otherwise the per-record route (the
  ``synthetic://`` readers): the zoo's ``dataset_fn`` record by record,
  each batch stacked.  "Columnar task path engaged" is logged the first
  time a mode takes the columnar route.
- ``--pipeline async`` builds batches off the step loop: a ``Prefetcher``
  thread runs the route (the per-record route stacks on the
  ``ParsePool``), and the trained variables are those of sync.
- EVALUATION tasks run ``eval_step_local`` on every batch and report the
  real rows' outputs and labels to the master in chunks of
  ``EVAL_REPORT_BATCHES`` batches (``per_rank_real_counts`` strips the
  padding); PREDICTION tasks run the forward and report nothing.

The elastic control plane (``obs/``): the step anatomy books each
flush's host time as data wait, stage, compile (the first
``ensure_initialized``, or a dispatch that built the kernel library),
execute and bookkeep, one window per flush, with the prefetcher's and the
staging pipeline's hidden time as overlap, and journals the cumulative
anatomy (``step_anatomy``) after each flush; the telemetry records each
flush's steps and records for the heartbeat; this process's goodput
ledger books the task loop's ``training`` and ``idle`` (WAIT), the
restore at boot and each save.

The worker journals (``obs``) ``checkpoint_restore``, ``first_step``,
``checkpoint_saved`` (both on the DP path with the state's CRC32s,
``state_digest``, on every rank) and, after every task,
``worker_task_done`` with the steps this process trained, its kernel
launches and any forbidden module loaded, so a process that is killed
leaves its counts behind, and the seconds the step loop waited for host
data (``data_wait_s``; with async staging also the staging and prefetch
seconds hidden behind the card's work), the columnar route's seconds
(``columnar_s``: read, parse and transform; ``columnar_transform_s``: the
zoo's transform) and the tasks this process read record by record
through an ETRF reader (``etrf_per_record_reads``, 0 on the columnar
route).
"""

from __future__ import annotations

import contextlib
import time
import traceback
import zlib
from typing import List, Optional

import numpy as np
import torch

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.common.boundary import forbidden_modules_loaded
from elasticdl_tpu_torch.common.constants import Mode, TaskExecCounterKey
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_utils import ModelSpec
from elasticdl_tpu_torch.data.columnar import materialize_for_worker
from elasticdl_tpu_torch.data.dataset import Dataset, SequentialRecords, _stack
from elasticdl_tpu_torch.data.pipeline import (
    ParsePool,
    PipelineConfig,
    Prefetcher,
    StagingPipeline,
)
from elasticdl_tpu_torch.data.reader import etrf_per_record_reads
from elasticdl_tpu_torch.obs import goodput, stepstats
from elasticdl_tpu_torch.parallel import elastic
from elasticdl_tpu_torch.parallel.elastic import WorldInfo
from elasticdl_tpu_torch.parallel.sharding import pad_batch

logger = get_logger("worker.collective_worker")


def kernel_launches() -> dict:
    """The process's hand-written kernel launches, by wrapper name."""
    from elasticdl_tpu_torch.ops import flash_attention, sparse_embedding

    counts = dict(sparse_embedding.launch_counts())
    counts.update(flash_attention.launch_counts())
    return {k: v for k, v in counts.items() if v}


def _crc32_tree(node, crc: int = 0) -> int:
    """CRC32 over a tree's leaves in order: mappings by sorted key,
    sequences (the optimizer's named tuples) by position."""
    if isinstance(node, dict):
        for key in sorted(node):
            crc = _crc32_tree(node[key], zlib.crc32(str(key).encode(), crc))
        return crc
    if isinstance(node, (tuple, list)):
        for child in node:
            crc = _crc32_tree(child, crc)
        return crc
    if node is None:
        return zlib.crc32(b"None", crc)
    return zlib.crc32(np.ascontiguousarray(np.asarray(node)).tobytes(), crc)


def state_digest(host_state) -> dict:
    """CRC32s of a JAX-layout host state: ``state_crc32`` over its params,
    optimizer state and ``model_state`` (ResNet's ``batch_stats``), and
    ``model_state_crc32`` over the last alone (absent without one).  The
    DP path journals them at each save and restore, so a journal shows
    that a restore landed the saved state bit for bit and that the ranks
    of a world hold the same one."""
    digest = {"state_crc32": _crc32_tree([host_state.params, host_state.opt_state,
                                          host_state.model_state])}
    if host_state.model_state:
        digest["model_state_crc32"] = _crc32_tree(host_state.model_state)
    return digest


def _concat(parts):
    """Per-rank blocks -> one global batch (dicts and arrays alike)."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], dict):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts)


def named_arrays(tree, default_name: str = "output") -> dict:
    """JAX ``worker/worker.py:324``: a model-output or label tree as
    ``{name: np.ndarray}``; dict keys kept (nested ones joined with '/'),
    a bare array under ``default_name``."""
    if isinstance(tree, dict):
        flat = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                for sub, arr in named_arrays(value, default_name).items():
                    flat[f"{key}/{sub}"] = arr
            else:
                flat[str(key)] = np.asarray(value)
        return flat
    return {default_name: np.asarray(tree)}


def concat_named(batches: list) -> dict:
    """JAX ``worker/worker.py:343``: ``{name: array}`` dicts joined along
    axis 0."""
    names = batches[0].keys()
    return {name: np.concatenate([b[name] for b in batches]) for name in names}



class EvalReports:
    """An evaluation task's ``{name: array}`` outputs and labels, sent to
    the master ``every`` batches a chunk under the task's model version,
    so the master joins all of a round's tasks whatever step the worker
    is at (it joins a task's chunks when the task is done)."""

    def __init__(self, master_client, task, every: int):
        self._mc, self._task, self._every = master_client, task, every
        self._outputs: list = []
        self._labels: list = []

    def add(self, outputs: dict, labels: dict) -> None:
        self._outputs.append(outputs)
        self._labels.append(labels)
        if len(self._outputs) >= self._every:
            self.flush()

    def flush(self) -> None:
        if not self._outputs:
            return
        self._mc.report_evaluation_metrics(
            model_version=self._task.model_version, model_outputs=concat_named(self._outputs),
            labels=concat_named(self._labels), task_id=self._task.task_id)
        self._outputs.clear()
        self._labels.clear()


class CollectiveWorker:
    #: AUTO window bounds (``--train_window_steps=0``), the JAX package's.
    AUTO_WINDOW_STEPS = 400
    AUTO_WINDOW_BYTES = 1 << 30
    #: The leader reports its model version at least this often (steps).
    REPORT_VERSION_EVERY_STEPS = 20
    #: Seconds between polls while the master answers WAIT.
    WAIT_SLEEP_S = 0.5
    #: The leader reports an evaluation task's outputs every this many
    #: batches (the master joins the chunks at the round's end).
    EVAL_REPORT_BATCHES = 32

    def __init__(
        self,
        master_client,
        model_spec: ModelSpec,
        data_reader,
        minibatch_size: int,
        world: WorldInfo,
        trainer,
        checkpoint_saver=None,
        checkpoint_steps: int = 0,
        train_window_steps: int = 0,
        pipeline: Optional[PipelineConfig] = None,
        validation_data_reader=None,
        prediction_data_reader=None,
        telemetry=None,
        anatomy=None,
    ):
        self._mc = master_client
        self._spec = model_spec
        # The heartbeat's telemetry collector and the step anatomy (by
        # default the one bound to the collector); None turns either off.
        self._telemetry = telemetry
        self._anatomy = anatomy or getattr(telemetry, "anatomy", None)
        if self._anatomy is not None and hasattr(trainer, "kernel_builds"):
            self._anatomy.watch_builds(lambda: trainer.kernel_builds)
        self._mb = minibatch_size
        self._world = world
        self._trainer = trainer
        self._ckpt = checkpoint_saver
        self._ckpt_steps = checkpoint_steps
        self._last_reported_version = 0
        self._last_ckpt_step = 0
        self._window_steps = int(train_window_steps)
        self._pipeline = pipeline or PipelineConfig()
        self._parse_pool = (ParsePool(self._pipeline.parse_workers)
                            if self._pipeline.is_async and self._pipeline.parse_workers > 0
                            else None)
        self._batch_nbytes: Optional[int] = None
        self._apply_short_warned = False
        # The windowed sparse apply chunks within one dispatch window, so
        # an explicit window grows to a multiple of its interval; 'auto'
        # resolves at the trainer's init (_sync_apply_every).
        self._apply_every = self._trainer_apply_every()
        self._grow_explicit_window_to_apply_multiple()
        self._effective_window: Optional[int] = None
        self._readers = {
            msg.TRAINING: data_reader,
            msg.TRAIN_END_CALLBACK: data_reader,
            msg.EVALUATION: validation_data_reader or data_reader,
            msg.PREDICTION: prediction_data_reader or data_reader,
        }
        # The broadcast's shard index: every reader's names, the same on
        # every rank (shard_names, not create_shards: no counting).
        names: List[str] = []
        for reader in (data_reader, validation_data_reader, prediction_data_reader):
            for name in reader.shard_names() if reader is not None else ():
                if name not in names:
                    names.append(name)
        self._shard_names = names
        self._metadata = data_reader.metadata
        self._columnar_logged: set = set()  # modes that took the columnar route
        self._started = time.monotonic()
        self._host_seconds: dict = {}  # the last task's host-side seconds
        #: Train steps, and evaluation and prediction batches, this
        #: process ran (all its tasks).
        self.process_steps = 0
        self.process_eval_batches = 0

    @property
    def trainer(self):
        return self._trainer

    def _trainer_apply_every(self) -> int:
        return int(getattr(self._trainer, "sparse_apply_every", 1) or 1)

    # -- restore -------------------------------------------------------------

    @property
    def _sharded_ckpt(self) -> bool:
        """The sharded protocol when both sides speak it: every rank reads
        and writes its own rows (the PS tables)."""
        return hasattr(self._trainer, "save_checkpoint") and hasattr(self._ckpt, "latest_step")

    def restore_from_checkpoint(self):
        if self._ckpt is None:
            return
        # This process's ledger: after a re-formation the restore is part
        # of what the rescale costs.
        with goodput.ledger().phase("checkpoint_restore", cause="boot"):
            self._restore_from_checkpoint_inner()

    def _restore_from_checkpoint_inner(self):
        start = time.monotonic()
        if self._sharded_ckpt:
            step = self._ckpt.latest_step()
            if step is None:
                return
            self._trainer.set_sharded_restore(self._ckpt, step)
        else:
            from elasticdl_tpu_torch.serving import convert

            state, step = self._ckpt.load_latest()
            if state is None:
                return
            self._trainer.state = convert.dp_trainer_state_from_jax(state, self._trainer.model)
        # Seeds the save cadence: no spurious checkpoint right after restore.
        self._last_ckpt_step = step
        # The restore itself lands at the trainer's first ensure_initialized.
        self._trainer.ensure_initialized()
        seconds = time.monotonic() - start
        logger.info("Rank %d restored checkpoint at step %d in %.3f s", self._world.rank, step,
                    seconds)
        digest = {} if self._sharded_ckpt else state_digest(self._trainer.state_to_jax_host())
        obs.journal().record("checkpoint_restore", rank=self._world.rank, step=step,
                             seconds=round(seconds, 6), **digest)

    def _verify_restore_consistency(self):
        """Every rank must have restored the same step; a divergent rank
        exits so the world re-forms from a consistent snapshot."""
        if self._world.world_size <= 1:
            return
        from elasticdl_tpu_torch.parallel.collective import (
            CollectiveCommunicator,
            CollectiveResult,
        )

        step = int(self._last_ckpt_step)
        status, leader_step = CollectiveCommunicator(self._trainer.mesh).broadcast(
            np.int64(step), root=0)
        if status is not CollectiveResult.SUCCEEDED:
            raise RuntimeError("Restore-consistency broadcast failed; re-forming world")
        if int(leader_step) != step:
            raise RuntimeError(
                f"Rank {self._world.rank} restored checkpoint step {step} but rank 0 "
                f"restored {int(leader_step)}: divergent restores; aborting so the world "
                "re-forms from a consistent snapshot")

    # -- the task loop -------------------------------------------------------

    def run(self):
        heartbeat = elastic.HeartbeatReporter(self._mc, self._world,
                                              telemetry=self._telemetry).start()
        try:
            self._run_task_loop()
        finally:
            heartbeat.stop()
            if self._parse_pool is not None:
                self._parse_pool.close()

    # -- step anatomy (no-op contexts when the plane is off) -------------------

    def _anat_phase(self, name: str):
        if self._anatomy is None:
            return contextlib.nullcontext()
        return self._anatomy.phase(name)

    def _anat_dispatch(self, n_steps: int, n_examples: int):
        if self._anatomy is None:
            return contextlib.nullcontext()
        return self._anatomy.dispatch(n_steps, n_examples)

    def _run_task_loop(self):
        self.restore_from_checkpoint()
        self._verify_restore_consistency()
        while True:
            # The leader's queue wait is data_wait, for a real task only
            # (a WAIT poll is the ledger's idle); the other ranks book
            # theirs inside broadcast_task.
            queue_wait_start = time.monotonic()
            task = self._mc.get_task() if self._world.is_leader else None
            task = elastic.broadcast_task(task, self._shard_names, self._world,
                                          anatomy=self._anatomy)
            if (self._anatomy is not None and self._world.is_leader and task.task_id != -1
                    and task.type != msg.WAIT):
                self._anatomy.note_phase_seconds("data_wait",
                                                 time.monotonic() - queue_wait_start)
            if task.task_id == -1 and task.type != msg.WAIT:
                logger.info("Job complete; rank %d exiting", self._world.rank)
                break
            if task.type == msg.WAIT:
                goodput.ledger().transition("idle", cause="wait_task")
                time.sleep(self.WAIT_SLEEP_S)
                continue
            spec = faults.fire("worker.task")
            if spec is not None and spec.kind == "crash":
                faults.crash_now(spec)
            try:
                type_name = msg.task_type_name(task.type)
            except ValueError:
                type_name = "UNKNOWN"
            goodput.ledger().transition("training", cause="task_start")
            if self._telemetry is not None:
                self._telemetry.begin_task(task.task_id, type_name, task.end - task.start)
            start = time.monotonic()
            try:
                with obs.span("worker.task", labels={"type": type_name},
                              task_id=task.task_id, rank=self._world.rank):
                    counters = self._process_task(task)
            except Exception as exc:
                logger.error("Task %d failed on rank %d:\n%s", task.task_id, self._world.rank,
                             traceback.format_exc())
                if self._world.is_leader:
                    self._mc.report_task_result_best_effort(task.task_id, str(exc) or repr(exc))
                # A failed collective step poisons the world: die, and let
                # the pod manager re-form it.
                raise
            self._note_task_done(task, counters, time.monotonic() - start)
            if self._world.is_leader:
                # The step succeeded on every rank; a lost report is only
                # an RPC fault (the master requeues the task).
                self._mc.report_task_result_best_effort(task.task_id, "", counters)
        self._report_version(force=True)
        self._maybe_checkpoint(force=True)

    def _note_task_done(self, task, counters: dict, seconds: float) -> None:
        batches = counters.get(TaskExecCounterKey.BATCH_COUNT, 0)
        if task.type == msg.TRAINING:
            self.process_steps += batches
            records = counters.get(TaskExecCounterKey.RECORD_COUNT, 0)
        else:
            self.process_eval_batches += batches
            records = task.end - task.start
        obs.journal().record(
            "worker_task_done", task_id=task.task_id, rank=self._world.rank,
            type=msg.task_type_name(task.type), start=task.start, end=task.end,
            steps=batches, records=records, seconds=round(seconds, 6),
            step=self._trainer.step, process_steps=self.process_steps,
            process_eval_batches=self.process_eval_batches,
            kernel_launches=kernel_launches(), etrf_per_record_reads=etrf_per_record_reads(),
            forbidden_modules=forbidden_modules_loaded(), **self._host_seconds,
        )

    def _process_task(self, task) -> dict:
        self._host_seconds = {}
        if task.type == msg.TRAINING:
            return self._process_train_task(task)
        if task.type == msg.EVALUATION:
            return self._process_eval_task(task)
        if task.type == msg.PREDICTION:
            return self._process_eval_task(task, report=False)
        if task.type == msg.TRAIN_END_CALLBACK:
            return self._process_train_end(task)
        raise ValueError(f"Unknown task type {task.type}")

    # -- batches ---------------------------------------------------------------

    def _reader(self, task):
        return self._readers.get(task.type, self._readers[msg.TRAINING])

    def _task_records(self, task, mode: str) -> SequentialRecords:
        """One-pass cursor over the task's parsed records (the same on
        every rank: ``dataset_fn`` is deterministic per task and mode)."""
        reader = self._reader(task)
        dataset = self._spec.dataset_fn(
            Dataset.from_generator(lambda: reader.read_records(task)), mode, self._metadata)
        return SequentialRecords(dataset)

    def _step_ranges(self, task):
        """Per global step, every rank's ``(lo, hi, global_real)`` in rank
        order."""
        ranks = [WorldInfo(r, self._world.world_size, self._world.rendezvous_id,
                           self._world.coordinator_addr)
                 for r in range(self._world.world_size)]
        return zip(*(elastic.iter_local_batch_ranges(task.start, task.end, self._mb, w)
                     for w in ranks))

    def _raw_batches(self, task, mode: str):
        """Yield ``(slices, template, global_real)`` per global step:
        every rank's records of the step in rank order."""
        records = self._task_records(task, mode)
        for parts in self._step_ranges(task):
            slices = [records.slice(lo - task.start, hi - task.start) for lo, hi, _ in parts]
            template = None if all(slices) else records.template()
            yield slices, template, parts[0][2]

    def _global_batch(self, slices, global_real):
        """``(features, labels, mask, global_real)`` of one global step from
        each rank's ``(features, labels, n_real)`` in rank order: each
        padded to ``minibatch_size`` and masked, then concatenated."""
        feats, labels, masks = [], [], []
        for f, lab, n_real in slices:
            f, mask = pad_batch(f, self._mb)
            mask[:n_real] = 1.0
            mask[n_real:] = 0.0
            feats.append(f)
            masks.append(mask)
            labels.append(None if lab is None else pad_batch(lab, self._mb)[0])
        return (_concat(feats), None if labels[0] is None else _concat(labels),
                np.concatenate(masks), global_real)

    def _assemble(self, raw):
        """One global step of the per-record route: each rank's records
        stacked (an empty slice from the first record)."""
        slices, template, global_real = raw
        stacked = []
        for records in slices:
            batch = _stack(records if records else [template])
            f, lab = batch if isinstance(batch, tuple) else (batch, None)
            stacked.append((f, lab, len(records)))
        return self._global_batch(stacked, global_real)

    def _record_batches(self, task, mode: str):
        raw = self._raw_batches(task, mode)
        if self._parse_pool is not None:
            return self._parse_pool.imap(self._assemble, raw)
        return map(self._assemble, raw)

    def _local_batches(self, task, mode: str):
        """``(features, labels, mask, global_real)`` per global step, by
        the columnar route when the reader and the zoo both have the
        columnar surface, else by the per-record route.  Lazy: the work
        runs where the batches are consumed (the prefetch thread)."""
        if (getattr(self._reader(task), "read_columns", None) is not None
                and getattr(self._spec, "columnar_dataset_fn", None) is not None):
            return self._columnar_batches(task, mode)
        return self._record_batches(task, mode)

    def _columnar_batches(self, task, mode: str):
        columnar = materialize_for_worker(self._reader(task), task, self._spec.columnar_dataset_fn,
                                          mode, self._metadata, self._host_seconds,
                                          self._columnar_logged, parse_pool=self._parse_pool)
        if columnar is None:  # an empty task
            yield from self._record_batches(task, mode)
            return
        for parts in self._step_ranges(task):
            slices = []
            for lo, hi, _ in parts:
                lo_off, hi_off = lo - task.start, hi - task.start
                n_real = max(0, min(hi_off, columnar.n) - lo_off)
                # Row-range views; an empty slice shapes from row 0.
                f, lab = columnar.slice(lo_off, hi_off) if n_real else columnar.slice(0, 1)
                slices.append((f, lab, n_real))
            yield self._global_batch(slices, parts[0][2])

    # -- dispatch windows ------------------------------------------------------

    def _grow_explicit_window_to_apply_multiple(self) -> None:
        if self._window_steps and self._apply_every > 1 and self._window_steps % self._apply_every:
            grown = -(-self._window_steps // self._apply_every) * self._apply_every
            logger.warning(
                "Dispatch window %d is not a multiple of sparse_apply_every=%d; growing the "
                "window to %d so every chunk reaches the configured apply interval",
                self._window_steps, self._apply_every, grown)
            self._window_steps = grown

    def _sync_apply_every(self) -> bool:
        """Re-read the trainer's (auto-resolved) apply interval after its
        init; True if it changed."""
        resolved = self._trainer_apply_every()
        if resolved == self._apply_every:
            return False
        self._apply_every = resolved
        self._grow_explicit_window_to_apply_multiple()
        return True

    def _window_candidate(self, task_batches: int) -> int:
        explicit = self._window_steps
        cand = min(explicit or self.AUTO_WINDOW_STEPS, task_batches)
        if not explicit and self._batch_nbytes:
            cand = min(cand, max(1, self.AUTO_WINDOW_BYTES // self._batch_nbytes))
        if self._apply_every > 1:
            if cand > self._apply_every:
                cand -= cand % self._apply_every
            elif cand < self._apply_every and not self._apply_short_warned:
                self._apply_short_warned = True
                logger.warning(
                    "Auto dispatch window %d is below sparse_apply_every=%d (task size or the "
                    "%d MB staged-bytes cap): sparse applies run every %d steps instead",
                    cand, self._apply_every, self.AUTO_WINDOW_BYTES >> 20, cand)
        return max(1, cand)

    def _process_train_task(self, task) -> dict:
        batch_count = 0
        record_count = 0
        data_wait_s = 0.0
        last_loss = None
        pending: list = []
        pending_real = 0
        global_batch = self._mb * self._world.world_size
        task_batches = max(1, -(-(task.end - task.start) // global_batch))
        candidate = self._window_candidate(task_batches)
        if self._effective_window is None or candidate > self._effective_window:
            self._effective_window = candidate
            if self._world.is_leader:
                logger.info("Dispatch window -> %d steps (%s; task of %d records yields %d "
                            "global batches)", candidate,
                            f"--train_window_steps={self._window_steps}"
                            if self._window_steps else "auto",
                            task.end - task.start, task_batches)
        window_steps = self._effective_window
        # Async staging books as overlap while a dispatch is outstanding
        # (the anatomy's credit); sync books the exclusive stage phase.
        staging = (StagingPipeline(self._anatomy, dispatch_depth=self._pipeline.dispatch_depth)
                   if self._pipeline.is_async else None)
        overlap_booked = [0.0]  # the prefetcher's overlap already credited

        def stage_call(fn, *args):
            if staging is not None:
                return staging.stage(fn, *args)
            with self._anat_phase("stage"):
                return fn(*args)

        def flush():
            nonlocal batch_count, record_count, pending, pending_real, last_loss
            if not pending:
                return
            first = self.process_steps == 0 and batch_count == 0
            flush_start = time.monotonic()
            if len(pending) == window_steps:
                window = stage_call(self._trainer.stage_window, pending)
                with self._anat_dispatch(len(pending), pending_real):
                    last_loss = self._trainer.train_window(window)[-1]
                if staging is not None:
                    staging.note_dispatched()
            else:
                for i, staged_batch in enumerate(pending):
                    staged = stage_call(self._trainer.stage_batch, *staged_batch)
                    # The flush's real records are credited once.
                    with self._anat_dispatch(1, pending_real if i == 0 else 0):
                        last_loss = self._trainer.train_step_staged(staged)
                    if staging is not None:
                        staging.note_dispatched()
            with self._anat_phase("bookkeep"):
                if first:
                    loss = float(last_loss)  # waits for the card
                    seconds = time.monotonic() - self._started
                    logger.info("First train steps done at step %d (loss %.5f), %.3f s after "
                                "the worker loop started", self._trainer.step, loss, seconds)
                    obs.journal().record("first_step", rank=self._world.rank,
                                         step=self._trainer.step, steps=len(pending),
                                         seconds_since_start=round(seconds, 6))
                if self._telemetry is not None:
                    # One sample per flush: its mean step time and records.
                    self._telemetry.record_steps(len(pending), time.monotonic() - flush_start,
                                                 records=pending_real)
                batch_count += len(pending)
                record_count += pending_real
                pending, pending_real = [], 0
                self._report_version_if_due()
                self._maybe_checkpoint()
            if self._anatomy is not None:
                if prefetcher is not None and prefetcher.overlap_s > overlap_booked[0]:
                    self._anatomy.note_overlap_seconds(prefetcher.overlap_s - overlap_booked[0])
                    overlap_booked[0] = prefetcher.overlap_s
                if self._anatomy.close_window() is not None:  # one window per flush
                    # The cumulative anatomy to this process's journal too:
                    # the heartbeat's copy reaches the master's journal at
                    # most every journal interval, and a short world may
                    # end before one.
                    stepstats.journal_anatomy(self._anatomy.worker_id,
                                              self._anatomy.snapshot())

        batches = iter(self._local_batches(task, Mode.TRAINING))
        prefetcher = None
        if self._pipeline.is_async:
            prefetcher = Prefetcher(batches, max_inflight=self._pipeline.max_inflight)
            batches = prefetcher
        try:
            while True:
                t_wait = time.monotonic()
                with self._anat_phase("data_wait"):
                    item = next(batches, None)  # the step loop blocked on host data
                data_wait_s += time.monotonic() - t_wait
                if item is None:
                    break
                features, labels, mask, global_real = item
                if self._trainer.state is None:
                    # First touch (model init, a restore landing): compile.
                    with self._anat_phase("compile"):
                        self._trainer.ensure_initialized(features)
                else:
                    self._trainer.ensure_initialized(features)
                if self._batch_nbytes is None:
                    # The window's one-time refinement from the real batch
                    # size and the now-resolved apply interval.
                    apply_changed = self._sync_apply_every()
                    leaves = list(features.values()) if isinstance(features, dict) else [features]
                    self._batch_nbytes = sum(np.asarray(x).nbytes
                                             for x in leaves + [labels, mask] if x is not None)
                    refined = self._window_candidate(task_batches)
                    if refined < window_steps or (apply_changed and refined != window_steps):
                        if self._world.is_leader:
                            logger.info("Dispatch window %d -> %d (staged batch is %.1f MB, "
                                        "%d MB auto cap; sparse_apply_every=%d)", window_steps,
                                        refined, self._batch_nbytes / 2**20,
                                        self.AUTO_WINDOW_BYTES >> 20, self._apply_every)
                        window_steps = refined
                        self._effective_window = refined
                pending.append((features, labels, mask))
                pending_real += global_real
                if len(pending) == window_steps:
                    flush()
            flush()
        finally:
            # Task boundary: drain, so no stale batch crosses a rendezvous.
            if prefetcher is not None:
                prefetcher.close()
            if staging is not None:
                staging.drain()
        if last_loss is not None and self._world.is_leader:
            logger.info("task %d done: step=%d loss=%.5f (%d global batches)", task.task_id,
                        self._trainer.step, float(last_loss), batch_count)
        self._report_version()
        self._host_seconds["data_wait_s"] = round(data_wait_s, 6)
        if staging is not None:
            self._host_seconds.update(stage_s=round(staging.stage_s, 6),
                                      stage_overlap_s=round(staging.overlap_s, 6),
                                      prefetch_overlap_s=round(prefetcher.overlap_s, 6))
        counters = {TaskExecCounterKey.BATCH_COUNT: batch_count,
                    TaskExecCounterKey.RECORD_COUNT: record_count}
        consume_oov = getattr(self._trainer, "consume_oov_count", None)
        if consume_oov is not None:
            oov = consume_oov()
            if oov:
                counters[TaskExecCounterKey.OOV_LOOKUP_COUNT] = oov
        return counters

    def _process_eval_task(self, task, report: bool = True) -> dict:
        """Outputs of every batch; with ``report`` the leader sends the
        real rows' outputs and labels to the master, ``EVAL_REPORT_BATCHES``
        batches a chunk (the master joins a task's chunks when it is
        done)."""
        reports = EvalReports(self._mc, task, self.EVAL_REPORT_BATCHES)
        batch_count = 0
        for features, labels, _mask, global_real in self._local_batches(task, Mode.EVALUATION):
            outputs = self._trainer.eval_step_local(features)  # a collective on a mesh
            batch_count += 1
            if not (report and self._world.is_leader):
                continue
            # Rank r's real rows are a prefix of its padded slice.
            counts = elastic.per_rank_real_counts(global_real, self._mb,
                                                  self._world.world_size)
            keep = np.concatenate([np.arange(r * self._mb, r * self._mb + count)
                                   for r, count in enumerate(counts)]).astype(np.int64)
            reports.add({name: arr[keep] for name, arr in named_arrays(outputs, "output").items()},
                        {name: arr[keep] for name, arr in named_arrays(labels, "").items()})
        reports.flush()
        return {TaskExecCounterKey.BATCH_COUNT: batch_count}

    def _process_train_end(self, task) -> dict:
        self._maybe_checkpoint(force=True)
        if self._world.is_leader and self._spec.callbacks is not None:
            for callback in self._spec.callbacks() or []:
                callback(self)
        return {}

    # -- versions and checkpoints ----------------------------------------------

    def _report_version_if_due(self):
        if self._trainer.step - self._last_reported_version >= self.REPORT_VERSION_EVERY_STEPS:
            self._report_version()

    def _report_version(self, force: bool = False):
        if not self._world.is_leader:
            return
        step = self._trainer.step
        if force or step > self._last_reported_version:
            self._mc.report_version(step)
            self._last_reported_version = step

    def _maybe_checkpoint(self, force: bool = False):
        """Every rank decides alike and joins the save (collective for
        sharded tables); the cadence is a delta, steps jump by windows."""
        if self._ckpt is None or self._trainer.state is None:
            return
        step = self._trainer.step
        due = force or (self._ckpt_steps and step - self._last_ckpt_step >= self._ckpt_steps)
        if not (due and step > 0 and step != self._last_ckpt_step):
            return
        start = time.monotonic()
        digest = {}
        with goodput.ledger().phase("checkpoint_save", cause="cadence"):
            with obs.span("checkpoint.save", rank=self._world.rank, step=step):
                if self._sharded_ckpt:
                    self._trainer.save_checkpoint(self._ckpt, step)
                else:
                    host_state = self._trainer.state_to_jax_host()
                    digest = state_digest(host_state)
                    if self._world.is_leader:
                        self._ckpt.save(host_state, step)
            if self._trainer.device.type == "cuda":
                torch.cuda.synchronize(self._trainer.device)
        seconds = time.monotonic() - start
        logger.info("Checkpoint at step %d saved in %.3f s", step, seconds)
        obs.journal().record("checkpoint_saved", rank=self._world.rank, step=step,
                             seconds=round(seconds, 6), **digest)
        self._last_ckpt_step = step
