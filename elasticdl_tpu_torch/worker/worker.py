"""The Local strategy's worker: the port of ``elasticdl_tpu/worker/worker.py``
(``Worker`` :31-354), the task loop around the single-device ``Trainer``.

- ``run`` pulls tasks from the master until it answers "done" (task id
  -1), sleeps while it answers WAIT, and reports each task's result; a
  failed task is reported with its error, and ``max_consecutive_task_
  failures`` failures in a row abort the worker.  It reports its model
  version every ``report_version_every_steps`` steps, after each task
  and at the end.
- TRAINING tasks train a step per minibatch; EVALUATION tasks run
  ``eval_step`` and report the outputs and labels to the master under
  the task's model version, ``EVAL_REPORT_BATCHES`` batches a chunk;
  PREDICTION tasks run the forward and report nothing; a
  TRAIN_END_CALLBACK task runs the zoo's ``callbacks``.
- A task's batches come by one of two routes, as in the collective
  worker (``worker/collective_worker.py``).  The columnar route when the
  task's reader has ``read_columns`` (the ETRF readers) and the zoo a
  ``columnar_dataset_fn``: the task is read and parsed as whole columns,
  transformed at once (ResNet-50's crop and shuffle) and each batch is a
  row-range view.  Otherwise the per-record route through
  ``data/task_data_service.py`` and the zoo's ``dataset_fn``.  "Columnar
  task path engaged" is logged the first time a mode takes the columnar
  route.  Batches are not padded: the last of a task may be smaller.
- ``--pipeline async`` (``PipelineConfig``) builds the batches on a
  bounded ``Prefetcher`` thread while the step loop trains.

The worker journals ``worker_task_done`` after each task (``obs``): its
steps, seconds, the seconds the step loop waited for host data
(``data_wait_s``), the columnar route's seconds (``columnar_s``: read,
parse and transform; ``columnar_transform_s``: the zoo's transform),
the seconds spent moving batches to the device (``stage_s``) and the
batches' image shape.

A WAIT answer parks this process's goodput ledger in ``idle``
(``obs/goodput.py``).  With a ``StepAnatomy`` (``anatomy``,
``obs/stepstats.py``) a training task's host time is booked as data
wait, stage, execute (a step that built the kernel library: compile) and
bookkeep, one window per task, and the cumulative anatomy is journaled
as ``step_anatomy`` after each training task: the Local worker has no
heartbeat to carry it.  The JAX worker's step profiler and quality hooks
are accepted (``profiler``) and select nothing: ``common.args.OBS_ITEM``.
"""

from __future__ import annotations

import contextlib
import time
import traceback
from typing import Optional

import numpy as np

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.common.constants import Mode, TaskExecCounterKey
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_utils import ModelSpec
from elasticdl_tpu_torch.data.columnar import materialize_for_worker
from elasticdl_tpu_torch.data.pipeline import PipelineConfig, Prefetcher
from elasticdl_tpu_torch.data.task_data_service import TaskDataService
from elasticdl_tpu_torch.obs import goodput, stepstats
from elasticdl_tpu_torch.worker.collective_worker import EvalReports, named_arrays
from elasticdl_tpu_torch.worker.trainer import Trainer

logger = get_logger("worker.worker")


class Worker:
    #: An evaluation task's outputs go to the master this many batches a chunk.
    EVAL_REPORT_BATCHES = 32

    def __init__(
        self,
        master_client,
        model_spec: ModelSpec,
        data_reader,
        minibatch_size: int,
        trainer: Optional[Trainer] = None,
        report_version_every_steps: int = 20,
        wait_sleep_s: float = 0.5,
        max_consecutive_task_failures: int = 10,
        validation_data_reader=None,
        prediction_data_reader=None,
        profiler=None,
        anatomy=None,
        pipeline: Optional[PipelineConfig] = None,
        device=None,
    ):
        self._mc = master_client
        self._spec = model_spec
        self._minibatch_size = minibatch_size
        train_service = TaskDataService(data_reader, model_spec.dataset_fn)
        # Evaluation and prediction tasks read their own data when given.
        self._services = {
            Mode.TRAINING: train_service,
            Mode.EVALUATION: (TaskDataService(validation_data_reader, model_spec.dataset_fn)
                              if validation_data_reader is not None else train_service),
            Mode.PREDICTION: (TaskDataService(prediction_data_reader, model_spec.dataset_fn)
                              if prediction_data_reader is not None else train_service),
        }
        self._trainer = trainer or Trainer(
            model=model_spec.build_model(device=device),
            loss_fn=model_spec.loss,
            optimizer=model_spec.optimizer(),
            device=device,
        )
        self._report_every = report_version_every_steps
        self._wait_sleep_s = wait_sleep_s
        self._max_consecutive_failures = max_consecutive_task_failures
        self._last_reported_version = 0
        self._pipeline = pipeline or PipelineConfig()
        self._columnar_logged: set = set()
        self._task_stats: dict = {}
        self._anatomy = anatomy
        if anatomy is not None:
            anatomy.watch_builds(lambda: self._trainer.kernel_builds)
        #: Train steps and evaluation/prediction batches this worker ran.
        self.process_steps = 0
        self.process_eval_batches = 0

    @property
    def trainer(self) -> Trainer:
        return self._trainer

    def _anat_phase(self, name: str):
        if self._anatomy is None:
            return contextlib.nullcontext()
        return self._anatomy.phase(name)

    # -- the task loop ---------------------------------------------------------

    def run(self):
        """Pull tasks until the master says the job is done."""
        consecutive_failures = 0
        while True:
            task = self._mc.get_task()
            if task.task_id == -1 and task.type != msg.WAIT:
                logger.info("Job complete; worker %d exiting", self._mc.worker_id)
                break
            if task.type == msg.WAIT:
                goodput.ledger().transition("idle", cause="wait_task")
                time.sleep(self._wait_sleep_s)
                continue
            spec = faults.fire("worker.task")
            if spec is not None and spec.kind == "crash":
                faults.crash_now(spec)
            start = time.monotonic()
            try:
                counters = self._process_task(task)
            except Exception as exc:
                logger.error("Task %d failed:\n%s", task.task_id, traceback.format_exc())
                self._mc.report_task_result_best_effort(task.task_id, str(exc) or repr(exc))
                consecutive_failures += 1
                if consecutive_failures >= self._max_consecutive_failures:
                    raise RuntimeError(f"{consecutive_failures} consecutive task failures; "
                                       "worker aborting") from exc
            else:
                self._note_task_done(task, counters, time.monotonic() - start)
                # A lost success report is an RPC fault, not a task failure:
                # the master requeues the task.
                self._mc.report_task_result_best_effort(task.task_id, "", counters)
                consecutive_failures = 0
        self._report_version(force=True)

    def _process_task(self, task) -> dict:
        self._task_stats = {}
        with obs.span("worker.task", labels={"type": msg.task_type_name(task.type)},
                      task_id=task.task_id):
            if task.type == msg.TRAINING:
                return self._process_train_task(task)
            if task.type == msg.EVALUATION:
                return self._process_eval_task(task, Mode.EVALUATION)
            if task.type == msg.PREDICTION:
                return self._process_eval_task(task, Mode.PREDICTION)
            if task.type == msg.TRAIN_END_CALLBACK:
                return self._process_train_end(task)
        raise ValueError(f"Unknown task type {task.type}")

    def _note_task_done(self, task, counters: dict, seconds: float) -> None:
        batches = counters.get(TaskExecCounterKey.BATCH_COUNT, 0)
        if task.type == msg.TRAINING:
            self.process_steps += batches
        else:
            self.process_eval_batches += batches
        obs.journal().record(
            "worker_task_done", task_id=task.task_id, type=msg.task_type_name(task.type),
            start=task.start, end=task.end, steps=batches, seconds=round(seconds, 6),
            step=self._trainer.step, process_steps=self.process_steps,
            process_eval_batches=self.process_eval_batches, **self._task_stats)

    # -- batches ---------------------------------------------------------------

    def _batches(self, task, mode: str):
        """The task's ``(features, labels)`` minibatches by the columnar
        route when the reader and the zoo both have it, else record by
        record; behind a ``Prefetcher`` with ``--pipeline async``."""
        service = self._services[mode]
        if (getattr(service.reader, "read_columns", None) is not None
                and self._spec.columnar_dataset_fn is not None):
            batches = self._columnar_batches(task, mode, service)
            if self._pipeline.is_async:
                return Prefetcher(batches, max_inflight=self._pipeline.max_inflight)
            return batches
        lookahead = self._pipeline.max_inflight if self._pipeline.is_async else 0
        return service.get_batches(task, mode, self._minibatch_size, lookahead=lookahead)

    def _columnar_batches(self, task, mode: str, service):
        columnar = materialize_for_worker(service.reader, task, self._spec.columnar_dataset_fn,
                                          mode, service.reader.metadata, self._task_stats,
                                          self._columnar_logged)
        if columnar is None:  # an empty task
            return
        self._task_stats["batch_shape"] = (list(columnar.features.shape[1:])
                                           if isinstance(columnar.features, np.ndarray) else None)
        for lo in range(0, columnar.n, self._minibatch_size):
            yield columnar.slice(lo, min(lo + self._minibatch_size, columnar.n))

    def _timed_batches(self, batches, anatomy=None):
        """Yield the batches, booking the time the loop waited for each
        (on ``anatomy`` too, as ``data_wait``, with a prefetcher's hidden
        time as its overlap)."""
        wait = 0.0
        try:
            while True:
                t0 = time.monotonic()
                with (anatomy.phase("data_wait") if anatomy is not None
                      else contextlib.nullcontext()):
                    batch = next(batches, None)
                wait += time.monotonic() - t0
                if batch is None:
                    return
                yield batch
        finally:
            self._task_stats["data_wait_s"] = round(wait, 6)
            if isinstance(batches, Prefetcher):
                if anatomy is not None:
                    anatomy.note_overlap_seconds(batches.overlap_s)
                # Task boundary: no stale batch survives into the next task.
                batches.close()

    # -- task kinds ------------------------------------------------------------

    def _process_train_task(self, task) -> dict:
        batch_count = record_count = 0
        stage_s = 0.0
        last_loss = None
        batches = iter(self._batches(task, Mode.TRAINING))
        for features, labels in self._timed_batches(batches, self._anatomy):
            spec = faults.fire("worker.step")
            if spec is not None and spec.kind == "crash":
                faults.crash_now(spec)
            t0 = time.monotonic()
            with self._anat_phase("stage"):
                staged = self._trainer.stage_batch(features, labels)
            stage_s += time.monotonic() - t0
            if self._anatomy is not None:
                with self._anatomy.dispatch(1, len(labels)):
                    last_loss = self._trainer.train_step_staged(staged)
            else:
                last_loss = self._trainer.train_step_staged(staged)
            batch_count += 1
            record_count += len(labels)
            with self._anat_phase("bookkeep"):
                if self._trainer.step % self._report_every == 0:
                    self._report_version()
        self._task_stats["stage_s"] = round(stage_s, 6)
        if self._anatomy is not None:
            # One window per task; no heartbeat carries it here, so the
            # cumulative anatomy goes to this process's journal.
            self._anatomy.close_window()
            stepstats.journal_anatomy(self._anatomy.worker_id, self._anatomy.snapshot())
        if last_loss is not None:
            logger.info("task %d done: step=%d loss=%.5f (%d batches)", task.task_id,
                        self._trainer.step, float(last_loss), batch_count)
        self._report_version()
        return {TaskExecCounterKey.BATCH_COUNT: batch_count,
                TaskExecCounterKey.RECORD_COUNT: record_count}

    def _process_eval_task(self, task, mode: str) -> dict:
        reports = EvalReports(self._mc, task, self.EVAL_REPORT_BATCHES)
        batch_count = 0
        for batch in self._timed_batches(iter(self._batches(task, mode))):
            features, labels = batch if isinstance(batch, tuple) else (batch, None)
            outputs = self._trainer.eval_step(features)
            batch_count += 1
            if mode != Mode.EVALUATION:
                continue
            reports.add(named_arrays(outputs, "output"), named_arrays(labels, ""))
        reports.flush()
        return {TaskExecCounterKey.BATCH_COUNT: batch_count}

    def _process_train_end(self, task) -> dict:
        if self._spec.callbacks is not None:
            for callback in self._spec.callbacks() or []:
                callback(self)
        return {}

    def _report_version(self, force: bool = False):
        step = self._trainer.step
        if force or step > self._last_reported_version:
            self._mc.report_version(step)
            self._last_reported_version = step
