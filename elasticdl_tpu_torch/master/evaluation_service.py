"""Master-side evaluation: the port's copy of
``elasticdl_tpu/master/evaluation_service.py`` (``EvaluationService``
:23).  It queues evaluation rounds every ``--evaluation_steps`` model
versions (or at each epoch's end when 0, and always when the training
tasks are done) and computes the zoo's ``eval_metrics_fn`` over the
``(model_outputs, labels)`` the workers report.  A worker reports a task
in chunks; a task's chunks join its round only when the task completes
(a failed attempt's chunks never do), and a round's metrics are computed
once, when all of its tasks are done, after which late reports are
dropped.

Each finalized round is logged as in JAX and journaled as
``evaluation_metrics`` (version, examples, metrics, the round's seconds
from its trigger to its metrics), and written to TensorBoard as
``eval/<name>`` scalars at the round's model version when the job has a
``TensorBoardService`` (``--tensorboard_log_dir``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("master.evaluation_service")


class EvaluationService:
    def __init__(
        self,
        task_manager,
        eval_metrics_fn=None,
        evaluation_steps: int = 0,
        tensorboard_service=None,
    ):
        self._task_manager = task_manager
        self._tensorboard_service = tensorboard_service
        self._eval_metrics_fn = eval_metrics_fn
        self._evaluation_steps = evaluation_steps
        self._lock = make_lock("EvaluationService._lock")
        # model_version -> when its first round was triggered (monotonic).
        self._triggered_at: Dict[int, float] = {}  # guarded-by: _lock
        self._last_eval_version = -1  # guarded-by: _lock
        # Per in-flight round (keyed by model_version), each value a
        # list of (outputs dict, labels) batches:
        self._reported: Dict[int, List] = {}  # guarded-by: _lock
        # Chunked reports STAGE per (model_version, task_id) and promote
        # into the round only when that task COMPLETES: task ids are
        # fresh per attempt, so a failed/timed-out attempt's partial
        # chunks are simply never promoted (no double-counted rows on
        # at-least-once retry).
        self._staged: Dict[tuple, List] = {}  # guarded-by: _lock
        # A round finalizes when all its EVALUATION tasks COMPLETE (task-
        # manager callback) — NOT when a report count is reached: workers
        # flush several chunked metric reports per task (the eval-memory
        # bound, collective_worker.EVAL_REPORT_BATCHES), and each task's
        # chunks all precede its completion report on the worker's
        # synchronous gRPC channel.
        self._expected_tasks: Dict[int, int] = {}  # guarded-by: _lock
        self._completed_tasks: Dict[int, int] = {}  # guarded-by: _lock
        if task_manager is not None and hasattr(
            task_manager, "add_eval_task_done_callback"
        ):
            task_manager.add_eval_task_done_callback(self._on_eval_task_done)
        # Rounds already finalized: late/duplicate reports (possible under
        # at-least-once task retry) are dropped, not resurrected.
        self._finalized_versions: set = set()  # guarded-by: _lock
        self._latest_metrics: Dict[str, float] = {}  # guarded-by: _lock

    # ------------------------------------------------------------------
    # Scheduling
    # ------------------------------------------------------------------

    def add_evaluation_task_if_needed(self, model_version: int):
        """Step-interval scheduling (no-op when evaluation_steps == 0; the
        per-epoch default is wired via TaskManager.add_epoch_done_callback)."""
        if self._evaluation_steps <= 0:
            return
        with self._lock:
            due = model_version >= self._last_eval_version + self._evaluation_steps
            if not due:
                return
            self._last_eval_version = model_version
        self.trigger_evaluation(model_version)

    def trigger_evaluation(self, model_version: int):
        """Queue one evaluation round at `model_version`."""
        count = self._task_manager.create_evaluation_tasks(model_version)
        complete = False
        with self._lock:
            self._triggered_at.setdefault(model_version, time.monotonic())
            if count > 0:
                self._expected_tasks[model_version] = (
                    self._expected_tasks.get(model_version, 0) + count
                )
                # The tasks became dispatchable the moment create returned;
                # a tiny round can have COMPLETED all of them before the
                # expected count above was recorded (each completion saw
                # expected=None).  Re-run the completion check so such a
                # round finalizes now instead of at job-end finalize().
                complete = (
                    model_version not in self._finalized_versions
                    and self._completed_tasks.get(model_version, 0)
                    >= self._expected_tasks[model_version]
                )
        if complete:
            self._finalize_round(model_version)

    # ------------------------------------------------------------------
    # Aggregation
    # ------------------------------------------------------------------

    def report_evaluation_metrics(
        self, model_version, model_outputs_pb, labels_pb, task_id: int = 0
    ):
        outputs = {
            tensor.name or "output": tensor_utils.tensor_to_ndarray(tensor)
            for tensor in model_outputs_pb
        }
        labels = {
            tensor.name: tensor_utils.tensor_to_ndarray(tensor) for tensor in labels_pb
        }
        with self._lock:
            if model_version in self._finalized_versions:
                logger.info(
                    "Dropping duplicate/late eval report for finalized "
                    "round %d (at-least-once task retry)",
                    model_version,
                )
                return
            self._staged.setdefault((model_version, task_id), []).append(
                (outputs, labels)
            )

    def _on_eval_task_done(self, model_version: int, task_id: int):
        """Task-manager callback: an EVALUATION task of this round
        completed (its chunked reports have all arrived — worker RPC
        ordering).  Promote ITS staged chunks (a dead attempt's chunks
        stay behind under their stale task id) and finalize once every
        task of the round is in."""
        with self._lock:
            if model_version in self._finalized_versions:
                return
            chunks = self._staged.pop((model_version, task_id), [])
            self._reported.setdefault(model_version, []).extend(chunks)
            self._completed_tasks[model_version] = (
                self._completed_tasks.get(model_version, 0) + 1
            )
            expected = self._expected_tasks.get(model_version)
            complete = (
                expected is not None
                and self._completed_tasks[model_version] >= expected
            )
        if complete:
            self._finalize_round(model_version)

    def finalize(self):
        """Compute metrics for any rounds still holding batches (e.g. a task
        with zero records never reported, or ad-hoc eval-only jobs)."""
        with self._lock:
            pending = [v for v, batches in self._reported.items() if batches]
        for version in pending:
            self._finalize_round(version)

    def _finalize_round(self, model_version) -> Dict[str, float]:
        if self._eval_metrics_fn is None:
            return {}
        with self._lock:
            batches = self._reported.pop(model_version, [])
            self._completed_tasks.pop(model_version, None)
            self._expected_tasks.pop(model_version, None)
            # Purge orphaned staged chunks (dead attempts of this round).
            for key in [k for k in self._staged if k[0] == model_version]:
                del self._staged[key]
            self._finalized_versions.add(model_version)
            triggered = self._triggered_at.get(model_version)
        if not batches:
            return {}
        output_names = batches[0][0].keys()
        outputs = {
            name: np.concatenate([b[0][name] for b in batches]) for name in output_names
        }
        label_names = batches[0][1].keys()
        labels = {
            name: np.concatenate([b[1][name] for b in batches]) for name in label_names
        }
        metric_fns = self._eval_metrics_fn()
        # Contract (reference §3.5): metric fns see ALL named outputs/labels.
        # The common single-output/single-label case unwraps to bare arrays so
        # simple `fn(outputs, labels)` metrics keep working.
        if not outputs or not labels:
            logger.warning(
                "Eval round %d reported without %s; dropping round",
                model_version,
                "outputs" if not outputs else "labels",
            )
            return {}
        out_arg = outputs if len(outputs) > 1 else next(iter(outputs.values()))
        lab_arg = labels if len(labels) > 1 else next(iter(labels.values()))
        n_examples = len(next(iter(labels.values())))
        metrics = {
            name: float(np.asarray(fn(out_arg, lab_arg)))
            for name, fn in metric_fns.items()
        }
        logger.info(
            "Eval metrics at version %d (%d examples): %s",
            model_version,
            n_examples,
            {k: round(v, 5) for k, v in metrics.items()},
        )
        obs.journal().record(
            "evaluation_metrics", model_version=model_version, examples=n_examples,
            metrics=metrics,
            seconds=None if triggered is None else round(time.monotonic() - triggered, 6))
        if self._tensorboard_service is not None:
            self._tensorboard_service.write_dict_to_summary(metrics, model_version)
        with self._lock:
            self._latest_metrics = metrics
        return metrics

    @property
    def latest_metrics(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._latest_metrics)
