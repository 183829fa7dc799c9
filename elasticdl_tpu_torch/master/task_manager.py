"""Dynamic data sharding, the heart of elasticity: the port's copy of
``elasticdl_tpu/master/task_manager.py`` (``TaskManager`` :155,
``TaskProgressPersister`` :843).

The dataset is cut into shard tasks ``(shard_name, start, end, type)``;
a ``todo`` deque holds unassigned tasks and ``doing`` maps task_id ->
(worker_id, task, dispatch time, trace id).  Tasks in flight on a dead or
timed-out worker go back to ``todo``: at-least-once semantics, so churn
never loses data.  Task ids, their order, epochs, the retry budget, the
timeouts, the train-end task and the exec counters are the JAX
package's, and so is the progress JSON (``to_checkpoint`` /
``from_checkpoint``): a restarted master of either package resumes the
other's ``task_progress.json``.

Evaluation rounds go to the front of the queue
(``create_evaluation_tasks``), and the evaluation service hears of each
completed evaluation task and each finished epoch through callbacks.

Journal events (``task_dispatch``, ``task_done``, ``task_requeue``,
``task_failed_permanently``, ``train_epoch_done``,
``task_progress_resume``) and metrics go through the port's ``obs``.
Dispatches, completions and requeues (failure, churn, timeout) drive the
goodput ledger (``obs/goodput.py``): what work is in flight and what is
redone.  Four hooks let ``master/stream.StreamingTaskManager`` ride this
protocol over an unbounded source: ``_maybe_refill_locked`` tops the
queue up under the dispatch lock, ``_stream_open_locked`` keeps an open
stream from ending an epoch or the job, ``_note_task_complete_locked``
advances the watermark, and ``_checkpoint_extra_locked`` persists the
stream cursor.  Not ported: the tracing plane's spans (ROADMAP.md Queue
1 item 8).
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.common.constants import TaskExecCounterKey
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.obs import goodput

logger = get_logger("master.task_manager")

#: Trace-id prefixes must differ between manager instances in one
#: process (task ids restart at 1 per manager).
_MANAGER_SEQ = itertools.count()


def _type_name(task_type: int) -> str:
    try:
        return msg.task_type_name(task_type)
    except ValueError:
        return "UNKNOWN"


class _TaskManagerMetrics:
    """Registry handles for the task lifecycle.  Gauge callbacks read
    fields without the manager lock: a scrape must never wait on the
    control plane."""

    def __init__(self, manager: "TaskManager"):
        self.dispatched = obs.counter("elasticdl_tasks_dispatched_total",
                                      "Tasks handed to workers by get()")
        self.completed = obs.counter("elasticdl_tasks_completed_total",
                                     "Tasks reported done, by task type", labelnames=("type",))
        self.requeues = obs.counter("elasticdl_task_requeues_total",
                                    "Tasks put back on the queue, by cause",
                                    labelnames=("reason",))
        self.failed_permanently = obs.counter(
            "elasticdl_tasks_failed_permanently_total",
            "Tasks dropped after exhausting their retry budget")
        self.duration = obs.histogram("elasticdl_task_duration_seconds",
                                      "Dispatch -> done/requeue latency, by task type",
                                      labelnames=("type",))
        self.worker_batches = obs.counter("elasticdl_worker_batches_total",
                                          "Train batches reported by workers (exec counters)")
        self.worker_records = obs.counter("elasticdl_worker_records_total",
                                          "Records reported processed by workers")
        self.batch_rate = obs.RateTracker()
        self.record_rate = obs.RateTracker()
        obs.gauge("elasticdl_job_steps_per_second",
                  "Job-wide train steps/s over the trailing minute").set_function(
            self.batch_rate.rate)
        obs.gauge("elasticdl_job_examples_per_second",
                  "Job-wide examples/s over the trailing minute").set_function(
            self.record_rate.rate)
        obs.gauge("elasticdl_tasks_todo", "Unassigned tasks in the queue").set_function(
            lambda: len(manager._todo))
        obs.gauge("elasticdl_tasks_doing", "Tasks in flight on workers").set_function(
            lambda: len(manager._doing))
        obs.gauge("elasticdl_training_epoch", "Current training epoch").set_function(
            lambda: manager._epoch)


@dataclass
class _Task:
    """In-memory task record (mirrors the ``Task`` message)."""

    shard_name: str
    start: int
    end: int
    type: int
    model_version: int = -1
    epoch: int = 0
    retry_count: int = 0

    def to_message(self, task_id: int, trace_id: str = "") -> msg.Task:
        return msg.Task(task_id=task_id, shard_name=self.shard_name, start=self.start,
                        end=self.end, type=self.type, model_version=self.model_version,
                        epoch=self.epoch, trace_id=trace_id)

    def to_json(self) -> dict:
        return {
            "shard_name": self.shard_name,
            "start": self.start,
            "end": self.end,
            "type": self.type,
            "model_version": self.model_version,
            "epoch": self.epoch,
            "retry_count": self.retry_count,
        }

    @staticmethod
    def from_json(obj: dict) -> "_Task":
        return _Task(**obj)


class TaskManager:
    """Thread-safe dynamic shard-task dispatcher.

    ``training_shards``: shard_name -> number of records (or a (start,
    count) pair).  Each shard is cut into tasks of at most
    ``records_per_task`` records; ``num_epochs`` epochs of training tasks
    are created one epoch at a time.
    """

    def __init__(
        self,
        training_shards: Optional[Dict[str, object]] = None,
        evaluation_shards: Optional[Dict[str, object]] = None,
        prediction_shards: Optional[Dict[str, object]] = None,
        records_per_task: int = 4096,
        num_epochs: int = 1,
        task_timeout_s: float = 0.0,
        max_task_retries: int = 3,
    ):
        self._lock = threading.Lock()
        self._metrics = _TaskManagerMetrics(self)
        self._training_shards = dict(training_shards or {})
        self._evaluation_shards = dict(evaluation_shards or {})
        self._prediction_shards = dict(prediction_shards or {})
        self._records_per_task = records_per_task
        self._num_epochs = num_epochs
        self._task_timeout_s = task_timeout_s
        self._max_task_retries = max_task_retries

        self._todo: deque = deque()
        self._doing: Dict[int, Tuple[int, _Task, float, str]] = {}
        self._task_id = 0
        self._trace_prefix = f"{os.getpid():x}{os.urandom(3).hex()}.{next(_MANAGER_SEQ)}"
        self._epoch = 0
        self._finished_record_count = 0
        self._recovered_record_count = 0
        self._exec_counters: Dict[str, int] = {}
        self._permanently_failed: List[_Task] = []
        self._tasks_done_callbacks: List[Callable[[], None]] = []
        self._done_callbacks_fired = False
        # True while done-callbacks run (they queue the TRAIN_END task):
        # get() answers WAIT, not job-complete, until they finish.
        self._finalizing = False
        self._epoch_done_callbacks: List[Callable[[int], None]] = []
        self._eval_task_done_callbacks: List[Callable[[int, int], None]] = []

        if self._training_shards:
            self._create_training_tasks_locked()
        elif self._prediction_shards:
            self._create_tasks_locked(self._prediction_shards, msg.PREDICTION)

    # -- task creation ----------------------------------------------------

    @staticmethod
    def _shard_ranges(shards: Dict[str, object]):
        for name, spec in shards.items():
            if isinstance(spec, (tuple, list)):
                start, count = spec
            else:
                start, count = 0, int(spec)
            yield name, int(start), int(count)

    def _create_tasks_locked(self, shards, task_type, model_version=-1):
        count = 0
        for name, start, num_records in self._shard_ranges(shards):
            for lo in range(start, start + num_records, self._records_per_task):
                hi = min(lo + self._records_per_task, start + num_records)
                self._todo.append(_Task(shard_name=name, start=lo, end=hi, type=task_type,
                                        model_version=model_version, epoch=self._epoch))
                count += 1
        logger.info("Created %d %s tasks (epoch %d)", count, _type_name(task_type), self._epoch)
        return count

    def _create_training_tasks_locked(self):
        return self._create_tasks_locked(self._training_shards, msg.TRAINING)

    def create_evaluation_tasks(self, model_version: int) -> int:
        """Queue a round of evaluation tasks at the front of the queue."""
        with self._lock:
            tasks = []
            for name, start, num_records in self._shard_ranges(self._evaluation_shards):
                for lo in range(start, start + num_records, self._records_per_task):
                    hi = min(lo + self._records_per_task, start + num_records)
                    tasks.append(_Task(name, lo, hi, msg.EVALUATION, model_version, self._epoch))
            self._todo.extendleft(reversed(tasks))
            logger.info("Created %d EVALUATION tasks at model version %d", len(tasks),
                        model_version)
            return len(tasks)

    # -- dispatch protocol --------------------------------------------------

    def get(self, worker_id: int) -> msg.Task:
        """Pop the next task for ``worker_id``: a WAIT task when the queue
        is momentarily empty but work is outstanding, a task with
        ``task_id == -1`` when the job is complete."""
        finished_epoch = None
        fired_done = False
        done_callbacks = []
        journal_events: List[dict] = []
        try:
            with self._lock:
                journal_events.extend(self._recover_timed_out_locked())
                # Streaming hook: an unbounded source tops the queue up
                # under the same lock hold.
                self._maybe_refill_locked(journal_events)
                if not self._todo and not self._doing:
                    if self._stream_open_locked():
                        # The queue is dry but the stream can still
                        # produce: never an epoch barrier, never the end.
                        return msg.Task(task_id=-1, type=msg.WAIT)
                    if self._epoch + 1 < self._num_epochs and self._training_shards:
                        finished_epoch = self._epoch
                        self._epoch += 1
                        self._create_training_tasks_locked()
                    elif not self._done_callbacks_fired:
                        # This worker arrived before report() fired the
                        # done-callbacks: fire them here, answer WAIT.
                        self._done_callbacks_fired = True
                        self._finalizing = True
                        fired_done = True
                        done_callbacks = list(self._tasks_done_callbacks)
                        return msg.Task(task_id=-1, type=msg.WAIT)
                    elif self._finalizing:
                        return msg.Task(task_id=-1, type=msg.WAIT)
                    else:
                        return msg.Task(task_id=-1)
                if not self._todo:
                    return msg.Task(task_id=-1, type=msg.WAIT)

                task = self._todo.popleft()
                self._task_id += 1
                task_id = self._task_id
                # One trace id per dispatch: a requeued task re-dispatches
                # under a fresh task id and trace id.
                trace_id = f"t-{self._trace_prefix}-{task_id}"
                self._doing[task_id] = (worker_id, task, time.time(), trace_id)
                self._metrics.dispatched.inc()
                journal_events.append(dict(
                    event="task_dispatch", task_id=task_id, worker_id=worker_id,
                    trace_id=trace_id, type=_type_name(task.type), shard=task.shard_name,
                    start=task.start, end=task.end, epoch=task.epoch,
                ))
                return task.to_message(task_id, trace_id=trace_id)
        finally:
            # Journal writes outside the dispatch lock.
            for event in journal_events:
                obs.journal().record(**event)
            # The ledger too (it journals): a dispatch opens the work
            # phase; a timeout requeue adds to the redo debt.
            for event in journal_events:
                if event["event"] == "task_requeue":
                    goodput.ledger().note_requeue(event.get("records", 0), event["reason"])
                elif event["event"] == "task_dispatch":
                    goodput.ledger().note_dispatch()
            if finished_epoch is not None:
                obs.journal().record("train_epoch_done", epoch=finished_epoch,
                                     next_epoch=finished_epoch + 1)
                for callback in self._epoch_done_callbacks:
                    try:
                        callback(finished_epoch)
                    except Exception:
                        logger.exception("epoch-done callback failed")
            if fired_done:
                self._run_done_callbacks(done_callbacks)

    def report(self, task_id: int, success: bool, worker_id: int = -1,
               exec_counters: Optional[Dict[str, int]] = None, trace_id: str = "") -> bool:
        """Mark a task done or failed (a failed one goes back to ``todo``
        while its retry budget lasts).  ``trace_id`` is the id the worker
        echoed; the dispatch-minted one is journaled.  True if ``task_id``
        was in flight."""
        fired_done = False
        callbacks_to_run = []
        eval_done_callbacks = []
        journal_events: List[dict] = []
        with self._lock:
            entry = self._doing.pop(task_id, None)
            if entry is None:
                logger.warning("Report for unknown/expired task %d%s", task_id,
                               f" (trace {trace_id})" if trace_id else "")
                return False
            _owner, task, started, stored_trace = entry
            type_name = _type_name(task.type)
            duration_s = time.time() - started
            self._metrics.duration.observe(duration_s, type=type_name)
            if success:
                self._metrics.completed.inc(type=type_name)
                done_event = dict(event="task_done", task_id=task_id, worker_id=worker_id,
                                  trace_id=stored_trace, type=type_name,
                                  duration_s=round(duration_s, 6))
                if trace_id and trace_id != stored_trace:
                    done_event["reported_trace_id"] = trace_id
                journal_events.append(done_event)
                batches = (exec_counters or {}).get(TaskExecCounterKey.BATCH_COUNT, 0)
                records = (exec_counters or {}).get(TaskExecCounterKey.RECORD_COUNT, 0)
                if batches:
                    self._metrics.worker_batches.inc(batches)
                    self._metrics.batch_rate.add(batches)
                if records:
                    self._metrics.worker_records.inc(records)
                    self._metrics.record_rate.add(records)
                if task.type == msg.TRAINING:
                    self._finished_record_count += task.end - task.start
                    # Streaming hook: the watermark advances here.
                    self._note_task_complete_locked(task, journal_events)
                if task.type == msg.EVALUATION:
                    eval_done_callbacks = list(self._eval_task_done_callbacks)
                for key, value in (exec_counters or {}).items():
                    self._exec_counters[key] = self._exec_counters.get(key, 0) + value
                oov = (exec_counters or {}).get(TaskExecCounterKey.OOV_LOOKUP_COUNT, 0)
                if oov:
                    logger.warning(
                        "Task %d saw %d out-of-vocabulary embedding ids (job total %d): OOV "
                        "ids read zeros and get no update; hash open-vocabulary features "
                        "into fixed bins", task_id, oov,
                        self._exec_counters[TaskExecCounterKey.OOV_LOOKUP_COUNT])
            elif task.retry_count + 1 > self._max_task_retries:
                logger.error("Task %d (%s[%d,%d)) exhausted %d retries; dropping", task_id,
                             task.shard_name, task.start, task.end, self._max_task_retries)
                self._metrics.failed_permanently.inc()
                journal_events.append(dict(
                    event="task_failed_permanently", task_id=task_id, trace_id=stored_trace,
                    shard=task.shard_name, start=task.start, end=task.end,
                    retries=self._max_task_retries,
                ))
                self._permanently_failed.append(task)
            else:
                task.retry_count += 1
                logger.info("Task %d failed; requeueing (retry %d/%d)", task_id,
                            task.retry_count, self._max_task_retries)
                self._metrics.requeues.inc(reason="failure")
                journal_events.append(dict(
                    event="task_requeue", reason="failure", task_id=task_id,
                    trace_id=stored_trace, worker_id=worker_id, retry=task.retry_count,
                ))
                self._todo.appendleft(task)
                if task.type == msg.TRAINING:
                    self._recovered_record_count += task.end - task.start
            if (not self._todo and not self._doing and not self._done_callbacks_fired
                    and not self._stream_open_locked()):
                if self._epoch + 1 >= self._num_epochs or not self._training_shards:
                    self._done_callbacks_fired = True
                    self._finalizing = True
                    fired_done = True
                    callbacks_to_run = list(self._tasks_done_callbacks)
        for event in journal_events:
            obs.journal().record(**event)
        # Completed training records repay any redo debt; a failure's
        # requeue adds to it.
        training = task.type == msg.TRAINING
        task_records = task.end - task.start
        if success:
            goodput.ledger().note_task_done(records=task_records if training else 0,
                                            training=training)
        elif any(e["event"] == "task_requeue" for e in journal_events):
            goodput.ledger().note_requeue(task_records if training else 0, "failure")
        # Outside the lock; the round sees its task done before any
        # tasks-done callback queues the next round.
        for callback in eval_done_callbacks:
            try:
                callback(task.model_version, task_id)
            except Exception:
                logger.exception("eval-task-done callback failed")
        if fired_done:
            self._run_done_callbacks(callbacks_to_run)
        return True

    def _run_done_callbacks(self, callbacks):
        """Tasks-done callbacks run outside the lock (they may queue tasks),
        then the finalizing gate lifts."""
        try:
            for callback in callbacks:
                try:
                    callback()
                except Exception:
                    logger.exception("tasks-done callback failed")
        finally:
            with self._lock:
                self._finalizing = False

    # -- streaming hooks (overridden by master/stream.StreamingTaskManager) --

    def _maybe_refill_locked(self, journal_events: List[dict]) -> None:
        """Called under the lock at the top of every ``get()``: an
        unbounded source tops the queue up here.  Base: no-op."""

    def _stream_open_locked(self) -> bool:
        """True while an unbounded source can still produce records;
        gates the epoch-advance and job-complete branches.  Base: False."""
        return False

    def _note_task_complete_locked(self, task: _Task, journal_events: List[dict]) -> None:
        """Called under the lock for every completed TRAINING task.
        Base: no-op."""

    def _checkpoint_extra_locked(self) -> Dict[str, object]:
        """Extra JSON merged into ``to_checkpoint()`` under the lock.
        Base: {}."""
        return {}

    def recover_tasks(self, worker_id: int) -> int:
        """Requeue every task in flight on a dead or removed worker."""
        with self._lock:
            recovered = [tid for tid, (owner, _t, _s, _tr) in self._doing.items()
                         if owner == worker_id]
            trace_ids = []
            churn_records = 0
            for tid in recovered:
                _owner, task, _start, trace_id = self._doing.pop(tid)
                trace_ids.append(trace_id)
                self._todo.appendleft(task)
                if task.type == msg.TRAINING:
                    self._recovered_record_count += task.end - task.start
                    churn_records += task.end - task.start
            if recovered:
                self._metrics.requeues.inc(len(recovered), reason="worker_churn")
                logger.info("Recovered %d tasks from worker %d", len(recovered), worker_id)
        if recovered:
            obs.journal().record("task_requeue", reason="worker_churn", worker_id=worker_id,
                                 task_ids=recovered, trace_ids=trace_ids)
            goodput.ledger().note_requeue(churn_records, "worker_churn", tasks=len(recovered))
        return len(recovered)

    def _recover_timed_out_locked(self) -> List[dict]:
        """Requeue tasks in flight longer than the timeout; returns their
        journal events (written by the caller outside the lock)."""
        if not self._task_timeout_s:
            return []
        now = time.time()
        expired = [tid for tid, (_owner, _task, start, _tr) in self._doing.items()
                   if now - start > self._task_timeout_s]
        events = []
        for tid in expired:
            owner, task, _start, trace_id = self._doing.pop(tid)
            self._todo.appendleft(task)
            records = task.end - task.start if task.type == msg.TRAINING else 0
            self._recovered_record_count += records
            self._metrics.requeues.inc(reason="timeout")
            events.append(dict(event="task_requeue", reason="timeout", task_id=tid,
                               trace_id=trace_id, worker_id=owner,
                               timeout_s=self._task_timeout_s, records=records))
            logger.info("Task %d timed out on worker %d; requeued", tid, owner)
        return events

    # -- introspection / lifecycle -----------------------------------------

    def add_tasks_done_callback(self, callback: Callable[[], None]):
        with self._lock:
            self._tasks_done_callbacks.append(callback)

    def add_eval_task_done_callback(self, callback: Callable[[int, int], None]):
        """``callback(model_version, task_id)`` after each EVALUATION task
        completes (outside the lock): the evaluation service closes
        rounds on task completions, not on report counts."""
        with self._lock:
            self._eval_task_done_callbacks.append(callback)

    def add_epoch_done_callback(self, callback: Callable[[int], None]):
        """``callback(epoch)`` (outside the lock) each time a training
        epoch completes and the next epoch's tasks are queued."""
        with self._lock:
            self._epoch_done_callbacks.append(callback)

    def create_train_end_task(self) -> None:
        """Queue the TRAIN_END_CALLBACK task (runs the zoo's callbacks)."""
        with self._lock:
            self._todo.append(_Task("", 0, 0, msg.TRAIN_END_CALLBACK))

    def finished(self) -> bool:
        with self._lock:
            no_more_epochs = self._epoch + 1 >= self._num_epochs or not self._training_shards
            finalization_settled = self._done_callbacks_fired and not self._finalizing
            return (not self._todo and not self._doing and no_more_epochs
                    and not self._stream_open_locked()
                    and (finalization_settled or not self._tasks_done_callbacks))

    @property
    def finished_record_count(self) -> int:
        with self._lock:
            return self._finished_record_count

    @property
    def recovered_record_count(self) -> int:
        """Records of tasks requeued after a death or timeout: the
        at-least-once replay cost of elasticity."""
        with self._lock:
            return self._recovered_record_count

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"todo": len(self._todo), "doing": len(self._doing), "epoch": self._epoch}

    def exec_counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._exec_counters)

    def permanently_failed_tasks(self) -> List[msg.Task]:
        with self._lock:
            return [t.to_message(-1) for t in self._permanently_failed]

    # -- master resume: the shard-progress checkpoint -----------------------

    def to_checkpoint(self) -> str:
        """JSON snapshot; ``doing`` tasks count as todo (at-least-once)."""
        with self._lock:
            todo = [t.to_json() for t in self._todo]
            todo.extend(t.to_json() for (_w, t, _s, _tr) in self._doing.values())
            state = {
                "epoch": self._epoch,
                "num_epochs": self._num_epochs,
                "records_per_task": self._records_per_task,
                "finished_record_count": self._finished_record_count,
                "training_shards": self._training_shards,
                "evaluation_shards": self._evaluation_shards,
                "prediction_shards": self._prediction_shards,
                "todo": todo,
            }
            state.update(self._checkpoint_extra_locked())
            return json.dumps(state)

    @classmethod
    def from_checkpoint(cls, content: str, task_timeout_s: float = 0.0,
                        max_task_retries: int = 3) -> "TaskManager":
        state = json.loads(content)
        manager = cls(
            training_shards=None,
            evaluation_shards=state.get("evaluation_shards") or {},
            prediction_shards=state.get("prediction_shards") or {},
            records_per_task=state["records_per_task"],
            num_epochs=state["num_epochs"],
            task_timeout_s=task_timeout_s,
            max_task_retries=max_task_retries,
        )
        manager._training_shards = state.get("training_shards") or {}
        manager._epoch = state["epoch"]
        manager._finished_record_count = state.get("finished_record_count", 0)
        manager._todo.extend(_Task.from_json(t) for t in state["todo"])
        obs.journal().record("task_progress_resume", epoch=manager._epoch,
                             todo=len(manager._todo),
                             finished_records=manager._finished_record_count)
        return manager


class TaskProgressPersister:
    """Snapshots a ``TaskManager`` to ``<checkpoint_dir>/task_progress.json``
    every ``interval_s`` so a restarted master resumes the epoch.  Writes
    are atomic (tmp + rename); tasks finished after the last snapshot
    re-run, which at-least-once semantics permit."""

    FILENAME = "task_progress.json"

    def __init__(self, task_manager: TaskManager, checkpoint_dir: str, interval_s: float = 2.0):
        self._task_manager = task_manager
        self._path = os.path.join(checkpoint_dir, self.FILENAME)
        self._interval_s = interval_s
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(checkpoint_dir, exist_ok=True)

    @classmethod
    def progress_path(cls, checkpoint_dir: str) -> str:
        return os.path.join(checkpoint_dir, cls.FILENAME)

    def start(self) -> "TaskProgressPersister":
        self._thread = threading.Thread(target=self._loop, name="task-progress-persister",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.cancel()
        self.persist_now()

    def cancel(self):
        """Stop the loop without the final persist (a hard-killed master's
        snapshot stays as it crashed)."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def persist_now(self):
        content = self._task_manager.to_checkpoint()
        fd, tmp_path = tempfile.mkstemp(prefix=self.FILENAME + ".",
                                        dir=os.path.dirname(self._path))
        try:
            with os.fdopen(fd, "w") as f:
                f.write(content)
            os.replace(tmp_path, self._path)
        except BaseException:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
            raise

    def clear(self):
        """Remove the snapshot after a job completes, so a re-run with the
        same checkpoint_dir does not resume a finished queue."""
        try:
            os.unlink(self._path)
            logger.info("Cleared task-progress snapshot %s", self._path)
        except FileNotFoundError:
            pass

    def _loop(self):
        while not self._stop_event.wait(self._interval_s):
            try:
                self.persist_now()
            except Exception:
                logger.exception("Task-progress persist failed; will retry")
