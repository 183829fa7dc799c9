"""Micro-batching front door of a serving replica.

The port's copy of ``elasticdl_tpu/serving/batcher.py``.  Concurrent
predict requests are aggregated into one device dispatch: a batch closes
when it reaches ``max_batch_size`` rows OR when its oldest request has
waited ``max_wait_us``, whichever comes first.

- **Padded-bucket shapes.**  Each dispatch is padded to a power-of-two
  bucket (``data/pipeline.py``); model rows are independent, so pad rows
  cannot perturb real rows, and their outputs are sliced off.
- **Explicit load shedding.**  Admission is a bounded queue
  (``queue_limit``); a request arriving at a full queue is rejected at
  once with ``QueueFullError``.  A request whose deadline passed while it
  queued is dropped with ``RequestError`` instead of executed.
- **Failure fan-out.**  An execute error fails every live request of
  that batch with ``RequestError``; the batcher thread keeps running.

The batcher thread never holds its lock across the execute callable.
The JAX package's metrics, journal events, fault-injection sites and
tracing/quality hooks are not ported yet (ROADMAP).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.data.pipeline import bucket_sizes, pad_and_stage

logger = logging.getLogger("elasticdl_tpu_torch.serving.batcher")


class QueueFullError(RuntimeError):
    """Admission queue at capacity: the request was shed, not queued."""


class RequestError(RuntimeError):
    """The batch this request rode failed to execute."""


@dataclass(eq=False)  # identity semantics: fields hold numpy arrays
class _Pending:
    """One admitted request riding the queue."""

    features: Dict[str, np.ndarray]
    rows: int
    enqueued_at: float
    deadline: Optional[float]  # monotonic; None = no deadline
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("predict result not ready in time")
        if self.error is not None:
            raise self.error
        return self.result


@dataclass(frozen=True)
class BatcherConfig:
    max_batch_size: int = 64
    max_wait_us: int = 2000
    queue_limit: int = 256


class MicroBatcher:
    """Aggregates admitted requests into padded-bucket dispatches.

    ``execute_fn(features, n_valid)`` runs the inference step on a padded
    batch and returns outputs with the batch on axis 0.  ``start``/
    ``stop`` own the single batcher thread.
    """

    def __init__(
        self,
        execute_fn: Callable[[Dict[str, np.ndarray], int], np.ndarray],
        config: BatcherConfig = BatcherConfig(),
    ):
        self._execute_fn = execute_fn
        self._config = config
        self._buckets = bucket_sizes(config.max_batch_size)
        self._lock = threading.Lock()
        self._queue: deque = deque()  # guarded-by: _lock
        self._queued_rows = 0  # guarded-by: _lock
        self._wakeup = threading.Condition(self._lock)
        self._stopped = False  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "MicroBatcher":
        self._thread = threading.Thread(
            target=self._run, name="serving-batcher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._stopped = True
            self._wakeup.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # Fail any stragglers still queued so no caller blocks forever.
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
        for req in pending:
            req.error = RequestError("batcher stopped")
            req.done.set()

    # -- admission ------------------------------------------------------

    def submit(
        self, features: Dict[str, np.ndarray], deadline_s: Optional[float] = None
    ) -> _Pending:
        """Admit one request (all arrays share axis-0 row count).  Raises
        QueueFullError when the admission queue is at capacity."""
        rows = int(np.asarray(next(iter(features.values()))).shape[0])
        if rows > self._config.max_batch_size:
            raise ValueError(
                f"request rows {rows} exceed max_batch_size "
                f"{self._config.max_batch_size}; split the request"
            )
        now = time.monotonic()
        req = _Pending(
            features={k: np.asarray(v) for k, v in features.items()},
            rows=rows,
            enqueued_at=now,
            deadline=(now + deadline_s) if deadline_s else None,
        )
        with self._lock:
            if self._stopped:
                raise RequestError("batcher stopped")
            depth = len(self._queue)
            if depth >= self._config.queue_limit:
                raise QueueFullError(
                    f"admission queue full ({depth}/{self._config.queue_limit})"
                )
            self._queue.append(req)
            self._queued_rows += rows
            self._wakeup.notify()
        return req

    def predict(
        self,
        features: Dict[str, np.ndarray],
        deadline_s: Optional[float] = None,
        wait_timeout_s: Optional[float] = 60.0,
    ) -> np.ndarray:
        """submit + wait, the synchronous convenience for request
        handler threads."""
        return self.submit(features, deadline_s).wait(wait_timeout_s)

    # -- the batcher thread ---------------------------------------------

    def _take_batch(self) -> List[_Pending]:
        """Block until a batch is due (full, or the oldest admitted
        request has waited max_wait_us), then pop it.  Empty list on
        stop."""
        max_wait_s = self._config.max_wait_us / 1e6
        with self._lock:
            while True:
                if self._stopped:
                    return []
                if self._queued_rows >= self._config.max_batch_size:
                    break
                if self._queue:
                    age = time.monotonic() - self._queue[0].enqueued_at
                    if age >= max_wait_s:
                        break
                    self._wakeup.wait(timeout=max_wait_s - age)
                else:
                    self._wakeup.wait(timeout=0.1)
            batch: List[_Pending] = []
            rows = 0
            while self._queue:
                if rows + self._queue[0].rows > self._config.max_batch_size:
                    break
                req = self._queue.popleft()
                self._queued_rows -= req.rows
                rows += req.rows
                batch.append(req)
            return batch

    def _run(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return
            try:
                self._dispatch(batch)
            except Exception:  # never kill the batcher thread
                logger.exception("batch dispatch failed")

    def _dispatch(self, batch: List[_Pending]):
        now = time.monotonic()
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                self._finish(req, None, RequestError("deadline expired in queue"))
            else:
                live.append(req)
        if not live:
            return
        rows = sum(r.rows for r in live)
        stacked = {
            key: np.concatenate([r.features[key] for r in live], axis=0)
            for key in live[0].features
        }
        padded, _ = pad_and_stage(stacked, rows, self._buckets)
        try:
            outputs = np.asarray(self._execute_fn(padded, rows))
        except Exception as exc:
            for req in live:
                self._finish(req, None, RequestError(f"execute failed: {exc}"))
            raise
        offset = 0
        for req in live:
            self._finish(req, outputs[offset:offset + req.rows], None)
            offset += req.rows

    @staticmethod
    def _finish(req: _Pending, result, error):
        req.result = result
        req.error = error
        req.done.set()
