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

Hooks and instruments (the JAX package's): ``on_request(phases,
outcome, rows)`` books every finished request (the availability
ledger's), ``on_shed(rows)`` every admission reject, ``on_batch(stacked)``
sees each dispatch's real (unpadded) rows; a shed is journaled as a
``request_shed`` event and counted in ``elasticdl_serving_shed_total``;
the queue depth and rows per dispatch are metrics; each request carries
its phase clocks (queue / batch / execute / respond); ``serving.execute``
is a fault site
(latency stalls the batcher thread, error fails the batch).  All clocks
are host-side, and the batcher thread never holds its lock across the
execute callable.  The request-trace ids and the shared ``serve.batch``
span of the JAX package wait for the tracing plane (ROADMAP.md Queue 1
item 8).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.pipeline import bucket_sizes, pad_and_stage

logger = get_logger("serving.batcher")

_SHED = obs.counter(
    "elasticdl_serving_shed_total",
    "Requests rejected at admission, by cause",
    labelnames=("reason",),
)


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
    # Phase clocks filled in by the batcher thread (queue / batch /
    # execute / respond: ledger.REQUEST_PHASES).
    phases: Dict[str, float] = field(default_factory=dict)

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
    batch and returns outputs with the batch on axis 0; ``on_request``,
    ``on_shed`` and ``on_batch`` (optional) are the hooks of the module
    docstring; ``clock`` is the monotonic clock every phase is read
    from.  ``start``/``stop`` own the single batcher thread.
    """

    def __init__(
        self,
        execute_fn: Callable[[Dict[str, np.ndarray], int], np.ndarray],
        config: BatcherConfig = BatcherConfig(),
        on_request: Optional[Callable[[Dict[str, float], str, int], None]] = None,
        on_shed: Optional[Callable[[int], None]] = None,
        on_batch: Optional[Callable[[Dict[str, np.ndarray]], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._execute_fn = execute_fn
        self._config = config
        self._on_request = on_request
        self._on_shed = on_shed
        self._on_batch = on_batch
        self._clock = clock
        self._buckets = bucket_sizes(config.max_batch_size)
        self._lock = threading.Lock()
        self._queue: deque = deque()  # guarded-by: _lock
        self._queued_rows = 0  # guarded-by: _lock
        self._wakeup = threading.Condition(self._lock)
        self._stopped = False  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None
        self._m_depth = obs.gauge(
            "elasticdl_serving_queue_depth",
            "Requests currently waiting for a batch slot",
        )
        self._m_depth.set_function(lambda: len(self._queue))
        self._m_batch_rows = obs.histogram(
            "elasticdl_serving_batch_rows",
            "Real (unpadded) rows per dispatched batch",
            buckets=tuple(float(b) for b in self._buckets),
        )

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
        now = self._clock()
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
            shed = depth >= self._config.queue_limit
            if not shed:
                self._queue.append(req)
                self._queued_rows += rows
                self._wakeup.notify()
        if shed:
            _SHED.inc(reason="queue_full")
            obs.journal().record(
                "request_shed",
                reason="queue_full",
                queue_depth=depth,
                queue_limit=self._config.queue_limit,
                rows=rows,
            )
            if self._on_shed is not None:
                self._on_shed(rows)
            raise QueueFullError(
                f"admission queue full ({depth}/{self._config.queue_limit})"
            )
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
                    age = self._clock() - self._queue[0].enqueued_at
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
        t_batch = self._clock()
        for req in batch:
            req.phases["queue"] = max(0.0, t_batch - req.enqueued_at)
        expired = [r for r in batch if r.deadline is not None and t_batch > r.deadline]
        live = [r for r in batch if r not in expired]
        for req in expired:
            _SHED.inc(reason="deadline")
            obs.journal().record(
                "request_shed", reason="deadline", rows=req.rows,
                waited_s=round(req.phases["queue"], 6),
            )
            self._finish(req, None, RequestError("deadline expired in queue"),
                         outcome="dropped")
        if not live:
            return
        rows = sum(r.rows for r in live)
        stacked = {
            key: np.concatenate([r.features[key] for r in live], axis=0)
            for key in live[0].features
        }
        if self._on_batch is not None:
            # Sees the REAL (unpadded) rows; its failure never fails the
            # batch.
            try:
                self._on_batch(stacked)
            except Exception:
                logger.exception("on_batch hook failed (ignored)")
        padded, _ = pad_and_stage(stacked, rows, self._buckets)
        t_exec = self._clock()
        batch_s = t_exec - t_batch
        self._m_batch_rows.observe(float(rows))
        try:
            # Fault site: a latency fault stalls the batcher thread (the
            # queue piles up behind it); an error fault fails the batch.
            spec = faults.fire("serving.execute")
            if spec is not None:
                if spec.kind == "latency":
                    time.sleep(float(spec.arg or 0.1))
                elif spec.kind == "error":
                    raise RuntimeError(
                        f"FAULT INJECTION: serving execute failed ({spec.arg or 'error'})"
                    )
            outputs = np.asarray(self._execute_fn(padded, rows))
        except Exception as exc:
            t_done = self._clock()
            self._stamp_batch(live, batch_s, t_done - t_exec)
            for req in live:
                self._finish(req, None, RequestError(f"execute failed: {exc}"),
                             outcome="error")
            raise
        execute_s = self._clock() - t_exec
        self._stamp_batch(live, batch_s, execute_s)
        offset = 0
        for req in live:
            self._finish(req, outputs[offset:offset + req.rows], None, outcome="served")
            offset += req.rows

    @staticmethod
    def _stamp_batch(live: List[_Pending], batch_s: float, execute_s: float):
        """Stamp each member's batch and execute phases."""
        for req in live:
            req.phases["batch"] = batch_s
            req.phases["execute"] = execute_s

    def _finish(self, req: _Pending, result, error, outcome: str):
        t0 = self._clock()
        req.result = result
        req.error = error
        req.done.set()
        req.phases["respond"] = self._clock() - t0
        if self._on_request is not None:
            try:
                self._on_request(dict(req.phases), outcome, req.rows)
            except Exception:
                logger.exception("availability-ledger callback failed")
