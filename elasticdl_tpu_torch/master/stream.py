"""Streaming task generation, the dispatcher over an unbounded source:
the port's copy of ``elasticdl_tpu/master/stream.py``.

``StreamingTaskManager`` extends the master's dynamic sharding service
(``master/task_manager.py``) from bounded epochs to an append-only
stream.  The shard IS the stream: tasks are offset ranges ``[lo, hi)``
cut from the source's availability frontier under the same dispatch
lock, and ride the same ``todo``/``doing`` protocol, churn-requeue path,
at-least-once replay accounting and journal chain.

A **watermark** replaces the epoch barrier: the offset below which every
record has been trained by a completed task.  Completed ranges above it
are held in a small sorted set and evicted the moment the contiguous
prefix closes, so the dispatcher's state stays O(in flight), never
O(stream).  Every advance is journaled (``stream_watermark``, the JAX
package's event and fields), which makes the journal a resume point: a
SIGKILLed master rebuilds the cursor from the last watermark plus the
dispatch/done chain above it (``resume_from_journal``) and re-emits
nothing that completed, so the only redo debt after a restart is what
churn requeues already charged.

Lookahead is bounded: at most ``lookahead_tasks`` tasks exist (todo +
doing) at any instant, so a stalled trainer exerts backpressure on the
cut frontier instead of buffering the stream.  ``watermark_event_time``
is what the freshness tracker (``obs/freshness.FreshnessTracker.
note_watermark``) and the delta exporter (``publish_delta(event_time=
...)``) read.
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Tuple

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.stream import SyntheticClickStream
from elasticdl_tpu_torch.master.task_manager import TaskManager, _Task

logger = get_logger("master.stream")


class StreamingTaskManager(TaskManager):
    """TaskManager over an unbounded stream source.

    `stream` must provide `name`, `available()`, `event_time(offset)`,
    `closed`, and (for checkpoint resume) `to_json`.  The driver owns
    the stream's clock; this class only ever reads the availability
    frontier — no wall-clock coupling, so chaos runs replay exactly.
    """

    def __init__(
        self,
        stream,
        records_per_task: int = 4096,
        lookahead_tasks: int = 8,
        task_timeout_s: float = 0.0,
        max_task_retries: int = 3,
    ):
        if lookahead_tasks < 1:
            raise ValueError("lookahead_tasks must be >= 1")
        self._stream = stream
        self._lookahead_tasks = lookahead_tasks
        # Cut frontier / watermark / completed-above-watermark ranges.
        # All guarded-by: _lock (created by the base ctor below; the
        # ctor itself runs single-threaded).
        self._next_offset = 0
        self._watermark = 0
        self._completed: List[Tuple[int, int]] = []  # sorted, disjoint
        super().__init__(
            training_shards=None,
            records_per_task=records_per_task,
            num_epochs=1,
            task_timeout_s=task_timeout_s,
            max_task_retries=max_task_retries,
        )
        obs.gauge(
            "elasticdl_stream_watermark",
            "Stream offset below which all records are trained",
        ).set_function(lambda: self._watermark)
        obs.gauge(
            "elasticdl_stream_backlog_records",
            "Arrived records not yet folded under the watermark",
        ).set_function(
            lambda: max(0, self._stream.available() - self._watermark)
        )

    # ------------------------------------------------------------------
    # TaskManager streaming hooks
    # ------------------------------------------------------------------

    def _stream_open_locked(self) -> bool:
        # Open while the source can still produce, or produced records
        # have not yet been cut into tasks.  (Consulted only when todo
        # and doing are both empty — anything cuttable was just cut by
        # _maybe_refill_locked under the same lock hold.)
        if not getattr(self._stream, "closed", False):
            return True
        return self._next_offset < self._stream.available()

    def _maybe_refill_locked(self, journal_events: List[dict]) -> None:
        available = self._stream.available()
        closed = getattr(self._stream, "closed", False)
        cut = 0
        while len(self._todo) + len(self._doing) < self._lookahead_tasks:
            span = self._cut_range_locked(available, closed, journal_events)
            if span is None:
                break
            lo, hi = span
            self._todo.append(
                _Task(
                    shard_name=self._stream.name,
                    start=lo,
                    end=hi,
                    type=msg.TRAINING,
                    epoch=0,
                )
            )
            cut += 1
        if cut:
            logger.debug(
                "Cut %d stream tasks (frontier %d, available %d)",
                cut, self._next_offset, available,
            )

    def _cut_range_locked(
        self, available: int, closed: bool, journal_events: List[dict]
    ) -> Optional[Tuple[int, int]]:
        """Next task range at the cut frontier, skipping ranges already
        completed before a resume (holes never re-emit — that is the
        redo-debt-exact resume guarantee)."""
        # Jump the frontier over a completed range it sits inside.  The
        # list is coalesced (disjoint, non-adjacent), so at most one
        # range can contain the frontier — and ranges wholly below it
        # MUST stay listed: they are holes above the watermark, evicted
        # only when the contiguous prefix reaches them.
        for clo, chi in self._completed:
            if chi <= self._next_offset:
                continue
            if clo <= self._next_offset:
                self._next_offset = chi
                self._evict_watermark_locked(journal_events)
            break
        lo = self._next_offset
        if lo >= available:
            return None
        hi = min(lo + self._records_per_task, available)
        bounded_by_hole = False
        idx = bisect.bisect_right([r[0] for r in self._completed], lo)
        if idx < len(self._completed) and self._completed[idx][0] < hi:
            hi = self._completed[idx][0]
            bounded_by_hole = True
        if hi - lo < self._records_per_task and not (
            closed or bounded_by_hole
        ):
            # Open stream, partial tail: wait for the task to fill —
            # uniform cuts keep per-task cost predictable, and at these
            # rates the fill latency is far inside the freshness SLO.
            return None
        self._next_offset = hi
        return lo, hi

    def _note_task_complete_locked(
        self, task: _Task, journal_events: List[dict]
    ) -> None:
        if task.shard_name != self._stream.name or task.end <= task.start:
            return
        self._merge_completed_locked(task.start, task.end)
        self._evict_watermark_locked(journal_events)

    def _merge_completed_locked(self, lo: int, hi: int) -> None:
        lows = [r[0] for r in self._completed]
        idx = bisect.bisect_left(lows, lo)
        self._completed.insert(idx, (lo, hi))
        # Coalesce neighbours (replayed ranges may overlap — the
        # at-least-once contract extends to watermark bookkeeping).
        merged: List[Tuple[int, int]] = []
        for clo, chi in self._completed:
            if merged and clo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], chi))
            else:
                merged.append((clo, chi))
        self._completed = merged

    def _evict_watermark_locked(self, journal_events: List[dict]) -> None:
        """Advance the watermark over the contiguous completed prefix and
        evict those ranges — the streaming replacement for an epoch
        barrier.  Journals `stream_watermark` on every advance (emitted
        by the caller outside the lock, like every journal write)."""
        advanced = False
        while self._completed and self._completed[0][0] <= self._watermark:
            clo, chi = self._completed.pop(0)
            if chi > self._watermark:
                self._watermark = chi
                advanced = True
        if advanced:
            journal_events.append(
                dict(
                    event="stream_watermark",
                    stream=self._stream.name,
                    offset=self._watermark,
                    event_time=round(
                        self._stream.event_time(self._watermark), 6
                    ),
                    next_offset=self._next_offset,
                    pending_ranges=len(self._completed),
                )
            )

    def _checkpoint_extra_locked(self) -> Dict[str, object]:
        extra: Dict[str, object] = {
            "stream": {
                "name": self._stream.name,
                "next_offset": self._next_offset,
                "watermark": self._watermark,
                "completed": [list(r) for r in self._completed],
                "lookahead_tasks": self._lookahead_tasks,
            }
        }
        if hasattr(self._stream, "to_json"):
            extra["stream"]["source"] = self._stream.to_json()
        return extra

    # ------------------------------------------------------------------
    # Introspection (driver + freshness tracker)
    # ------------------------------------------------------------------

    @property
    def watermark(self) -> int:
        with self._lock:
            return self._watermark

    def watermark_event_time(self) -> float:
        """Event time of the watermark frontier: every record with an
        earlier event time has been trained.  The freshness tracker's
        `note_watermark` input."""
        with self._lock:
            return self._stream.event_time(self._watermark)

    def stream_counts(self) -> Dict[str, int]:
        with self._lock:
            return {
                "watermark": self._watermark,
                "next_offset": self._next_offset,
                "available": self._stream.available(),
                "pending_ranges": len(self._completed),
            }

    # ------------------------------------------------------------------
    # Crash-safe resume: snapshot and journal paths
    # ------------------------------------------------------------------

    @classmethod
    def from_checkpoint(
        cls,
        content: str,
        stream=None,
        task_timeout_s: float = 0.0,
        max_task_retries: int = 3,
    ) -> "StreamingTaskManager":
        """Rebuild from a TaskProgressPersister snapshot.  `doing` was folded into `todo`
        at snapshot time, so in-flight ranges re-dispatch (at-least-once)
        while completed ranges — including holes above the watermark —
        never re-emit."""
        state = json.loads(content)
        cursor = state.get("stream") or {}
        if stream is None:
            source = cursor.get("source")
            if source is None:
                raise ValueError(
                    "snapshot has no serialised stream source; pass one"
                )
            stream = SyntheticClickStream.from_json(source)
        manager = cls(
            stream,
            records_per_task=state["records_per_task"],
            lookahead_tasks=int(cursor.get("lookahead_tasks", 8)),
            task_timeout_s=task_timeout_s,
            max_task_retries=max_task_retries,
        )
        manager._next_offset = int(cursor.get("next_offset", 0))
        manager._watermark = int(cursor.get("watermark", 0))
        manager._completed = [
            (int(lo), int(hi)) for lo, hi in cursor.get("completed", [])
        ]
        manager._finished_record_count = state.get("finished_record_count", 0)
        manager._todo.extend(_Task.from_json(t) for t in state["todo"])
        obs.journal().record(
            "task_progress_resume",
            epoch=0,
            todo=len(manager._todo),
            finished_records=manager._finished_record_count,
            stream=stream.name,
            watermark=manager._watermark,
            next_offset=manager._next_offset,
        )
        return manager

    @classmethod
    def resume_from_journal(
        cls,
        events: List[dict],
        stream,
        records_per_task: int = 4096,
        lookahead_tasks: int = 8,
        task_timeout_s: float = 0.0,
        max_task_retries: int = 3,
    ) -> "StreamingTaskManager":
        """Rebuild the cursor from the journal alone — the resume path
        when the master died between progress snapshots.  The last
        `stream_watermark` anchors the frontier; the dispatch/done chain
        above it reconstructs completed holes, so nothing that finished
        re-emits.  Ranges that were in flight at the kill simply re-cut
        — the same records the churn-requeue path would have charged,
        keeping the ledger's redo debt exact."""
        watermark = 0
        dispatched: Dict[int, Tuple[int, int]] = {}
        completed: List[Tuple[int, int]] = []
        for event in events:
            name = event.get("event")
            if (
                name == "stream_watermark"
                and event.get("stream") == stream.name
            ):
                watermark = max(watermark, int(event["offset"]))
            elif (
                name == "task_dispatch"
                and event.get("shard") == stream.name
            ):
                dispatched[event["task_id"]] = (
                    int(event["start"]), int(event["end"])
                )
            elif name == "task_done" and event.get("task_id") in dispatched:
                completed.append(dispatched[event["task_id"]])
        manager = cls(
            stream,
            records_per_task=records_per_task,
            lookahead_tasks=lookahead_tasks,
            task_timeout_s=task_timeout_s,
            max_task_retries=max_task_retries,
        )
        manager._watermark = watermark
        manager._next_offset = watermark
        for lo, hi in completed:
            if hi > watermark:
                manager._merge_completed_locked(
                    max(lo, watermark), hi
                )
        # A completed range flush against the watermark advances it right
        # away (journaled below alongside the resume marker).
        resume_events: List[dict] = []
        manager._evict_watermark_locked(resume_events)
        manager._next_offset = manager._watermark
        manager._finished_record_count = manager._watermark + sum(
            hi - lo for lo, hi in manager._completed
        )
        for event in resume_events:
            obs.journal().record(**event)
        obs.journal().record(
            "task_progress_resume",
            epoch=0,
            todo=0,
            finished_records=manager._finished_record_count,
            stream=stream.name,
            watermark=manager._watermark,
            next_offset=manager._next_offset,
            completed_above_watermark=len(manager._completed),
        )
        logger.info(
            "Resumed stream %s from journal: watermark %d, %d completed "
            "ranges above it",
            stream.name, manager._watermark, len(manager._completed),
        )
        return manager
