"""Unbounded stream sources for the continuous train->serve loop: the
port's copy of ``elasticdl_tpu/data/stream.py``.

A *stream* is an append-only record log: offsets are dense integers,
each record carries an **event time** (when the click happened), and
production never ends.  The master's streaming dispatcher
(``master/stream.py``) cuts the log into the same shard-task ranges the
bounded dispatcher uses: the stream is the dataset, the offsets are the
shard.

``SyntheticClickStream`` is the deterministic test double: production
follows a piecewise-constant **rate schedule** on a virtual timeline the
driver owns (``advance(dt)``; no wall clock anywhere, so a chaos run
replays exactly), and ``event_time(offset)`` inverts the schedule.  A
mid-run rate spike is one extra schedule phase; a stalled source (the
``stream.source`` fault site, kind ``latency``) shifts *production*
without shifting event times, which is how a wedged upstream pipe shows
up as event-time lag.

Reading a task's range rides ``data/pipeline.Prefetcher`` (bounded
lookahead, synchronous close-drain), so worker churn never leaks a stale
window across a rendezvous generation.  Everything here is numpy and
the standard library: a batch reaches the card through the trainer.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.pipeline import Prefetcher

logger = get_logger("data.stream")


class SyntheticClickStream:
    """Deterministic unbounded click stream on a driver-owned timeline.

    `schedule` is a sequence of ``(duration_s, records_per_s)`` phases;
    the LAST phase's rate continues forever (a stream has no end).  All
    timing is virtual: the driver calls `advance(dt)` to move the
    production clock, so availability, event times, and stalls replay
    bit-exactly regardless of host speed.
    """

    def __init__(
        self,
        schedule: Sequence[Tuple[float, float]],
        name: str = "stream",
        label_delay_s: float = 0.0,
    ):
        if not schedule:
            raise ValueError("stream schedule needs at least one phase")
        for duration, rate in schedule:
            if duration < 0 or rate < 0:
                raise ValueError(f"bad schedule phase ({duration}, {rate})")
        if schedule[-1][1] <= 0:
            raise ValueError("final schedule phase must have rate > 0")
        if label_delay_s < 0:
            raise ValueError("label_delay_s must be >= 0")
        self.name = name
        self._schedule: List[Tuple[float, float]] = [
            (float(d), float(r)) for d, r in schedule
        ]
        self._label_delay_s = float(label_delay_s)
        self._elapsed = 0.0
        self._stall_s = 0.0
        self._closed = False

    # -- the driver-owned clock -----------------------------------------

    def advance(self, dt_s: float) -> None:
        """Move the virtual production clock forward."""
        if dt_s < 0:
            raise ValueError("time only moves forward")
        self._elapsed += dt_s
        # Call-count-triggered stall (`stream.source:latency=SECONDS@N`):
        # the Nth advance wedges the source for SECONDS of virtual time.
        spec = faults.fire("stream.source")
        if spec is not None and spec.kind == "latency":
            self.stall(float(spec.arg or 1.0))

    def stall(self, seconds: float) -> None:
        """A wedged upstream pipe: production stops for `seconds` of
        virtual time.  Event times are unaffected — the records were
        already minted upstream, they just arrive late (that is what
        event-time lag measures).  Drivers applying schedule-based
        `stream.source` specs (`faults.due`) call this directly."""
        self._stall_s += float(seconds)
        logger.warning(
            "FAULT INJECTION: stream %s stalled %.3fs (total stall %.3fs)",
            self.name, seconds, self._stall_s,
        )

    @property
    def elapsed_s(self) -> float:
        return self._elapsed

    def close(self) -> None:
        """Bounded-test escape hatch: no records beyond the current
        availability; the dispatcher may then drain and finish."""
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    # -- production / event-time math -----------------------------------

    def records_until(self, elapsed_s: float) -> int:
        """Records produced by `elapsed_s` on an unstalled timeline
        (the integral of the rate schedule)."""
        remaining = max(0.0, float(elapsed_s))
        records = 0.0
        for i, (duration, rate) in enumerate(self._schedule):
            last = i == len(self._schedule) - 1
            span = remaining if last else min(remaining, duration)
            records += span * rate
            remaining -= span
            if remaining <= 0:
                break
        return int(records)

    def available(self) -> int:
        """Records that have ARRIVED by now: production shifted by every
        stall so far.  Monotone in elapsed time."""
        return self.records_until(self._elapsed - self._stall_s)

    @property
    def label_delay_s(self) -> float:
        return self._label_delay_s

    def labels_available(self) -> int:
        """Records whose delayed feedback label has ARRIVED by now: the
        label for record `o` lands `label_delay_s` of virtual time after
        the record itself (clicks are attributed late), and a stalled
        source delays the labels with the records.  Monotone, and always
        <= `available()` — the label watermark trails the record
        watermark by construction."""
        return self.records_until(
            self._elapsed - self._stall_s - self._label_delay_s
        )

    def labels_for(
        self,
        lo: int,
        hi: int,
        vocab_size: int,
        fields: Sequence[str] = ("user", "item"),
    ) -> Optional[np.ndarray]:
        """Delayed-feedback labels for offsets [lo, hi): the same
        offset-pure generator family as `synthetic_click_batch`, routed
        through the `stream.labels` fault site (`feedback_labels`) so a
        chaos run can poison (flip) or black out the label feed.  The
        caller owns the watermark discipline — only ask for ranges below
        `labels_available()`."""
        return feedback_labels(
            synthetic_click_batch(lo, hi, vocab_size, fields)
        )

    def event_time(self, offset: int) -> float:
        """Event time (virtual seconds since stream start) of record
        `offset` — the schedule's inverse, stall-independent."""
        offset = max(0, int(offset))
        produced = 0.0
        start = 0.0
        for i, (duration, rate) in enumerate(self._schedule):
            last = i == len(self._schedule) - 1
            phase_records = float("inf") if last else duration * rate
            if offset < produced + phase_records:
                if rate <= 0:
                    return start + duration
                return start + (offset - produced) / rate
            produced += phase_records
            start += duration
        return start

    # -- serialisation (master resume) ----------------------------------

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "schedule": [list(p) for p in self._schedule],
            "label_delay_s": self._label_delay_s,
            "elapsed": self._elapsed,
            "stall_s": self._stall_s,
            "closed": self._closed,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "SyntheticClickStream":
        stream = cls(
            [tuple(p) for p in obj["schedule"]],
            name=obj.get("name", "stream"),
            label_delay_s=float(obj.get("label_delay_s", 0.0)),
        )
        stream._elapsed = float(obj.get("elapsed", 0.0))
        stream._stall_s = float(obj.get("stall_s", 0.0))
        stream._closed = bool(obj.get("closed", False))
        return stream


def synthetic_click_batch(
    lo: int,
    hi: int,
    vocab_size: int,
    fields: Sequence[str] = ("user", "item"),
) -> dict:
    """Deterministic feature batch for offsets [lo, hi): each record's
    ids are a pure function of its offset, so any worker that replays a
    requeued range trains on the identical batch (the at-least-once
    replay contract extends to the data)."""
    offsets = np.arange(int(lo), int(hi), dtype=np.int64)
    return {
        name: ((offsets * (31 + 17 * i) + 7 * i) % vocab_size).astype(
            np.int64
        )
        for i, name in enumerate(fields)
    }


def click_label_rule(features: dict) -> np.ndarray:
    """Deterministic ground-truth click label per row: a pure function
    of the integer feature ids, so it is learnable from the embeddings,
    replayable offline, and IDENTICAL wherever it is evaluated — the
    stream's delayed-feedback channel, the JAX package's load
    generator and an offline AUC audit of the same joined set all agree
    element-wise.  ~31% positive rate (the `< 30 of 97` residue)."""
    acc = None
    for i, name in enumerate(sorted(features)):
        arr = np.asarray(features[name])
        if not np.issubdtype(arr.dtype, np.integer):
            continue
        ids = arr.astype(np.int64)
        if ids.ndim == 1:
            ids = ids[:, None]
        weights = 13 + 7 * np.arange(ids.shape[-1], dtype=np.int64)
        contrib = (ids * weights).sum(axis=-1) * (1 + i)
        acc = contrib if acc is None else acc + contrib
    if acc is None:
        raise ValueError(
            "click_label_rule needs at least one integer feature array"
        )
    return ((acc % 97) < 30).astype(np.float32)


def feedback_labels(features: dict) -> Optional[np.ndarray]:
    """The label FEED: `click_label_rule` routed through the
    ``stream.labels`` fault site.  kind ``truncate`` -> outage (None:
    no labels arrive for this range this poll); kind ``error`` ->
    poisoned feed (flipped labels — the canary-gate chaos scenario, a
    label-flipped shard entering training)."""
    spec = faults.fire("stream.labels")
    if spec is not None and spec.kind == "truncate":
        logger.warning("FAULT INJECTION: label feed outage (range withheld)")
        return None
    labels = click_label_rule(features)
    if spec is not None and spec.kind == "error":
        logger.warning(
            "FAULT INJECTION: label feed poisoned (labels flipped, %s)",
            spec.arg or "flip",
        )
        labels = (1.0 - labels).astype(labels.dtype)
    return labels


def iter_stream_batches(
    make_batch: Callable[[int, int], object],
    lo: int,
    hi: int,
    batch_size: int,
    prefetch: int = 2,
) -> Iterator[object]:
    """One task range [lo, hi) as a prefetched batch iterator: the
    stream-worker analogue of the bounded pipeline's readahead.  The
    Prefetcher's synchronous close() drain runs on generator close, so a
    churned worker abandoning the range leaves no producer thread and no
    buffered window behind."""

    def windows():
        for start in range(int(lo), int(hi), int(batch_size)):
            yield make_batch(start, min(start + batch_size, int(hi)))

    prefetcher = Prefetcher(windows(), max_inflight=prefetch)
    try:
        for batch in prefetcher:
            yield batch
    finally:
        prefetcher.close()
