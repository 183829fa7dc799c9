"""Stdlib-only, thread-safe metrics registry (Counter / Gauge / Histogram):
the port's copy of ``elasticdl_tpu/obs/metrics.py``.

- **stdlib only**, **thread-safe**: batcher, frontend handler threads and
  the exporter's scrape threads touch metrics concurrently; every metric
  guards its samples with its own lock;
- **scrapes never re-enter instrumented services while holding a metric
  lock**: function gauges (``set_function``) are evaluated with no
  registry or metric lock held;
- **bounded label cardinality**: labels are small enums; unbounded values
  belong in the event journal.

Exposition follows the Prometheus text format (0.0.4), byte for byte the
JAX package's: ``# HELP``/``# TYPE`` headers, ``name{label="value"}
value`` samples, and the ``_bucket``/``_sum``/``_count`` histogram
triple with cumulative ``le`` buckets.
"""

from __future__ import annotations

import re
import time
from bisect import bisect_left
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from elasticdl_tpu_torch.analysis.runtime import make_lock


#: Default duration buckets (seconds): spans sub-millisecond RPC handling
#: through multi-minute re-rendezvous / checkpoint restores.
DURATION_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label_value(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _format_number(value: float) -> str:
    value = float(value)
    if value != value:  # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if value.is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


class _Metric:
    """Shared name/help/label plumbing; subclasses own the samples."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"Invalid metric name {name!r}")
        for label in labelnames:
            if not _LABEL_RE.match(label) or label == "le":
                raise ValueError(f"Invalid label name {label!r} for {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = make_lock(f"obs.{type(self).__name__}._lock")

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(labels)}"
            )
        return tuple(str(labels[name]) for name in self.labelnames)

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = [
            f'{name}="{_escape_label_value(value)}"'
            for name, value in zip(self.labelnames, key)
        ]
        if extra:
            parts.append(extra)
        parts.sort()
        return "{" + ",".join(parts) + "}" if parts else ""

    def header_lines(self) -> List[str]:
        lines = []
        if self.help:
            escaped = self.help.replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {self.name} {escaped}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines

    def expose_lines(self) -> List[str]:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count (per labelset)."""

    kind = "counter"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}  # guarded-by: _lock

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(f"Counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def _snapshot(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            if not self._values and not self.labelnames:
                return {(): 0.0}  # unlabeled counters export even at zero
            return dict(self._values)

    def to_dict(self) -> dict:
        return {
            "type": self.kind,
            "help": self.help,
            "values": {",".join(key) if key else "": value
                       for key, value in sorted(self._snapshot().items())},
        }

    def expose_lines(self) -> List[str]:
        return [
            f"{self.name}{self._label_str(key)} {_format_number(value)}"
            for key, value in sorted(self._snapshot().items())
        ]


class Gauge(_Metric):
    """Point-in-time value; supports explicit set/inc/dec and callback
    gauges (`set_function`) evaluated at scrape time WITHOUT any metric
    lock held (callbacks may take service locks)."""

    kind = "gauge"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}  # guarded-by: _lock
        self._functions: Dict[Tuple[str, ...], Callable[[], float]] = {}  # guarded-by: _lock

    def set(self, value: float, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, value: float = 1.0, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels):
        self.inc(-value, **labels)

    def set_function(self, fn: Callable[[], float], **labels):
        """Bind a callback sampled at collect time.  Re-binding the same
        labelset replaces the callback (a re-created service instance,
        e.g. a resumed TaskManager, takes over its gauges)."""
        key = self._key(labels)
        with self._lock:
            self._functions[key] = fn

    def value(self, **labels) -> Optional[float]:
        key = self._key(labels)
        with self._lock:
            fn = self._functions.get(key)
            if fn is None:
                return self._values.get(key)
        return float(fn())  # outside the lock: fn may take service locks

    def _snapshot(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            values = dict(self._values)
            functions = dict(self._functions)
        for key, fn in functions.items():
            try:
                values[key] = float(fn())
            except Exception:
                # A dying callback (service mid-teardown) must not break
                # the whole scrape; the stale explicit value (if any)
                # stands — `values` already holds it — else the sample
                # is dropped.
                pass
        return values

    def to_dict(self) -> dict:
        return {
            "type": self.kind,
            "help": self.help,
            "values": {",".join(key) if key else "": value
                       for key, value in sorted(self._snapshot().items())},
        }

    def expose_lines(self) -> List[str]:
        return [
            f"{self.name}{self._label_str(key)} {_format_number(value)}"
            for key, value in sorted(self._snapshot().items())
        ]


class Histogram(_Metric):
    """Distribution with explicit bucket boundaries (upper bounds,
    seconds by default).  Exposes the Prometheus cumulative-`le` triple."""

    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=DURATION_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(set(float(b) for b in buckets)))
        if not bounds:
            raise ValueError(f"Histogram {self.name} needs >= 1 bucket")
        self.buckets = bounds
        # key -> [per-bucket counts..., +Inf count]; sums/counts separate.
        self._bucket_counts: Dict[Tuple[str, ...], List[int]] = {}  # guarded-by: _lock
        self._sums: Dict[Tuple[str, ...], float] = {}  # guarded-by: _lock
        self._counts: Dict[Tuple[str, ...], int] = {}  # guarded-by: _lock

    def observe(self, value: float, **labels):
        key = self._key(labels)
        value = float(value)
        index = bisect_left(self.buckets, value)
        with self._lock:
            counts = self._bucket_counts.get(key)
            if counts is None:
                counts = self._bucket_counts[key] = [0] * (
                    len(self.buckets) + 1
                )
            counts[index] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._counts[key] = self._counts.get(key, 0) + 1

    def count(self, **labels) -> int:
        key = self._key(labels)
        with self._lock:
            return self._counts.get(key, 0)

    def sum(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._sums.get(key, 0.0)

    def _snapshot(self):
        with self._lock:
            return (
                {key: list(counts) for key, counts in self._bucket_counts.items()},
                dict(self._sums),
                dict(self._counts),
            )

    def to_dict(self) -> dict:
        bucket_counts, sums, counts = self._snapshot()
        return {
            "type": self.kind,
            "help": self.help,
            "buckets": list(self.buckets),
            "values": {
                ",".join(key) if key else "": {
                    "count": counts[key], "sum": sums[key],
                    "bucket_counts": bucket_counts[key],
                }
                for key in sorted(bucket_counts)
            },
        }

    def expose_lines(self) -> List[str]:
        bucket_counts, sums, counts = self._snapshot()
        lines = []
        for key in sorted(bucket_counts):
            cumulative = 0
            for bound, bucket in zip(self.buckets, bucket_counts[key]):
                cumulative += bucket
                label_str = self._label_str(
                    key, f'le="{_format_number(bound)}"'
                )
                lines.append(f"{self.name}_bucket{label_str} {cumulative}")
            total = counts[key]
            label_str = self._label_str(key, 'le="+Inf"')
            lines.append(f"{self.name}_bucket{label_str} {total}")
            lines.append(
                f"{self.name}_sum{self._label_str(key)} "
                f"{_format_number(sums[key])}"
            )
            lines.append(f"{self.name}_count{self._label_str(key)} {total}")
        return lines


class MetricsRegistry:
    """Name -> metric map with get-or-create semantics: instrumented
    services re-register their metrics on every construction (tests,
    a restarted replica's objects) and get the same objects back."""

    def __init__(self):
        self._lock = make_lock("MetricsRegistry._lock")
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: _lock

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"Metric {name} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}"
                    )
                return existing
            metric = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name, help="", labelnames=(), buckets=DURATION_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[name] for name in sorted(self._metrics)]

    def to_dict(self) -> dict:
        """JSON-able dump of every metric (the ``/debug/vars`` payload)."""
        return {metric.name: metric.to_dict() for metric in self.collect()}

    def render_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4) of every registered metric."""
        lines: List[str] = []
        for metric in self.collect():
            lines.extend(metric.header_lines())
            lines.extend(metric.expose_lines())
        return "\n".join(lines) + "\n"




class RateTracker:
    """Sliding-window throughput over an event feed: ``add(n)`` on each
    report, ``rate()`` = events/second over the trailing window (the
    master's job-wide steps/s and examples/s)."""

    def __init__(self, window_s: float = 60.0):
        self._window_s = float(window_s)
        self._lock = make_lock("obs.RateTracker._lock")
        self._samples: deque = deque()  # (t, amount)

    def _prune_locked(self, now: float):
        horizon = now - self._window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def add(self, amount: float, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        with self._lock:
            self._samples.append((now, float(amount)))
            self._prune_locked(now)

    def rate(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune_locked(now)
            total = sum(amount for _t, amount in self._samples)
        return total / self._window_s
