"""In-process metric history: the ring-buffer sampler behind the SLO plane.

The port's copy of ``elasticdl_tpu/obs/history.py``, stdlib only: it imports nothing of the
JAX package.

The registry (`obs/metrics.py`) answers "what is the value NOW"; the
journal answers "what happened" after the fact.  Burn-rate alerting
(`obs/slo.py`) needs the piece in between: a bounded window of recent
samples per series, queryable by time window.  `MetricsHistory` is that
window — it polls a `MetricsRegistry` on a caller-driven tick and keeps
the last N samples of every (metric, labels) series in a deque ring.

Clock discipline matches `FreshnessTracker.evaluate(now)` and
`faults.due`: `sample(now)` takes the timestamp from the CALLER, so a
chaos driver replays the exact tick timeline it injected faults on and
the determinism analyzer rule stays green.  A production tick thread
(`SLOPlane.start`) simply feeds `time.monotonic()`.

Boundedness is a hard contract, mirroring the metric-label-cardinality
rule's intent at the storage layer:

- per-series: ``max_samples`` ring (old samples fall off the back)
- per-history: ``max_series`` series; when label-set churn pushes the
  count over, the least-recently-updated series are evicted (a label
  set the registry stopped producing stops being refreshed and ages
  out first)
- clock regressions clamp: a `now` earlier than the last accepted
  sample time is pinned to it, so per-series timestamps are
  monotonically non-decreasing and windowed queries never see
  negative spans

Histograms are flattened to two counter-kind series, ``<name>_count``
and ``<name>_sum`` — enough for rate/ratio queries without storing
per-bucket rings.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

from elasticdl_tpu_torch.analysis.runtime import make_lock



class _Series:
    """One (metric, labelset) ring: (t, value) samples, newest last."""

    __slots__ = ("name", "kind", "labels", "samples")

    def __init__(self, name: str, kind: str, labels: Dict[str, str],
                 max_samples: int):
        self.name = name
        self.kind = kind
        self.labels = labels
        self.samples: deque = deque(maxlen=max_samples)


def _quantile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile of a non-empty sample list."""
    ordered = sorted(values)
    if len(ordered) == 1:
        return ordered[0]
    q = min(1.0, max(0.0, float(q)))
    pos = q * (len(ordered) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    frac = pos - lo
    return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


class MetricsHistory:
    """Bounded per-series sample windows over a `MetricsRegistry`.

    Thread-safe: one sampler tick plus any number of query readers.
    Registry snapshots are taken OUTSIDE the history lock (gauge
    `set_function` callbacks may grab service locks of their own).
    """

    def __init__(self, registry=None, max_series: int = 256,
                 max_samples: int = 512):
        if registry is None:
            from elasticdl_tpu_torch import obs
            registry = obs.registry()
        self.registry = registry
        self._max_series = max(1, int(max_series))
        self._max_samples = max(2, int(max_samples))
        self._lock = make_lock("MetricsHistory._lock")
        # (name, labelkey) -> _Series, in least-recently-updated order.
        self._series: "OrderedDict[Tuple[str, str], _Series]" = OrderedDict()  # guarded-by: _lock
        self._last_now = float("-inf")  # guarded-by: _lock
        self._evicted_total = 0  # guarded-by: _lock

    # -- sampling --------------------------------------------------------

    def sample(self, now: float) -> float:
        """Poll every registry series once at time `now` (caller clock).

        Returns the timestamp actually recorded — `now`, unless a clock
        regression clamped it to the previous sample time."""
        rows: List[Tuple[str, str, Tuple[str, ...], str, float]] = []
        for metric in self.registry.collect():
            dump = metric.to_dict()
            kind = dump.get("type", "gauge")
            for labelkey, value in dump.get("values", {}).items():
                if kind == "histogram":
                    rows.append((metric.name + "_count", "counter",
                                 metric.labelnames, labelkey,
                                 float(value["count"])))
                    rows.append((metric.name + "_sum", "counter",
                                 metric.labelnames, labelkey,
                                 float(value["sum"])))
                else:
                    rows.append((metric.name, kind, metric.labelnames,
                                 labelkey, float(value)))
        with self._lock:
            now = float(now)
            if now < self._last_now:
                now = self._last_now  # clock regression: clamp, never rewind
            else:
                self._last_now = now
            for name, kind, labelnames, labelkey, value in rows:
                key = (name, labelkey)
                series = self._series.get(key)
                if series is None:
                    labels = (
                        dict(zip(labelnames, labelkey.split(",")))
                        if labelkey else {}
                    )
                    series = _Series(name, kind, labels, self._max_samples)
                self._series[key] = series
                self._series.move_to_end(key)
                series.samples.append((now, value))
            while len(self._series) > self._max_series:
                self._series.popitem(last=False)
                self._evicted_total += 1
        return now

    # -- readouts --------------------------------------------------------

    def last_sample_time(self) -> float:
        with self._lock:
            return self._last_now

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def evicted_total(self) -> int:
        with self._lock:
            return self._evicted_total

    def _select(self, name: str, labels: Optional[dict]):
        """Copies of matching series under the lock: (labels, samples)."""
        out = []
        with self._lock:
            for (n, _labelkey), series in self._series.items():
                if n != name:
                    continue
                if labels is not None and any(
                    series.labels.get(k) != str(v) for k, v in labels.items()
                ):
                    continue
                out.append((dict(series.labels), list(series.samples)))
            last_now = self._last_now
        return out, last_now

    def _window(self, samples, window_s: float, now: float,
                keep_baseline: bool = False):
        """Samples with t in [now - window_s, now]; with `keep_baseline`,
        also the newest sample BEFORE the window (counter-delta anchor)."""
        horizon = now - float(window_s)
        kept = []
        baseline = None
        for t, v in samples:
            if t > now:
                continue
            if t >= horizon:
                kept.append((t, v))
            else:
                baseline = (t, v)
        if keep_baseline and baseline is not None:
            kept.insert(0, baseline)
        return kept

    def latest(self, name: str, labels: Optional[dict] = None
               ) -> Optional[float]:
        picked, _ = self._select(name, labels)
        best: Optional[Tuple[float, float]] = None
        for _lbl, samples in picked:
            if samples and (best is None or samples[-1][0] >= best[0]):
                best = samples[-1]
        return best[1] if best else None

    def delta(self, name: str, window_s: float, now: Optional[float] = None,
              labels: Optional[dict] = None) -> float:
        """Counter increase over the window, summed across matching
        series, reset-aware: a sample below its predecessor restarts
        accumulation from zero (the counter was recreated)."""
        picked, last_now = self._select(name, labels)
        now = last_now if now is None else float(now)
        total = 0.0
        for _lbl, samples in picked:
            windowed = self._window(samples, window_s, now,
                                    keep_baseline=True)
            prev = None
            for _t, v in windowed:
                if prev is not None:
                    total += (v - prev) if v >= prev else v
                prev = v
        return total

    def rate(self, name: str, window_s: float, now: Optional[float] = None,
             labels: Optional[dict] = None) -> float:
        """`delta` normalized by the window span (per-second rate)."""
        window_s = float(window_s)
        if window_s <= 0:
            return 0.0
        return self.delta(name, window_s, now, labels) / window_s

    def quantile_over_time(self, name: str, q: float, window_s: float,
                           now: Optional[float] = None,
                           labels: Optional[dict] = None
                           ) -> Optional[float]:
        """Quantile of every in-window sample value, pooled across
        matching series (gauge kind; use labels to isolate one)."""
        picked, last_now = self._select(name, labels)
        now = last_now if now is None else float(now)
        values: List[float] = []
        for _lbl, samples in picked:
            values.extend(v for _t, v in self._window(samples, window_s, now))
        if not values:
            return None
        return _quantile(values, q)

    def threshold_fraction(self, name: str, window_s: float,
                           threshold: float,
                           now: Optional[float] = None,
                           labels: Optional[dict] = None,
                           above: bool = True) -> Optional[float]:
        """Fraction of in-window samples beyond `threshold` — the
        bad-minutes estimator for threshold-kind SLOs.  None with no
        samples in the window (no data is not a breach)."""
        picked, last_now = self._select(name, labels)
        now = last_now if now is None else float(now)
        total = 0
        bad = 0
        for _lbl, samples in picked:
            for _t, v in self._window(samples, window_s, now):
                total += 1
                if (v > threshold) if above else (v < threshold):
                    bad += 1
        if total == 0:
            return None
        return bad / total

    def sparkline(self, name: str, n: int = 32,
                  labels: Optional[dict] = None) -> List[float]:
        """Last-N values of the first matching series (render-ready)."""
        picked, _ = self._select(name, labels)
        if not picked:
            return []
        _lbl, samples = picked[0]
        return [v for _t, v in samples[-max(1, int(n)):]]

    def series_deltas(self, name: str, window_s: float,
                      now: Optional[float] = None) -> List[Tuple[dict, float]]:
        """Per-series (labels, increase) over the window — the
        offending-series attribution input."""
        picked, last_now = self._select(name, None)
        now = last_now if now is None else float(now)
        out = []
        for lbl, samples in picked:
            windowed = self._window(samples, window_s, now,
                                    keep_baseline=True)
            inc = 0.0
            prev = None
            for _t, v in windowed:
                if prev is not None:
                    inc += (v - prev) if v >= prev else v
                prev = v
            out.append((lbl, inc))
        return out

    def snapshot(self, max_series: int = 16, samples_per_series: int = 32,
                 names: Optional[Sequence[str]] = None) -> List[dict]:
        """Bounded JSON-able dump of the newest series (the `/slo`
        endpoint payload) — metric name, labels, last-N (t, v) points.
        No paths, no hosts: label values are the only free text and the
        cardinality rule keeps those enumerable."""
        wanted = set(names) if names is not None else None
        out = []
        with self._lock:
            for (name, _labelkey), series in reversed(self._series.items()):
                if wanted is not None and name not in wanted:
                    continue
                if len(out) >= max(0, int(max_series)):
                    break
                points = list(series.samples)[-max(1, int(samples_per_series)):]
                out.append({
                    "metric": name,
                    "kind": series.kind,
                    "labels": dict(series.labels),
                    "points": [[round(t, 6), v] for t, v in points],
                })
        return out
