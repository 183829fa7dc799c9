"""Served-vs-dropped availability ledger for the serving plane: the
port's copy of ``elasticdl_tpu/serving/ledger.py``'s
``AvailabilityLedger``.

"What fraction of admitted traffic was served", plus where request wall
time went.  Every finished request books:

- an outcome (``served`` / ``dropped`` / ``shed`` / ``error``: a bounded
  enum, so it may ride a metric label), and
- its per-phase seconds over ``REQUEST_PHASES`` (queue / batch / execute
  / respond, stamped by the batcher).

Exported via the obs registry (scraped from the replica's exporter):

- ``elasticdl_serving_availability_ratio``: served / all finished;
- ``elasticdl_serving_requests_total{outcome=}`` and
  ``elasticdl_serving_rows_total{outcome=}``;
- ``elasticdl_serving_phase_seconds_total{phase=}``;
- ``elasticdl_serving_latency_p50_ms`` / ``..._p99_ms``: host-side
  percentiles over a sliding window;
- ``elasticdl_serving_qps``: served requests/s over the same window.

Requests finish on the batcher thread while the exporter scrapes from
its own; the lock covers the window and the counters.  The JAX package's
``ExemplarSampler`` waits for the tracing plane (ROADMAP.md Queue 1
item 8).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from elasticdl_tpu_torch import obs

#: The exclusive sub-phases of one serving request's wall time (the JAX
#: package's ``obs/stepstats.py`` ``REQUEST_PHASES``): ``queue`` =
#: admission to batch formation, ``batch`` = stacking + bucket padding,
#: ``execute`` = the inference dispatch, ``respond`` = result hand-off.
REQUEST_PHASES = ("queue", "batch", "execute", "respond")

#: Bounded outcome enum (metric-label safe).
OUTCOMES = ("served", "dropped", "shed", "error")

#: Sliding latency/QPS window (requests).
WINDOW = 2048


class AvailabilityLedger:
    """Process-wide accounting of request outcomes and phase time."""

    def __init__(self, clock=time.monotonic, registry=None):
        # `registry` defaults to the process obs registry (the replica
        # path).  Tests inject private registries so several
        # replica-shaped ledgers can coexist in one process.
        if registry is None:
            registry = obs.registry()
        self._clock = clock
        self._lock = threading.Lock()
        self._outcomes = {o: 0 for o in OUTCOMES}  # guarded-by: _lock
        self._rows = {o: 0 for o in OUTCOMES}  # guarded-by: _lock
        self._phase_s = {p: 0.0 for p in REQUEST_PHASES}  # guarded-by: _lock
        # (finish_ts, latency_s, phases) of recent served requests; the
        # per-request phases dict feeds the per-phase p99 split.
        self._window: deque = deque(maxlen=WINDOW)  # guarded-by: _lock
        self._m_requests = registry.counter(
            "elasticdl_serving_requests_total",
            "Finished predict requests, by outcome",
            labelnames=("outcome",),
        )
        self._m_rows = registry.counter(
            "elasticdl_serving_rows_total",
            "Finished predict rows, by outcome",
            labelnames=("outcome",),
        )
        self._m_phase = registry.counter(
            "elasticdl_serving_phase_seconds_total",
            "Cumulative request wall time, by request phase",
            labelnames=("phase",),
        )
        registry.gauge(
            "elasticdl_serving_availability_ratio",
            "served / all finished requests (1.0 = nothing dropped)",
        ).set_function(self.availability_ratio)
        registry.gauge(
            "elasticdl_serving_latency_p50_ms",
            "p50 served-request latency over the sliding window",
        ).set_function(lambda: self.latency_percentile_ms(50.0))
        registry.gauge(
            "elasticdl_serving_latency_p99_ms",
            "p99 served-request latency over the sliding window",
        ).set_function(lambda: self.latency_percentile_ms(99.0))
        registry.gauge(
            "elasticdl_serving_qps",
            "Served requests/s over the sliding window",
        ).set_function(self.qps)

    # -- recording ------------------------------------------------------

    def record_request(
        self, phases: Dict[str, float], outcome: str, rows: int = 1
    ):
        """Book one finished request (the MicroBatcher's on_request
        callback signature).  Unknown phases are ignored; unknown
        outcomes count as 'error' rather than raising on the batcher
        thread."""
        if outcome not in self._outcomes:
            outcome = "error"
        latency = sum(
            float(phases.get(p, 0.0)) for p in REQUEST_PHASES
        )
        now = self._clock()
        with self._lock:
            self._outcomes[outcome] += 1
            self._rows[outcome] += int(rows)
            for phase in REQUEST_PHASES:
                if phase in phases:
                    self._phase_s[phase] += float(phases[phase])
            if outcome == "served":
                self._window.append((now, latency, dict(phases)))
        self._m_requests.inc(outcome=outcome)
        self._m_rows.inc(int(rows), outcome=outcome)
        for phase in REQUEST_PHASES:
            if phase in phases:
                self._m_phase.inc(float(phases[phase]), phase=phase)

    def record_shed(self, rows: int = 1):
        """Book an admission-rejected request (the MicroBatcher's
        on_shed callback; the batcher itself journals the
        ``request_shed`` event)."""
        self.record_request({}, "shed", rows)

    # -- readouts -------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._outcomes)

    def availability_ratio(self) -> float:
        with self._lock:
            total = sum(self._outcomes.values())
            if total == 0:
                return 1.0
            return self._outcomes["served"] / total

    def latency_percentile_ms(self, pct: float) -> float:
        with self._lock:
            latencies = sorted(latency for _, latency, _ in self._window)
        if not latencies:
            return 0.0
        rank = min(
            len(latencies) - 1, int(round(pct / 100.0 * (len(latencies) - 1)))
        )
        return latencies[rank] * 1e3

    def phase_percentile_ms(self, pct: float) -> Dict[str, float]:
        """Per-phase percentile over the served sliding window — the
        p99 phase-attribution split ("p99 is mostly queue")."""
        with self._lock:
            samples = [phases for _, _, phases in self._window]
        split: Dict[str, float] = {}
        for phase in REQUEST_PHASES:
            values = sorted(float(p.get(phase, 0.0)) for p in samples)
            if not values:
                split[phase] = 0.0
                continue
            rank = min(
                len(values) - 1,
                int(round(pct / 100.0 * (len(values) - 1))),
            )
            split[phase] = values[rank] * 1e3
        return split

    def qps(self, horizon_s: float = 10.0) -> float:
        now = self._clock()
        with self._lock:
            recent = [ts for ts, _, _ in self._window if now - ts <= horizon_s]
        if not recent:
            return 0.0
        span = max(1e-6, now - min(recent))
        return len(recent) / span

    def snapshot(self) -> dict:
        """One bounded dict for the replica's serving_telemetry journal
        event (per-replica detail rides the journal, never labels)."""
        with self._lock:
            counts = dict(self._outcomes)
            phases = {p: round(s, 6) for p, s in self._phase_s.items()}
        return {
            "counts": counts,
            "phase_seconds": phases,
            "availability_ratio": round(self.availability_ratio(), 6),
            "p50_ms": round(self.latency_percentile_ms(50.0), 3),
            "p99_ms": round(self.latency_percentile_ms(99.0), 3),
            "phase_p99_ms": {
                p: round(v, 3)
                for p, v in self.phase_percentile_ms(99.0).items()
            },
            "qps": round(self.qps(), 2),
        }


_ledger: Optional[AvailabilityLedger] = None


def ledger() -> AvailabilityLedger:
    """The process singleton (one serving replica per process)."""
    global _ledger
    if _ledger is None:
        _ledger = AvailabilityLedger()
    return _ledger


def reset_ledger():
    """Test hook: drop the singleton so a fresh registry snapshot can
    re-register its gauges."""
    global _ledger
    _ledger = None
