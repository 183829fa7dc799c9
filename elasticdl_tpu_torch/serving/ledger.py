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
its own; the lock covers the window and the counters.

``ExemplarSampler`` (JAX ``serving/ledger.py:228-390``) is the request
tracing plane's sensor: of the requests that carry a trace id it keeps
the head (1 in ``head_every``), the tail (slower than the threshold) and
every failed one, and journals each as a ``request_trace`` event plus
its span tree (``rpc.predict`` -> ``serve.batch`` -> ``serve.execute``,
``serve.queue`` and ``serve.respond`` under ``rpc.predict``).  A
sampled served request's predictions and features also enter the
model-quality plane's ``QualityLedger`` (``obs/quality.py``) when the
sampler has one, so label joins score exactly the population the trace
plane exemplifies; a failing note is logged and ignored.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.obs import tracing

logger = get_logger("serving.ledger")

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
        self._lock = make_lock("AvailabilityLedger._lock")
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


class ExemplarSampler:
    """Bounded ring of completed request records with a three-policy
    sampling decision:

    - **head**: deterministic 1-in-``head_every`` of traced requests
      (a counter, not a coin flip — the same request stream always
      journals the same head set);
    - **tail**: latency above ``tail_threshold_ms`` (wired to the
      replica's ``--slo_p99_ms`` target, so "slow" means "slow against
      the SLO the fleet pages on");
    - **outcome**: every shed / dropped / error request (failures are
      always evidence).

    A sampled request journals one ``request_trace`` event plus its
    deferred span set (``rpc.predict`` -> ``serve.queue`` ->
    ``serve.execute`` -> ``serve.respond``), and the shared
    ``serve.batch`` span its bucket rode — journaled ONCE per batch, on
    the first sampled member (a bounded id ring dedupes).  Unsampled
    requests write nothing: journaling stays O(sampled).

    Requests without a trace id (clients that sent no
    ``elasticdl-trace-id`` header) are invisible to the sampler — there is no
    id to journal, and skipping them keeps the head counter pure in the
    *traced* stream.

    All clocks are read by the caller (the frontend and the batcher)
    and arrive as wall stamps inside the prepared span payloads; this
    class only counts, compares and journals.
    """

    def __init__(
        self,
        head_every: int = 128,
        tail_threshold_ms: float = 0.0,
        capacity: int = 64,
        replica_id: Optional[int] = None,
        journal=None,
        quality=None,
    ):
        self._head_every = max(0, int(head_every))
        self._tail_threshold_ms = float(tail_threshold_ms)
        self._capacity = max(1, int(capacity))
        self._replica_id = replica_id
        self._journal = journal
        # Model-quality label-join ledger (obs/quality.py): sampled
        # SERVED requests' predictions enter its pending-join ring, so
        # the quality plane rides the same O(sampled) decision this
        # sampler already makes.
        self._quality = quality
        self._lock = make_lock("ExemplarSampler._lock")
        self._count = 0  # traced requests seen, guarded-by: _lock
        self._sampled = 0  # guarded-by: _lock
        self._ring: deque = deque(maxlen=self._capacity)  # guarded-by: _lock
        # Shared-batch-span dedup: ids already journaled (bounded LRU;
        # no deque maxlen — eviction must also clean the set).
        self._batch_ids: deque = deque()  # guarded-by: _lock
        self._batch_id_set = set()  # guarded-by: _lock

    def _journal_ref(self):
        if self._journal is not None:
            return self._journal
        return obs.journal()

    # -- the sampling decision ------------------------------------------

    def observe(
        self,
        trace_id: str,
        phases: Dict[str, float],
        outcome: str,
        rows: int = 1,
        latency_s: Optional[float] = None,
        spans=None,
        batch: Optional[dict] = None,
        generation: Optional[int] = None,
        bucket: Optional[int] = None,
        predictions=None,
        features=None,
    ) -> str:
        """Feed one completed request; returns the sampling reason
        (``head`` / ``tail`` / ``outcome``) or ``""`` when unsampled.

        ``spans`` is the deferred span payload list (record_span kwargs,
        prepared by the frontend with wall stamps already read);
        ``batch`` is the shared serve.batch payload (must carry
        ``span_id``).  Both journal only on a sample.

        ``predictions``/``features`` (host arrays) feed the quality
        ledger's pending-join ring when this sampler has one, only for
        sampled SERVED requests.
        """
        if not trace_id:
            return ""
        if latency_s is None:
            latency_s = sum(
                float(phases.get(p, 0.0)) for p in REQUEST_PHASES
            )
        latency_ms = float(latency_s) * 1e3
        with self._lock:
            self._count += 1
            if outcome != "served":
                sampled_by = "outcome"
            elif (
                self._tail_threshold_ms > 0
                and latency_ms > self._tail_threshold_ms
            ):
                sampled_by = "tail"
            elif (
                self._head_every > 0
                and (self._count - 1) % self._head_every == 0
            ):
                sampled_by = "head"
            else:
                return ""
            self._sampled += 1
            batch_is_new = False
            if batch is not None and batch.get("span_id"):
                batch_id = batch["span_id"]
                if batch_id not in self._batch_id_set:
                    batch_is_new = True
                    self._batch_ids.append(batch_id)
                    self._batch_id_set.add(batch_id)
                    while len(self._batch_ids) > self._capacity:
                        self._batch_id_set.discard(self._batch_ids.popleft())
            phases_ms = {
                p: round(float(phases[p]) * 1e3, 3)
                for p in REQUEST_PHASES
                if p in phases
            }
            dominant = (
                max(phases_ms, key=phases_ms.get) if phases_ms else ""
            )
            record = {
                "trace_id": trace_id,
                "outcome": outcome,
                "sampled_by": sampled_by,
                "latency_ms": round(latency_ms, 3),
                "phases": phases_ms,
                "dominant_phase": dominant,
                "rows": int(rows),
            }
            self._ring.append(dict(record))
        # Journal OUTSIDE the lock: the journal has its own lock and a
        # slow disk must not serialize the request handler threads here.
        extra = {}
        if self._replica_id is not None:
            extra["replica_id"] = self._replica_id
        if generation is not None:
            extra["generation"] = generation
        if bucket is not None:
            extra["bucket"] = bucket
        self._journal_ref().record("request_trace", **record, **extra)
        if batch_is_new:
            tracing.record_span(**batch)
        for payload in spans or ():
            tracing.record_span(**payload)
        if self._quality is not None and outcome == "served" and predictions is not None:
            try:
                self._quality.note_prediction(trace_id, predictions, now=time.monotonic(),
                                              features=features)
            except Exception:
                logger.exception("quality note_prediction failed (ignored)")
        return sampled_by

    # -- readouts -------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"observed": self._count, "sampled": self._sampled}

    def exemplars(self) -> list:
        """Ring contents, oldest first (bounded copies)."""
        with self._lock:
            return [dict(r) for r in self._ring]

    def slowest(self) -> Optional[dict]:
        """The slowest request currently in the ring (the obs.top
        footer / serving_telemetry ``exemplar`` field)."""
        with self._lock:
            if not self._ring:
                return None
            return dict(max(self._ring, key=lambda r: r["latency_ms"]))

    def trace_ids(self, k: int = 4) -> list:
        """Up to ``k`` exemplar trace ids, slowest first — the
        offending-request evidence a fired latency ``slo_alert``
        attaches."""
        with self._lock:
            ranked = sorted(
                self._ring, key=lambda r: -r["latency_ms"]
            )
        return [r["trace_id"] for r in ranked[: max(0, int(k))]]


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
