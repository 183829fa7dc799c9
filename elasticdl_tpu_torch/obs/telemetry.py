"""Worker telemetry plane: the port's copy of ``elasticdl_tpu/obs/telemetry.py``
(``sanitize_snapshot`` :76, ``WorkerTelemetry`` :136,
``StragglerDetector`` :294, ``TelemetryAggregator`` :440).

The master hears from a worker at task completion (minutes apart) or at
its heartbeat; this module gives the heartbeat a payload, with no new
RPC:

- **WorkerTelemetry** (worker side): a small rolling collector — step
  times, examples/s, task progress, rendezvous epoch, RPC retry counts,
  the step anatomy — whose ``snapshot_json()`` rides the liveness
  heartbeat (``ReportWorkerLivenessRequest.telemetry_json``).
- **TelemetryAggregator** (master side): ingests snapshots in the
  servicer, folds fleet AGGREGATES into the default metrics registry
  (p50/p95 step time, min/max examples/s, staleness, phase fractions)
  and journals the per-worker detail — a worker id is never a metric
  label; ``worker_telemetry`` journal events carry it instead.
- **StragglerDetector**: flags workers whose step time or report
  staleness exceeds a robust threshold (median + k*MAD, floored), with
  hysteresis so one noisy sample neither flags nor clears.  Transitions
  emit ``straggler_detected``/``straggler_cleared`` journal events, move
  the ``elasticdl_stragglers`` gauge, and fire advisory callbacks the
  pod manager, the goodput ledger and the policy engine consume.

The snapshot JSON is a wire format shared with the JAX package: a
snapshot either package's worker writes is read by either aggregator.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.obs import stepstats

logger = get_logger("obs.telemetry")

#: Snapshot schema version (bump on incompatible changes; the aggregator
#: ignores snapshots whose version it does not know).
SNAPSHOT_VERSION = 1

#: Hard cap on the serialized snapshot riding the heartbeat: telemetry
#: must never bloat the liveness RPC.  The schema is all scalars, so the
#: cap only trips if a caller stuffs an oversized task type/shard string.
MAX_SNAPSHOT_BYTES = 4096


def _quantile(sorted_values: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of an already-sorted non-empty sequence."""
    index = min(len(sorted_values) - 1, max(0, int(q * len(sorted_values))))
    return float(sorted_values[index])


def _number(value) -> Optional[float]:
    """`value` as float when it is a real JSON number, else None (bool is
    a JSON boolean, not a number)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    return None


#: Top-level numeric snapshot fields the aggregator accepts (count-like
#: fields round-trip as ints so renderers don't show "rendezvous 1.0").
_FLOAT_FIELDS = ("ts", "step_p50_s", "step_p95_s", "examples_per_s")
_INT_FIELDS = ("rendezvous_id", "steps_total", "records_total")
_TASK_NUMERIC_FIELDS = ("id", "records_done", "records_total")


def sanitize_snapshot(snapshot) -> Optional[dict]:
    """Validate + whitelist a parsed telemetry snapshot.

    Returns a clean dict or None (malformed).  Strict on purpose: the
    snapshot came off the wire from a possibly-skewed/older worker, and
    its fields flow into gauge arithmetic (a string p50 would make every
    scrape's sorted() raise) and into journal.record(**fields) (an
    unexpected 'event' key would collide with the record envelope) — so
    wrong-typed known fields reject the snapshot, and unknown fields are
    dropped rather than forwarded."""
    if not isinstance(snapshot, dict) or snapshot.get("v") != SNAPSHOT_VERSION:
        return None
    clean = {"v": SNAPSHOT_VERSION}
    for key in _FLOAT_FIELDS + _INT_FIELDS:
        if key not in snapshot:
            continue
        value = _number(snapshot[key])
        if value is None:
            return None
        clean[key] = int(value) if key in _INT_FIELDS else value
    task = snapshot.get("task")
    if task is not None:
        if not isinstance(task, dict):
            return None
        clean_task = {}
        for key in _TASK_NUMERIC_FIELDS:
            if key in task:
                value = _number(task[key])
                if value is None:
                    return None
                clean_task[key] = int(value)
        type_name = task.get("type")
        if type_name is not None:
            if not isinstance(type_name, str):
                return None
            clean_task["type"] = type_name[:32]
        clean["task"] = clean_task
    anatomy = snapshot.get("anatomy")
    if anatomy is not None:
        # Anatomy is supplementary: a malformed sub-dict degrades to
        # absent (sanitize_anatomy whitelists) instead of rejecting the
        # snapshot — the liveness/step signal must survive it.
        clean_anatomy = stepstats.sanitize_anatomy(anatomy)
        if clean_anatomy is not None:
            clean["anatomy"] = clean_anatomy
    rpc = snapshot.get("rpc")
    if rpc is not None:
        if not isinstance(rpc, dict):
            return None
        clean_rpc = {}
        for key in ("retries", "give_ups"):
            if key in rpc:
                value = _number(rpc[key])
                if value is None:
                    return None
                clean_rpc[key] = int(value)
        clean["rpc"] = clean_rpc
    return clean


class WorkerTelemetry:
    """Worker-side rolling telemetry.  All mutators are O(1) and cheap
    enough for the training hot loop (one call per dispatch window, not
    per step); ``snapshot_json()`` is called by the heartbeat thread."""

    def __init__(self, worker_id: int, step_window: int = 128):
        self._lock = make_lock("WorkerTelemetry._lock")
        self._worker_id = worker_id
        # Per-step durations, one sample per recorded flush (the sample is
        # the flush's mean step time) — a bounded window so percentiles
        # track the RECENT regime, not the job-lifetime average.
        self._step_times: deque = deque(maxlen=step_window)  # guarded-by: _lock
        self._steps_total = 0  # guarded-by: _lock
        self._records_total = 0  # guarded-by: _lock
        self._example_rate = obs.RateTracker(window_s=60.0)
        self._rendezvous_id = 0  # guarded-by: _lock
        self._task_id = -1  # guarded-by: _lock
        self._task_type = ""  # guarded-by: _lock
        self._task_records_total = 0  # guarded-by: _lock
        self._task_records_done = 0  # guarded-by: _lock
        self._retry_stats = None  # guarded-by: _lock
        self._anatomy = None  # guarded-by: _lock
        #: Wall-clock stamp of the newest snapshot — the clock-probe
        #: pairing key (see snapshot()).  Written/read on the heartbeat
        #: thread only.
        self.last_snapshot_ts: float = 0.0

    @property
    def worker_id(self) -> int:
        return self._worker_id

    def bind_retry_stats(self, stats) -> None:
        """Attach a MasterClient.RetryStats so snapshots carry the RPC
        retry plane's per-worker view."""
        with self._lock:
            self._retry_stats = stats

    def bind_anatomy(self, anatomy) -> None:
        """Attach a StepAnatomy (obs/stepstats.py) so snapshots carry the
        step-time decomposition under the ``anatomy`` key."""
        with self._lock:
            self._anatomy = anatomy

    @property
    def anatomy(self):
        with self._lock:
            return self._anatomy

    def set_rendezvous(self, rendezvous_id: int) -> None:
        with self._lock:
            self._rendezvous_id = int(rendezvous_id)

    def begin_task(self, task_id: int, type_name: str, records_total: int) -> None:
        with self._lock:
            self._task_id = int(task_id)
            self._task_type = str(type_name)[:32]
            self._task_records_total = int(records_total)
            self._task_records_done = 0

    def record_steps(
        self, n_steps: int, duration_s: float, records: int = 0
    ) -> None:
        """One dispatch window finished: `n_steps` train steps took
        `duration_s` seconds wall and consumed `records` real records."""
        if n_steps <= 0:
            return
        per_step = float(duration_s) / n_steps
        with self._lock:
            self._step_times.append(per_step)
            self._steps_total += int(n_steps)
            self._records_total += int(records)
            self._task_records_done += int(records)
        if records:
            self._example_rate.add(records)

    def snapshot(self) -> dict:
        """Bounded JSON-able snapshot (the telemetry wire schema, the JAX
        package's field for field)."""
        with self._lock:
            steps = sorted(self._step_times)
            retry_stats = self._retry_stats
            anatomy = self._anatomy
            # Remembered for the clock-probe pairing key: the heartbeat
            # journals a `clock_probe` carrying THIS stamp, and the
            # master's worker_telemetry event forwards the same value as
            # `worker_ts`, so the two pair into a clock-offset estimate.
            self.last_snapshot_ts = round(time.time(), 3)
            snap = {
                "v": SNAPSHOT_VERSION,
                "worker_id": self._worker_id,
                "ts": self.last_snapshot_ts,
                "rendezvous_id": self._rendezvous_id,
                "steps_total": self._steps_total,
                "records_total": self._records_total,
                "task": {
                    "id": self._task_id,
                    "type": self._task_type,
                    "records_done": self._task_records_done,
                    "records_total": self._task_records_total,
                },
            }
        if steps:
            snap["step_p50_s"] = round(_quantile(steps, 0.50), 6)
            snap["step_p95_s"] = round(_quantile(steps, 0.95), 6)
        snap["examples_per_s"] = round(self._example_rate.rate(), 3)
        if retry_stats is not None:
            snap["rpc"] = {
                "retries": retry_stats.retries,
                "give_ups": retry_stats.give_ups,
            }
        if anatomy is not None:
            try:
                snap["anatomy"] = anatomy.snapshot()
            except Exception:
                # Anatomy is supplementary: it must never take the
                # liveness snapshot down with it.
                logger.exception("StepAnatomy snapshot failed; omitted")
        return snap

    @staticmethod
    def _dumps(snap: dict) -> str:
        return json.dumps(snap, separators=(",", ":"))

    def snapshot_json(self) -> str:
        snap = self.snapshot()
        payload = self._dumps(snap)
        # Size-budget ladder: a snapshot nearing the 4 KiB heartbeat
        # bound sheds the ANATOMY detail first — windows oldest-first,
        # then per-function compile counts, then the whole sub-dict —
        # so the core liveness/step fields always deliver.  The final
        # identity fallback stays only for pathological core bloat.
        anatomy = snap.get("anatomy")
        while (
            len(payload.encode("utf-8")) > MAX_SNAPSHOT_BYTES
            and isinstance(anatomy, dict)
        ):
            windows = anatomy.get("windows")
            if windows:
                windows.pop(0)  # oldest window first
            elif "compiles" in anatomy or "windows" in anatomy:
                anatomy.pop("compiles", None)
                anatomy.pop("windows", None)
            else:
                snap.pop("anatomy", None)
                anatomy = None
            payload = self._dumps(snap)
        if len(payload.encode("utf-8")) > MAX_SNAPSHOT_BYTES:
            # Degrade to the minimal identity snapshot rather than ship a
            # bloated heartbeat (only reachable via oversized task names).
            payload = self._dumps(
                {"v": SNAPSHOT_VERSION, "worker_id": self._worker_id}
            )
        return payload


class StragglerDetector:
    """Robust relative-slowness detector with hysteresis.

    A worker is OVER threshold when its step-time p50 or its report
    staleness exceeds ``median + max(k * 1.4826 * MAD, rel_floor *
    median, abs_floor)`` across the current fleet (1.4826 scales MAD to
    sigma under normality).  The floors keep a tight, healthy fleet
    (MAD ~ 0) from flagging micro-jitter.  Hysteresis: `flag_after`
    consecutive over-threshold evaluations flag, `clear_after`
    consecutive under-threshold evaluations clear.  Below `min_workers`
    reporting workers relative slowness is unjudgeable and the detector
    stays silent.
    """

    def __init__(
        self,
        k: float = 3.0,
        min_workers: int = 3,
        rel_floor: float = 0.5,
        step_floor_s: float = 1e-3,
        staleness_floor_s: float = 5.0,
        flag_after: int = 2,
        clear_after: int = 2,
    ):
        self.k = float(k)
        self.min_workers = int(min_workers)
        self.rel_floor = float(rel_floor)
        self.step_floor_s = float(step_floor_s)
        self.staleness_floor_s = float(staleness_floor_s)
        self.flag_after = int(flag_after)
        self.clear_after = int(clear_after)
        self._over_streak: Dict[int, int] = {}
        self._under_streak: Dict[int, int] = {}
        self._flagged: Dict[int, dict] = {}

    @staticmethod
    def _median(values: Sequence[float]) -> float:
        ordered = sorted(values)
        mid = len(ordered) // 2
        if len(ordered) % 2:
            return float(ordered[mid])
        return (ordered[mid - 1] + ordered[mid]) / 2.0

    def threshold(self, values: Sequence[float], abs_floor: float) -> float:
        """median + max(k*1.4826*MAD, rel_floor*median, abs_floor)."""
        median = self._median(values)
        mad = self._median([abs(v - median) for v in values])
        return median + max(
            self.k * 1.4826 * mad, self.rel_floor * median, abs_floor
        )

    @property
    def flagged(self) -> Dict[int, dict]:
        return dict(self._flagged)

    def evaluate(
        self,
        step_times: Dict[int, float],
        staleness: Dict[int, float],
        updated: Optional[set] = None,
    ) -> List[dict]:
        """One detection pass over the current fleet.  Returns the list of
        TRANSITIONS: {"worker_id", "flagged": bool, ...evidence}.  The
        caller (TelemetryAggregator) owns journaling/metrics/callbacks.

        `updated` names the workers whose data is NEW since the last
        pass (None = all).  Step-time streaks only advance on fresh data
        from that worker: evaluations fire on every ingest from ANY
        worker, so without the gate one noisy snapshot would be
        re-judged N times within a heartbeat period and flag instantly,
        making `flag_after` vacuous.  Staleness streaks advance on every
        pass — staleness grows on its own, not per report.
        """
        current = set(step_times) | set(staleness)
        if updated is None:
            updated = current
        # Workers gone from the fleet (rescale, churn) drop silently —
        # they are not "cleared", they no longer exist.
        for state in (self._over_streak, self._under_streak, self._flagged):
            for wid in [w for w in state if w not in current]:
                del state[wid]
        over: Dict[int, dict] = {}
        if len(step_times) >= self.min_workers:
            thr = self.threshold(list(step_times.values()), self.step_floor_s)
            med = self._median(list(step_times.values()))
            for wid, value in step_times.items():
                if value > thr:
                    over[wid] = {
                        "metric": "step_time",
                        "value": round(value, 6),
                        "threshold": round(thr, 6),
                        "median": round(med, 6),
                    }
        if len(staleness) >= self.min_workers:
            thr = self.threshold(
                list(staleness.values()), self.staleness_floor_s
            )
            med = self._median(list(staleness.values()))
            for wid, value in staleness.items():
                # Staleness evidence yields to step-time evidence ONLY
                # for freshly-updated workers: a slow-then-SILENT worker
                # has stale step evidence whose streak can't advance, so
                # its staleness (which grows every pass) must take over
                # or the most suspicious worker kind never flags.
                if value > thr and (wid not in over or wid not in updated):
                    over[wid] = {
                        "metric": "staleness",
                        "value": round(value, 3),
                        "threshold": round(thr, 3),
                        "median": round(med, 3),
                    }
        transitions: List[dict] = []
        for wid in current:
            if wid in over:
                if wid not in updated and over[wid]["metric"] != "staleness":
                    continue  # same step sample re-judged: streak holds
                self._over_streak[wid] = self._over_streak.get(wid, 0) + 1
                self._under_streak[wid] = 0
                if (
                    wid not in self._flagged
                    and self._over_streak[wid] >= self.flag_after
                ):
                    self._flagged[wid] = over[wid]
                    transitions.append(
                        {"worker_id": wid, "flagged": True, **over[wid]}
                    )
            else:
                if wid not in updated:
                    continue  # no fresh data: recovery can't be judged yet
                self._under_streak[wid] = self._under_streak.get(wid, 0) + 1
                self._over_streak[wid] = 0
                if (
                    wid in self._flagged
                    and self._under_streak[wid] >= self.clear_after
                ):
                    evidence = self._flagged.pop(wid)
                    transitions.append(
                        {
                            "worker_id": wid,
                            "flagged": False,
                            "metric": evidence.get("metric"),
                        }
                    )
        return transitions


class TelemetryAggregator:
    """Master-side half: ingest snapshots, aggregate, detect stragglers.

    Cardinality rule: per-worker values NEVER become metric labels — the
    registry gets fleet aggregates only; per-worker detail goes to the
    journal as ``worker_telemetry`` events (rate-limited per worker).
    """

    def __init__(
        self,
        detector: Optional[StragglerDetector] = None,
        current_workers_fn: Optional[Callable[[], List[int]]] = None,
        journal_interval_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._lock = make_lock("TelemetryAggregator._lock")
        self._detector = detector or StragglerDetector()
        self._current_workers_fn = current_workers_fn
        self._journal_interval_s = float(journal_interval_s)
        self._clock = clock
        # wid -> {"snapshot", "received", "journaled"} (monotonic clocks).
        self._reports: Dict[int, dict] = {}  # guarded-by: _lock
        self._callbacks: List[Callable[[int, bool, dict], None]] = []  # guarded-by: _lock
        # Scrape-path memo for the anatomy fold: 5 phase gauges + the
        # retrace gauge would otherwise each re-fold every snapshot per
        # scrape.  Keyed on the ingest sequence — any new snapshot
        # invalidates.
        self._ingest_seq = 0  # guarded-by: _lock
        self._attribution_cache = (-1, None)  # guarded-by: _lock

        self._m_reports = obs.counter(
            "elasticdl_telemetry_reports_total",
            "Worker telemetry snapshots ingested from heartbeats",
        )
        self._m_malformed = obs.counter(
            "elasticdl_telemetry_malformed_total",
            "Telemetry payloads dropped as unparsable/unknown-version",
        )
        self._m_stragglers = obs.gauge(
            "elasticdl_stragglers",
            "Workers currently flagged by the straggler detector",
        )
        self._m_stragglers.set(0)
        obs.gauge(
            "elasticdl_telemetry_workers",
            "Current-world workers with a telemetry snapshot",
        ).set_function(lambda: len(self._fleet_reports()))
        obs.gauge(
            "elasticdl_worker_step_time_p50_seconds",
            "Fleet median of per-worker recent step-time p50",
        ).set_function(lambda: self._aggregate("step_p50_s", 0.50))
        obs.gauge(
            "elasticdl_worker_step_time_p95_seconds",
            "Fleet maximum of per-worker recent step-time p95 "
            "(the slowest worker's tail)",
        ).set_function(lambda: self._aggregate("step_p95_s", 1.0))
        obs.gauge(
            "elasticdl_worker_examples_per_second_min",
            "Slowest current worker's examples/s",
        ).set_function(lambda: self._aggregate("examples_per_s", 0.0))
        obs.gauge(
            "elasticdl_worker_examples_per_second_max",
            "Fastest current worker's examples/s",
        ).set_function(lambda: self._aggregate("examples_per_s", 1.0))
        obs.gauge(
            "elasticdl_telemetry_staleness_seconds",
            "Oldest current-worker telemetry report (seconds ago)",
        ).set_function(self._max_staleness)
        # Step-anatomy fleet view (obs/stepstats.py): fraction of fleet
        # compute-plane time per sub-phase.  `phase` is a bounded enum
        # (stepstats.PHASES) — per-worker/per-function detail stays
        # journal-only per the cardinality rule.
        phase_fraction = obs.gauge(
            "elasticdl_worker_phase_fraction",
            "Fleet step-time fraction per anatomy sub-phase",
            labelnames=("phase",),
        )
        for phase_name in stepstats.PHASES:
            phase_fraction.set_function(
                (lambda p: lambda: self._fleet_phase_fraction(p))(
                    phase_name
                ),
                phase=phase_name,
            )
        obs.gauge(
            "elasticdl_worker_retraces",
            "Fleet total of reported rebuilds (builds beyond the first "
            "per entry point)",
        ).set_function(self._fleet_retraces)

    # -- read side (gauge callbacks; take only the aggregator lock) -----

    def _fleet_reports(self) -> Dict[int, dict]:
        """Latest report per CURRENT-world worker (reports from workers
        of torn-down worlds are excluded once a membership source is
        wired; without one, every reporter counts)."""
        with self._lock:
            reports = dict(self._reports)
        if self._current_workers_fn is not None:
            try:
                current = set(self._current_workers_fn())
            except Exception:
                return reports
            reports = {w: r for w, r in reports.items() if w in current}
        return reports

    def _aggregate(self, field: str, q: float) -> float:
        values = sorted(
            r["snapshot"][field]
            for r in self._fleet_reports().values()
            if field in r["snapshot"]
        )
        if not values:
            return 0.0
        return _quantile(values, q)

    def _max_staleness(self) -> float:
        reports = self._fleet_reports()
        if not reports:
            return 0.0
        now = self._clock()
        return round(max(now - r["received"] for r in reports.values()), 3)

    def fleet_attribution(self) -> dict:
        """The compute-plane bottleneck view (stepstats.fleet_attribution
        over current-world snapshots): summed phase seconds, fractions,
        the bottleneck phase, per-worker dominant phases, fleet retrace
        total.  Memoized per ingest so one scrape's six gauge callbacks
        fold the snapshots once, not six times."""
        with self._lock:
            seq = self._ingest_seq
            cached_seq, cached = self._attribution_cache
        if cached_seq == seq and cached is not None:
            return cached
        attribution = stepstats.fleet_attribution(self.worker_snapshots())
        with self._lock:
            self._attribution_cache = (seq, attribution)
        return attribution

    def _fleet_phase_fraction(self, phase: str) -> float:
        return float(
            self.fleet_attribution()["fractions"].get(phase, 0.0)
        )

    def _fleet_retraces(self) -> float:
        return float(self.fleet_attribution().get("retraces", 0))

    def stragglers(self) -> Dict[int, dict]:
        with self._lock:
            return self._detector.flagged

    def worker_snapshots(self) -> Dict[int, dict]:
        return {
            wid: dict(r["snapshot"])
            for wid, r in self._fleet_reports().items()
        }

    # -- write side -----------------------------------------------------

    def add_straggler_callback(
        self, callback: Callable[[int, bool, dict], None]
    ) -> None:
        """`callback(worker_id, flagged, evidence)` on every straggler
        transition — the advisory hook (pod manager, schedulers)."""
        with self._lock:
            self._callbacks.append(callback)

    def ingest(self, worker_id: int, telemetry_json: str) -> None:
        """Fold one heartbeat's snapshot in.  Never raises: observability
        must not take the liveness RPC down — so besides the strict
        sanitizer (wrong-typed fields reject, unknown fields drop), the
        whole fold is exception-guarded."""
        try:
            snapshot = sanitize_snapshot(json.loads(telemetry_json))
        except (ValueError, TypeError):
            snapshot = None
        if snapshot is None:
            self._m_malformed.inc()
            return
        try:
            self._ingest_clean(worker_id, snapshot)
        except Exception:
            logger.exception(
                "Telemetry ingest for worker %d failed", worker_id
            )

    def _ingest_clean(self, worker_id: int, snapshot: dict) -> None:
        now = self._clock()
        current = None
        if self._current_workers_fn is not None:
            try:
                current = set(self._current_workers_fn())
            except Exception:
                current = None
        journal_it = False
        with self._lock:
            if current is not None:
                # Prune departed incarnations HERE, not just at read
                # time: worker ids grow monotonically across world
                # re-formations, so an unpruned _reports map is a slow
                # master memory leak over weeks of preemption churn.
                for stale_wid in [
                    w for w in self._reports if w not in current
                ]:
                    del self._reports[stale_wid]
                if worker_id not in current:
                    return  # a torn-down world's straggler reporting in
            entry = self._reports.get(worker_id)
            if entry is None:
                entry = {"journaled": -self._journal_interval_s}
                self._reports[worker_id] = entry
            entry["snapshot"] = snapshot
            entry["received"] = now
            self._ingest_seq += 1
            if now - entry["journaled"] >= self._journal_interval_s:
                entry["journaled"] = now
                journal_it = True
        self._m_reports.inc()
        if journal_it:
            # The worker's own wall-clock stamp forwards as `worker_ts`:
            # the record envelope's `ts` must stay the MASTER's write
            # time, or a skew-clocked worker reorders the journal
            # timeline every post-mortem tool sorts by.
            fields = {
                key: value
                for key, value in snapshot.items()
                if key not in ("v", "worker_id", "ts", "anatomy")
            }
            if "ts" in snapshot:
                fields["worker_ts"] = snapshot["ts"]
            obs.journal().record(
                "worker_telemetry", worker_id=worker_id, **fields
            )
            anatomy = snapshot.get("anatomy")
            if isinstance(anatomy, dict):
                # The compute-plane decomposition journals as its OWN
                # schema-registered event (same per-worker rate limit),
                # keeping worker_telemetry lean; windows stay
                # heartbeat-only — cumulative totals reconstruct the
                # attribution.
                self._journal_anatomy(worker_id, anatomy)
        self._detect(now, updated={worker_id})

    @staticmethod
    def _journal_anatomy(worker_id: int, anatomy: dict) -> None:
        stepstats.journal_anatomy(worker_id, anatomy)

    def _anatomy_evidence(self, worker_id: int) -> dict:
        """Compute-plane evidence for a straggler transition: the
        flagged worker's dominant phase and how its fraction compares
        to the fleet median of the same phase — what upgrades the
        journal verdict from "slow" to "slow because data_wait is Nx
        the fleet median"."""
        snapshots = self.worker_snapshots()
        mine = (snapshots.get(worker_id) or {}).get("anatomy") or {}
        fractions = stepstats.phase_fractions(mine.get("totals") or {})
        if not fractions:
            return {}
        dominant = max(fractions, key=fractions.get)
        peer_fractions = sorted(
            stepstats.phase_fractions(
                (snap.get("anatomy") or {}).get("totals") or {}
            ).get(dominant, 0.0)
            for wid, snap in snapshots.items()
            if wid != worker_id and snap.get("anatomy")
        )
        evidence = {
            "dominant_phase": dominant,
            "dominant_phase_fraction": fractions[dominant],
        }
        if peer_fractions:
            fleet_median = _quantile(peer_fractions, 0.5)
            evidence["fleet_phase_fraction"] = round(fleet_median, 4)
            evidence["phase_ratio"] = round(
                fractions[dominant] / max(fleet_median, 1e-6), 1
            )
        return evidence

    def _detect(self, now: float, updated: Optional[set] = None) -> None:
        reports = self._fleet_reports()
        step_times = {
            wid: r["snapshot"]["step_p50_s"]
            for wid, r in reports.items()
            if "step_p50_s" in r["snapshot"]
        }
        staleness = {
            wid: now - r["received"] for wid, r in reports.items()
        }
        with self._lock:
            transitions = self._detector.evaluate(
                step_times, staleness, updated=updated
            )
            flagged_count = len(self._detector.flagged)
            callbacks = list(self._callbacks)
        self._m_stragglers.set(flagged_count)
        for transition in transitions:
            wid = transition["worker_id"]
            if transition["flagged"]:
                # Attach the step-anatomy evidence BEFORE journaling so
                # the straggler record itself names the bottleneck
                # phase (not just "slow").
                transition.update(self._anatomy_evidence(wid))
                logger.warning(
                    "Straggler detected: worker %d (%s=%s > threshold %s, "
                    "fleet median %s)",
                    wid, transition.get("metric"), transition.get("value"),
                    transition.get("threshold"), transition.get("median"),
                )
                obs.journal().record("straggler_detected", **transition)
            else:
                logger.info("Straggler cleared: worker %d", wid)
                obs.journal().record("straggler_cleared", **transition)
            evidence = {
                key: value
                for key, value in transition.items()
                if key not in ("worker_id", "flagged")
            }
            for callback in callbacks:
                try:
                    callback(wid, transition["flagged"], evidence)
                except Exception:
                    logger.exception("Straggler advisory callback failed")
