"""Elastic goodput ledger: the port's copy of ``elasticdl_tpu/obs/goodput.py``
(``GoodputLedger`` :91, the process ledger :581-596).

The ledger partitions a job's wall-clock into EXCLUSIVE phases:

    training            workers executing train/eval tasks (goodput)
    degraded_straggler  training while >=1 straggler is flagged (goodput,
                        reported separately so slow-fleet time is visible)
    requeue_redo        re-training records that were already trained
                        once and got requeued (at-least-once replay cost)
    rendezvous          world dead/forming: churn detected -> drain ->
                        declaration -> first dispatch of the new world
    scaling_wait        elastic regrow in flight (scale_up rescales)
    checkpoint_save     checkpoint write window (worker step loop)
    checkpoint_restore  checkpoint restore window (worker boot)
    idle                no work in flight (startup, finalization)

Exactly one phase is open at any time; ``transition()`` closes the
current phase (accumulating its seconds) and opens the next, journaling
every edge as a ``phase_transition`` event, so the timeline can be
rebuilt from the JSONL alone (``seed_from_journal`` folds it back in).
Durations come from THIS process's monotonic clock; worker-supplied
wall-clock never enters the accounting, and a clock regression clamps
to a zero-length phase instead of going negative.

On top of the phase machine sits the **rescale cost tracker**: each
rescale (worker_churn / scale / scale_up) opens a record at detection
and closes at the first successful task completion of the re-formed
world with the requeued work repaid, journaled as ``rescale_cost`` with
a detection -> rendezvous -> redo breakdown (and observed into the
``elasticdl_rescale_cost_seconds`` histogram by component).

Restart survival: a replacement master seeds cumulative per-phase
seconds from the resumed journal (``seed_from_journal``), so the live
``elasticdl_goodput_ratio`` gauge keeps job-lifetime meaning across
master generations.  The outage gap itself (no master alive to account
it) is not seen by the live gauge; the JAX package's offline report
(``obs/report.py``) attributes it and is not ported yet.

Process scoping: each process accounts its own ledger.  Control-plane
hooks (the task manager, the rendezvous, the pod manager) drive the
master's; the worker step-loop hooks (``join_world``, checkpoint
windows, WAIT idling) drive the worker process's own, which coincides
with the master's only in single-process Local mode.

Label cardinality: ``phase`` / ``component`` / ``cause`` / ``reason``
are small closed enums; unbounded detail (task ids, rendezvous ids)
rides the journal fields.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("obs.goodput")

#: The closed phase taxonomy.
PHASES = (
    "training",
    "rendezvous",
    "checkpoint_save",
    "checkpoint_restore",
    "scaling_wait",
    "requeue_redo",
    "degraded_straggler",
    "idle",
)

#: Phases that count as goodput: the job is making NEW forward progress.
#: `requeue_redo` deliberately does not count — those records trained
#: before and the time re-spent on them is the price of at-least-once.
GOODPUT_PHASES = frozenset({"training", "degraded_straggler"})

#: Rescale-cost breakdown components (histogram label values).
RESCALE_COMPONENTS = ("detection", "rendezvous", "redo", "total")


class GoodputLedger:
    """Thread-safe exclusive-phase ledger + per-rescale cost tracker.

    All hooks are O(1) and safe to call from servicer threads, the
    pod-manager monitor, and telemetry callbacks; callers must NOT hold
    control-plane locks (the hooks journal, which is file I/O).  The
    journal write happens inside the ledger's own lock so the journaled
    edge order always matches the accounted order.
    """

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._phase: Optional[str] = None  # guarded-by: _lock
        self._phase_started = 0.0  # guarded-by: _lock
        self._seconds: Dict[str, float] = {p: 0.0 for p in PHASES}  # guarded-by: _lock
        self._records_done = 0  # guarded-by: _lock
        self._records_redone = 0  # guarded-by: _lock
        self._redo_pending = 0  # guarded-by: _lock
        self._straggler_ids: set = set()  # guarded-by: _lock
        self._rescale: Optional[dict] = None  # guarded-by: _lock
        self._rescale_seq = 0  # guarded-by: _lock
        self._last_emitted: Optional[dict] = None  # guarded-by: _lock
        self._finished = False  # guarded-by: _lock

        self._m_phase_seconds = obs.counter(
            "elasticdl_phase_seconds_total",
            "Wall-clock seconds accounted to each ledger phase",
            labelnames=("phase",),
        )
        self._m_current = obs.gauge(
            "elasticdl_goodput_current_phase",
            "1 for the ledger's currently open phase, 0 otherwise",
            labelnames=("phase",),
        )
        for phase in PHASES:
            self._m_current.set(0, phase=phase)
        self._m_rescales = obs.counter(
            "elasticdl_rescales_total",
            "Rescale events tracked by the goodput ledger, by cause",
            labelnames=("cause",),
        )
        self._m_rescale_cost = obs.histogram(
            "elasticdl_rescale_cost_seconds",
            "Per-rescale cost: detection -> rendezvous -> redo, + total",
            labelnames=("component",),
        )
        self._m_redone = obs.counter(
            "elasticdl_records_redone_total",
            "Records requeued for re-training (at-least-once replay), "
            "by cause",
            labelnames=("reason",),
        )
        self._m_last_rescale = obs.gauge(
            "elasticdl_goodput_last_rescale_seconds",
            "Total cost of the most recently completed rescale",
        )
        # set_function re-binds: a fresh ledger (tests, reset_ledger)
        # takes the gauge over from its predecessor.
        obs.gauge(
            "elasticdl_goodput_ratio",
            "Fraction of accounted wall-clock spent in goodput phases "
            "(training + degraded_straggler)",
        ).set_function(self.goodput_ratio)

    # ------------------------------------------------------------------
    # Core phase machine
    # ------------------------------------------------------------------

    def transition(self, phase: str, cause: str = "", **fields) -> Optional[dict]:
        """Close the open phase and open `phase`.  Same-phase transitions
        are no-ops (phases are exclusive; re-entering is not an edge).
        Returns the journal record, or None when nothing changed."""
        if phase not in PHASES:
            raise ValueError(f"Unknown ledger phase {phase!r}")
        with self._lock:
            if phase == self._phase:
                return None
            now = self._clock()
            closed_phase, closed_s = self._close_locked(now)
            self._phase = phase
            self._phase_started = now
            record = obs.journal().record(
                "phase_transition",
                **{"from": closed_phase or ""},
                to=phase,
                cause=cause,
                seconds=round(closed_s, 6),
                **fields,
            )
            # Metric updates INSIDE the ledger lock (metric locks are
            # leaves — no inversion risk): two racing transitions must
            # publish their current-phase flips in edge order, or a
            # scrape could see two phases at 1 (or none).
            if closed_phase is not None:
                self._m_phase_seconds.inc(closed_s, phase=closed_phase)
                self._m_current.set(0, phase=closed_phase)
            self._m_current.set(1, phase=phase)
        return record

    def _close_locked(self, now: float):
        """Accumulate the open phase; returns (phase, seconds).  A clock
        regression (suspend, clock step under a non-monotonic test clock)
        clamps to zero rather than charging negative seconds."""
        if self._phase is None:
            return None, 0.0
        seconds = max(0.0, now - self._phase_started)
        self._seconds[self._phase] += seconds
        return self._phase, seconds

    @contextlib.contextmanager
    def phase(self, name: str, cause: str = "", **fields):
        """Scoped phase: enter `name`, and on exit return to the phase
        that was open before (worker step loop: checkpoint windows,
        world joins).  No-op frame when `name` is already open."""
        with self._lock:
            previous = self._phase
        if previous == name:
            yield  # already in this phase: nested frames are free
            return
        self.transition(name, cause=cause, **fields)
        try:
            yield
        finally:
            self.transition(
                previous if previous is not None else "idle",
                cause=f"{name}_done",
            )

    def current_phase(self) -> Optional[str]:
        with self._lock:
            return self._phase

    def phase_seconds(self) -> Dict[str, float]:
        """Cumulative seconds per phase INCLUDING the open phase's
        elapsed time (the live view the ratio gauge is computed from)."""
        with self._lock:
            seconds = dict(self._seconds)
            if self._phase is not None:
                seconds[self._phase] += max(
                    0.0, self._clock() - self._phase_started
                )
        return seconds

    def goodput_ratio(self) -> float:
        """Goodput seconds / accounted seconds, in [0, 1]; 0.0 before any
        time has been accounted."""
        seconds = self.phase_seconds()
        total = sum(seconds.values())
        if total <= 0.0:
            return 0.0
        good = sum(seconds[p] for p in GOODPUT_PHASES)
        return good / total

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {
                "records_done": self._records_done,
                "records_redone": self._records_redone,
                "redo_pending": self._redo_pending,
                "rescales": self._rescale_seq,
            }

    # ------------------------------------------------------------------
    # Work accounting (TaskManager hooks)
    # ------------------------------------------------------------------

    def _work_phase(self) -> str:
        """Which phase dispatched work lands in: redo debt first, then
        degraded while stragglers are flagged, else clean training."""
        with self._lock:
            if self._redo_pending > 0:
                return "requeue_redo"
            if self._straggler_ids:
                return "degraded_straggler"
            return "training"

    def note_dispatch(self):
        """A task was handed to a worker: work is in flight.  The first
        dispatch after a world declaration is also the signal that the
        new world actually formed (rank 0 only polls for tasks after its
        join completed)."""
        self.transition(self._work_phase(), cause="task_dispatch")

    def note_task_done(self, records: int = 0, training: bool = True):
        """A task completed successfully.  Training records repay the
        redo debt; repaying it (with a formed world) closes the open
        rescale record."""
        finalize = None
        with self._lock:
            records = max(0, int(records))
            if training:
                self._records_done += records
                if self._redo_pending > 0:
                    self._redo_pending = max(0, self._redo_pending - records)
            rescale = self._rescale
            if (
                rescale is not None
                and self._redo_pending == 0
                # The re-formed world must exist before a completion can
                # close the rescale: formation observed, or at least the
                # new declaration (deferred-host worlds never report
                # formation to the master — the dispatch/done pair is
                # then the "first step after" signal).
                and (
                    rescale.get("t_world") is not None
                    or rescale.get("rendezvous_id") is not None
                )
            ):
                finalize = self._close_rescale_locked(self._clock())
        if finalize is not None:
            self._emit_rescale(finalize)
        if self._redo_pending == 0 and self.current_phase() == "requeue_redo":
            self.transition(self._work_phase(), cause="redo_repaid")

    def note_requeue(self, records: int, reason: str, tasks: int = 1):
        """Training records went back on the queue — they will be trained
        again, and the time re-spent is `requeue_redo`, not goodput."""
        records = max(0, int(records))
        if records:
            self._m_redone.inc(records, reason=reason)
        with self._lock:
            self._records_redone += records
            self._redo_pending += records
            if self._rescale is not None:
                self._rescale["redo_records"] += records
                self._rescale["redo_tasks"] += int(tasks)

    # ------------------------------------------------------------------
    # Rescale lifecycle (pod manager + rendezvous hooks)
    # ------------------------------------------------------------------

    def on_rescale_detected(self, cause: str, old_size: int):
        """A rescale begins: churn detected, or an explicit/elastic
        resize committed.  Back-to-back rescales (a second churn before
        the first one's redo is repaid) close the open record with what
        it has — the new detection restarts the clock."""
        stale = None
        with self._lock:
            now = self._clock()
            if self._rescale is not None:
                stale = self._close_rescale_locked(now, superseded=True)
            self._rescale_seq += 1
            self._rescale = {
                "seq": self._rescale_seq,
                "cause": cause,
                "old_size": int(old_size),
                "new_size": None,
                "t_detect": now,
                "t_drain": None,
                "t_world": None,
                "rendezvous_id": None,
                "redo_records": 0,
                "redo_tasks": 0,
            }
        if stale is not None:
            self._emit_rescale(stale)
        self._m_rescales.inc(cause=cause)
        self.transition(
            "scaling_wait" if cause == "scale_up" else "rendezvous",
            cause=cause,
        )

    def on_drain_complete(self, new_size: int):
        """The dead world is torn down and its tasks recovered — the end
        of the detection component."""
        with self._lock:
            if self._rescale is not None and self._rescale["t_drain"] is None:
                self._rescale["t_drain"] = self._clock()
                self._rescale["new_size"] = int(new_size)

    def on_world_declared(self, rendezvous_id: int, world_size: int):
        """A new world was declared.  Outside a tracked rescale (initial
        formation) this still opens a rendezvous phase — startup
        formation is not goodput either."""
        with self._lock:
            if self._rescale is not None:
                if self._rescale["t_drain"] is None:
                    self._rescale["t_drain"] = self._clock()
                self._rescale["rendezvous_id"] = int(rendezvous_id)
                if self._rescale["new_size"] is None:
                    self._rescale["new_size"] = int(world_size)
        if self.current_phase() != "scaling_wait":
            self.transition(
                "rendezvous", cause="world_declared",
                rendezvous_id=rendezvous_id, world_size=world_size,
            )

    def on_world_formed(self, rendezvous_id: int):
        """Every member of the declared world polled its rank — the end
        of the rendezvous component.  Best-signal-wins: when this never
        fires (deferred-host worlds mid-forming), the first dispatch
        stands in (note_task_done falls back to t_drain/t_detect)."""
        with self._lock:
            if self._rescale is not None and self._rescale["t_world"] is None:
                self._rescale["t_world"] = self._clock()

    def _close_rescale_locked(self, now: float, superseded: bool = False):
        rescale = self._rescale
        self._rescale = None
        if rescale is None:
            return None
        detect = rescale["t_detect"]
        drain = rescale["t_drain"] if rescale["t_drain"] is not None else detect
        world = rescale["t_world"] if rescale["t_world"] is not None else drain
        rescale["detection_s"] = max(0.0, drain - detect)
        rescale["rendezvous_s"] = max(0.0, world - drain)
        rescale["redo_s"] = max(0.0, now - world)
        rescale["total_s"] = max(0.0, now - detect)
        rescale["superseded"] = superseded
        return rescale

    def last_rescale(self) -> Optional[dict]:
        """The most recently COMPLETED rescale's cost record (the value
        behind elasticdl_goodput_last_rescale_seconds), with `t_end` —
        the ledger clock when it closed.  None before the first one.
        The policy engine prices scale decisions off this."""
        with self._lock:
            return dict(self._last_emitted) if self._last_emitted else None

    def seconds_since_last_rescale(self) -> Optional[float]:
        """Seconds since the last completed rescale closed (the policy
        engine's cooldown clock); None before any rescale completed."""
        with self._lock:
            if self._last_emitted is None:
                return None
            return max(0.0, self._clock() - self._last_emitted["t_end"])

    def rescale_in_flight(self) -> bool:
        """True while a rescale record is open (detection happened, redo
        not yet repaid) — scale decisions should wait it out."""
        with self._lock:
            return self._rescale is not None

    def _emit_rescale(self, rescale: dict):
        with self._lock:
            self._last_emitted = {**rescale, "t_end": self._clock()}
        for component in ("detection", "rendezvous", "redo", "total"):
            self._m_rescale_cost.observe(
                rescale[f"{component}_s"], component=component
            )
        self._m_last_rescale.set(rescale["total_s"])
        obs.journal().record(
            "rescale_cost",
            seq=rescale["seq"],
            cause=rescale["cause"],
            old_size=rescale["old_size"],
            new_size=rescale["new_size"],
            total_s=round(rescale["total_s"], 6),
            detection_s=round(rescale["detection_s"], 6),
            rendezvous_s=round(rescale["rendezvous_s"], 6),
            redo_s=round(rescale["redo_s"], 6),
            redo_records=rescale["redo_records"],
            redo_tasks=rescale["redo_tasks"],
            rendezvous_id=rescale["rendezvous_id"],
            superseded=rescale["superseded"],
        )
        logger.info(
            "Rescale #%d (%s, %s -> %s workers) cost %.1fs: %.1fs "
            "detection, %.1fs rendezvous, %.1fs redo of %d requeued "
            "records (%d tasks)",
            rescale["seq"], rescale["cause"], rescale["old_size"],
            rescale["new_size"], rescale["total_s"], rescale["detection_s"],
            rescale["rendezvous_s"], rescale["redo_s"],
            rescale["redo_records"], rescale["redo_tasks"],
        )

    # ------------------------------------------------------------------
    # Straggler + terminal hooks
    # ------------------------------------------------------------------

    def on_straggler(self, worker_id: int, flagged: bool):
        """Telemetry-plane advisory: while >=1 worker is flagged, training
        time is accounted as `degraded_straggler` (still goodput — the
        fleet progresses — but visibly slow-fleet time)."""
        with self._lock:
            if flagged:
                self._straggler_ids.add(worker_id)
            else:
                self._straggler_ids.discard(worker_id)
            degraded = bool(self._straggler_ids)
        current = self.current_phase()
        if degraded and current == "training":
            self.transition("degraded_straggler", cause="straggler_flagged")
        elif not degraded and current == "degraded_straggler":
            self.transition("training", cause="straggler_cleared")

    def finish(self, outcome: str = "job_complete", **fields):
        """Terminal accounting: close any open rescale, park the ledger
        in `idle`, and journal the `goodput_summary` record the report
        tool (and operators grepping the JSONL) key off."""
        stale = None
        with self._lock:
            if self._finished:
                return
            self._finished = True
            if self._rescale is not None:
                stale = self._close_rescale_locked(self._clock())
        if stale is not None:
            self._emit_rescale(stale)
        self.transition("idle", cause=outcome)
        seconds = self.phase_seconds()
        counts = self.counts()
        obs.journal().record(
            "goodput_summary",
            outcome=outcome,
            wall_s=round(sum(seconds.values()), 6),
            goodput_ratio=round(self.goodput_ratio(), 6),
            phases={p: round(s, 6) for p, s in seconds.items() if s > 0},
            records_done=counts["records_done"],
            records_redone=counts["records_redone"],
            rescales=counts["rescales"],
            **fields,
        )

    # ------------------------------------------------------------------
    # Master-restart seeding
    # ------------------------------------------------------------------

    def seed_from_journal(self, path: str) -> int:
        """Fold a predecessor master's phase accounting (its
        `phase_transition` records) into this ledger so the live goodput
        ratio keeps job-lifetime meaning across restarts.  Returns the
        number of seeded transitions; unreadable/foreign journals seed
        nothing (the report tool remains the full-fidelity path)."""
        import json

        seeded = {p: 0.0 for p in PHASES}
        transitions = 0
        rescales = 0
        from elasticdl_tpu_torch.obs.journal import ROTATED_SUFFIX

        # Oldest first, rotated file included: a journal past its size
        # cap moved earlier generations' accounting to the rotated file,
        # and dropping it would silently shrink the job-lifetime ratio.
        for source in (path + ROTATED_SUFFIX, path):
            try:
                with open(
                    source, "r", encoding="utf-8", errors="replace"
                ) as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                if rec.get("event") == "phase_transition":
                    phase = rec.get("from")
                    seconds = rec.get("seconds")
                    if (
                        phase in PHASES
                        and isinstance(seconds, (int, float))
                        and not isinstance(seconds, bool)
                        and seconds >= 0
                    ):
                        seeded[phase] += float(seconds)
                        transitions += 1
                elif rec.get("event") == "rescale_cost":
                    rescales += 1
        if transitions == 0 and rescales == 0:
            return 0
        with self._lock:
            for phase, seconds in seeded.items():
                self._seconds[phase] += seconds
            self._rescale_seq = max(self._rescale_seq, rescales)
        for phase, seconds in seeded.items():
            if seconds > 0:
                self._m_phase_seconds.inc(seconds, phase=phase)
        logger.info(
            "Goodput ledger seeded from %s: %d prior transitions "
            "(%.1fs accounted), %d prior rescales",
            path, transitions, sum(seeded.values()), rescales,
        )
        return transitions


# ---------------------------------------------------------------------------
# Process-wide default (same pattern as obs.journal()/obs.registry()).
# ---------------------------------------------------------------------------

_ledger: Optional[GoodputLedger] = None


def ledger() -> GoodputLedger:
    """The process-wide ledger every instrumentation hook feeds.  Created
    lazily so importing this module costs nothing until a hook fires."""
    global _ledger
    if _ledger is None:
        _ledger = GoodputLedger()
    return _ledger


def reset_ledger() -> GoodputLedger:
    """Replace the process-wide ledger with a fresh one (test isolation:
    the ratio gauge re-binds to the new instance).  Production never
    calls this — a master restart is a new process."""
    global _ledger
    _ledger = GoodputLedger()
    return _ledger
