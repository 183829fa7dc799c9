"""Goodput-driven elastic policy engine: the port's copy of
``elasticdl_tpu/master/policy.py`` (``PolicyConfig`` :77,
``ElasticPolicyEngine`` :124).

The telemetry aggregator flags stragglers and the goodput ledger prices
every rescale (detection -> rendezvous -> redo seconds); this engine,
evaluated on a master tick, turns those measured signals into ENFORCED
decisions:

- **scale_up**: approved only when the marginal-throughput gain of the
  granted workers amortizes the ledger's measured per-rescale cost
  within ``amortize_horizon_s``.  With ``n`` current workers, ``k``
  granted, and a measured rescale cost ``C`` (the most recently
  completed rescale's ``total_s``), adding workers pays off within the
  horizon ``H`` iff ``k * (H - C) > n * C``, i.e. ``H > C * (n + k) / k``
  under the uniform per-worker-rate estimate.  An unpriced fleet (no
  completed rescale yet) is optimistic: the first rescale is how the
  price gets measured.

- **scale_down / hold with hysteresis**: rescale thrash — at least
  ``thrash_rescales`` rescales inside ``thrash_window_s`` with the
  rescale-overhead phases (rendezvous + scaling_wait + requeue_redo)
  eating more than ``thrash_overhead_frac`` of the windowed wall-clock —
  suppresses further scale-ups, and after ``scale_down_after``
  consecutive thrashy ticks the engine parks the fleet at
  ``min_workers``.  Every rescale also opens a cooldown keyed off its
  own measured cost (``max(min_cooldown_s, cooldown_factor *
  last_rescale_total_s)``) during which scale decisions hold.

- **evict**: a worker must stay flagged for ``evict_after_ticks``
  CONSECUTIVE policy ticks (on top of the detector's own hysteresis),
  and kills draw from a per-window budget (``kill_budget`` per
  ``kill_budget_window_s``).  When the budget is spent, or the kill
  would drop the world below ``min_workers``, the engine falls back to
  advisory-only and journals the hold.

Every decision — holds included — is journaled as a ``policy_decision``
event carrying its evidence (identical holds are deduplicated to one per
``hold_journal_interval_s``; action decisions always land).
``elasticdl_policy_decisions_total{action=...}`` counts them and
``elasticdl_policy_kill_budget_remaining`` / ``elasticdl_policy_thrash``
expose the enforcement state.  ``note_slo_alert`` takes the SLO plane's
alert edges (``master/job_runner._build_slo_plane`` binds it; a serving
fleet's ``serving/supervisor.SLOAlertFollower`` forwards its replicas');
fired SLOs ride every decision as ``slo_advisory``.  An alert is
advisory only: it never evicts or rescales.  The engine tracks each
alert per SLO and origin, so several replicas firing one SLO are
several alerts (JAX keys them by SLO alone, ``elasticdl_tpu/master/
policy.py:274-275``, and dedups their holds by SLO alone, ``:717``: a
second replica's fire went unjournaled and the first one's clear
dropped the SLO from the advisory while the second still paged).

Threading: ``tick()`` runs on the engine's own daemon thread;
``gate_scale_up`` is called from the pod manager's monitor thread.  All
shared state is guarded by the engine lock, and enforcement calls into
the manager (``kill_worker``, ``scale``) happen OUTSIDE it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("master.policy")

#: The closed decision taxonomy (metric label values).
ACTIONS = ("scale_up", "scale_down", "evict", "hold")

#: Ledger phases charged to rescales — the thrash signal's numerator.
RESCALE_OVERHEAD_PHASES = ("rendezvous", "scaling_wait", "requeue_redo")


@dataclass
class PolicyConfig:
    """Tuning surface (master flags --policy_*).  On/off lives with the
    caller: job_runner simply doesn't build an engine when
    --policy_enabled is false."""

    tick_interval_s: float = 2.0
    #: Scale-up must pay for its measured rescale cost within this window.
    amortize_horizon_s: float = 600.0
    #: Enforcement floor: no decision may shrink the fleet below this.
    min_workers: int = 1
    #: Consecutive flagged TICKS (not snapshots) before an eviction.
    evict_after_ticks: int = 3
    #: Straggler kills allowed per window; 0 = advisory-only forever.
    kill_budget: int = 1
    kill_budget_window_s: float = 600.0
    #: Post-rescale cooldown = max(min_cooldown_s, factor * last cost).
    cooldown_factor: float = 4.0
    min_cooldown_s: float = 30.0
    #: Thrash detection window over the goodput ledger's phase seconds.
    thrash_window_s: float = 120.0
    thrash_rescales: int = 2
    thrash_overhead_frac: float = 0.25
    #: Consecutive thrashy ticks before the park-at-floor scale-down.
    scale_down_after: int = 2
    #: Identical consecutive holds journal at most this often.
    hold_journal_interval_s: float = 30.0

    @classmethod
    def from_args(cls, args) -> "PolicyConfig":
        """Build from parsed master args; flags absent on old arg
        namespaces fall back to the dataclass defaults."""
        config = cls()
        for field_name, flag in (
            ("tick_interval_s", "policy_tick_interval_s"),
            ("amortize_horizon_s", "policy_amortize_horizon_s"),
            ("min_workers", "policy_min_workers"),
            ("evict_after_ticks", "policy_evict_after"),
            ("kill_budget", "policy_kill_budget"),
            ("kill_budget_window_s", "policy_kill_budget_window_s"),
        ):
            value = getattr(args, flag, None)
            if value is not None:
                setattr(config, field_name, value)
        return config


class ElasticPolicyEngine:
    """Master-tick policy evaluation over ledger + telemetry + fleet state.

    Construct, ``bind(manager)``, then either ``start()`` the tick thread
    or drive ``tick()`` directly (tests use an injected clock).  The
    manager surface consumed: ``current_worker_ids()``, ``kill_worker()``,
    ``scale()``.
    """

    def __init__(
        self,
        config: Optional[PolicyConfig] = None,
        manager=None,
        ledger=None,
        stragglers_fn: Optional[Callable[[], Dict[int, dict]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or PolicyConfig()
        self._clock = clock
        self._ledger = ledger
        self._stragglers_fn = stragglers_fn

        self._lock = make_lock("ElasticPolicyEngine._lock")
        self._manager = manager  # guarded-by: _lock
        self._flagged: Dict[int, dict] = {}  # guarded-by: _lock
        self._flag_streak: Dict[int, int] = {}  # guarded-by: _lock
        self._kills_spent = 0  # guarded-by: _lock
        self._kill_window_start = self._clock()  # guarded-by: _lock
        self._thrash_strikes = 0  # guarded-by: _lock
        self._in_thrash = False  # guarded-by: _lock
        # (t, total_s, overhead_s, rescale_seq) ledger samples, pruned to
        # the thrash window — the windowed-goodput view the cumulative
        # ledger cannot give directly.
        self._window: List[tuple] = []  # guarded-by: _lock
        # (reason, worker_id) -> last journaled t: dedup is PER KEY, or
        # two hold sources alternating reasons (the gate's denials
        # racing the tick's steady hold) would defeat the interval —
        # and DISTINCT workers' eviction-fallback holds are distinct
        # evidence, never deduped against each other.
        self._last_hold: Dict[tuple, float] = {}  # guarded-by: _lock
        # (slo name, origin) -> fire evidence from the SLO plane
        # (obs/slo.py) — advisory only: the names ride every journaled
        # decision as `slo_advisory`.
        self._slo_alerts: Dict[tuple, dict] = {}  # guarded-by: _lock
        self._last_decision: Optional[dict] = None  # guarded-by: _lock
        self._last_scale_action_t = float("-inf")  # guarded-by: _lock
        self._pre_approval_scale_t = float("-inf")  # guarded-by: _lock
        # Pre-scale-down fleet size, remembered while parked at the
        # floor; restored (as a target, through the capacity oracle +
        # this engine's own scale-up gate) once thrash clears.
        self._parked_target: Optional[int] = None  # guarded-by: _lock
        self._stopped = False  # guarded-by: _lock

        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self._m_decisions = obs.counter(
            "elasticdl_policy_decisions_total",
            "Elastic policy decisions journaled, by action",
            labelnames=("action",),
        )
        self._m_evictions = obs.counter(
            "elasticdl_policy_evictions_total",
            "Workers killed by the straggler-eviction enforcement path",
        )
        obs.gauge(
            "elasticdl_policy_kill_budget_remaining",
            "Straggler kills left in the current budget window",
        ).set_function(self.kill_budget_remaining)
        obs.gauge(
            "elasticdl_policy_thrash",
            "1 while the policy engine judges the job to be in rescale "
            "thrash (scale-ups suppressed)",
        ).set_function(lambda: 1 if self._in_thrash else 0)

    # ------------------------------------------------------------------
    # Wiring / lifecycle
    # ------------------------------------------------------------------

    def bind(self, manager) -> "ElasticPolicyEngine":
        with self._lock:
            self._manager = manager
        return self

    def start(self) -> "ElasticPolicyEngine":
        self._thread = threading.Thread(
            target=self._tick_loop, name="policy-engine-tick", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._stopped = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _tick_loop(self):
        while True:
            self._wake.wait(self.config.tick_interval_s)
            with self._lock:
                if self._stopped:
                    return
            try:
                self.tick()
            except Exception:
                # Policy must never take the control plane down: a tick
                # that dies logs and the next one retries.
                logger.exception("Policy tick failed")

    def _ledger_obj(self):
        if self._ledger is not None:
            return self._ledger
        from elasticdl_tpu_torch.obs import goodput

        return goodput.ledger()

    # ------------------------------------------------------------------
    # Telemetry-plane input (straggler advisory -> enforcement candidate)
    # ------------------------------------------------------------------

    def note_straggler(self, worker_id: int, flagged: bool, evidence=None):
        """Callback-mode input for callers WITHOUT a `stragglers_fn`:
        tracks the currently flagged set.  When a stragglers_fn is wired
        (the job_runner path) the per-tick poll is authoritative and
        overwrites this state — wire one mechanism, not both.  Eviction
        streaks advance per tick, not per callback — N heartbeats inside
        one tick are still one tick."""
        with self._lock:
            if flagged:
                self._flagged[worker_id] = dict(evidence or {})
            else:
                self._flagged.pop(worker_id, None)
                self._flag_streak.pop(worker_id, None)
                self._prune_holds_locked(self._flagged)

    def note_slo_alert(self, slo: str, alerting: bool, evidence=None):
        """SLO-plane input (the SLO registry's alert callback,
        ``obs/slo.SLORegistry.add_alert_callback``): track the fired set
        and journal the edge as an advisory hold.  A clear for
        an SLO that never fired here is dropped — a follower replaying
        an old journal tail must not emit phantom clears.  Each origin's
        alert (a fleet's replicas share SLO names) fires and clears on
        its own."""
        now = self._clock()
        slo = str(slo)
        evidence = dict(evidence or {})
        key = (slo, str(evidence.get("origin", "")))
        with self._lock:
            if alerting:
                self._slo_alerts[key] = evidence
            elif self._slo_alerts.pop(key, None) is None:
                return
        self._hold(
            now,
            "slo_alert" if alerting else "slo_alert_cleared",
            slo=slo,
            **{k: evidence[k] for k in
               ("grade", "burn_rates", "budget_remaining_ratio",
                "offending", "origin") if k in evidence},
        )

    def slo_alerts(self) -> Dict[str, dict]:
        """Currently-fired SLO alerts: name -> fire evidence (of the
        first origin, by name, when several fired it)."""
        alerts: Dict[str, dict] = {}
        with self._lock:
            for (name, _origin), ev in sorted(self._slo_alerts.items()):
                alerts.setdefault(name, dict(ev))
        return alerts

    def _prune_holds_locked(self, flagged) -> None:
        """Drop per-worker hold-dedup entries for workers no longer
        flagged — worker ids are minted monotonically on every relaunch,
        so without pruning an advisory-only deployment (kill_budget=0)
        accretes a (reason, wid) entry per straggler forever."""
        for key in [
            k for k in self._last_hold
            if k[1] is not None and k[1] not in flagged
        ]:
            del self._last_hold[key]

    def last_decision(self) -> Optional[dict]:
        with self._lock:
            return dict(self._last_decision) if self._last_decision else None

    def kill_budget_remaining(self) -> int:
        now = self._clock()
        with self._lock:
            self._refill_budget_locked(now)
            return max(0, self.config.kill_budget - self._kills_spent)

    def _refill_budget_locked(self, now: float):
        if now - self._kill_window_start >= self.config.kill_budget_window_s:
            self._kills_spent = 0
            self._kill_window_start = now

    # ------------------------------------------------------------------
    # The tick
    # ------------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass; returns the decisions made (tests drive
        this directly with a fake clock)."""
        now = self._clock() if now is None else now
        thrash_evidence = self._update_thrash(now)
        decisions = self._evict_pass(now)
        scale_down = self._scale_down_pass(now, thrash_evidence)
        if scale_down is not None:
            decisions.append(scale_down)
        restore = self._restore_pass(now)
        if restore is not None:
            decisions.append(restore)
        if not decisions:
            reason = (
                "rescale_thrash" if thrash_evidence.get("thrash") else "steady"
            )
            hold = self._hold(now, reason, **thrash_evidence)
            if hold is not None:
                decisions.append(hold)
        return decisions

    def _update_thrash(self, now: float) -> dict:
        """Slide the ledger-sample window and re-judge the thrash state."""
        ledger = self._ledger_obj()
        seconds = ledger.phase_seconds()
        total = sum(seconds.values())
        overhead = sum(seconds.get(p, 0.0) for p in RESCALE_OVERHEAD_PHASES)
        seq = ledger.counts()["rescales"]
        config = self.config
        with self._lock:
            self._window.append((now, total, overhead, seq))
            horizon = now - config.thrash_window_s
            while len(self._window) > 1 and self._window[1][0] <= horizon:
                self._window.pop(0)
            t0, total0, overhead0, seq0 = self._window[0]
            d_total = max(0.0, total - total0)
            d_overhead = max(0.0, overhead - overhead0)
            d_rescales = seq - seq0
            frac = (d_overhead / d_total) if d_total > 0 else 0.0
            thrash = (
                d_rescales >= config.thrash_rescales
                and frac >= config.thrash_overhead_frac
            )
            self._in_thrash = thrash
            if thrash:
                self._thrash_strikes += 1
            else:
                self._thrash_strikes = 0
            return {
                "thrash": thrash,
                "window_rescales": d_rescales,
                "window_overhead_frac": round(frac, 4),
                "window_s": round(now - t0, 3),
            }

    # ------------------------------------------------------------------
    # (c) Straggler eviction — enforcement with hysteresis + kill budget
    # ------------------------------------------------------------------

    def _evict_pass(self, now: float) -> List[dict]:
        config = self.config
        if self._stragglers_fn is not None:
            # Poll-mode wiring (no callback plumbing): refresh the
            # flagged set from the aggregator each tick.
            try:
                current = dict(self._stragglers_fn())
            except Exception:
                # Telemetry glitch: with no fresh evidence this tick,
                # eviction streaks must NOT advance on the stale flagged
                # set — a worker that recovered during the outage would
                # otherwise accrue ticks toward a kill it no longer
                # deserves.  Freeze the pass entirely.
                logger.warning(
                    "Straggler poll failed; eviction pass skipped this "
                    "tick", exc_info=True,
                )
                return []
            with self._lock:
                self._flagged = current
                for wid in [
                    w for w in self._flag_streak if w not in current
                ]:
                    del self._flag_streak[wid]
                self._prune_holds_locked(current)
        with self._lock:
            manager = self._manager
            flagged = dict(self._flagged)
            for wid in flagged:
                self._flag_streak[wid] = self._flag_streak.get(wid, 0) + 1
            due = [
                (wid, streak)
                for wid, streak in self._flag_streak.items()
                if streak >= config.evict_after_ticks and wid in flagged
            ]
        decisions: List[dict] = []
        if manager is None:
            return decisions
        killed_ids: set = set()
        for wid, streak in sorted(due):
            world = manager.current_worker_ids()
            if wid not in world:
                # Churned away between flag and enforcement; nothing to do.
                with self._lock:
                    self._flagged.pop(wid, None)
                    self._flag_streak.pop(wid, None)
                    self._prune_holds_locked(self._flagged)
                continue
            evidence = {
                "worker_id": wid,
                "flag_streak_ticks": streak,
                "world_size": len(world),
                "straggler_evidence": flagged.get(wid, {}),
            }
            # Workers killed earlier THIS pass may still appear in
            # current_worker_ids() (the kill only signals; the monitor
            # reaps the exit later) — count the ones STILL PRESENT
            # against the floor, or two same-tick evictions could breach
            # min_workers; already-reaped victims are out of `world` and
            # must not be double-counted.
            pending_kills = sum(1 for k in killed_ids if k in world)
            if len(world) - pending_kills - 1 < config.min_workers:
                hold = self._hold(
                    now, "min_workers_floor",
                    min_workers=config.min_workers, **evidence,
                )
                if hold is not None:
                    decisions.append(hold)
                continue
            with self._lock:
                self._refill_budget_locked(now)
                budget_left = config.kill_budget - self._kills_spent
                if budget_left > 0:
                    self._kills_spent += 1
            if budget_left <= 0:
                hold = self._hold(
                    now, "kill_budget_exhausted",
                    kill_budget=config.kill_budget,
                    kill_budget_window_s=config.kill_budget_window_s,
                    **evidence,
                )
                if hold is not None:
                    decisions.append(hold)
                continue
            try:
                # Kill OUTSIDE the engine lock (on k8s this blocks on an
                # HTTP DELETE).  The death converts to churn: the world
                # re-forms without the straggler, which never rejoins
                # (worker ids are never reused).
                manager.kill_worker(wid, 9)
            except Exception:
                with self._lock:  # the token wasn't used; give it back
                    self._kills_spent = max(0, self._kills_spent - 1)
                logger.warning(
                    "Eviction of straggler worker %d failed (already "
                    "gone?)", wid,
                )
                continue
            self._m_evictions.inc()
            killed_ids.add(wid)
            with self._lock:
                self._flagged.pop(wid, None)
                self._flag_streak.pop(wid, None)
                remaining = max(0, config.kill_budget - self._kills_spent)
            decisions.append(
                self._decide(
                    now, "evict", "persistent_straggler",
                    kill_budget_remaining=remaining, **evidence,
                )
            )
        return decisions

    # ------------------------------------------------------------------
    # (b) Scale-down / hold under rescale thrash
    # ------------------------------------------------------------------

    def _scale_down_pass(self, now: float, thrash_evidence: dict):
        config = self.config
        with self._lock:
            manager = self._manager
            strikes = self._thrash_strikes
            cooled = now - self._last_scale_action_t >= self._cooldown_locked()
        if (
            manager is None
            or strikes < config.scale_down_after
            or not cooled
            # Mid-rescale the fleet is already draining/re-forming;
            # layering a second teardown on top would race the monitor.
            or self._ledger_obj().rescale_in_flight()
        ):
            return None
        world = manager.current_worker_ids()
        if len(world) <= config.min_workers:
            return None
        target = getattr(manager, "target_num_workers", lambda: len(world))()
        # One deliberate rescale (graceful drain + re-form at the floor)
        # instead of paying storm churn on every preempted worker.  The
        # decision journals — and the park state commits — only once the
        # scale actually happened: a substrate failure here must not
        # leave a false audit record or a parked target for a park that
        # never was.
        try:
            manager.scale(config.min_workers)
        except Exception:
            logger.exception(
                "Thrash scale-down to %d failed; retrying next tick",
                config.min_workers,
            )
            return None
        with self._lock:
            self._last_scale_action_t = now
            self._thrash_strikes = 0
            self._parked_target = max(len(world), target)
        return self._decide(
            now, "scale_down", "rescale_thrash",
            old_size=len(world), new_size=config.min_workers,
            thrash_strikes=strikes, **thrash_evidence,
        )

    def _restore_pass(self, now: float):
        """Storm over: once thrash clears and the post-rescale cooldown
        has elapsed, restore the parked pre-scale-down size as the
        manager's TARGET — the actual growth still flows through the
        capacity oracle and this engine's scale-up gate (which journals
        the scale_up decision when it approves the grant)."""
        with self._lock:
            manager = self._manager
            parked = self._parked_target
            blocked = self._in_thrash
        if manager is None or parked is None or blocked:
            return None
        ledger = self._ledger_obj()
        if ledger.rescale_in_flight():
            return None
        since = ledger.seconds_since_last_rescale()
        with self._lock:
            cooldown = self._cooldown_locked()
        if since is not None and since < cooldown:
            return None
        with self._lock:
            self._parked_target = None
        manager.set_target_num_workers(parked)
        return self._decide(
            now, "hold", "target_restored",
            restored_target=parked,
            since_last_rescale_s=round(since, 3) if since is not None else None,
        )

    def _cooldown_for(self, cost: float) -> float:
        """The one cooldown rule (gate, scale-down, and restore all key
        off it): expensive rescales earn longer quiet periods."""
        return max(
            self.config.min_cooldown_s, self.config.cooldown_factor * cost
        )

    def _cooldown_locked(self) -> float:
        last = self._ledger_obj().last_rescale()
        return self._cooldown_for(last["total_s"] if last else 0.0)

    # ------------------------------------------------------------------
    # (a) Scale-up gating — amortize the measured rescale cost
    # ------------------------------------------------------------------

    @staticmethod
    def _required_horizon(cost: float, n: int, k: int) -> float:
        """Amortization: k added workers gain k*(H - C) worker-seconds
        of new throughput over the horizon; the rescale pause costs the
        n-worker fleet n*C.  Uniform per-worker rate cancels out, so
        scale-up pays off iff H > C*(n + k)/k."""
        return cost * (n + k) / k if cost > 0 and k > 0 else 0.0

    def gate_scale_up(self, needed: int, grant) -> int:
        """Called by the pod manager's capacity path; returns the
        approved grant (0 = denied/hold).  Approval requires: no rescale
        in flight, not in thrash, cooldown elapsed, and the amortization
        inequality.  `grant` may be the oracle's already-computed int,
        or a callable `f(needed) -> int` deferring the oracle until the
        policy's own checks pass — the k8s probe consumes a
        once-per-cooldown token per call, and a denial must not burn it.
        """
        if needed <= 0:
            return 0
        config = self.config
        now = self._clock()
        ledger = self._ledger_obj()
        with self._lock:
            manager = self._manager
            in_thrash = self._in_thrash
        world = len(manager.current_worker_ids()) if manager is not None else 0
        if ledger.rescale_in_flight():
            self._hold(now, "rescale_in_flight", needed=needed)
            return 0
        if in_thrash:
            self._hold(
                now, "rescale_thrash", needed=needed, world_size=world
            )
            return 0
        last = ledger.last_rescale()
        since = ledger.seconds_since_last_rescale()
        cost = last["total_s"] if last else 0.0
        cooldown = self._cooldown_for(cost)
        if since is not None and since < cooldown:
            self._hold(
                now, "cooldown",
                cooldown_s=round(cooldown, 3),
                since_last_rescale_s=round(since, 3),
                last_rescale_cost_s=round(cost, 3),
            )
            return 0
        # Pre-check amortization at the LARGEST possible grant before
        # consulting the oracle: required horizon C*(n+k)/k shrinks as k
        # grows, so failing at k=needed fails for every smaller grant.
        n = max(1, world)
        required_full = self._required_horizon(cost, n, needed)
        if cost > 0 and config.amortize_horizon_s <= required_full:
            self._hold(
                now, "unamortized_rescale_cost",
                last_rescale_cost_s=round(cost, 3),
                horizon_s=config.amortize_horizon_s,
                required_horizon_s=round(required_full, 3),
                world_size=world, needed=needed,
            )
            return 0
        grant = grant(needed) if callable(grant) else grant
        if grant <= 0:
            return 0  # no capacity offered: nothing to decide
        # A partial grant must re-clear the bar (smaller k needs a
        # longer horizon); the probe token is already spent — rare and
        # bounded, the price of not knowing the grant up front.
        required_horizon = self._required_horizon(cost, n, grant)
        if cost > 0 and config.amortize_horizon_s <= required_horizon:
            self._hold(
                now, "unamortized_rescale_cost",
                last_rescale_cost_s=round(cost, 3),
                horizon_s=config.amortize_horizon_s,
                required_horizon_s=round(required_horizon, 3),
                world_size=world, granted=grant,
            )
            return 0
        with self._lock:
            # Remember the pre-approval stamp: on Kubernetes the grant
            # only launches PROBE pods, and a probe that never proves
            # capacity must hand the cooldown back (scale_up_aborted).
            self._pre_approval_scale_t = self._last_scale_action_t
            self._last_scale_action_t = now
        self._decide(
            now, "scale_up", "amortized",
            old_size=world, granted=grant,
            last_rescale_cost_s=round(cost, 3),
            horizon_s=config.amortize_horizon_s,
            required_horizon_s=round(required_horizon, 3),
        )
        return grant

    def scale_up_aborted(self):
        """An approved scale-up never materialized (the k8s capacity
        probe timed out or its pods died before the regrow committed).
        Roll the scale-action cooldown back so a legitimately needed
        thrash scale-down isn't suppressed by a rescale that never
        happened, and journal the retraction — the audit trail reads
        scale_up(amortized) followed by hold(scale_up_aborted)."""
        now = self._clock()
        with self._lock:
            self._last_scale_action_t = self._pre_approval_scale_t
        self._hold(now, "scale_up_aborted")

    # ------------------------------------------------------------------
    # Decision journaling
    # ------------------------------------------------------------------

    def _decide(self, now: float, action: str, reason: str, **evidence) -> dict:
        decision = {"action": action, "reason": reason, **evidence}
        with self._lock:
            if self._slo_alerts:
                decision.setdefault(
                    "slo_advisory", sorted({name for name, _ in self._slo_alerts})
                )
            self._last_decision = {**decision, "t": now}
            if action != "hold":
                # A real action resets the dedup: the holds after it are
                # news again.
                self._last_hold.clear()
        self._m_decisions.inc(action=action)
        obs.journal().record("policy_decision", **decision)
        if action != "hold":
            logger.info(
                "Policy decision: %s (%s) %s", action, reason, evidence
            )
        return decision

    def _hold(self, now: float, reason: str, **evidence) -> Optional[dict]:
        """Journal a hold, deduplicating each (reason, worker) to one per
        hold_journal_interval_s — the gate is polled every pod monitor
        tick and must not flood the journal, but different workers'
        eviction-fallback holds each carry their own evidence and always
        land.  SLO advisories dedup per (reason, slo, origin) the same
        way — distinct SLOs, or one SLO of distinct replicas, firing are
        distinct evidence."""
        key = (reason, evidence.get("worker_id"), evidence.get("slo"), evidence.get("origin"))
        with self._lock:
            last_t = self._last_hold.get(key, float("-inf"))
            if now - last_t < self.config.hold_journal_interval_s:
                return None
            self._last_hold[key] = now
        return self._decide(now, "hold", reason, **evidence)
