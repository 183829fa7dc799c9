"""Declarative SLOs with error-budget burn-rate alerting.

The port's copy of ``elasticdl_tpu/obs/slo.py``, stdlib only: it imports nothing of the
JAX package.

The sensor layer for serving autoscale (ROADMAP item 2) and the
freshness/goodput planes: each `SLOSpec` names an objective over
metrics already in the registry, `SLORegistry.evaluate(now)` turns the
`MetricsHistory` ring (obs/history.py) into burn rates, and alerting
follows the Google-SRE multi-window multi-burn-rate recipe:

    pair   short window   long window   burn threshold   grade
    fast   W/8640 (5m)    W/720 (1h)    14.4             page
    slow   W/720  (1h)    W/120 (6h)    6.0              warn

where W is the spec's rolling compliance window (the canonical 30-day
fractions, scaled to job time) and every window is clamped to
``min_window_s``.  ``burn_rate = bad_fraction(window) / (1 - objective)``
— burn 1.0 spends the budget exactly over the compliance window; an
alert pair fires only when BOTH its windows are over threshold (the
short window for reaction time, the long one to ignore blips).

Two spec kinds:

- ``ratio``      good/total counter deltas (serving availability from
                 the `AvailabilityLedger` outcome counters)
- ``threshold``  fraction of gauge samples beyond a bound (p99 latency
                 vs target, freshness lag, goodput ratio)

Events are schema-registered in scripts/validate_journal.py:
``slo_status`` (rate-limited, on tick) and ``slo_alert``
(edge-triggered fire/clear with evidence: per-window burn rates,
budget remaining, offending series).  Exported gauges:
``elasticdl_slo_burn_rate{slo,window}``,
``elasticdl_slo_budget_remaining_ratio{slo}``,
``elasticdl_slo_alerting{slo}`` — label values are spec names
(validated slugs) and the four window positions, both bounded
(metric-label-cardinality rule).

Clock discipline: `evaluate(now)`/`tick(now)` are caller-driven like
`FreshnessTracker.evaluate(now)`; `SLOPlane.start()` is the production
convenience that feeds `time.monotonic()` from a named daemon thread.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.obs.history import MetricsHistory

logger = get_logger("obs.slo")

_SLO_NAME_RE = re.compile(r"[a-z][a-z0-9_]{0,39}$")

#: Window positions, in (pair, length) order — the `window` label enum.
WINDOWS = ("fast_short", "fast_long", "slow_short", "slow_long")

#: Canonical 30-day-window fractions (5m/1h, 1h/6h), scaled to the
#: spec's compliance window.
WINDOW_FRACTIONS = {
    "fast_short": 1.0 / 8640.0,
    "fast_long": 1.0 / 720.0,
    "slow_short": 1.0 / 720.0,
    "slow_long": 1.0 / 120.0,
}

PAGE_BURN_THRESHOLD = 14.4
WARN_BURN_THRESHOLD = 6.0


@dataclass
class SLOSpec:
    """One objective over registry metrics.

    ``ratio`` kind: ``good_metric{good_labels}`` / all series of
    ``total_metric`` (counter deltas).  ``threshold`` kind: fraction of
    ``value_metric`` samples beyond ``threshold`` (``bad_when`` says
    which side is bad)."""

    name: str
    kind: str  # "ratio" | "threshold"
    objective: float  # target good fraction, e.g. 0.999
    compliance_window_s: float = 3600.0
    # ratio kind
    good_metric: str = ""
    good_labels: Dict[str, str] = field(default_factory=dict)
    total_metric: str = ""
    total_labels: Optional[Dict[str, str]] = None  # None = every series
    # threshold kind
    value_metric: str = ""
    threshold: float = 0.0
    bad_when: str = "above"  # or "below"
    # window scaling
    min_window_s: float = 5.0
    fast_burn_threshold: float = PAGE_BURN_THRESHOLD
    slow_burn_threshold: float = WARN_BURN_THRESHOLD

    def __post_init__(self):
        if not _SLO_NAME_RE.match(self.name):
            raise ValueError(f"Invalid SLO name {self.name!r}")
        if self.kind not in ("ratio", "threshold"):
            raise ValueError(f"Unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name}: objective must be in (0, 1), "
                f"got {self.objective}"
            )
        if self.bad_when not in ("above", "below"):
            raise ValueError(f"Unknown bad_when {self.bad_when!r}")

    def windows(self) -> Dict[str, float]:
        """Window name -> seconds, scaled + clamped."""
        w = float(self.compliance_window_s)
        return {
            name: min(w, max(float(self.min_window_s), w * frac))
            for name, frac in WINDOW_FRACTIONS.items()
        }

    def budget(self) -> float:
        """The allowed bad fraction (1 - objective), floored > 0."""
        return max(1e-9, 1.0 - float(self.objective))

    def metric_names(self) -> List[str]:
        if self.kind == "ratio":
            return sorted({self.good_metric, self.total_metric})
        return [self.value_metric]


# ---------------------------------------------------------------------------
# Built-in spec constructors (the four planes named by the roadmap)
# ---------------------------------------------------------------------------


def serving_availability_slo(objective: float = 0.999,
                             compliance_window_s: float = 3600.0,
                             min_window_s: float = 5.0) -> SLOSpec:
    """Good = served requests, total = every outcome, from the
    `AvailabilityLedger` counters."""
    return SLOSpec(
        name="serving_availability",
        kind="ratio",
        objective=objective,
        compliance_window_s=compliance_window_s,
        good_metric="elasticdl_serving_requests_total",
        good_labels={"outcome": "served"},
        total_metric="elasticdl_serving_requests_total",
        min_window_s=min_window_s,
    )


def serving_latency_slo(p99_ms: float, objective: float = 0.99,
                        compliance_window_s: float = 3600.0,
                        min_window_s: float = 5.0) -> SLOSpec:
    """p99 samples must stay under `p99_ms` for `objective` of the
    window (the ledger gauge is itself a sliding-window percentile)."""
    return SLOSpec(
        name="serving_latency",
        kind="threshold",
        objective=objective,
        compliance_window_s=compliance_window_s,
        value_metric="elasticdl_serving_latency_p99_ms",
        threshold=float(p99_ms),
        bad_when="above",
        min_window_s=min_window_s,
    )


def freshness_slo(lag_slo_s: float, objective: float = 0.99,
                  compliance_window_s: float = 3600.0,
                  min_window_s: float = 5.0) -> SLOSpec:
    """Event-time -> servable-model lag (obs/freshness.py gauge) under
    `lag_slo_s` — the windowed companion to the breach/clear edge."""
    return SLOSpec(
        name="freshness",
        kind="threshold",
        objective=objective,
        compliance_window_s=compliance_window_s,
        value_metric="elasticdl_freshness_lag_seconds",
        threshold=float(lag_slo_s),
        bad_when="above",
        min_window_s=min_window_s,
    )


def quality_slo(max_logloss: float, objective: float = 0.95,
                compliance_window_s: float = 3600.0,
                min_window_s: float = 5.0) -> SLOSpec:
    """Windowed online logloss (the quality ledger's
    `elasticdl_quality_logloss` gauge, obs/quality.py) must stay under
    `max_logloss` — the model-quality page.  The gauge reads 0.0 while
    no labels have joined, so quality-unknown never burns budget; a
    poisoned model that DOES get labeled burns fast and the alert's
    advisory evidence reaches the policy engine like every other SLO."""
    return SLOSpec(
        name="model_quality",
        kind="threshold",
        objective=objective,
        compliance_window_s=compliance_window_s,
        value_metric="elasticdl_quality_logloss",
        threshold=float(max_logloss),
        bad_when="above",
        min_window_s=min_window_s,
    )


def goodput_slo(ratio: float, objective: float = 0.95,
                compliance_window_s: float = 3600.0,
                min_window_s: float = 5.0) -> SLOSpec:
    """Goodput ledger ratio must stay ABOVE `ratio` (bad when below)."""
    return SLOSpec(
        name="goodput",
        kind="threshold",
        objective=objective,
        compliance_window_s=compliance_window_s,
        value_metric="elasticdl_goodput_ratio",
        threshold=float(ratio),
        bad_when="below",
        min_window_s=min_window_s,
    )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class SLORegistry:
    """Evaluates specs against a `MetricsHistory` on a caller tick.

    Burn/budget/alerting gauges land in the SAME registry the history
    samples — the burn-rate series therefore has history of its own,
    which is what the `/slo` sparklines render."""

    def __init__(self, history: MetricsHistory, specs=(),
                 status_interval_s: float = 10.0, origin: str = ""):
        self.history = history
        self.status_interval_s = float(status_interval_s)
        self.origin = str(origin)
        self._lock = make_lock("SLORegistry._lock")
        self._specs: Dict[str, SLOSpec] = {}  # guarded-by: _lock
        self._alerting: Dict[str, str] = {}  # name -> grade, guarded-by: _lock
        self._statuses: Dict[str, dict] = {}  # guarded-by: _lock
        self._last_status_t = float("-inf")  # guarded-by: _lock
        self._callbacks: List[Callable[[str, bool, dict], None]] = []  # guarded-by: _lock
        self._exemplar_provider: Optional[Callable[[str], List[str]]] = None  # guarded-by: _lock
        registry = history.registry
        self._g_burn = registry.gauge(
            "elasticdl_slo_burn_rate",
            "Error-budget burn rate per evaluation window",
            labelnames=("slo", "window"),
        )
        self._g_budget = registry.gauge(
            "elasticdl_slo_budget_remaining_ratio",
            "Fraction of the error budget left over the compliance window",
            labelnames=("slo",),
        )
        self._g_alerting = registry.gauge(
            "elasticdl_slo_alerting",
            "1 while the SLO has a fired burn-rate alert",
            labelnames=("slo",),
        )
        for spec in specs:
            self.add(spec)

    def add(self, spec: SLOSpec) -> SLOSpec:
        with self._lock:
            if spec.name in self._specs:
                raise ValueError(f"SLO {spec.name} already registered")
            self._specs[spec.name] = spec
        self._g_alerting.set(0, slo=spec.name)
        self._g_budget.set(1.0, slo=spec.name)
        return spec

    def add_alert_callback(
        self, fn: Callable[[str, bool, dict], None]
    ) -> None:
        """fn(slo_name, alerting, evidence) on every fire/clear edge."""
        with self._lock:
            self._callbacks.append(fn)

    def set_exemplar_provider(
        self, fn: Callable[[str], List[str]]
    ) -> None:
        """fn(slo_name) -> trace ids attached to FIRE edges as evidence.

        Wired by the serving replica to its ExemplarSampler so a latency
        page carries the slowest sampled request trace ids — resolvable
        in the Perfetto trace built from the same journal.  Trace ids
        ride the alert event/evidence (unbounded values), never a metric
        label (metric-label-cardinality rule)."""
        with self._lock:
            self._exemplar_provider = fn

    def specs(self) -> List[SLOSpec]:
        with self._lock:
            return list(self._specs.values())

    def alerting(self) -> Dict[str, str]:
        """Currently-fired SLOs: name -> grade."""
        with self._lock:
            return dict(self._alerting)

    def statuses(self) -> List[dict]:
        """Last-evaluated status per spec (the `/slo` payload rows)."""
        with self._lock:
            return [dict(s) for _n, s in sorted(self._statuses.items())]

    # -- evaluation ------------------------------------------------------

    def _bad_fraction(self, spec: SLOSpec, window_s: float,
                      now: float) -> Optional[float]:
        """Bad fraction over the window; None = no data (not a breach)."""
        if spec.kind == "ratio":
            total = self.history.delta(
                spec.total_metric, window_s, now, labels=spec.total_labels
            )
            if total <= 0:
                return None
            good = self.history.delta(
                spec.good_metric, window_s, now, labels=spec.good_labels
            )
            return min(1.0, max(0.0, 1.0 - good / total))
        frac = self.history.threshold_fraction(
            spec.value_metric, window_s, spec.threshold, now,
            above=(spec.bad_when == "above"),
        )
        return frac

    def _offending(self, spec: SLOSpec, window_s: float, now: float) -> str:
        """The series that burned the budget, as `metric{labels}`."""
        if spec.kind == "threshold":
            return spec.value_metric
        worst = None
        for labels, inc in self.history.series_deltas(
            spec.total_metric, window_s, now
        ):
            if all(labels.get(k) == str(v)
                   for k, v in spec.good_labels.items()):
                continue  # the good series never offends
            if inc > 0 and (worst is None or inc > worst[1]):
                worst = (labels, inc)
        if worst is None:
            return spec.total_metric
        rendered = ",".join(f"{k}={v}" for k, v in sorted(worst[0].items()))
        return f"{spec.total_metric}{{{rendered}}}"

    def _status_for(self, spec: SLOSpec, now: float) -> dict:
        windows = spec.windows()
        budget = spec.budget()
        burn_rates: Dict[str, float] = {}
        for wname, wsec in windows.items():
            frac = self._bad_fraction(spec, wsec, now)
            burn_rates[wname] = round((frac or 0.0) / budget, 4)
        compliance_frac = self._bad_fraction(
            spec, spec.compliance_window_s, now
        )
        budget_remaining = min(1.0, max(
            0.0, 1.0 - (compliance_frac or 0.0) / budget
        ))
        page = (burn_rates["fast_short"] > spec.fast_burn_threshold
                and burn_rates["fast_long"] > spec.fast_burn_threshold)
        warn = (burn_rates["slow_short"] > spec.slow_burn_threshold
                and burn_rates["slow_long"] > spec.slow_burn_threshold)
        grade = "page" if page else ("warn" if warn else "")
        offending = (
            self._offending(spec, windows["fast_long"], now) if grade else ""
        )
        return {
            "slo": spec.name,
            "kind": spec.kind,
            "objective": spec.objective,
            "window_s": spec.compliance_window_s,
            "bad_fraction": round(compliance_frac or 0.0, 6),
            "budget_remaining_ratio": round(budget_remaining, 4),
            "burn_rates": burn_rates,
            "alerting": bool(grade),
            "grade": grade,
            "offending": offending,
            "origin": self.origin,
        }

    def evaluate(self, now: float) -> List[dict]:
        """Evaluate every spec at `now`; returns the `slo_alert` edge
        events journaled this tick (possibly empty).  Journal writes and
        callbacks run outside the lock."""
        now = float(now)
        statuses = [self._status_for(spec, now) for spec in self.specs()]
        edges: List[dict] = []
        status_due = False
        with self._lock:
            if now - self._last_status_t >= self.status_interval_s:
                self._last_status_t = now
                status_due = True
            for status in statuses:
                name = status["slo"]
                self._statuses[name] = status
                was = name in self._alerting
                if status["alerting"] and not was:
                    self._alerting[name] = status["grade"]
                    edges.append(dict(status, state="fire"))
                elif not status["alerting"] and was:
                    fired_grade = self._alerting.pop(name)
                    edges.append(dict(status, state="clear",
                                      grade=fired_grade))
                elif status["alerting"]:
                    self._alerting[name] = status["grade"]
            callbacks = list(self._callbacks)
            exemplar_provider = self._exemplar_provider
        for status in statuses:
            name = status["slo"]
            for wname, burn in status["burn_rates"].items():
                self._g_burn.set(burn, slo=name, window=wname)
            self._g_budget.set(status["budget_remaining_ratio"], slo=name)
            self._g_alerting.set(1 if status["alerting"] else 0, slo=name)
        journal = obs.journal()
        if status_due:
            for status in statuses:
                journal.record(
                    "slo_status",
                    slo=status["slo"],
                    kind=status["kind"],
                    objective=status["objective"],
                    window_s=status["window_s"],
                    bad_fraction=status["bad_fraction"],
                    budget_remaining_ratio=status["budget_remaining_ratio"],
                    burn_rates=status["burn_rates"],
                    alerting=status["alerting"],
                    grade=status["grade"],
                    origin=status["origin"],
                )
        for edge in edges:
            exemplars: List[str] = []
            if edge["state"] == "fire" and exemplar_provider is not None:
                try:
                    exemplars = [str(t) for t
                                 in exemplar_provider(edge["slo"]) if t]
                except Exception:
                    logger.exception("SLO exemplar provider failed")
            extra = {"exemplars": exemplars} if exemplars else {}
            journal.record(
                "slo_alert",
                slo=edge["slo"],
                state=edge["state"],
                grade=edge["grade"],
                burn_rates=edge["burn_rates"],
                budget_remaining_ratio=edge["budget_remaining_ratio"],
                offending=edge["offending"],
                origin=edge["origin"],
                **extra,
            )
            if edge["state"] == "fire":
                logger.warning(
                    "SLO ALERT %s [%s]: burn %s, budget %.1f%% left "
                    "(offending: %s)",
                    edge["slo"], edge["grade"], edge["burn_rates"],
                    100.0 * edge["budget_remaining_ratio"],
                    edge["offending"] or "-",
                )
            else:
                logger.info("SLO alert cleared: %s", edge["slo"])
            evidence = {
                "grade": edge["grade"],
                "burn_rates": edge["burn_rates"],
                "budget_remaining_ratio": edge["budget_remaining_ratio"],
                "offending": edge["offending"],
                "origin": edge["origin"],
            }
            if exemplars:
                evidence["exemplars"] = exemplars
            for fn in callbacks:
                try:
                    fn(edge["slo"], edge["state"] == "fire", evidence)
                except Exception:
                    logger.exception("SLO alert callback failed")
        return edges


# ---------------------------------------------------------------------------
# Plane: history + registry + tick thread + /slo payload
# ---------------------------------------------------------------------------


class SLOPlane:
    """One process's SLO sensor: a `MetricsHistory` sampler and an
    `SLORegistry`, ticked together.  `tick(now)` is the deterministic
    entry point (tests, chaos drivers, the replica telemetry loop);
    `start()` runs a wall-clock tick thread for the master."""

    def __init__(self, registry=None, specs=(),
                 tick_interval_s: float = 2.0,
                 status_interval_s: float = 10.0, origin: str = "",
                 max_series: int = 256, max_samples: int = 512):
        self.history = MetricsHistory(
            registry, max_series=max_series, max_samples=max_samples
        )
        self.slos = SLORegistry(
            self.history, specs,
            status_interval_s=status_interval_s, origin=origin,
        )
        self.tick_interval_s = float(tick_interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticks = 0

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """Sample + evaluate once; `now` defaults to the wall clock."""
        import time
        now = time.monotonic() if now is None else float(now)
        now = self.history.sample(now)
        self._ticks += 1
        return self.slos.evaluate(now)

    def start(self, interval_s: Optional[float] = None) -> "SLOPlane":
        if self._thread is not None:
            return self
        if interval_s is not None:
            self.tick_interval_s = float(interval_s)

        def _loop():
            while not self._stop.wait(self.tick_interval_s):
                try:
                    self.tick()
                except Exception:
                    logger.exception("SLO tick failed")

        self._thread = threading.Thread(
            target=_loop, name="slo-plane-tick", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            self._thread = None

    def snapshot(self, samples_per_series: int = 32) -> dict:
        """The bounded `/slo` endpoint payload: statuses (each with a
        fast-window burn-rate sparkline), the headline metric series,
        and the alert set.  Nothing unbounded, no file paths."""
        samples_per_series = min(128, max(1, int(samples_per_series)))
        statuses = self.slos.statuses()
        names: List[str] = []
        for spec in self.slos.specs():
            for metric in spec.metric_names():
                names.extend((metric, metric + "_count", metric + "_sum"))
        for status in statuses:
            status["sparkline"] = [
                round(v, 4) for v in self.history.sparkline(
                    "elasticdl_slo_burn_rate", n=samples_per_series,
                    labels={"slo": status["slo"], "window": "fast_short"},
                )
            ]
        return {
            "origin": self.slos.origin,
            "ticks": self._ticks,
            "alerting": sorted(self.slos.alerting()),
            "statuses": statuses,
            "series": self.history.snapshot(
                max_series=16, samples_per_series=samples_per_series,
                names=names,
            ),
        }


# ---------------------------------------------------------------------------
# Selftest
# ---------------------------------------------------------------------------


def _selftest() -> int:
    """Deterministic burn-rate run on a virtual clock: a latency
    regression trips the fast pair within bounded ticks and clears
    after draining; an all-served availability SLO never fires; a
    control run with no fault journals zero alerts."""
    import json
    import os
    import tempfile

    from elasticdl_tpu_torch.obs.metrics import MetricsRegistry

    def run(fault: bool, tmp: str):
        obs.init_journal(tmp)
        registry = MetricsRegistry()
        p99 = registry.gauge("elasticdl_serving_latency_p99_ms", "")
        served = registry.counter(
            "elasticdl_serving_requests_total", "", labelnames=("outcome",)
        )
        plane = SLOPlane(
            registry=registry,
            specs=[
                serving_latency_slo(
                    20.0, objective=0.99, compliance_window_s=7200.0
                ),
                serving_availability_slo(
                    0.999, compliance_window_s=7200.0
                ),
            ],
            status_interval_s=10.0,
            origin="selftest",
        )
        edges = []
        plane.slos.add_alert_callback(
            lambda slo, alerting, ev: edges.append((slo, alerting))
        )
        fired_tick = cleared_tick = None
        for tick in range(240):
            p99.set(50.0 if fault and 60 <= tick < 120 else 2.0)
            served.inc(100, outcome="served")
            plane.tick(float(tick))
            alerting = plane.slos.alerting()
            if fired_tick is None and alerting:
                fired_tick = tick
            if fired_tick is not None and cleared_tick is None \
                    and tick >= 120 and not alerting:
                cleared_tick = tick
        return plane, edges, fired_tick, cleared_tick

    with tempfile.TemporaryDirectory() as tmp:
        plane, edges, fired, cleared = run(fault=True, tmp=tmp)
        assert fired is not None and 60 < fired <= 90, fired
        assert cleared is not None and cleared <= 200, cleared
        assert edges == [("serving_latency", True),
                         ("serving_latency", False)], edges
        events = [json.loads(line)
                  for line in open(os.path.join(tmp, "events.jsonl"))]
        alerts = [e for e in events if e.get("event") == "slo_alert"]
        assert [a["state"] for a in alerts] == ["fire", "clear"], alerts
        assert alerts[0]["grade"] == "page", alerts[0]
        assert alerts[0]["offending"] == \
            "elasticdl_serving_latency_p99_ms", alerts[0]
        for alert in alerts:
            for need in ("slo", "state", "burn_rates",
                         "budget_remaining_ratio", "origin"):
                assert need in alert, (need, alert)
        statuses = [e for e in events if e.get("event") == "slo_status"]
        assert 20 <= len(statuses) <= 80, len(statuses)
        for status in statuses:
            for need in ("slo", "budget_remaining_ratio"):
                assert need in status, (need, status)
        latency = plane.slos.statuses()[1]
        assert latency["slo"] == "serving_latency", latency
        assert latency["budget_remaining_ratio"] < 1.0, latency
        snap = plane.snapshot()
        assert snap["statuses"] and snap["series"], snap.keys()
        assert not snap["alerting"], snap["alerting"]

    with tempfile.TemporaryDirectory() as tmp:
        _plane, edges, fired, _cleared = run(fault=False, tmp=tmp)
        assert fired is None and not edges, (fired, edges)
        lines = open(os.path.join(tmp, "events.jsonl")).read()
        assert '"slo_alert"' not in lines, "control run fired an alert"

    print("slo selftest: OK")
    return 0


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="SLO plane")
    parser.add_argument("--selftest", action="store_true")
    args = parser.parse_args(argv)
    if args.selftest:
        return _selftest()
    parser.error("nothing to do (use --selftest)")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
