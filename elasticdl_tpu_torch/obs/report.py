"""``python -m elasticdl_tpu_torch.obs.report`` — postmortem goodput timeline.

The port's copy of ``elasticdl_tpu/obs/report.py``, stdlib only: it imports nothing of the
JAX package.

Replays a control-plane event journal (JSONL) into the same phase
accounting the live goodput ledger keeps (obs/goodput.py), so a chaos
run and a production incident get identical forensics:

    python -m elasticdl_tpu_torch.obs.report /logs/job1/events.jsonl
    python -m elasticdl_tpu_torch.obs.report events.jsonl --json summary.json
    python -m elasticdl_tpu_torch.obs.report events.jsonl --scrape :9090/metrics
    python -m elasticdl_tpu_torch.obs.report --selftest tests/golden_journal.jsonl

Output: a human-readable timeline (one line per phase segment, rescale
and churn markers inline), an attribution table (seconds and share of
wall-clock per phase), a compute-phase attribution table (the step
anatomy's data_wait/stage/compile/execute/bookkeep split from
`step_anatomy` events, with per-worker dominant phases, straggler
bottleneck evidence, and `profile_window` pointers at the TensorBoard
traces covering anomalous windows), a per-rescale cost breakdown
(detection/rendezvous/redo), an error-budget section (the SLO plane's
``slo_status``/``slo_alert`` events replayed into a breach timeline,
with shed-reason and goodput-phase attribution per breach), and a
one-line verdict ("job ran 41m,
goodput 87.3%; rescale #2 cost 93s: ...").  `--json` writes the same
facts machine-readably.

Reconstruction rules (mirroring the ledger's):

- The journal's `ts` (master wall-clock at write time) is authoritative;
  events sort by it, and segment durations derive from consecutive
  timestamps — the `seconds` field each `phase_transition` carries is a
  cross-check, not the source of truth (a restarted master's monotonic
  clock does not span generations).
- A `master_start` event after other events marks a master restart: the
  gap since the previous event is attributed as an `idle` segment with
  cause `master_outage` — the downtime nobody was alive to account.
- Goodput = training + degraded_straggler (same GOODPUT_PHASES as the
  live gauge); `requeue_redo` is replay waste, everything else is
  overhead.

`--scrape` joins a live (or saved) /metrics exposition: the report
prints the exporter's `elasticdl_goodput_ratio` next to the replayed
one so drift between the live gauge and the journal is visible.
Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import Dict, List, Optional, Tuple

from elasticdl_tpu_torch.obs.goodput import GOODPUT_PHASES, PHASES


def load_events(path: str) -> List[dict]:
    """Parse a JSONL journal, dropping malformed lines (a SIGKILLed
    master may tear its final line), sorted by master timestamp."""
    events = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and isinstance(
                rec.get("ts"), (int, float)
            ):
                events.append(rec)
    events.sort(key=lambda e: e["ts"])
    return events


def build_timeline(events: List[dict]) -> Tuple[List[dict], List[dict]]:
    """Fold events into contiguous phase segments.

    Returns (segments, outages); each segment is {"start_ts", "end_ts",
    "seconds", "phase", "cause"}; outages (also present in segments as
    idle/master_outage) are listed separately for attribution."""
    segments: List[dict] = []
    outages: List[dict] = []
    phase = None
    cause = ""
    seg_start = None
    last_ts = None

    def close(end_ts: float):
        nonlocal seg_start
        if phase is None or seg_start is None:
            seg_start = end_ts
            return
        seconds = max(0.0, end_ts - seg_start)
        if seconds > 0 or not segments:
            segments.append(
                {
                    "start_ts": seg_start,
                    "end_ts": end_ts,
                    "seconds": seconds,
                    "phase": phase,
                    "cause": cause,
                }
            )
        seg_start = end_ts

    for event in events:
        ts = event["ts"]
        kind = event.get("event")
        if phase is None:
            phase, cause, seg_start = "idle", "journal_start", ts
        if kind == "master_start" and last_ts is not None:
            # Inter-generation gap: nobody was alive to account it.
            close(last_ts)
            outage = {
                "start_ts": last_ts,
                "end_ts": ts,
                "seconds": max(0.0, ts - last_ts),
                "phase": "idle",
                "cause": "master_outage",
            }
            segments.append(outage)
            outages.append(outage)
            phase, cause, seg_start = "idle", "master_start", ts
        elif kind == "phase_transition":
            to = event.get("to")
            if to in PHASES:
                close(ts)
                phase, cause = to, str(event.get("cause", ""))
        last_ts = ts
    if last_ts is not None:
        close(last_ts)
    return segments, outages


def summarize(events: List[dict]) -> dict:
    """The machine-readable postmortem: wall-clock, per-phase
    attribution, goodput ratio, rescale costs, outages, terminal facts."""
    if not events:
        return {
            "wall_s": 0.0, "goodput_ratio": 0.0, "phases": {},
            "segments": [], "rescales": [], "outages": [],
            "generations": 0, "events": 0,
        }
    segments, outages = build_timeline(events)
    phases: Dict[str, float] = {}
    for seg in segments:
        phases[seg["phase"]] = phases.get(seg["phase"], 0.0) + seg["seconds"]
    wall = events[-1]["ts"] - events[0]["ts"]
    good = sum(phases.get(p, 0.0) for p in GOODPUT_PHASES)
    total = sum(phases.values())
    rescales = [
        {
            key: event.get(key)
            for key in (
                "seq", "cause", "old_size", "new_size", "total_s",
                "detection_s", "rendezvous_s", "redo_s", "redo_records",
                "redo_tasks", "rendezvous_id", "superseded",
            )
        }
        for event in events
        if event.get("event") == "rescale_cost"
    ]
    summaries = [e for e in events if e.get("event") == "goodput_summary"]
    compute = _compute_attribution(events)
    task_chains = _slowest_task_chains(events)
    # Independent cross-check channel: the seconds each phase_transition
    # CARRIED (the emitting ledger's own accounting), as opposed to the
    # timestamp-derived segment durations above.  Derived time per phase
    # can exceed carried (open tails at a SIGKILL, outage attribution)
    # but must never fall below it — the selftest gates on that.
    carried: Dict[str, float] = {}
    for event in events:
        if event.get("event") != "phase_transition":
            continue
        phase = event.get("from")
        seconds = event.get("seconds")
        if (
            phase in PHASES
            and isinstance(seconds, (int, float))
            and not isinstance(seconds, bool)
            and seconds >= 0
        ):
            carried[phase] = carried.get(phase, 0.0) + float(seconds)
    summary = {
        "wall_s": round(wall, 6),
        "accounted_s": round(total, 6),
        "goodput_s": round(good, 6),
        "goodput_ratio": round(good / total, 6) if total > 0 else 0.0,
        "phases": {p: round(s, 6) for p, s in sorted(phases.items())},
        "carried_phases": {
            p: round(s, 6) for p, s in sorted(carried.items())
        },
        "segments": segments,
        "rescales": rescales,
        "outages": outages,
        "outage_s": round(sum(o["seconds"] for o in outages), 6),
        "generations": sum(
            1 for e in events if e.get("event") == "master_start"
        ),
        "events": len(events),
        "start_ts": events[0]["ts"],
        "end_ts": events[-1]["ts"],
        **compute,
    }
    if task_chains:
        summary["task_chains"] = task_chains
    if summaries:
        final = summaries[-1]
        summary["ledger_summary"] = {
            key: final.get(key)
            for key in (
                "outcome", "goodput_ratio", "records_done",
                "records_redone", "rescales",
            )
        }
    freshness = _freshness_summary(events)
    if freshness:
        summary["freshness"] = freshness
    quality = _quality_summary(events)
    if quality:
        summary["quality"] = quality
    slo = _slo_summary(events, segments)
    if slo:
        summary["slo"] = slo
    tail = _tail_latency_summary(events)
    if tail:
        summary["tail_latency"] = tail
    return summary


#: Rows in the "tail latency attribution" exemplar table.
TOP_TAIL_EXEMPLARS = 5


def _tail_latency_summary(events: List[dict]) -> Optional[dict]:
    """Fold the serving sampler's ``request_trace`` events
    (serving/ledger.py ExemplarSampler: head/tail/outcome-sampled
    request records with per-phase latency splits) into a tail-latency
    attribution section.  Returns None when the journal predates
    request tracing, so old journals render no section at all.

    The slowest exemplars ARE the p99 evidence — the sampler journals
    everything above its SLO-tied threshold, so the top of this table
    is the top of the true latency distribution, decomposed by phase
    (queue/batch/execute/respond) to name what the tail is made of."""
    traces = [e for e in events if e.get("event") == "request_trace"]
    if not traces:
        return None
    by_reason: Dict[str, int] = {}
    outcomes: Dict[str, int] = {}
    for event in traces:
        reason = str(event.get("sampled_by") or "unknown")
        by_reason[reason] = by_reason.get(reason, 0) + 1
        outcome = str(event.get("outcome") or "unknown")
        outcomes[outcome] = outcomes.get(outcome, 0) + 1
    ranked = sorted(
        (e for e in traces if _num(e.get("latency_ms")) is not None),
        key=lambda e: -float(e["latency_ms"]),
    )
    exemplars = []
    phase_ms: Dict[str, float] = {}
    for event in ranked[:TOP_TAIL_EXEMPLARS]:
        exemplar = {
            key: event.get(key)
            for key in (
                "trace_id", "latency_ms", "dominant_phase", "outcome",
                "sampled_by", "replica_id", "generation", "bucket",
                "phases",
            )
            if event.get(key) is not None
        }
        exemplars.append(exemplar)
        phases = event.get("phases")
        if isinstance(phases, dict):
            for phase, value in phases.items():
                ms = _num(value)
                if ms is not None and ms >= 0:
                    phase_ms[phase] = phase_ms.get(phase, 0.0) + ms
    section: dict = {
        "sampled": len(traces),
        "by_reason": by_reason,
        "outcomes": outcomes,
        "exemplars": exemplars,
    }
    total = sum(phase_ms.values())
    if total > 0:
        section["phase_ms"] = {
            p: round(v, 3) for p, v in sorted(phase_ms.items())
        }
        section["phase_fractions"] = {
            p: round(v / total, 4) for p, v in sorted(phase_ms.items())
        }
        section["dominant_phase"] = max(phase_ms, key=phase_ms.get)
    return section


def _freshness_summary(events: List[dict]) -> Optional[dict]:
    """Fold the continuous-loop events (stream_watermark,
    delta_checkpoint, delta_compaction, freshness_slo) into one section.
    Returns None when the journal predates the continuous loop, so old
    journals render no section at all."""
    watermarks = [e for e in events if e.get("event") == "stream_watermark"]
    deltas = [e for e in events if e.get("event") == "delta_checkpoint"]
    compactions = [e for e in events if e.get("event") == "delta_compaction"]
    slo_events = [e for e in events if e.get("event") == "freshness_slo"]
    quarantines = [
        e for e in events if e.get("event") == "checkpoint_quarantined"
    ]
    if not (watermarks or deltas or compactions or slo_events):
        return None
    section: dict = {
        "watermark_updates": len(watermarks),
        "deltas_published": len(deltas),
        "delta_rows": sum(
            int(e.get("rows") or 0)
            for e in deltas
            if isinstance(e.get("rows"), (int, float))
        ),
        "compactions": len(compactions),
        "quarantines": len(quarantines),
        "breaches": sum(1 for e in slo_events if e.get("state") == "breach"),
    }
    if watermarks:
        last = watermarks[-1]
        section["last_watermark"] = {
            "offset": last.get("offset"),
            "event_time": last.get("event_time"),
        }
    if slo_events:
        last = slo_events[-1]
        section["slo_s"] = last.get("slo_s")
        section["final_state"] = last.get("state")
        section["transitions"] = [
            {
                key: e.get(key)
                for key in ("state", "lag_s", "stage", "generation", "step")
            }
            for e in slo_events
        ]
        breach_lags = [
            float(e["lag_s"])
            for e in slo_events
            if e.get("state") == "breach"
            and isinstance(e.get("lag_s"), (int, float))
        ]
        if breach_lags:
            section["max_breach_lag_s"] = round(max(breach_lags), 6)
    return section


def _num(value) -> Optional[float]:
    """Float when the journal field is a real number, else None (bool is
    an int subtype; a journal is arbitrary input)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    return None


#: Rows in the per-section quality timelines (AUC windows, gate ledger).
TOP_QUALITY_ROWS = 8


def _quality_summary(events: List[dict]) -> Optional[dict]:
    """Fold the model-quality plane's events (``quality_window`` online
    label-join rollups, ``quality_drift`` train-serve divergence edges,
    ``quality_gate`` canary verdicts) into one section.  Returns None
    when the journal predates the quality plane, so old journals render
    no section at all."""
    windows = [e for e in events if e.get("event") == "quality_window"]
    drifts = [e for e in events if e.get("event") == "quality_drift"]
    gates = [e for e in events if e.get("event") == "quality_gate"]
    if not (windows or drifts or gates):
        return None
    section: dict = {
        "window_updates": len(windows),
        "gate_decisions": len(gates),
        "drift_events": len(drifts),
    }
    if windows:
        # Latest rollup per origin: the "where quality stands now" row.
        latest: Dict[str, dict] = {}
        for event in windows:
            latest[str(event.get("origin") or "")] = event
        section["latest"] = [
            {
                key: latest[origin].get(key)
                for key in (
                    "origin", "joined", "window", "pending", "expired",
                    "orphans", "auc", "logloss", "calibration_error",
                    "prediction_mean", "label_mean",
                )
            }
            for origin in sorted(latest)
        ]
        timeline = [
            {
                "ts": _num(event.get("ts")),
                "origin": str(event.get("origin") or ""),
                "auc": _num(event.get("auc")),
                "logloss": _num(event.get("logloss")),
                "joined": event.get("joined"),
            }
            for event in windows
            if _num(event.get("auc")) is not None
        ]
        if timeline:
            section["auc_timeline"] = timeline[-TOP_QUALITY_ROWS:]
    if gates:
        section["gates"] = [
            {
                key: event.get(key)
                for key in (
                    "ts", "outcome", "step", "origin", "reason", "rows",
                    "quality", "baseline_logloss", "candidate_logloss",
                    "baseline_auc", "candidate_auc", "delta_dir",
                )
            }
            for event in gates
        ]
        section["holds"] = sum(
            1 for e in gates if e.get("outcome") == "held"
        )
        section["forced"] = sum(
            1 for e in gates if e.get("outcome") == "forced"
        )
    if drifts:
        section["drift_breaches"] = sum(
            1 for e in drifts if e.get("state") == "breach"
        )
        final_state: Dict[str, str] = {}
        for event in drifts:
            final_state[str(event.get("origin") or "")] = str(
                event.get("state")
            )
        section["drift_final_state"] = final_state
        divergences = [
            _num(e.get("divergence"))
            for e in drifts
            if _num(e.get("divergence")) is not None
        ]
        if divergences:
            section["max_divergence"] = round(max(divergences), 6)
    return section


def _slo_summary(
    events: List[dict], segments: List[dict]
) -> Optional[dict]:
    """Fold the SLO plane's journal events (obs/slo.py: rate-limited
    ``slo_status`` rows, edge-triggered ``slo_alert`` fire/clear pairs)
    into an error-budget section.  Returns None when the journal
    predates the SLO plane, so old journals render no section at all.

    Each fire/clear pair keyed by (slo, origin) becomes one breach on
    the timeline; an unmatched fire is an OPEN breach (the job ended —
    or the master was SIGKILLed — mid-alert).  Attribution joins two
    taxonomies over each breach window: the ``request_shed`` reason
    counts (which admission failure burned the budget) and the dominant
    goodput phase (what the job was doing while it burned)."""
    statuses = [e for e in events if e.get("event") == "slo_status"]
    alerts = [e for e in events if e.get("event") == "slo_alert"]
    if not (statuses or alerts):
        return None
    end_ts = events[-1]["ts"]

    # Per-(slo, origin) budget accounting from the status stream.
    budgets: Dict[Tuple[str, str], dict] = {}
    for event in statuses:
        key = (str(event.get("slo")), str(event.get("origin") or ""))
        entry = budgets.setdefault(
            key,
            {
                "slo": key[0], "origin": key[1], "status_updates": 0,
                "min_budget_remaining_ratio": None,
                "final_budget_remaining_ratio": None,
                "objective": event.get("objective"),
                "kind": event.get("kind"),
            },
        )
        entry["status_updates"] += 1
        budget = _num(event.get("budget_remaining_ratio"))
        if budget is not None:
            low = entry["min_budget_remaining_ratio"]
            entry["min_budget_remaining_ratio"] = (
                budget if low is None else min(low, budget)
            )
            entry["final_budget_remaining_ratio"] = budget

    # Breach timeline: pair fire/clear edges per (slo, origin).
    open_fires: Dict[Tuple[str, str], dict] = {}
    breaches: List[dict] = []

    def close_breach(fired: dict, cleared_ts: Optional[float]):
        breaches.append(
            {
                "slo": str(fired.get("slo")),
                "origin": str(fired.get("origin") or ""),
                "grade": fired.get("grade"),
                "fired_ts": fired["ts"],
                "cleared_ts": cleared_ts,
                "seconds": round(
                    max(0.0, (cleared_ts if cleared_ts is not None
                              else end_ts) - fired["ts"]), 6
                ),
                "offending": fired.get("offending"),
                "burn_rates": fired.get("burn_rates"),
                "budget_remaining_ratio": fired.get(
                    "budget_remaining_ratio"
                ),
            }
        )

    for event in alerts:
        key = (str(event.get("slo")), str(event.get("origin") or ""))
        state = event.get("state")
        if state == "fire":
            if key in open_fires:  # double fire: journal merge/replay
                close_breach(open_fires.pop(key), event["ts"])
            open_fires[key] = event
        elif state == "clear" and key in open_fires:
            close_breach(open_fires.pop(key), event["ts"])
        # A clear with no prior fire: the journal's head was truncated
        # past the fire edge — nothing to attribute, skip.
    for key in sorted(open_fires):
        close_breach(open_fires[key], None)
    breaches.sort(key=lambda b: b["fired_ts"])

    # Attribution joins over each breach window.
    sheds = [e for e in events if e.get("event") == "request_shed"]
    for breach in breaches:
        lo = breach["fired_ts"]
        hi = breach["cleared_ts"] if breach["cleared_ts"] is not None \
            else end_ts
        reasons: Dict[str, int] = {}
        for shed in sheds:
            if lo <= shed["ts"] <= hi:
                reason = str(shed.get("reason") or "unknown")
                reasons[reason] = reasons.get(reason, 0) + 1
        if reasons:
            breach["shed_reasons"] = reasons
        overlap: Dict[str, float] = {}
        for seg in segments:
            shared = min(hi, seg["end_ts"]) - max(lo, seg["start_ts"])
            if shared > 0:
                overlap[seg["phase"]] = (
                    overlap.get(seg["phase"], 0.0) + shared
                )
        if overlap:
            breach["dominant_goodput_phase"] = max(
                overlap, key=overlap.get
            )

    section: dict = {
        "status_updates": len(statuses),
        "alert_edges": len(alerts),
        "breaches": breaches,
        "open_breaches": sum(
            1 for b in breaches if b["cleared_ts"] is None
        ),
        "breach_s": round(sum(b["seconds"] for b in breaches), 6),
    }
    if budgets:
        section["slos"] = [budgets[key] for key in sorted(budgets)]
        floors = [
            entry["min_budget_remaining_ratio"]
            for entry in budgets.values()
            if entry["min_budget_remaining_ratio"] is not None
        ]
        if floors:
            section["worst_budget_remaining_ratio"] = min(floors)
    return section


#: Rows in the "slowest task chains" table.
TOP_TASK_CHAINS = 10


def _slowest_task_chains(
    events: List[dict], top: int = TOP_TASK_CHAINS
) -> List[dict]:
    """Top-N end-to-end task latencies from the tracing plane's
    ``task.lifetime`` root spans (obs/tracing.py: the master journals
    one per closed dispatch, dispatch -> report/requeue), with the
    worker-side execute share joined from the same trace's
    ``worker.task`` span when the worker journal is merged in."""
    roots: List[dict] = []
    worker_spans: Dict[str, float] = {}
    for event in events:
        if event.get("event") != "span":
            continue
        duration = event.get("duration_s")
        if not isinstance(duration, (int, float)) or isinstance(
            duration, bool
        ) or duration < 0:
            continue
        trace_id = event.get("trace_id")
        if event.get("name") == "task.lifetime":
            roots.append(event)
        elif event.get("name") == "worker.task" and trace_id:
            worker_spans[trace_id] = max(
                worker_spans.get(trace_id, 0.0), float(duration)
            )
    roots.sort(key=lambda e: -float(e["duration_s"]))
    chains = []
    for event in roots[:top]:
        chain = {
            key: event.get(key)
            for key in (
                "trace_id", "task_id", "worker_id", "type", "error",
            )
            if event.get(key) is not None
        }
        chain["duration_s"] = round(float(event["duration_s"]), 6)
        trace_id = event.get("trace_id")
        if trace_id in worker_spans:
            chain["worker_s"] = round(worker_spans[trace_id], 6)
            # The chain's non-worker share: RPC hops + queue/dispatch
            # overhead (clock skew can push it below zero pre-alignment;
            # floor at 0 — obs.trace is the precision tool).
            chain["overhead_s"] = round(
                max(0.0, chain["duration_s"] - chain["worker_s"]), 6
            )
        chains.append(chain)
    return chains


def _compute_attribution(events: List[dict]) -> dict:
    """The compute-plane half of the postmortem (docs/observability.md
    "Step anatomy"): fold ``step_anatomy`` events (cumulative per-worker
    phase totals — the LATEST per worker wins), ``straggler_detected``
    anatomy evidence, and ``profile_window`` trace pointers."""
    latest: Dict[int, dict] = {}
    straggler_attr: List[dict] = []
    profile_windows: List[dict] = []
    for event in events:
        kind = event.get("event")
        if kind == "step_anatomy" and event.get("worker_id") is not None:
            latest[event["worker_id"]] = event
        elif kind == "straggler_detected" and event.get("dominant_phase"):
            straggler_attr.append(
                {
                    key: event.get(key)
                    for key in (
                        "worker_id", "metric", "dominant_phase",
                        "dominant_phase_fraction", "fleet_phase_fraction",
                        "phase_ratio",
                    )
                    if event.get(key) is not None
                }
            )
        elif kind == "profile_window":
            profile_windows.append(
                {
                    key: event.get(key)
                    for key in (
                        "ts", "worker_id", "action", "step_start",
                        "step_end", "trace_dir",
                    )
                    if event.get(key) is not None
                }
            )
    out: dict = {}
    if profile_windows:
        out["profile_windows"] = profile_windows
    if straggler_attr:
        out["straggler_attribution"] = straggler_attr
    if not latest:
        return out
    fleet_seconds: Dict[str, float] = {}
    workers: Dict[int, dict] = {}
    for wid, event in latest.items():
        totals = event.get("totals")
        if not isinstance(totals, dict):
            continue  # forensics over arbitrary journals: skip, don't die
        seconds = {
            phase: float(value)
            for phase, value in totals.items()
            if isinstance(value, (int, float))
            and not isinstance(value, bool)
        }
        accounted = sum(seconds.values())
        if accounted <= 0:
            continue  # all-zero totals: nothing to attribute
        fractions = {
            phase: round(value / accounted, 4)
            for phase, value in seconds.items()
        }
        for phase, value in seconds.items():
            fleet_seconds[phase] = fleet_seconds.get(phase, 0.0) + value
        workers[wid] = {
            "seconds": {p: round(s, 6) for p, s in seconds.items()},
            "fractions": fractions,
            "dominant_phase": max(fractions, key=fractions.get),
            "bound": event.get("bound"),
            "retraces": event.get("retraces"),
            "mfu": event.get("mfu"),
            # Async-staging credit: host seconds hidden behind device
            # execution (outside the exclusive phase totals on purpose).
            "overlap_s": event.get("overlap_s"),
        }
    if not workers:
        return out
    accounted = sum(fleet_seconds.values())
    out["compute"] = {
        "seconds": {p: round(s, 6) for p, s in sorted(fleet_seconds.items())},
        "fractions": {
            p: round(s / accounted, 4)
            for p, s in sorted(fleet_seconds.items())
        },
        "bottleneck": max(fleet_seconds, key=fleet_seconds.get),
        "workers": workers,
    }
    return out


def _fmt_duration(seconds: float) -> str:
    if seconds >= 120:
        return f"{seconds / 60:.1f}m"
    return f"{seconds:.1f}s"


def render_report(summary: dict, max_segments: int = 80) -> str:
    """The human half: timeline + attribution + rescale breakdown."""
    lines: List[str] = []
    wall = summary["wall_s"]
    ratio = summary["goodput_ratio"]
    lines.append(
        f"job ran {_fmt_duration(wall)} across "
        f"{summary['generations']} master generation(s), "
        f"{summary['events']} journal events; goodput "
        f"{ratio * 100:.1f}%"
    )
    if summary["outages"]:
        lines.append(
            f"master outage: {_fmt_duration(summary['outage_s'])} across "
            f"{len(summary['outages'])} gap(s) (attributed to "
            "idle/master_outage)"
        )
    lines.append("")
    lines.append("attribution (share of accounted wall-clock):")
    total = summary["accounted_s"] or 1.0
    for phase, seconds in sorted(
        summary["phases"].items(), key=lambda kv: -kv[1]
    ):
        marker = "goodput" if phase in GOODPUT_PHASES else "lost"
        lines.append(
            f"  {phase:<20} {_fmt_duration(seconds):>8}  "
            f"{100 * seconds / total:5.1f}%  [{marker}]"
        )
    compute = summary.get("compute")
    if compute:
        lines.append("")
        lines.append(
            "compute-phase attribution (step anatomy, share of fleet "
            "step time):"
        )
        for phase, seconds in sorted(
            compute["seconds"].items(), key=lambda kv: -kv[1]
        ):
            marker = (
                " <- bottleneck" if phase == compute["bottleneck"] else ""
            )
            lines.append(
                f"  {phase:<20} {_fmt_duration(seconds):>8}  "
                f"{100 * compute['fractions'][phase]:5.1f}%{marker}"
            )
        for wid in sorted(compute["workers"]):
            worker = compute["workers"][wid]
            dominant = worker["dominant_phase"]
            extra = ""
            if worker.get("bound"):
                extra += f", bound: {worker['bound']}"
            if worker.get("retraces"):
                extra += f", retraces: {worker['retraces']}"
            if worker.get("mfu") is not None:
                extra += f", mfu: {worker['mfu']}"
            if worker.get("overlap_s"):
                extra += f", overlap: {_fmt_duration(float(worker['overlap_s']))}"
            lines.append(
                f"  worker {wid}: dominant {dominant} "
                f"({100 * worker['fractions'][dominant]:.0f}%{extra})"
            )
    for finding in summary.get("straggler_attribution", ()):
        ratio = finding.get("phase_ratio")
        versus = (
            f" ({ratio}x the fleet median "
            f"{finding.get('fleet_phase_fraction')})"
            if ratio is not None
            else ""
        )
        lines.append(
            f"  straggler worker {finding.get('worker_id')}: "
            f"{finding.get('metric')} over threshold; dominant phase "
            f"{finding.get('dominant_phase')} at "
            f"{finding.get('dominant_phase_fraction')}{versus}"
        )
    profile_windows = summary.get("profile_windows")
    if profile_windows:
        lines.append("")
        lines.append("profiler traces (jax.profiler windows):")
        t0 = summary.get("start_ts", 0.0)
        for window in profile_windows:
            lines.append(
                f"  +{(window.get('ts', t0) or t0) - t0:9.2f}s  "
                f"worker {window.get('worker_id')} {window.get('action')} "
                f"steps [{window.get('step_start')}, "
                f"{window.get('step_end')}) -> {window.get('trace_dir')}"
            )
    task_chains = summary.get("task_chains")
    if task_chains:
        lines.append("")
        lines.append(
            "slowest task chains (dispatch -> report, from task.lifetime "
            "spans; `python -m elasticdl_tpu_torch.obs.trace` for the aligned "
            "waterfall):"
        )
        for chain in task_chains:
            extra = ""
            if chain.get("worker_s") is not None:
                extra = (
                    f"  worker {_fmt_duration(chain['worker_s'])} + "
                    f"overhead {_fmt_duration(chain['overhead_s'])}"
                )
            if chain.get("error"):
                extra += f"  [{chain['error']}]"
            lines.append(
                f"  {_fmt_duration(chain['duration_s']):>8}  "
                f"task {chain.get('task_id')} "
                f"(worker {chain.get('worker_id')}, "
                f"{chain.get('type', '?')}, "
                f"trace {chain.get('trace_id')}){extra}"
            )
    if summary["rescales"]:
        lines.append("")
        lines.append("rescales:")
        for r in summary["rescales"]:
            sizes = f"{r.get('old_size')}->{r.get('new_size')}"
            extra = " (superseded)" if r.get("superseded") else ""
            lines.append(
                f"  #{r.get('seq')} {r.get('cause')} {sizes}: "
                f"cost {_fmt_duration(r.get('total_s') or 0.0)} = "
                f"{_fmt_duration(r.get('detection_s') or 0.0)} detection + "
                f"{_fmt_duration(r.get('rendezvous_s') or 0.0)} rendezvous + "
                f"{_fmt_duration(r.get('redo_s') or 0.0)} redo of "
                f"{r.get('redo_records') or 0} requeued records "
                f"({r.get('redo_tasks') or 0} task(s)){extra}"
            )
    ledger = summary.get("ledger_summary")
    if ledger:
        lines.append("")
        lines.append(
            f"ledger summary ({ledger.get('outcome')}): live ratio "
            f"{ledger.get('goodput_ratio')}, records done "
            f"{ledger.get('records_done')}, redone "
            f"{ledger.get('records_redone')}, rescales "
            f"{ledger.get('rescales')}"
        )
    freshness = summary.get("freshness")
    if freshness:
        lines.append("")
        lines.append("continuous train->serve loop:")
        last_wm = freshness.get("last_watermark")
        if last_wm:
            lines.append(
                f"  watermark: offset {last_wm.get('offset')} "
                f"(event time {last_wm.get('event_time')}s, "
                f"{freshness['watermark_updates']} advance(s))"
            )
        lines.append(
            f"  deltas: {freshness['deltas_published']} published "
            f"({freshness['delta_rows']} rows), "
            f"{freshness['compactions']} compaction(s), "
            f"{freshness['quarantines']} quarantined artifact(s)"
        )
        if freshness.get("slo_s") is not None:
            state = freshness.get("final_state")
            lines.append(
                f"  freshness SLO {freshness['slo_s']}s: "
                f"{freshness['breaches']} breach(es), "
                f"final state {state}"
                + (
                    f", worst lag "
                    f"{_fmt_duration(freshness['max_breach_lag_s'])}"
                    if freshness.get("max_breach_lag_s") is not None
                    else ""
                )
            )
            for t in freshness.get("transitions", ()):
                lines.append(
                    f"    {t.get('state'):>6}  lag {t.get('lag_s')}s"
                    + (
                        f"  (stage: {t.get('stage')}, gen "
                        f"{t.get('generation')}, step {t.get('step')})"
                        if t.get("state") == "breach"
                        else ""
                    )
                )
        elif freshness["breaches"] == 0:
            lines.append("  freshness SLO: not configured")
    quality = summary.get("quality")
    if quality:
        lines.append("")
        lines.append("model quality (online label-join evaluation):")
        for row in quality.get("latest", ()):
            where = f"@{row['origin']}" if row.get("origin") else ""
            bits = [
                f"  window{where}: joined {row.get('joined')}"
                f" ({row.get('window')} in window,"
                f" {row.get('pending')} pending,"
                f" {row.get('expired')} expired,"
                f" {row.get('orphans')} orphaned)"
            ]
            auc = row.get("auc")
            if isinstance(auc, (int, float)):
                bits.append(f"auc {float(auc):.3f}")
            logloss = row.get("logloss")
            if isinstance(logloss, (int, float)):
                bits.append(f"logloss {float(logloss):.3f}")
            cal = row.get("calibration_error")
            if isinstance(cal, (int, float)):
                bits.append(f"cal err {float(cal):.3f}")
            mean = row.get("prediction_mean")
            label_mean = row.get("label_mean")
            if isinstance(mean, (int, float)) and isinstance(
                label_mean, (int, float)
            ):
                bits.append(
                    f"pred mean {float(mean):.3f} vs label "
                    f"{float(label_mean):.3f}"
                )
            lines.append(";  ".join(bits))
        timeline = quality.get("auc_timeline")
        if timeline:
            t0 = summary.get("start_ts", 0.0)
            lines.append("  windowed AUC timeline:")
            for point in timeline:
                ts = point.get("ts")
                offset = (
                    f"+{ts - t0:9.2f}s" if isinstance(ts, (int, float))
                    else f"{'?':>10}"
                )
                lines.append(
                    f"    {offset}  auc {point['auc']:.3f}"
                    + (
                        f"  logloss {point['logloss']:.3f}"
                        if point.get("logloss") is not None
                        else ""
                    )
                    + f"  (joined {point.get('joined')}"
                    + (
                        f" @{point['origin']})" if point.get("origin")
                        else ")"
                    )
                )
        if quality.get("drift_events"):
            states = ", ".join(
                f"{origin or '(unlabeled)'}: {state}"
                for origin, state in sorted(
                    quality.get("drift_final_state", {}).items()
                )
            )
            lines.append(
                f"  train-serve drift: "
                f"{quality.get('drift_breaches', 0)} breach(es)"
                + (
                    f", max divergence {quality['max_divergence']:.3f}"
                    if quality.get("max_divergence") is not None
                    else ""
                )
                + (f"  [{states}]" if states else "")
            )
        gates = quality.get("gates")
        if gates:
            lines.append(
                f"  canary gate: {quality['gate_decisions']} decision(s), "
                f"{quality.get('holds', 0)} held, "
                f"{quality.get('forced', 0)} forced"
            )
            t0 = summary.get("start_ts", 0.0)
            for gate in gates[-TOP_QUALITY_ROWS:]:
                ts = gate.get("ts")
                offset = (
                    f"+{ts - t0:9.2f}s" if isinstance(ts, (int, float))
                    else f"{'?':>10}"
                )
                extra = ""
                if gate.get("reason"):
                    extra += f"  ({gate['reason']})"
                base = gate.get("baseline_logloss")
                cand = gate.get("candidate_logloss")
                if isinstance(base, (int, float)) and isinstance(
                    cand, (int, float)
                ):
                    extra += (
                        f"  logloss {float(base):.3f} -> {float(cand):.3f}"
                    )
                base_auc = gate.get("baseline_auc")
                cand_auc = gate.get("candidate_auc")
                if isinstance(base_auc, (int, float)) and isinstance(
                    cand_auc, (int, float)
                ):
                    extra += (
                        f"  auc {float(base_auc):.3f} -> "
                        f"{float(cand_auc):.3f}"
                    )
                where = f"@{gate['origin']}" if gate.get("origin") else ""
                lines.append(
                    f"    {offset}  {str(gate.get('outcome')).upper():<6} "
                    f"step {gate.get('step')}{where}"
                    f" [{gate.get('quality') or 'known'}"
                    f", {gate.get('rows') or 0} rows]{extra}"
                )
    slo = summary.get("slo")
    if slo:
        lines.append("")
        lines.append(
            f"error budget (SLO plane): {slo['status_updates']} status "
            f"update(s), {len(slo['breaches'])} breach(es) totalling "
            f"{_fmt_duration(slo['breach_s'])}"
            + (
                f", {slo['open_breaches']} still open"
                if slo["open_breaches"]
                else ""
            )
        )
        for entry in slo.get("slos", ()):
            final = entry.get("final_budget_remaining_ratio")
            low = entry.get("min_budget_remaining_ratio")
            where = (
                f"@{entry['origin']}" if entry.get("origin") else ""
            )
            lines.append(
                f"  {entry['slo']}{where}: budget "
                + (
                    f"{100 * final:.1f}% remaining"
                    if final is not None
                    else "n/a"
                )
                + (
                    f" (low {100 * low:.1f}%)"
                    if low is not None and low != final
                    else ""
                )
                + f", {entry['status_updates']} status update(s)"
            )
        t0 = summary.get("start_ts", 0.0)
        for breach in slo["breaches"]:
            where = (
                f"@{breach['origin']}" if breach.get("origin") else ""
            )
            extra = ""
            if breach.get("offending"):
                extra += f"; offending {breach['offending']}"
            if breach.get("shed_reasons"):
                shed = ", ".join(
                    f"{reason} x{count}"
                    for reason, count in sorted(
                        breach["shed_reasons"].items(),
                        key=lambda kv: -kv[1],
                    )
                )
                extra += f"; shed: {shed}"
            if breach.get("dominant_goodput_phase"):
                extra += f"; during {breach['dominant_goodput_phase']}"
            span = (
                f"for {_fmt_duration(breach['seconds'])}"
                if breach["cleared_ts"] is not None
                else "OPEN at journal end"
            )
            lines.append(
                f"    +{breach['fired_ts'] - t0:9.2f}s  "
                f"{breach.get('grade') or 'alert':<5} "
                f"{breach['slo']}{where} {span}{extra}"
            )
    tail = summary.get("tail_latency")
    if tail:
        lines.append("")
        reasons = ", ".join(
            f"{reason} x{count}"
            for reason, count in sorted(
                tail["by_reason"].items(), key=lambda kv: -kv[1]
            )
        )
        lines.append(
            f"tail latency attribution ({tail['sampled']} sampled "
            f"request trace(s); {reasons}):"
        )
        if tail.get("dominant_phase"):
            split = ", ".join(
                f"{phase} {100 * fraction:.0f}%"
                for phase, fraction in sorted(
                    tail["phase_fractions"].items(), key=lambda kv: -kv[1]
                )
            )
            lines.append(
                f"  p99 exemplars decompose as: {split}  "
                f"<- dominant {tail['dominant_phase']}"
            )
        for exemplar in tail["exemplars"]:
            extra = ""
            if exemplar.get("dominant_phase"):
                extra += f"  dominant {exemplar['dominant_phase']}"
            if exemplar.get("replica_id") is not None:
                extra += f"  (replica {exemplar['replica_id']})"
            lines.append(
                f"    {exemplar['latency_ms']:>9.1f}ms  "
                f"trace {exemplar.get('trace_id')}  "
                f"[{exemplar.get('outcome')}/{exemplar.get('sampled_by')}]"
                f"{extra}"
            )
    lines.append("")
    lines.append("timeline:")
    segments = summary["segments"]
    shown = segments[-max_segments:]
    if len(segments) > len(shown):
        lines.append(f"  ... {len(segments) - len(shown)} earlier segment(s)")
    t0 = summary.get("start_ts", 0.0)
    for seg in shown:
        lines.append(
            f"  +{seg['start_ts'] - t0:9.2f}s  "
            f"{_fmt_duration(seg['seconds']):>8}  {seg['phase']:<20} "
            f"({seg['cause']})"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# /metrics join
# ---------------------------------------------------------------------------


def parse_metric_value(text: str, name: str) -> Optional[float]:
    """First unlabeled sample of `name` in a Prometheus text exposition."""
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 2 and parts[0] == name:
            try:
                return float(parts[1])
            except ValueError:
                return None
    return None


def load_scrape(source: str) -> str:
    """`source` is a file path, or a host:port/URL to scrape live."""
    import os

    if os.path.exists(source):
        with open(source, "r", encoding="utf-8", errors="replace") as f:
            return f.read()
    if source.startswith(":"):
        source = "localhost" + source  # bare-port form: ':9090'
    url = source if "://" in source else f"http://{source}"
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    with urllib.request.urlopen(url, timeout=5) as response:
        return response.read().decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Selftest over the golden fixture
# ---------------------------------------------------------------------------


def selftest(path: str) -> int:
    """Replay the golden journal and check the report's invariants: the
    timeline covers wall-clock exactly, the ratio is sane, and every
    rescale's components sum to (about) its total."""
    events = load_events(path)
    if not events:
        print(f"report selftest FAILED: no events in {path}", file=sys.stderr)
        return 1
    summary = summarize(events)
    problems = []
    wall = summary["wall_s"]
    covered = sum(summary["phases"].values())
    if abs(covered - wall) > max(0.02 * wall, 1e-6):
        problems.append(
            f"phase durations sum to {covered:.3f}s but wall-clock is "
            f"{wall:.3f}s"
        )
    # The independent check: timestamp-derived time per phase must cover
    # the seconds the transitions themselves carried.  (The sum check
    # above holds by construction of the contiguous timeline; THIS one
    # catches misattribution — a dropped/renamed phase would leave its
    # carried seconds uncovered.)
    tolerance = max(0.02 * wall, 0.05)
    for phase, carried_s in summary["carried_phases"].items():
        derived_s = summary["phases"].get(phase, 0.0)
        if derived_s < carried_s - tolerance:
            problems.append(
                f"phase {phase!r}: timeline derives {derived_s:.3f}s but "
                f"transitions carried {carried_s:.3f}s — misattributed"
            )
    if sum(summary["carried_phases"].values()) > wall + tolerance:
        problems.append(
            "carried phase seconds exceed wall-clock "
            f"({sum(summary['carried_phases'].values()):.3f}s > {wall:.3f}s)"
        )
    if not (0.0 <= summary["goodput_ratio"] <= 1.0):
        problems.append(f"goodput_ratio {summary['goodput_ratio']} not in [0,1]")
    compute = summary.get("compute")
    if compute:
        fraction_sum = sum(compute["fractions"].values())
        if abs(fraction_sum - 1.0) > 0.02:
            problems.append(
                "compute-phase fractions sum to "
                f"{fraction_sum:.4f}, not ~1.0"
            )
        for wid, worker in compute["workers"].items():
            worker_sum = sum(worker["fractions"].values())
            if abs(worker_sum - 1.0) > 0.02:
                problems.append(
                    f"worker {wid} phase fractions sum to "
                    f"{worker_sum:.4f}, not ~1.0"
                )
    for chain in summary.get("task_chains", ()):
        if chain["duration_s"] < 0:
            problems.append(
                f"task chain {chain.get('trace_id')} has negative "
                f"duration {chain['duration_s']}"
            )
        if chain.get("worker_s") is not None and (
            chain["worker_s"] < 0 or chain["overhead_s"] < 0
        ):
            problems.append(
                f"task chain {chain.get('trace_id')} has negative "
                "worker/overhead split"
            )
    slo = summary.get("slo")
    if slo:
        for entry in slo.get("slos", ()):
            for key in (
                "min_budget_remaining_ratio",
                "final_budget_remaining_ratio",
            ):
                value = entry.get(key)
                if value is not None and not (0.0 <= value <= 1.0):
                    problems.append(
                        f"SLO {entry['slo']}: {key} {value} not in [0,1]"
                    )
        for breach in slo["breaches"]:
            if breach["seconds"] < 0:
                problems.append(
                    f"SLO breach {breach['slo']} has negative duration "
                    f"{breach['seconds']}"
                )
            if (
                breach["cleared_ts"] is not None
                and breach["cleared_ts"] < breach["fired_ts"]
            ):
                problems.append(
                    f"SLO breach {breach['slo']} clears at "
                    f"{breach['cleared_ts']} before firing at "
                    f"{breach['fired_ts']}"
                )
    quality = summary.get("quality")
    if quality:
        for row in quality.get("latest", ()):
            auc = row.get("auc")
            if auc is not None and not (0.0 <= auc <= 1.0):
                problems.append(
                    f"quality window {row.get('origin')}: auc {auc} "
                    "not in [0,1]"
                )
            logloss = row.get("logloss")
            if logloss is not None and logloss < 0:
                problems.append(
                    f"quality window {row.get('origin')}: negative "
                    f"logloss {logloss}"
                )
            cal = row.get("calibration_error")
            if cal is not None and not (0.0 <= cal <= 1.0):
                problems.append(
                    f"quality window {row.get('origin')}: calibration "
                    f"error {cal} not in [0,1]"
                )
        for gate in quality.get("gates", ()):
            if gate.get("outcome") not in ("passed", "held", "forced"):
                problems.append(
                    f"quality gate outcome {gate.get('outcome')!r} "
                    "unknown"
                )
            if gate.get("outcome") == "held" and not gate.get("reason"):
                problems.append(
                    f"held quality gate at step {gate.get('step')} "
                    "carries no reason"
                )
        if quality.get("max_divergence") is not None and not (
            0.0 <= quality["max_divergence"] <= 1.0
        ):
            problems.append(
                f"quality drift divergence {quality['max_divergence']} "
                "not in [0,1] (total variation)"
            )
    tail = summary.get("tail_latency")
    if tail:
        fractions = tail.get("phase_fractions")
        if fractions:
            fraction_sum = sum(fractions.values())
            if abs(fraction_sum - 1.0) > 0.02:
                problems.append(
                    "tail-latency phase fractions sum to "
                    f"{fraction_sum:.4f}, not ~1.0"
                )
        latencies = [e["latency_ms"] for e in tail["exemplars"]]
        if latencies != sorted(latencies, reverse=True):
            problems.append(
                f"tail exemplars not sorted slowest-first: {latencies}"
            )
        if any(ms < 0 for ms in latencies):
            problems.append(f"negative exemplar latency: {latencies}")
        if sum(tail["by_reason"].values()) != tail["sampled"]:
            problems.append("tail-latency reason counts != sampled total")
    for r in summary["rescales"]:
        parts = sum(
            r.get(k) or 0.0 for k in ("detection_s", "rendezvous_s", "redo_s")
        )
        total = r.get("total_s") or 0.0
        if abs(parts - total) > max(0.05 * total, 0.05):
            problems.append(
                f"rescale #{r.get('seq')}: components sum to {parts:.3f}s "
                f"!= total {total:.3f}s"
            )
    render_report(summary)  # must not raise
    if problems:
        print("report selftest FAILED:", file=sys.stderr)
        for problem in problems:
            print(f"  {problem}", file=sys.stderr)
        return 1
    print(
        f"report selftest OK ({path}: {summary['events']} events, "
        f"wall {summary['wall_s']:.1f}s, goodput "
        f"{summary['goodput_ratio'] * 100:.1f}%, "
        f"{len(summary['rescales'])} rescale(s))"
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.obs.report",
        description="Replay a control-plane event journal into a goodput "
        "timeline + downtime attribution report.",
    )
    parser.add_argument("journal", nargs="?", help="events.jsonl path")
    parser.add_argument(
        "--json", default="",
        help="also write the machine-readable summary here ('-' = stdout)",
    )
    parser.add_argument(
        "--scrape", default="",
        help="a /metrics exposition (file path or host:port) to join: "
        "prints the live elasticdl_goodput_ratio next to the replayed one",
    )
    parser.add_argument(
        "--max-segments", type=int, default=80,
        help="timeline lines to print (newest win)",
    )
    parser.add_argument(
        "--selftest", action="store_true",
        help="validate the report invariants over the given journal "
        "(the golden-fixture gate)",
    )
    args = parser.parse_args(argv)
    if not args.journal:
        parser.print_usage(sys.stderr)
        return 2
    if args.selftest:
        return selftest(args.journal)
    try:
        events = load_events(args.journal)
    except OSError as exc:
        print(f"{args.journal}: {exc}", file=sys.stderr)
        return 2
    summary = summarize(events)
    if args.scrape:
        try:
            ratio = parse_metric_value(
                load_scrape(args.scrape), "elasticdl_goodput_ratio"
            )
        except OSError as exc:
            print(f"--scrape {args.scrape}: {exc}", file=sys.stderr)
            ratio = None
        summary["metrics_goodput_ratio"] = ratio
        if ratio is not None:
            summary["goodput_ratio_delta"] = round(
                ratio - summary["goodput_ratio"], 6
            )
    print(render_report(summary, max_segments=args.max_segments))
    if "metrics_goodput_ratio" in summary:
        print(
            f"\n/metrics elasticdl_goodput_ratio: "
            f"{summary['metrics_goodput_ratio']} "
            f"(replayed: {summary['goodput_ratio']})"
        )
    if args.json:
        payload = json.dumps(summary, indent=2, default=str)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as f:
                f.write(payload + "\n")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # `report ... | head` is a normal postmortem idiom.
        sys.exit(0)
