"""``python -m elasticdl_tpu_torch.obs.top`` — live per-worker status table.

The port's copy of ``elasticdl_tpu/obs/top.py``, stdlib only: it imports nothing of the
JAX package.

Renders the worker telemetry plane from a running master's exporter
(``--metrics_port``): fleet aggregates from ``/metrics`` (Prometheus
text) and the per-worker detail from ``/journal`` (the bounded event
tail, where ``worker_telemetry`` / ``straggler_*`` events carry the
per-worker fields that — per the cardinality rule — never become metric
labels).

    python -m elasticdl_tpu_torch.obs.top --addr localhost:9090
    python -m elasticdl_tpu_torch.obs.top --addr localhost:9090 --once

``--serving`` switches to the serving-plane table: point ``--addr`` at
any serving replica's metrics port and the per-replica rows fold from
the fleet's shared journal (`serving_telemetry` events land in one
events.jsonl per serve dir, so one replica's /journal shows them all),
while the header carries the scraped replica's own availability
gauges.  Against a training-only master the serving table degrades to
an empty-table note, never a crash.

Stdlib only, read-only, and safe against a mid-scrape master restart
(connection errors render as a status line, not a crash).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

#: /metrics families summarized in the header line.
_HEADER_GAUGES = (
    ("elasticdl_world_size", "world"),
    ("elasticdl_tasks_todo", "todo"),
    ("elasticdl_tasks_doing", "doing"),
    ("elasticdl_job_examples_per_second", "job ex/s"),
    ("elasticdl_stragglers", "stragglers"),
    ("elasticdl_telemetry_staleness_seconds", "max stale(s)"),
)

_COLUMNS = (
    "WORKER", "AGE(s)", "P50(ms)", "P95(ms)", "EX/S",
    "TASK", "PROGRESS", "RDZV", "RETRY",
    "DW%", "ST%", "CO%", "EX%", "BK%", "OV%", "BOUND", "STATE",
)

#: Step-anatomy phase -> its percent column, in render order
#: (obs/stepstats.PHASES; data_wait / stage / compile / execute /
#: bookkeep — the per-worker phase-fraction columns).  OV% rides beside
#: them: the async staging engine's overlap credit as a fraction of
#: accounted-plus-overlapped host time (100% * overlap_s /
#: (sum(totals) + overlap_s)) — how much host work the pipeline hid
#: behind device execution.
_PHASE_COLUMNS = ("data_wait", "stage", "compile", "execute", "bookkeep")

#: Serving-plane header gauges (one replica's exporter; the table rows
#: are fleet-wide via the shared journal).
_SERVING_HEADER_GAUGES = (
    ("elasticdl_serving_availability_ratio", "avail"),
    ("elasticdl_serving_qps", "qps"),
    ("elasticdl_serving_latency_p50_ms", "p50ms"),
    ("elasticdl_serving_latency_p99_ms", "p99ms"),
)

_SERVING_COLUMNS = (
    "REPLICA", "AGE(s)", "GEN", "STEP", "FRESH(s)", "QPS", "P50(ms)",
    "P99(ms)", "QUEUE", "INFLT", "AVAIL%", "SERVED", "SHED", "ERR",
)

#: Per-phase p99 split columns (request-level tracing): telemetry field
#: -> column header.  Rendered only when the journal carries the fields
#: (replicas newer than the request-tracing plane) — against older
#: journals the frame is byte-identical to the pre-tracing layout.
_SERVING_PHASE_COLUMNS = (
    ("queue_p99_ms", "QU(ms)"),
    ("batch_p99_ms", "BA(ms)"),
    ("execute_p99_ms", "EX(ms)"),
    ("respond_p99_ms", "RE(ms)"),
)

#: Model-quality columns (label-join evaluation plane): row field ->
#: column header.  Fed from `quality_window` / `quality_drift` journal
#: events folded per replica origin — rendered only when the journal
#: carries them, so pre-quality journals get the pre-quality frame
#: byte-for-byte.
_SERVING_QUALITY_COLUMNS = (
    ("quality_auc", "AUC"),
    ("quality_cal", "CAL"),
    ("quality_drift", "DRIFT"),
)


def fetch_text(url: str, timeout_s: float = 5.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as response:
        return response.read().decode("utf-8", errors="replace")


def parse_metrics(text: str) -> Dict[str, float]:
    """Minimal Prometheus text parser: unlabeled samples only (all the
    fleet aggregates this tool reads are unlabeled gauges)."""
    values: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#") or "{" in line:
            continue
        parts = line.split()
        if len(parts) != 2:
            continue
        try:
            values[parts[0]] = float(parts[1])
        except ValueError:
            continue
    return values


def parse_labeled_gauge(text: str, name: str) -> Dict[str, float]:
    """Samples of one single-label family: label value -> sample value
    (enough for the goodput ledger's bounded `phase=` gauges)."""
    values: Dict[str, float] = {}
    prefix = name + "{"
    for line in text.splitlines():
        if not line.startswith(prefix):
            continue
        labels, _, sample = line[len(prefix):].partition("} ")
        _, _, label_value = labels.partition('="')
        label_value = label_value.rstrip('"')
        try:
            values[label_value] = float(sample)
        except ValueError:
            continue
    return values


def goodput_header(text: str) -> str:
    """The job-level goodput line for the header — or "" when the master
    predates the goodput ledger (old-master compatibility: degrade to
    the classic header, never raise)."""
    metrics = parse_metrics(text)
    if "elasticdl_goodput_ratio" not in metrics:
        return ""
    bits = [f"goodput={metrics['elasticdl_goodput_ratio'] * 100:.1f}%"]
    current = parse_labeled_gauge(text, "elasticdl_goodput_current_phase")
    active = [phase for phase, value in current.items() if value >= 1]
    if active:
        bits.append(f"phase={active[0]}")
    last_rescale = metrics.get("elasticdl_goodput_last_rescale_seconds")
    if last_rescale:
        bits.append(f"last_rescale={last_rescale:.1f}s")
    redone = sum(
        parse_labeled_gauge(text, "elasticdl_records_redone_total").values()
    )
    if redone:
        bits.append(f"redone={int(redone)}rec")
    return "  ".join(bits)


def policy_header(events: List[dict]) -> str:
    """The most recent `policy_decision` in the journal tail, for the
    header — or "" against masters that predate the policy engine (old
    masters emit no such events; degrade, never raise)."""
    last = None
    for event in events:
        if event.get("event") == "policy_decision":
            last = event
    if not isinstance(last, dict) or not last.get("action"):
        return ""
    text = f"policy={last['action']}"
    if last.get("reason"):
        text += f"({last['reason']})"
    if last["action"] == "evict" and last.get("worker_id") is not None:
        text += f" worker={last['worker_id']}"
    return text


def worker_rows(
    events: List[dict], now: Optional[float] = None
) -> List[dict]:
    """Fold the journal tail into one row per worker: the latest
    ``worker_telemetry`` snapshot plus straggler state from the most
    recent ``straggler_detected``/``straggler_cleared`` transition."""
    now = time.time() if now is None else now
    latest: Dict[int, dict] = {}
    anatomy: Dict[int, dict] = {}
    straggling: Dict[int, dict] = {}
    for event in events:
        kind = event.get("event")
        wid = event.get("worker_id")
        if wid is None:
            continue
        if kind == "worker_telemetry":
            latest[wid] = event
        elif kind == "step_anatomy":
            anatomy[wid] = event
        elif kind == "straggler_detected":
            straggling[wid] = event
        elif kind == "straggler_cleared":
            straggling.pop(wid, None)
    rows = []
    for wid in sorted(set(latest) | set(anatomy)):
        event = latest.get(wid, {})
        task = event.get("task") or {}
        total = task.get("records_total") or 0
        done = task.get("records_done") or 0
        progress = f"{done}/{total}" if total else "-"
        state = "ok"
        if wid in straggling:
            marker = straggling[wid].get("metric", "?")
            dominant = straggling[wid].get("dominant_phase")
            if dominant:
                marker = f"{marker}:{dominant}"
            state = f"STRAGGLER({marker})"
        fractions = (anatomy.get(wid) or {}).get("fractions") or {}
        overlap = _overlap_fraction(anatomy.get(wid) or {})
        rows.append(
            {
                "worker": wid,
                "age_s": round(max(0.0, now - float(event.get("ts", now))), 1),
                "p50_ms": _ms(event.get("step_p50_s")),
                "p95_ms": _ms(event.get("step_p95_s")),
                "examples_per_s": event.get("examples_per_s", 0.0),
                "task": task.get("id", -1),
                "progress": progress,
                "rendezvous_id": event.get("rendezvous_id", 0),
                "retries": (event.get("rpc") or {}).get("retries", 0),
                "phases": {
                    phase: _pct(fractions.get(phase))
                    for phase in _PHASE_COLUMNS
                },
                "overlap": _pct(overlap),
                "bound": (anatomy.get(wid) or {}).get("bound") or "-",
                "state": state,
            }
        )
    return rows


#: Eight-level bar glyphs for burn-rate sparklines (SLO header rows).
_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _spark(values: List[float], width: int = 24) -> str:
    """Last-`width` values as a unicode sparkline ("" when empty)."""
    vals = [float(v) for v in values][-max(1, int(width)):]
    if not vals:
        return ""
    lo = min(vals)
    hi = max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_CHARS[0] * len(vals)
    top = len(_SPARK_CHARS) - 1
    return "".join(
        _SPARK_CHARS[min(top, int((v - lo) / span * top + 0.5))]
        for v in vals
    )


def fetch_slo(base: str, tail: int = 32,
              timeout_s: float = 5.0) -> Optional[dict]:
    """The /slo payload, or None against masters predating the SLO
    plane (404, connection error, non-JSON — degrade, never raise)."""
    try:
        payload = json.loads(
            fetch_text(f"{base}/slo?n={tail}", timeout_s=timeout_s)
        )
    except (urllib.error.URLError, OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None


def slo_header(payload: Optional[dict]) -> str:
    """The SLO summary line for the header — budget remaining, worst
    burn rate, ALERT marker — or "" when the payload is absent/empty
    (old masters, planes with no specs)."""
    if not isinstance(payload, dict):
        return ""
    statuses = payload.get("statuses")
    if not isinstance(statuses, list) or not statuses:
        return ""
    min_budget = None
    worst = None  # (burn, slo, window)
    alerting = []
    for status in statuses:
        if not isinstance(status, dict):
            continue
        budget = status.get("budget_remaining_ratio")
        if isinstance(budget, (int, float)) and (
            min_budget is None or budget < min_budget
        ):
            min_budget = float(budget)
        for window, burn in (status.get("burn_rates") or {}).items():
            if isinstance(burn, (int, float)) and (
                worst is None or burn > worst[0]
            ):
                worst = (float(burn), status.get("slo", "?"), window)
        if status.get("alerting"):
            grade = status.get("grade") or "?"
            alerting.append(f"{status.get('slo', '?')}:{grade}")
    if min_budget is None and worst is None:
        return ""
    bits = [f"slo: budget={min_budget * 100:.1f}%"
            if min_budget is not None else "slo:"]
    if worst is not None:
        bits.append(f"worst_burn={worst[0]:.1f}x({worst[1]}@{worst[2]})")
    if alerting:
        bits.append("ALERT[" + ",".join(sorted(alerting)) + "]")
    return "  ".join(bits)


def slo_sparkline_notes(payload: Optional[dict],
                        width: int = 24) -> List[str]:
    """One per-SLO note line with the fast-window burn-rate sparkline
    the plane ships in each status ([] when absent)."""
    if not isinstance(payload, dict):
        return []
    notes = []
    for status in payload.get("statuses") or ():
        if not isinstance(status, dict):
            continue
        spark = _spark(status.get("sparkline") or [], width=width)
        if not spark:
            continue
        budget = status.get("budget_remaining_ratio")
        budget_text = (
            f" budget={budget * 100:.1f}%"
            if isinstance(budget, (int, float)) else ""
        )
        marker = " ALERT" if status.get("alerting") else ""
        notes.append(
            f"slo {status.get('slo', '?')}: {spark}{budget_text}{marker}"
        )
    return notes


def freshness_note(events: List[dict]) -> str:
    """The freshness-SLO state line for the serving frame — "" against
    journals from masters predating the freshness plane (no
    `freshness_slo` events; degrade, never raise)."""
    last = None
    for event in events:
        if event.get("event") == "freshness_slo":
            last = event
    if not isinstance(last, dict) or last.get("state") not in (
        "breach", "clear"
    ):
        return ""
    try:
        lag = float(last.get("lag_s", 0.0))
        slo = float(last.get("slo_s", 0.0))
    except (TypeError, ValueError):
        return ""
    if last["state"] == "breach":
        note = f"freshness: BREACH lag={lag:.1f}s > slo={slo:.1f}s"
        stage = last.get("stage")
        if stage:
            note += f" (stage: {stage})"
        return note
    return f"freshness: ok (last clear at lag={lag:.1f}s, slo={slo:.1f}s)"


def quality_note(events: List[dict]) -> str:
    """The model-quality state line for the serving frame — "" against
    journals from fleets predating the quality plane (no
    `quality_window` events; degrade, never raise)."""
    last = None
    gate = None
    for event in events:
        kind = event.get("event")
        if kind == "quality_window":
            last = event
        elif kind == "quality_gate":
            gate = event
    if not isinstance(last, dict):
        return ""
    try:
        joined = int(last.get("joined", 0))
        pending = int(last.get("pending", 0))
    except (TypeError, ValueError):
        return ""
    bits = [f"quality: joined={joined} pending={pending}"]
    auc = last.get("auc")
    if isinstance(auc, (int, float)):
        bits.append(f"auc={float(auc):.3f}")
    logloss = last.get("logloss")
    if isinstance(logloss, (int, float)):
        bits.append(f"logloss={float(logloss):.3f}")
    if isinstance(gate, dict) and gate.get("outcome") in ("held", "forced"):
        bits.append(
            f"gate={gate['outcome'].upper()} at step {gate.get('step')}"
        )
    return " ".join(bits)


def _origin_replica_id(origin) -> Optional[int]:
    """`replica_<id>` quality origins -> the serving_telemetry row key;
    None for anything else (worker origins, free-form strings)."""
    if isinstance(origin, str) and origin.startswith("replica_"):
        try:
            return int(origin[len("replica_"):])
        except ValueError:
            return None
    return None


def serving_rows(
    events: List[dict], now: Optional[float] = None
) -> List[dict]:
    """Fold the journal tail into one row per serving replica: the
    latest ``serving_telemetry`` snapshot (replica ids are never reused,
    so a SIGKILLed replica's stale row ages out of the tail while its
    replacement appears under a fresh id)."""
    now = time.time() if now is None else now
    latest: Dict[int, dict] = {}
    watermark_et = None
    quality_latest: Dict[int, dict] = {}
    drift_latest: Dict[int, dict] = {}
    for event in events:
        kind = event.get("event")
        if kind == "stream_watermark":
            # Trained event-time frontier: the reference point the
            # per-replica freshness column measures against.
            et = event.get("event_time")
            if isinstance(et, (int, float)):
                watermark_et = float(et)
            continue
        if kind in ("quality_window", "quality_drift"):
            # Model-quality plane: the latest windowed eval / drift
            # state per replica, joined onto the telemetry row below.
            rid = _origin_replica_id(event.get("origin"))
            if rid is not None:
                (quality_latest if kind == "quality_window"
                 else drift_latest)[rid] = event
            continue
        if kind != "serving_telemetry":
            continue
        rid = event.get("replica_id")
        if rid is None:
            continue
        latest[rid] = event
    rows = []
    for rid in sorted(latest):
        event = latest[rid]
        avail = event.get("availability_ratio")
        # Replica freshness: how far its servable model's event-time
        # frontier trails the trained watermark.  "-" against journals
        # from masters predating the continuous loop (no watermark
        # events, or telemetry without model_event_time) — degrade,
        # never raise.
        model_et = event.get("model_event_time")
        fresh_s = None
        if watermark_et is not None and isinstance(model_et, (int, float)):
            fresh_s = max(0.0, watermark_et - float(model_et))
        rows.append(
            {
                "replica": rid,
                "age_s": round(max(0.0, now - float(event.get("ts", now))), 1),
                "generation": event.get("generation", 0),
                "step": event.get("step", 0),
                "fresh_s": fresh_s,
                "qps": float(event.get("qps", 0.0) or 0.0),
                "p50_ms": event.get("p50_ms"),
                "p99_ms": event.get("p99_ms"),
                "queue_depth": event.get("queue_depth", 0),
                "inflight": event.get("inflight", 0),
                "availability_pct": _pct(avail),
                "served": event.get("served", 0),
                "shed": event.get("shed", 0),
                "errors": event.get("errors", 0),
            }
        )
        for field, _label in _SERVING_PHASE_COLUMNS:
            rows[-1][field] = event.get(field)
        quality = quality_latest.get(rid)
        if isinstance(quality, dict):
            auc = quality.get("auc")
            cal = quality.get("calibration_error")
            rows[-1]["quality_auc"] = (
                float(auc) if isinstance(auc, (int, float)) else None
            )
            rows[-1]["quality_cal"] = (
                float(cal) if isinstance(cal, (int, float)) else None
            )
        drift = drift_latest.get(rid)
        if isinstance(drift, dict):
            div = drift.get("divergence")
            if isinstance(div, (int, float)):
                rows[-1]["quality_drift"] = float(div)
                rows[-1]["quality_drift_state"] = drift.get("state")
        exemplar = event.get("exemplar")
        if isinstance(exemplar, dict):
            rows[-1]["exemplar"] = exemplar
    return rows


def render_serving(
    rows: List[dict],
    metrics: Dict[str, float],
    addr: str = "",
    notes: Optional[List[str]] = None,
) -> str:
    """One serving-plane status frame as plain text."""
    header_bits = []
    for name, label in _SERVING_HEADER_GAUGES:
        if name in metrics:
            header_bits.append(f"{label}={metrics[name]:.2f}")
    lines = [
        f"elasticdl top (serving) — {addr}  " + "  ".join(header_bits),
    ]
    # The per-phase p99 split renders only when some replica journals
    # it (post-request-tracing); old journals get the old frame.
    has_phases = any(
        row.get(field) is not None
        for row in rows
        for field, _label in _SERVING_PHASE_COLUMNS
    )
    columns = _SERVING_COLUMNS
    if has_phases:
        columns = columns + tuple(
            label for _field, label in _SERVING_PHASE_COLUMNS
        )
    # Likewise the quality columns: only when some replica's journal
    # carries a joined-label evaluation window or a drift sketch.
    has_quality = any(
        row.get(field) is not None
        for row in rows
        for field, _label in _SERVING_QUALITY_COLUMNS
    )
    if has_quality:
        columns = columns + tuple(
            label for _field, label in _SERVING_QUALITY_COLUMNS
        )
    table: List[Tuple[str, ...]] = [columns]
    for row in rows:
        cells = (
            str(row["replica"]),
            f"{row['age_s']:.1f}",
            str(row["generation"]),
            str(row["step"]),
            "-" if row.get("fresh_s") is None else f"{row['fresh_s']:.1f}",
            f"{row['qps']:.1f}",
            _fixed_ms(row["p50_ms"]),
            _fixed_ms(row["p99_ms"]),
            str(row["queue_depth"]),
            str(row["inflight"]),
            str(row["availability_pct"]),
            str(row["served"]),
            str(row["shed"]),
            str(row["errors"]),
        )
        if has_phases:
            cells = cells + tuple(
                _fixed_ms(row.get(field))
                for field, _label in _SERVING_PHASE_COLUMNS
            )
        if has_quality:
            cells = cells + (
                _fixed3(row.get("quality_auc")),
                _fixed3(row.get("quality_cal")),
                _drift_cell(row),
            )
        table.append(cells)
    widths = [
        max(len(line[col]) for line in table)
        for col in range(len(columns))
    ]
    for line in table:
        lines.append(
            "  ".join(cell.ljust(width) for cell, width in zip(line, widths))
            .rstrip()
        )
    if not rows:
        lines.append(
            "(no serving_telemetry events in the journal tail — is this a "
            "training-only master?)"
        )
    exemplars = [
        (row["replica"], row["exemplar"])
        for row in rows
        if isinstance(row.get("exemplar"), dict)
        and isinstance(row["exemplar"].get("latency_ms"), (int, float))
    ]
    if exemplars:
        rid, slowest = max(
            exemplars, key=lambda pair: pair[1]["latency_ms"]
        )
        dominant = slowest.get("dominant_phase") or "-"
        lines.append(
            f"slowest sampled request: trace {slowest.get('trace_id')} "
            f"{float(slowest['latency_ms']):.1f}ms dominant {dominant} "
            f"(replica {rid}; resolve with obs.trace)"
        )
    for note in notes or ():
        lines.append(note)
    return "\n".join(lines)


def _fixed_ms(value) -> str:
    """Already-in-ms telemetry field (unlike `_ms`, which converts)."""
    if value is None:
        return "-"
    return f"{float(value):.1f}"


def _fixed3(value) -> str:
    """Three-decimal quality ratio (AUC, calibration error)."""
    if value is None:
        return "-"
    return f"{float(value):.3f}"


def _drift_cell(row: dict) -> str:
    """Train-serve divergence cell; `!` flags an un-cleared breach."""
    value = row.get("quality_drift")
    if value is None:
        return "-"
    mark = "!" if row.get("quality_drift_state") == "breach" else ""
    return f"{float(value):.2f}{mark}"


def _ms(seconds) -> str:
    if seconds is None:
        return "-"
    return f"{float(seconds) * 1e3:.1f}"


def _pct(fraction) -> str:
    if fraction is None:
        return "-"
    return f"{float(fraction) * 100:.0f}"


def _overlap_fraction(anatomy: dict) -> Optional[float]:
    """Async-staging overlap credit as a fraction of accounted-plus-
    overlapped host time — None when the worker reports none (sync
    pipeline, or a master predating overlap_s)."""
    overlap = anatomy.get("overlap_s")
    if not isinstance(overlap, (int, float)) or overlap <= 0:
        return None
    totals = anatomy.get("totals") or {}
    accounted = sum(
        float(v) for v in totals.values()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    )
    return float(overlap) / (accounted + float(overlap))


def render(
    rows: List[dict],
    metrics: Dict[str, float],
    addr: str = "",
    job_header: str = "",
    notes: Optional[List[str]] = None,
) -> str:
    """One status frame as plain text (also the --once output)."""
    header_bits = []
    for name, label in _HEADER_GAUGES:
        if name in metrics:
            value = metrics[name]
            formatted = (
                str(int(value)) if float(value).is_integer() else f"{value:.1f}"
            )
            header_bits.append(f"{label}={formatted}")
    lines = [
        f"elasticdl top — {addr}  " + "  ".join(header_bits),
    ]
    if job_header:
        lines.append(job_header)
    table: List[Tuple[str, ...]] = [_COLUMNS]
    for row in rows:
        phases = row.get("phases") or {}
        table.append(
            (
                str(row["worker"]),
                f"{row['age_s']:.1f}",
                str(row["p50_ms"]),
                str(row["p95_ms"]),
                f"{row['examples_per_s']:.1f}",
                str(row["task"]),
                str(row["progress"]),
                str(row["rendezvous_id"]),
                str(row["retries"]),
                *(phases.get(phase, "-") for phase in _PHASE_COLUMNS),
                str(row.get("overlap", "-")),
                str(row.get("bound", "-")),
                row["state"],
            )
        )
    widths = [
        max(len(line[col]) for line in table) for col in range(len(_COLUMNS))
    ]
    for line in table:
        lines.append(
            "  ".join(cell.ljust(width) for cell, width in zip(line, widths))
            .rstrip()
        )
    if not rows:
        lines.append("(no worker_telemetry events in the journal tail yet)")
    for note in notes or ():
        lines.append(note)
    return "\n".join(lines)


def snapshot_frame(addr: str, tail: int = 256, serving: bool = False) -> str:
    base = addr if "://" in addr else f"http://{addr}"
    metrics_text = fetch_text(base + "/metrics")
    # The journal endpoint is newer than /metrics: an old master without
    # it degrades to the aggregate header, not a crash.
    notes: List[str] = []
    events: List[dict] = []
    try:
        journal = json.loads(fetch_text(f"{base}/journal?n={tail}"))
        events = journal.get("events", [])
    except (urllib.error.URLError, OSError, ValueError) as exc:
        notes.append(f"(journal endpoint unavailable: {exc})")
    # /slo is newer still: None against old masters — the SLO header
    # row and sparklines simply don't render.
    slo_payload = fetch_slo(base, tail=min(tail, 64))
    if serving:
        fresh = freshness_note(events)
        if fresh:
            notes.append(fresh)
        quality = quality_note(events)
        if quality:
            notes.append(quality)
        slo_line = slo_header(slo_payload)
        if slo_line:
            notes.append(slo_line)
        notes.extend(slo_sparkline_notes(slo_payload))
        return render_serving(
            serving_rows(events),
            parse_metrics(metrics_text),
            addr,
            notes=notes,
        )
    notes.extend(slo_sparkline_notes(slo_payload))
    job_header = "  ".join(
        part
        for part in (goodput_header(metrics_text), policy_header(events),
                     slo_header(slo_payload))
        if part
    )
    return render(
        worker_rows(events),
        parse_metrics(metrics_text),
        addr,
        job_header=job_header,
        notes=notes,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.obs.top",
        description="Live per-worker status from a master's metrics port.",
    )
    parser.add_argument(
        "--addr", default="localhost:9090",
        help="host:port of the master's --metrics_port exporter",
    )
    parser.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh interval in seconds",
    )
    parser.add_argument(
        "--tail", type=int, default=256,
        help="journal events to fold per frame",
    )
    parser.add_argument(
        "--once", action="store_true", help="print one frame and exit"
    )
    parser.add_argument(
        "--serving", action="store_true",
        help="render the serving-plane table (point --addr at any "
        "serving replica's metrics port)",
    )
    args = parser.parse_args(argv)
    while True:
        try:
            frame = snapshot_frame(args.addr, args.tail, serving=args.serving)
        except (urllib.error.URLError, OSError, ValueError) as exc:
            frame = f"elasticdl top — {args.addr} unreachable: {exc}"
        if args.once:
            print(frame)
            return 0
        # ANSI clear + home keeps the table in place like top(1).
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
