"""The port's journal schema registry, and a checker of event journals.

    python -m elasticdl_tpu_torch.analysis.journal_schema events.jsonl [...]
    python -m elasticdl_tpu_torch.analysis.journal_schema --selftest
    python -m elasticdl_tpu_torch.analysis.journal_schema --check-sources

The port's copy of the JAX package's ``scripts/validate_journal.py``:
every event of that registry with its exact required and optional
fields, plus the events only the port writes (``PORT_EVENTS``) and the
fields the port adds to shared events (``PORT_OPTIONAL_EXTRAS``).  The
analyzer's ``journal-schema`` rule reads this module; it is the single
source of truth for what the port may journal.

Exit status: 0 when every record validates, 1 on any malformed record,
2 on usage errors.  Every record must be a JSON object with a numeric
``ts`` and a non-empty string ``event``; events named in
``EVENT_REQUIRED_FIELDS`` must additionally carry their listed fields.
Unknown event types pass (the journal is open for extension) —
malformed JSON, wrong-typed envelope fields, or missing required fields
fail.  Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
from typing import List, Tuple

#: Required fields per documented event type (the JAX package's
#: docs/observability.md), then the port's own events.  Extension stays
#: cheap: add the event name + its load-bearing fields.
EVENT_REQUIRED_FIELDS = {
    "master_start": ("job_name",),
    "rendezvous": ("rendezvous_id", "world_size"),
    "task_dispatch": ("task_id", "worker_id", "trace_id"),
    "task_done": ("task_id", "trace_id"),
    "task_requeue": ("reason",),
    "task_failed_permanently": ("task_id",),
    "worker_churn": ("workers", "exit_codes"),
    "hung_worker_kill": ("worker_id",),
    "worker_telemetry": ("worker_id",),
    "straggler_detected": ("worker_id", "metric"),
    "straggler_cleared": ("worker_id",),
    "scale": ("old_size", "new_size"),
    "scale_up": ("old_size", "new_size"),
    "span": ("name", "duration_s"),
    "job_failed": ("reason",),
    # Goodput ledger (obs/goodput.py — docs/observability.md "Goodput").
    "phase_transition": ("from", "to", "seconds"),
    "rescale_cost": (
        "cause", "total_s", "detection_s", "rendezvous_s", "redo_s",
    ),
    "goodput_summary": ("goodput_ratio", "wall_s", "phases"),
    # Elastic policy engine (master/policy.py — docs/observability.md
    # "Policy decisions"): scale_up/scale_down/evict/hold + evidence.
    "policy_decision": ("action", "reason"),
    # Step anatomy (obs/stepstats.py — docs/observability.md "Step
    # anatomy"): per-worker compute-plane phase decomposition.
    "step_anatomy": ("worker_id",),
    # StepProfiler trace windows (common/profiler.py): lets obs.report
    # point at the TensorBoard trace covering an anomalous window.
    "profile_window": ("worker_id", "action", "trace_dir"),
    # Bench regression gate (scripts/bench_regress.py): per-metric
    # verdicts of a bench.py run vs the recorded baseline spread.
    "bench_regress": ("verdict", "metrics_total", "regressed"),
    # Sparse-path engine decision (parallel/ps_trainer.py init): which
    # lookup/apply engine (xla vs the fused Pallas kernels) a training
    # run's numbers were measured on — and, for the fused engine, which
    # dispatch route it took (`route`: single_device pallas_call vs
    # shard_map over the mesh; 'xla' for the SPMD-partitioned engine) —
    # postmortems and bench audits must not have to guess
    # (docs/design.md "Fused sparse kernels").
    "sparse_kernel_selected": ("kernel",),
    # Declarative compile layer (parallel/compile.py): one event per
    # compiled entry point — trainer identity, pjit-vs-shard_map
    # strategy, rule-table hit/miss counts, donated argnums — so a
    # postmortem can always answer "what placement did this job
    # actually compile?" (docs/design.md "Declarative sharding").
    "compile_plan": ("trainer", "strategy"),
    # Distributed tracing plane (obs/tracing.py + obs/trace.py —
    # docs/observability.md "Distributed tracing").  `span` above stays
    # backward-compatible (name + duration_s); tracing-plane spans add
    # span_id/trace_id/parent_span_id/start_ts as optional fields.
    # `clock_probe` is the worker-journal half of clock alignment:
    # wall stamps around the telemetry-carrying heartbeat RPC, paired
    # with the master's worker_telemetry event by (worker_id, probe_ts
    # == worker_ts) for the midpoint offset estimate.
    "clock_probe": ("worker_id", "probe_ts", "t_send", "t_recv"),
    # Crash flight recorder (tracing.flush_flight_record): the final
    # bounded metrics dump a SIGTERM'd process leaves next to its
    # flushed open spans.
    "registry_snapshot": ("reason",),
    # Serving plane (serving/ — docs/serving.md).  `model_swap` is the
    # hot-swap commit record (new generation + the training step it was
    # exported at; old_generation/drained_inflight ride as optional
    # evidence).  `request_shed` is the explicit load-shed record
    # (reason: queue_full at admission, deadline in queue).
    # `serving_telemetry` is the per-replica periodic rollup — replica
    # id is unbounded, so qps/p50/p99/queue-depth/generation ride the
    # journal, never metric labels.  Serving requests reuse
    # `phase_transition` with the REQUEST_PHASES taxonomy
    # (queue/batch/execute/respond — obs/stepstats.py).
    "model_swap": ("generation", "step"),
    "request_shed": ("reason",),
    "serving_telemetry": ("replica_id",),
    "serving_replica_start": ("replica_id", "port"),
    "serving_fleet_start": ("replicas",),
    # Continuous train->serve loop (master/stream.py, checkpoint/delta.py,
    # obs/freshness.py — docs/design.md "Continuous training").
    # `stream_watermark` records every advance of the trained-offset
    # frontier (the journal-backed resume point for a SIGKILLed master);
    # `delta_checkpoint`/`delta_compaction` are the chain's commit
    # records; `freshness_slo` fires on breach/clear TRANSITIONS only,
    # with the lag attributed to the owning stage.
    "stream_watermark": ("stream", "offset"),
    "delta_checkpoint": ("step", "base_step"),
    "delta_compaction": ("step",),
    "freshness_slo": ("state", "lag_s", "slo_s"),
    # SLO plane (obs/slo.py — docs/observability.md "SLO plane").
    # `slo_status` is the rate-limited per-tick rollup of one SLO's
    # error budget; `slo_alert` is the edge-triggered multi-window
    # burn-rate fire/clear with its evidence (per-window burn rates,
    # budget remaining, offending series).
    "slo_status": ("slo", "budget_remaining_ratio"),
    "slo_alert": ("slo", "state"),
    # Request-level tracing exemplars (serving/ledger.py ExemplarSampler
    # — docs/observability.md "Request tracing & exemplars").  Journaled
    # only for sampled requests (deterministic head samples, over-SLO
    # tails, and every non-served outcome), so exemplar volume is
    # O(sampled), never O(requests); the trace id is journal-only per
    # the cardinality rule.
    "request_trace": ("trace_id", "outcome", "sampled_by"),
    # Model-quality plane (obs/quality.py — docs/observability.md
    # "Model quality").  `quality_window` is the periodic online-metric
    # rollup of the label-join ledger (AUC/logloss/calibration ride as
    # optional fields — a window can be labelless); `quality_drift`
    # fires on train-serve divergence breach/clear EDGES only;
    # `quality_gate` records every canary-gate verdict on a delta link
    # (outcome passed|held|forced, with the shadow-eval evidence).
    "quality_window": ("joined", "origin"),
    "quality_drift": ("state", "divergence", "origin"),
    "quality_gate": ("outcome", "step", "origin"),
}

#: Events only the port writes, with the fields every emission carries
#: (required) and the ones some carry (optional).  The worker and master
#: processes journal their lifecycle and counts so a killed process
#: leaves them behind (worker/main.py, worker/worker.py,
#: worker/collective_worker.py, master/job_runner.py,
#: master/pod_manager.py, master/evaluation_service.py, client/api.py).
PORT_EVENTS = {
    "worker_start": (("worker_id", "pid"), ("device",)),
    "worker_launch": (("worker_id", "pid"), ("log",)),
    "data_readers": (("training", "validation", "prediction"), ("record_codec",)),
    "first_step": (("rank", "step", "steps", "seconds_since_start"), ()),
    "worker_task_done": (
        ("task_id", "type", "start", "end", "steps", "seconds", "step",
         "process_steps", "process_eval_batches"),
        ("rank", "records", "kernel_launches", "etrf_per_record_reads",
         "forbidden_modules", "data_wait_s", "stage_s", "batch_shape",
         "columnar_s", "columnar_transform_s"),
    ),
    "checkpoint_restore": (
        ("rank", "step"), ("seconds", "state_crc32", "model_state_crc32"),
    ),
    "evaluation_metrics": (("model_version", "metrics"), ("examples", "seconds")),
    "model_exported": (("worker_id", "path", "step"), ("seconds",)),
    "worker_exit": (
        ("worker_id", "seconds", "steps"), ("kernel_launches", "forbidden_modules"),
    ),
    "local_job_exit": (("seconds", "steps"), ("eval_batches", "forbidden_modules")),
    "master_exit": (("succeeded",), ("restarts_used", "forbidden_modules")),
}
EVENT_REQUIRED_FIELDS.update(
    {event: required for event, (required, _) in PORT_EVENTS.items()}
)

#: Every event type the port is ALLOWED to emit.  Journal FILES stay
#: open for extension (unknown events in a file pass — an old validator
#: must not reject a newer master's journal), but the port's own call
#: sites must register here: ``--check-sources`` runs the analyzer's
#: AST ``journal-schema`` rule over the source tree and fails on any
#: emission whose event name is missing from this set, so schema drift
#: can't recur silently.
KNOWN_EVENTS = frozenset(EVENT_REQUIRED_FIELDS) | {
    "task_progress_resume",
    "train_epoch_done",
    "job_complete",
    "pod_create_failed",
    "pod_pending_timeout",
    "checkpoint_saved",
    "checkpoint_restored",
    "checkpoint_quarantined",
}

#: Optional fields per event: everything a call site may carry BESIDE
#: the required fields and the ts/event envelope.  This is the
#: field-level half of the source contract — the analyzer's
#: ``journal-schema`` rule flags any literal kwarg/dict key at an
#: emission site that is in neither the required nor the optional set,
#: which is how a misspelled field (``generaton=...``) gets caught at
#: lint time instead of at post-mortem grep time.  Journal-FILE
#: validation stays permissive (extra fields in a file always pass).
#: Every KNOWN_EVENTS entry appears here, even when empty, so adding a
#: field is an explicit one-line registration.
EVENT_OPTIONAL_FIELDS = {
    "master_start": ("port", "metrics_port"),
    "rendezvous": ("coordinator", "workers"),
    "task_dispatch": ("type", "shard", "start", "end", "epoch"),
    "task_done": ("worker_id", "type", "duration_s"),
    "task_requeue": (
        "task_id", "task_ids", "worker_id", "trace_id", "trace_ids",
        "retry", "records", "timeout_s",
    ),
    "task_failed_permanently": (
        "trace_id", "retries", "shard", "start", "end",
    ),
    "task_progress_resume": (
        "stream", "epoch", "todo", "finished_records", "next_offset",
        "watermark", "completed_above_watermark",
    ),
    "train_epoch_done": ("epoch", "next_epoch"),
    "job_complete": ("restarts_used",),
    "job_failed": (),
    "worker_churn": ("old_size", "restarts_used", "budget_left"),
    "hung_worker_kill": ("silent_s",),
    "worker_telemetry": (
        "worker_ts", "step", "step_p50_s", "step_p95_s", "examples_s",
        "data_wait_s", "host",
    ),
    "straggler_detected": ("value", "threshold", "median"),
    "straggler_cleared": ("metric",),
    "scale": ("direction",),
    "scale_up": ("direction",),
    "pod_create_failed": ("pod", "error"),
    "pod_pending_timeout": ("pod", "timeout_s"),
    "span": (
        "trace_id", "span_id", "parent_span_id", "start_ts", "proc",
        "task_id", "worker_id", "error", "steps",
        # Serving request spans (rpc.predict / serve.queue /
        # serve.execute / serve.respond) and the shared serve.batch span
        # every member request links to via `batch_span_id`.
        "rows", "outcome", "batch_rows", "bucket", "generation",
        "requests", "batch_span_id", "addr",
    ),
    "phase_transition": ("cause",),
    "rescale_cost": (
        "seq", "old_size", "new_size", "rendezvous_id", "redo_tasks",
        "redo_records", "superseded",
    ),
    "goodput_summary": (
        "outcome", "rescales", "records_done", "records_redone",
    ),
    "policy_decision": (
        "worker_id", "flag_streak_ticks", "kill_budget_remaining",
        "evidence", "old_size", "new_size",
        # SLO advisory evidence (note_slo_alert -> _hold): which SLOs
        # were fired while the engine decided, plus the fire evidence.
        "slo_advisory", "slo", "grade", "burn_rates",
        "budget_remaining_ratio", "offending", "origin",
    ),
    "step_anatomy": (
        "totals", "fractions", "steps", "examples", "retraces", "bound",
        "dominant_phase", "overlap_s",
    ),
    "profile_window": ("step_start", "step_end"),
    "bench_regress": ("details", "baseline"),
    "sparse_kernel_selected": (
        "requested", "route", "optimizer", "tables", "table_rows",
    ),
    "compile_plan": (
        "name", "rule_table", "rule_hits", "rule_misses",
        "donated_argnums", "devices",
    ),
    "clock_probe": ("rtt_s",),
    "registry_snapshot": ("proc", "metrics"),
    "model_swap": (
        "old_generation", "old_step", "model_dir", "drained_inflight",
        "undrained", "kind", "outcome", "reason", "event_time",
    ),
    "request_shed": (
        "queue_depth", "queue_limit", "rows", "waited_s",
    ),
    "serving_telemetry": (
        "generation", "step", "inflight", "queue_depth", "qps",
        "p50_ms", "p99_ms", "availability_ratio", "served", "dropped",
        "shed", "errors", "model_event_time",
        # Per-phase p99 split (queue/batch/execute/respond — the
        # obs.top --serving QU/BA/EX/RE columns) and the slowest recent
        # exemplar ({trace_id, latency_ms, dominant_phase}).
        "queue_p99_ms", "batch_p99_ms", "execute_p99_ms",
        "respond_p99_ms", "exemplar",
    ),
    "serving_replica_start": ("model_dir", "generation"),
    "serving_fleet_start": ("model_dir", "serve_dir"),
    "stream_watermark": ("event_time", "next_offset", "pending_ranges"),
    "delta_checkpoint": ("rows", "tables", "event_time"),
    "delta_compaction": ("deltas_folded", "event_time"),
    "freshness_slo": ("stage", "generation", "step"),
    "slo_status": (
        "kind", "objective", "window_s", "bad_fraction", "burn_rates",
        "alerting", "grade", "offending", "origin",
    ),
    "slo_alert": (
        "grade", "burn_rates", "budget_remaining_ratio", "offending",
        "windows", "origin", "objective",
        # Up-to-K exemplar trace ids from the serving ExemplarSampler:
        # the offending-REQUEST evidence beside the offending-series
        # string (resolvable in the assembled obs.trace output).
        "exemplars",
    ),
    "request_trace": (
        "latency_ms", "phases", "dominant_phase", "rows", "replica_id",
        "generation", "bucket",
    ),
    "checkpoint_saved": ("step", "kind", "n_processes", "event_time"),
    "checkpoint_restored": ("step", "kind"),
    "checkpoint_quarantined": ("path", "reason"),
    "quality_window": (
        "window", "pending", "expired", "orphans", "auc", "logloss",
        "calibration_error", "prediction_mean", "label_mean", "entropy",
    ),
    "quality_drift": ("threshold",),
    "quality_gate": (
        "delta_dir", "reason", "rows", "quality", "baseline_logloss",
        "candidate_logloss", "baseline_auc", "candidate_auc",
    ),
}

#: Fields the port writes on events it shares with the JAX package:
#: the master's pid, the replica's device, startup time and the
#: forbidden-module census, and the rank, save time and state digests
#: of a DP checkpoint.
PORT_OPTIONAL_EXTRAS = {
    "master_start": ("pid",),
    "serving_replica_start": ("device", "forbidden_modules", "startup_s"),
    "checkpoint_saved": ("rank", "seconds", "state_crc32", "model_state_crc32"),
    # The tables' placement: an axis, "data,model" (the whole mesh) or None.
    "sparse_kernel_selected": ("placement",),
}
for _event, _extras in PORT_OPTIONAL_EXTRAS.items():
    EVENT_OPTIONAL_FIELDS[_event] = EVENT_OPTIONAL_FIELDS[_event] + _extras
EVENT_OPTIONAL_FIELDS.update(
    {event: optional for event, (_, optional) in PORT_EVENTS.items()}
)
KNOWN_EVENTS = KNOWN_EVENTS | frozenset(PORT_EVENTS)
del _event, _extras
assert set(EVENT_OPTIONAL_FIELDS) == set(KNOWN_EVENTS), (
    "EVENT_OPTIONAL_FIELDS must carry an entry (possibly empty) for "
    "every known event"
)


def validate_record(record: object) -> List[str]:
    """Schema errors for one parsed record ([] when valid)."""
    errors = []
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, not an object"]
    ts = record.get("ts")
    if not isinstance(ts, (int, float)) or isinstance(ts, bool):
        errors.append(f"'ts' must be a number, got {ts!r}")
    event = record.get("event")
    if not isinstance(event, str) or not event:
        errors.append(f"'event' must be a non-empty string, got {event!r}")
        return errors
    for field in EVENT_REQUIRED_FIELDS.get(event, ()):
        if field not in record:
            errors.append(f"event '{event}' missing required field '{field}'")
    return errors


def validate_file(path: str) -> List[Tuple[int, str]]:
    """(line number, message) for every invalid line in a journal file."""
    problems: List[Tuple[int, str]] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError as exc:
                problems.append((lineno, f"invalid JSON: {exc}"))
                continue
            for message in validate_record(record):
                problems.append((lineno, message))
    return problems


#: ``--check-sources`` runs the analyzer's AST ``journal-schema`` rule
#: (``analysis/protocol_rules.py``): every literal field at each
#: ``journal.record(...)`` / ``record_span(...)`` / ``dict(event=...)``
#: site is checked against EVENT_REQUIRED_FIELDS / EVENT_OPTIONAL_FIELDS
#: above, so a misspelled field fails the gate.
_UNKNOWN_EVENT_RE = re.compile(r"unknown journal event '([^']+)'")


def _analysis_scan(root: str):
    """One journal-schema pass of the analyzer over `root`."""
    from elasticdl_tpu_torch.analysis.core import scan
    from elasticdl_tpu_torch.analysis.protocol_rules import check_journal_schema

    return scan([root], [check_journal_schema])


def scan_sources(root: str) -> List[Tuple[str, int, str]]:
    """(path, line, event) for every journal emission whose event type is
    not registered in KNOWN_EVENTS.  Scans the package source tree —
    tests journal arbitrary demo events and are deliberately excluded."""
    unknown: List[Tuple[str, int, str]] = []
    for violation in _analysis_scan(root).violations:
        match = _UNKNOWN_EVENT_RE.search(violation.message)
        if match:
            unknown.append((violation.path, violation.line, match.group(1)))
    return unknown


def scan_sources_counted(root: str) -> Tuple[List[Tuple[str, int, str]], int]:
    """All journal-schema findings as (path, line, message), plus the
    scanned-file count (zero means the gate looked at nothing)."""
    report = _analysis_scan(root)
    problems = [
        (violation.path, violation.line, violation.message)
        for violation in report.violations
    ]
    return problems, len(report.files)


def _check_sources(root: str) -> int:
    if not os.path.isdir(root) and not (
        os.path.isfile(root) and root.endswith(".py")
    ):
        # A gate that scanned nothing must not pass (same rule as the
        # analysis CLI's zero-file-scan exit): a wrong cwd or a moved
        # tree would otherwise silently disable drift detection.
        print(
            f"check-sources: no .py files under {root!r} — wrong "
            "directory? (run from the repo root)", file=sys.stderr,
        )
        return 2
    problems, scanned = scan_sources_counted(root)
    if scanned == 0:
        print(
            f"check-sources: no .py files under {root!r} — wrong "
            "directory? (run from the repo root)", file=sys.stderr,
        )
        return 2
    if problems:
        print(
            "journal schema drift (event names and fields are checked "
            "against analysis/journal_schema.py by the analyzer's "
            "journal-schema rule):", file=sys.stderr,
        )
        for path, line, message in sorted(problems):
            print(f"  {path}:{line}: {message}", file=sys.stderr)
        return 1
    print(
        f"check-sources OK ({root}: {scanned} files, every emission "
        "site matches the registered event + field schema)"
    )
    return 0


def _selftest() -> int:
    """Generate a known-good and a known-bad journal and verify this
    validator tells them apart."""
    good = [
        {"ts": 1.0, "event": "master_start", "job_name": "j", "port": 1},
        {"ts": 2.0, "event": "rendezvous", "rendezvous_id": 1,
         "world_size": 2, "workers": [0, 1]},
        {"ts": 3.0, "event": "task_dispatch", "task_id": 1, "worker_id": 0,
         "trace_id": "t-1-1"},
        {"ts": 4.0, "event": "worker_telemetry", "worker_id": 0,
         "step_p50_s": 0.01},
        {"ts": 5.0, "event": "straggler_detected", "worker_id": 1,
         "metric": "step_time", "value": 1.0},
        {"ts": 6.0, "event": "task_done", "task_id": 1, "trace_id": "t-1-1"},
        {"ts": 6.2, "event": "phase_transition", "from": "idle",
         "to": "training", "cause": "task_dispatch", "seconds": 1.5},
        {"ts": 6.4, "event": "rescale_cost", "seq": 1,
         "cause": "worker_churn", "total_s": 3.0, "detection_s": 0.5,
         "rendezvous_s": 1.5, "redo_s": 1.0, "redo_records": 64},
        {"ts": 6.6, "event": "goodput_summary", "goodput_ratio": 0.87,
         "wall_s": 41.0, "phases": {"training": 35.7}},
        {"ts": 6.8, "event": "policy_decision", "action": "evict",
         "reason": "persistent_straggler", "worker_id": 1,
         "flag_streak_ticks": 3, "kill_budget_remaining": 0},
        # overlap_s rides BESIDE the exclusive phase totals (async
        # staging credit, obs/stepstats.py): fractions still sum to 1.0
        # over serialized time and overlap_s reports the hidden work.
        {"ts": 6.85, "event": "step_anatomy", "worker_id": 0,
         "totals": {"data_wait": 1.2, "execute": 4.0}, "steps": 64,
         "examples": 4096, "retraces": 1, "bound": "host",
         "fractions": {"data_wait": 0.23, "execute": 0.77},
         "dominant_phase": "execute", "overlap_s": 0.8},
        {"ts": 6.9, "event": "profile_window", "worker_id": 2,
         "action": "open", "step_start": 100, "step_end": 120,
         "trace_dir": "/logs/job1/profile/worker_2"},
        {"ts": 6.95, "event": "bench_regress", "verdict": "regressed",
         "metrics_total": 8, "regressed": 1,
         "details": [{"metric": "deepfm", "ratio": 0.8}]},
        {"ts": 6.97, "event": "sparse_kernel_selected", "kernel": "fused",
         "requested": "fused", "route": "shard_map", "optimizer": "adam",
         "tables": 1, "table_rows": 26000000},
        {"ts": 6.98, "event": "compile_plan", "trainer": "ps_trainer",
         "name": "ps_train_step", "strategy": "pjit",
         "rule_table": "ps-fused", "rule_hits": 3, "rule_misses": 0,
         "donated_argnums": [0], "devices": 8},
        # Tracing-plane span: the legacy envelope (name + duration_s)
        # plus the span-tree fields the assembler keys on.
        {"ts": 7.02, "event": "span", "name": "task.lifetime",
         "duration_s": 9.01, "start_ts": 6.99, "span_id": "t-1-1",
         "trace_id": "t-1-1", "proc": "master", "task_id": 1},
        {"ts": 7.04, "event": "span", "name": "step.data_wait",
         "duration_s": 2.0, "start_ts": 7.0, "span_id": "s-abc-3",
         "parent_span_id": "s-abc-2", "trace_id": "t-1-1",
         "proc": "worker_0"},
        {"ts": 7.06, "event": "clock_probe", "worker_id": 0,
         "probe_ts": 7.001, "t_send": 7.001, "t_recv": 7.041,
         "rtt_s": 0.04},
        {"ts": 7.08, "event": "registry_snapshot", "reason": "shutdown",
         "proc": "worker_0", "metrics": {"elasticdl_rpc_calls_total": 5}},
        # Serving plane (docs/serving.md).
        {"ts": 7.12, "event": "model_swap", "generation": 2, "step": 4096,
         "old_generation": 1, "old_step": 2048,
         "model_dir": "/exports/gen2", "drained_inflight": 3,
         "undrained": 0},
        {"ts": 7.14, "event": "request_shed", "reason": "queue_full",
         "queue_depth": 256, "queue_limit": 256, "rows": 8},
        {"ts": 7.16, "event": "serving_telemetry", "replica_id": 7,
         "generation": 2, "step": 4096, "inflight": 1, "queue_depth": 4,
         "qps": 812.5, "p50_ms": 3.1, "p99_ms": 11.8,
         "availability_ratio": 0.998, "served": 51233, "dropped": 14,
         "shed": 88, "errors": 0},
        {"ts": 7.18, "event": "serving_replica_start", "replica_id": 7,
         "port": 40001, "model_dir": "/exports/gen2", "generation": 1},
        {"ts": 7.2, "event": "serving_fleet_start", "replicas": 4,
         "model_dir": "/exports/gen2", "serve_dir": "/srv/fleet"},
        # A serving request's phase record rides the same
        # phase_transition envelope with the REQUEST_PHASES taxonomy.
        {"ts": 7.22, "event": "phase_transition", "from": "queue",
         "to": "execute", "cause": "batch_formed", "seconds": 0.0021},
        # Continuous train->serve loop.
        {"ts": 7.24, "event": "stream_watermark", "stream": "clicks",
         "offset": 81920, "event_time": 204.8, "next_offset": 86016,
         "pending_ranges": 2},
        {"ts": 7.25, "event": "delta_checkpoint", "step": 4160,
         "base_step": 4096, "rows": 1812, "tables": 2,
         "event_time": 204.8},
        {"ts": 7.26, "event": "delta_compaction", "step": 4288,
         "deltas_folded": 3, "event_time": 211.2},
        {"ts": 7.27, "event": "freshness_slo", "state": "breach",
         "lag_s": 12.4, "slo_s": 10.0, "stage": "serving",
         "generation": 2, "step": 4160},
        {"ts": 7.28, "event": "model_swap", "kind": "delta",
         "outcome": "rolled_back", "generation": 2, "step": 4160,
         "old_generation": 2, "old_step": 4160,
         "model_dir": "/pub/delta_000000004160_000000004224",
         "reason": "ValueError('corrupt delta')"},
        # SLO plane (obs/slo.py): the rate-limited status rollup and a
        # fire/clear alert pair with its burn-rate evidence.
        {"ts": 7.32, "event": "slo_status", "slo": "serving_latency",
         "kind": "threshold", "objective": 0.99, "window_s": 3600.0,
         "bad_fraction": 0.004, "budget_remaining_ratio": 0.6,
         "burn_rates": {"fast_short": 0.4, "fast_long": 0.3,
                        "slow_short": 0.3, "slow_long": 0.2},
         "alerting": False, "grade": "", "origin": "replica_0"},
        {"ts": 7.34, "event": "slo_alert", "slo": "serving_latency",
         "state": "fire", "grade": "page",
         "burn_rates": {"fast_short": 33.3, "fast_long": 18.2,
                        "slow_short": 18.2, "slow_long": 3.3},
         "budget_remaining_ratio": 0.12,
         "offending": "elasticdl_serving_latency_p99_ms",
         "origin": "replica_0"},
        {"ts": 7.36, "event": "slo_alert", "slo": "serving_latency",
         "state": "clear", "grade": "page",
         "burn_rates": {"fast_short": 0.0, "fast_long": 0.1,
                        "slow_short": 0.1, "slow_long": 1.1},
         "budget_remaining_ratio": 0.11, "offending": "",
         "origin": "replica_0"},
        # Request tracing & exemplars: a latency slo_alert
        # carrying exemplar trace ids, the shared serve.batch span, a
        # member request's phase span linking to it, and the sampler's
        # request_trace records (a tail exemplar + a minimal shed one).
        {"ts": 7.38, "event": "slo_alert", "slo": "serving_latency",
         "state": "fire", "grade": "page",
         "burn_rates": {"fast_short": 20.1, "fast_long": 15.0,
                        "slow_short": 15.0, "slow_long": 2.8},
         "budget_remaining_ratio": 0.4,
         "offending": "elasticdl_serving_latency_p99_ms",
         "origin": "replica_1", "exemplars": ["lg7-00000102"]},
        {"ts": 7.4, "event": "span", "name": "serve.batch",
         "duration_s": 0.004, "start_ts": 7.39, "span_id": "s-b-1",
         "proc": "replica_0", "batch_rows": 24, "bucket": 32,
         "generation": 2, "requests": 3},
        {"ts": 7.42, "event": "span", "name": "serve.execute",
         "duration_s": 0.003, "start_ts": 7.391, "span_id": "s-e-1",
         "parent_span_id": "s-b-1", "trace_id": "lg7-00000102",
         "proc": "replica_0", "rows": 8, "batch_span_id": "s-b-1"},
        {"ts": 7.44, "event": "request_trace", "trace_id": "lg7-00000102",
         "outcome": "served", "sampled_by": "tail", "latency_ms": 81.2,
         "phases": {"queue": 63.1, "batch": 0.8, "execute": 17.1,
                    "respond": 0.2},
         "dominant_phase": "queue", "rows": 8, "replica_id": 0,
         "generation": 2, "bucket": 32},
        {"ts": 7.46, "event": "request_trace", "trace_id": "lg7-00000140",
         "outcome": "shed", "sampled_by": "outcome"},
        {"ts": 7.48, "event": "serving_telemetry", "replica_id": 0,
         "generation": 2, "qps": 410.0, "p99_ms": 81.2,
         "queue_p99_ms": 63.1, "batch_p99_ms": 0.9,
         "execute_p99_ms": 17.4, "respond_p99_ms": 0.3,
         "exemplar": {"trace_id": "lg7-00000102", "latency_ms": 81.2,
                      "dominant_phase": "queue"}},
        # Model-quality plane: the windowed online-eval rollup, a
        # drift breach edge, and a canary-gate hold with its shadow-eval
        # evidence (docs/observability.md "Model quality").
        {"ts": 7.5, "event": "quality_window", "joined": 512,
         "origin": "replica_0", "window": 512, "pending": 9, "expired": 3,
         "orphans": 1, "auc": 0.71, "logloss": 0.48,
         "calibration_error": 0.04, "prediction_mean": 0.31,
         "label_mean": 0.3, "entropy": 0.58},
        {"ts": 7.52, "event": "quality_drift", "state": "breach",
         "divergence": 0.41, "threshold": 0.25, "origin": "replica_0"},
        {"ts": 7.54, "event": "quality_gate", "outcome": "held",
         "step": 4224, "origin": "replica_0",
         "delta_dir": "/pub/delta_000000004160_000000004224",
         "reason": "logloss_regress:0.3120", "rows": 192,
         "quality": "known", "baseline_logloss": 0.48,
         "candidate_logloss": 0.79, "baseline_auc": 0.71,
         "candidate_auc": 0.55},
        # The port's own events and the fields it adds to shared ones.
        {"ts": 7.6, "event": "worker_start", "worker_id": 0, "pid": 4242,
         "device": "cuda"},
        {"ts": 7.62, "event": "worker_task_done", "task_id": 1,
         "type": "TRAINING", "start": 0, "end": 4096, "steps": 8,
         "seconds": 0.91, "step": 8, "process_steps": 8,
         "process_eval_batches": 0, "data_wait_s": 0.12},
        {"ts": 7.64, "event": "checkpoint_saved", "step": 8, "kind": "full",
         "rank": 0, "seconds": 0.2, "state_crc32": 12345},
        {"ts": 7.66, "event": "master_exit", "succeeded": True,
         "restarts_used": 0},
        {"ts": 7.3, "event": "some_future_event", "anything": "goes"},  # noqa-invariant: journal-schema (an unregistered event on purpose: journal files stay open for extension)
    ]
    bad_lines = [
        '{"ts": 1.0, "event": "task_requeue"}',        # missing reason
        '{"ts": 1.2, "event": "policy_decision", "action": "hold"}',  # no reason
        '{"ts": 1.3, "event": "step_anatomy", "totals": {}}',  # no worker_id
        '{"ts": 1.35, "event": "profile_window", "worker_id": 1}',  # no action
        '{"ts": 1.4, "event": "bench_regress", "verdict": "ok"}',  # no counts
        '{"ts": 1.45, "event": "sparse_kernel_selected"}',  # no kernel
        '{"ts": 1.47, "event": "compile_plan", "trainer": "dp"}',  # no strategy
        '{"ts": 1.48, "event": "clock_probe", "worker_id": 0}',  # no stamps
        '{"ts": 1.49, "event": "registry_snapshot"}',           # no reason
        '{"ts": 1.491, "event": "model_swap", "generation": 2}',  # no step
        '{"ts": 1.492, "event": "request_shed", "rows": 8}',    # no reason
        '{"ts": 1.493, "event": "serving_telemetry", "qps": 1}',  # no replica
        '{"ts": 1.494, "event": "serving_replica_start", "replica_id": 1}',
        '{"ts": 1.495, "event": "serving_fleet_start"}',        # no replicas
        '{"ts": 1.496, "event": "stream_watermark", "stream": "clicks"}',
        '{"ts": 1.497, "event": "delta_checkpoint", "step": 4160}',  # no base
        '{"ts": 1.498, "event": "delta_compaction"}',           # no step
        '{"ts": 1.499, "event": "freshness_slo", "state": "breach"}',
        '{"ts": 1.4995, "event": "slo_status", "slo": "goodput"}',  # no budget
        '{"ts": 1.4996, "event": "slo_alert", "slo": "goodput"}',   # no state
        '{"ts": 1.4997, "event": "slo_alert", "state": "fire"}',    # no slo
        '{"ts": 1.4998, "event": "request_trace", "trace_id": "t",'
        ' "outcome": "served"}',                        # no sampled_by
        '{"ts": 1.4999, "event": "request_trace", "outcome": "shed",'
        ' "sampled_by": "outcome"}',                    # no trace_id
        '{"ts": 1.49991, "event": "quality_window", "auc": 0.7}',  # no joined
        '{"ts": 1.49992, "event": "quality_drift", "state": "breach"}',
        '{"ts": 1.49993, "event": "quality_gate", "step": 4224,'
        ' "origin": "replica_0"}',                      # no outcome
        '{"ts": 1.5, "event": "phase_transition", "from": "idle"}',  # no to
        '{"ts": 1.6, "event": "rescale_cost", "cause": "scale"}',  # no costs
        '{"event": "rendezvous", "rendezvous_id": 1, "world_size": 1}',  # no ts
        '{"ts": "yesterday", "event": "span", "name": "x", "duration_s": 1}',
        '{"ts": 2.0}',                                  # no event
        '{"ts": 3.0, "event": "task_done", "task_id"',  # truncated JSON
        '[1, 2, 3]',                                    # not an object
        '{"ts": 1.7, "event": "worker_start", "worker_id": 0}',  # no pid
        '{"ts": 1.71, "event": "worker_task_done", "task_id": 1}',  # no counts
        '{"ts": 1.72, "event": "master_exit"}',         # no succeeded
    ]
    with tempfile.TemporaryDirectory(prefix="journal_selftest_") as tmp:
        good_path = os.path.join(tmp, "good.jsonl")
        with open(good_path, "w", encoding="utf-8") as f:
            for record in good:
                f.write(json.dumps(record) + "\n")
        bad_path = os.path.join(tmp, "bad.jsonl")
        with open(bad_path, "w", encoding="utf-8") as f:
            f.write("\n".join(bad_lines) + "\n")
        good_problems = validate_file(good_path)
        bad_problems = validate_file(bad_path)
    if good_problems:
        print("selftest FAILED: valid journal flagged:", file=sys.stderr)
        for lineno, message in good_problems:
            print(f"  line {lineno}: {message}", file=sys.stderr)
        return 1
    if len({lineno for lineno, _ in bad_problems}) != len(bad_lines):
        print(
            f"selftest FAILED: expected every one of {len(bad_lines)} bad "
            f"lines flagged, got {bad_problems}",
            file=sys.stderr,
        )
        return 1
    print("journal_schema selftest OK")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.analysis.journal_schema",
        description="Schema-check the port's event journals (JSONL).",
    )
    parser.add_argument("paths", nargs="*", help="journal files to check")
    parser.add_argument(
        "--quiet", action="store_true", help="suppress per-line messages"
    )
    parser.add_argument(
        "--selftest", action="store_true",
        help="validate a generated good/bad pair and exit",
    )
    parser.add_argument(
        "--check-sources", nargs="?", const="elasticdl_tpu_torch",
        default=None, metavar="DIR",
        help="run the analyzer's AST journal-schema rule over the source "
        "tree (default: elasticdl_tpu_torch) and fail on unregistered "
        "event types or unregistered/missing fields",
    )
    args = parser.parse_args(argv)
    if args.check_sources is not None:
        status = _check_sources(args.check_sources)
        if status or not (args.selftest or args.paths):
            return status
    if args.selftest:
        return _selftest()
    if not args.paths:
        parser.print_usage(sys.stderr)
        return 2
    failed = False
    for path in args.paths:
        if not os.path.exists(path):
            print(f"{path}: no such file", file=sys.stderr)
            failed = True
            continue
        problems = validate_file(path)
        if problems:
            failed = True
            if not args.quiet:
                for lineno, message in problems:
                    print(f"{path}:{lineno}: {message}", file=sys.stderr)
            print(
                f"{path}: {len(problems)} problem(s)", file=sys.stderr
            )
        else:
            print(f"{path}: OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
