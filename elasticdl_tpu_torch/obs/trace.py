"""``python -m elasticdl_tpu_torch.obs.trace`` — distributed trace assembler.

The port's copy of ``elasticdl_tpu/obs/trace.py``, stdlib only: it imports nothing of the
JAX package.

Merges the master's ``events.jsonl`` and the per-worker
``events_worker_<id>.jsonl`` journals into ONE timeline: estimates each
worker's wall-clock offset from heartbeat round-trips, aligns every
worker event onto the master clock, rebuilds the span trees journaled
by the tracing plane (obs/tracing.py), and emits Chrome trace-event
JSON loadable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``:

    python -m elasticdl_tpu_torch.obs.trace /logs/job1 -o trace.json
    python -m elasticdl_tpu_torch.obs.trace /logs/job1            # text waterfall
    python -m elasticdl_tpu_torch.obs.trace events.jsonl events_worker_0.jsonl
    python -m elasticdl_tpu_torch.obs.trace --selftest

Clock model (docs/observability.md "Distributed tracing"):

- Every heartbeat that carries telemetry journals a ``clock_probe`` in
  the WORKER journal (``t_send``/``t_recv`` worker wall clocks around
  the RPC, plus the snapshot stamp ``probe_ts``); the master's
  ``worker_telemetry`` event carries its ingest time ``ts`` and echoes
  the same stamp as ``worker_ts``.  Joining the two on
  ``(worker_id, probe_ts == worker_ts)`` gives, per probe, the midpoint
  estimate ``offset = ts_master - (t_send + t_recv) / 2`` (error
  bounded by rtt/2 under asymmetric routing); the per-worker offset is
  the MEDIAN over probes.
- Fewer than 2 matched round-trips degrades to the master-authoritative
  fallback: the median one-way delta ``ts - worker_ts`` over
  ``worker_telemetry`` events (offset plus an un-cancelled one-way
  delay), or 0 with no signal at all — the worker's clock is then taken
  at face value and the clamp below enforces consistency.
- After alignment every span is MONOTONIC-CLAMPED into its parent:
  children may not start before or end after their parent, and no span
  may have negative duration — alignment error moves an edge by at most
  rtt/2, never inverts the tree.  The ``--selftest`` gate (and
  tests/test_tracing.py) assert both invariants on every emitted trace.

Output: ``-o trace.json`` writes ``{"traceEvents": [...]}`` with one
``ph: "X"`` complete event per span (µs timescale, per-process ``pid``
rows, greedy lane assignment so concurrent traces never overlap-render)
plus phase-track events derived from ``phase_transition`` journal
records; without ``-o`` a per-task text waterfall prints instead (the
terminal fallback).  Stdlib only.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import sys
from typing import Dict, List, Optional, Tuple

_WORKER_JOURNAL_RE = re.compile(r"events_worker_(\d+)\.jsonl(?:\.1)?$")

#: Sources: the master journal is authoritative for the timescale.
MASTER_SOURCE = "master"


def _load_jsonl(path: str) -> List[dict]:
    events = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn final line of a SIGKILLed process
                if isinstance(rec, dict) and isinstance(
                    rec.get("ts"), (int, float)
                ):
                    events.append(rec)
    except OSError:
        return []
    return events


def source_label(path: str) -> str:
    """``master`` for events.jsonl, ``worker_<id>`` for worker files."""
    name = os.path.basename(path)
    match = _WORKER_JOURNAL_RE.search(name)
    if match:
        return f"worker_{match.group(1)}"
    return MASTER_SOURCE


def discover_journals(path: str) -> List[str]:
    """A directory expands to its master + worker journal files
    (rotated ``.1`` files included, oldest first so sort-by-ts works
    on appends too); a file is itself."""
    if os.path.isdir(path):
        paths = []
        for pattern in (
            "events.jsonl.1",
            "events.jsonl",
            "events_worker_*.jsonl.1",
            "events_worker_*.jsonl",
        ):
            paths.extend(sorted(glob.glob(os.path.join(path, pattern))))
        return paths
    return [path]


def load_sources(paths: List[str]) -> Dict[str, List[dict]]:
    """{source label: time-sorted events} over all journal files."""
    by_source: Dict[str, List[dict]] = {}
    for path in paths:
        label = source_label(path)
        by_source.setdefault(label, []).extend(_load_jsonl(path))
    for events in by_source.values():
        events.sort(key=lambda e: e["ts"])
    return by_source


# ---------------------------------------------------------------------------
# Clock-offset estimation
# ---------------------------------------------------------------------------


def estimate_offset(
    probes: List[dict], telemetry: List[dict]
) -> Tuple[float, str, int]:
    """(offset_s, method, pairs) for ONE worker: ``offset_s`` added to a
    worker timestamp yields master time.

    ``probes`` are the worker journal's ``clock_probe`` events;
    ``telemetry`` the master journal's ``worker_telemetry`` events for
    the same worker.  Methods: ``midpoint`` (>= 2 matched round-trips),
    ``one_way`` (master-authoritative fallback from ingest deltas),
    ``none`` (no signal; offset 0)."""
    by_stamp: Dict[float, dict] = {}
    for event in telemetry:
        worker_ts = event.get("worker_ts")
        if isinstance(worker_ts, (int, float)):
            by_stamp[round(float(worker_ts), 3)] = event
    samples = []
    for probe in probes:
        stamp = probe.get("probe_ts")
        t_send, t_recv = probe.get("t_send"), probe.get("t_recv")
        if not all(
            isinstance(v, (int, float)) for v in (stamp, t_send, t_recv)
        ):
            continue
        match = by_stamp.get(round(float(stamp), 3))
        if match is None:
            continue
        # Midpoint method: the master stamped `ts` somewhere inside the
        # worker's [t_send, t_recv] round-trip window; assuming the two
        # legs are symmetric, the master's stamp aligns with the window
        # midpoint, so the clock offset is their difference.
        samples.append(float(match["ts"]) - (t_send + t_recv) / 2.0)
    if len(samples) >= 2:
        return statistics.median(samples), "midpoint", len(samples)
    one_way = [
        float(event["ts"]) - float(event["worker_ts"])
        for event in telemetry
        if isinstance(event.get("worker_ts"), (int, float))
    ]
    if one_way:
        return statistics.median(one_way), "one_way", len(one_way)
    return 0.0, "none", 0


def estimate_offsets(
    by_source: Dict[str, List[dict]]
) -> Dict[str, dict]:
    """{source label: {offset_s, method, pairs}} for every worker
    source (the master defines the timescale: offset 0)."""
    master = by_source.get(MASTER_SOURCE, [])
    telemetry_by_worker: Dict[int, List[dict]] = {}
    for event in master:
        if event.get("event") == "worker_telemetry":
            wid = event.get("worker_id")
            if isinstance(wid, int):
                telemetry_by_worker.setdefault(wid, []).append(event)
    offsets: Dict[str, dict] = {
        MASTER_SOURCE: {"offset_s": 0.0, "method": "authoritative", "pairs": 0}
    }
    for label, events in by_source.items():
        if label == MASTER_SOURCE:
            continue
        try:
            wid = int(label.split("_", 1)[1])
        except (IndexError, ValueError):
            wid = -1
        probes = [e for e in events if e.get("event") == "clock_probe"]
        offset, method, pairs = estimate_offset(
            probes, telemetry_by_worker.get(wid, [])
        )
        offsets[label] = {
            "offset_s": round(offset, 6), "method": method, "pairs": pairs,
        }
    return offsets


# ---------------------------------------------------------------------------
# Span extraction + monotonic clamping
# ---------------------------------------------------------------------------


def extract_spans(
    by_source: Dict[str, List[dict]], offsets: Dict[str, dict]
) -> List[dict]:
    """Aligned span dicts: {name, trace_id, span_id, parent_span_id,
    start, end, proc, args} with worker clocks shifted onto the master
    timescale.  Spans without a span_id (pre-tracing emitters) get a
    synthetic id so they still render (flat, parentless)."""
    spans: List[dict] = []
    synthetic = 0
    for label, events in by_source.items():
        offset = offsets.get(label, {}).get("offset_s", 0.0)
        for event in events:
            if event.get("event") != "span":
                continue
            duration = event.get("duration_s")
            if not isinstance(duration, (int, float)) or isinstance(
                duration, bool
            ):
                continue
            start = event.get("start_ts")
            if not isinstance(start, (int, float)) or isinstance(start, bool):
                # Pre-tracing spans only stamped the journal-write time:
                # approximate start as (write ts - duration).
                start = float(event["ts"]) - float(duration)
            span_id = event.get("span_id")
            if not isinstance(span_id, str) or not span_id:
                synthetic += 1
                span_id = f"legacy-{label}-{synthetic}"
            start = float(start) + offset
            args = {
                key: value
                for key, value in event.items()
                if key
                not in (
                    "event", "ts", "name", "duration_s", "start_ts",
                    "span_id", "parent_span_id", "trace_id", "proc",
                )
            }
            spans.append(
                {
                    "name": str(event.get("name", "span")),
                    "trace_id": str(event.get("trace_id", "") or ""),
                    "span_id": span_id,
                    "parent_span_id": str(
                        event.get("parent_span_id", "") or ""
                    ),
                    "start": start,
                    "end": start + max(0.0, float(duration)),
                    "proc": str(event.get("proc", "") or label),
                    "args": args,
                }
            )
    return spans


def clamp_spans(spans: List[dict]) -> int:
    """Monotonic clamping, in place: no negative durations, no child
    starting before or ending after its parent.  Processed parents-first
    (children of clamped parents clamp against the clamped extent), so
    residual alignment error can never invert the tree.  Returns the
    number of adjusted spans."""
    by_id = {span["span_id"]: span for span in spans}

    def depth(span: dict, seen=None) -> int:
        seen = seen or set()
        d = 0
        while True:
            parent = by_id.get(span.get("parent_span_id", ""))
            if parent is None or id(parent) in seen:
                return d
            seen.add(id(parent))
            span = parent
            d += 1

    adjusted = 0
    for span in sorted(spans, key=depth):
        before = (span["start"], span["end"])
        if span["end"] < span["start"]:
            span["end"] = span["start"]
        parent = by_id.get(span["parent_span_id"])
        if parent is not None:
            span["start"] = min(
                max(span["start"], parent["start"]), parent["end"]
            )
            span["end"] = min(max(span["end"], span["start"]), parent["end"])
        if (span["start"], span["end"]) != before:
            span["clamped"] = True
            adjusted += 1
    return adjusted


def check_invariants(spans: List[dict]) -> List[str]:
    """Problems (empty when clean): negative durations, children
    escaping parents — what clamp_spans must have eliminated."""
    problems = []
    by_id = {span["span_id"]: span for span in spans}
    for span in spans:
        if span["end"] < span["start"]:
            problems.append(
                f"span {span['span_id']} ({span['name']}) has negative "
                f"duration {span['end'] - span['start']:.6f}s"
            )
        parent = by_id.get(span["parent_span_id"])
        if parent is not None and (
            span["start"] < parent["start"] - 1e-9
            or span["end"] > parent["end"] + 1e-9
        ):
            problems.append(
                f"span {span['span_id']} ({span['name']}) escapes parent "
                f"{parent['span_id']} ({parent['name']})"
            )
    return problems


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------


def _phase_segments(
    by_source: Dict[str, List[dict]], offsets: Dict[str, dict]
) -> List[dict]:
    """Goodput phase tracks: each ``phase_transition`` closes the `from`
    phase, so the interval is [ts - seconds, ts] on that source's
    (aligned) clock."""
    segments = []
    for label, events in by_source.items():
        offset = offsets.get(label, {}).get("offset_s", 0.0)
        for event in events:
            if event.get("event") != "phase_transition":
                continue
            seconds = event.get("seconds")
            phase = event.get("from")
            if (
                not isinstance(seconds, (int, float))
                or isinstance(seconds, bool)
                or seconds <= 0
                or not isinstance(phase, str)
            ):
                continue
            end = float(event["ts"]) + offset
            segments.append(
                {
                    "name": f"phase:{phase}",
                    "start": end - float(seconds),
                    "end": end,
                    "proc": label,
                    "args": {"cause": event.get("cause", "")},
                }
            )
    return segments


def _assign_lanes(intervals: List[dict]) -> Dict[int, int]:
    """Greedy lane (tid) assignment per proc: an interval goes to the
    first lane where it either NESTS inside the lane's open intervals or
    starts after they all ended — Chrome/Perfetto render stacks from
    timestamps, but two PARTIALLY overlapping spans on one tid render
    wrong, so concurrent traces get their own lanes."""
    lanes: List[List[Tuple[float, float]]] = []  # per lane: open stack
    assignment: Dict[int, int] = {}
    for index, interval in sorted(
        enumerate(intervals),
        key=lambda pair: (pair[1]["start"], -(pair[1]["end"])),
    ):
        placed = None
        for lane_index, stack in enumerate(lanes):
            while stack and stack[-1][1] <= interval["start"] + 1e-9:
                stack.pop()
            if not stack or (
                stack[-1][0] <= interval["start"] + 1e-9
                and interval["end"] <= stack[-1][1] + 1e-9
            ):
                stack.append((interval["start"], interval["end"]))
                placed = lane_index
                break
        if placed is None:
            lanes.append([(interval["start"], interval["end"])])
            placed = len(lanes) - 1
        assignment[index] = placed
    return assignment


def build_chrome_trace(
    spans: List[dict],
    phase_segments: Optional[List[dict]] = None,
    offsets: Optional[Dict[str, dict]] = None,
) -> dict:
    """The Chrome trace-event JSON object (Perfetto-loadable)."""
    phase_segments = phase_segments or []
    everything = spans + phase_segments
    if not everything:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(item["start"] for item in everything)
    procs = sorted({item["proc"] for item in everything})
    pid_of = {proc: index for index, proc in enumerate(procs)}
    events: List[dict] = []
    for proc in procs:
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid_of[proc],
                "tid": 0,
                "args": {"name": proc},
            }
        )
    # Phase tracks occupy a reserved high lane; spans lane-pack below.
    PHASE_TID = 999
    for proc in procs:
        proc_spans = [s for s in spans if s["proc"] == proc]
        lanes = _assign_lanes(proc_spans)
        for index, span in enumerate(proc_spans):
            args = dict(span.get("args", {}))
            if span.get("trace_id"):
                args["trace_id"] = span["trace_id"]
            args["span_id"] = span["span_id"]
            if span.get("parent_span_id"):
                args["parent_span_id"] = span["parent_span_id"]
            if span.get("clamped"):
                args["clamped"] = True
            events.append(
                {
                    "ph": "X",
                    "name": span["name"],
                    "cat": "span",
                    "pid": pid_of[proc],
                    "tid": lanes[index],
                    "ts": round((span["start"] - t0) * 1e6, 3),
                    "dur": round((span["end"] - span["start"]) * 1e6, 3),
                    "args": args,
                }
            )
        for segment in phase_segments:
            if segment["proc"] != proc:
                continue
            events.append(
                {
                    "ph": "X",
                    "name": segment["name"],
                    "cat": "goodput_phase",
                    "pid": pid_of[proc],
                    "tid": PHASE_TID,
                    "ts": round((segment["start"] - t0) * 1e6, 3),
                    "dur": round(
                        (segment["end"] - segment["start"]) * 1e6, 3
                    ),
                    "args": dict(segment.get("args", {})),
                }
            )
    trace = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "elasticdl_tpu_torch.obs.trace",
            "t0_unix_s": round(t0, 6),
        },
    }
    if offsets:
        trace["otherData"]["clock_offsets"] = offsets
    return trace


def validate_chrome_trace(trace: dict) -> List[str]:
    """Schema problems of a Chrome trace-event object (the golden-file
    and selftest gate — stdlib, so no jsonschema dependency)."""
    problems = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for index, event in enumerate(events):
        if not isinstance(event, dict):
            problems.append(f"event {index} is not an object")
            continue
        ph = event.get("ph")
        if ph not in ("X", "M", "b", "e", "i"):
            problems.append(f"event {index}: unknown ph {ph!r}")
            continue
        if not isinstance(event.get("name"), str) or not event["name"]:
            problems.append(f"event {index}: missing name")
        if not isinstance(event.get("pid"), int):
            problems.append(f"event {index}: pid must be an int")
        if ph == "X":
            for key in ("ts", "dur"):
                value = event.get(key)
                if not isinstance(value, (int, float)) or isinstance(
                    value, bool
                ):
                    problems.append(
                        f"event {index}: {key} must be a number"
                    )
                elif key == "dur" and value < 0:
                    problems.append(f"event {index}: negative dur {value}")
            if not isinstance(event.get("tid"), int):
                problems.append(f"event {index}: tid must be an int")
    return problems


# ---------------------------------------------------------------------------
# Assembly driver + text waterfall
# ---------------------------------------------------------------------------


def assemble(paths: List[str]) -> dict:
    """journals -> {spans, offsets, clamped, invariant_problems,
    chrome}.  The one entry point tests and the CLI share."""
    files: List[str] = []
    for path in paths:
        files.extend(discover_journals(path))
    by_source = load_sources(files)
    offsets = estimate_offsets(by_source)
    spans = extract_spans(by_source, offsets)
    clamped = clamp_spans(spans)
    problems = check_invariants(spans)
    chrome = build_chrome_trace(
        spans, _phase_segments(by_source, offsets), offsets
    )
    return {
        "files": files,
        "sources": sorted(by_source),
        "offsets": offsets,
        "spans": spans,
        "clamped": clamped,
        "invariant_problems": problems,
        "chrome": chrome,
    }


#: Serving waterfall order (request-level tracing, docs/observability.md
#: "Request tracing & exemplars"): the client's send span roots the
#: trace, the replica's rpc.predict nests under it, phases nest below.
SERVING_SPAN_ORDER = (
    "client.predict", "rpc.predict", "serve.queue", "serve.batch",
    "serve.execute", "serve.respond",
)


def request_chain(spans: List[dict], trace_id: str) -> List[dict]:
    """The ordered serving waterfall for ONE traced request: client send
    (when the loadgen journal is merged in) -> rpc.predict ->
    serve.queue -> shared serve.batch -> serve.execute -> serve.respond.

    The shared batch span is journaled ONCE per batch and carries no
    trace id (it belongs to every member request equally); member spans
    point at it through their ``batch_span_id`` arg, so the hop is
    resolved here by id rather than by trace membership.  Returns []
    for an unknown trace id."""
    members = [s for s in spans if s["trace_id"] == trace_id]
    if not members:
        return []
    by_id = {s["span_id"]: s for s in spans}
    chain = list(members)
    linked = {s["span_id"] for s in members}
    for span in members:
        batch_id = span.get("args", {}).get("batch_span_id", "")
        if batch_id and batch_id not in linked:
            batch = by_id.get(batch_id)
            if batch is not None:
                chain.append(batch)
                linked.add(batch_id)
    rank = {name: i for i, name in enumerate(SERVING_SPAN_ORDER)}
    chain.sort(key=lambda s: (rank.get(s["name"], len(rank)), s["start"]))
    return chain


def span_children(spans: List[dict]) -> Dict[str, List[dict]]:
    children: Dict[str, List[dict]] = {}
    for span in spans:
        if span["parent_span_id"]:
            children.setdefault(span["parent_span_id"], []).append(span)
    for kids in children.values():
        kids.sort(key=lambda s: s["start"])
    return children


def render_waterfall(
    spans: List[dict], top: int = 10, width: int = 72
) -> str:
    """The terminal fallback: one indented tree per task trace (slowest
    roots first), with per-span offset/duration columns."""
    by_id = {span["span_id"]: span for span in spans}
    children = span_children(spans)
    roots = [
        span
        for span in spans
        if not span["parent_span_id"] or span["parent_span_id"] not in by_id
    ]
    roots.sort(key=lambda s: s["start"] - s["end"])  # longest first
    lines: List[str] = []
    shown = roots[:top]
    if not spans:
        return "no spans found (is the tracing plane enabled on this job?)"
    lines.append(
        f"{len(spans)} span(s), {len(roots)} root(s); showing the "
        f"{len(shown)} longest root chain(s):"
    )

    def walk(span: dict, t_root: float, depth: int):
        duration_ms = (span["end"] - span["start"]) * 1e3
        offset_ms = (span["start"] - t_root) * 1e3
        label = f"{'  ' * depth}{span['name']}"
        extra = ""
        if span["args"].get("error"):
            extra += f" error={span['args']['error']}"
        if span.get("clamped"):
            extra += " [clamped]"
        lines.append(
            f"  +{offset_ms:9.1f}ms {duration_ms:9.1f}ms  "
            f"{label:<{width - 36}.{width - 36}} ({span['proc']}){extra}"
        )
        for child in children.get(span["span_id"], ()):
            walk(child, t_root, depth + 1)

    for root in shown:
        header = root["trace_id"] or root["span_id"]
        lines.append("")
        lines.append(f"trace {header}:")
        walk(root, root["start"], 0)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Selftest: synthetic skewed journals -> assembled invariants
# ---------------------------------------------------------------------------


def _selftest() -> int:
    """Generate a master + two skewed worker journals, assemble, and
    gate the pipeline's invariants:
    - the midpoint estimator recovers the injected offsets;
    - the dispatch -> rpc -> execute -> report chain reconstructs;
    - the serving waterfall (client.predict -> rpc.predict -> queue ->
      shared serve.batch -> execute -> respond) reconstructs for every
      member of a batch, with ONE shared batch span between them;
    - zero negative durations / child-escaping-parent spans survive;
    - the Chrome trace schema-validates."""
    import tempfile

    SKEWS = {0: 37.5, 1: -12.25}  # worker wall clocks vs the master's
    T0 = 1_754_000_000.0
    trace_id = "t-self.0-1"

    def master_journal() -> List[str]:
        events = [
            {"ts": T0, "event": "master_start", "job_name": "selftest"},
            {"ts": T0 + 0.01, "event": "task_dispatch", "task_id": 1,
             "worker_id": 0, "trace_id": trace_id},
            {"ts": T0 + 0.012, "event": "span", "name": "rpc.get_task",
             "start_ts": T0 + 0.005, "duration_s": 0.006,
             "span_id": "s-m-1", "parent_span_id": "s-w0-1",
             "trace_id": trace_id, "proc": "master"},
            {"ts": T0 + 9.01, "event": "span",
             "name": "rpc.report_task_result", "start_ts": T0 + 9.0,
             "duration_s": 0.01, "span_id": "s-m-2",
             "parent_span_id": "s-w0-9", "trace_id": trace_id,
             "proc": "master"},
            {"ts": T0 + 9.02, "event": "task_done", "task_id": 1,
             "trace_id": trace_id},
            {"ts": T0 + 9.02, "event": "span", "name": "task.lifetime",
             "start_ts": T0 + 0.005, "duration_s": 9.005,
             "span_id": trace_id, "trace_id": trace_id, "proc": "master"},
            {"ts": T0 + 9.5, "event": "phase_transition",
             "from": "training", "to": "idle", "seconds": 9.0},
        ]
        # Serving request traces: two member requests of ONE batch —
        # the shared serve.batch span is journaled once (no trace_id)
        # and both members hop to it via batch_span_id.
        S0 = T0 + 20.0
        for i, rtrace in enumerate(("lg-req-1", "lg-req-2")):
            enq = S0 + 0.001 * i
            events.extend([
                {"ts": S0 + 0.1, "event": "span", "name": "client.predict",
                 "start_ts": enq - 0.001, "duration_s": 0.055,
                 "span_id": rtrace, "trace_id": rtrace, "proc": "loadgen"},
                {"ts": S0 + 0.1, "event": "span", "name": "rpc.predict",
                 "start_ts": enq - 0.0005, "duration_s": 0.052,
                 "span_id": f"s-rpc-{i}", "parent_span_id": rtrace,
                 "trace_id": rtrace, "proc": "replica_0", "rows": 4,
                 "outcome": "served", "batch_span_id": "s-batch-1"},
                {"ts": S0 + 0.1, "event": "span", "name": "serve.queue",
                 "start_ts": enq, "duration_s": 0.04,
                 "trace_id": rtrace, "span_id": f"s-q-{i}",
                 "parent_span_id": f"s-rpc-{i}", "proc": "replica_0"},
                {"ts": S0 + 0.1, "event": "span", "name": "serve.execute",
                 "start_ts": enq + 0.042, "duration_s": 0.008,
                 "trace_id": rtrace, "span_id": f"s-x-{i}",
                 "parent_span_id": "s-batch-1",
                 "batch_span_id": "s-batch-1", "proc": "replica_0"},
                {"ts": S0 + 0.1, "event": "span", "name": "serve.respond",
                 "start_ts": enq + 0.050, "duration_s": 0.001,
                 "trace_id": rtrace, "span_id": f"s-r-{i}",
                 "parent_span_id": f"s-rpc-{i}", "proc": "replica_0"},
            ])
        events.append(
            {"ts": S0 + 0.1, "event": "span", "name": "serve.batch",
             "start_ts": S0 + 0.0405, "duration_s": 0.011,
             "span_id": "s-batch-1", "proc": "replica_0",
             "batch_rows": 8, "bucket": 8, "generation": 1,
             "requests": 2})
        # Telemetry ingests pairing with each worker's probes: the
        # master stamp lands mid-round-trip (symmetric 20ms legs).
        for wid, skew in SKEWS.items():
            for k in range(3):
                worker_stamp = round(T0 + skew + 1.0 + k, 3)
                events.append(
                    {"ts": worker_stamp - skew + 0.02,
                     "event": "worker_telemetry", "worker_id": wid,
                     "worker_ts": worker_stamp}
                )
        return [json.dumps(e) for e in sorted(events, key=lambda e: e["ts"])]

    def worker_journal(wid: int) -> List[str]:
        skew = SKEWS[wid]
        events = []
        for k in range(3):
            stamp = round(T0 + skew + 1.0 + k, 3)
            events.append(
                {"ts": stamp + 0.04, "event": "clock_probe",
                 "worker_id": wid, "probe_ts": stamp, "t_send": stamp,
                 "t_recv": stamp + 0.04, "rtt_s": 0.04}
            )
        if wid == 0:
            base = T0 + skew  # worker-0 clock
            events.extend(
                [
                    {"ts": base + 0.011, "event": "span",
                     "name": "worker.get_task", "start_ts": base + 0.004,
                     "duration_s": 0.007, "span_id": "s-w0-1",
                     "parent_span_id": trace_id, "trace_id": trace_id,
                     "proc": "worker_0"},
                    {"ts": base + 8.9, "event": "span",
                     "name": "worker.task", "start_ts": base + 0.012,
                     "duration_s": 8.888, "span_id": "s-w0-2",
                     "parent_span_id": trace_id, "trace_id": trace_id,
                     "proc": "worker_0", "task_id": 1},
                    {"ts": base + 8.9, "event": "span",
                     "name": "step.data_wait", "start_ts": base + 0.02,
                     "duration_s": 2.0, "span_id": "s-w0-3",
                     "parent_span_id": "s-w0-2", "trace_id": trace_id,
                     "proc": "worker_0"},
                    {"ts": base + 8.9, "event": "span",
                     "name": "step.execute", "start_ts": base + 2.02,
                     "duration_s": 6.8, "span_id": "s-w0-4",
                     "parent_span_id": "s-w0-2", "trace_id": trace_id,
                     "proc": "worker_0"},
                    {"ts": base + 9.06, "event": "span",
                     "name": "worker.report_task",
                     # Deliberately 5ms before the parent root's start
                     # once aligned: the clamp must absorb it.
                     "start_ts": base + 0.0,
                     "duration_s": 9.01, "span_id": "s-w0-9",
                     "parent_span_id": trace_id, "trace_id": trace_id,
                     "proc": "worker_0", "task_id": 1},
                ]
            )
        return [json.dumps(e) for e in events]

    with tempfile.TemporaryDirectory(prefix="trace_selftest_") as tmp:
        with open(os.path.join(tmp, "events.jsonl"), "w") as f:
            f.write("\n".join(master_journal()) + "\n")
        for wid in SKEWS:
            path = os.path.join(tmp, f"events_worker_{wid}.jsonl")
            with open(path, "w") as f:
                f.write("\n".join(worker_journal(wid)) + "\n")
        result = assemble([tmp])

    failures = []
    for wid, skew in SKEWS.items():
        info = result["offsets"].get(f"worker_{wid}")
        if info is None:
            failures.append(f"no offset estimated for worker_{wid}")
            continue
        if info["method"] != "midpoint" or info["pairs"] != 3:
            failures.append(
                f"worker_{wid}: expected midpoint over 3 pairs, got {info}"
            )
        # Recovered offset maps worker clock -> master clock: -skew,
        # within the rtt/2 (20ms) error bound.
        if abs(info["offset_s"] - (-skew)) > 0.021:
            failures.append(
                f"worker_{wid}: offset {info['offset_s']} not within "
                f"rtt/2 of {-skew}"
            )
    if result["invariant_problems"]:
        failures.extend(result["invariant_problems"])
    if result["clamped"] == 0:
        failures.append(
            "expected the seeded child-escapes-parent span to be clamped"
        )
    schema_problems = validate_chrome_trace(result["chrome"])
    if schema_problems:
        failures.extend(schema_problems)
    by_id = {span["span_id"]: span for span in result["spans"]}
    chain = ["s-w0-1", "s-m-1", "s-w0-2", "s-w0-3", "s-w0-4", "s-w0-9",
             "s-m-2", trace_id]
    missing = [span_id for span_id in chain if span_id not in by_id]
    if missing:
        failures.append(f"chain spans missing from assembly: {missing}")
    else:
        root = by_id[trace_id]
        for span_id in chain[:-1]:
            span = by_id[span_id]
            if not (
                root["start"] - 1e-9 <= span["start"]
                and span["end"] <= root["end"] + 1e-9
            ):
                failures.append(
                    f"{span_id} [{span['start']:.3f}, {span['end']:.3f}] "
                    f"outside aligned root "
                    f"[{root['start']:.3f}, {root['end']:.3f}]"
                )
    for rtrace in ("lg-req-1", "lg-req-2"):
        names = [s["name"] for s in request_chain(result["spans"], rtrace)]
        if names != list(SERVING_SPAN_ORDER):
            failures.append(
                f"serving waterfall for {rtrace}: {names} != "
                f"{list(SERVING_SPAN_ORDER)}"
            )
    batch_ids = {
        s["span_id"] for s in result["spans"] if s["name"] == "serve.batch"
    }
    if batch_ids != {"s-batch-1"}:
        failures.append(f"expected ONE shared batch span, got {batch_ids}")
    if "replica_0" not in {s["proc"] for s in result["spans"]}:
        failures.append("replica_0 proc row missing from assembled spans")
    render_waterfall(result["spans"])  # must not raise
    if failures:
        print("trace selftest FAILED:", file=sys.stderr)
        for failure in failures:
            print(f"  {failure}", file=sys.stderr)
        return 1
    print(
        f"trace selftest OK ({len(result['spans'])} spans, "
        f"{len(result['chrome']['traceEvents'])} trace events, "
        f"offsets recovered for {len(SKEWS)} skewed workers, "
        f"{result['clamped']} clamped)"
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.obs.trace",
        description="Merge master + worker event journals into an "
        "aligned distributed trace (Chrome trace-event JSON for "
        "Perfetto, or a terminal waterfall).",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="journal files, or a log directory holding events.jsonl + "
        "events_worker_*.jsonl",
    )
    parser.add_argument(
        "-o", "--output", default="",
        help="write Chrome trace-event JSON here ('-' = stdout); "
        "omit for the text waterfall",
    )
    parser.add_argument(
        "--top", type=int, default=10,
        help="root chains to show in the text waterfall",
    )
    parser.add_argument(
        "--selftest", action="store_true",
        help="assemble synthetic skewed journals and gate the "
        "alignment/clamping/schema invariants",
    )
    args = parser.parse_args(argv)
    if args.selftest:
        return _selftest()
    if not args.paths:
        parser.print_usage(sys.stderr)
        return 2
    result = assemble(args.paths)
    if not result["files"]:
        print("no journal files found", file=sys.stderr)
        return 2
    for label, info in sorted(result["offsets"].items()):
        if label == MASTER_SOURCE:
            continue
        print(
            f"clock offset {label}: {info['offset_s']:+.6f}s "
            f"({info['method']}, {info['pairs']} round-trip(s))",
            file=sys.stderr,
        )
    if result["invariant_problems"]:
        # Clamping should make this unreachable; if it ever fires, the
        # trace is still written — a distorted view beats none — but the
        # exit code says so.
        for problem in result["invariant_problems"]:
            print(f"invariant: {problem}", file=sys.stderr)
    if args.output:
        payload = json.dumps(result["chrome"])
        if args.output == "-":
            print(payload)
        else:
            with open(args.output, "w", encoding="utf-8") as f:
                f.write(payload)
            print(
                f"wrote {args.output}: "
                f"{len(result['chrome']['traceEvents'])} events from "
                f"{len(result['spans'])} spans "
                f"({result['clamped']} clamped) — load it at "
                "https://ui.perfetto.dev",
                file=sys.stderr,
            )
    else:
        print(render_waterfall(result["spans"], top=args.top))
    return 1 if result["invariant_problems"] else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(0)
