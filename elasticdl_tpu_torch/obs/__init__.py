"""Observability plane of the port: metrics registry, event journal and
spans, the port's copy of ``elasticdl_tpu/obs/__init__.py``.

The process-wide singletons live here; instrumented modules use the
module-level helpers:

    from elasticdl_tpu_torch import obs

    SHED = obs.counter("elasticdl_serving_shed_total", "...", labelnames=("reason",))
    SHED.inc(reason="queue_full")
    obs.journal().record("request_shed", reason="queue_full", rows=8)

Conventions (as the JAX package's): metric names
``elasticdl_<subsystem>_<what>_<unit?>``; labels are bounded enums only;
unbounded identifiers (replica ids, paths) ride the journal.

``REQUIRED_FIELDS`` is the journal's event schema as far as the port's
events go (the JAX package's ``scripts/validate_journal.py`` holds the
whole of it); ``missing_fields`` checks one record against it.

The planes beside this module: the goodput ledger (``obs/goodput.py``),
the step anatomy (``obs/stepstats.py``), the worker telemetry over the
master's heartbeat (``obs/telemetry.py``), the tracing plane
(``obs/tracing.py``, through which ``span`` journals), the SLO plane
(``obs/history.py``, ``obs/slo.py``), the model-quality plane
(``obs/quality.py``: the label-join ledger, the drift sketches, the
canary gate) and the offline tools over the journals (``obs/trace.py``,
``obs/report.py``, ``obs/top.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Tuple

from elasticdl_tpu_torch.obs.journal import DEFAULT_FILENAME, DEFAULT_MAX_BYTES, EventJournal
from elasticdl_tpu_torch.obs.metrics import (
    DURATION_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RateTracker,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RateTracker", "EventJournal",
    "DURATION_BUCKETS",
    "REQUIRED_FIELDS", "registry", "journal", "counter", "gauge", "histogram", "init_journal",
    "span", "missing_fields",
]

#: event -> the fields every record of it carries (the JAX schema's
#: required fields for the events the port writes).
REQUIRED_FIELDS = {
    "span": ("name", "duration_s", "start_ts", "span_id", "proc"),
    "model_swap": ("generation", "step"),
    "request_shed": ("reason",),
    "serving_telemetry": ("replica_id",),
    "serving_replica_start": ("replica_id", "port"),
    "freshness_slo": ("state", "lag_s", "slo_s"),
    "quality_gate": ("outcome", "step", "origin"),
    "quality_window": ("joined", "origin"),
    "quality_drift": ("state", "divergence", "origin"),
    # The elastic control plane: telemetry, stragglers, the goodput
    # ledger, the policy engine, the step anatomy, explicit resizes.
    "worker_telemetry": ("worker_id",),
    "straggler_detected": ("worker_id", "metric"),
    "straggler_cleared": ("worker_id",),
    "phase_transition": ("from", "to", "seconds"),
    "rescale_cost": ("cause", "total_s", "detection_s", "rendezvous_s", "redo_s"),
    "goodput_summary": ("goodput_ratio", "wall_s", "phases"),
    "policy_decision": ("action", "reason"),
    "step_anatomy": ("worker_id",),
    "scale": ("old_size", "new_size"),
    "scale_up": ("old_size", "new_size"),
    "clock_probe": ("worker_id", "probe_ts", "t_send", "t_recv"),
    # The tracing, SLO, profiler and checkpoint planes.
    "registry_snapshot": ("reason",),
    "request_trace": ("trace_id", "outcome", "sampled_by"),
    "slo_status": ("slo", "budget_remaining_ratio"),
    "slo_alert": ("slo", "state"),
    "profile_window": ("worker_id", "action", "trace_dir"),
    "checkpoint_saved": ("step", "kind"),
    "checkpoint_restored": ("step", "kind"),
    "delta_checkpoint": ("step", "base_step"),
    "delta_compaction": ("step",),
}

_registry = MetricsRegistry()
_journal = EventJournal()


def registry() -> MetricsRegistry:
    """The process-wide default registry (what the exporter serves)."""
    return _registry


def journal() -> EventJournal:
    """The process-wide default event journal."""
    return _journal


def counter(name, help="", labelnames=()) -> Counter:
    return _registry.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return _registry.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DURATION_BUCKETS) -> Histogram:
    return _registry.histogram(name, help, labelnames, buckets=buckets)


def init_journal(directory: str, filename: str = DEFAULT_FILENAME,
                 max_bytes: int = DEFAULT_MAX_BYTES) -> str:
    """Point the default journal at ``<directory>/<filename>`` (append
    mode, size-capped rotation).  Returns the journal path.  Never
    raises: an unusable directory degrades to the memory-only journal
    with a warning."""
    path = os.path.join(directory, filename)
    try:
        os.makedirs(directory, exist_ok=True)
    except OSError:
        from elasticdl_tpu_torch.obs.journal import logger

        logger.exception("Journal directory %s unusable; events stay memory-only", directory)
        return path
    _journal.configure(path, max_bytes)  # open failure degrades inside
    return path


def _span_metric_name(name: str) -> str:
    slug = name.replace(".", "_").replace("-", "_").replace("/", "_")
    return f"elasticdl_span_{slug}_seconds"


@contextlib.contextmanager
def span(name: str, labels=None, **fields):
    """Timer emitting a histogram observation
    (``elasticdl_span_<name>_seconds``, bounded ``labels`` only) and,
    through the tracing plane (``obs/tracing.py``), a journal ``span``
    record with span, parent and trace ids; ``fields`` (unbounded ids
    welcome, ``trace_id`` among them) ride the journal record only.
    Yields the open ``tracing.Span``."""
    from elasticdl_tpu_torch.obs import tracing

    labels = dict(labels or {})
    hist = _registry.histogram(_span_metric_name(name), f"Duration of {name} spans",
                               labelnames=tuple(sorted(labels)))
    trace_id = fields.pop("trace_id", "")
    start = time.monotonic()
    try:
        with tracing.tracer().span(name, trace_id=trace_id, **{**labels, **fields}) as open_span:
            yield open_span
    finally:
        hist.observe(time.monotonic() - start, **labels)


def missing_fields(record: dict) -> Tuple[str, ...]:
    """The required fields ``record`` lacks (empty for an event outside
    ``REQUIRED_FIELDS``)."""
    return tuple(f for f in REQUIRED_FIELDS.get(record.get("event"), ()) if f not in record)
