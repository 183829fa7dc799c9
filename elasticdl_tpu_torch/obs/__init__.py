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
the step anatomy (``obs/stepstats.py``) and the worker telemetry over the
master's heartbeat (``obs/telemetry.py``).  Not ported yet (ROADMAP.md
Queue 1 item 8): the tracing plane (span and trace ids, exemplars), the
SLO plane, the offline report.
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
    "span": ("name", "duration_s"),
    "model_swap": ("generation", "step"),
    "request_shed": ("reason",),
    "serving_telemetry": ("replica_id",),
    "serving_replica_start": ("replica_id", "port"),
    "freshness_slo": ("state", "lag_s", "slo_s"),
    "quality_gate": ("outcome", "step", "origin"),
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
    (``elasticdl_span_<name>_seconds``, bounded ``labels`` only) and a
    journal ``span`` record with the wall start and the duration;
    ``fields`` (unbounded ids welcome) ride the journal record only."""
    labels = dict(labels or {})
    hist = _registry.histogram(_span_metric_name(name), f"Duration of {name} spans",
                               labelnames=tuple(sorted(labels)))
    start_ts = time.time()
    start = time.monotonic()
    try:
        yield
    finally:
        duration = time.monotonic() - start
        hist.observe(duration, **labels)
        _journal.record("span", name=name, start_ts=round(start_ts, 6),
                        duration_s=round(duration, 6), **{**labels, **fields})


def missing_fields(record: dict) -> Tuple[str, ...]:
    """The required fields ``record`` lacks (empty for an event outside
    ``REQUIRED_FIELDS``)."""
    return tuple(f for f in REQUIRED_FIELDS.get(record.get("event"), ()) if f not in record)
