"""Distributed tracing plane: span trees over the event journal, the
port's copy of ``elasticdl_tpu/obs/tracing.py`` (``Tracer`` :90, the
flight recorder :356-415).

Spans journal as ``span`` events in each process's own journal (the
master's ``events.jsonl``, each worker's ``events_worker_<id>.jsonl``,
a replica fleet's shared serve-dir journal), and ``python -m
elasticdl_tpu_torch.obs.trace`` merges the files, aligns the clocks and
writes a Chrome trace.

- A ``Span`` is one timed operation: ``name``, ``trace_id`` (the
  dispatch-minted task trace id, or empty), ``span_id``,
  ``parent_span_id``, a wall-clock ``start_ts`` and a monotonic
  duration.  Unbounded ids ride the journal record, never metric labels.
- ``Tracer.span()`` is a context manager; a ``contextvars.ContextVar``
  carries the current span, so nested calls parent under it and each
  thread sees its own ancestry.
- The root span of a task trace has ``span_id == trace_id``: any
  process that knows the trace id parents under the root without
  coordination (the master journals ``task.lifetime`` at report time).
- Across processes the trace and span ids ride the HTTP headers
  ``elasticdl-trace-id`` and ``elasticdl-span-id``
  (``common/http_rpc.py``), the names of the JAX package's gRPC
  metadata keys.
- ``record_span`` journals a span measured after the fact;
  ``record_window_spans`` lays one dispatch window's step-anatomy phases
  out as child spans of the current span.

``start_ts`` is wall clock (the assembler aligns processes on it);
durations come from ``time.monotonic``.  ``install_flight_recorder()``
registers an atexit flush (SIGTERM reaches it through the worker's
SIGTERM -> SystemExit conversion) of every open span (``flushed=
"shutdown"``) and a bounded ``registry_snapshot`` event.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import itertools
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("obs.tracing")

#: Tracer instances in one process must mint non-colliding span ids even
#: when tests rebuild them (same rule as the TaskManager trace prefix).
_TRACER_SEQ = itertools.count()

#: Ordered step-anatomy phases a dispatch window decomposes into
#: (mirrors stepstats.PHASES; imported lazily there to avoid a cycle).
_WINDOW_PHASES = ("data_wait", "stage", "compile", "execute", "bookkeep")

#: Size bound on the flight recorder's final registry snapshot: the
#: journal is size-capped, and a pathological registry must not spend
#: the whole budget on one exit record.
MAX_REGISTRY_SNAPSHOT_BYTES = 32 << 10


@dataclass
class Span:
    """One open (or closed) span.  Mutable fields accumulate while the
    context manager is open; closing journals the record."""

    name: str
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    start_ts: float = 0.0
    start_monotonic: float = 0.0
    fields: dict = field(default_factory=dict)


class Tracer:
    """Process-wide span factory + context carrier.

    One instance per process (module-level ``tracer()``); tests may
    build their own with an injected journal.  The current span lives
    in a ``ContextVar`` — each thread (and each ``contextvars`` context)
    sees its own ancestry, so the master's gRPC handler threads and the
    worker's task loop never cross-parent.
    """

    def __init__(self, journal=None, proc: str = ""):
        self._lock = make_lock("Tracer._lock")
        self._journal = journal
        # Pid + random salt + in-process seq: the pid alone is NOT a
        # process-unique discriminator on the k8s substrate (every pod's
        # main process is PID 1), and colliding span ids would cross-link
        # different workers' subtrees in the assembled trace.  The salt
        # is identity, not schedule — the determinism-replay rule (seeded
        # schedules) is untouched.
        self._prefix = (
            f"{os.getpid():x}{os.urandom(3).hex()}.{next(_TRACER_SEQ)}"
        )
        self._seq = itertools.count(1)
        self._proc = proc or f"pid-{os.getpid()}"
        self._current: contextvars.ContextVar = contextvars.ContextVar(
            f"elasticdl_span_{self._prefix}", default=None
        )
        # Open spans, for the crash flight recorder.  Keyed by span_id.
        self._open: Dict[str, Span] = {}  # guarded-by: _lock

    # -- identity -------------------------------------------------------

    @property
    def proc(self) -> str:
        return self._proc

    def set_process(self, label: str) -> None:
        """Name this process on the assembled trace (``master``,
        ``worker_3``); defaults to ``pid-<n>``."""
        if label:
            self._proc = str(label)

    def mint_span_id(self) -> str:
        """A fresh process-unique span id (callers that must send the id
        over the wire BEFORE the span's outcome is known — e.g. the
        get_task client span, whose trace id arrives in the response)."""
        return f"s-{self._prefix}-{next(self._seq)}"

    # -- context --------------------------------------------------------

    def current(self) -> Optional[Span]:
        return self._current.get()

    def current_span_id(self) -> str:
        span = self._current.get()
        return span.span_id if span is not None else ""

    def current_trace_id(self) -> str:
        span = self._current.get()
        return span.trace_id if span is not None else ""

    # -- span emission --------------------------------------------------

    def _journal_ref(self):
        if self._journal is not None:
            return self._journal
        from elasticdl_tpu_torch import obs  # lazy: obs/__init__ imports us

        return obs.journal()

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        trace_id: str = "",
        parent_id: Optional[str] = None,
        root: bool = False,
        span_id: str = "",
        **fields,
    ):
        """Open a span; yields the ``Span`` (callers read ``span_id`` to
        propagate it over RPC metadata).  ``trace_id`` and parentage
        inherit from the enclosing span when not given; ``root=True``
        with a trace id makes this THE root span (span_id == trace_id,
        the cross-process parenting convention)."""
        parent = self._current.get()
        if not trace_id and parent is not None:
            trace_id = parent.trace_id
        if parent_id is None:
            parent_id = parent.span_id if parent is not None else ""
        if root and trace_id:
            span_id = trace_id
        if not parent_id and trace_id and span_id != trace_id:
            # Contextless span of a known trace: hang it off the trace
            # root (span_id == trace_id by convention) — the worker's
            # top-level task span has no enclosing span but is still a
            # child of the master's task.lifetime.
            parent_id = trace_id
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=span_id or self.mint_span_id(),
            parent_span_id=parent_id,
            start_ts=time.time(),
            start_monotonic=time.monotonic(),
            fields=dict(fields),
        )
        with self._lock:
            self._open[span.span_id] = span
        token = self._current.set(span)
        error = None
        try:
            yield span
        except BaseException as exc:
            error = type(exc).__name__
            raise
        finally:
            self._current.reset(token)
            duration_s = max(0.0, time.monotonic() - span.start_monotonic)
            with self._lock:
                self._open.pop(span.span_id, None)
            if error is not None:
                span.fields.setdefault("error", error)
            self._emit(span, duration_s)

    def record_span(
        self,
        name: str,
        start_ts: float,
        duration_s: float,
        trace_id: str = "",
        parent_id: str = "",
        span_id: str = "",
        root: bool = False,
        **fields,
    ) -> dict:
        """Journal an after-the-fact span (start/duration measured by the
        caller — task lifetimes, rendezvous formation, phase windows).
        Does not touch the context; returns the journal record."""
        if root and trace_id:
            span_id = trace_id
        if not parent_id and trace_id and not root and span_id != trace_id:
            parent_id = trace_id  # same root convention as span()
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=span_id or self.mint_span_id(),
            parent_span_id=parent_id,
            start_ts=start_ts,
            fields=dict(fields),
        )
        return self._emit(span, max(0.0, duration_s))

    def _emit(self, span: Span, duration_s: float) -> dict:
        record = {
            "name": span.name,
            "duration_s": round(duration_s, 6),
            "start_ts": round(span.start_ts, 6),
            "span_id": span.span_id,
            "proc": self._proc,
        }
        if span.trace_id:
            record["trace_id"] = span.trace_id
        if span.parent_span_id:
            record["parent_span_id"] = span.parent_span_id
        record.update(span.fields)
        return self._journal_ref().record("span", **record)

    def record_window_spans(
        self, window: dict, end_ts: Optional[float] = None
    ) -> int:
        """Journal the step-anatomy phases of one sealed dispatch window
        as child spans of the CURRENT span (no-op outside a span — phase
        detail without a task context has no tree to hang from).

        The anatomy keeps exclusive per-phase totals, not raw intervals
        (a window can cover hundreds of batches; per-interval spans
        would swamp the journal), so the phases lay out sequentially in
        canonical order ending at ``end_ts`` — a faithful AGGREGATE
        waterfall: phases are exclusive by contract, so their sum is the
        window's accounted wall time.  Returns the number of spans."""
        parent = self._current.get()
        if parent is None or not isinstance(window, dict):
            return 0
        end = time.time() if end_ts is None else float(end_ts)
        phase_seconds = [
            (phase, float(window[phase]))
            for phase in _WINDOW_PHASES
            if isinstance(window.get(phase), (int, float))
            and window[phase] > 0
        ]
        cursor = end - sum(seconds for _, seconds in phase_seconds)
        emitted = 0
        for phase, seconds in phase_seconds:
            self.record_span(
                f"step.{phase}",
                start_ts=cursor,
                duration_s=seconds,
                trace_id=parent.trace_id,
                parent_id=parent.span_id,
                steps=window.get("steps"),
            )
            cursor += seconds
            emitted += 1
        return emitted

    # -- crash flight recorder -----------------------------------------

    def open_spans(self) -> Dict[str, Span]:
        with self._lock:
            return dict(self._open)

    def flush_open(self, reason: str = "shutdown") -> int:
        """Journal every still-open span with its duration so far and a
        ``flushed`` marker — the trace tail a preempted worker leaves
        behind.  Idempotent per span (flushed spans are dropped from the
        open set; the normal close at unwind would re-journal, but
        SIGTERM->SystemExit unwinding and atexit never both complete)."""
        with self._lock:
            open_spans = list(self._open.values())
            self._open.clear()
        now = time.monotonic()
        for span in open_spans:
            span.fields.setdefault("flushed", reason)
            self._emit(
                span,
                max(0.0, now - span.start_monotonic)
                if span.start_monotonic
                else 0.0,
            )
        return len(open_spans)


_tracer = Tracer()


def tracer() -> Tracer:
    """The process-wide default tracer (what ``obs.span`` journals
    through)."""
    return _tracer


def span(name: str, **kwargs):
    """Module-level shorthand for ``tracer().span(...)``."""
    return _tracer.span(name, **kwargs)


def record_span(name: str, start_ts: float, duration_s: float, **kwargs):
    return _tracer.record_span(name, start_ts, duration_s, **kwargs)


def set_process(label: str) -> None:
    _tracer.set_process(label)


# ---------------------------------------------------------------------------
# Crash flight recorder
# ---------------------------------------------------------------------------

_flight_recorder_installed = False


def _registry_snapshot_record(reason: str) -> dict:
    """A bounded final-metrics record: the full registry dump when it
    fits, else a families-only summary (the journal's size cap must not
    be spent on one exit record)."""
    from elasticdl_tpu_torch import obs

    record = {"reason": reason, "proc": _tracer.proc}
    try:
        metrics = obs.registry().to_dict()
        payload = json.dumps(metrics, default=str)
        if len(payload.encode("utf-8")) <= MAX_REGISTRY_SNAPSHOT_BYTES:
            record["metrics"] = metrics
        else:
            record["metrics_truncated"] = True
            record["families"] = sorted(metrics)
    except Exception:  # never let the recorder break process exit
        record["metrics_error"] = True
    return record


def flush_flight_record(reason: str = "shutdown") -> int:
    """Flush open spans + a final registry snapshot to the journal.
    Safe to call directly from fatal-error handlers; the atexit hook
    calls it too (flush_open is idempotent, the snapshot is not —
    repeated snapshots are harmless, just redundant)."""
    from elasticdl_tpu_torch import obs

    flushed = _tracer.flush_open(reason)
    obs.journal().record(
        "registry_snapshot", **_registry_snapshot_record(reason)
    )
    return flushed


def install_flight_recorder() -> bool:
    """Register the atexit flush (once per process).  SIGTERM reaches it
    through the worker main's SIGTERM->SystemExit conversion; SIGKILL
    cannot be caught — the pod manager's grace period is the contract."""
    global _flight_recorder_installed
    if _flight_recorder_installed:
        return False
    _flight_recorder_installed = True
    atexit.register(_atexit_flush)
    return True


def _atexit_flush():
    try:
        flushed = flush_flight_record("shutdown")
        if flushed:
            logger.info(
                "Flight recorder flushed %d open span(s) at exit", flushed
            )
    except Exception:
        logger.exception("Flight-recorder flush failed at exit")
