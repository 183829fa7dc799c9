"""Deterministic fault injection for resilience testing: the port's copy
of ``elasticdl_tpu/common/faults.py``.

- **call-count triggered**: a fault fires on the Nth..(N+count-1)th call
  of its site, never on wall clock and never on randomness, so a failing
  run replays exactly;
- **off by default and zero-cost when disabled**: ``fire()`` is a single
  module-attribute ``None`` check until ``install()`` or
  ``ELASTICDL_FAULTS`` arms the registry.

Injection sites wired into the port:

    serving.execute      every batcher dispatch (serving/batcher.py;
                         kinds: latency[=seconds] stalls the batcher
                         thread, error[=msg] fails the batch)
    serving.delta_apply  every ServingReplica.build_delta_generation
                         (kind: error[=msg]: the apply fails and rolls
                         back to the previous generation)
    ckpt.write           every CheckpointSaver state-file write
                         (checkpoint/saver.py; kind: truncate[=keep_bytes]:
                         a torn write, after the manifest recorded the
                         whole file's CRC)
    ckpt.delta           every DeltaExporter.publish_delta (kind:
                         truncate[=keep_bytes]: tears the largest delta
                         file after the manifest recorded its CRC)
    rpc.<method>         every attempt of a master call (common/retry.py;
                         kinds: error[=CODE] fails the attempt with that
                         status code, latency[=seconds] delays it)
    worker.task          every task a cluster worker starts
                         (worker/collective_worker.py; kind:
                         crash[=exit code] kills the process at once)
    stream.source        every SyntheticClickStream.advance
                         (data/stream.py; kind: latency[=seconds]: a
                         wedged upstream pipe stalls production for that
                         much VIRTUAL time; ``@t`` specs are applied by
                         the driver through ``due()`` + ``stream.stall``)
    stream.labels        every delayed-label range fetch
                         (data/stream.feedback_labels; kinds: truncate,
                         a label-feed outage that returns no labels for
                         the range; error, a poisoned feed with every
                         label flipped)
    quality.label_join   every label delivery into the quality ledger
                         (obs/quality.py; kinds: error, the label is
                         dropped; truncate, delivered twice, the
                         at-least-once feed's duplicate)
    quality.shadow_eval  every canary-gate shadow evaluation (kind:
                         error[=msg]: the evaluation blows up and the
                         gate degrades to quality unknown)

Spec grammar (comma/semicolon separated, via ``ELASTICDL_FAULTS`` or
``install()``), the JAX package's:

    site:kind[=arg][@after|@tSECONDS][xcount]

    serving.delta_apply:error=injected@2   the 2nd apply fails
    serving.execute:latency=0.25@1x3       dispatches 1-3 stall 0.25 s
    ckpt.delta:truncate@2                  the 2nd delta publish torn

``after`` is 1-based (default 1); ``count`` is how many consecutive calls
trigger (default 1, ``x*`` = every call from ``after`` on).

**Schedule-based triggers** (``@t<seconds>``): the spec fires once, at a
relative time on a timeline the *caller* owns; this module never reads
a clock.  A driver polls ``due(site, elapsed_s)`` with its own elapsed
seconds and applies every newly due spec; ``remaining_due(site)`` says
when the schedule is spent.  Time specs never trigger through ``fire()``
and never combine with ``xcount``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ENV_VAR = "ELASTICDL_FAULTS"

KINDS = ("error", "latency", "truncate", "crash")


@dataclass
class FaultSpec:
    site: str
    kind: str
    arg: str = ""
    after: int = 1  # first triggering call, 1-based
    count: int = 1  # number of consecutive triggering calls; -1 = forever
    at_s: Optional[float] = None  # schedule trigger: relative seconds

    def triggers_at(self, call_number: int) -> bool:
        if self.at_s is not None:
            return False  # schedule specs fire through due(), not fire()
        if call_number < self.after:
            return False
        return self.count < 0 or call_number < self.after + self.count


@dataclass
class _Registry:
    specs: List[FaultSpec] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    fired_schedule: set = field(default_factory=set)  # spec indices
    lock: threading.Lock = field(default_factory=threading.Lock)


# None = disabled; fire() bails on one attribute load, so armed-off cost
# is zero on hot paths (per dispatch, per publish).
_registry: Optional[_Registry] = None


def parse_specs(text: str) -> List[FaultSpec]:
    specs = []
    for token in text.replace(";", ",").split(","):
        token = token.strip()
        if not token:
            continue
        try:
            site, rest = token.split(":", 1)
            count = 1
            explicit_count = False
            if "x" in rest.rsplit("@", 1)[-1]:
                rest, count_text = rest.rsplit("x", 1)
                count = -1 if count_text == "*" else int(count_text)
                explicit_count = True
            after = 1
            at_s = None
            if "@" in rest:
                rest, after_text = rest.rsplit("@", 1)
                if after_text.startswith("t"):
                    at_s = float(after_text[1:])
                else:
                    after = int(after_text)
            kind, _, arg = rest.partition("=")
        except ValueError as exc:
            raise ValueError(f"Unparseable fault spec {token!r}") from exc
        if kind not in KINDS:
            raise ValueError(
                f"Unknown fault kind {kind!r} in {token!r} (know {KINDS})"
            )
        if after < 1 or (count < 1 and count != -1):
            raise ValueError(f"Bad @after/xcount in fault spec {token!r}")
        if at_s is not None and (at_s < 0 or explicit_count):
            raise ValueError(
                f"Bad schedule trigger in fault spec {token!r}: @t needs "
                "seconds >= 0 and fires exactly once (no xcount — list "
                "one spec per firing)"
            )
        specs.append(
            FaultSpec(
                site=site, kind=kind, arg=arg, after=after, count=count,
                at_s=at_s,
            )
        )
    return specs


def install(specs) -> None:
    """Arm the registry with FaultSpecs (or a spec string)."""
    global _registry
    if isinstance(specs, str):
        specs = parse_specs(specs)
    _registry = _Registry(specs=list(specs))


def install_from_env(environ=os.environ) -> bool:
    """Arm from ELASTICDL_FAULTS if set; True when faults were armed.
    Called at replica process start, so a test arms a subprocess
    through its environment."""
    text = environ.get(ENV_VAR, "")
    if not text:
        return False
    install(text)
    return bool(_registry.specs)


def clear() -> None:
    global _registry
    _registry = None


def call_count(site: str) -> int:
    if _registry is None:
        return 0
    with _registry.lock:
        return _registry.counters.get(site, 0)


def fire(site: str) -> Optional[FaultSpec]:
    """Count one call of `site`; return the FaultSpec to apply, if any.

    The caller applies the fault (raise / sleep / truncate / exit) — this
    module never touches the network or filesystem itself, so sites stay
    import-light and the mapping fault->behavior lives next to the code
    it perturbs.
    """
    registry = _registry
    if registry is None:
        return None
    with registry.lock:
        registry.counters[site] = n = registry.counters.get(site, 0) + 1
        for spec in registry.specs:
            if spec.site == site and spec.triggers_at(n):
                return spec
    return None


def due(site: str, elapsed_s: float) -> List[FaultSpec]:
    """The ``@t<seconds>`` specs of ``site`` whose time has come at
    ``elapsed_s``, seconds on the caller's timeline.  Each spec is
    returned exactly once, however often a driver polls."""
    registry = _registry
    if registry is None:
        return []
    hits: List[FaultSpec] = []
    with registry.lock:
        for index, spec in enumerate(registry.specs):
            if spec.site != site or spec.at_s is None:
                continue
            if spec.at_s <= elapsed_s and index not in registry.fired_schedule:
                registry.fired_schedule.add(index)
                hits.append(spec)
    hits.sort(key=lambda spec: spec.at_s)
    return hits


def remaining_due(site: str) -> int:
    """How many of ``site``'s schedule-based specs have not fired yet."""
    registry = _registry
    if registry is None:
        return 0
    with registry.lock:
        return sum(1 for index, spec in enumerate(registry.specs)
                   if spec.site == site and spec.at_s is not None
                   and index not in registry.fired_schedule)


def crash_now(spec: FaultSpec) -> None:
    """Apply a ``crash`` fault: immediate process death (no atexit, no
    flush), which the pod manager cannot tell from a SIGKILL."""
    os._exit(int(spec.arg or 13))
