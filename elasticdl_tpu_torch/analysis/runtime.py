"""Runtime lock-order race detector (opt-in: ``ELASTICDL_LOCKCHECK=1``):
the port's copy of ``elasticdl_tpu/analysis/runtime.py``.

The static lock-discipline rule proves mutations happen under the right
lock; it cannot see *ordering* across locks — the deadlock class where
thread A holds L1 wanting L2 while thread B holds L2 wanting L1.  This
module is the dynamic half: the port's services (master, obs planes,
serving) create their locks via `make_lock(name)`, which returns a plain
``threading.Lock`` in production (zero overhead) and an instrumented
`CheckedLock` when ``ELASTICDL_LOCKCHECK=1`` is set in the environment
at lock-creation time.

A `CheckedLock` records, per thread, the stack of checked locks held.
Every acquisition while other checked locks are held adds ordering
edges ``held -> acquired`` to a global order graph; an edge that closes
a cycle is a **lock-order inversion** and is recorded (with both
witness sites) in the global report.  Release measures hold time and
records holds longer than ``ELASTICDL_LOCKCHECK_HOLD_S`` (default 0.5s)
— a long hold on a control-plane lock stalls every request the
handler threads carry.

Detection is schedule-independent: the inversion is flagged from the
*order graph*, so a run that never actually interleaved into the
deadlock still reports the hazard.  ``tests/test_torch_lockcheck.py``
hammers the port's TaskManager under lockcheck and asserts a clean
report, and seeds a deliberate inversion to prove the detector fires.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("analysis.lockcheck")

ENV_VAR = "ELASTICDL_LOCKCHECK"
HOLD_ENV_VAR = "ELASTICDL_LOCKCHECK_HOLD_S"
DEFAULT_LONG_HOLD_S = 0.5


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") not in ("", "0", "false")


def long_hold_threshold_s() -> float:
    try:
        return float(os.environ.get(HOLD_ENV_VAR, DEFAULT_LONG_HOLD_S))
    except ValueError:
        return DEFAULT_LONG_HOLD_S


@dataclass(frozen=True)
class LockOrderInversion:
    """A cycle in the acquisition-order graph."""

    first: str   # lock acquired first on the new (violating) edge
    second: str  # lock acquired second
    witness: str         # where this edge was observed
    prior_witness: str   # where the opposite order was first observed

    def describe(self) -> str:
        return (
            f"lock-order inversion: {self.first} -> {self.second} "
            f"({self.witness}) vs established order {self.second} -> "
            f"{self.first} ({self.prior_witness})"
        )


@dataclass(frozen=True)
class LongHold:
    lock: str
    seconds: float
    thread: str


@dataclass
class _State:
    """Global detector state (guarded by a PLAIN lock — the meta-lock
    must never be a CheckedLock)."""

    meta: threading.Lock = field(default_factory=threading.Lock)
    # acquisition-order edges: held-lock name -> {acquired-lock names}
    edges: Dict[str, Set[str]] = field(default_factory=dict)
    # (held, acquired) -> first witness description
    edge_witness: Dict[Tuple[str, str], str] = field(default_factory=dict)
    inversions: List[LockOrderInversion] = field(default_factory=list)
    long_holds: List[LongHold] = field(default_factory=list)
    max_hold_s: Dict[str, float] = field(default_factory=dict)
    acquisitions: int = 0


_state = _State()
_tls = threading.local()


def _held_stack() -> List[Tuple[int, str, float]]:
    """Per-thread stack of (lock instance id, lock name, acquire time).
    Identity is the *instance* (two TaskManagers share a lock name but
    must not conflate); ordering discipline is keyed by *name* (every
    instance of a class obeys the same order)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _reachable(graph: Dict[str, Set[str]], src: str, dst: str) -> bool:
    """DFS: can `dst` be reached from `src` along order edges?"""
    seen = set()
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        frontier.extend(graph.get(node, ()))
    return False


class CheckedLock:
    """Drop-in ``threading.Lock`` replacement with order/hold tracking.

    Not reentrant (same as threading.Lock); a same-thread re-acquisition
    is recorded as a self-deadlock inversion *before* blocking, so the
    hang is attributable in the report even if the process then wedges.
    """

    def __init__(self, name: str):
        self._name = name
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._pre_acquire(blocking)
        acquired = self._lock.acquire(blocking, timeout)
        if acquired:
            _held_stack().append((id(self), self._name, time.monotonic()))
        return acquired

    def release(self):
        stack = _held_stack()
        for index in range(len(stack) - 1, -1, -1):
            if stack[index][0] == id(self):
                _, _, acquired_at = stack.pop(index)
                self._post_release(time.monotonic() - acquired_at)
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc_info):
        self.release()
        return False

    # -- instrumentation ------------------------------------------------

    def _pre_acquire(self, blocking: bool):
        stack = _held_stack()
        thread = threading.current_thread().name
        with _state.meta:
            _state.acquisitions += 1
            if blocking and any(key == id(self) for key, _, _ in stack):
                inversion = LockOrderInversion(
                    first=self._name,
                    second=self._name,
                    witness=f"thread {thread} re-acquired {self._name} "
                    "while holding it (self-deadlock)",
                    prior_witness="(same site)",
                )
                _state.inversions.append(inversion)
                logger.error(inversion.describe())
            for _key, held_name, _t in stack:
                if held_name == self._name:
                    # Same lock NAME on a different instance (e.g. two
                    # TaskManagers): no order discipline between peers.
                    continue
                edge = (held_name, self._name)
                if edge in _state.edge_witness:
                    continue
                witness = f"thread {thread}: held {held_name}, acquiring {self._name}"
                # Does the reverse order already exist?  Check BEFORE
                # inserting, so the self-edge of this insert can't mask it.
                if _reachable(_state.edges, self._name, held_name):
                    prior = _state.edge_witness.get(
                        (self._name, held_name),
                        "(transitive order through other locks)",
                    )
                    inversion = LockOrderInversion(
                        first=held_name,
                        second=self._name,
                        witness=witness,
                        prior_witness=prior,
                    )
                    _state.inversions.append(inversion)
                    logger.error(inversion.describe())
                _state.edges.setdefault(held_name, set()).add(self._name)
                _state.edge_witness[edge] = witness

    def _post_release(self, held_s: float):
        threshold = long_hold_threshold_s()
        with _state.meta:
            previous = _state.max_hold_s.get(self._name, 0.0)
            if held_s > previous:
                _state.max_hold_s[self._name] = held_s
            if held_s > threshold:
                hold = LongHold(
                    lock=self._name,
                    seconds=held_s,
                    thread=threading.current_thread().name,
                )
                _state.long_holds.append(hold)
                logger.warning(
                    "lock %s held %.3fs (> %.3fs) by thread %s — long "
                    "holds on control-plane locks stall every servicer "
                    "thread",
                    hold.lock, hold.seconds, threshold, hold.thread,
                )


def make_lock(name: str):
    """Lock factory the control-plane services use.

    Plain ``threading.Lock`` unless ``ELASTICDL_LOCKCHECK=1`` was set
    when the lock was created — production pays only this env lookup,
    once, at service construction.
    """
    if enabled():
        return CheckedLock(name)
    return threading.Lock()


def reset():
    """Clear all recorded state (test isolation)."""
    global _state
    _state = _State()


def report() -> Dict[str, object]:
    with _state.meta:
        return {
            "acquisitions": _state.acquisitions,
            "inversions": list(_state.inversions),
            "long_holds": list(_state.long_holds),
            "max_hold_s": dict(_state.max_hold_s),
        }


def inversions() -> List[LockOrderInversion]:
    with _state.meta:
        return list(_state.inversions)


def assert_clean(ignore_long_holds: bool = True):
    """Raise AssertionError if any inversion (or, optionally, long hold)
    was recorded — the stress tests' post-run gate."""
    snapshot = report()
    problems = [i.describe() for i in snapshot["inversions"]]
    if not ignore_long_holds:
        problems += [
            f"long hold: {h.lock} {h.seconds:.3f}s ({h.thread})"
            for h in snapshot["long_holds"]
        ]
    if problems:
        raise AssertionError(
            "lockcheck found problems:\n  " + "\n  ".join(problems)
        )
