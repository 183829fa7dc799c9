"""The retrying call plane of the port's HTTP transports: the JAX package's
``RetryPolicy`` and ``call_with_retry`` (``elasticdl_tpu/common/
grpc_utils.py:147,332``) without gRPC.

A call carries an explicit deadline.  A transient failure (the server
refused, reset or dropped the connection, a deadline lapsed, or it
answered UNAVAILABLE or DEADLINE_EXCEEDED) backs off and retries while
the policy's attempts and total budget last; any other error propagates
at once.  Backoff for attempt k (1-based) is ``min(max_backoff_s,
base_backoff_s * 2**(k-1))`` scaled by a deterministic jitter in [1, 1 +
jitter] seeded from (salt, method, k), as in JAX.  Each attempt fires the
fault site ``rpc.<method>`` (``common/faults.py``: ``error=<CODE>``
raises that code, ``latency=<s>`` sleeps) before the wire call.
"""

from __future__ import annotations

import http.client
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.constants import RPC
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("common.retry")

#: gRPC status code name -> HTTP status (the codes the port's servers
#: answer with; an unknown status reads back as UNKNOWN).
HTTP_STATUS = {
    "OK": 200,
    "INVALID_ARGUMENT": 400,
    "NOT_FOUND": 404,
    "RESOURCE_EXHAUSTED": 429,
    "INTERNAL": 500,
    "UNIMPLEMENTED": 501,
    "UNAVAILABLE": 503,
    "DEADLINE_EXCEEDED": 504,
}

#: Status codes worth retrying: the server is (re)starting or going
#: away, or the deadline lapsed.
TRANSIENT_CODES = ("UNAVAILABLE", "DEADLINE_EXCEEDED")

#: Connection-level failures that mean the same.
TRANSIENT_ERRORS = (ConnectionRefusedError, ConnectionResetError, ConnectionAbortedError,
                    BrokenPipeError, http.client.RemoteDisconnected, TimeoutError)


class RpcError(RuntimeError):
    """A call the server answered with a status other than OK (``code``
    is the gRPC code's name)."""

    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message
        self.status = HTTP_STATUS.get(code, 500)


def code_of(exc: BaseException) -> Optional[str]:
    """The status code name of a failed call: its own for an ``RpcError``
    (or anything with a string ``code``), DEADLINE_EXCEEDED for a
    timeout, UNAVAILABLE for a failed connection, else None."""
    code = getattr(exc, "code", None)
    if isinstance(code, str):
        return code
    if isinstance(exc, TimeoutError):
        return "DEADLINE_EXCEEDED"
    if isinstance(exc, TRANSIENT_ERRORS):
        return "UNAVAILABLE"
    return None


@dataclass(frozen=True)
class RetryPolicy:
    """Per-call deadline + bounded exponential backoff; ``max_attempts=1``
    is deadline-only (the non-idempotent policy)."""

    timeout_s: float = RPC.DEADLINE_S
    max_attempts: int = 1
    base_backoff_s: float = RPC.BASE_BACKOFF_S
    max_backoff_s: float = RPC.MAX_BACKOFF_S
    jitter: float = RPC.JITTER
    total_budget_s: float = RPC.TOTAL_BUDGET_S

    def backoff_s(self, method: str, attempt: int, salt: str = "") -> float:
        base = min(self.max_backoff_s, self.base_backoff_s * (2 ** (attempt - 1)))
        if not self.jitter:
            return base
        u = random.Random(f"{salt}:{method}:{attempt}").random()
        return base * (1.0 + self.jitter * u)


#: The two client-side policies; idempotency is a per-call property the
#: caller declares.
IDEMPOTENT_POLICY = RetryPolicy(max_attempts=RPC.MAX_ATTEMPTS)
NON_IDEMPOTENT_POLICY = RetryPolicy(max_attempts=1)


@dataclass
class RetryStats:
    """Per-client counters: how often a caller had to retry (a client is
    shared by the task loop and the heartbeat thread, hence the lock)."""

    calls: int = 0
    attempts: int = 0
    retries: int = 0
    give_ups: int = 0
    last_error: str = ""
    per_method_retries: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def record(self, kind: str, method: str = "", code: str = "") -> None:
        with self._lock:
            if kind == "call":
                self.calls += 1
            elif kind == "attempt":
                self.attempts += 1
            elif kind == "retry":
                self.retries += 1
                self.per_method_retries[method] = self.per_method_retries.get(method, 0) + 1
            else:
                self.give_ups += 1
                self.last_error = f"{method}: {code}"


def _apply_rpc_fault(spec: faults.FaultSpec, sleep: Callable[[float], None]) -> None:
    if spec.kind == "error":
        raise RpcError(spec.arg or "UNAVAILABLE", "injected fault (elasticdl_tpu_torch.common.faults)")
    if spec.kind == "latency":
        sleep(float(spec.arg or 0.1))


def call_with_retry(
    call: Callable[[float], object],
    method: str,
    policy: RetryPolicy,
    stats: Optional[RetryStats] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    seed: str = "",
):
    """``call(timeout_s)`` under ``policy``: every attempt carries the
    policy's deadline; transient failures back off and retry while
    attempts and the total budget last (an attempt that could not finish
    inside the budget is not started)."""
    if stats is not None:
        stats.record("call")
    deadline = clock() + policy.total_budget_s
    attempt = 0
    while True:
        attempt += 1
        if stats is not None:
            stats.record("attempt")
        try:
            spec = faults.fire(f"rpc.{method}")
            if spec is not None:
                _apply_rpc_fault(spec, sleep)
            return call(policy.timeout_s)
        except (RpcError, *TRANSIENT_ERRORS) as exc:
            code = code_of(exc)
            transient = code in TRANSIENT_CODES
            backoff = policy.backoff_s(method, attempt, salt=seed)
            out_of_budget = clock() + backoff + policy.timeout_s > deadline
            if not transient or attempt >= policy.max_attempts or out_of_budget:
                if stats is not None and transient:
                    stats.record("give_up", method, code)
                if transient and policy.max_attempts > 1:
                    logger.warning("RPC %s failed with %s after %d attempt(s)%s", method, code,
                                   attempt, " (retry budget exhausted)" if out_of_budget else "")
                raise
            if stats is not None:
                stats.record("retry", method)
            if attempt == 1:
                # One line per outage; the give-up above closes it.
                logger.warning("RPC %s hit %s; retrying with backoff (deadline %.0fs, "
                               "budget %.0fs)", method, code, policy.timeout_s,
                               policy.total_budget_s)
            sleep(backoff)


def expected_backoff_schedule(method: str, policy: RetryPolicy, retries: int, seed: str = ""):
    """The backoff sequence ``call_with_retry`` sleeps for ``retries``
    consecutive transient failures of ``method`` under ``seed``."""
    return tuple(policy.backoff_s(method, attempt, salt=seed) for attempt in range(1, retries + 1))
