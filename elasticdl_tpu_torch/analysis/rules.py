"""The control-plane invariant checkers (one per contract).

The port's copy of ``elasticdl_tpu/analysis/rules.py``: the same six
rules under the same names, each extended with the forms the port
writes (its RPC travels as JSON over HTTP, ``common/http_rpc.py``).
Each rule is a function ``rule(source: SourceFile) -> List[Violation]``;
tests/test_torch_analysis.py holds the must-pass / must-fail fixtures
and holds these rules to the JAX package's on its fixtures.  The
hot-path family lives in `torch_rules.py` on top of the hot-ness core in
`traced.py`, the protocol family in `protocol_rules.py`; all three merge
into ``ALL_RULES`` below.

Rules
-----
rpc-deadline     every gRPC stub call carries ``timeout=``; every
                 ``JsonRpcClient.call(method, request, policy)`` passes
                 its retry policy (which carries the deadline); every
                 ``http.client.HTTPConnection`` / ``urlopen`` passes
                 ``timeout=``.
idempotency      non-idempotent RPC names never ride a retrying wrapper
                 (``call_with_retry`` in either argument order, and
                 ``JsonRpcClient.call``).
determinism      no wall clock / unseeded randomness in deterministic-replay
                 paths (fault injection, retry backoff schedules).
thread-hygiene   every ``threading.Thread(...)`` names itself and declares
                 ``daemon=`` — stack dumps from stuck jobs must be
                 attributable, and shutdown must be deliberate.
lock-discipline  fields annotated ``# guarded-by: <lock>`` are only mutated
                 with that lock held (``with self.<lock>`` lexically, or in
                 a ``*_locked`` method whose caller holds it).
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional

from elasticdl_tpu_torch.analysis.core import SourceFile, Violation
from elasticdl_tpu_torch.analysis.program import program_of

# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _keyword_names(call: ast.Call) -> List[str]:
    return [kw.arg for kw in call.keywords if kw.arg is not None]


def _get_arg(call: ast.Call, position: int, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    if len(call.args) > position:
        return call.args[position]
    return None


def _string_value(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ---------------------------------------------------------------------------
# Rule: rpc-deadline
# ---------------------------------------------------------------------------

#: Receivers that are gRPC stubs by naming convention: ``stub``, ``_stub``,
#: ``self._stub``, ``master_stub`` ... — the analyzer flags any *direct*
#: method invocation on them that lacks an explicit ``timeout=``.
def _is_stub_expr(node: ast.AST) -> bool:
    dotted = _dotted(node)
    if not dotted:
        return False
    last = dotted.split(".")[-1]
    return last == "stub" or last.endswith("_stub")


#: Raw HTTP openers: each takes its deadline as ``timeout=`` (or as the
#: third positional argument: ``HTTPConnection(host, port, timeout)``,
#: ``urlopen(url, data, timeout)``).
_HTTP_OPENERS = frozenset(
    {"http.client.HTTPConnection", "client.HTTPConnection", "HTTPConnection",
     "http.client.HTTPSConnection", "client.HTTPSConnection", "HTTPSConnection",
     "urllib.request.urlopen", "request.urlopen", "urlopen"}
)


def _rpc_client_call(source: SourceFile, node: ast.Call) -> bool:
    """``<client>.call("method", ...)``: the port's JSON-over-HTTP RPC —
    the receiver names a client, or the program index resolves the call
    to an ``...RpcClient`` class's ``call``."""
    func = node.func
    if not (isinstance(func, ast.Attribute) and func.attr == "call"):
        return False
    if _string_value(_get_arg(node, 0, "method")) is None:
        return False
    dotted = _dotted(func.value) or ""
    if "client" in dotted.split(".")[-1].lower():
        return True
    target = program_of(source).resolve_call(node)
    return bool(target and target.class_fq and target.class_fq.endswith("RpcClient"))


def check_rpc_deadline(source: SourceFile) -> List[Violation]:
    """Every RPC carries a deadline (stub timeout=, JSON-RPC policy, HTTP timeout=).

    gRPC stub calls pass timeout=, ``JsonRpcClient.call`` passes a retry
    policy (it carries the deadline), HTTP openers pass timeout=."""
    violations = []

    def flag(node: ast.Call, message: str):
        violations.append(
            Violation(
                rule="rpc-deadline",
                path=source.path,
                line=node.lineno,
                col=node.col_offset,
                message=message,
            )
        )

    for node in ast.walk(source.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted_func = _dotted(node.func)
        if dotted_func in _HTTP_OPENERS:
            if "timeout" not in _keyword_names(node) and len(node.args) < 3:
                flag(
                    node,
                    f"{dotted_func}(...) without timeout= — a connection "
                    "without a deadline can hang its caller forever; pass "
                    "the call's deadline as timeout=",
                )
            continue
        if _rpc_client_call(source, node):
            if _get_arg(node, 2, "policy") is None:
                flag(
                    node,
                    f"{_dotted(node.func.value)}.call(...) without a retry "
                    "policy — the policy carries the RPC's deadline and "
                    "retry budget; pass one (IDEMPOTENT_POLICY or the "
                    "no-retry NON_IDEMPOTENT_POLICY)",
                )
            continue
        raw_stub_call = isinstance(
            node.func, ast.Attribute
        ) and _is_stub_expr(node.func.value)
        # getattr(stub, method)(request, ...) — the dynamic-dispatch form.
        getattr_call = (
            isinstance(node.func, ast.Call)
            and isinstance(node.func.func, ast.Name)
            and node.func.func.id == "getattr"
            and len(node.func.args) >= 1
            and _is_stub_expr(node.func.args[0])
        )
        if not (raw_stub_call or getattr_call):
            continue
        if "timeout" in _keyword_names(node):
            continue
        what = (
            f"{_dotted(node.func.value)}.{node.func.attr}"
            if raw_stub_call
            else "getattr(stub, ...)"
        )
        flag(
            node,
            f"raw gRPC stub call {what}(...) without timeout= — "
            "every RPC must carry a deadline; route it through "
            "call_with_retry / a RetryPolicy",
        )
    return violations


# ---------------------------------------------------------------------------
# Rule: idempotency
# ---------------------------------------------------------------------------

#: RPCs whose effects do NOT deduplicate server-side (see
#: worker/master_client.py): a retried duplicate either double-charges a
#: task retry budget or double-counts evaluation rows.
NON_IDEMPOTENT_RPCS = frozenset(
    {"report_task_result", "report_evaluation_metrics"}
)

#: Wrapper callables that retry their RPC.
_RETRYING_WRAPPERS = frozenset({"_call_idempotent", "call_with_retry"})

#: Policy-argument spellings that mean "no retries" for call_with_retry.
_NO_RETRY_POLICY_HINTS = ("NON_IDEMPOTENT", "no_retry", "_once")


def check_idempotency(source: SourceFile) -> List[Violation]:
    """Non-idempotent RPC names never appear inside a retrying wrapper."""
    violations = []
    for node in ast.walk(source.tree):
        if not isinstance(node, ast.Call):
            continue
        func_name = None
        if isinstance(node.func, ast.Attribute):
            func_name = node.func.attr
        elif isinstance(node.func, ast.Name):
            func_name = node.func.id
        client_call = _rpc_client_call(source, node)
        if func_name not in _RETRYING_WRAPPERS and not client_call:
            continue
        if func_name == "call_with_retry" or client_call:
            # The JAX package's call_with_retry(fn, request, method,
            # policy); the port's call_with_retry(call, method, policy)
            # and JsonRpcClient.call(method, request, policy).
            if client_call:
                method_pos, policy_pos = 0, 2
            elif _string_value(_get_arg(node, 2, "method")) is None and (
                _string_value(_get_arg(node, 1, "method")) is not None
            ):
                method_pos, policy_pos = 1, 2
            else:
                method_pos, policy_pos = 2, 3
            method = _string_value(_get_arg(node, method_pos, "method"))
            policy = _get_arg(node, policy_pos, "policy")
            policy_text = (
                ast.unparse(policy) if policy is not None else ""
            )
            if any(hint in policy_text for hint in _NO_RETRY_POLICY_HINTS):
                continue
            if (
                isinstance(policy, ast.Call)
                and _dotted(policy.func) in (
                    "RetryPolicy", "grpc_utils.RetryPolicy", "retry.RetryPolicy"
                )
            ):
                attempts = _get_arg(policy, 10**6, "max_attempts")
                if (
                    isinstance(attempts, ast.Constant)
                    and attempts.value == 1
                ):
                    continue
        else:
            # _call_idempotent(method, request)
            method = _string_value(_get_arg(node, 0, "method"))
        if method in NON_IDEMPOTENT_RPCS:
            violations.append(
                Violation(
                    rule="idempotency",
                    path=source.path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"non-idempotent RPC '{method}' inside a retrying "
                        "wrapper — a retried duplicate double-charges the "
                        "task retry budget / double-counts eval rows; use "
                        "the no-retry (deadline-only) policy"
                    ),
                )
            )
    return violations


# ---------------------------------------------------------------------------
# Rule: determinism
# ---------------------------------------------------------------------------

#: Files on the deterministic-replay path: fault schedules and retry
#: backoff must replay exactly (the JAX package's
#: docs/failure_model.md §Determinism).  The port's jitter lives in
#: ``common/retry.py`` and its RPC client in ``common/http_rpc.py``.
#: Other modules can opt in with a `# deterministic-replay-path` comment.
DETERMINISTIC_PATH_SUFFIXES = (
    "elasticdl_tpu_torch/common/faults.py",
    "elasticdl_tpu_torch/common/retry.py",
    "elasticdl_tpu_torch/common/http_rpc.py",
)

_DETERMINISM_MARKER = "deterministic-replay-path"

#: time.monotonic / perf_counter (interval clocks for budgets and
#: heartbeats) and time.sleep are fine; wall clock and unseeded
#: randomness are not.
_BANNED_CLOCKS = frozenset({"time.time", "datetime.now", "datetime.utcnow",
                            "datetime.datetime.now", "datetime.datetime.utcnow"})


def _on_deterministic_path(source: SourceFile) -> bool:
    normalized = source.path.replace("\\", "/")
    if any(normalized.endswith(sfx) for sfx in DETERMINISTIC_PATH_SUFFIXES):
        return True
    return any(
        _DETERMINISM_MARKER in comment for comment in source.comments.values()
    )


def check_determinism(source: SourceFile) -> List[Violation]:
    """No wall clock / unseeded RNG in deterministic-replay modules."""
    if not _on_deterministic_path(source):
        return []
    violations = []
    for node in ast.walk(source.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if not dotted:
            continue
        bad = None
        if dotted in _BANNED_CLOCKS and not node.args:
            bad = f"{dotted}() reads the wall clock"
        elif dotted.startswith("random.") and dotted != "random.Random":
            bad = f"{dotted}() draws from the global (unseeded) RNG"
        elif dotted == "random.Random" and not node.args and not node.keywords:
            bad = "random.Random() without a seed is wall-clock seeded"
        if bad is not None:
            violations.append(
                Violation(
                    rule="determinism",
                    path=source.path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"{bad} — this module is on the deterministic-"
                        "replay path (fault/backoff schedules must replay "
                        "exactly); use a seeded random.Random or a "
                        "monotonic clock injected by the caller"
                    ),
                )
            )
    return violations


# ---------------------------------------------------------------------------
# Rule: thread-hygiene
# ---------------------------------------------------------------------------


def check_thread_hygiene(source: SourceFile) -> List[Violation]:
    """Every threading.Thread(...) passes both name= and daemon=."""
    violations = []
    for node in ast.walk(source.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted not in ("threading.Thread", "Thread"):
            continue
        keywords = set(_keyword_names(node))
        missing = [kw for kw in ("name", "daemon") if kw not in keywords]
        if not missing:
            continue
        violations.append(
            Violation(
                rule="thread-hygiene",
                path=source.path,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"threading.Thread(...) missing {', '.join(missing)}= — "
                    "unnamed threads make stack dumps from stuck jobs "
                    "unattributable, and an implicit daemon flag makes "
                    "shutdown behavior accidental"
                ),
            )
        )
    return violations


# ---------------------------------------------------------------------------
# Rule: lock-discipline
# ---------------------------------------------------------------------------

#: Method names that mutate their receiver in place.
_MUTATORS = frozenset(
    {
        "append", "appendleft", "extend", "extendleft", "insert",
        "pop", "popleft", "popitem", "remove", "discard", "clear",
        "update", "setdefault", "add", "sort", "reverse",
    }
)


def _self_attr_root(node: ast.AST) -> Optional[str]:
    """For self._a[k].b chains, the root attribute name ('_a'); else None."""
    while True:
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Starred):
            node = node.value
        else:
            return None


def _collect_guarded_fields(
    source: SourceFile, cls: ast.ClassDef
) -> Dict[str, str]:
    """field name -> lock attribute name for one class."""
    guarded: Dict[str, str] = {}
    # Class-body (dataclass-style) declarations with inline annotations.
    for stmt in cls.body:
        target = None
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            target = stmt.target.id
        elif (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
        ):
            target = stmt.targets[0].id
        if target is None:
            continue
        lock = source.guarded_inline(stmt.lineno) or source.guarded_inline(
            stmt.end_lineno or stmt.lineno
        )
        if lock:
            guarded[target] = lock
    # __init__-declared self.<field> assignments with inline annotations.
    for stmt in cls.body:
        if not (
            isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
            and stmt.name == "__init__"
        ):
            continue
        for node in ast.walk(stmt):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            for tgt in targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    lock = source.guarded_inline(
                        node.lineno
                    ) or source.guarded_inline(node.end_lineno or node.lineno)
                    if lock:
                        guarded[tgt.attr] = lock
    # Standalone multi-field re-declarations (inherited fields).
    guarded.update(
        source.guarded_blocks(cls.lineno, cls.end_lineno or cls.lineno)
    )
    return guarded


def _with_locks(node: ast.With, lock_names: FrozenSet[str]) -> List[str]:
    held = []
    for item in node.items:
        expr = item.context_expr
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in lock_names
        ):
            held.append(expr.attr)
    return held


def check_lock_discipline(source: SourceFile) -> List[Violation]:
    """# guarded-by: <lock> fields are only mutated with that lock held."""
    violations: List[Violation] = []
    for cls in ast.walk(source.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        guarded = _collect_guarded_fields(source, cls)
        if not guarded:
            continue
        lock_names = frozenset(guarded.values())
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name == "__init__" or method.name.endswith("_locked"):
                # __init__ runs before the object is shared; *_locked
                # methods are called with the lock already held (naming
                # convention used throughout the master services).
                continue
            _scan_method(source, cls, method, guarded, lock_names, violations)
    return violations


def _scan_method(source, cls, method, guarded, lock_names, violations):
    def report(node: ast.AST, field_name: str, verb: str):
        lock = guarded[field_name]
        violations.append(
            Violation(
                rule="lock-discipline",
                path=source.path,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"{cls.name}.{field_name} (guarded-by: {lock}) "
                    f"{verb} in {method.name}() outside 'with "
                    f"self.{lock}' — mutate under the lock or move the "
                    "code into a *_locked method"
                ),
            )
        )

    def check_target(node: ast.AST, target: ast.AST, held, verb: str):
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                check_target(node, elt, held, verb)
            return
        field_name = _self_attr_root(target)
        if field_name in guarded and guarded[field_name] not in held:
            report(node, field_name, verb)

    def visit(node: ast.AST, held: FrozenSet[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # A nested function body does not run at definition point:
            # the lexically-held locks are NOT held when it is called.
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                visit(child, frozenset())
            return
        if isinstance(node, ast.With):
            held = held | frozenset(_with_locks(node, lock_names))
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                check_target(node, tgt, held, "assigned")
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            check_target(node, node.target, held, "assigned")
        elif isinstance(node, ast.AugAssign):
            check_target(node, node.target, held, "updated")
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                check_target(node, tgt, held, "deleted")
        elif isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS
            ):
                field_name = _self_attr_root(node.func.value)
                if field_name in guarded and guarded[field_name] not in held:
                    report(node, field_name, f"mutated (.{node.func.attr}())")
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in method.body:
        visit(stmt, frozenset())


# ---------------------------------------------------------------------------
# Rule: metric-label-cardinality
# ---------------------------------------------------------------------------

#: Label names whose values are unbounded in an elastic job: task ids
#: grow forever, pods/hosts churn with every re-formation, steps/epochs
#: are counters.  Each distinct label value is a NEW timeseries held
#: forever by the registry and re-sent on every scrape — an unbounded
#: label is a slow memory leak and a scrape-size bomb.  Such identifiers
#: belong in the event journal (obs/journal.py) as free-form fields.
UNBOUNDED_LABEL_NAMES = frozenset(
    {
        "task_id", "worker_id", "pod", "pod_name", "host", "hostname",
        "addr", "address", "ip", "uid", "step", "epoch", "rendezvous_id",
        "shard", "shard_name", "path", "job_name", "model_version",
    }
)

#: Metric-creation entry points: the obs module helpers (receiver must
#: look like a metrics registry, see _is_metric_factory) and the class
#: forms (labelnames check only — `collections.Counter(...)` has no
#: labelnames kwarg, so the class form cannot false-positive on it).
_METRIC_FACTORY_HELPERS = frozenset({"counter", "gauge", "histogram"})
_METRIC_FACTORY_CLASSES = frozenset({"Counter", "Gauge", "Histogram"})

#: Receiver names that identify a metrics registry (`obs.counter`,
#: `registry.histogram`, `self._registry.gauge`, ...).
_METRIC_RECEIVER_HINTS = ("obs", "registry", "metrics")

#: Metric methods that accept **label kwargs.
_LABELED_METRIC_METHODS = frozenset(
    {"labels", "inc", "dec", "set", "observe", "set_function"}
)


def _call_func_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


def _is_metric_factory(node: ast.Call) -> bool:
    """True for metric-creation helper calls.  Bare names (`counter(...)`)
    and unresolvable receivers (`obs.registry().counter(...)`) count; a
    resolvable receiver must carry a registry-ish name, so unrelated
    `.histogram()`/`.counter()` methods on other objects stay unflagged."""
    name = _call_func_name(node)
    if name not in _METRIC_FACTORY_HELPERS:
        return False
    if isinstance(node.func, ast.Name):
        return True
    base = _dotted(node.func.value)
    if base is None:
        return True
    last = base.split(".")[-1].lstrip("_").lower()
    return any(hint in last for hint in _METRIC_RECEIVER_HINTS)


def check_metric_label_cardinality(source: SourceFile) -> List[Violation]:
    """Metric label sets stay bounded: no task/pod/host-shaped labels, no
    dynamic metric names."""
    violations = []

    def flag(node, message):
        violations.append(
            Violation(
                rule="metric-label-cardinality",
                path=source.path,
                line=node.lineno,
                col=node.col_offset,
                message=message,
            )
        )

    for node in ast.walk(source.tree):
        if not isinstance(node, ast.Call):
            continue
        func_name = _call_func_name(node)
        is_helper = _is_metric_factory(node)
        if is_helper or func_name in _METRIC_FACTORY_CLASSES:
            if is_helper:
                name_arg = _get_arg(node, 0, "name")
                if isinstance(name_arg, (ast.JoinedStr, ast.BinOp)):
                    flag(
                        node,
                        "dynamic metric name at metric-creation site — "
                        "every distinct value mints a new metric family "
                        "held forever; use a constant name and bounded "
                        "labels (put the varying identifier in the event "
                        "journal)",
                    )
            labelnames = _get_arg(node, 2, "labelnames")
            if isinstance(labelnames, (ast.Tuple, ast.List, ast.Set)):
                for elt in labelnames.elts:
                    value = _string_value(elt)
                    if value and value.lower() in UNBOUNDED_LABEL_NAMES:
                        flag(
                            elt,
                            f"label '{value}' declared at metric creation "
                            "is fed from an unbounded value source (task "
                            "ids / pods / hosts grow without bound): every "
                            "distinct value is a new timeseries held "
                            "forever — record it as a journal field "
                            "instead",
                        )
        if func_name in _LABELED_METRIC_METHODS:
            for kw in node.keywords:
                if kw.arg and kw.arg.lower() in UNBOUNDED_LABEL_NAMES:
                    flag(
                        kw.value,
                        f"metric label '{kw.arg}' at a .{func_name}() call "
                        "site carries an unbounded value (task ids / pods "
                        "/ hosts): every distinct value is a new "
                        "timeseries held forever — record it as a journal "
                        "field instead",
                    )
    return violations


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

from elasticdl_tpu_torch.analysis.protocol_rules import PROTOCOL_RULES  # noqa: E402
from elasticdl_tpu_torch.analysis.torch_rules import TORCH_RULES  # noqa: E402

ALL_RULES = {
    "rpc-deadline": check_rpc_deadline,
    "idempotency": check_idempotency,
    "determinism": check_determinism,
    "thread-hygiene": check_thread_hygiene,
    "lock-discipline": check_lock_discipline,
    "metric-label-cardinality": check_metric_label_cardinality,
    **TORCH_RULES,
    **PROTOCOL_RULES,
}

RULE_NAMES = tuple(ALL_RULES)

# Registry names double as timing keys in ScanReport.timings (core.scan
# reads the attribute back — rules not in the registry fall back to
# their function __name__).
for _name, _rule in ALL_RULES.items():
    _rule._rule_name = _name
del _name, _rule
