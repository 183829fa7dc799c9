"""Whole-program protocol rules (on top of `program.ProgramIndex`).

The port's copy of ``elasticdl_tpu/analysis/protocol_rules.py``.  Three
rule families, all cross-module by construction (the JAX package's
docs/invariants.md "Protocol rules"):

drain-discipline     every constructed object whose class defines
                     close()/drain()/stop()/shutdown() must reach
                     teardown on every path: ``with``, try/finally, or
                     ownership transfer to an owner that itself tears
                     down.  A bare local escaping scope undrained — or
                     drained only on the straight-line path — is a
                     finding.
blocking-under-lock  no RPC, time.sleep, file I/O, subprocess, thread
                     join, or resource drain may be *reachable* while a
                     ``# guarded-by:`` lock is held — reachability is
                     interprocedural over the cross-module call graph
                     (the blocking call is usually two frames down).
journal-schema       every ``journal.record(...)`` / ``record_span`` /
                     ``journal_anatomy`` emission and every
                     ``dict(event=...)`` payload-construction site must
                     match the port's registry
                     (``analysis/journal_schema.py``) field-for-field:
                     unknown event, missing required field, unregistered
                     extra field, or a non-literal event name is a
                     finding.  A ``.record(...)`` the program index
                     resolves to a class that is not a journal (the
                     retry counters' ``RetryStats.record``) is no
                     emission.

Each rule accepts a single SourceFile like every other rule; `scan()`
attaches the whole-program index so findings see across modules, and a
directly-invoked rule (test fixtures) degrades to a one-file program.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from elasticdl_tpu_torch.analysis.core import SourceFile, Violation
from elasticdl_tpu_torch.analysis.program import (
    ClassInfo,
    TEARDOWN_METHODS,
    _direct_blocking,
    program_of,
)

# ---------------------------------------------------------------------------
# Rule: drain-discipline
# ---------------------------------------------------------------------------

#: Teardown attribute names that satisfy the drain contract at a call
#: site (`p.close()`, `p.drain()`, ...).
_TEARDOWN_CALLS = frozenset(TEARDOWN_METHODS) | {"__exit__"}


class _TrackedLocal:
    """One bare local bound to a constructed resource."""

    __slots__ = ("var", "cls", "node", "teardown_plain", "teardown_finally",
                 "with_used", "escaped", "field_attr", "field_owner")

    def __init__(self, var: str, cls: ClassInfo, node: ast.Call):
        self.var = var
        self.cls = cls
        self.node = node
        self.teardown_plain = False
        self.teardown_finally = False
        self.with_used = False
        self.escaped = False
        self.field_attr: Optional[str] = None
        self.field_owner: Optional[ClassInfo] = None


def check_drain_discipline(source: SourceFile) -> List[Violation]:
    """close()/drain()/stop() resources reach teardown on every path."""
    program = program_of(source)
    mod = program.module_of(source)
    if mod is None:
        return []
    violations: List[Violation] = []
    for info in mod.traced.functions.values():
        if isinstance(info.node, ast.Lambda):
            continue
        _scan_drains(program, mod, info, source, violations)
    return violations


def _scan_drains(program, mod, info, source, violations):
    tracked: Dict[str, _TrackedLocal] = {}
    owner = (
        program.classes.get(f"{mod.name}.{info.self_class}")
        if info.self_class
        else None
    )

    def flag(node: ast.AST, message: str):
        violations.append(
            Violation(
                rule="drain-discipline",
                path=source.path,
                line=node.lineno,
                col=node.col_offset,
                message=message,
            )
        )

    def constructed_class(
        value: ast.AST,
    ) -> Tuple[Optional[ClassInfo], Optional[ast.Call]]:
        """(resource class, construction node) for `Cls(...)` — also
        through one builder-chained call (`Cls(...).start()` returning
        self, the serving-plane convention)."""
        if not isinstance(value, ast.Call):
            return None, None
        cls = program.resolve_class(mod, value.func)
        if cls is not None and cls.is_resource():
            return cls, value
        if (
            isinstance(value.func, ast.Attribute)
            and isinstance(value.func.value, ast.Call)
            and value.func.attr not in _TEARDOWN_CALLS
        ):
            inner = value.func.value
            cls = program.resolve_class(mod, inner.func)
            if cls is not None and cls.is_resource():
                return cls, inner
        return None, None

    def names_escaping(expr: ast.AST) -> Set[str]:
        """Tracked locals whose *ownership* the expression can take: a
        bare Name reference — but NOT a method/attribute receiver
        (`p.start()`, `p.port` are use, not transfer)."""
        found: Set[str] = set()
        stack: List[ast.AST] = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name
            ):
                continue
            if isinstance(node, ast.Name) and node.id in tracked:
                found.add(node.id)
            stack.extend(ast.iter_child_nodes(node))
        return found

    def mark_escaped(expr: ast.AST):
        for var in names_escaping(expr):
            tracked[var].escaped = True

    def check_field_store(target: ast.Attribute, cls: ClassInfo,
                          node: ast.AST, entry: Optional[_TrackedLocal]):
        """`self.x = <resource>`: ownership transfer — legal when the
        owner class itself has a teardown method to drain through."""
        if owner is None or owner.has_teardown():
            if entry is not None:
                entry.escaped = True
            return
        if entry is not None:
            entry.escaped = True  # reported here, not at end-of-scope
        teardown = "/".join(cls.teardown_methods())
        flag(
            node,
            f"{cls.name} stored on self.{target.attr} of {owner.name}, "
            f"which defines no close/drain/stop/shutdown — the "
            f"{cls.name}'s {teardown}() contract can never be honored "
            "through its owner",
        )

    def visit(node: ast.AST, in_finally: bool):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # A nested def runs later: any reference to a tracked local
            # from inside it is deferred use — treat as ownership
            # transfer (a teardown callback is a legitimate drain path).
            body = node.body if isinstance(node.body, list) else [node.body]
            for stmt in body:
                mark_escaped(stmt)
            return
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
            cls, ctor = constructed_class(value)
            visit(value, in_finally)
            if cls is not None and isinstance(target, ast.Name):
                tracked[target.id] = _TrackedLocal(target.id, cls, ctor)
                return
            if (
                cls is not None
                and isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                check_field_store(target, cls, ctor, None)
                return
            # Aliasing / container store of an already-tracked local.
            if isinstance(value, ast.Name) and value.id in tracked:
                entry = tracked[value.id]
                if (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    check_field_store(target, entry.cls, node, entry)
                else:
                    entry.escaped = True
            else:
                mark_escaped(value)
            return
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            if node.value is not None:
                mark_escaped(node.value)
                visit(node.value, in_finally)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Name) and expr.id in tracked:
                    tracked[expr.id].with_used = True
                else:
                    visit(expr, in_finally)
                if item.optional_vars is not None:
                    visit(item.optional_vars, in_finally)
            for stmt in node.body:
                visit(stmt, in_finally)
            return
        if isinstance(node, ast.Try):
            for stmt in node.body + node.orelse:
                visit(stmt, in_finally)
            for handler in node.handlers:
                for stmt in handler.body:
                    visit(stmt, in_finally)
            for stmt in node.finalbody:
                visit(stmt, True)
            return
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id in tracked
                and func.attr in _TEARDOWN_CALLS
            ):
                entry = tracked[func.value.id]
                if in_finally:
                    entry.teardown_finally = True
                else:
                    entry.teardown_plain = True
            else:
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    mark_escaped(arg)
            for child in ast.iter_child_nodes(node):
                visit(child, in_finally)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, in_finally)

    body = info.node.body
    for stmt in body if isinstance(body, list) else [body]:
        visit(stmt, False)

    for entry in tracked.values():
        if entry.with_used or entry.escaped or entry.teardown_finally:
            continue
        teardown = "/".join(entry.cls.teardown_methods())
        if entry.teardown_plain:
            flag(
                entry.node,
                f"{entry.cls.name}.{entry.cls.teardown_methods()[0]}() is "
                "reached only on the straight-line path — an exception "
                f"between construction and teardown leaks the "
                f"{entry.cls.name}; move teardown into try/finally or use "
                "`with`",
            )
        else:
            flag(
                entry.node,
                f"{entry.cls.name} constructed here never reaches "
                f"{teardown}() on any path — drain it with `with`/"
                "try-finally, or hand ownership to an owner that tears "
                "it down",
            )


# ---------------------------------------------------------------------------
# Rule: blocking-under-lock
# ---------------------------------------------------------------------------


def _guarded_locks(source: SourceFile, cls: ast.ClassDef) -> FrozenSet[str]:
    """Lock attribute names the class's # guarded-by: annotations name."""
    from elasticdl_tpu_torch.analysis.rules import _collect_guarded_fields

    return frozenset(_collect_guarded_fields(source, cls).values())


def _lock_regions(
    method: ast.AST, lock_names: FrozenSet[str]
) -> Iterator[Tuple[str, List[ast.AST]]]:
    """(lock name, body statements) for every `with self.<lock>:` block;
    inner with-blocks of an already-held lock are not re-reported."""
    from elasticdl_tpu_torch.analysis.rules import _with_locks

    stack: List[ast.AST] = list(method.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, (ast.With, ast.AsyncWith)):
            held = _with_locks(node, lock_names)
            if held:
                yield held[0], list(node.body)
                continue  # everything inside is already one region
        stack.extend(ast.iter_child_nodes(node))


def _region_calls(body: Sequence[ast.AST]) -> Iterator[ast.Call]:
    """Call nodes lexically inside a region, skipping nested defs (they
    run after the lock is released)."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def check_blocking_under_lock(source: SourceFile) -> List[Violation]:
    """No blocking call reachable while a # guarded-by: lock is held."""
    program = program_of(source)
    violations: List[Violation] = []

    def flag(call: ast.Call, held: str, detail: str):
        violations.append(
            Violation(
                rule="blocking-under-lock",
                path=source.path,
                line=call.lineno,
                col=call.col_offset,
                message=(
                    f"{detail} while holding {held} — blocking under a "
                    "control-plane lock stalls every reader (heartbeats, "
                    "k8s probes, dispatch); move the blocking work "
                    "outside the critical section"
                ),
            )
        )

    def check_region(cls_name: str, held: str, body: Sequence[ast.AST]):
        for call in _region_calls(body):
            prim = _direct_blocking(call)
            if prim is not None:
                flag(call, held, prim)
                continue
            fact = program.blocking_fact(call)
            if fact is not None:
                flag(call, held, f"call reaches {fact.describe()}")

    for cls in ast.walk(source.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        lock_names = _guarded_locks(source, cls)
        if not lock_names:
            continue
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            if method.name.endswith("_locked"):
                check_region(
                    cls.name,
                    f"{cls.name}'s lock ({method.name}() runs under its "
                    "*_locked contract)",
                    method.body,
                )
            for lock, body in _lock_regions(method, lock_names):
                check_region(cls.name, f"{cls.name}.{lock}", body)
    return violations


# ---------------------------------------------------------------------------
# Rule: journal-schema
# ---------------------------------------------------------------------------

#: Envelope fields the journal adds / the validator checks itself.
_ENVELOPE_FIELDS = frozenset({"ts", "event"})

#: record_span(...) signature parameters that are span *envelope*, not
#: payload fields (obs/tracing.py) — payload rides **fields.
_SPAN_ENVELOPE = frozenset(
    {"name", "start_ts", "duration_s", "trace_id", "parent_id",
     "parent_span_id", "span_id", "root"}
)

def _journal_registry() -> dict:
    """The port's schema registry, ``analysis/journal_schema.py``.  No
    fallback: a registry that fails to import raises, so the rule can
    never go silent."""
    from elasticdl_tpu_torch.analysis import journal_schema

    return {
        "required": dict(journal_schema.EVENT_REQUIRED_FIELDS),
        "optional": dict(journal_schema.EVENT_OPTIONAL_FIELDS),
        "known": frozenset(journal_schema.KNOWN_EVENTS),
    }


def _not_a_journal(program, node: ast.Call) -> bool:
    """The call resolves to a method of a class that is not a journal
    (``RetryStats.record``): its first argument is no event name."""
    target = program.resolve_call(node)
    if target is None or target.class_fq is None:
        return False
    return "journal" not in target.class_fq.rsplit(".", 1)[-1].lower()


def _journalish(receiver: ast.AST) -> bool:
    """Heuristic: the receiver of .record() is an event journal."""
    if isinstance(receiver, ast.Call):
        func = receiver.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else ""
        )
        return "journal" in name
    name = receiver.attr if isinstance(receiver, ast.Attribute) else (
        receiver.id if isinstance(receiver, ast.Name) else ""
    )
    return "journal" in name


def _call_last_segment(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def check_journal_schema(source: SourceFile) -> List[Violation]:
    """Journal emissions match the registry field-for-field."""
    registry = _journal_registry()
    program = program_of(source)
    known: FrozenSet[str] = registry["known"]
    required: Dict[str, tuple] = registry["required"]
    optional: Dict[str, tuple] = registry["optional"]
    violations: List[Violation] = []

    def flag(node: ast.AST, message: str):
        violations.append(
            Violation(
                rule="journal-schema",
                path=source.path,
                line=node.lineno,
                col=node.col_offset,
                message=message,
            )
        )

    def check_fields(node: ast.AST, event: str, fields: Sequence[str],
                     has_splat: bool, where: str):
        if event not in known:
            flag(
                node,
                f"unknown journal event '{event}' {where} — register it "
                "in analysis/journal_schema.py (EVENT_REQUIRED_FIELDS / "
                "KNOWN_EVENTS) or fix the name",
            )
            return
        needed = required.get(event, ())
        allowed = set(needed) | _ENVELOPE_FIELDS
        if event in optional:
            allowed |= set(optional[event])
            extras = sorted(f for f in fields if f not in allowed)
            if extras:
                flag(
                    node,
                    f"event '{event}' {where} carries unregistered "
                    f"field(s) {', '.join(extras)} — register them in "
                    "analysis/journal_schema.py EVENT_OPTIONAL_FIELDS "
                    "or fix the spelling (required fields: "
                    f"{', '.join(needed) or 'none'})",
                )
        if not has_splat:
            missing = sorted(f for f in needed if f not in fields)
            if missing:
                flag(
                    node,
                    f"event '{event}' {where} is missing required "
                    f"field(s) {', '.join(missing)} — "
                    "analysis/journal_schema.py rejects the record at "
                    "validation time",
                )

    for node in ast.walk(source.tree):
        if isinstance(node, ast.Dict):
            event = None
            fields: List[str] = []
            has_splat = False
            for key in node.keys:
                if key is None:
                    has_splat = True
                elif isinstance(key, ast.Constant) and isinstance(
                    key.value, str
                ):
                    fields.append(key.value)
            for key, value in zip(node.keys, node.values):
                if (
                    isinstance(key, ast.Constant)
                    and key.value == "event"
                    and isinstance(value, ast.Constant)
                    and isinstance(value.value, str)
                ):
                    event = value.value
            if event is not None:
                check_fields(node, event, fields, has_splat,
                             "(payload dict literal)")
            continue
        if not isinstance(node, ast.Call):
            continue
        segment = _call_last_segment(node.func)
        kwarg_names = [kw.arg for kw in node.keywords if kw.arg is not None]
        has_splat = any(kw.arg is None for kw in node.keywords)
        if segment == "record" and isinstance(node.func, ast.Attribute):
            if not node.args:
                continue  # record(**payload): checked at the build site
            if _not_a_journal(program, node):
                continue
            event = None
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(
                first.value, str
            ):
                event = first.value
            if event is None:
                if _journalish(node.func.value):
                    flag(
                        node,
                        "non-literal event name in journal.record(...) — "
                        "the schema gate (and every journal consumer) "
                        "needs a literal event type; pass the literal "
                        "here or build the payload with dict(event=...)",
                    )
                continue
            check_fields(node, event, kwarg_names, has_splat,
                         "at this record() site")
        elif segment == "record_span":
            fields = [k for k in kwarg_names if k not in _SPAN_ENVELOPE]
            check_fields(node, "span", fields, True,
                         "at this record_span() site")
        elif segment in ("journal_anatomy", "_journal_anatomy"):
            fields = [k for k in kwarg_names if k != "worker_id"]
            check_fields(node, "step_anatomy", fields, True,
                         "at this journal_anatomy() site")
        elif isinstance(node.func, ast.Name) and node.func.id == "dict":
            event = None
            for kw in node.keywords:
                if (
                    kw.arg == "event"
                    and isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, str)
                ):
                    event = kw.value.value
            if event is not None:
                check_fields(node, event, kwarg_names, has_splat,
                             "(dict(event=...) payload)")
    return violations


PROTOCOL_RULES = {
    "drain-discipline": check_drain_discipline,
    "blocking-under-lock": check_blocking_under_lock,
    "journal-schema": check_journal_schema,
}
