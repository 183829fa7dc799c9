"""Whole-program view: modules, imports, the cross-module call graph.

The port's copy of ``elasticdl_tpu/analysis/program.py``, unchanged in
substance (tests hold the two indexes to the same modules, imports,
classes, call edges and blocking facts over one file set).

`traced.py` answers "is this function hot?" *per file*.  The protocol
rules (`protocol_rules.py`) need the question answered across module
boundaries: the blocking call sitting under a ``# guarded-by:`` lock is
usually two frames down in another module, and the class whose
``close()`` contract a caller must honor is usually imported.  This
module builds that view, stdlib-only like the rest of the analyzer:

1. **Module table** — every scanned file gets a dotted module name
   derived from its ``__init__.py`` package chain, so
   ``elasticdl_tpu_torch/data/pipeline.py`` is addressable as
   ``elasticdl_tpu_torch.data.pipeline`` and a bare fixture file as its stem.
2. **Import resolution** — ``import a.b as m`` / ``from .pkg import X``
   (any relative level) bind local names to modules, functions, and
   classes *of the scanned file set*; names that resolve outside it
   (stdlib, torch) stay unresolved on purpose — the analyzer reasons only
   about code it can see.
3. **Call graph** — per function, every call is resolved to a scanned
   function where possible: bare names (module scope + imports),
   ``mod.func``, constructors (``Cls()`` -> ``Cls.__init__``),
   ``self.method()``, and method dispatch through an *inferred receiver
   class* (parameter annotations, ``x = Cls(...)`` locals, and
   ``self._x = Cls(...)`` fields).  Resolutions are cached per Call
   node (`call_targets`) so rules can ask about any site they walk.
4. **Fixpoint passes** — two properties propagate over the graph until
   quiescent: *hot-ness* (a helper called from a hot step in
   another module runs on the same step — the per-file
   `TracedIndex` maps are updated in place so the hot-path rules see it) and
   *blocking* (a function that reaches ``time.sleep`` / file I/O /
   ``subprocess`` / ``.join()`` / a raw RPC anywhere down its call
   chain).  The iteration count is exported in `stats()` so analyzer
   cost regressions show up in ``analysis/report.py``'s table.

Build with `build_program_index(sources)`; `scan()` attaches the result
to every SourceFile as ``_program_index`` so the program-aware rules
share one index per pass (and degrade to a single-file index when run
against a lone fixture).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from elasticdl_tpu_torch.analysis.core import SourceFile
from elasticdl_tpu_torch.analysis.traced import (
    FunctionInfo,
    TracedIndex,
    traced_index,
)

#: Teardown method names that make a class a *resource* for the
#: drain-discipline rule (plus ``__exit__``, which counts as teardown
#: for ownership checks but does not by itself make a class a resource).
TEARDOWN_METHODS = ("close", "drain", "stop", "shutdown")

#: Maximum rendered hops in a blocking-chain message.
_CHAIN_LIMIT = 6


def module_name_for(path: str) -> str:
    """Dotted module name from the ``__init__.py`` chain above `path`
    ('elasticdl_tpu_torch/data/pipeline.py' -> 'elasticdl_tpu_torch.data.pipeline';
    a file outside any package is just its stem)."""
    path = os.path.abspath(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    parts: List[str] = [] if stem == "__init__" else [stem]
    directory = os.path.dirname(path)
    while os.path.isfile(os.path.join(directory, "__init__.py")):
        parts.append(os.path.basename(directory))
        parent = os.path.dirname(directory)
        if parent == directory:
            break
        directory = parent
    if not parts:
        parts = [stem]
    return ".".join(reversed(parts))


@dataclass
class ClassInfo:
    """One class defined in the scanned file set."""

    fq: str  # '<module>.<Class>' (nested: '<module>.<Outer>.<Inner>')
    name: str
    module: str
    node: ast.ClassDef
    methods: Dict[str, str] = field(default_factory=dict)  # name -> fn fq

    def teardown_methods(self) -> Tuple[str, ...]:
        return tuple(m for m in TEARDOWN_METHODS if m in self.methods)

    def has_teardown(self) -> bool:
        return bool(self.teardown_methods()) or "__exit__" in self.methods

    def is_resource(self) -> bool:
        """Classes with an explicit close/drain/stop/shutdown contract."""
        return bool(self.teardown_methods())


@dataclass
class ProgramFunction:
    """One function with its program-wide address."""

    fq: str  # '<module>.<qualname>'
    module: str
    info: FunctionInfo
    class_fq: Optional[str]  # owning class fq for methods


@dataclass(frozen=True)
class BlockFact:
    """Why a function is considered blocking: the primitive it reaches
    and the call chain (this function first) that reaches it."""

    prim: str  # e.g. "time.sleep()", "file I/O (open())"
    chain: Tuple[str, ...]  # display names, caller -> ... -> primitive site

    def describe(self) -> str:
        chain = self.chain
        if len(chain) > _CHAIN_LIMIT:
            chain = chain[: _CHAIN_LIMIT - 1] + ("...",) + chain[-1:]
        if len(chain) <= 1:
            return self.prim
        return f"{self.prim} via {' -> '.join(chain)}"


class ModuleInfo:
    """Per-module symbol tables used during resolution."""

    __slots__ = ("name", "source", "traced", "imports", "classes",
                 "top_functions")

    def __init__(self, name: str, source: SourceFile, traced: TracedIndex):
        self.name = name
        self.source = source
        self.traced = traced
        #: local name -> dotted target ('pkg.mod' or 'pkg.mod.symbol')
        self.imports: Dict[str, str] = {}
        #: top-level class name -> class fq
        self.classes: Dict[str, str] = {}
        #: top-level function name -> function fq
        self.top_functions: Dict[str, str] = {}


def _direct_blocking(call: ast.Call) -> Optional[str]:
    """Human description when `call` is a blocking primitive, else None.

    Deliberately excluded: ``cv.wait()`` (releases the lock it waits
    under), ``.get()`` (queue vs dict is undecidable syntactically), and
    ``.acquire()`` (lock ordering is lock-discipline's concern).
    """
    func = call.func
    if isinstance(func, ast.Name):
        if func.id == "open":
            return "file I/O (open())"
        if func.id == "sleep":
            return "time.sleep()"
        if func.id == "call_with_retry":
            return "RPC (call_with_retry)"
        return None
    if not isinstance(func, ast.Attribute):
        return None
    receiver = func.value
    if func.attr == "sleep":
        if isinstance(receiver, ast.Name) and receiver.id == "time":
            return "time.sleep()"
        return None
    if isinstance(receiver, ast.Name) and receiver.id == "subprocess":
        return f"subprocess.{func.attr}()"
    if func.attr == "call_with_retry":
        return "RPC (call_with_retry)"
    # thread.join() / proc.join([timeout]) — but NOT str.join(iterable):
    # string joins always pass the iterable positionally, thread joins
    # pass nothing or a numeric timeout.
    if func.attr == "join" and not isinstance(receiver, ast.Constant):
        numeric_arg = (
            len(call.args) == 1
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, (int, float))
        )
        timeout_kw = any(kw.arg == "timeout" for kw in call.keywords)
        if not call.args or numeric_arg or timeout_kw:
            return f".{func.attr}() (thread/process join)"
    # Raw gRPC stub calls (same naming heuristic as rpc-deadline).
    dotted: List[str] = []
    node: ast.AST = receiver
    while isinstance(node, ast.Attribute):
        dotted.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        dotted.append(node.id)
    if dotted:
        last = dotted[0]
        if last == "stub" or last.endswith("_stub"):
            return f"RPC (stub.{func.attr}())"
    return None


def _annotation_class_name(annotation: Optional[ast.AST]) -> Optional[ast.AST]:
    """The Name/Attribute node naming a class in an annotation,
    unwrapping ``Optional[...]``-style subscripts and string literals."""
    if annotation is None:
        return None
    if isinstance(annotation, ast.Constant) and isinstance(
        annotation.value, str
    ):
        try:
            annotation = ast.parse(annotation.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(annotation, ast.Subscript):
        # Optional[Cls] / Final[Cls]: look at the (single) parameter.
        inner = annotation.slice
        if isinstance(inner, (ast.Name, ast.Attribute)):
            return inner
        return None
    if isinstance(annotation, (ast.Name, ast.Attribute)):
        return annotation
    return None


class ProgramIndex:
    """Cross-module symbol, class, and call-graph database."""

    def __init__(self, sources: Sequence[SourceFile]):
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_path: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, ProgramFunction] = {}
        self.classes: Dict[str, ClassInfo] = {}
        #: id(ast.Call node) -> resolved callee fq (only resolved calls)
        self.call_targets: Dict[int, str] = {}
        self.edges: Dict[str, Set[str]] = {}
        self.blocking: Dict[str, BlockFact] = {}
        self.fixpoint_iterations = 0
        self._self_attr_types: Dict[str, Dict[str, str]] = {}
        self._build(sources)

    # -- public API ----------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {
            "modules": len(self.modules),
            "edges": sum(len(v) for v in self.edges.values()),
            "fixpoint_iterations": self.fixpoint_iterations,
        }

    def module_of(self, source: SourceFile) -> Optional[ModuleInfo]:
        return self.by_path.get(source.path)

    def function_of(self, mod: ModuleInfo, info: FunctionInfo) -> str:
        return f"{mod.name}.{info.qualname}"

    def blocking_fact(self, call: ast.Call) -> Optional[BlockFact]:
        """BlockFact for a resolved call site whose callee blocks."""
        target = self.call_targets.get(id(call))
        if target is None:
            return None
        return self.blocking.get(target)

    def resolve_call(self, call: ast.Call) -> Optional[ProgramFunction]:
        target = self.call_targets.get(id(call))
        return self.functions.get(target) if target else None

    def resolve_class(
        self, mod: ModuleInfo, node: ast.AST
    ) -> Optional[ClassInfo]:
        """ClassInfo named by a Name / ``mod.Cls`` Attribute in `mod`."""
        if isinstance(node, ast.Name):
            fq = mod.classes.get(node.id)
            if fq:
                return self.classes.get(fq)
            target = mod.imports.get(node.id)
            if target:
                return self._class_at(target)
            return None
        if isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ):
            target = mod.imports.get(node.value.id)
            if target:
                other = self.modules.get(target)
                if other:
                    fq = other.classes.get(node.attr)
                    if fq:
                        return self.classes.get(fq)
        return None

    def resource_classes(self) -> Iterator[ClassInfo]:
        for cls in self.classes.values():
            if cls.is_resource():
                yield cls

    # -- construction --------------------------------------------------

    def _build(self, sources: Sequence[SourceFile]):
        for source in sources:
            name = module_name_for(source.path)
            while name in self.modules:  # same stem scanned twice
                name += "_"
            mod = ModuleInfo(name, source, traced_index(source))
            self.modules[name] = mod
            self.by_path[source.path] = mod
        for mod in self.modules.values():
            self._index_symbols(mod)
            self._parse_imports(mod)
        for mod in self.modules.values():
            self._build_edges(mod)
        self._propagate_tracedness()
        self._propagate_blocking()

    def _index_symbols(self, mod: ModuleInfo):
        # Classes, with traced.py's qualname scheme (nesting prefixes).
        def visit(node: ast.AST, prefix: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    qualname = (
                        f"{prefix}.{child.name}" if prefix else child.name
                    )
                    fq = f"{mod.name}.{qualname}"
                    self.classes[fq] = ClassInfo(
                        fq=fq, name=child.name, module=mod.name, node=child
                    )
                    if not prefix:
                        mod.classes[child.name] = fq
                    visit(child, qualname)
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qualname = (
                        f"{prefix}.{child.name}" if prefix else child.name
                    )
                    visit(child, qualname)
                else:
                    visit(child, prefix)

        visit(mod.source.tree, "")
        for info in mod.traced.functions.values():
            fq = f"{mod.name}.{info.qualname}"
            class_fq = None
            if info.is_method and "." in info.qualname:
                class_fq = f"{mod.name}.{info.qualname.rsplit('.', 1)[0]}"
                cls = self.classes.get(class_fq)
                if cls is not None:
                    cls.methods.setdefault(info.name, fq)
            self.functions[fq] = ProgramFunction(
                fq=fq, module=mod.name, info=info, class_fq=class_fq
            )
            if (
                not info.is_method
                and info.parent_function is None
                and not info.name.startswith("<lambda")
            ):
                mod.top_functions.setdefault(info.name, fq)

    def _parse_imports(self, mod: ModuleInfo):
        for node in ast.walk(mod.source.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        mod.imports[alias.asname] = alias.name
                    else:
                        root = alias.name.split(".")[0]
                        mod.imports.setdefault(root, root)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = mod.name.split(".")
                    # Relative to the containing package: drop the module
                    # segment, then one more per extra level.
                    keep = max(len(parts) - node.level, 0)
                    prefix = ".".join(parts[:keep])
                    base = (
                        f"{prefix}.{node.module}"
                        if prefix and node.module
                        else (prefix or node.module or "")
                    )
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    mod.imports[local] = (
                        f"{base}.{alias.name}" if base else alias.name
                    )

    # -- symbol lookup -------------------------------------------------

    def _function_at(self, dotted: str) -> Optional[str]:
        """fq of a top-level function addressed as '<module>.<name>'."""
        if "." not in dotted:
            return None
        module, name = dotted.rsplit(".", 1)
        other = self.modules.get(module)
        if other:
            return other.top_functions.get(name)
        return None

    def _class_at(self, dotted: str) -> Optional[ClassInfo]:
        if "." not in dotted:
            return None
        module, name = dotted.rsplit(".", 1)
        other = self.modules.get(module)
        if other:
            fq = other.classes.get(name)
            if fq:
                return self.classes.get(fq)
        return None

    def self_attr_types(self, class_fq: str) -> Dict[str, str]:
        """attr name -> class fq, inferred from ``self._x = Cls(...)``
        assignments and ``self._x: Cls`` annotations in any method."""
        cached = self._self_attr_types.get(class_fq)
        if cached is not None:
            return cached
        types: Dict[str, str] = {}
        cls = self.classes.get(class_fq)
        mod = self.modules.get(cls.module) if cls else None
        if cls is not None and mod is not None:
            for stmt in ast.walk(cls.node):
                target = None
                value_cls = None
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    target = stmt.targets[0]
                    if isinstance(stmt.value, ast.Call):
                        value_cls = self.resolve_class(mod, stmt.value.func)
                elif isinstance(stmt, ast.AnnAssign):
                    target = stmt.target
                    ann = _annotation_class_name(stmt.annotation)
                    if ann is not None:
                        value_cls = self.resolve_class(mod, ann)
                if (
                    value_cls is not None
                    and isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    types.setdefault(target.attr, value_cls.fq)
        self._self_attr_types[class_fq] = types
        return types

    def local_types(
        self, mod: ModuleInfo, info: FunctionInfo
    ) -> Dict[str, str]:
        """local var -> class fq within one function body (parameter
        annotations + ``x = Cls(...)`` constructor assignments)."""
        types: Dict[str, str] = {}
        node = info.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = (
                node.args.posonlyargs + node.args.args + node.args.kwonlyargs
            )
            for arg in args:
                ann = _annotation_class_name(arg.annotation)
                if ann is not None:
                    cls = self.resolve_class(mod, ann)
                    if cls is not None:
                        types[arg.arg] = cls.fq
        for stmt in mod.traced.own_body(info):
            target = None
            value = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign):
                target = stmt.target
                ann = _annotation_class_name(stmt.annotation)
                if ann is not None:
                    cls = self.resolve_class(mod, ann)
                    if cls is not None and isinstance(target, ast.Name):
                        types[target.id] = cls.fq
                value = stmt.value
            if (
                isinstance(target, ast.Name)
                and isinstance(value, ast.Call)
            ):
                cls = self.resolve_class(mod, value.func)
                if cls is not None:
                    types[target.id] = cls.fq
        return types

    def _resolve_callee(
        self,
        mod: ModuleInfo,
        info: FunctionInfo,
        call: ast.Call,
        local_types: Dict[str, str],
    ) -> Optional[str]:
        func = call.func
        if isinstance(func, ast.Name):
            fq = mod.top_functions.get(func.id)
            if fq:
                return fq
            class_fq = mod.classes.get(func.id)
            if class_fq:
                cls = self.classes.get(class_fq)
                return cls.methods.get("__init__") if cls else None
            target = mod.imports.get(func.id)
            if target:
                fq = self._function_at(target)
                if fq:
                    return fq
                cls = self._class_at(target)
                if cls:
                    return cls.methods.get("__init__")
            return None
        if not isinstance(func, ast.Attribute):
            return None
        receiver = func.value
        # self.method() / cls.method()
        if (
            isinstance(receiver, ast.Name)
            and receiver.id in ("self", "cls")
            and info.self_class is not None
        ):
            class_fq = f"{mod.name}.{info.self_class}"
            cls = self.classes.get(class_fq)
            if cls:
                return cls.methods.get(func.attr)
            return None
        # imported_module.func() / imported_module.Cls()
        if isinstance(receiver, ast.Name):
            target = mod.imports.get(receiver.id)
            if target and target in self.modules:
                fq = self._function_at(f"{target}.{func.attr}")
                if fq:
                    return fq
                cls = self._class_at(f"{target}.{func.attr}")
                if cls:
                    return cls.methods.get("__init__")
            # local_var.method() with an inferred receiver class
            class_fq = local_types.get(receiver.id)
            if class_fq:
                cls = self.classes.get(class_fq)
                if cls:
                    return cls.methods.get(func.attr)
            return None
        # self._field.method() with an inferred field class
        if (
            isinstance(receiver, ast.Attribute)
            and isinstance(receiver.value, ast.Name)
            and receiver.value.id == "self"
            and info.self_class is not None
        ):
            attr_types = self.self_attr_types(f"{mod.name}.{info.self_class}")
            class_fq = attr_types.get(receiver.attr)
            if class_fq:
                cls = self.classes.get(class_fq)
                if cls:
                    return cls.methods.get(func.attr)
        return None

    def _build_edges(self, mod: ModuleInfo):
        for info in mod.traced.functions.values():
            caller_fq = f"{mod.name}.{info.qualname}"
            outgoing = self.edges.setdefault(caller_fq, set())
            local_types = self.local_types(mod, info)
            for node in mod.traced.own_body(info):
                if not isinstance(node, ast.Call):
                    continue
                prim = _direct_blocking(node)
                if prim is not None and caller_fq not in self.blocking:
                    self.blocking[caller_fq] = BlockFact(
                        prim=prim, chain=(_short(caller_fq),)
                    )
                target = self._resolve_callee(mod, info, node, local_types)
                if target is not None and target != caller_fq:
                    self.call_targets[id(node)] = target
                    outgoing.add(target)

    # -- fixpoint passes -----------------------------------------------

    def _propagate_tracedness(self):
        """Cross-module transitive closure of hot-ness, updating each
        module's TracedIndex in place so the per-file hot-path rules see
        it."""
        worklist = [
            fq
            for fq, fn in self.functions.items()
            if fn.info.qualname in self.modules[fn.module].traced.traced
        ]
        while worklist:
            caller = worklist.pop()
            for callee in self.edges.get(caller, ()):
                fn = self.functions.get(callee)
                if fn is None:
                    continue
                # The callee and what its body references in its own
                # file (the per-file closure ran before this mark).
                for qualname in self.modules[fn.module].traced.mark_hot(
                    fn.info.qualname,
                    f"called from hot {_short(caller)} (cross-module)",
                ):
                    worklist.append(f"{fn.module}.{qualname}")

    def _propagate_blocking(self):
        """Round-based fixpoint: a caller of a blocking function blocks.
        Rounds are counted for the `stats()` cost report."""
        iterations = 0
        changed = True
        while changed:
            iterations += 1
            changed = False
            for caller, callees in self.edges.items():
                if caller in self.blocking:
                    continue
                for callee in sorted(callees):
                    fact = self.blocking.get(callee)
                    if fact is None:
                        continue
                    self.blocking[caller] = BlockFact(
                        prim=fact.prim,
                        chain=(_short(caller),) + fact.chain,
                    )
                    changed = True
                    break
        self.fixpoint_iterations = iterations


def _short(fq: str) -> str:
    """Display name: the last two dotted segments ('mod.Class.meth' ->
    'Class.meth')."""
    parts = fq.split(".")
    return ".".join(parts[-2:]) if len(parts) > 2 else fq


def build_program_index(sources: Sequence[SourceFile]) -> ProgramIndex:
    return ProgramIndex(sources)


def program_of(source: SourceFile) -> ProgramIndex:
    """The whole-program index `scan()` attached, or a fresh single-file
    index when a rule is invoked directly against one fixture."""
    program = getattr(source, "_program_index", None)
    if program is None or source.path not in program.by_path:
        program = ProgramIndex([source])
        source._program_index = program
    return program
