"""Hot-ness: which functions run on the port's device step.

The port's counterpart of ``elasticdl_tpu/analysis/traced.py``.  The JAX
package asks "does this statement run under a JAX trace?"; the port runs
its steps eagerly, so the question becomes *does this statement run on
the step that drives the card?* — because ``t.item()`` is a harmless host
read in a data loader and a stream synchronisation in every training
step.  The structure is JAX's, stdlib-only:

1. **Function index** — every ``def`` / ``async def`` / ``lambda`` in the
   module, with its qualified name, enclosing class, and enclosing
   function scopes (the same qualnames as JAX's, so the whole-program
   index in ``program.py`` builds on it unchanged).
2. **Hot roots** — the port's counterparts of JAX's trace roots:
   - ``forward`` of an ``nn.Module`` subclass (JAX's ``@nn.compact``);
   - ``forward`` / ``backward`` of a ``torch.autograd.Function`` subclass
     (JAX's ``custom_vjp`` / ``defvjp``);
   - a function passed to ``torch.compile``, ``make_graphed_callables``,
     ``torch.func.*`` / ``torch.vmap`` or
     ``torch.utils.checkpoint.checkpoint``, decorated with
     ``torch.compile``, or called inside ``with torch.cuda.graph(...)``;
   - a ``def`` whose line carries the ``# hot-path`` marker: the eager
     counterparts of the JAX package's compiled steps (in the style of
     ``# multi-device-path``).
3. **Transitive closure** — a function referenced from a hot function's
   body is hot too; per file here, and across modules through the
   whole-program index (``TracedIndex.mark_traced``).

On top sits the intraprocedural symbol pass: ``array_tainted_names`` marks
the names that (may) hold tensors — parameters, results of ``torch.*`` /
``F.*`` calls, of calls to other hot functions, and anything assigned
from those — and de-taints the static accessors (``.shape``, ``.dtype``,
``.ndim``, ``.device``, ``.size()``, ``.dim()``, ``.numel()``,
``len(...)``), so shape arithmetic never trips a host-sync rule.
``tensor_names`` is the stricter set the truthiness check uses: names
bound to the result of a tensor operation, never a bare parameter (a
``causal`` flag is a parameter, not a tensor).

The class and attribute names (``TracedIndex``, ``traced``,
``traced_infos``, ``mark_traced``) are JAX's, so a reader maps one
analyzer onto the other.  Stdlib-only, like the rest of the analyzer.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

from elasticdl_tpu_torch.analysis.core import SourceFile

#: The comment that marks a ``def`` as a hot root: the eager counterpart
#: of a step the JAX package compiles.
HOT_MARKER = "hot-path"
_HOT_MARKER_RE = re.compile(r"#\s*hot-path\b")

#: Dotted call names that run their function-valued arguments on the
#: device step (compiled, graph-captured, transformed or recomputed).
HOT_ENTRY_CALLS = frozenset(
    {
        "torch.compile",
        "torch.cuda.make_graphed_callables",
        "cuda.make_graphed_callables",
        "make_graphed_callables",
        "torch.vmap",
        "vmap",
        "functional_call",
        "torch.utils.checkpoint.checkpoint",
        "utils.checkpoint.checkpoint",
        "checkpoint.checkpoint",
        "torch.utils.checkpoint.checkpoint_sequential",
        "checkpoint_sequential",
        "torch.jit.script",
        "torch.jit.trace",
    }
)

#: ``torch.func`` transforms: ``torch.func.<name>`` / ``func.<name>``.
FUNC_TRANSFORMS = frozenset(
    {"vmap", "grad", "grad_and_value", "jacrev", "jacfwd", "hessian", "jvp",
     "vjp", "functional_call", "linearize"}
)

#: Calls that construct a compiled or captured callable: the port's
#: counterparts of a ``jax.jit`` construction site (``retrace-hazard``
#: reads them).
CAPTURE_CALLS = frozenset(
    {
        "torch.compile",
        "torch.cuda.make_graphed_callables",
        "cuda.make_graphed_callables",
        "make_graphed_callables",
        "torch.cuda.CUDAGraph",
        "cuda.CUDAGraph",
        "CUDAGraph",
        "torch.cuda.graph",
        "cuda.graph",
        "torch.jit.script",
        "torch.jit.trace",
    }
)

#: Decorators whose function runs compiled on the step.
_HOT_DECORATORS = frozenset({"torch.compile", "torch.jit.script"})

#: Context managers whose body is captured into a CUDA graph.
_GRAPH_CONTEXTS = frozenset({"torch.cuda.graph", "cuda.graph"})

#: Attribute accesses and accessor methods that yield host values even
#: on a CUDA tensor (no synchronisation).
STATIC_ATTRS = frozenset(
    {"shape", "dtype", "ndim", "device", "is_cuda", "layout", "requires_grad",
     "size", "dim", "numel", "nelement", "stride", "element_size",
     "is_contiguous", "is_floating_point", "data_ptr", "get_device",
     "names", "grad_fn"}
)

#: Call roots whose results are tensors (for the taint pass).
ARRAY_NAMESPACES = ("torch", "F")

#: ``torch.*`` calls that return host values, not tensors.
_HOST_VALUED_PREFIXES = (
    "torch.cuda.", "torch.device", "torch.Size", "torch.finfo", "torch.iinfo",
    "torch.is_", "torch.get_", "torch.are_", "torch.distributed.",
    "torch.backends.", "torch.no_grad", "torch.enable_grad",
    "torch.inference_mode", "torch.set_", "torch.jit.", "torch.profiler.",
    "torch.autograd.profiler.", "torch.utils.", "torch.Generator",
    "torch.manual_seed", "torch.promote_types", "torch.result_type",
    "torch.can_cast",
)

#: numpy namespaces: their calls make host values.
_NUMPY_ROOTS = frozenset({"np", "numpy", "onp"})

#: Decorators that memoise a function: it runs once, not per step, so
#: hot-ness does not flow into it (a kernel library loader behind
#: ``functools.cache`` is the case).
_CACHE_DECORATORS = frozenset({"lru_cache", "cache", "cached_property"})

#: Attribute reads that hand back tensors.
_TENSOR_ATTRS = frozenset({"saved_tensors", "grad", "data", "T", "mT"})

#: Tensor methods whose result is a tensor: called on a name that may
#: hold one (a parameter of a hot step), they make a tensor.
_TENSOR_METHODS = frozenset(
    {"sum", "mean", "prod", "max", "min", "amax", "amin", "any", "all", "norm",
     "abs", "eq", "ne", "gt", "lt", "ge", "le", "isfinite", "isnan", "isinf",
     "logical_and", "logical_or", "logical_not", "count_nonzero", "float",
     "double", "long", "int", "bool", "half", "bfloat16", "to", "clone",
     "detach", "contiguous", "reshape", "view", "flatten", "squeeze",
     "unsqueeze", "exp", "log", "sqrt", "sigmoid", "softmax", "argmax", "argmin"}
)

#: Names a hot step's receiver carries (never a tensor).
_RECEIVERS = ("self", "cls", "ctx")

#: Keyword arguments of hot entries that carry settings, not callables.
_SPEC_KWARGS = frozenset(
    {
        "mode", "backend", "fullgraph", "dynamic", "options", "disable",
        "in_dims", "out_dims", "randomness", "chunk_size", "argnums",
        "has_aux", "use_reentrant", "preserve_rng_state", "context_fn",
        "determinism_check", "debug", "num_warmup_iters",
        "allow_unused_input", "pool", "sample_args", "sample_kwargs",
        "example_inputs", "check_trace", "strict", "segments",
        "stream", "capture_error_mode",
    }
)


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


def _dotted_root(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def hot_entry_of(func: ast.AST) -> Optional[str]:
    """The hot entry a call of `func` is ('torch.compile', 'torch.func.vmap',
    ...), or None."""
    dotted = _dotted(func)
    if dotted is None:
        return None
    if dotted in HOT_ENTRY_CALLS:
        return dotted
    parts = dotted.split(".")
    if len(parts) >= 2 and parts[-2] == "func" and parts[-1] in FUNC_TRANSFORMS:
        return dotted
    return None


def capture_call_of(func: ast.AST) -> Optional[str]:
    """The capture construction a call of `func` is, or None."""
    dotted = _dotted(func)
    return dotted if dotted in CAPTURE_CALLS else None


def _host_valued_call(dotted: Optional[str]) -> bool:
    return bool(dotted) and dotted.startswith(_HOST_VALUED_PREFIXES)


def _annotation_is_tensor(annotation: Optional[ast.AST]) -> bool:
    if annotation is None:
        return False
    return "Tensor" in ast.unparse(annotation)


def _annotation_is_host(annotation: Optional[ast.AST]) -> bool:
    """An annotation that names no tensor (``bool``, ``int``,
    ``Optional[float]``, ``Ring``, ...): the parameter holds a host value."""
    if annotation is None:
        return False
    text = ast.unparse(annotation)
    return "Tensor" not in text and "Any" not in text


@dataclass
class FunctionInfo:
    """One def/lambda plus enough context to resolve its references."""

    qualname: str
    name: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    lineno: int
    params: Tuple[str, ...]
    self_class: Optional[str]  # class providing `self` inside the body
    is_method: bool  # defined directly in a class body
    parent_function: Optional[str]  # nearest enclosing function qualname
    decorators: Tuple[ast.AST, ...] = ()

    @property
    def data_params(self) -> Tuple[str, ...]:
        """Parameters excluding the self/cls/ctx receiver."""
        if self.params and self.params[0] in _RECEIVERS and (
            self.is_method or self.params[0] == "ctx"
        ):
            return self.params[1:]
        return self.params

    def arg_nodes(self) -> List[ast.arg]:
        node = self.node
        args = node.args
        return list(args.posonlyargs + args.args + args.kwonlyargs)

    def tensor_params(self) -> Set[str]:
        """Data parameters that may hold tensors: all of them but those
        annotated with a host type or defaulting to a bool/str/number."""
        defaults: Dict[str, ast.AST] = {}
        args = self.node.args
        plain = args.posonlyargs + args.args
        for arg, default in zip(plain[len(plain) - len(args.defaults):], args.defaults):
            defaults[arg.arg] = default
        for arg, default in zip(args.kwonlyargs, args.kw_defaults):
            if default is not None:
                defaults[arg.arg] = default
        out = set()
        data = set(self.data_params)
        for arg in self.arg_nodes():
            if arg.arg not in data or _annotation_is_host(arg.annotation):
                continue
            default = defaults.get(arg.arg)
            if isinstance(default, ast.Constant) and isinstance(
                default.value, (bool, str, int, float)
            ):
                continue
            out.add(arg.arg)
        return out


@dataclass
class CaptureSite:
    """One ``torch.compile(...)`` / graph-capture construction: the port's
    counterpart of JAX's ``JitSite``."""

    node: ast.AST  # the Call (or the decorator)
    entry: str  # dotted name of the construction
    enclosing_function: Optional[str]  # qualname of the fn holding it
    in_loop: bool
    is_decorator: bool = False


class _Scope:
    __slots__ = ("qualname", "functions")

    def __init__(self, qualname: str):
        self.qualname = qualname
        self.functions: Dict[str, str] = {}  # local name -> func qualname


@dataclass
class _Ctx:
    """Lexical context threaded through the walk."""

    scopes: List[_Scope]
    class_qualname: Optional[str]  # non-None only directly inside a class
    self_class: Optional[str]  # nearest method-owning class (for self.X)
    function: Optional[str]  # enclosing function qualname
    loop_depth: int = 0
    capture_depth: int = 0  # inside `with torch.cuda.graph(...)`

    def replace(self, **kw) -> "_Ctx":
        data = dict(
            scopes=self.scopes,
            class_qualname=self.class_qualname,
            self_class=self.self_class,
            function=self.function,
            loop_depth=self.loop_depth,
            capture_depth=self.capture_depth,
        )
        data.update(kw)
        return _Ctx(**data)


class TracedIndex:
    """Per-file hot-ness database.  Build with `traced_index(source)`."""

    def __init__(self, source: SourceFile):
        self.source = source
        self.functions: Dict[str, FunctionInfo] = {}
        self.by_node: Dict[int, FunctionInfo] = {}  # id(node) -> info
        self.traced: Dict[str, str] = {}  # qualname -> reason it is hot
        self.capture_sites: List[CaptureSite] = []
        #: class qualname -> 'module' / 'function' for nn.Module and
        #: autograd.Function subclasses of this file
        self.class_kinds: Dict[str, str] = {}
        self._class_bases: Dict[str, List[ast.AST]] = {}
        self._refs: Dict[str, Set[str]] = {}  # qualname -> referenced fns
        self._class_methods: Dict[str, Dict[str, str]] = {}
        self._pending_entry_calls: List[Tuple[ast.Call, _Ctx]] = []
        self._pending_capture_calls: List[Tuple[ast.Call, _Ctx]] = []
        self._pending_refs: List[Tuple[str, _Ctx]] = []
        self._module_scope = _Scope("")
        self._build()

    # -- public API ----------------------------------------------------

    def is_traced(self, fn) -> bool:
        info = fn if isinstance(fn, FunctionInfo) else self.by_node.get(id(fn))
        return bool(info) and info.qualname in self.traced

    def mark_traced(self, qualname: str, reason: str) -> bool:
        """Mark `qualname` hot with `reason`; True when newly marked (the
        whole-program index extends the closure across modules).  A
        memoised function is never marked: it runs once, not per step."""
        if qualname in self.traced or self.is_cached(qualname):
            return False
        self.traced[qualname] = reason
        return True

    def mark_hot(self, qualname: str, reason: str) -> List[str]:
        """`mark_traced`, then this file's closure from `qualname` (the
        functions its body references, such as a kernel body handed to
        ``autograd.Function.apply``).  -> every newly marked qualname, so
        the whole-program index follows their calls too."""
        if not self.mark_traced(qualname, reason):
            return []
        marked, worklist = [qualname], [qualname]
        while worklist:
            current = worklist.pop()
            for ref in self._refs.get(current, ()):
                if self.mark_traced(ref, f"called from hot {current}"):
                    marked.append(ref)
                    worklist.append(ref)
        return marked

    def is_cached(self, qualname: str) -> bool:
        """`qualname` carries a memoising decorator (``functools.cache``)."""
        info = self.functions.get(qualname)
        if info is None:
            return False
        for deco in info.decorators:
            for sub in ast.walk(deco):
                dotted = _dotted(sub)
                if dotted and dotted.split(".")[-1] in _CACHE_DECORATORS:
                    return True
        return False

    def traced_infos(self) -> Iterator[FunctionInfo]:
        for qualname, info in self.functions.items():
            if qualname in self.traced:
                yield info

    def reason(self, qualname: str) -> str:
        return self.traced.get(qualname, "")

    def function_at(self, line: int) -> Optional[FunctionInfo]:
        """The innermost def/lambda whose body spans `line`."""
        best: Optional[FunctionInfo] = None
        for info in self.functions.values():
            node = info.node
            first = min([node.lineno] + [d.lineno for d in info.decorators])
            last = node.end_lineno or node.lineno
            if first <= line <= last and (
                best is None or node.lineno >= best.node.lineno
            ):
                best = info
        return best

    def own_body(self, info: FunctionInfo) -> Iterator[ast.AST]:
        """Walk a function's body, NOT descending into nested defs or
        lambdas (those are separate FunctionInfos, hot or not)."""
        body = info.node.body
        if not isinstance(body, list):  # Lambda
            body = [body]
        stack: List[ast.AST] = list(body)
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                stack.append(child)

    # -- taint (intraprocedural symbol pass) ---------------------------

    def array_tainted_names(self, info: FunctionInfo) -> Set[str]:
        """Names in `info`'s body that (may) hold tensors: JAX's taint,
        seeded with the parameters that may hold tensors."""
        return self._fixpoint(info, set(info.tensor_params()), self.expr_tainted)

    def tensor_names(self, info: FunctionInfo) -> Set[str]:
        """Names bound to the result of a tensor operation (and
        parameters annotated as tensors): what ``if`` must not test."""
        seeded = {
            arg.arg for arg in info.arg_nodes()
            if arg.arg in info.data_params and _annotation_is_tensor(arg.annotation)
        }
        params = info.tensor_params()
        return self._fixpoint(
            info, seeded, lambda expr, tensors: self.expr_is_tensor(expr, tensors, params))

    def _fixpoint(self, info: FunctionInfo, tainted: Set[str], test) -> Set[str]:
        # Two passes reach a fixpoint for straight-line code and the
        # simple re-assignment chains that occur in step functions.
        for _ in range(2):
            for node in self.own_body(info):
                targets: List[ast.AST] = []
                value: Optional[ast.AST] = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.AugAssign):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.For):
                    targets, value = [node.target], node.iter
                if value is None or not test(value, tainted):
                    continue
                for target in targets:
                    for name_node in ast.walk(target):
                        if isinstance(name_node, ast.Name):
                            tainted.add(name_node.id)
        return tainted

    def expr_tainted(self, expr: ast.AST, tainted: Set[str]) -> bool:
        """True when `expr` (may) evaluate to a tensor: it mentions a
        tainted name or a tensor-producing call, outside of static
        accessors (`x.shape`, `x.size()`, `len(x)`, ...)."""
        for node in self._walk_non_static(expr):
            if isinstance(node, ast.Name) and node.id in tainted:
                return True
            if isinstance(node, ast.Call):
                if self._tensor_call(node):
                    return True
        return False

    def expr_is_tensor(self, expr: ast.AST, tensors: Set[str],
                       params: Set[str] = frozenset()) -> bool:
        """The strict test: `expr` reads a tensor-bound name or makes a
        tensor (a ``torch.*`` op, or a tensor method such as ``.sum()``
        on a name in `tensors` or `params`), outside static accessors,
        identity tests (``x is None``) and calls that are neither (their
        result is opaque: ``all(...)``, ``helper(x)``)."""
        for node in self._walk_non_static(expr, strict=True):
            if isinstance(node, ast.Name) and node.id in tensors:
                return True
            if isinstance(node, ast.Attribute) and node.attr in _TENSOR_ATTRS:
                return True
            if isinstance(node, ast.Call) and self._namespace_call(node):
                return True
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _TENSOR_METHODS
                and _dotted_root(node.func.value) in (tensors | params)
            ):
                return True
        return False

    @staticmethod
    def _namespace_call(node: ast.Call) -> bool:
        dotted = _dotted(node.func)
        return _dotted_root(node.func) in ARRAY_NAMESPACES and not _host_valued_call(dotted)

    def _tensor_call(self, node: ast.Call) -> bool:
        if self._namespace_call(node):
            return True
        resolved = self._resolve_loose(node.func)
        return resolved is not None and resolved in self.traced

    @staticmethod
    def _walk_non_static(expr: ast.AST, strict: bool = False) -> Iterator[ast.AST]:
        """Walk an expression, pruning static-accessor subtrees
        (`x.shape[0]` contributes nothing to tensor taint); with `strict`
        also host builtins (``int(n)``) and identity/membership tests."""
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
                continue
            if isinstance(node, ast.Call):
                root = _dotted_root(node.func)
                if root in _NUMPY_ROOTS:
                    continue  # numpy makes host values
                if strict and not (
                    root in ARRAY_NAMESPACES
                    or isinstance(node.func, ast.Attribute) and root not in _RECEIVERS
                ):
                    continue  # an opaque call: its result is no tensor
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                if node.func.id == "len":
                    continue
                if (
                    node.func.id == "getattr"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and node.args[1].value in STATIC_ATTRS
                ):
                    continue
            if strict and isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in node.ops
            ):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    # -- construction --------------------------------------------------

    def _build(self):
        ctx = _Ctx(
            scopes=[self._module_scope],
            class_qualname=None,
            self_class=None,
            function=None,
        )
        for stmt in self.source.tree.body:
            self._visit(stmt, ctx)
        self._classify_classes()
        self._mark_class_roots()
        self._mark_marker_roots()
        self._mark_decorator_roots()
        self._mark_entry_call_roots()
        self._close_transitively()

    def _visit(self, node: ast.AST, ctx: _Ctx):
        if isinstance(node, ast.ClassDef):
            qualname = self._child_qualname(ctx, node.name)
            self._class_methods.setdefault(qualname, {})
            self._class_bases[qualname] = list(node.bases)
            for deco in node.decorator_list:
                self._visit(deco, ctx)
            inner = ctx.replace(class_qualname=qualname, self_class=qualname)
            for stmt in node.body:
                self._visit(stmt, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            self._register_function(node, ctx)
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            body_nodes = set(map(id, list(node.body) + list(node.orelse)))
            loop_ctx = ctx.replace(loop_depth=ctx.loop_depth + 1)
            for child in ast.iter_child_nodes(node):
                self._visit(child, loop_ctx if id(child) in body_nodes else ctx)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            captured = any(
                isinstance(item.context_expr, ast.Call)
                and _dotted(item.context_expr.func) in _GRAPH_CONTEXTS
                for item in node.items
            )
            for item in node.items:
                self._visit(item.context_expr, ctx)
                if item.optional_vars is not None:
                    self._visit(item.optional_vars, ctx)
            body_ctx = (
                ctx.replace(capture_depth=ctx.capture_depth + 1) if captured else ctx
            )
            for stmt in node.body:
                self._visit(stmt, body_ctx)
            return
        if isinstance(node, ast.Assign):
            self._note_alias(node, ctx)
        if isinstance(node, ast.Call):
            if hot_entry_of(node.func) is not None:
                self._pending_entry_calls.append((node, ctx))
            if ctx.capture_depth > 0:
                self._pending_capture_calls.append((node, ctx))
            entry = capture_call_of(node.func)
            if entry is not None:
                self.capture_sites.append(CaptureSite(
                    node=node, entry=entry, enclosing_function=ctx.function,
                    in_loop=ctx.loop_depth > 0,
                ))
        for child in ast.iter_child_nodes(node):
            self._visit(child, ctx)

    def _child_qualname(self, ctx: _Ctx, name: str) -> str:
        parent = ctx.class_qualname or ctx.scopes[-1].qualname
        return f"{parent}.{name}" if parent else name

    def _register_function(self, node, ctx: _Ctx):
        if isinstance(node, ast.Lambda):
            name = f"<lambda:{node.lineno}:{node.col_offset}>"
            decorators: Tuple[ast.AST, ...] = ()
            params = tuple(a.arg for a in node.args.args)
        else:
            name = node.name
            decorators = tuple(node.decorator_list)
            params = tuple(
                a.arg
                for a in (
                    node.args.posonlyargs
                    + node.args.args
                    + node.args.kwonlyargs
                )
            )
        qualname = self._child_qualname(ctx, name)
        if qualname in self.functions:  # redefinition / lambda collision
            qualname = f"{qualname}@{node.lineno}"
        is_method = ctx.class_qualname is not None and not isinstance(
            node, ast.Lambda
        )
        info = FunctionInfo(
            qualname=qualname,
            name=name,
            node=node,
            lineno=node.lineno,
            params=params,
            self_class=ctx.self_class,
            is_method=is_method,
            parent_function=ctx.function,
            decorators=decorators,
        )
        self.functions[qualname] = info
        self.by_node[id(node)] = info
        if not isinstance(node, ast.Lambda):
            if is_method:
                # Methods are visible as `self.<name>`, NOT as bare names
                # in enclosing scopes.
                self._class_methods[ctx.class_qualname].setdefault(
                    name, qualname
                )
            else:
                ctx.scopes[-1].functions.setdefault(name, qualname)
        # Decorators and default values evaluate in the ENCLOSING scope.
        for deco in decorators:
            self._visit(deco, ctx)
        if not isinstance(node, ast.Lambda):
            for default in node.args.defaults + [
                d for d in node.args.kw_defaults if d is not None
            ]:
                self._visit(default, ctx)
        inner_scope = _Scope(qualname)
        body_ctx = _Ctx(
            scopes=ctx.scopes + [inner_scope],
            class_qualname=None,
            self_class=ctx.self_class,
            function=qualname,
        )
        body = node.body if isinstance(node.body, list) else [node.body]
        for stmt in body:
            self._visit(stmt, body_ctx)
        self._refs[qualname] = set()
        self._pending_refs.append((qualname, body_ctx))

    def _note_alias(self, node: ast.Assign, ctx: _Ctx):
        """``fn = partial(step_fn, ...)`` / ``fn = step_fn``: a function
        alias, so ``torch.compile(fn)`` resolves to the real step."""
        if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
            return
        value = node.value
        aliased = None
        if (
            isinstance(value, ast.Call)
            and (_dotted(value.func) or "").split(".")[-1] == "partial"
            and value.args
        ):
            aliased = self._resolve_ref(value.args[0], ctx)
        elif isinstance(value, (ast.Name, ast.Attribute)):
            aliased = self._resolve_ref(value, ctx)
        if aliased:
            ctx.scopes[-1].functions[node.targets[0].id] = aliased

    # -- resolution ----------------------------------------------------

    def _resolve_ref(self, node: ast.AST, ctx: _Ctx) -> Optional[str]:
        """Resolve a Name / self.X / lambda reference to a known function."""
        if isinstance(node, ast.Lambda):
            info = self.by_node.get(id(node))
            return info.qualname if info else None
        if isinstance(node, ast.Name):
            for scope in reversed(ctx.scopes):
                if node.id in scope.functions:
                    return scope.functions[node.id]
            return None
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("self", "cls")
            and ctx.self_class is not None
        ):
            return self._class_methods.get(ctx.self_class, {}).get(node.attr)
        return None

    def _resolve_loose(self, node: ast.AST) -> Optional[str]:
        """Best-effort resolution without lexical context (module scope +
        any class) — used only by the taint pass."""
        if isinstance(node, ast.Name):
            return self._module_scope.functions.get(node.id)
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("self", "cls")
        ):
            for methods in self._class_methods.values():
                if node.attr in methods:
                    return methods[node.attr]
        return None

    # -- root marking + closure ----------------------------------------

    def _classify_classes(self):
        """nn.Module and autograd.Function subclasses, through bases
        defined earlier in the same file."""
        changed = True
        while changed:
            changed = False
            for qualname, bases in self._class_bases.items():
                if qualname in self.class_kinds:
                    continue
                for base in bases:
                    dotted = _dotted(base) or ""
                    kind = None
                    if dotted.split(".")[-1] == "Module":
                        kind = "module"
                    elif dotted.endswith("autograd.Function") or dotted == "Function":
                        kind = "function"
                    else:
                        kind = self.class_kinds.get(dotted)
                    if kind:
                        self.class_kinds[qualname] = kind
                        changed = True
                        break

    def _mark_class_roots(self):
        for class_qualname, kind in self.class_kinds.items():
            methods = self._class_methods.get(class_qualname, {})
            names = ("forward",) if kind == "module" else ("forward", "backward")
            what = "nn.Module" if kind == "module" else "torch.autograd.Function"
            for name in names:
                qualname = methods.get(name)
                if qualname:
                    self.traced.setdefault(
                        qualname, f"{name} of the {what} {class_qualname}"
                    )

    def _mark_marker_roots(self):
        for info in self.functions.values():
            if isinstance(info.node, ast.Lambda):
                continue
            comment = self.source.comments.get(info.lineno, "")
            if _HOT_MARKER_RE.search(comment):
                self.traced.setdefault(
                    info.qualname, f"marked # {HOT_MARKER} (line {info.lineno})"
                )

    def _mark_decorator_roots(self):
        for info in self.functions.values():
            for deco in info.decorators:
                for sub in ast.walk(deco):
                    dotted = _dotted(sub)
                    if dotted in _HOT_DECORATORS:
                        self.traced.setdefault(
                            info.qualname,
                            f"decorated @{dotted} (line {info.lineno})",
                        )
                        self.capture_sites.append(CaptureSite(
                            node=deco, entry=dotted,
                            enclosing_function=info.parent_function,
                            in_loop=False, is_decorator=True,
                        ))

    def _mark_entry_call_roots(self):
        for call, ctx in self._pending_entry_calls:
            entry = hot_entry_of(call.func) or "a hot entry"
            arg_exprs: List[ast.AST] = list(call.args) + [
                kw.value for kw in call.keywords if kw.arg not in _SPEC_KWARGS
            ]
            for expr in arg_exprs:
                for sub in ast.walk(expr):
                    if isinstance(sub, (ast.Name, ast.Attribute, ast.Lambda)):
                        resolved = self._resolve_ref(sub, ctx)
                        if resolved:
                            self.traced.setdefault(
                                resolved, f"passed to {entry}() at line {call.lineno}"
                            )
        for call, ctx in self._pending_capture_calls:
            resolved = self._resolve_ref(call.func, ctx)
            if resolved:
                self.traced.setdefault(
                    resolved, f"called under torch.cuda.graph at line {call.lineno}"
                )

    def _close_transitively(self):
        for qualname, body_ctx in self._pending_refs:
            refs = self._refs[qualname]
            info = self.functions[qualname]
            for sub in self.own_body(info):
                if isinstance(sub, (ast.Name, ast.Attribute, ast.Lambda)):
                    resolved = self._resolve_ref(sub, body_ctx)
                    if resolved and resolved != qualname:
                        refs.add(resolved)
        worklist = list(self.traced)
        while worklist:
            current = worklist.pop()
            for ref in self._refs.get(current, ()):
                if self.mark_traced(ref, f"called from hot {current or '<module>'}"):
                    worklist.append(ref)


def traced_index(source: SourceFile) -> TracedIndex:
    """The (memoized) TracedIndex for a SourceFile — every hot-path rule
    shares one index per file."""
    index = getattr(source, "_traced_index", None)
    if index is None or index.source is not source:
        index = TracedIndex(source)
        source._traced_index = index
    return index
