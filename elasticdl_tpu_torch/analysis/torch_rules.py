"""Hot-path hygiene rules for the port's device step (PyTorch/CUDA).

The port's counterpart of ``elasticdl_tpu/analysis/jax_rules.py``: the
same six rule names, each holding the port's eager steps to the contract
its JAX rule holds the compiled ones to.  They sit on the hot-ness core
in ``analysis/traced.py``: every rule asks "does this statement run on
the device step?" (a ``# hot-path`` step, an ``nn.Module.forward``, an
``autograd.Function``, or what they call).

Rules
-----
jit-host-sync        no ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                     ``.numpy()`` / ``.to("cpu")``, ``float/int/bool()``
                     of a tensor, ``if`` on a tensor, ``np.asarray`` of a
                     tensor, ``print``, ``*.synchronize()``, an op whose
                     output size depends on the data (``nonzero``,
                     ``unique``, ``masked_select``, ...), or a blocking
                     copy of host data to the card
                     (``torch.from_numpy(a).to(dev)``,
                     ``torch.as_tensor(a, device=dev)``) on a hot path —
                     each one stops the host until the card drains.
retrace-hazard       no ``torch.compile`` / CUDA graph capture built in a
                     loop or a hot (per-step) function, and no kernel
                     library build reached from a hot function except
                     behind its module-level cache (``functools.cache``).
donation-discipline  a hot step updates its state in place (no per-step
                     rebind of a fresh full table or optimizer slot), and
                     host code reads no alias of a tensor taken before an
                     in-place update of it.
async-staging-discipline
                     a host buffer copied with ``non_blocking=True`` is not
                     written by host code before the copy's stream is
                     synchronised or recorded.
trace-purity         no obs registry/journal calls, file IO or lock
                     acquisition on a hot path.
sharding-coverage    on the multi-device path (``parallel/``, or a file
                     carrying ``# multi-device-path``), every collective
                     names its mesh and axis, and no collective reaches
                     the default world group implicitly.

Stdlib-only, like the rest of the analyzer.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from elasticdl_tpu_torch.analysis.core import SourceFile, Violation
from elasticdl_tpu_torch.analysis.traced import (
    FunctionInfo,
    TracedIndex,
    traced_index,
)

# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    """'x' for x / x.a.b / x[i].c chains."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _violation(rule: str, source: SourceFile, node: ast.AST, message: str
               ) -> Violation:
    return Violation(
        rule=rule,
        path=source.path,
        line=getattr(node, "lineno", 0),
        col=getattr(node, "col_offset", 0),
        message=message,
    )


def _where(index: TracedIndex, info: FunctionInfo) -> str:
    """'in `f` (hot: <reason>)' context suffix for messages."""
    return f"in `{info.name}` (hot: {index.reason(info.qualname)})"


def _pos(node: ast.AST) -> Tuple[int, int]:
    return (node.lineno, node.col_offset)


def _end(node: ast.AST) -> Tuple[int, int]:
    return (node.end_lineno or node.lineno, node.end_col_offset or node.col_offset)


# ---------------------------------------------------------------------------
# Rule: jit-host-sync
# ---------------------------------------------------------------------------

#: numpy namespaces whose array constructors copy a tensor to the host.
_NP_ROOTS = frozenset({"np", "numpy", "onp"})
_NP_SYNC_FNS = frozenset({"asarray", "array", "copy"})

#: Tensor methods that read device memory on the host (no arguments).
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: Constructors of a host tensor from host data: copied to the card
#: without ``non_blocking=True``, the copy from pageable memory blocks
#: the host until the card has it (the sync the census saw on the
#: serving dispatch).
_HOST_TENSOR_CALLS = frozenset(
    {"torch.from_numpy", "torch.as_tensor", "torch.tensor", "torch.asarray"}
)

#: Ops whose output size depends on the data: the host waits for the
#: count before it can allocate the result.
_DATA_DEPENDENT_OPS = frozenset(
    {"nonzero", "argwhere", "unique", "unique_consecutive", "masked_select",
     "bincount"}
)


def _is_cpu_target(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (
        isinstance(node, ast.Call)
        and (_dotted(node.func) or "").endswith("device")
        and bool(node.args)
        and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "cpu"
    )


def _blocking_upload(node: ast.Call, dotted: Optional[str]) -> bool:
    """A copy of host data to the card that is not ``non_blocking``:
    ``torch.from_numpy(a).to(dev)`` / ``.cuda()``, or
    ``torch.as_tensor(a, device=dev)`` with a device other than the CPU."""
    if any(kw.arg == "non_blocking" for kw in node.keywords):
        return False
    func = node.func
    if (
        isinstance(func, ast.Attribute)
        and func.attr in ("to", "cuda")
        and isinstance(func.value, ast.Call)
        and _dotted(func.value.func) in _HOST_TENSOR_CALLS
        and not any(_is_cpu_target(a) for a in node.args)
    ):
        return True
    if dotted in _HOST_TENSOR_CALLS:
        device = next((kw.value for kw in node.keywords if kw.arg == "device"), None)
        return device is not None and not _is_cpu_target(device)
    return False


def _sync_call(node: ast.Call, index: TracedIndex, tainted: Set[str]) -> Optional[str]:
    """Why `node` synchronises the host with the card, or None."""
    func = node.func
    dotted = _dotted(func)
    last = dotted.split(".")[-1] if dotted else (
        func.attr if isinstance(func, ast.Attribute) else None
    )
    if _blocking_upload(node, dotted):
        return "a copy of host data to the card without non_blocking"
    if isinstance(func, ast.Attribute):
        if func.attr in _SYNC_METHODS and not node.args and not node.keywords:
            return f".{func.attr}() reads device memory on the host"
        if func.attr == "to" and (
            any(_is_cpu_target(a) for a in node.args)
            or any(kw.arg == "device" and _is_cpu_target(kw.value)
                   for kw in node.keywords)
        ):
            return '.to("cpu") copies device memory to the host'
        if func.attr == "synchronize":
            return f"{dotted or '.synchronize'}() waits for the card"
        if func.attr == "block_until_ready":
            return ".block_until_ready() waits for the card"
    if isinstance(func, ast.Name) and func.id == "print":
        return "print(...) formats values on the host"
    if (
        isinstance(func, ast.Name)
        and func.id in ("float", "int", "bool")
        and len(node.args) == 1
        and index.expr_tainted(node.args[0], tainted)
    ):
        return f"{func.id}(...) of a tensor reads it on the host"
    if (
        dotted
        and dotted.split(".")[0] in _NP_ROOTS
        and last in _NP_SYNC_FNS
        and any(index.expr_tainted(arg, tainted) for arg in node.args)
    ):
        return f"{dotted}(...) of a tensor copies it to the host"
    if last in _DATA_DEPENDENT_OPS:
        return f"{last}(...) sizes its output from the data"
    if last == "where" and len(node.args) == 1 and not node.keywords:
        return "where(cond) with one argument sizes its output from the data"
    if last == "repeat_interleave" and not any(
        kw.arg == "output_size" for kw in node.keywords
    ) and (len(node.args) >= 2 or isinstance(func, ast.Attribute) and node.args):
        return "repeat_interleave(...) without output_size sizes its output from the data"
    return None


def check_jit_host_sync(source: SourceFile) -> List[Violation]:
    """No host syncs (reads, truth tests, uploads, synchronize) on a hot path.

    .item()/.cpu()/float()/if on a tensor/np.asarray/print/synchronize,
    data-sized ops, blocking uploads of host data."""
    index = traced_index(source)
    violations: List[Violation] = []
    for info in index.traced_infos():
        tainted = index.array_tainted_names(info)
        tensors = index.tensor_names(info)
        params = info.tensor_params()
        for node in index.own_body(info):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                if index.expr_is_tensor(node.test, tensors, params):
                    violations.append(_violation(
                        "jit-host-sync", source, node.test,
                        f"truth value of a tensor {_where(index, info)} — "
                        "branching on device data waits for the card every "
                        "step; keep the decision on the device "
                        "(torch.where) or read it outside the step",
                    ))
                continue
            if not isinstance(node, ast.Call):
                continue
            why = _sync_call(node, index, tainted)
            if why is not None:
                violations.append(_violation(
                    "jit-host-sync", source, node,
                    f"{why} {_where(index, info)} — a host sync inside "
                    "the device step stalls the launch queue every step; "
                    "return the tensor and read it on the host side of "
                    "the step",
                ))
    return violations


# ---------------------------------------------------------------------------
# Rule: retrace-hazard
# ---------------------------------------------------------------------------

#: Method names that run once per training step: building a compiled
#: callable there recompiles per call.
_PER_STEP_NAME_RE = re.compile(r"(^|_)step$|^step_")

#: Calls that build or load a kernel library.
_BUILD_CALLS = frozenset(
    {"cpp_extension.load", "cpp_extension.load_inline",
     "torch.utils.cpp_extension.load", "torch.utils.cpp_extension.load_inline",
     "load_inline", "ctypes.CDLL", "CDLL", "ctypes.cdll.LoadLibrary",
     "triton.compile"}
)


def _direct_build(call: ast.Call) -> Optional[str]:
    dotted = _dotted(call.func)
    if dotted in _BUILD_CALLS:
        return f"{dotted}()"
    if dotted and dotted.startswith("subprocess."):
        return f"{dotted}()"
    return None


def check_retrace_hazard(source: SourceFile) -> List[Violation]:
    """No compile/graph capture in a loop or hot function; no uncached kernel build.

    A kernel library build reached from a hot function is allowed only
    behind its module-level cache (functools.cache)."""
    index = traced_index(source)
    violations: List[Violation] = []

    for site in index.capture_sites:
        if site.in_loop:
            violations.append(_violation(
                "retrace-hazard", source, site.node,
                f"{site.entry}(...) constructed inside a loop — every "
                "iteration builds a fresh compiled/captured callable (a "
                "recompile or re-capture per step); hoist construction out "
                "of the loop and reuse it",
            ))
            continue
        if site.enclosing_function and not site.is_decorator:
            enclosing = index.functions.get(site.enclosing_function)
            if enclosing is None:
                continue
            if enclosing.qualname in index.traced or _PER_STEP_NAME_RE.search(
                enclosing.name
            ):
                violations.append(_violation(
                    "retrace-hazard", source, site.node,
                    f"{site.entry}(...) constructed inside per-step "
                    f"function `{enclosing.name}` — compiled and captured "
                    "callables must be built once (init time) and reused; "
                    "rebuilding per step recompiles per step",
                ))

    # Hot-ness does not flow into a memoised function (traced.py), so a
    # build behind functools.cache runs once and is never flagged here.
    for info in index.traced_infos():
        for node in index.own_body(info):
            if not isinstance(node, ast.Call):
                continue
            prim = _direct_build(node)
            if prim is not None:
                violations.append(_violation(
                    "retrace-hazard", source, node,
                    f"kernel library build ({prim}) {_where(index, info)} "
                    "— a build or load per step costs seconds; keep it "
                    "behind a module-level cache (functools.cache) and call "
                    "the cached loader",
                ))
    return violations


# ---------------------------------------------------------------------------
# Rule: donation-discipline
# ---------------------------------------------------------------------------

#: Attribute names holding a step's state: a dict of tables / slots /
#: params (rebinding an entry is a fresh tensor) or the tensor itself.
_STATE_DICT_RE = re.compile(r"(^|_)(state|opt_state|params|tables|slots|weights|buffers)$")
_STATE_TENSOR_RE = re.compile(
    r"(^|_)(state|opt_state|params|tables?|slots?|embedding|weights?)$"
)


def _state_rebind(target: ast.AST) -> Optional[str]:
    """The state attribute a store to `target` rebinds, or None."""
    if isinstance(target, ast.Subscript) and isinstance(target.value, ast.Attribute):
        if _STATE_DICT_RE.search(target.value.attr):
            return target.value.attr
        return None
    if isinstance(target, ast.Attribute) and _STATE_TENSOR_RE.search(target.attr):
        return target.attr
    return None


def check_donation_discipline(source: SourceFile) -> List[Violation]:
    """Hot steps update their state in place; no stale alias is read after an update.

    Host code reads no alias of a tensor taken before an in-place update
    of it."""
    index = traced_index(source)
    violations: List[Violation] = []

    for info in index.traced_infos():
        tainted = index.array_tainted_names(info)
        for node in index.own_body(info):
            if not isinstance(node, (ast.Assign, ast.AugAssign)):
                continue
            if isinstance(node, ast.AugAssign):
                continue  # `t += g` on a tensor is in place
            if not index.expr_tainted(node.value, tainted):
                continue
            for target in node.targets:
                attr = _state_rebind(target)
                if attr is None:
                    continue
                violations.append(_violation(
                    "donation-discipline", source, node,
                    f"hot step `{info.name}` rebinds state `{attr}` to a "
                    "freshly computed tensor — the old and the new copy are "
                    "both live across the update (double peak memory for "
                    "the table or optimizer slot) and every alias of the "
                    "old one goes stale; update it in place (copy_, add_, "
                    "index_add_ or the fused kernels)",
                ))

    for info in index.functions.values():
        if info.qualname in index.traced:
            continue
        _check_stale_alias(source, index, info, violations)
    return violations


def _update_root(node: ast.Call, index: TracedIndex, info: FunctionInfo) -> Optional[str]:
    """The root name whose tensors `node` updates in place: an in-place
    method (``x.add_(...)``) or a call of a hot step on that receiver."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    root = _root_name(func.value)
    if root is None:
        return None
    name = func.attr
    if name.endswith("_") and not name.startswith("_"):
        return root
    if root in ("self", "cls") and info.self_class is not None:
        resolved = index._class_methods.get(info.self_class, {}).get(name)
        if resolved is not None and resolved in index.traced:
            return root
    return None


def _check_stale_alias(source, index, info, violations):
    aliases: List[Tuple[Tuple[int, int], str, str]] = []  # (pos, alias, root)
    for node in index.own_body(info):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, (ast.Attribute, ast.Subscript))
            and not any(isinstance(sub, ast.Call) for sub in ast.walk(node.value))
        ):
            root = _root_name(node.value)
            if root is not None and root != node.targets[0].id:
                aliases.append((_end(node), node.targets[0].id, root))
    if not aliases:
        return
    updates: List[Tuple[ast.Call, str]] = []
    for node in index.own_body(info):
        if isinstance(node, ast.Call):
            root = _update_root(node, index, info)
            if root is not None:
                updates.append((node, root))
    names: Dict[str, List[Tuple[Tuple[int, int], bool, ast.Name]]] = {}
    for node in index.own_body(info):
        if isinstance(node, ast.Name):
            names.setdefault(node.id, []).append(
                (_pos(node), isinstance(node.ctx, (ast.Store, ast.Del)), node)
            )
    flagged: Set[str] = set()
    for call, root in sorted(updates, key=lambda u: _pos(u[0])):
        call_end = _end(call)
        for bound_at, alias, alias_root in aliases:
            if alias_root != root or alias in flagged or bound_at > _pos(call):
                continue
            events = sorted(e for e in names.get(alias, ()) if e[0] > bound_at)
            # Re-bound before the update: the alias is a new one.
            if any(e[1] and e[0] < _pos(call) for e in events):
                continue
            later = [e for e in events if e[0] > call_end]
            if later and not later[0][1]:
                flagged.add(alias)
                read = later[0][2]
                violations.append(_violation(
                    "donation-discipline", source, read,
                    f"`{alias}` aliases `{root}`'s tensor from before the "
                    f"in-place update at line {call.lineno} and is read "
                    "after it — it sees the updated values, not the ones "
                    "it was taken to keep; clone() it before the update or "
                    "read the state again",
                ))


# ---------------------------------------------------------------------------
# Rule: async-staging-discipline
# ---------------------------------------------------------------------------

#: Calls after which an asynchronous copy's source may be reused.
_SYNC_POINTS = frozenset({"synchronize", "record_stream"})


def _non_blocking(call: ast.Call) -> bool:
    return any(
        kw.arg == "non_blocking"
        and isinstance(kw.value, ast.Constant)
        and kw.value.value is True
        for kw in call.keywords
    )


def _staged_source(call: ast.Call) -> Optional[str]:
    """The host buffer a non-blocking copy reads, or None."""
    if not _non_blocking(call) or not isinstance(call.func, ast.Attribute):
        return None
    if call.func.attr == "copy_" and call.args:
        return _root_name(call.args[0])
    if call.func.attr in ("to", "cuda"):
        return _root_name(call.func.value)
    return None


def _writes(node: ast.AST, buffer: str) -> bool:
    """`node` writes into `buffer` in place."""
    if isinstance(node, ast.Assign):
        return any(
            isinstance(t, ast.Subscript) and _root_name(t) == buffer
            for t in node.targets
        )
    if isinstance(node, ast.AugAssign):
        return _root_name(node.target) == buffer
    if isinstance(node, ast.Call):
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr.endswith("_")
            and not func.attr.startswith("_")
            and _root_name(func.value) == buffer
        ):
            return True
        if _dotted(func) in ("np.copyto", "numpy.copyto") and node.args:
            return _root_name(node.args[0]) == buffer
    return False


def _sync_point(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr in _SYNC_POINTS:
        return True
    return node.func.attr == "record" and "event" in (_dotted(node.func.value) or "").lower()


def check_async_staging_discipline(source: SourceFile) -> List[Violation]:
    """A non_blocking copy's host buffer is not rewritten before a sync.

    The buffer stays untouched until the copy's stream is synchronised
    or recorded."""
    index = traced_index(source)
    violations: List[Violation] = []
    for info in index.functions.values():
        nodes = list(index.own_body(info))
        for call in nodes:
            if not isinstance(call, ast.Call):
                continue
            buffer = _staged_source(call)
            if buffer is None:
                continue
            call_end = _end(call)
            after = sorted(
                (n for n in nodes
                 if hasattr(n, "lineno") and _pos(n) > call_end),
                key=_pos,
            )
            for node in after:
                if _sync_point(node):
                    break
                if (
                    isinstance(node, ast.Name)
                    and node.id == buffer
                    and isinstance(node.ctx, ast.Store)
                ):
                    break  # re-bound: a new buffer
                if _writes(node, buffer):
                    violations.append(_violation(
                        "async-staging-discipline", source, node,
                        f"`{buffer}` is written after its non_blocking copy "
                        f"(line {call.lineno}) and before the copy's stream "
                        "is synchronised — the copy reads the buffer when "
                        "the stream reaches it, so the card may receive "
                        "the new contents; synchronise (or record an event "
                        "and wait on it) before reusing the buffer",
                    ))
                    break
    return violations


# ---------------------------------------------------------------------------
# Rule: trace-purity
# ---------------------------------------------------------------------------

#: Receiver-segment prefixes that identify the observability plane.
_OBS_HINTS = ("journal", "registry", "metric", "obs")


def _obs_receiver(dotted: str) -> Optional[str]:
    segments = dotted.split(".")
    for segment in segments[:-1]:
        bare = segment.lstrip("_").lower()
        if any(bare.startswith(hint) for hint in _OBS_HINTS):
            return segment
    return None


def _lock_name(expr: ast.AST) -> Optional[str]:
    for node in ast.walk(expr):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name and "lock" in name.lower():
            return name
    return None


def check_trace_purity(source: SourceFile) -> List[Violation]:
    """No obs/journal calls, file IO, or lock acquisition on a hot path."""
    index = traced_index(source)
    violations: List[Violation] = []
    for info in index.traced_infos():
        for node in index.own_body(info):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = _lock_name(item.context_expr)
                    if lock:
                        violations.append(_violation(
                            "trace-purity", source, node,
                            f"lock `{lock}` acquired {_where(index, info)} "
                            "— a lock on the device step serialises every "
                            "caller behind the card's queue and can stall "
                            "the step behind a control-plane reader; take "
                            "it outside the step",
                        ))
                continue
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and node.func.id == "open":
                violations.append(_violation(
                    "trace-purity", source, node,
                    f"open(...) {_where(index, info)} — file IO on the "
                    "device step stalls every step on the disk; do IO on "
                    "the host loop around the step",
                ))
                continue
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"
            ):
                violations.append(_violation(
                    "trace-purity", source, node,
                    f".acquire() {_where(index, info)} — lock acquisition "
                    "on the device step serialises it behind other "
                    "threads; synchronise on the host loop",
                ))
                continue
            dotted = _dotted(node.func)
            if dotted:
                receiver = _obs_receiver(dotted)
                if receiver:
                    violations.append(_violation(
                        "trace-purity", source, node,
                        f"obs-plane call {dotted}(...) {_where(index, info)}"
                        " — the metrics/journal plane takes locks and may "
                        "write files; emit from the host loop around the "
                        "step",
                    ))
    return violations


# ---------------------------------------------------------------------------
# Rule: sharding-coverage
# ---------------------------------------------------------------------------

#: Files on the multi-device path by location; any other file opts in
#: with a `# multi-device-path` comment.
_MULTI_DEVICE_PATH_FRAGMENT = "elasticdl_tpu_torch/parallel/"
_MULTI_DEVICE_MARKER = "multi-device-path"

#: The port's compile layer (parallel/compile.py): its helpers receive
#: their mesh and axes as arguments, so it is exempt, as the JAX
#: package's is.  Identified by path, or by the marker comment.
_COMPILE_LAYER_PATH_FRAGMENT = "elasticdl_tpu_torch/parallel/compile.py"
_COMPILE_LAYER_MARKER = "sharding-compile-layer"

#: torch.distributed collectives (each takes ``group=``).
_COLLECTIVES = frozenset(
    {"all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
     "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
     "all_to_all_single", "broadcast", "broadcast_object_list", "reduce",
     "gather", "gather_object", "scatter", "scatter_object_list", "barrier",
     "monitored_barrier", "send", "recv", "isend", "irecv"}
)
_DIST_PREFIXES = ("dist.", "torch.distributed.", "distributed.")

#: The mesh helpers: ``axis_<collective>(mesh, axis, ...)``.
_AXIS_HELPER_RE = re.compile(r"^axis_(all_reduce|all_gather|broadcast|reduce_scatter|all_to_all)")


def _on_multi_device_path(source: SourceFile) -> bool:
    normalized = source.path.replace("\\", "/")
    if _MULTI_DEVICE_PATH_FRAGMENT in normalized:
        return True
    return any(
        _MULTI_DEVICE_MARKER in comment
        for comment in source.comments.values()
    )


def _is_compile_layer(source: SourceFile) -> bool:
    normalized = source.path.replace("\\", "/")
    if normalized.endswith(_COMPILE_LAYER_PATH_FRAGMENT):
        return True
    return any(
        _COMPILE_LAYER_MARKER in comment
        for comment in source.comments.values()
    )


def check_sharding_coverage(source: SourceFile) -> List[Violation]:
    """Multi-device-path collectives name their group (mesh and axis).

    None reaches the default world group implicitly."""
    if not _on_multi_device_path(source) or _is_compile_layer(source):
        return []
    violations: List[Violation] = []
    for node in ast.walk(source.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func) or ""
        last = dotted.split(".")[-1]
        if dotted.startswith(_DIST_PREFIXES) and last in _COLLECTIVES:
            if any(kw.arg == "group" for kw in node.keywords):
                continue
            violations.append(_violation(
                "sharding-coverage", source, node,
                f"multi-device-path {dotted}(...) without group= — it runs "
                "over the default world group, whatever mesh the caller "
                "meant; pass the mesh axis's group (mesh.group(axis)) or "
                "call the axis_* helper with the mesh and axis",
            ))
        elif _AXIS_HELPER_RE.match(last):
            named = {kw.arg for kw in node.keywords}
            if len(node.args) + len(named & {"mesh", "axis"}) < 2:
                violations.append(_violation(
                    "sharding-coverage", source, node,
                    f"multi-device-path {last}(...) without its mesh and "
                    "axis — name both (axis_*(self._mesh, DATA_AXIS, ...)) "
                    "so the collective's group is explicit",
                ))
    return violations


# ---------------------------------------------------------------------------
# Registry (merged into rules.ALL_RULES)
# ---------------------------------------------------------------------------

TORCH_RULES = {
    "jit-host-sync": check_jit_host_sync,
    "retrace-hazard": check_retrace_hazard,
    "donation-discipline": check_donation_discipline,
    "async-staging-discipline": check_async_staging_discipline,
    "trace-purity": check_trace_purity,
    "sharding-coverage": check_sharding_coverage,
}
