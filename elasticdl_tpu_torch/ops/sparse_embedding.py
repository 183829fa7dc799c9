"""Sparse-embedding ops: the port of the Pallas kernels of
``elasticdl_tpu/ops/sparse_embedding.py``.  Three kernels, each a
hand-written CUDA kernel in ``csrc/sparse_embedding.cu``:

``fused_lookup``       ids ``[n]`` -> rows ``[n, dim]`` (replaces
                       ``_lookup_kernel``; the ``split_tables`` DeepFM
                       layout and the generic Embedding layer).
``fused_lookup_fm``    the DeepFM merged ``1+d`` lookup plus the FM partial
                       sums in one pass (replaces ``_fm_kernel``).
``fused_dedup_apply``  the one-pass sparse optimizer update: dedup the
                       ids, sum their grads, apply the slot math to each
                       touched row in place (replaces
                       ``_dedup_apply_kernel``).

Each public function checks its operands, then dispatches on the device
of the tensors it is given: on ``cuda`` it launches its kernel (or
raises), on ``cpu`` it runs its ``*_plain`` version, the PyTorch form the
tests hold against the JAX package and ``chip_smoke.py`` holds the
kernels against on the card.  Nothing falls back from the kernel to the
plain version.

The two lookups are differentiable (``torch.autograd.Function``), with
the JAX package's custom VJPs as their backward: ``_fm_bwd_math`` folds
every cotangent into one per-field activation cotangent (returned for
``bet``, the perturbation capture) and ``_lookup_bwd`` is a segment sum.
Both are XLA ops in the JAX package, not Pallas kernels, so the backward
is plain PyTorch here too.  The backward saves ``acts``, ids and
``valid``, never the table: ``fused_dedup_apply`` updates tables in place.

Sharded dispatch (the JAX package's ``shard_map`` route): each function
takes a keyword-only ``mesh`` (a ``parallel.mesh.Mesh``).  A mesh of more
than one slot splits a table's storage blocks over its ``model`` axis
when they divide it (``table_partition_axis``), else replicates the
table.  Each model shard runs the same body (kernel or plain version)
on its rows with the ids routed to it (K2 is given the shard's first row
and routes them inside its kernel), and the lookups combine by a sum
over ``model`` (exact zeros from every shard but the owner); the apply
all-gathers ``(ids, grads)`` over ``data`` first, routes ids owned
elsewhere to ``-1`` and combines nothing.  On an in-process mesh the
shards are row views of one table and the body runs once per model
slot; on a process mesh each rank holds its own rows and the combine is
a collective (``parallel.mesh.axis_all_reduce`` / ``axis_all_gather``).
Ids no shard owns read zeros on that route, where the one-card clamp
rule reads a real row (JAX ``_sharded_lookup_impl``).  The backward of
the two lookups stays the segment sum over the table as given.

Tables are ``[vocab_padded, dim_padded]`` f32 logical rows
(``parallel/packed.py``).  Contracts (those of ``docs/design.md`` for the
TPU kernels): the lookup and ``acts`` are exact copies, bit for bit;
``first``/``sum_v``/``sum_sq`` agree with the plain version to reduction
order; ``fused_dedup_apply`` replays the JAX scatter path's arithmetic
operation for operation (``<= 1 ulp`` between engines).
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_all_gather,
    axis_all_reduce,
    axis_index,
)
from elasticdl_tpu_torch.parallel.packed import PackedSpec, row_index

KERNELS = ("fused_lookup", "fused_lookup_fm", "fused_dedup_apply")

_launch_lock = threading.Lock()
_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name.  Only a
    wrapper that launches its CUDA kernel counts; the plain versions
    never do."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


def _count_launch(name: str) -> None:
    with _launch_lock:
        _launches[name] += 1


def _check_table(spec: PackedSpec, table: torch.Tensor, what: str = "table") -> None:
    if table.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {table.dtype}")
    if tuple(table.shape) != spec.rows_shape:
        raise ValueError(
            f"{what} shape {tuple(table.shape)} != {spec.rows_shape} "
            f"([vocab_padded, dim_padded] of {spec})"
        )
    if not table.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_ids(ids: torch.Tensor, table: torch.Tensor, ndim: int) -> None:
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if ids.dim() != ndim:
        raise ValueError(f"ids must have {ndim} dimension(s), got {tuple(ids.shape)}")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device} but table on {table.device}")


def _route(table: torch.Tensor) -> str:
    if table.device.type == "cuda":
        return "cuda"
    if table.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel for device {table.device}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ----------------------------------------------------------------------
# sharded dispatch: the rules (JAX ``ops/sparse_embedding.py:156-219``)
# ----------------------------------------------------------------------

#: The process-default dispatch mesh: an Embedding layer built without
#: a ``mesh`` resolves against it.  The ops consult only their own
#: ``mesh`` argument.
_DISPATCH_MESH = None


def set_dispatch_mesh(mesh) -> None:
    global _DISPATCH_MESH
    _DISPATCH_MESH = mesh


def dispatch_mesh():
    return _DISPATCH_MESH


def dispatch_route(mesh=None) -> str:
    """``"single_device"`` (one body on the whole table) or
    ``"shard_map"`` (per-shard bodies over the mesh) for ``mesh``."""
    if mesh is not None and mesh.size > 1:
        return "shard_map"
    return "single_device"


def table_partition_axis(num_blocks: int, mesh) -> Optional[str]:
    """The mesh axis a table's storage blocks are split over: ``model``
    when it divides ``num_blocks`` (STORAGE blocks, ``spec.num_blocks``,
    not rows), else None (the table is replicated)."""
    if mesh is None:
        return None
    msize = mesh.shape.get(MODEL_AXIS, 1)
    if msize > 1 and num_blocks % msize == 0:
        return MODEL_AXIS
    return None


def _shard_local_spec(spec: PackedSpec, mesh) -> PackedSpec:
    """One model shard's spec: the same dim, 1/model of the rows (exact:
    ``table_partition_axis`` demanded divisibility)."""
    return PackedSpec(spec.vocab_padded // mesh.shape[MODEL_AXIS], spec.dim)


def _shards(spec: PackedSpec, table: torch.Tensor, mesh, what: str = "table"):
    """-> ``(local_spec, [(first row, rows)])``: the model shards of
    ``table`` this process holds, or ``(None, [(0, table)])`` for a
    replicated table.  In process the shards are row views of the whole
    table; on a process mesh ``table`` must be this rank's rows."""
    if table_partition_axis(spec.num_blocks, mesh) is None:
        _check_table(spec, table, what)
        return None, [(0, table)]
    local = _shard_local_spec(spec, mesh)
    slots = axis_index(mesh, MODEL_AXIS)
    if mesh.in_process:
        _check_table(spec, table, what)
        views = table.chunk(mesh.shape[MODEL_AXIS])
        return local, [(s * local.vocab_padded, views[s]) for s in slots]
    _check_table(local, table, f"{what} (this rank's model shard)")
    return local, [(slots[0] * local.vocab_padded, table)]


def _route_ids(local: PackedSpec, ids: torch.Tensor, start: int, fill: int):
    """(ids routed to the shard whose rows start at ``start``, with
    ``fill`` where another shard owns them; bool mask of the owned)."""
    rel = ids.to(torch.int64) - start
    owned = (rel >= 0) & (rel < local.vocab_padded)
    return torch.where(owned, rel, fill).to(torch.int32), owned


def _table_cotangent(spec, shape, ids, g, mesh):
    """The segment sum of ``g`` by row over the table as it was given
    (``shape``: the whole table, or this rank's shard on a process
    mesh): duplicates sum, ids outside it drop."""
    if shape != spec.rows_shape:  # this rank's rows of a split table
        spec = _shard_local_spec(spec, mesh)
        ids = _route_ids(spec, ids, mesh.model_index * spec.vocab_padded, -1)[0]
    zeros = torch.zeros(shape, dtype=g.dtype, device=g.device)
    return pk.scatter_add(spec, zeros, ids, g)


# ----------------------------------------------------------------------
# fused_lookup
# ----------------------------------------------------------------------


def _lookup_plain_body(spec: PackedSpec, table: torch.Tensor, ids: torch.Tensor,
                       start: Optional[int] = None) -> torch.Tensor:
    """K2's plain version.  One card (``start`` None): the clamp-rule rows
    of ``ids``, first ``dim`` lanes.  The model shard whose rows
    (``table``, ``spec`` its local spec) start at global row ``start``:
    its part of the sharded lookup (JAX ``_sharded_lookup_impl``'s body),
    the ids routed to it (local id 0 where another shard owns them), the
    rows, then ``* owned``: another shard's id reads local row 0 times
    0.0, so a -0.0 or a NaN there comes through."""
    if start is None:
        return table.index_select(0, row_index(spec, ids))[:, : spec.dim]
    routed, owned = _route_ids(spec, ids, start, 0)
    return _lookup_plain_body(spec, table, routed) * owned[:, None].to(table.dtype)


def _launch_lookup(spec, table, ids, out, start: Optional[int] = None) -> None:
    """One launch of K2's kernel on contiguous ``ids`` into ``out``: on
    one card (``start`` None) or on the model shard whose rows
    (``table``) start at global row ``start`` (the kernel routes the ids
    itself, as ``_lookup_plain_body`` does)."""
    from elasticdl_tpu_torch.ops import _build

    with torch.cuda.device(table.device):
        code = _build.library().edl_fused_lookup(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.shape[0],
            -1 if start is None else start, spec.rows_per_block, spec.num_blocks,
            spec.dim_padded, spec.dim, _stream(),
        )
    _build.check(code, "fused_lookup")


def _lookup_forward(spec: PackedSpec, table: torch.Tensor, ids: torch.Tensor,
                    start: Optional[int] = None) -> torch.Tensor:
    """K2 on a CUDA table, its plain version on a CPU one."""
    if _route(table) == "plain":
        return _lookup_plain_body(spec, table, ids, start)
    ids = ids.contiguous()
    out = torch.empty((ids.shape[0], spec.dim), dtype=table.dtype, device=table.device)
    _launch_lookup(spec, table, ids, out, start)
    _count_launch("fused_lookup")
    return out


def _sharded_lookup(body, spec, table, ids, mesh):
    """The shard_map route of the lookup: ``body`` on each model shard
    with its first row (the body routes the ids and masks what another
    shard owns), then the sum over ``model``.  Each id has one owner, so
    the sum adds exact zeros to the owner's row."""
    local, shards = _shards(spec, table, mesh)
    if local is None:
        return body(spec, table, ids)
    parts = [body(local, rows, ids, start) for start, rows in shards]
    return axis_all_reduce(mesh, MODEL_AXIS, parts)


class _FusedLookup(torch.autograd.Function):
    """The lookup with ``_lookup_bwd`` as its backward: the table's
    cotangent is the segment sum of the output cotangent by row
    (duplicates sum, ids outside the table drop), on either route."""

    @staticmethod
    def forward(ctx, spec, table, ids, mesh, body):
        ctx.spec, ctx.mesh, ctx.shape = spec, mesh, tuple(table.shape)
        ctx.save_for_backward(ids)
        if dispatch_route(mesh) == "shard_map":
            return _sharded_lookup(body, spec, table, ids, mesh)
        return body(spec, table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d_table = None
        if ctx.needs_input_grad[1]:
            d_table = _table_cotangent(ctx.spec, ctx.shape, ids, g, ctx.mesh)
        return None, d_table, None, None, None


def fused_lookup_plain(
    spec: PackedSpec, table: torch.Tensor, ids: torch.Tensor, *, mesh=None
) -> torch.Tensor:
    """Plain PyTorch version of the lookup: clamp-rule rows, first
    ``dim`` lanes.  ids [n] -> [n, dim].  With a ``mesh`` it takes the
    sharded route with plain bodies (and the lookups' backward)."""
    if dispatch_route(mesh) == "shard_map":
        _check_ids(ids, table, 1)
        return _FusedLookup.apply(spec, table, ids, mesh, _lookup_plain_body)
    return _lookup_plain_body(spec, table, ids)


def fused_lookup(
    spec: PackedSpec, table: torch.Tensor, ids: torch.Tensor, *, mesh=None
) -> torch.Tensor:
    """ids int32 [n] -> rows [n, dim] (the JAX ``fused_lookup``).

    One card (``mesh`` None or of one slot): every id reads a real row by
    the clamp rule (``packed.row_index``); bit-exact with the JAX kernel
    for every id and with ``pk.lookup`` for ids in ``[0, vocab_padded)``.
    A mesh of more: the sharded route (module docstring), on which ids
    outside ``[0, vocab_padded)`` read zeros.  Differentiable in the
    table."""
    _check_ids(ids, table, 1)
    if dispatch_route(mesh) == "single_device":
        _check_table(spec, table)
    return _FusedLookup.apply(spec, table, ids, mesh, _lookup_forward)


# ----------------------------------------------------------------------
# fused_lookup_fm
# ----------------------------------------------------------------------

FmOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fm_stats(acts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """acts [batch, fields, dim] -> (first [batch], sum_v [batch, dim-1],
    sum_sq [batch, dim-1]) — twin of the JAX ``fm_stats_xla``."""
    first = torch.sum(acts[..., 0], dim=-1)
    v = acts[..., 1:]
    return first, torch.sum(v, dim=1), torch.sum(v * v, dim=1)


def _lookup_fm_plain_body(spec, table, bet, ids, valid) -> FmOut:
    batch, fields = ids.shape
    rows = table.index_select(0, row_index(spec, ids.reshape(-1)))
    rows = rows[:, : spec.dim].reshape(batch, fields, spec.dim)
    rows = rows + (bet.to(table.dtype) if bet is not None else 0.0)
    acts = rows * valid.to(table.dtype)[..., None]
    return (acts, *fm_stats(acts))


def _lookup_fm_operands(spec, table, bet, ids, valid):
    """The kernel's inputs, contiguous, and its empty outputs."""
    batch, fields = ids.shape
    if bet is not None:
        bet = bet.to(table.dtype).contiguous()
    device, dtype = table.device, table.dtype
    outs = (torch.empty((batch, fields, spec.dim), dtype=dtype, device=device),
            torch.empty((batch,), dtype=dtype, device=device),
            torch.empty((batch, spec.dim - 1), dtype=dtype, device=device),
            torch.empty((batch, spec.dim - 1), dtype=dtype, device=device))
    # valid's bool storage goes to the kernel as bytes, as it is: a
    # torch.bool element is one byte holding 0 or 1, and the kernel only
    # tests it against 0 (no conversion launch).
    return (bet, ids.contiguous(), valid.contiguous()), outs


def _launch_lookup_fm(spec, table, inputs, outs) -> None:
    """One launch of K1's kernel on ``_lookup_fm_operands``' tensors."""
    from elasticdl_tpu_torch.ops import _build

    bet, ids, valid = inputs
    batch, fields = ids.shape
    with torch.cuda.device(table.device):
        code = _build.library().edl_fused_lookup_fm(
            table.data_ptr(), bet.data_ptr() if bet is not None else None,
            ids.data_ptr(), valid.data_ptr(), *(o.data_ptr() for o in outs), batch,
            fields, spec.rows_per_block, spec.num_blocks, spec.dim_padded,
            spec.dim, _stream(),
        )
    _build.check(code, "fused_lookup_fm")


def _lookup_fm_forward(spec, table, bet, ids, valid) -> FmOut:
    if _route(table) == "plain":
        return _lookup_fm_plain_body(spec, table, bet, ids, valid)
    inputs, outs = _lookup_fm_operands(spec, table, bet, ids, valid)
    _launch_lookup_fm(spec, table, inputs, outs)
    _count_launch("fused_lookup_fm")
    return outs


def _sharded_lookup_fm(body, spec, table, bet, ids, valid, mesh) -> FmOut:
    """The shard_map route of the FM pass: on each model shard, ``body``
    with ``valid AND owned here`` and local id 0 where that is false,
    then each output summed over ``model`` (``acts`` gains exact zeros;
    the sums are summed per shard, then across shards)."""
    local, shards = _shards(spec, table, mesh)
    if local is None:
        return body(spec, table, bet, ids, valid)
    parts = []
    for start, rows in shards:
        routed, owned = _route_ids(local, ids, start, 0)
        mine = valid & owned
        parts.append(body(local, rows, bet, torch.where(mine, routed, 0), mine))
    return tuple(axis_all_reduce(mesh, MODEL_AXIS, [p[i] for p in parts]) for i in range(4))


def fm_backward(acts, valid, d_acts, d_first, d_sumv, d_sumsq) -> torch.Tensor:
    """``_fm_bwd_math``'s per-field activation cotangent: first/sum_v/
    sum_sq are plain sums of ``acts`` components, so every cotangent
    folds into ``d_field`` (``2·v`` is the sum-of-squares jacobian), then
    the validity mask.  Same operations in the same order."""
    dtype = acts.dtype
    d_field = d_acts.to(dtype).clone()
    d_field[..., 0] += d_first.to(dtype)[:, None]
    d_field[..., 1:] += (
        d_sumv.to(dtype)[:, None, :]
        + 2.0 * acts[..., 1:] * d_sumsq.to(dtype)[:, None, :]
    )
    return d_field * valid.to(dtype)[..., None]


class _FusedLookupFm(torch.autograd.Function):
    """K1 forward with ``_fm_bwd_math`` as its backward, on either route:
    ``bet`` gets ``d_field``; the table, only when asked for, its segment
    sum."""

    @staticmethod
    def forward(ctx, spec, table, bet, ids, valid, mesh, body):
        if dispatch_route(mesh) == "shard_map":
            out = _sharded_lookup_fm(body, spec, table, bet, ids, valid, mesh)
        else:
            out = body(spec, table, bet, ids, valid)
        ctx.spec, ctx.mesh, ctx.shape = spec, mesh, tuple(table.shape)
        ctx.save_for_backward(out[0], ids, valid)
        return out

    @staticmethod
    def backward(ctx, d_acts, d_first, d_sumv, d_sumsq):
        acts, ids, valid = ctx.saved_tensors
        d_field = fm_backward(acts, valid, d_acts, d_first, d_sumv, d_sumsq)
        d_table = None
        if ctx.needs_input_grad[1]:
            d_table = _table_cotangent(ctx.spec, ctx.shape, ids.reshape(-1),
                                       d_field.reshape(-1, ctx.spec.dim), ctx.mesh)
        d_bet = d_field if ctx.needs_input_grad[2] else None
        return None, d_table, d_bet, None, None, None, None


def _check_lookup_fm(spec, table, bet, ids, valid, mesh) -> None:
    if spec.dim < 2:
        raise ValueError(
            f"fused_lookup_fm needs a combined table of dim >= 2 "
            f"(1 linear lane + FM lanes), got dim={spec.dim}"
        )
    if dispatch_route(mesh) == "single_device":
        _check_table(spec, table)
    _check_ids(ids, table, 2)
    if valid.shape != ids.shape or valid.dtype != torch.bool:
        raise ValueError(
            f"valid must be bool of shape {tuple(ids.shape)}, got "
            f"{valid.dtype} {tuple(valid.shape)}"
        )
    if valid.device != table.device:
        raise ValueError(f"valid on {valid.device} but table on {table.device}")
    if bet is not None:
        if tuple(bet.shape) != tuple(ids.shape) + (spec.dim,):
            raise ValueError(
                f"bet shape {tuple(bet.shape)} != {tuple(ids.shape) + (spec.dim,)}"
            )
        if bet.device != table.device:
            raise ValueError(f"bet on {bet.device} but table on {table.device}")


def fused_lookup_fm_plain(
    spec: PackedSpec,
    table: torch.Tensor,
    bet: Optional[torch.Tensor],
    ids: torch.Tensor,
    valid: torch.Tensor,
    *,
    mesh=None,
) -> FmOut:
    """Plain PyTorch version of the merged lookup + FM partial sums
    (differentiable through plain autograd).  With a ``mesh`` it takes the
    sharded route with plain bodies (and the FM backward)."""
    if dispatch_route(mesh) == "shard_map":
        _check_lookup_fm(spec, table, bet, ids, valid, mesh)
        return _FusedLookupFm.apply(spec, table, bet, ids, valid, mesh, _lookup_fm_plain_body)
    return _lookup_fm_plain_body(spec, table, bet, ids, valid)


def fused_lookup_fm(
    spec: PackedSpec,
    table: torch.Tensor,
    bet: Optional[torch.Tensor],
    ids: torch.Tensor,
    valid: torch.Tensor,
    *,
    mesh=None,
) -> FmOut:
    """Combined ``1+dim`` lookup + FM partial sums in one pass (the JAX
    ``fused_lookup_fm``).

    ids int32 [batch, fields] (already offset), valid bool [batch,
    fields], bet [batch, fields, dim] or None (zeros; serving passes
    None, training its perturbation capture, whose gradient is the
    sparse gradient).  Returns ``(acts [batch, fields, dim], first
    [batch], sum_v [batch, dim-1], sum_sq [batch, dim-1])`` with ``acts =
    (row + bet) * valid``; lane 0 is the first-order weight and lanes
    1..dim the FM field vector:

        second_order = 0.5 * sum_d(sum_v^2 - sum_sq)

    ``mesh``: a mesh of more than one slot takes the sharded route
    (module docstring); ``acts`` is then the same values, the sums agree
    to reduction order.
    """
    _check_lookup_fm(spec, table, bet, ids, valid, mesh)
    return _FusedLookupFm.apply(spec, table, bet, ids, valid, mesh, _lookup_fm_forward)


# ----------------------------------------------------------------------
# fused_dedup_apply
# ----------------------------------------------------------------------

#: Table-shaped operands per optimizer kind, in kernel-operand order.
#: The table itself is always first; the rest are the slot names.
KIND_SLOTS: Dict[str, Tuple[str, ...]] = {
    "sgd": (),
    "momentum": ("momentum",),
    "adagrad": ("accumulator",),
    "adam": ("m", "v", "t"),
    "adam_global": ("m", "v"),
}
_KIND_CODE = {"sgd": 0, "momentum": 1, "adagrad": 2, "adam": 3, "adam_global": 4}


def apply_constants(kind: str, hyper: Mapping) -> Dict[str, float]:
    """The f32 constants of the slot math, rounded as JAX rounds its
    weakly typed Python-float hyperparameters: ``-lr`` and ``1 - b`` are
    formed in double and rounded once to f32; the kernel receives them
    already rounded and never forms ``1.0f - b1`` itself."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    c = {"lr_neg": f32(-hyper["learning_rate"])}
    if kind == "momentum":
        c["mu"] = f32(hyper["momentum"])
        c["nesterov"] = bool(hyper["nesterov"])
    elif kind == "adagrad":
        c["eps"] = f32(hyper["epsilon"])
    elif kind in ("adam", "adam_global"):
        b1, b2 = hyper["beta_1"], hyper["beta_2"]
        c.update(b1=f32(b1), b2=f32(b2), omb1=f32(1 - b1), omb2=f32(1 - b2),
                 eps=f32(hyper["epsilon"]))
    return c


def apply_math(kind: str, c: Mapping, g, subs, tr):
    """Plain per-row optimizer math (the JAX ``_apply_math``) on real
    lanes: the DELTAS to add to each operand (table first, then the slots
    in ``KIND_SLOTS`` order).  ``g`` is the summed gradient, ``subs`` the
    current rows, ``tr`` Adam's bias-correction step count, ``c`` from
    ``apply_constants``."""
    if kind == "sgd":
        return (c["lr_neg"] * g,)
    if kind == "momentum":
        v = subs[1]
        v_new = c["mu"] * v + g
        step = (c["mu"] * v_new + g) if c["nesterov"] else v_new
        return (c["lr_neg"] * step, v_new - v)
    if kind == "adagrad":
        gg = g * g
        new_acc = subs[1] + gg
        return (c["lr_neg"] * g / (torch.sqrt(new_acc) + c["eps"]), gg)
    m, v = subs[1], subs[2]
    m_new = c["b1"] * m + c["omb1"] * g
    v_new = c["b2"] * v + c["omb2"] * g * g
    b1 = torch.full((), c["b1"], dtype=torch.float32, device=g.device)
    b2 = torch.full((), c["b2"], dtype=torch.float32, device=g.device)
    m_hat = m_new / (1.0 - torch.pow(b1, tr))
    v_hat = v_new / (1.0 - torch.pow(b2, tr))
    update = c["lr_neg"] * m_hat / (torch.sqrt(v_hat) + c["eps"])
    if kind == "adam":
        # Per-row t gains 1 on real lanes only (pad lanes stay zero).
        return (update, m_new - m, v_new - v, torch.ones_like(g))
    return (update, m_new - m, v_new - v)


def _resolve_kind(kind: str, slots: Mapping) -> str:
    if kind == "adam" and "t" not in slots:
        kind = "adam_global"
    if kind not in KIND_SLOTS:
        raise ValueError(f"unknown sparse optimizer kind {kind!r}")
    return kind


def _check_apply(spec, kind, table, slots, ids, grads):
    _check_table(spec, table)
    for name in KIND_SLOTS[kind]:
        if name not in slots:
            raise KeyError(f"{kind} needs the slot {name!r}")
        _check_table(spec, slots[name], f"slot {name!r}")
        if slots[name].device != table.device:
            raise ValueError(f"slot {name!r} on {slots[name].device}, table on {table.device}")
    if kind == "adam_global":
        t_global = slots.get("t_global")
        if t_global is None or t_global.shape != () or t_global.dtype != torch.float32:
            raise ValueError("adam_global needs a float32 scalar slot 't_global'")
        if t_global.device != table.device:
            raise ValueError(f"slot 't_global' on {t_global.device}, table on {table.device}")
    _check_ids(ids, table, 1)
    if grads.dtype != torch.float32:
        raise TypeError(f"grads must be float32, got {grads.dtype}")
    if tuple(grads.shape) != (ids.shape[0], spec.dim):
        raise ValueError(f"grads shape {tuple(grads.shape)} != {(ids.shape[0], spec.dim)}")
    if grads.device != table.device:
        raise ValueError(f"grads on {grads.device} but table on {table.device}")


def _apply_plain_body(spec, kind, c, operands, t_global, ids, grads):
    """The JAX scatter path, step for step, on ``operands`` (the table,
    then the slots in ``KIND_SLOTS`` order; row views allowed), in place.
    ``t_global``: adam_global's count, already advanced."""
    dim = spec.dim
    uids, gsum, touched = pk.dedup_representatives(spec, ids, grads)
    tch = touched.to(operands[0].dtype)[:, None]
    gsum = gsum * tch
    rows64 = uids.to(torch.int64)
    subs = tuple(op.index_select(0, rows64)[:, :dim] for op in operands)
    if kind == "adam":
        tr = torch.clamp(subs[3][:, :1] + tch, min=1.0)
    else:
        tr = t_global  # adam_global's count; None for the other kinds
    deltas = apply_math(kind, c, gsum, subs, tr)
    for op, delta in zip(operands, deltas):
        pk.scatter_add(spec, op, uids, delta * tch)


def _launch_apply(spec, kind, c, operands, t_global, sorted_ids, perm, grads):
    """One launch of K3's kernel on the stably sorted raw ids and their
    positions (``torch.sort(ids, stable=True)``): each row's occurrences
    keep their position order, and ids outside ``[0, vocab_padded)`` sort
    to the ends, where the kernel skips them (it tests the range itself,
    so no keying pass runs first)."""
    from elasticdl_tpu_torch.ops import _build

    n = sorted_ids.shape[0]
    operands = list(operands) + [None] * (4 - len(operands))
    with torch.cuda.device(operands[0].device):
        code = _build.library().edl_fused_dedup_apply(
            sorted_ids.data_ptr(), perm.data_ptr(), grads.data_ptr(), n,
            spec.vocab_padded, spec.dim_padded, spec.dim, _KIND_CODE[kind],
            *(op.data_ptr() if op is not None else None for op in operands),
            t_global.data_ptr() if t_global is not None else None,
            c["lr_neg"], c.get("mu", 0.0), int(c.get("nesterov", False)),
            c.get("eps", 0.0), c.get("b1", 0.0), c.get("b2", 0.0),
            c.get("omb1", 0.0), c.get("omb2", 0.0),
            _stream(),
        )
    _build.check(code, "fused_dedup_apply")


def _apply_body(spec, kind, c, operands, t_global, ids, grads):
    """K3 on a CUDA table, the plain body on a CPU one."""
    if _route(operands[0]) == "plain":
        return _apply_plain_body(spec, kind, c, operands, t_global, ids, grads)
    if ids.shape[0] == 0:
        return
    sorted_ids, perm = torch.sort(ids, stable=True)
    _launch_apply(spec, kind, c, operands, t_global, sorted_ids, perm, grads.contiguous())
    _count_launch("fused_dedup_apply")


def _dedup_apply(body, spec, kind, hyper, table, slots, ids, grads, mesh):
    """Both routes of the apply around ``body``.  The sharded route
    all-gathers ``(ids, grads)`` over ``data`` (in data-index order), then
    runs ``body`` on each model shard of the table and its slots with the
    ids owned elsewhere routed to ``-1`` (which the dedup drops); each id
    keeps its occurrence order, so its summed gradient has the one-card
    bits.  adam_global's scalar count advances once per apply."""
    kind = _resolve_kind(kind, slots)
    names = KIND_SLOTS[kind]
    local, shards = None, [(0, [table] + [slots[name] for name in names])]
    if dispatch_route(mesh) == "shard_map":
        ids = axis_all_gather(mesh, DATA_AXIS, ids)
        grads = axis_all_gather(mesh, DATA_AXIS, grads)
        local, table_shards = _shards(spec, table, mesh)
        slot_shards = [_shards(spec, slots[name], mesh, f"slot {name!r}")[1] for name in names]
        shards = [(start, [rows] + [ss[i][1] for ss in slot_shards])
                  for i, (start, rows) in enumerate(table_shards)]
    checked = dict(slots, **dict(zip(names, shards[0][1][1:])))
    _check_apply(local or spec, kind, shards[0][1][0], checked, ids, grads)
    c = apply_constants(kind, hyper)
    t_global = None
    if kind == "adam_global":
        t_global = slots["t_global"]
        t_global.add_(1.0)
    for start, operands in shards:
        routed = ids if local is None else _route_ids(local, ids, start, -1)[0]
        body(local or spec, kind, c, operands, t_global, routed, grads)
    return table, slots


def fused_dedup_apply_plain(
    spec: PackedSpec, kind: str, hyper: Mapping, table: torch.Tensor,
    slots: Dict[str, torch.Tensor], ids: torch.Tensor, grads: torch.Tensor,
    *, mesh=None,
):
    """Plain PyTorch version: the JAX scatter path, step for step —
    ``dedup_representatives``, row gathers, the slot math, then the
    delta-form ``scatter_add`` of each operand (``parallel/
    sparse_optim.py`` ``scatter_apply``).  Updates in place and returns
    ``(table, slots)``; ``mesh`` as ``fused_dedup_apply``."""
    return _dedup_apply(_apply_plain_body, spec, kind, hyper, table, slots, ids, grads, mesh)


def fused_dedup_apply(
    spec: PackedSpec, kind: str, hyper: Mapping, table: torch.Tensor,
    slots: Dict[str, torch.Tensor], ids: torch.Tensor, grads: torch.Tensor,
    *, mesh=None,
):
    """One-pass sparse optimizer step, IN PLACE: ``(ids [n] int32, grads
    [n, dim] f32)`` in; ``table`` and the slots of ``kind``
    (``KIND_SLOTS``) updated and returned as ``(table, slots)``.

    ``kind`` is sgd, momentum (``hyper["nesterov"]``), adagrad, adam
    (per-row step count in slot ``t``) or adam_global (``adam`` without a
    ``t`` slot: the scalar ``t_global`` gains 1 per apply, outside the
    kernel, and is the bias-correction count of every row).  Semantics of
    the JAX ``fused_dedup_apply``: every distinct id in ``[0,
    vocab_padded)`` gets one update from the sum of its grads; rows whose
    sum is exactly zero are untouched; written values are ``old +
    fl(new - old)`` for every operand; pad lanes stay zero.

    On CUDA the raw ids are sorted (stable, so each row's grads keep
    their position order) and the kernel sums each row's segment from
    0.0f in that order, a chunk of sorted positions at a time, then
    applies the update to its row; each touched row belongs to one
    segment, so the in-place update needs no atomics.

    ``mesh``: a mesh of more than one slot takes the sharded route
    (``_dedup_apply``); every table-shaped slot is split as the table
    is, the scalar ``t_global`` is replicated."""
    return _dedup_apply(_apply_body, spec, kind, hyper, table, slots, ids, grads, mesh)
