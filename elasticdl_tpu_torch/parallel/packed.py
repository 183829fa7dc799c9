"""Table geometry shared with the JAX package's packed storage.

The JAX package stores a ``[vocab, dim]`` table as ``[num_blocks, 128]``
f32 (``elasticdl_tpu/parallel/packed.py``): ``dim`` is padded to a power
of two that divides 128 (``dim_padded``) and ``rows_per_block`` logical
rows share one 128-lane storage row.  The packing exists for the TPU's
(8, 128) tiling.  A CUDA card has no such tiling, so the port keeps a
table as LOGICAL rows ``[vocab_padded, dim_padded]``: because
``block_width == rows_per_block * dim_padded``, that is the same bytes
as the packed buffer, and a JAX artifact's table ``.npy`` is used as it
is through a reshape (a view, even of a memmap).  The port never needs
the 128-lane packing on the card.

``row_index`` is the kernels' id -> row rule, copied from
``_block_and_lane`` (``elasticdl_tpu/ops/sparse_embedding.py``): the
storage block is CLAMPED into ``[0, num_blocks)`` and the slot is the
floor-mod of the id, so every id, negative or past the table, reads a
real row.  Ids outside ``[0, vocab)`` are the Embedding layer's business
(safe ids + validity mask); the clamp only keeps every read in bounds.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

LANES = 128

# Opt-in out-of-vocabulary diagnostics (--oov_diagnostics, or the
# environment's ELASTICDL_OOV_DEBUG), JAX packed.py:46-57.  Ids outside
# [0, vocab) read zeros and receive no update; with diagnostics on, the
# Embedding layer logs each step's count of ids >= vocab_size (a host
# readback, so a sync per lookup: a diagnostic, off by default).
_OOV_DEBUG = os.environ.get("ELASTICDL_OOV_DEBUG", "").strip().lower() in (
    "1", "true", "yes", "on",
)


def set_oov_debug(enabled: bool) -> None:
    global _OOV_DEBUG
    _OOV_DEBUG = bool(enabled)


def oov_debug_enabled() -> bool:
    return _OOV_DEBUG


def _pad_dim(dim: int) -> int:
    """Smallest power of two >= dim that divides 128, or a multiple of 128
    for wide rows (which need no packing)."""
    if dim >= LANES:
        return -(-dim // LANES) * LANES
    p = 1
    while p < dim:
        p *= 2
    return p


@dataclass(frozen=True)
class PackedSpec:
    """Static description of one table (the JAX package's field names)."""

    vocab_size: int
    dim: int

    @property
    def dim_padded(self) -> int:
        return _pad_dim(self.dim)

    @property
    def rows_per_block(self) -> int:
        return max(1, LANES // self.dim_padded)

    @property
    def vocab_padded(self) -> int:
        r = self.rows_per_block
        return -(-self.vocab_size // r) * r

    @property
    def num_blocks(self) -> int:
        return self.vocab_padded // self.rows_per_block

    @property
    def block_width(self) -> int:
        return self.rows_per_block * self.dim_padded  # == LANES for dim<128

    @property
    def packed_shape(self) -> tuple:
        return (self.num_blocks, self.block_width)

    @property
    def rows_shape(self) -> tuple:
        """The port's on-device table shape: logical rows."""
        return (self.vocab_padded, self.dim_padded)


def pack(spec: PackedSpec, table: np.ndarray) -> np.ndarray:
    """[vocab, dim] -> packed [num_blocks, block_width] (pad cells zero)."""
    table = np.asarray(table)
    v_pad = spec.vocab_padded - table.shape[0]
    d_pad = spec.dim_padded - table.shape[1]
    if v_pad or d_pad:
        table = np.pad(table, ((0, v_pad), (0, d_pad)))
    return table.reshape(spec.packed_shape)


def unpack(spec: PackedSpec, packed: np.ndarray) -> np.ndarray:
    """packed [num_blocks, block_width] -> logical [vocab, dim]."""
    logical = np.asarray(packed).reshape(spec.rows_shape)
    return logical[: spec.vocab_size, : spec.dim]


def as_rows(spec: PackedSpec, table: np.ndarray) -> np.ndarray:
    """Any stored form of a table -> ``[vocab_padded, dim_padded]`` rows.

    Packed ``[num_blocks, block_width]`` and row form are the same bytes
    and come back as a view (no copy of a memmapped table); a logical
    ``[vocab, dim]`` array (the trainers' ``get_variables_numpy`` export
    view) is zero-padded, which copies."""
    shape = tuple(table.shape)
    if shape in (spec.packed_shape, spec.rows_shape):
        return table.reshape(spec.rows_shape)
    if shape == (spec.vocab_size, spec.dim):
        return pack(spec, table).reshape(spec.rows_shape)
    raise ValueError(
        f"table of shape {shape} fits neither the packed {spec.packed_shape}, "
        f"the row {spec.rows_shape} nor the logical "
        f"{(spec.vocab_size, spec.dim)} form of {spec}"
    )


def row_index(spec: PackedSpec, ids: torch.Tensor) -> torch.Tensor:
    """ids (any int dtype) -> int64 row of the ``[vocab_padded,
    dim_padded]`` table: ``clamp(id // r, 0, nb-1) * r + floor_mod(id, r)``
    — ``_block_and_lane``'s rule, reproduced for every id."""
    r = spec.rows_per_block
    ids = ids.to(torch.int64)
    blocks = torch.clamp(
        torch.div(ids, r, rounding_mode="floor"), 0, spec.num_blocks - 1
    )
    return blocks * r + torch.remainder(ids, r)


# ----------------------------------------------------------------------
# Row-form scatter side (the JAX package's expand_updates / scatter_add /
# grad_accumulate / dedup_representatives).  The JAX versions scatter
# 128-lane storage rows with one-hot slot masks; on logical rows a
# scatter is an ``index_add_`` of [n, dim_padded] updates.  Ids outside
# [0, vocab_padded) are DROPPED, as the JAX scatters drop them (negative
# ids routed out of bounds high, ids >= vocab_padded out of bounds).
# ----------------------------------------------------------------------


def in_table(spec: PackedSpec, ids: torch.Tensor) -> torch.Tensor:
    """bool mask of ids that address a row of the table."""
    return (ids >= 0) & (ids < spec.vocab_padded)


def pad_lanes(spec: PackedSpec, updates: torch.Tensor) -> torch.Tensor:
    """[n, dim] -> [n, dim_padded] with zero pad lanes."""
    if spec.dim == spec.dim_padded:
        return updates
    return torch.nn.functional.pad(updates, (0, spec.dim_padded - spec.dim))


def expand_updates(spec: PackedSpec, ids: torch.Tensor, updates: torch.Tensor):
    """(ids [n], updates [n, dim]) -> (rows int64 [m], updates [m,
    dim_padded]) for the m ids inside the table, in position order: the
    row-form ``expand_updates``, whose dropped ids are left out here."""
    keep = in_table(spec, ids)
    return ids[keep].to(torch.int64), pad_lanes(spec, updates[keep])


def scatter_add(
    spec: PackedSpec, table: torch.Tensor, ids: torch.Tensor, updates: torch.Tensor
) -> torch.Tensor:
    """table[ids] += updates, in place; duplicates sum, out-of-table ids
    drop.  On the CPU ``index_add_`` adds in position order, as the JAX
    scatter does; on CUDA it adds with atomics, in no fixed order."""
    rows, expanded = expand_updates(spec, ids, updates)
    return table.index_add_(0, rows, expanded.to(table.dtype))


def grad_accumulate(
    spec: PackedSpec, table_like: torch.Tensor, ids: torch.Tensor, grads: torch.Tensor
) -> torch.Tensor:
    """Segment sum of grads by row: a new zeros table with acc[row] = the
    sum of grads over every occurrence of row in ids."""
    return scatter_add(spec, torch.zeros_like(table_like), ids, grads)


def real_lane_mask(spec: PackedSpec, dtype=torch.float32, device=None) -> torch.Tensor:
    """[dim_padded] mask: 1 on lanes holding real dims, 0 on pad lanes."""
    return (torch.arange(spec.dim_padded, device=device) < spec.dim).to(dtype)


def dedup_representatives(spec: PackedSpec, ids: torch.Tensor, grads: torch.Tensor):
    """Row-form twin of the JAX ``dedup_representatives``: returns
    ``(safe_ids int32 [n], gsum [n, dim], touched bool [n])``.

    Exactly one position per distinct in-table id — its LAST occurrence,
    the representative — is touched; ``gsum`` there holds the sum of the
    grads of every occurrence (added in position order onto zeros, as
    the JAX scatter-add does on the CPU); rows whose sum is exactly zero
    are untouched; ids outside ``[0, vocab_padded)`` are dropped and
    their safe id is 0.  Non-representative positions keep ``gsum``
    zero, like the JAX version's."""
    n = ids.shape[0]
    ids = ids.to(torch.int32)
    valid = in_table(spec, ids)
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    pos = torch.arange(n, dtype=torch.int64, device=ids.device)
    # last occurrence per row: scatter-max of positions (-1 = never).
    last_by_row = torch.full((spec.vocab_padded,), -1, dtype=torch.int64, device=ids.device)
    last_by_row.scatter_reduce_(
        0, safe[valid].to(torch.int64), pos[valid], reduce="amax", include_self=True
    )
    last = torch.where(valid, last_by_row[safe.to(torch.int64)], torch.full_like(pos, -1))
    # every occurrence's grad onto its representative; invalid -> row n,
    # cut off below (the JAX version drops them out of bounds).
    target = torch.where(valid, last, torch.full_like(pos, n))
    # On CUDA, deterministic index_add_ sums the duplicates of one-wide
    # rows in another order (its stride-1 kernel reduces them across a
    # warp); a zero second lane keeps dim 1 on the kernel that adds them
    # one after another in position order, as wider rows are.
    one_wide = grads.dim() == 2 and grads.shape[1] == 1
    src = torch.nn.functional.pad(grads, (0, 1)) if one_wide else grads
    gsum = torch.zeros((n + 1,) + tuple(src.shape[1:]), dtype=grads.dtype, device=grads.device)
    gsum.index_add_(0, target, src)
    gsum = gsum[:n, :1].contiguous() if one_wide else gsum[:n]
    touched = valid & (pos == last) & torch.any(gsum != 0, dim=-1)
    return safe, gsum, touched
