"""K10, the block-gather probe: the port of ``gather_kernel``
(``scripts/exp_sparse_gather.py:154``, launched through ``pallas_gather``
and ``pl.pallas_call`` at :157-159), a hand-written CUDA kernel in
``csrc/sparse_gather.cu``.

For each index ``b[i]`` it copies the aligned 8-row block of the packed
table, ``packed[8·b[i] : 8·b[i] + 8, :]``, to ``out[i]``: ids ``[n]`` int32
-> ``[n, 8, 128]`` f32.  The experiment script
(``elasticdl_tpu_torch.bench.exp_sparse_gather``) launches it as the
one-row-per-step floor probe of the sparse lookup.  The port keeps a
table as rows ``[vocab_padded, dim_padded]`` (``parallel/packed.py``);
with 128-lane storage rows that is the packed ``[num_blocks, 128]``
buffer byte for byte, so the wrapper takes the row table and views it.

Index rule, that of the Pallas kernel in interpret mode (``block_index``):
the block's first row is ``8·b`` as an int32 product (wrapping), a
negative first row is moved up by the table's row count once, and the
result is clamped to ``[0, rows - 8]``.  So with ``nb8 = num_blocks / 8``
blocks, ``b`` in ``[-nb8, nb8)`` reads block ``b mod nb8`` (``-1`` the
last), ``b >= nb8`` the last block and ``b < -nb8`` block 0.

``block_gather`` launches K10 on a CUDA tensor and runs
``block_gather_plain`` on a CPU one; ``launch_counts()`` counts its
launches.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel.packed import LANES, PackedSpec

KERNELS = ("block_gather",)
#: Storage rows per gathered block (the Pallas BlockSpec's 8).
BLOCK_ROWS = 8

_launch_lock = threading.Lock()
_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def launch_counts() -> Dict[str, int]:
    """K10 launches since the last reset (the plain version counts none)."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        _launches["block_gather"] = 0


def _packed(table_rows: torch.Tensor, spec: PackedSpec) -> torch.Tensor:
    """The row table viewed as packed storage ``[num_blocks, 128]``."""
    if spec.block_width != LANES:
        raise ValueError(f"block_gather needs 128-lane storage rows, {spec} has {spec.block_width}")
    if spec.num_blocks % BLOCK_ROWS:
        raise ValueError(
            f"block_gather needs num_blocks % {BLOCK_ROWS} == 0 (the TPU BlockSpec's "
            f"8-row blocks), got {spec.num_blocks}"
        )
    ske._check_table(spec, table_rows)
    return table_rows.view(spec.packed_shape)


def block_index(spec: PackedSpec, b: torch.Tensor) -> torch.Tensor:
    """Indices -> the int64 block each reads (module docstring's rule)."""
    rows = spec.num_blocks
    start = b.to(torch.int64) * BLOCK_ROWS
    start = torch.remainder(start + 2**31, 2**32) - 2**31  # the int32 product wraps
    start = torch.where(start < 0, start + rows, start)
    return torch.clamp(start, 0, rows - BLOCK_ROWS) // BLOCK_ROWS


def block_gather_plain(table_rows: torch.Tensor, spec: PackedSpec, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``packed.view(-1, 8, 128)[rule(b)]``."""
    packed = _packed(table_rows, spec)
    return packed.view(-1, BLOCK_ROWS, LANES).index_select(0, block_index(spec, b))


def block_gather(table_rows: torch.Tensor, spec: PackedSpec, b: torch.Tensor) -> torch.Tensor:
    """ids int32 ``[n]`` -> ``[n, 8, 128]`` f32, the 8-row block each id
    names (module docstring).  K10 on a CUDA table, the plain version on
    a CPU one."""
    if b.dtype != torch.int32 or b.dim() != 1:
        raise TypeError(f"b must be int32 [n], got {b.dtype} {tuple(b.shape)}")
    if b.device != table_rows.device:
        raise ValueError(f"b on {b.device} but table on {table_rows.device}")
    if ske._route(table_rows) == "plain":
        return block_gather_plain(table_rows, spec, b)
    from elasticdl_tpu_torch.ops import _build

    packed = _packed(table_rows, spec)
    if packed.data_ptr() % 16:
        raise ValueError("block_gather needs a table whose storage is 16-byte aligned")
    b = b.contiguous()
    n = b.shape[0]
    out = torch.empty((n, BLOCK_ROWS, LANES), dtype=packed.dtype, device=packed.device)
    with torch.cuda.device(packed.device):
        code = _build.library().edl_block_gather(
            packed.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            spec.num_blocks // BLOCK_ROWS, ske._stream(),
        )
    _build.check(code, "block_gather")
    with _launch_lock:
        _launches["block_gather"] += 1
    return out
