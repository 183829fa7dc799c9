"""Sparse-embedding forward ops: the port of the Pallas lookup kernels.

Counterpart of ``elasticdl_tpu/ops/sparse_embedding.py``.  Two kernels
sit on the serving path, each a hand-written CUDA kernel in
``csrc/sparse_embedding.cu``:

``fused_lookup``     ids ``[n]`` -> rows ``[n, dim]`` (replaces
                     ``_lookup_kernel``; the ``split_tables`` DeepFM
                     layout and the generic Embedding layer).
``fused_lookup_fm``  the DeepFM merged ``1+d`` lookup plus the FM partial
                     sums in one pass (replaces ``_fm_kernel``).

Each public function checks its operands, then dispatches on the device
of the tensors it is given: on ``cuda`` it launches its kernel (or
raises), on ``cpu`` it runs its ``*_plain`` version, the index
arithmetic + ``index_select`` + masks + ``torch.sum`` form the tests hold
against the JAX package and ``chip_smoke.py`` holds the kernels against
on the card.  Nothing falls back from the kernel to the plain version.

Tables are ``[vocab_padded, dim_padded]`` f32 logical rows
(``parallel/packed.py``).  Forward only: the FM custom VJP, the lookup's
segment-sum backward and ``fused_dedup_apply`` belong to the training
slice.

Contracts (those of ``docs/design.md`` for the TPU kernels): the lookup
and ``acts`` are exact copies, bit for bit; ``first``/``sum_v``/
``sum_sq`` agree with the plain version to reduction order (the kernel
adds the fields in order f = 0..F-1, ``torch.sum`` in its own order).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from elasticdl_tpu_torch.parallel.packed import PackedSpec, row_index

KERNELS = ("fused_lookup", "fused_lookup_fm")

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


def _check_table(spec: PackedSpec, table: torch.Tensor) -> None:
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    if tuple(table.shape) != spec.rows_shape:
        raise ValueError(
            f"table shape {tuple(table.shape)} != {spec.rows_shape} "
            f"([vocab_padded, dim_padded] of {spec})"
        )
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")


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


# ----------------------------------------------------------------------
# fused_lookup
# ----------------------------------------------------------------------


def fused_lookup_plain(
    spec: PackedSpec, table: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the lookup: clamp-rule rows, first
    ``dim`` lanes.  ids [n] -> [n, dim]."""
    rows = table.index_select(0, row_index(spec, ids))
    return rows[:, : spec.dim]


def fused_lookup(
    spec: PackedSpec, table: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """ids int32 [n] -> rows [n, dim] (the JAX ``fused_lookup``).

    Every id reads a real row by the clamp rule (``packed.row_index``);
    bit-exact with the JAX kernel for every id and with ``pk.lookup`` for
    ids in ``[0, vocab_padded)``."""
    _check_table(spec, table)
    _check_ids(ids, table, 1)
    if _route(table) == "plain":
        return fused_lookup_plain(spec, table, ids)
    from elasticdl_tpu_torch.ops import _build

    ids = ids.contiguous()
    n = ids.shape[0]
    out = torch.empty((n, spec.dim), dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        code = _build.library().edl_fused_lookup(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), n,
            spec.rows_per_block, spec.num_blocks, spec.dim_padded, spec.dim,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "fused_lookup")
    _count_launch("fused_lookup")
    return out


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


def fused_lookup_fm_plain(
    spec: PackedSpec,
    table: torch.Tensor,
    bet: Optional[torch.Tensor],
    ids: torch.Tensor,
    valid: torch.Tensor,
) -> FmOut:
    """Plain PyTorch version of the merged lookup + FM partial sums."""
    batch, fields = ids.shape
    rows = table.index_select(0, row_index(spec, ids.reshape(-1)))
    rows = rows[:, : spec.dim].reshape(batch, fields, spec.dim)
    rows = rows + (bet.to(table.dtype) if bet is not None else 0.0)
    acts = rows * valid.to(table.dtype)[..., None]
    return (acts, *fm_stats(acts))


def fused_lookup_fm(
    spec: PackedSpec,
    table: torch.Tensor,
    bet: Optional[torch.Tensor],
    ids: torch.Tensor,
    valid: torch.Tensor,
) -> FmOut:
    """Combined ``1+dim`` lookup + FM partial sums in one pass (the JAX
    ``fused_lookup_fm`` forward).

    ids int32 [batch, fields] (already offset), valid bool [batch,
    fields], bet [batch, fields, dim] or None (zeros; serving passes
    None, the training slice will pass its perturbation input).  Returns
    ``(acts [batch, fields, dim], first [batch], sum_v [batch, dim-1],
    sum_sq [batch, dim-1])`` with ``acts = (row + bet) * valid``; lane 0
    is the first-order weight and lanes 1..dim the FM field vector:

        second_order = 0.5 * sum_d(sum_v^2 - sum_sq)
    """
    if spec.dim < 2:
        raise ValueError(
            f"fused_lookup_fm needs a combined table of dim >= 2 "
            f"(1 linear lane + FM lanes), got dim={spec.dim}"
        )
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
    if _route(table) == "plain":
        return fused_lookup_fm_plain(spec, table, bet, ids, valid)
    from elasticdl_tpu_torch.ops import _build

    batch, fields = ids.shape
    ids = ids.contiguous()
    # bool is passed as one byte per flag, never as a reinterpreted bool*.
    valid_u8 = valid.to(torch.uint8).contiguous()
    if bet is not None:
        bet = bet.to(table.dtype).contiguous()
    device, dtype = table.device, table.dtype
    acts = torch.empty((batch, fields, spec.dim), dtype=dtype, device=device)
    first = torch.empty((batch,), dtype=dtype, device=device)
    sum_v = torch.empty((batch, spec.dim - 1), dtype=dtype, device=device)
    sum_sq = torch.empty((batch, spec.dim - 1), dtype=dtype, device=device)
    with torch.cuda.device(device):
        code = _build.library().edl_fused_lookup_fm(
            table.data_ptr(), bet.data_ptr() if bet is not None else None,
            ids.data_ptr(), valid_u8.data_ptr(), acts.data_ptr(),
            first.data_ptr(), sum_v.data_ptr(), sum_sq.data_ptr(), batch,
            fields, spec.rows_per_block, spec.num_blocks, spec.dim_padded,
            spec.dim, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "fused_lookup_fm")
    _count_launch("fused_lookup_fm")
    return acts, first, sum_v, sum_sq
