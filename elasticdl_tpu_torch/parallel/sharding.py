"""Batch and table placement over a mesh: the port of
``elasticdl_tpu/parallel/sharding.py`` (:41-165).

The data-parallel batch must divide the ``data`` axis, so a ragged batch
is padded and the padding rows are masked out of the loss (no record is
dropped).  On a process mesh each rank takes the rows of its data index
(``shard_batch``) and holds only its own rows of a table split over an
axis (``place_rows``); ``gather_to_host`` assembles the full rows again
(export, state snapshots, the tests).  An in-process mesh holds every
slot, so there each of them is the identity.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch.parallel.mesh import DATA_AXIS, axis_all_gather


def data_axis_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape[DATA_AXIS]


def pad_batch(tree, multiple: int) -> Tuple[Any, np.ndarray]:
    """Every array's leading dim up to a multiple of ``multiple``, the
    padding rows repeating row 0 (an empty batch pads with zeros to one
    whole block); -> ``(tree, mask)``, the mask 1 for real rows."""
    if isinstance(tree, dict):
        padded = {k: pad_batch(v, multiple)[0] for k, v in tree.items()}
        return padded, pad_batch(next(iter(tree.values())), multiple)[1]
    x = np.asarray(tree)
    batch = x.shape[0]
    rows = -(-batch // multiple) * multiple if batch else multiple
    mask = np.ones((rows,), np.float32)
    mask[batch:] = 0.0
    if rows == batch:
        return x, mask
    if batch == 0:
        return np.zeros((rows,) + x.shape[1:], x.dtype), mask
    return np.concatenate([x, np.repeat(x[:1], rows - batch, axis=0)]), mask


def _on_process_axis(mesh, axis: Optional[str]) -> bool:
    return axis is not None and mesh is not None and not mesh.in_process \
        and mesh.shape[axis] > 1


def axis_rows(n: int, mesh, axis: Optional[str]) -> slice:
    """The rows of an ``n``-row leaf split over ``axis`` that this
    process holds: its block on a process mesh, all of them otherwise."""
    if not _on_process_axis(mesh, axis):
        return slice(0, n)
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(f"{n} rows do not split over the {size} slots of {axis!r}")
    index = mesh.data_index if axis == DATA_AXIS else mesh.model_index
    rows = n // size
    return slice(index * rows, (index + 1) * rows)


def shard_batch(tree, mesh):
    """This process's rows of a batch already padded to the data axis:
    the rows of its data index on a process mesh, the whole batch on an
    in-process mesh or none."""
    if not _on_process_axis(mesh, DATA_AXIS):
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    return tree[axis_rows(len(tree), mesh, DATA_AXIS)]


def place_rows(tensor: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """A whole table (or table-shaped slot) placed on ``mesh``: a copy of
    this rank's rows when it is split over ``axis`` on a process mesh,
    else the tensor itself (an in-process mesh splits it into row views
    at dispatch)."""
    if not _on_process_axis(mesh, axis):
        return tensor
    return tensor[axis_rows(tensor.shape[0], mesh, axis)].clone()


def gather_to_host(tensor: torch.Tensor, mesh, axis: Optional[str]) -> np.ndarray:
    """The full rows of a placed table as a host array: on a process mesh
    with ``axis`` split, gathered over that axis (a collective: every
    rank of the axis calls it).  Always a copy, never a view of the live
    tensor, on every device."""
    if _on_process_axis(mesh, axis):
        tensor = axis_all_gather(mesh, axis, tensor)
    return tensor.detach().to("cpu", copy=True).numpy()
