"""FSDP placement of dense state: the port of JAX's ``dense_sharding=
"fsdp"`` rule (``elasticdl_tpu/parallel/dp_trainer.py:69,106-134``).

A parameter shards over the ``data`` axis when dim 0 of its FLAX layout
divides the axis and it has at least ``FSDP_MIN_LEAF`` elements; its
optimizer slots follow it, and everything else replicates.  The rule
reads the flax layout because that is the layout of JAX's state and of
its sharded checkpoints: dim 0 of a flax ``Dense`` kernel ``[in, out]``
is dim 1 of the port's ``nn.Linear.weight [out, in]``, and a conv
kernel is ``HWIO`` there, ``OIHW`` here.  So a leaf's block is a
flax-layout block: ``FsdpLeaf.block`` permutes the port's tensor into
the flax layout and takes its dim-0 rows, and a checkpoint writes those
rows as JAX does (``checkpoint/sharded.py``).

The optimizers of ``parallel/optim.py`` are elementwise, so a block's
update is the whole update's block, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

#: Elements below which a leaf replicates (JAX's ``FSDP_MIN_LEAF``).
FSDP_MIN_LEAF = 1024

#: The convert kinds whose port layout is a permutation of flax's:
#: port dims -> flax dims (``flax = port.permute(perm)``).
_FLAX_PERM = {"dense_kernel": (1, 0), "conv_kernel": (2, 3, 1, 0)}


@dataclass(frozen=True)
class FsdpLeaf:
    """One sharded parameter: its port ``name``, the permutation of its
    port dims into the flax layout, its flax shape and the number of
    blocks (the data axis)."""

    name: str
    perm: Tuple[int, ...]
    flax_shape: Tuple[int, ...]
    blocks: int

    @property
    def rows(self) -> int:
        """Flax dim-0 rows of one block."""
        return self.flax_shape[0] // self.blocks

    @property
    def block_shape(self) -> Tuple[int, ...]:
        return (self.rows,) + self.flax_shape[1:]

    def to_flax(self, port: torch.Tensor) -> torch.Tensor:
        return port.permute(self.perm) if self.perm else port

    def to_port(self, flax: torch.Tensor) -> torch.Tensor:
        return flax.permute(tuple(np.argsort(self.perm))) if self.perm else flax

    def block(self, port: torch.Tensor, index: int) -> torch.Tensor:
        """Block ``index`` of a whole port-layout tensor: its flax rows,
        a contiguous copy (never a view: the whole's memory is freed)."""
        rows = self.to_flax(port)[index * self.rows:(index + 1) * self.rows]
        return rows.clone(memory_format=torch.contiguous_format)

    def flax_blocks(self, port: torch.Tensor) -> torch.Tensor:
        """A whole port-layout tensor as ``[blocks, rows * ...]``: the
        flax layout, contiguous, one block per row (what a reduce-scatter
        over the data axis takes flattened)."""
        return self.to_flax(port).contiguous().reshape(self.blocks, -1)


def plan(model: nn.Module, data: int) -> Dict[str, FsdpLeaf]:
    """``{parameter name: FsdpLeaf}`` of the parameters JAX's rule shards
    over a data axis of ``data`` slots (none when ``data`` is 1: FSDP is
    then the replicated layout)."""
    from elasticdl_tpu_torch.serving.convert import _targets

    if data <= 1:
        return {}
    params = dict(model.named_parameters())
    leaves = {}
    for _, port_key, kind, _ in _targets(model):
        param = params.get(port_key)
        if param is None or param.dim() == 0:
            continue
        perm = _FLAX_PERM.get(kind, ())
        flax_shape = tuple(param.permute(perm).shape) if perm else tuple(param.shape)
        if flax_shape[0] % data or param.numel() < FSDP_MIN_LEAF:
            continue
        leaves[port_key] = FsdpLeaf(port_key, perm, flax_shape, data)
    return leaves


def free_storage(param: torch.Tensor) -> None:
    """Release a gathered parameter's memory, keeping its shape: its data
    becomes a fresh tensor whose storage is emptied (the old storage may
    be pinned by a numpy view, which makes it impossible to resize)."""
    freed = torch.empty_like(param)
    freed.untyped_storage().resize_(0)
    param.data = freed


def alloc_storage(param: torch.Tensor) -> None:
    """Give a freed parameter memory again (values undefined)."""
    if param.untyped_storage().size() != param.numel() * param.element_size():
        param.data = torch.empty_like(param)
