"""Inference-only Embedding layer over the port's lookup kernels.

Counterpart of ``elasticdl_tpu/layers/embedding.py`` ``Embedding``, with
its fixed-vocabulary contract: ids outside ``[0, vocab)`` contribute
zeros (negative ids are padding, ids ``>= vocab`` out of vocabulary).
They are replaced by the safe id 0 before the lookup and masked after it,
so the kernels' clamp rule never decides a result.

The table is the buffer ``embedding`` of shape ``[vocab_padded,
dim_padded]`` (``parallel/packed.py``).  There is no engine switch: on a
CUDA tensor the lookup IS the kernel, on a CPU tensor its plain version.
The training-only parts of the JAX layer (perturbation capture, id
``sow``s, OOV counters) wait for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel.packed import PackedSpec


class Embedding(nn.Module):
    """ids int [batch] or [batch, length] -> activations.

    combiner: None returns per-position vectors ``[..., dim]``;
    ``'sum'``/``'mean'`` reduce the trailing length axis.
    fm_interaction: the DeepFM merged-table mode: ids ``[batch, fields]``
    -> ``(acts [batch, fields, dim], first [batch], sum_v [batch,
    dim-1], sum_sq [batch, dim-1])`` from one ``fused_lookup_fm`` pass.
    """

    def __init__(
        self,
        vocab_size: int,
        embedding_dim: int,
        combiner: Optional[str] = None,
        fm_interaction: bool = False,
        device=None,
    ):
        super().__init__()
        if combiner not in (None, "sum", "mean"):
            raise ValueError(f"Unknown combiner {combiner!r}")
        if fm_interaction and combiner is not None:
            raise ValueError("fm_interaction excludes a combiner")
        self.spec = PackedSpec(vocab_size, embedding_dim)
        self.combiner = combiner
        self.fm_interaction = fm_interaction
        # Uninitialised: a loader fills it (serving/convert.load_state);
        # at full width it is gigabytes, so it is never zero-filled first.
        self.register_buffer(
            "embedding",
            torch.empty(self.spec.rows_shape, dtype=torch.float32, device=device),
        )

    def extra_repr(self) -> str:
        return (
            f"vocab_size={self.spec.vocab_size}, dim={self.spec.dim}, "
            f"combiner={self.combiner}, fm_interaction={self.fm_interaction}"
        )

    def forward(self, ids: torch.Tensor):
        spec = self.spec
        ids = ids.to(torch.int32)
        valid = (ids >= 0) & (ids < spec.vocab_size)
        safe_ids = torch.where(valid, ids, torch.zeros_like(ids))
        if self.fm_interaction:
            if ids.dim() != 2:
                raise ValueError("fm_interaction requires ids of shape [batch, fields]")
            return ske.fused_lookup_fm(spec, self.embedding, None, safe_ids, valid)
        acts = ske.fused_lookup(spec, self.embedding, safe_ids.reshape(-1))
        acts = acts.reshape(safe_ids.shape + (spec.dim,))
        acts = acts * valid[..., None].to(acts.dtype)
        if self.combiner is None:
            return acts
        if ids.dim() < 2:
            raise ValueError("combiner requires ids of shape [batch, length]")
        summed = torch.sum(acts, dim=-2)
        if self.combiner == "sum":
            return summed
        counts = torch.clamp(
            torch.sum(valid.to(acts.dtype), dim=-1, keepdim=True), min=1.0
        )
        return summed / counts
