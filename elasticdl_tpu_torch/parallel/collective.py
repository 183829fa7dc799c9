"""Control-plane collectives that report failure as a status: the part of
``elasticdl_tpu/parallel/collective.py`` (``CollectiveCommunicator`` :34)
the worker's restore-consistency check needs, a broadcast over the mesh's
process group.

A peer that dies mid-collective makes ``torch.distributed`` raise; the
communicator returns FAILED instead, and the caller decides (the worker
exits so the pod manager re-forms the world).  The per-step gradient
reductions are the trainers' own, not this class.  ``allreduce`` and
``barrier`` wait for a caller (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import enum
from typing import Any, Optional

import numpy as np
import torch

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("parallel.collective")


class CollectiveResult(enum.Enum):
    SUCCEEDED = 0
    FAILED = 1


class CollectiveCommunicator:
    """Collectives over ``mesh``'s processes (all of them: the default
    group); a mesh of one process, or none, needs no communication."""

    def __init__(self, mesh):
        self._mesh = mesh

    def _multi_process(self) -> bool:
        return self._mesh is not None and not self._mesh.in_process and self._mesh.size > 1

    def broadcast(self, data: Optional[Any], root: int = 0):
        """``(status, data)``: the root process's numeric ``data`` on every
        process (its dtype and shape, which every rank must share)."""
        if not self._multi_process():
            return CollectiveResult.SUCCEEDED, data
        import torch.distributed as dist

        try:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend() == "nccl" else torch.device("cpu"))
            tensor = torch.as_tensor(np.asarray(data)).to(device)
            dist.broadcast(tensor, src=root)
            return CollectiveResult.SUCCEEDED, tensor.cpu().numpy()
        except Exception as exc:  # a peer's failure -> a status, not a crash
            logger.error("broadcast failed: %s", exc)
            return CollectiveResult.FAILED, None
