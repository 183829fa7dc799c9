"""Control-plane collectives that report failure as a status: the port of
``elasticdl_tpu/parallel/collective.py`` (``CollectiveCommunicator``:
``allreduce`` :46, ``broadcast`` :78, ``barrier`` :95).

These are host-side reductions over the processes of the default
process group (metric sync, the worker's restore-consistency check, a
parameter average on re-formation), on gloo and on NCCL alike.  The
per-step gradient reductions are the trainers' own, not this class.

A peer that dies mid-collective makes ``torch.distributed`` raise; the
communicator returns FAILED instead, and the caller decides (the worker
exits so the pod manager re-forms the world).  A dead gloo peer ends a
collective as soon as its connection closes, at the latest at the
timeout the default group was given (``init_process_group(...,
timeout=)``; ``parallel/elastic.join_world`` sets it), so a caller gets
FAILED and never hangs.
"""

from __future__ import annotations

import enum
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("parallel.collective")


class CollectiveResult(enum.Enum):
    SUCCEEDED = 0
    FAILED = 1


def _process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class CollectiveCommunicator:
    """Collectives over the processes of the default group; one process
    needs no communication.  ``mesh`` is kept for the elastic layer's
    re-formation wiring, as in JAX."""

    def __init__(self, mesh):
        self._mesh = mesh

    def allreduce(self, data: Any, op: str = "MEAN"):
        """``(status, result or None)``: the sum, or the mean, over the
        processes of the host array ``data``, which each process gives
        ONCE, whatever slots it drives (JAX's semantics: the values are
        gathered in rank order and summed with numpy, so every process
        gets the same bits).  An unknown ``op`` is a programming error
        and raises ``ValueError``; a peer's failure returns FAILED."""
        if op not in ("MEAN", "SUM"):
            raise ValueError(f"Unknown allreduce op {op!r}")
        try:
            arr = np.asarray(data)
            n = _process_count()
            if n == 1:
                stacked = arr[None]
            else:
                tensor = torch.as_tensor(np.ascontiguousarray(arr)).to(_collective_device())
                parts = [torch.empty_like(tensor) for _ in range(n)]
                dist.all_gather(parts, tensor, group=dist.group.WORLD)
                stacked = torch.stack(parts).cpu().numpy()
            total = stacked.sum(axis=0)
            if op == "MEAN":
                total = total / stacked.shape[0]
            return CollectiveResult.SUCCEEDED, total
        except Exception as exc:  # a peer's failure -> a status, not a crash
            logger.error("allreduce failed: %s", exc)
            return CollectiveResult.FAILED, None

    def broadcast(self, data: Optional[Any], root: int = 0):
        """``(status, data)``: the root process's numeric ``data`` on every
        process (its dtype and shape, which every rank must share)."""
        if _process_count() == 1:
            return CollectiveResult.SUCCEEDED, data
        try:
            tensor = torch.as_tensor(np.asarray(data)).to(_collective_device())
            dist.broadcast(tensor, src=root, group=dist.group.WORLD)
            return CollectiveResult.SUCCEEDED, tensor.cpu().numpy()
        except Exception as exc:  # a peer's failure -> a status, not a crash
            logger.error("broadcast failed: %s", exc)
            return CollectiveResult.FAILED, None

    def barrier(self, name: str = "barrier"):
        """Every process of the default group reaches ``name`` (the label
        of JAX's ``sync_global_devices``, logged on failure)."""
        try:
            if _process_count() > 1:
                dist.barrier(group=dist.group.WORLD)
            return CollectiveResult.SUCCEEDED
        except Exception as exc:  # a peer's failure -> a status, not a crash
            logger.error("barrier %s failed: %s", name, exc)
            return CollectiveResult.FAILED
