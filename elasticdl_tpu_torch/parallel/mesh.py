"""Device meshes: the port of ``elasticdl_tpu/parallel/mesh.py``.

The axis conventions are the JAX package's: a mesh of shape (data,
model), ``data`` the data-parallel axis (the batch), ``model`` the axis
that carries the sequence for context-parallel attention.  A world of
``data * model`` slots is laid out row-major, so slot ``r`` sits at
``(r // model, r % model)``, as ``np.reshape`` lays out the JAX mesh's
devices.

``build_mesh`` builds one of two kinds:

- **A process mesh**: one slot per rank of the initialised default
  process group, each rank on ``cuda:{LOCAL_RANK}`` with NCCL, or on the
  CPU with gloo (the tests rehearse the multi-card path that way).  It
  carries the model-axis and data-axis subgroups of this rank.
- **An in-process mesh**: ``virtual_devices(n, device)`` gives n slots
  in this process on one device, the counterpart of the JAX package's
  ``force_virtual_cpu_devices``; it runs on the CPU and on the card
  alike.  Its slots share one device and one process, so nothing is
  reduced over its data axis and its ring's rotation is a list roll.

Anything else raises.

The axis helpers (``axis_index``, ``axis_all_reduce``,
``axis_all_gather``) are what the sharded sparse dispatch and the PS
trainer share: on a process mesh they run the collective in the axis's
subgroup; on an in-process mesh they are the loop over the slots or the
identity that its layout implies.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.common.device import (
    MULTI_CARD_ITEM,
    DeviceLike,
    require_one_device,
    resolve_device,
)

logger = logging.getLogger("elasticdl_tpu_torch.parallel.mesh")

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. -1 for ``data`` means "all remaining slots"."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int]:
        model = max(1, self.model)
        if n_devices % model != 0:
            raise ValueError(f"model axis {model} does not divide device count {n_devices}")
        data = self.data if self.data != -1 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != device count {n_devices}")
        return data, model


@dataclass(frozen=True)
class VirtualDevice:
    """Slot ``id`` of an in-process mesh, computing on ``device``."""

    id: int
    device: torch.device


def virtual_devices(n: int, device: DeviceLike = None) -> List[VirtualDevice]:
    """n slots in this process on one device (None: the CUDA card)."""
    if n < 1:
        raise ValueError(f"virtual_devices needs n >= 1, got {n}")
    resolved = resolve_device(device)
    return [VirtualDevice(i, resolved) for i in range(n)]


class Mesh:
    """A (data, model) mesh of slots.  ``shape`` maps each axis to its
    size; ``device`` is where this process computes.  On a process mesh,
    ``data_index``/``model_index`` place this rank, ``group(axis)`` is
    its subgroup along ``axis`` and ``axis_ranks(axis)`` that group's
    global ranks in axis order."""

    def __init__(self, devices: np.ndarray, device: torch.device, rank: Optional[int] = None,
                 groups: Optional[dict] = None):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))
        self.device = device
        self.rank = rank
        self._groups = groups or {}

    @property
    def in_process(self) -> bool:
        return self.rank is None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data_index(self) -> int:
        return self._index()[0]

    @property
    def model_index(self) -> int:
        return self._index()[1]

    def _index(self) -> Tuple[int, int]:
        if self.in_process:
            raise ValueError("an in-process mesh holds every slot: it has no index of its own")
        return divmod(self.rank, self.shape[MODEL_AXIS])

    def axis_ranks(self, axis: str) -> List[int]:
        data_index, model_index = self._index()
        line = self.devices[data_index] if axis == MODEL_AXIS else self.devices[:, model_index]
        return [int(r) for r in line]

    def group(self, axis: str):
        self._index()
        return self._groups[axis]

    def gather_sequence(self, part: torch.Tensor, seq_len: int,
                        positions: Callable[[int], Optional[np.ndarray]]) -> torch.Tensor:
        """Every rank's ``part`` ``[rows, T_here, ...]`` assembled into
        ``[rows * data, seq_len, ...]`` (a collective: every rank calls it
        with a part of one shape): a rank's rows are those of its data
        index, its sequence rows the global positions
        ``positions(model_index)`` (None: the whole sequence)."""
        rows = part.shape[0]
        full = torch.empty((rows * self.shape[DATA_AXIS], seq_len) + tuple(part.shape[2:]),
                           dtype=part.dtype, device=part.device)
        parts = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(parts, part.contiguous())
        for rank, got in enumerate(parts):
            data_index, model_index = divmod(rank, self.shape[MODEL_AXIS])
            pos = positions(model_index)
            where = slice(None) if pos is None else torch.from_numpy(pos).to(part.device)
            full[data_index * rows:(data_index + 1) * rows, where] = got
        return full

    def __repr__(self) -> str:
        kind = "in-process" if self.in_process else f"process rank {self.rank}"
        return (f"Mesh({self.shape[DATA_AXIS]}x{self.shape[MODEL_AXIS]} "
                f"({DATA_AXIS} x {MODEL_AXIS}), {kind}, on {self.device})")


def axis_index(mesh: Mesh, axis: str) -> Tuple[int, ...]:
    """The indices along ``axis`` of the slots this process computes:
    its own on a process mesh, every one on an in-process mesh (whose
    callers loop over them)."""
    if mesh.in_process:
        return tuple(range(mesh.shape[axis]))
    return (mesh.data_index if axis == DATA_AXIS else mesh.model_index,)


def axis_all_reduce(mesh: Mesh, axis: str, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over ``axis`` of the parts this process holds along it: on
    a process mesh its one part, all-reduced (SUM) in the axis's
    subgroup; on an in-process mesh the parts, added in slot order."""
    if mesh.in_process:
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total
    (part,) = parts
    out = part.contiguous().clone()
    dist.all_reduce(out, group=mesh.group(axis))
    return out


def axis_all_gather(mesh: Mesh, axis: str, tensor: torch.Tensor) -> torch.Tensor:
    """Every slot's ``tensor`` along ``axis`` concatenated on dim 0 in
    axis order (``all_gather(tiled=True)``): a collective in the axis's
    subgroup on a process mesh; on an in-process mesh, which holds the
    whole axis, the tensor as it is."""
    if mesh.in_process or mesh.shape[axis] == 1:
        return tensor
    parts = [torch.empty_like(tensor) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, tensor.contiguous(), group=mesh.group(axis))
    return torch.cat(parts)


def _process_mesh(config: MeshConfig) -> Mesh:
    world, rank = dist.get_world_size(), dist.get_rank()
    data, model = config.resolve(world)
    backend = dist.get_backend()
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None
                              else rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"a process mesh runs on nccl (cards) or gloo (CPU), not {backend!r}")
    grid = np.arange(world).reshape(data, model)
    # Every rank creates every subgroup, in one order (new_group is
    # collective); each keeps its own.
    data_index, model_index = divmod(rank, model)
    groups = {}
    for d in range(data):
        group = dist.new_group([int(r) for r in grid[d]])
        if d == data_index:
            groups[MODEL_AXIS] = group
    for m in range(model):
        group = dist.new_group([int(r) for r in grid[:, m]])
        if m == model_index:
            groups[DATA_AXIS] = group
    return Mesh(grid, device, rank=rank, groups=groups)


def build_mesh(config: MeshConfig = MeshConfig(), devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh: over the ranks of the default process group
    (``devices=None``; every rank calls it) or over ``virtual_devices``
    of one device in this process."""
    if devices is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                "build_mesh(devices=None) builds a process mesh and needs an initialised "
                "default process group (torch.distributed.init_process_group); an in-process "
                "mesh takes devices=virtual_devices(n, device)"
            )
        mesh = _process_mesh(config)
    else:
        devices = list(devices)
        if not devices or not all(isinstance(d, VirtualDevice) for d in devices) \
                or len({d.device for d in devices}) != 1:
            raise NotImplementedError(
                "build_mesh builds a process mesh (devices=None: one rank per card) or an "
                "in-process mesh (devices=virtual_devices(n, device)); several real devices "
                f"driven from one process wait for {MULTI_CARD_ITEM}"
            )
        data, model = config.resolve(len(devices))
        mesh = Mesh(np.asarray(devices, dtype=object).reshape(data, model), devices[0].device)
    logger.info("Built %r", mesh)
    return mesh


def resolve_mesh(mesh, what: str) -> Optional[Mesh]:
    """A ``Mesh`` as it is; None, a device or a one-device list -> None
    (one card); anything else raises ``NotImplementedError`` naming
    ``what``."""
    if isinstance(mesh, Mesh):
        return mesh
    require_one_device(mesh, what, f"a Mesh from parallel.mesh.build_mesh ({MULTI_CARD_ITEM})")
    return None
