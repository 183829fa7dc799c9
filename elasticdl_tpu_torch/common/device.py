"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``.  ``None`` means the CUDA
card: the port never drops to the CPU on its own, so a run that was meant
for the card and finds none fails at once instead of serving from the
host at a fraction of the speed.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

#: What a list of several real devices driven from one process raises:
#: the one part of ROADMAP.md Queue 1 item 5 still to port.  A
#: ``parallel.mesh.Mesh`` (in-process, or one rank per card) is ported,
#: and every mode runs over it: context and tensor parallelism, FSDP,
#: and the sharded sparse dispatch.
MULTI_CARD_ITEM = "ROADMAP.md Queue 1 item 5, multi-card routing"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; anything else -> ``torch.device(device)``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device is available.
    """
    resolved = torch.device("cuda", 0) if device is None else torch.device(device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "elasticdl_tpu_torch runs on a CUDA device by default, and no "
            "CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the host"
        )
    return resolved


def require_one_device(mesh, what: str, item: str = MULTI_CARD_ITEM) -> None:
    """Raise ``NotImplementedError`` unless ``mesh`` is None, a device, or
    a mesh (or list) of one device: ``what`` runs on one card, and a
    mesh of more waits for ``item``."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        return
    devices = getattr(mesh, "devices", mesh)
    if int(np.size(np.asarray(devices, dtype=object))) != 1:
        raise NotImplementedError(
            f"{what} runs on one card: a mesh of more than one device waits for {item}"
        )
