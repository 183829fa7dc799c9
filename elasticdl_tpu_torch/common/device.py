"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``.  ``None`` means the CUDA
card: the port never drops to the CPU on its own, so a run that was meant
for the card and finds none fails at once instead of serving from the
host at a fraction of the speed.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


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

