"""The image data plane: the port's copy of ``elasticdl_tpu/data/image.py``
(``image_record_layout`` :34, ``write_image_etrf`` :45,
``random_crop_flip`` :59, ``center_crop`` :97).

Images are stored decoded, fixed-size, uint8 HWC, one record per image
with its int32 label, so a whole ETRF chunk parses into an ``[n,
S*S*C]`` array with one numpy view (``data/vectorized.py``) and no
per-record Python.  Augmentation stays uint8 on the host: a random crop
from the stored size and a horizontal flip in the training transform, a
center crop in evaluation.  The model normalises on the card (the
ResNet-50 zoo's ``normalize`` head), so the host ships raw uint8.  The
bytes of a file and the draws of a crop are the JAX package's: one seed
gives the same crops and flips in both.
"""

from __future__ import annotations

import numpy as np

from elasticdl_tpu_torch.data import recordfile
from elasticdl_tpu_torch.data.vectorized import RecordLayout


def image_record_layout(size: int, channels: int = 3) -> RecordLayout:
    """Fixed-width record: ``[size*size*channels]`` uint8 image + int32
    label."""
    return RecordLayout([
        ("image", np.uint8, size * size * channels),
        ("label", np.int32, 1),
    ])


def write_image_etrf(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    """Pack ``[n, S, S, C]`` uint8 images and ``[n]`` labels into one ETRF
    file, each record the image's bytes then the label's."""
    images = np.ascontiguousarray(images, np.uint8)
    n = images.shape[0]
    flat = images.reshape((n, -1))
    lab = np.ascontiguousarray(labels, np.int32).reshape((n, 1))
    buf = np.concatenate([flat, lab.view(np.uint8)], axis=1)
    recordfile.write_records(path, (row.tobytes() for row in buf))


def random_crop_flip(
    images: np.ndarray,
    out_size: int,
    rng: np.random.Generator,
    flip: bool = True,
    order: np.ndarray = None,
) -> np.ndarray:
    """Training augmentation on uint8 ``[B, S, S, C]``: a random
    ``out_size`` crop per sample (``S >= out_size``; equal sizes crop
    nothing) and a random horizontal flip.  ``order``, a permutation of
    the batch, folds the training shuffle into the crop's gather: output
    row ``i`` is a crop of ``images[order[i]]``, so the stored-size array
    is never copied just to reorder it.  The draws: ``dy``, ``dx``, then
    the flips, each over the whole batch."""
    b, s, c = images.shape[0], images.shape[1], images.shape[3]
    if s < out_size:
        raise ValueError(f"stored size {s} < crop size {out_size}")
    if order is None:
        order = np.arange(b)
    out = np.empty((b, out_size, out_size, c), np.uint8)
    span = s - out_size + 1
    dy = rng.integers(0, span, size=b)
    dx = rng.integers(0, span, size=b)
    do_flip = rng.random(b) < 0.5 if flip else np.zeros(b, bool)
    for i in range(b):
        # One strided copy per sample; the flip is a reversed-stride view
        # of the same copy, not a second pass.
        src = images[order[i], dy[i]:dy[i] + out_size, dx[i]:dx[i] + out_size]
        out[i] = src[:, ::-1] if do_flip[i] else src
    return out


def center_crop(images: np.ndarray, out_size: int) -> np.ndarray:
    """Evaluation's deterministic crop, ``[B, S, S, C]`` uint8 ->
    ``out_size``."""
    s = images.shape[1]
    if s < out_size:
        raise ValueError(f"stored size {s} < crop size {out_size}")
    lo = (s - out_size) // 2
    return np.ascontiguousarray(images[:, lo:lo + out_size, lo:lo + out_size])
