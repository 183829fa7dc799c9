"""Pad-to-bucket staging for serving batches.

The port's copy of the shared pad-and-stage step of
``elasticdl_tpu/data/pipeline.py``: a dispatched batch is padded to the
smallest power-of-two bucket that holds it, so the device sees at most
``len(buckets)`` batch shapes.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def bucket_sizes(max_batch_size: int) -> Tuple[int, ...]:
    """Power-of-two padding buckets up to (and including) the max batch
    size."""
    if max_batch_size < 1:
        raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
    sizes = []
    size = 1
    while size < max_batch_size:
        sizes.append(size)
        size *= 2
    sizes.append(max_batch_size)
    return tuple(sizes)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket holding n rows."""
    for size in buckets:
        if n <= size:
            return size
    return buckets[-1]


def pad_features(features: Dict[str, np.ndarray], rows: int) -> Dict[str, np.ndarray]:
    """Zero-pad every array of a features dict to `rows` along axis 0.
    Id 0 is a valid embedding row, but pad rows' outputs are sliced off
    before any request sees them and model rows are independent."""
    out = {}
    for key, array in features.items():
        array = np.asarray(array)
        if array.shape[0] == rows:
            out[key] = array
            continue
        pad = np.zeros((rows - array.shape[0],) + array.shape[1:], array.dtype)
        out[key] = np.concatenate([array, pad], axis=0)
    return out


def pad_and_stage(
    features: Dict[str, np.ndarray], rows: int, buckets: Sequence[int]
) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad `features` (stacked live rows) to the smallest admitting
    bucket.  Returns (padded, bucket).  The JAX package's optional
    staging callback (a device copy started before execute) waits for a
    caller that needs it."""
    bucket = bucket_for(rows, buckets)
    return pad_features(features, bucket), bucket
