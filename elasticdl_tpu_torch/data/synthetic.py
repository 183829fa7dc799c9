"""Synthetic Criteo-layout click data: the port's own copy of the JAX
zoo's ``synthetic_ctr_reader`` arrays (``model_zoo/datasets.py``).

The same ``numpy.random.default_rng(seed)`` draws in the same order give
the same dense features, categories and labels, bit for bit: a record's
label depends on a sparse set of (field, id) weights plus a linear term
on the dense features, so both the embedding path and the dense path must
learn for the loss to fall.  Built whole-array at once (the reader builds
a list of per-record tuples).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

NUM_DENSE = 13
NUM_CAT = 26


def synthetic_ctr_arrays(
    n: int,
    num_dense: int = NUM_DENSE,
    num_categorical: int = NUM_CAT,
    vocab_size: int = 1000,
    seed: int = 0,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """``({"dense": f32 [n, num_dense], "cat": i32 [n, num_categorical]},
    labels i32 [n])``."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, num_dense)).astype(np.float32)
    cats = rng.integers(0, vocab_size, size=(n, num_categorical)).astype(np.int32)
    field_weights = rng.standard_normal((num_categorical, vocab_size)).astype(np.float32)
    dense_weights = rng.standard_normal((num_dense,)).astype(np.float32)
    cat_logit = np.zeros((n,), np.float32)
    for field in range(num_categorical):  # field by field: the reader's f32 sums
        cat_logit += field_weights[field, cats[:, field]]
    logits = dense @ dense_weights + cat_logit / np.sqrt(num_categorical)
    labels = (logits > np.median(logits)).astype(np.int32)
    return {"dense": dense, "cat": cats}, labels

