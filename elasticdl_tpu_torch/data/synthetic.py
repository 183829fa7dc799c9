"""Synthetic training data: the port's own copies of the JAX zoo's
``synthetic_ctr_reader`` and ``synthetic_lm_reader`` arrays, of its
vision readers (``synthetic_mnist_reader``, ``synthetic_cifar10_reader``
and ``synthetic_imagenet_reader``, ``model_zoo/datasets.py:30-98``) and
of its ``synthetic://`` path parser.

The vision readers make the same draws in the same order as the JAX
ones, so one seed gives the same uint8 images and int32 labels: a
class-dependent bright patch on uniform noise, so accuracy can move.
MNIST and CIFAR-10 are whole arrays (``NumpyDataReader``); ImageNet
draws each image when its record is read, from a per-record seed, so a
224x224x3 set never sits in memory whole.

For the click data (Criteo layout), the same
``numpy.random.default_rng(seed)`` draws in the same order give the same
dense features, categories and labels, bit for bit: a record's
label depends on a sparse set of (field, id) weights plus a linear term
on the dense features, so both the embedding path and the dense path must
learn for the loss to fall.  Built whole-array at once (the reader builds
a list of per-record tuples); ``SyntheticCTRReader`` serves them as the
reader's records, ``({"dense": f32 [13], "cat": i32 [26]}, label)``, and
builds the arrays only when a worker first reads (the master counts
records from the path alone).

Census (``model_zoo/datasets.py:207-292``): RAW records, strings and
unscaled floats, the input the preprocessing layers exist for;
``synthetic_census_reader`` makes the JAX reader's draws in its order,
so one seed gives the same records value for value, the labels taken at
the median of all ``n`` logits.
"""

from __future__ import annotations

import urllib.parse
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.data.reader import AbstractDataReader, NumpyDataReader

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


def synthetic_lm_arrays(
    n: int = 2048, seq_len: int = 128, vocab: int = 256, seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Next-token data, ``(tokens i32 [n, seq_len], next_tokens i32 [n,
    seq_len])``: an affine bigram chain (``next = 3 * tok + 7 mod vocab``)
    with 10% uniform noise, the same draws in the same order as the JAX
    zoo's reader, so the same seed gives the same arrays."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, vocab, size=n)
    noise = rng.random(size=(n, seq_len)) < 0.1
    noise_tok = rng.integers(0, vocab, size=(n, seq_len))
    seqs = np.empty((n, seq_len + 1), np.int32)
    seqs[:, 0] = starts
    for t in range(seq_len):
        nxt = (3 * seqs[:, t] + 7) % vocab
        seqs[:, t + 1] = np.where(noise[:, t], noise_tok[:, t], nxt)
    return seqs[:, :-1].copy(), seqs[:, 1:].copy()


def parse_synthetic_path(data_path: str) -> Tuple[Optional[str], Dict[str, int]]:
    """``'synthetic://lm?n=4096&seed=3'`` -> ``('lm', {'n': 4096, 'seed':
    3})``; any other scheme -> ``(None, {})``."""
    parsed = urllib.parse.urlparse(data_path)
    if parsed.scheme != "synthetic":
        return None, {}
    params = {
        key: int(values[0])
        for key, values in urllib.parse.parse_qs(parsed.query).items()
    }
    return parsed.netloc, params


# Census raw-feature vocabularies (the census dataset the reference's
# preprocessing layers were built for).
CENSUS_EDUCATION = [
    "Bachelors", "HS-grad", "11th", "Masters", "9th", "Some-college",
    "Assoc-acdm", "Assoc-voc", "7th-8th", "Doctorate", "Prof-school",
    "5th-6th", "10th", "1st-4th", "Preschool", "12th",
]
CENSUS_WORKCLASS = [
    "Private", "Self-emp-not-inc", "Self-emp-inc", "Federal-gov",
    "Local-gov", "State-gov", "Without-pay", "Never-worked",
]
CENSUS_OCCUPATIONS = [f"occupation-{i}" for i in range(40)]  # high cardinality: hashed


def synthetic_census_records(n: int = 4096, seed: int = 0) -> list:
    """``n`` census records ``({"age", "capital_gain", "hours_per_week":
    f32, "education", "workclass", "occupation": str}, i32 label)``; the
    label depends on every feature family, so a model only learns when
    its preprocessing wires them all through."""
    rng = np.random.default_rng(seed)
    age = rng.uniform(17, 90, size=n).astype(np.float32)
    gain = np.abs(rng.normal(3000, 8000, size=n)).astype(np.float32)
    hours = rng.uniform(1, 99, size=n).astype(np.float32)
    edu_idx = rng.integers(0, len(CENSUS_EDUCATION), size=n)
    work_idx = rng.integers(0, len(CENSUS_WORKCLASS), size=n)
    occ_idx = rng.integers(0, len(CENSUS_OCCUPATIONS), size=n)
    w_edu = rng.standard_normal(len(CENSUS_EDUCATION)).astype(np.float32)
    w_work = rng.standard_normal(len(CENSUS_WORKCLASS)).astype(np.float32)
    w_occ = rng.standard_normal(len(CENSUS_OCCUPATIONS)).astype(np.float32)
    logits = (w_edu[edu_idx] + w_work[work_idx] + w_occ[occ_idx] + 0.03 * (hours - 40.0)
              + 0.02 * (age - 40.0) + gain / 20000.0)
    labels = (logits > np.median(logits)).astype(np.int32)
    return [
        ({"age": age[i], "capital_gain": gain[i], "hours_per_week": hours[i],
          "education": CENSUS_EDUCATION[edu_idx[i]],
          "workclass": CENSUS_WORKCLASS[work_idx[i]],
          "occupation": CENSUS_OCCUPATIONS[occ_idx[i]]}, labels[i])
        for i in range(n)
    ]


class SyntheticCensusReader(AbstractDataReader):
    """The records of ``synthetic_census_records`` for every task range,
    built when a worker first reads (the master counts them from the
    path alone)."""

    def __init__(self, n: int = 4096, seed: int = 0, shard_name: str = "census-synth",
                 **kwargs):
        super().__init__(**kwargs)
        self._n = int(n)
        self._seed = int(seed)
        self._shard_name = shard_name
        self._records = None
        self._lock = threading.Lock()

    def create_shards(self):
        return {self._shard_name: self._n}

    def records(self) -> list:
        with self._lock:
            if self._records is None:
                self._records = synthetic_census_records(self._n, self._seed)
            return self._records

    def read_records(self, task):
        records = self.records()
        for i in range(task.start, min(task.end, self._n)):
            yield records[i]


def synthetic_census_reader(n: int = 4096, seed: int = 0,
                            shard_name: str = "census-synth") -> SyntheticCensusReader:
    return SyntheticCensusReader(n=n, seed=seed, shard_name=shard_name)


class SyntheticCTRReader(AbstractDataReader):
    """The records of the JAX zoo's ``synthetic_ctr_reader``
    (``model_zoo/datasets.py:101-140``) for every task range, from
    ``synthetic_ctr_arrays``."""

    def __init__(self, n: int, vocab_size: int = 1000, seed: int = 0,
                 shard_name: str = "ctr-synth", **kwargs):
        super().__init__(**kwargs)
        self._n = int(n)
        self._vocab = int(vocab_size)
        self._seed = int(seed)
        self._shard_name = shard_name
        self._arrays = None
        self._lock = threading.Lock()

    def create_shards(self):
        return {self._shard_name: self._n}

    def arrays(self):
        """``(features, labels)`` of every record, built once."""
        with self._lock:
            if self._arrays is None:
                self._arrays = synthetic_ctr_arrays(self._n, vocab_size=self._vocab,
                                                    seed=self._seed)
            return self._arrays

    def read_records(self, task):
        features, labels = self.arrays()
        dense, cats = features["dense"], features["cat"]
        for i in range(task.start, min(task.end, self._n)):
            yield {"dense": dense[i], "cat": cats[i]}, labels[i]


def synthetic_mnist_reader(n: int = 4096, seed: int = 0, shard_name: str = "mnist-synth"):
    """28x28 uint8 images, the label's 7x5 patch set to 200."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = rng.integers(0, 64, size=(n, 28, 28)).astype(np.uint8)
    for cls in range(10):
        rows = (cls // 5) * 14 + 3
        cols = (cls % 5) * 5 + 1
        images[labels == cls, rows:rows + 7, cols:cols + 5] = 200
    return NumpyDataReader(images, labels, shard_name=shard_name)


def synthetic_cifar10_reader(n: int = 4096, seed: int = 0, shard_name: str = "cifar-synth"):
    """32x32x3 uint8 images, the label's 8x6 patch of one channel set to 220."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = rng.integers(0, 64, size=(n, 32, 32, 3)).astype(np.uint8)
    for cls in range(10):
        rows = (cls // 5) * 16 + 3
        cols = (cls % 5) * 6 + 1
        images[labels == cls, rows:rows + 8, cols:cols + 6, cls % 3] = 220
    return NumpyDataReader(images, labels, shard_name=shard_name)


class SyntheticImagenetReader(AbstractDataReader):
    """``image_size``^2 x 3 uint8 images drawn per record, the label's
    12x12 patch of one channel set to 220 at a grid position."""

    def __init__(self, n: int = 1024, seed: int = 0, image_size: int = 224,
                 num_classes: int = 1000, shard_name: str = "imagenet-synth", **kwargs):
        super().__init__(**kwargs)
        rng = np.random.default_rng(seed)
        self._n = int(n)
        self._labels = rng.integers(0, num_classes, size=n).astype(np.int32)
        self._seeds = rng.integers(0, 2**31 - 1, size=n)
        self._size = int(image_size)
        self._grid = max(1, image_size // 16)
        self._shard_name = shard_name

    def create_shards(self):
        return {self._shard_name: self._n}

    @property
    def labels(self) -> np.ndarray:
        """Every record's int32 label."""
        return self._labels

    def image(self, i: int) -> np.ndarray:
        s = self._size
        image = np.random.default_rng(int(self._seeds[i])).integers(
            0, 64, size=(s, s, 3)).astype(np.uint8)
        cls = int(self._labels[i])
        row = (cls // self._grid) % self._grid * 16
        col = (cls % self._grid) * 16
        image[row:row + 12, col:col + 12, cls % 3] = 220
        return image

    def read_records(self, task):
        for i in range(task.start, min(task.end, self._n)):
            yield self.image(i), self._labels[i]
