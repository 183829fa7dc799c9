"""Feature-preprocessing layers: the port of
``elasticdl_tpu/preprocessing/layers.py``.

The transforms CTR models need to consume raw strings and floats:
``Hashing``, ``IndexLookup``, ``Discretization``, ``Normalizer``,
``RoundIdentity``, ``ConcatenateWithOffset`` and ``to_padded_ids``.
Each declares where it runs:

- HOST transforms (``Hashing`` over strings, ``IndexLookup``,
  ``to_padded_ids``) run in the data pipeline on numpy and produce the
  fixed-shape integer and float arrays the model consumes.
- DEVICE transforms (``Discretization``, ``Normalizer``,
  ``RoundIdentity``, ``ConcatenateWithOffset``, ``Hashing`` over ints)
  take a numpy array on the host or a torch tensor on its own device and
  give the same results on both, so a model runs them inside ``forward``
  on the card and the data pipeline runs them on the host.

The objects a training ``dataset_fn`` uses are the ones serving callers
use (train == serve consistency).  Ragged id lists become a fixed-width
block padded with -1 (``to_padded_ids``), which ``layers.Embedding``
treats as "no row".
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Sequence, Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor]

_U32 = 0xFFFFFFFF


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def _mul32(h, c: int):
    """``h * c mod 2**32`` for ``h`` in ``[0, 2**32)`` held in int64, with
    no product past 2**49: ``h`` in 16-bit halves."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _mix32(h):
    """Murmur3's fmix32 finalizer on ``uint32`` values held in int64
    (numpy or torch): bit-identical to the JAX package's ``uint32``
    arithmetic, with no unsigned type (torch's ``uint32`` lacks shifts,
    multiplies and ``%`` on several backends)."""
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def _as_u32(x):
    """Integers -> their ``uint32`` value (two's complement wrap, as
    numpy's ``astype(uint32)``), held in int64."""
    if _is_torch(x):
        return x.to(torch.int64) & _U32
    return np.asarray(x).astype(np.int64) & _U32


class Hashing:
    """Deterministic hash-bucketing: x -> [0, num_bins).

    Strings hash on the host (md5, stable across processes; Python's
    salted ``hash()`` is never used); integers hash with murmur3's
    finalizer on the host or the device alike."""

    def __init__(self, num_bins: int, salt: int = 0):
        if num_bins <= 0:
            raise ValueError("num_bins must be positive")
        self.num_bins = num_bins
        self.salt = salt

    def _hash_str(self, s: str) -> int:
        digest = hashlib.md5((f"{self.salt}\x00" + s).encode("utf-8")).digest()
        return int.from_bytes(digest[:8], "little") % self.num_bins

    def __call__(self, x: ArrayLike) -> ArrayLike:
        if not _is_torch(x):
            arr = np.asarray(x)
            if arr.dtype.kind in ("U", "S", "O"):
                flat = arr.ravel()
                out = np.fromiter((self._hash_str(str(s)) for s in flat), count=flat.size,
                                  dtype=np.int32)
                return out.reshape(arr.shape)
            x = arr
        h = _mix32(_as_u32(x) ^ (self.salt & _U32)) % self.num_bins
        return h.to(torch.int32) if _is_torch(h) else h.astype(np.int32)


class IndexLookup:
    """Vocabulary lookup: token -> index; unknown tokens map to OOV ids.

    Indices ``[0, num_oov_indices)`` are the OOV buckets (hashed with
    ``Hashing(salt=1)`` when there is more than one), the vocabulary
    follows.  A HOST transform (strings)."""

    def __init__(self, vocabulary: Sequence[str], num_oov_indices: int = 1):
        if num_oov_indices < 0:
            raise ValueError("num_oov_indices must be >= 0")
        self.vocabulary: List[str] = list(vocabulary)
        self.num_oov_indices = num_oov_indices
        self._table: Dict[str, int] = {
            token: i + num_oov_indices for i, token in enumerate(self.vocabulary)
        }
        self._oov_hash = Hashing(max(1, num_oov_indices), salt=1)

    @property
    def vocab_size(self) -> int:
        """The whole id space, OOV buckets included (an Embedding's rows)."""
        return len(self.vocabulary) + self.num_oov_indices

    def _lookup_one(self, token: str) -> int:
        idx = self._table.get(token)
        if idx is not None:
            return idx
        if self.num_oov_indices == 0:
            raise KeyError(f"Token {token!r} not in vocabulary (no OOV)")
        if self.num_oov_indices == 1:
            return 0
        return int(self._oov_hash(np.asarray([token], object))[0])

    def __call__(self, x) -> np.ndarray:
        arr = np.asarray(x)
        flat = arr.ravel()
        out = np.fromiter((self._lookup_one(str(s)) for s in flat), count=flat.size,
                          dtype=np.int32)
        return out.reshape(arr.shape)


class Discretization:
    """Bucketize by boundaries: value -> bin index in ``[0, len(bins)]``,
    over f32 boundaries; a value equal to a boundary goes to the upper
    bin.  A DEVICE transform."""

    def __init__(self, bin_boundaries: Sequence[float]):
        self.bin_boundaries = [float(b) for b in bin_boundaries]
        if sorted(self.bin_boundaries) != self.bin_boundaries:
            raise ValueError("bin_boundaries must be ascending")

    @property
    def num_bins(self) -> int:
        return len(self.bin_boundaries) + 1

    def __call__(self, x: ArrayLike) -> ArrayLike:
        if _is_torch(x):
            bounds = torch.tensor(self.bin_boundaries, dtype=torch.float32, device=x.device)
            return torch.searchsorted(bounds, x.to(torch.float32).contiguous(),
                                      right=True).to(torch.int32)
        bounds = np.asarray(self.bin_boundaries, np.float32)
        return np.searchsorted(bounds, np.asarray(x, np.float32), side="right").astype(np.int32)


class Normalizer:
    """``(x - subtract) / divide`` elementwise, in f32.  A DEVICE
    transform."""

    def __init__(self, subtract: float = 0.0, divide: float = 1.0):
        if divide == 0.0:
            raise ValueError("divide must be nonzero")
        self.subtract = float(subtract)
        self.divide = float(divide)

    @classmethod
    def from_stats(cls, mean: float, std: float) -> "Normalizer":
        return cls(subtract=mean, divide=std if std else 1.0)

    def __call__(self, x: ArrayLike) -> ArrayLike:
        if _is_torch(x):
            def f32(v):
                return torch.tensor(v, dtype=torch.float32, device=x.device)

            return (x.to(torch.float32) - f32(self.subtract)) / f32(self.divide)
        x = np.asarray(x, np.float32)
        return (x - np.float32(self.subtract)) / np.float32(self.divide)


class RoundIdentity:
    """Round a numeric feature (half to even) into an integer id in
    ``[0, max_value)``.  A DEVICE transform."""

    def __init__(self, max_value: int):
        if max_value <= 0:
            raise ValueError("max_value must be positive")
        self.max_value = int(max_value)

    def __call__(self, x: ArrayLike) -> ArrayLike:
        if _is_torch(x):
            ids = torch.round(x.to(torch.float32))
            return torch.clamp(ids, 0, self.max_value - 1).to(torch.int32)
        ids = np.round(np.asarray(x, np.float32))
        return np.clip(ids, 0, self.max_value - 1).astype(np.int32)


class ConcatenateWithOffset:
    """Concatenate id columns, each offset into a disjoint range of one
    shared id space (one ``[sum(sizes), dim]`` table serves every
    feature with a single lookup).  Negative ids (padding) stay negative;
    1-D columns become ``[B, 1]``.  A DEVICE transform."""

    def __init__(self, id_space_sizes: Sequence[int]):
        self.id_space_sizes = [int(s) for s in id_space_sizes]
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.id_space_sizes[:-1])]).astype(np.int32)

    @property
    def total_id_space(self) -> int:
        return int(sum(self.id_space_sizes))

    def __call__(self, columns: Iterable[ArrayLike]) -> ArrayLike:
        columns = list(columns)
        if len(columns) != len(self.id_space_sizes):
            raise ValueError(
                f"Expected {len(self.id_space_sizes)} columns, got {len(columns)}")
        shifted = []
        if _is_torch(columns[0]):
            for column, offset in zip(columns, self.offsets):
                ids = column.to(torch.int32)
                if ids.dim() == 1:
                    ids = ids[:, None]
                shifted.append(torch.where(ids >= 0, ids + int(offset), ids))
            return torch.cat(shifted, dim=-1)
        for column, offset in zip(columns, self.offsets):
            ids = np.asarray(column, np.int32)
            if ids.ndim == 1:
                ids = ids[:, None]
            shifted.append(np.where(ids >= 0, ids + np.int32(offset), ids))
        return np.concatenate(shifted, axis=-1)


def to_padded_ids(rows: Sequence[Sequence[int]], max_len: int, pad_id: int = -1,
                  dtype=np.int32) -> np.ndarray:
    """Ragged id lists -> a fixed ``[len(rows), max_len]`` block padded
    with ``pad_id`` (``layers.Embedding`` masks ids < 0).  Overlong rows
    keep their first ``max_len`` ids."""
    out = np.full((len(rows), max_len), pad_id, dtype=dtype)
    for i, row in enumerate(rows):
        take = min(len(row), max_len)
        if take:
            out[i, :take] = np.asarray(row[:take], dtype=dtype)
    return out
