"""Feature-column glue: the port of
``elasticdl_tpu/preprocessing/feature_column.py``.

Declarative feature specs over the transforms (``numeric_column``,
``bucketized_column``, ``categorical_column_with_*``,
``crossed_column``, ``embedding_column``): a model declares its input
schema once, and a ``FeatureLayer`` compiles the columns into ONE host
transform, ``raw batch dict -> {"dense": [B, D] f32, "cat": [B, K]
i32}``, with fixed shapes, strings resolved on the host and every
categorical family offset into a disjoint range of one shared id space
(``ConcatenateWithOffset``).  The model then needs one
``layers.Embedding(total_id_space, dim)`` per embedding group.

Everything here is host numpy, ``NumericColumn``'s ``Normalizer``
included.  The ``FeatureLayer`` a ``dataset_fn`` uses is the one serving
callers use.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from elasticdl_tpu_torch.preprocessing.layers import (
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    IndexLookup,
    Normalizer,
    RoundIdentity,
)


class FeatureColumn:
    """Base: every column names the raw feature(s) it consumes."""

    key: str


@dataclass
class NumericColumn(FeatureColumn):
    key: str
    normalizer: Optional[Normalizer] = None

    def values(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        x = np.asarray(batch[self.key], np.float32)
        if self.normalizer is not None:
            x = self.normalizer(x)
        return x.reshape(len(x), -1)


class CategoricalColumn(FeatureColumn):
    """Base for id-producing columns: ``num_ids`` sizes the id space,
    ``ids(batch)`` gives ``[B]`` (or ``[B, W]``) int32 in ``[0,
    num_ids)``, negative for padding."""

    @property
    def num_ids(self) -> int:
        raise NotImplementedError

    def ids(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        raise NotImplementedError


@dataclass
class HashedCategoricalColumn(CategoricalColumn):
    key: str
    hashing: Hashing

    @property
    def num_ids(self) -> int:
        return self.hashing.num_bins

    def ids(self, batch):
        return np.asarray(self.hashing(np.asarray(batch[self.key])), np.int32)


@dataclass
class VocabCategoricalColumn(CategoricalColumn):
    key: str
    lookup: IndexLookup

    @property
    def num_ids(self) -> int:
        return self.lookup.vocab_size

    def ids(self, batch):
        return self.lookup(np.asarray(batch[self.key]))


@dataclass
class IdentityCategoricalColumn(CategoricalColumn):
    key: str
    round_identity: RoundIdentity

    @property
    def num_ids(self) -> int:
        return self.round_identity.max_value

    def ids(self, batch):
        return np.asarray(self.round_identity(np.asarray(batch[self.key])), np.int32)


@dataclass
class BucketizedColumn(CategoricalColumn):
    source: NumericColumn
    discretization: Discretization

    @property
    def key(self) -> str:  # type: ignore[override]
        return self.source.key

    @property
    def num_ids(self) -> int:
        return self.discretization.num_bins

    def ids(self, batch):
        # The RAW value is bucketized, before the source's normalizer.
        raw = np.asarray(batch[self.source.key], np.float32)
        return np.asarray(self.discretization(raw), np.int32)


@dataclass
class CrossedColumn(CategoricalColumn):
    keys: Tuple[str, ...]
    hashing: Hashing

    @property
    def key(self) -> str:  # type: ignore[override]
        return "_x_".join(self.keys)

    @property
    def num_ids(self) -> int:
        return self.hashing.num_bins

    def ids(self, batch):
        # Each column str-cast once and the columns joined with "\x01",
        # byte for byte as the JAX package joins them (the crossed ids
        # depend on it).
        cols = [np.char.mod("%s", np.asarray(batch[k]).ravel()) for k in self.keys]
        joined = cols[0]
        for col in cols[1:]:
            joined = np.char.add(np.char.add(joined, "\x01"), col)
        return np.asarray(self.hashing(joined), np.int32)


@dataclass
class EmbeddingColumn(FeatureColumn):
    """A categorical column for dense-embedding treatment, with the table
    width the model should use; columns of one ``group`` share a table."""

    categorical: CategoricalColumn
    dimension: int
    group: str = "default"

    @property
    def key(self) -> str:  # type: ignore[override]
        return self.categorical.key


# -- constructors under the reference's public names ---------------------


def numeric_column(key: str, normalizer: Optional[Normalizer] = None):
    return NumericColumn(key, normalizer)


def bucketized_column(source: NumericColumn, boundaries: Sequence[float]):
    return BucketizedColumn(source, Discretization(boundaries))


def categorical_column_with_hash_bucket(key: str, hash_bucket_size: int):
    return HashedCategoricalColumn(key, Hashing(hash_bucket_size))


def categorical_column_with_vocabulary_list(key: str, vocabulary: Sequence[str],
                                            num_oov_indices: int = 1):
    return VocabCategoricalColumn(key, IndexLookup(vocabulary, num_oov_indices))


def categorical_column_with_identity(key: str, num_buckets: int):
    return IdentityCategoricalColumn(key, RoundIdentity(num_buckets))


def crossed_column(keys: Sequence[str], hash_bucket_size: int):
    return CrossedColumn(tuple(keys), Hashing(hash_bucket_size, salt=2))


def embedding_column(categorical: CategoricalColumn, dimension: int, group: str = "default"):
    return EmbeddingColumn(categorical, dimension, group)


def shared_embedding_columns(categoricals: Sequence[CategoricalColumn], dimension: int,
                             group: str = "shared"):
    return [EmbeddingColumn(c, dimension, group) for c in categoricals]


# -- the layer ------------------------------------------------------------


@dataclass
class _Group:
    columns: List[CategoricalColumn] = field(default_factory=list)
    dimension: int = 0


class FeatureLayer:
    """Declared columns -> one batch transform.

    ``__call__(raw)`` takes a dict of same-length raw feature arrays and
    returns the model inputs: ``"dense"`` ``[B, D]`` f32, the numeric
    columns in declaration order (absent when there are none), and per
    embedding group ``"cat"`` (the default group) or ``"cat_<group>"``,
    ``[B, K]`` int32 ids offset into the group's shared id space.

    ``embedding_specs()`` -> ``{group: (total_id_space, dimension)}``
    sizes the model's Embedding tables.  Bare CategoricalColumns join the
    default group with dimension 0."""

    def __init__(self, columns: Sequence[FeatureColumn]):
        self._numeric: List[NumericColumn] = []
        self._groups: Dict[str, _Group] = {}
        for col in columns:
            if isinstance(col, NumericColumn):
                self._numeric.append(col)
            elif isinstance(col, EmbeddingColumn):
                group = self._groups.setdefault(col.group, _Group())
                group.columns.append(col.categorical)
                if group.dimension and group.dimension != col.dimension:
                    raise ValueError(
                        f"Embedding group {col.group!r} mixes dimensions "
                        f"{group.dimension} and {col.dimension}")
                group.dimension = col.dimension
            elif isinstance(col, CategoricalColumn):
                self._groups.setdefault("default", _Group()).columns.append(col)
            else:
                raise TypeError(f"Not a feature column: {col!r}")
        self._offsets = {
            name: ConcatenateWithOffset([c.num_ids for c in group.columns])
            for name, group in self._groups.items()
        }

    def _cat_key(self, group: str) -> str:
        return "cat" if group == "default" else f"cat_{group}"

    def embedding_specs(self) -> Dict[str, Tuple[int, int]]:
        return {name: (self._offsets[name].total_id_space, group.dimension)
                for name, group in self._groups.items()}

    def total_id_space(self, group: str = "default") -> int:
        return self._offsets[group].total_id_space

    def __call__(self, raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        if self._numeric:
            out["dense"] = np.concatenate(
                [c.values(raw) for c in self._numeric], axis=-1).astype(np.float32)
        for name, group in self._groups.items():
            id_cols = [c.ids(raw) for c in group.columns]
            out[self._cat_key(name)] = np.asarray(self._offsets[name](id_cols), np.int32)
        return out
