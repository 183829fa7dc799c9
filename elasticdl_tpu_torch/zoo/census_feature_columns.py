"""Census Wide&Deep declared through the feature-column glue: the port of
``model_zoo/census/census_feature_columns.py``.

The schema is declared once (``FEATURES``): three normalised numeric
columns, education and workclass by vocabulary, occupation hashed into
64 bins, age bucketized and education crossed with occupation into 128
bins, every categorical column embedded at dim 8 in one group, a shared
id space of 229 rows.  The input pipeline (``FEATURES(batch)`` -> ``dense``
``[B, 3]`` and ``cat`` ``[B, 5]``, all on the host) and the table sizes
fall out of it.  The model: ``wide_embedding`` (dim 1, summed over the
columns) plus ``Dense_1`` over ``Dense_0`` (32, relu) over the
``deep_embedding`` vectors and the dense features.

The sibling ``census_wide_deep`` wires the transforms by hand; both read
the same raw census records.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data import synthetic
from elasticdl_tpu_torch.layers.embedding import Embedding
from elasticdl_tpu_torch.parallel import optim, sparse_optim
from elasticdl_tpu_torch.preprocessing import Normalizer
from elasticdl_tpu_torch.preprocessing.feature_column import (
    FeatureLayer,
    bucketized_column,
    categorical_column_with_hash_bucket,
    categorical_column_with_vocabulary_list,
    crossed_column,
    embedding_column,
    numeric_column,
)
from elasticdl_tpu_torch.zoo.census_wide_deep import custom_data_reader  # noqa: F401
from elasticdl_tpu_torch.zoo.deepfm import _init_linear
from elasticdl_tpu_torch.zoo.wide_and_deep import eval_metrics_fn, loss  # noqa: F401

# ---- the schema, declared once -------------------------------------------

AGE = numeric_column("age", Normalizer.from_stats(40.0, 15.0))
GAIN = numeric_column("capital_gain", Normalizer.from_stats(3000.0, 8000.0))
HOURS = numeric_column("hours_per_week", Normalizer.from_stats(40.0, 12.0))

EDUCATION = categorical_column_with_vocabulary_list(
    "education", synthetic.CENSUS_EDUCATION, num_oov_indices=1)
WORKCLASS = categorical_column_with_vocabulary_list(
    "workclass", synthetic.CENSUS_WORKCLASS, num_oov_indices=1)
OCCUPATION = categorical_column_with_hash_bucket("occupation", 64)
AGE_BUCKETS = bucketized_column(AGE, [18, 25, 30, 35, 40, 45, 50, 55, 60, 65])
EDU_X_OCC = crossed_column(["education", "occupation"], 128)

FEATURES = FeatureLayer([
    AGE,
    GAIN,
    HOURS,
    embedding_column(EDUCATION, 8),
    embedding_column(WORKCLASS, 8),
    embedding_column(OCCUPATION, 8),
    embedding_column(AGE_BUCKETS, 8),
    embedding_column(EDU_X_OCC, 8),
])
#: The embedded columns and the numeric ones.
NUM_CAT_COLUMNS = 5
NUM_DENSE = 3


class CensusFeatureColumnModel(nn.Module):
    def __init__(self, hidden: int = 32, device=None):
        super().__init__()
        vocab, dim = FEATURES.embedding_specs()["default"]
        self.wide_embedding = Embedding(vocab, 1, combiner="sum", device=device)
        self.deep_embedding = Embedding(vocab, dim, device=device)
        self.Dense_0 = nn.Linear(NUM_CAT_COLUMNS * dim + NUM_DENSE, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, 1, device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation, flax's defaults."""
        self.wide_embedding.init_parameters(generator)
        self.deep_embedding.init_parameters(generator)
        for layer in (self.Dense_0, self.Dense_1):
            _init_linear(layer, generator)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        wide = self.wide_embedding(features["cat"])[..., 0]
        deep_emb = self.deep_embedding(features["cat"])
        deep_in = torch.cat([deep_emb.reshape(deep_emb.shape[0], -1),
                             features["dense"].to(torch.float32)], dim=-1)
        x = torch.relu(self.Dense_0(deep_in))
        return wide + self.Dense_1(x)[..., 0]  # logit


def custom_model(hidden: int = 32, device=None) -> CensusFeatureColumnModel:
    """The JAX ``custom_model`` contract, built on ``device`` (None: the
    CUDA card; weights uninitialised)."""
    return CensusFeatureColumnModel(hidden=hidden, device=resolve_device(device))


def optimizer(lr: float = 0.01) -> optim.DenseOptimizer:
    return optim.adam(lr)


def embedding_optimizer(lr: float = 0.01) -> sparse_optim.SparseOptimizer:
    return sparse_optim.adam(lr)


def dataset_fn(dataset, mode, metadata):
    def parse(record):
        raw, label = record
        inputs = FEATURES({k: np.asarray([v]) for k, v in raw.items()})
        return {k: v[0] for k, v in inputs.items()}, np.int32(label)

    dataset = dataset.map(parse)
    if mode == "training":
        dataset = dataset.shuffle(2048, seed=0)
    return dataset
