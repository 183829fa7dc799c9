"""Census Wide&Deep over RAW features: the port of
``model_zoo/census/census_wide_deep.py``, the preprocessing-layer
showcase.

Records arrive as raw strings and unscaled floats
(``data.synthetic.synthetic_census_reader``) and every transform runs on
the way in:

- HOST (``dataset_fn`` and ``preprocess_record``): education and
  workclass through ``IndexLookup``, occupation through
  ``Hashing(64)``;
- DEVICE (inside ``forward``, on the card): age through
  ``Discretization``, hours through ``RoundIdentity(100)``, capital gain
  through ``Normalizer``, and every id column through
  ``ConcatenateWithOffset`` into ONE shared id space of 201 rows, looked
  up by two Embedding layers: ``wide_embedding`` (dim 1, summed over the
  five columns) and ``deep_embedding`` (dim 8), whose vectors with the
  normalised gain feed ``Dense_0`` (32, relu) and ``Dense_1`` (1).

The transform objects are module-level singletons: the same ones serve
training's ``dataset_fn`` and serving callers.  The zoo contract:
``loss`` (sigmoid binary cross entropy), ``optimizer`` (dense Adam
0.01), ``embedding_optimizer`` (sparse per-row Adam 0.01, the fused
apply kernel on the card), ``dataset_fn`` (``preprocess_record``, then in
training a 2048-record shuffle seeded 0), ``eval_metrics_fn`` (accuracy,
AUC) and ``custom_data_reader`` (``synthetic://census?n=&seed=``).
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
from elasticdl_tpu_torch.preprocessing import (
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    IndexLookup,
    Normalizer,
    RoundIdentity,
)
from elasticdl_tpu_torch.zoo.deepfm import _init_linear
from elasticdl_tpu_torch.zoo.wide_and_deep import eval_metrics_fn, loss  # noqa: F401

# ---- HOST transforms ----------------------------------------------------

EDUCATION_LOOKUP = IndexLookup(synthetic.CENSUS_EDUCATION, num_oov_indices=1)
WORKCLASS_LOOKUP = IndexLookup(synthetic.CENSUS_WORKCLASS, num_oov_indices=1)
OCCUPATION_HASH = Hashing(num_bins=64)

# ---- DEVICE transforms --------------------------------------------------

AGE_BUCKETS = Discretization([18, 25, 30, 35, 40, 45, 50, 55, 60, 65])
HOURS_ID = RoundIdentity(max_value=100)
GAIN_NORM = Normalizer.from_stats(mean=3000.0, std=8000.0)

# One shared table: each feature family offset into a disjoint id range.
ID_SPACES = ConcatenateWithOffset([
    EDUCATION_LOOKUP.vocab_size,
    WORKCLASS_LOOKUP.vocab_size,
    OCCUPATION_HASH.num_bins,
    AGE_BUCKETS.num_bins,
    HOURS_ID.max_value,
])
#: The id columns, in ID_SPACES' order.
NUM_ID_COLUMNS = 5


class CensusWideDeep(nn.Module):
    def __init__(self, embedding_dim: int = 8, hidden: int = 32, device=None):
        super().__init__()
        total = ID_SPACES.total_id_space
        self.wide_embedding = Embedding(total, 1, combiner="sum", device=device)
        self.deep_embedding = Embedding(total, embedding_dim, device=device)
        self.Dense_0 = nn.Linear(NUM_ID_COLUMNS * embedding_dim + 1, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, 1, device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation, flax's defaults."""
        self.wide_embedding.init_parameters(generator)
        self.deep_embedding.init_parameters(generator)
        for layer in (self.Dense_0, self.Dense_1):
            _init_linear(layer, generator)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        # The device transforms, on the features' device.
        age_ids = AGE_BUCKETS(features["age"])
        hour_ids = HOURS_ID(features["hours_per_week"])
        gain = GAIN_NORM(features["capital_gain"])[:, None]
        ids = ID_SPACES([features["edu_id"], features["work_id"], features["occ_id"],
                         age_ids, hour_ids])
        wide = self.wide_embedding(ids)[..., 0]
        deep_emb = self.deep_embedding(ids)
        deep_in = torch.cat([deep_emb.reshape(deep_emb.shape[0], -1), gain], dim=-1)
        x = torch.relu(self.Dense_0(deep_in))
        return wide + self.Dense_1(x)[..., 0]  # logit


def custom_model(embedding_dim: int = 8, hidden: int = 32, device=None) -> CensusWideDeep:
    """The JAX ``custom_model`` contract, built on ``device`` (None: the
    CUDA card; weights uninitialised)."""
    return CensusWideDeep(embedding_dim=embedding_dim, hidden=hidden,
                          device=resolve_device(device))


def preprocess_record(raw: dict) -> dict:
    """A raw census dict -> the model's features (the host transforms):
    what ``dataset_fn`` applies in training and serving callers apply to
    a request."""
    return {
        "edu_id": EDUCATION_LOOKUP(np.asarray([raw["education"]]))[0],
        "work_id": WORKCLASS_LOOKUP(np.asarray([raw["workclass"]]))[0],
        "occ_id": OCCUPATION_HASH(np.asarray([raw["occupation"]], object))[0],
        "age": np.float32(raw["age"]),
        "hours_per_week": np.float32(raw["hours_per_week"]),
        "capital_gain": np.float32(raw["capital_gain"]),
    }


def optimizer(lr: float = 0.01) -> optim.DenseOptimizer:
    return optim.adam(lr)


def embedding_optimizer(lr: float = 0.01) -> sparse_optim.SparseOptimizer:
    return sparse_optim.adam(lr)


def dataset_fn(dataset, mode, metadata):
    def parse(record):
        raw, label = record
        return preprocess_record(raw), np.int32(label)

    dataset = dataset.map(parse)
    if mode == "training":
        dataset = dataset.shuffle(2048, seed=0)
    return dataset


def custom_data_reader(data_path: str, **kwargs):
    """``synthetic://census?n=&seed=`` -> the synthetic census records;
    None for any other path."""
    name, params = synthetic.parse_synthetic_path(data_path)
    if name != "census":
        return None
    return synthetic.synthetic_census_reader(n=params.get("n", 4096),
                                             seed=params.get("seed", 0))
