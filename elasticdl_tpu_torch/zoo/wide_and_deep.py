"""Wide-and-Deep on Criteo/census-layout ids: the port of
``model_zoo/wide_and_deep/wide_and_deep.py``.

Each of the 26 categorical fields is offset into one shared table of
``vocab_size * 26`` rows (26,000 at the default vocab 1000), looked up
by two Embedding layers: ``wide_embedding`` (dim 1, summed over the
fields: a linear model in the one-hot ids) and ``deep_embedding`` (dim
8), whose field vectors with the 13 dense features feed the tower
``Dense_0`` (64, relu), ``Dense_1`` (32, relu), ``Dense_2`` (1).

The zoo contract: ``loss`` (sigmoid binary cross entropy), ``optimizer``
(dense Adam 0.005), ``embedding_optimizer`` (sparse per-row Adam
0.005), ``dataset_fn`` (parse, then in training a 2048-record shuffle
seeded 0), ``eval_metrics_fn`` (accuracy, AUC: ``_auc``, which census
imports) and ``custom_data_reader`` (``synthetic://<any>?n=&vocab=&seed=``
in the ``census-synth`` shard).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data.synthetic import SyntheticCTRReader, parse_synthetic_path
from elasticdl_tpu_torch.layers.embedding import Embedding
from elasticdl_tpu_torch.parallel import optim, sparse_optim
# The same loss, AUC and metrics as DeepFM's (the JAX zoo's DeepFM takes
# its AUC from this module).
from elasticdl_tpu_torch.zoo.deepfm import _auc, _init_linear, eval_metrics_fn, loss  # noqa: F401

NUM_DENSE = 13
NUM_CAT = 26
VOCAB = 1000


class WideAndDeep(nn.Module):
    def __init__(self, vocab_size: int = VOCAB, embedding_dim: int = 8, hidden: int = 64,
                 device=None):
        super().__init__()
        self.vocab_size = vocab_size
        total_vocab = vocab_size * NUM_CAT
        self.wide_embedding = Embedding(total_vocab, 1, combiner="sum", device=device)
        self.deep_embedding = Embedding(total_vocab, embedding_dim, device=device)
        self.Dense_0 = nn.Linear(NUM_CAT * embedding_dim + NUM_DENSE, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, hidden // 2, device=device)
        self.Dense_2 = nn.Linear(hidden // 2, 1, device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation, flax's defaults."""
        self.wide_embedding.init_parameters(generator)
        self.deep_embedding.init_parameters(generator)
        for layer in (self.Dense_0, self.Dense_1, self.Dense_2):
            _init_linear(layer, generator)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        dense = features["dense"].to(torch.float32)
        cats = features["cat"].to(torch.int32)
        offsets = torch.arange(cats.shape[-1], dtype=torch.int32,
                               device=cats.device) * self.vocab_size
        flat_ids = cats + offsets[None, :]
        wide = self.wide_embedding(flat_ids)[..., 0]
        deep_emb = self.deep_embedding(flat_ids)
        deep_in = torch.cat([deep_emb.reshape(deep_emb.shape[0], -1), dense], dim=-1)
        x = torch.relu(self.Dense_0(deep_in))
        x = torch.relu(self.Dense_1(x))
        return wide + self.Dense_2(x)[..., 0]  # logit


def custom_model(vocab_size: int = VOCAB, embedding_dim: int = 8, hidden: int = 64,
                 device=None) -> WideAndDeep:
    """The JAX ``custom_model`` contract, built on ``device`` (None: the
    CUDA card; weights uninitialised)."""
    return WideAndDeep(vocab_size=vocab_size, embedding_dim=embedding_dim, hidden=hidden,
                       device=resolve_device(device))


def optimizer(lr: float = 0.005) -> optim.DenseOptimizer:
    return optim.adam(lr)


def embedding_optimizer(lr: float = 0.005) -> sparse_optim.SparseOptimizer:
    return sparse_optim.adam(lr)


def dataset_fn(dataset, mode, metadata):
    def parse(record):
        features, label = record
        return ({"dense": np.asarray(features["dense"], np.float32),
                 "cat": np.asarray(features["cat"], np.int32)}, np.int32(label))

    dataset = dataset.map(parse)
    if mode == "training":
        dataset = dataset.shuffle(2048, seed=0)
    return dataset


def custom_data_reader(data_path: str, **kwargs):
    """Any ``synthetic://`` path -> the zoo's generated CTR records
    (``vocab`` ids a field) in the ``census-synth`` shard; None for any
    other path."""
    name, params = parse_synthetic_path(data_path)
    if name is None:
        return None
    return SyntheticCTRReader(n=params.get("n", 4096), vocab_size=params.get("vocab", VOCAB),
                              seed=params.get("seed", 0), shard_name="census-synth")
