"""DeepFM (Criteo/DAC click-through) — the port of
``model_zoo/deepfm/deepfm_functional_api.py``.

Same structure and parameter names as the flax module, so the JAX
variables map one to one (``serving/convert.py``):

- 26 categorical fields share one offset id space over the Embedding
  layer: ONE merged table of dim ``1+d`` by default (lane 0 the
  first-order weight, lanes 1..d the FM/deep field vector, looked up by
  ``fused_lookup_fm`` together with the FM partial sums), or under
  ``split_tables`` two tables, ``linear_embedding`` (dim 1) and
  ``fm_embedding`` (dim d), each through ``fused_lookup``.
- ``linear_dense``: Dense(1) over the 13 numeric features.
- ``dense_projection``: flax ``DenseGeneral((13, d), axis=-1)`` on
  ``[B, 1, 13]`` (kernel ``[13, 13, d]``, bias ``[13, d]``), kept as an
  einsum.
- FM second order by the sum-square trick over all 39 fields; the deep
  tower ``Dense_0 [(26+13)*d -> hidden]``, ``Dense_1 [-> hidden//2]``,
  ``Dense_2 [-> 1]`` over the flattened fields.

Training-only parameters (``sparse_apply_every``, ``sparse_kernel``)
are accepted so an artifact's recorded params build the model; they
decide nothing on the card beyond the JAX package's table-layout rule
(``_split``), which they must reproduce for the variables to match.
``mesh`` (a ``parallel.mesh.Mesh``) is threaded into the Embedding
layers, whose lookups then take the sharded dispatch over it, and puts
the model on the mesh's device.

The model-zoo contract of the JAX module: ``loss`` (sigmoid binary cross
entropy, batch mean), ``optimizer`` (dense Adam 1e-3),
``embedding_optimizer`` (sparse per-row Adam 1e-3), ``dataset_fn``
(parse, then in training a 4096-record shuffle seeded 0),
``columnar_dataset_fn`` (whole-column casts, then in training one
permutation seeded by the task), ``eval_metrics_fn`` (accuracy, AUC) and
``custom_data_reader`` (``synthetic://criteo?n=&vocab=&seed=``, or
Criteo-layout ETRF: one ``.etrf`` file or a directory of them, read by
``CriteoRecordReader``; ``write_criteo_etrf`` writes such a file).  ``init_parameters``
draws flax's default initialisation from a ``torch.Generator``:
lecun-normal kernels, zero biases, the Embedding layer's uniform tables.
In training the Embedding layers pass their perturbation capture through
(``layers/embedding.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data import recordfile
from elasticdl_tpu_torch.data.columnar import training_permutation
from elasticdl_tpu_torch.data.reader import FixedWidthEtrfReader, is_etrf_dir
from elasticdl_tpu_torch.data.synthetic import SyntheticCTRReader, parse_synthetic_path
from elasticdl_tpu_torch.data.vectorized import RecordLayout
from elasticdl_tpu_torch.layers.embedding import Embedding
from elasticdl_tpu_torch.parallel import optim, sparse_optim
from elasticdl_tpu_torch.parallel.mesh import resolve_mesh

NUM_DENSE = 13
NUM_CAT = 26
VOCAB = 1000

#: The JAX model's auto table-layout crossover (rows of the merged
#: table), and the PS trainer's auto apply rule it is paired with.
SPLIT_TABLE_ROWS = 10_000_000
AUTO_APPLY_TABLE_ROWS = 10_000_000
AUTO_APPLY_W = 32

_SPARSE_KERNELS = ("xla", "fused", "auto")


def use_split_tables(
    split_tables, sparse_apply_every: int, sparse_kernel, total_vocab: int
) -> bool:
    """The JAX ``DeepFM._split`` rule: an explicit ``split_tables`` wins;
    otherwise split only under strict per-step apply above
    ``SPLIT_TABLE_ROWS`` rows on the xla sparse engine.  ``None`` and
    ``'auto'`` resolve to ``'xla'`` as they do in the JAX package."""
    if sparse_kernel is not None and sparse_kernel not in _SPARSE_KERNELS:
        raise ValueError(
            f"sparse_kernel must be one of {_SPARSE_KERNELS}, got {sparse_kernel!r}"
        )
    if split_tables is not None:
        return bool(split_tables)
    return (
        sparse_apply_every <= 1
        and total_vocab > SPLIT_TABLE_ROWS
        and sparse_kernel != "fused"
    )


#: flax's truncated-normal correction: the std of a unit normal cut at
#: +-2, so the truncated draw has the requested variance.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal (+-2 std) of variance
    ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral(features=(13, d), axis=-1)`` applied to a
    ``[B, 1, 13]`` input: ``out[b, i, j] = sum_k x[b, k] kernel[k, i, j]
    + bias[i, j]``."""

    def __init__(self, in_features: int, features: tuple, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty((in_features, *features), device=device)
        )
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bk,kij->bij", x, self.kernel) + self.bias

    def init_parameters(self, generator: torch.Generator) -> None:
        # flax folds the input axes into fan_in: kernel [in, *features].
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        nn.init.zeros_(self.bias)


def _init_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    lecun_normal_(layer.weight, layer.in_features, generator)
    nn.init.zeros_(layer.bias)


class DeepFM(nn.Module):
    def __init__(
        self,
        vocab_size: int = VOCAB,
        embedding_dim: int = 8,
        hidden: int = 128,
        split_tables=None,
        sparse_apply_every: int = 1,
        sparse_kernel=None,
        mesh=None,
        device=None,
    ):
        super().__init__()
        self.mesh = mesh
        self.vocab_size = vocab_size
        self.embedding_dim = embedding_dim
        total_vocab = vocab_size * NUM_CAT
        self.split = use_split_tables(
            split_tables, sparse_apply_every, sparse_kernel, total_vocab
        )
        d = embedding_dim
        self.linear_dense = nn.Linear(NUM_DENSE, 1, device=device)
        self.dense_projection = DenseGeneral(
            NUM_DENSE, (NUM_DENSE, d), device=device
        )
        if self.split:
            self.linear_embedding = Embedding(total_vocab, 1, mesh=mesh, device=device)
            self.fm_embedding = Embedding(total_vocab, d, mesh=mesh, device=device)
        else:
            self.fm_embedding = Embedding(
                total_vocab, 1 + d, fm_interaction=True, mesh=mesh, device=device
            )
        self.Dense_0 = nn.Linear((NUM_CAT + NUM_DENSE) * d, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, hidden // 2, device=device)
        self.Dense_2 = nn.Linear(hidden // 2, 1, device=device)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation, flax's defaults (draws in module order)."""
        _init_linear(self.linear_dense, generator)
        self.dense_projection.init_parameters(generator)
        if self.split:
            self.linear_embedding.init_parameters(generator)
        self.fm_embedding.init_parameters(generator)
        for layer in (self.Dense_0, self.Dense_1, self.Dense_2):
            _init_linear(layer, generator)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        dense = features["dense"].to(torch.float32)          # [B, 13]
        cats = features["cat"].to(torch.int32)               # [B, 26]
        batch = cats.shape[0]
        offsets = (
            torch.arange(cats.shape[-1], dtype=torch.int32, device=cats.device)
            * self.vocab_size
        )
        flat_ids = cats + offsets[None, :]

        first_dense = self.linear_dense(dense)[..., 0]
        dense_emb = self.dense_projection(dense)             # [B, 13, d]
        if self.split:
            linear = self.linear_embedding(flat_ids)         # [B, 26, 1]
            first_cat = torch.sum(linear[..., 0], dim=-1)
            cat_emb = self.fm_embedding(flat_ids)            # [B, 26, d]
            fields = torch.cat([cat_emb, dense_emb], dim=1)
            sum_fields = torch.sum(fields, dim=1)
            second = 0.5 * torch.sum(
                sum_fields * sum_fields - torch.sum(fields * fields, dim=1),
                dim=-1,
            )
        else:
            cat_acts, first_cat, sum_v, sum_sq = self.fm_embedding(flat_ids)
            cat_emb = cat_acts[..., 1:]                      # [B, 26, d]
            fields = torch.cat([cat_emb, dense_emb], dim=1)
            sum_dense = torch.sum(dense_emb, dim=1)
            sumsq_dense = torch.sum(dense_emb * dense_emb, dim=1)
            total_sum = sum_v + sum_dense
            second = 0.5 * torch.sum(
                total_sum * total_sum - (sum_sq + sumsq_dense), dim=-1
            )

        x = fields.reshape(batch, -1)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        deep = self.Dense_2(x)[..., 0]
        return first_cat + first_dense + second + deep      # logit


def custom_model(
    vocab_size: int = VOCAB,
    embedding_dim: int = 8,
    hidden: int = 128,
    split_tables=None,
    sparse_apply_every: "int | str" = 1,
    sparse_kernel=None,
    mesh: Any = None,
    device=None,
) -> DeepFM:
    """The JAX ``custom_model`` contract, built on ``device`` (None: the
    CUDA card, or the mesh's device; weights uninitialised).
    ``sparse_apply_every='auto'`` resolves from the table rows exactly as
    the JAX package does, since it decides the table layout.  ``mesh``
    goes to the Embedding layers (their lookups' dispatch mesh)."""
    mesh = resolve_mesh(mesh, "the port's DeepFM")
    if mesh is not None:
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        device = mesh.device
    if sparse_apply_every == "auto":
        total_rows = vocab_size * NUM_CAT * (2 if split_tables else 1)
        sparse_apply_every = (
            1 if total_rows <= AUTO_APPLY_TABLE_ROWS else AUTO_APPLY_W
        )
    return DeepFM(
        vocab_size=vocab_size,
        embedding_dim=embedding_dim,
        hidden=hidden,
        split_tables=split_tables,
        sparse_apply_every=int(sparse_apply_every),
        sparse_kernel=sparse_kernel,
        mesh=mesh,
        device=resolve_device(device),
    )


def loss(labels: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy(predictions, labels).mean()``."""
    labels = labels.to(predictions.dtype)
    log_p = torch.nn.functional.logsigmoid(predictions)
    log_not_p = torch.nn.functional.logsigmoid(-predictions)
    return (-labels * log_p - (1.0 - labels) * log_not_p).mean()


def optimizer(lr: float = 0.001) -> optim.DenseOptimizer:
    return optim.adam(lr)


def embedding_optimizer(lr: float = 0.001) -> sparse_optim.SparseOptimizer:
    return sparse_optim.adam(lr)


def dataset_fn(dataset, mode, metadata):
    """JAX ``deepfm_functional_api.py:216``: each record to
    ``({"dense": f32, "cat": i32}, i32 label)``, shuffled in training."""
    def parse(record):
        features, label = record
        return (
            {
                "dense": np.asarray(features["dense"], np.float32),
                "cat": np.asarray(features["cat"], np.int32),
            },
            np.int32(label),
        )

    dataset = dataset.map(parse)
    if mode == "training":
        dataset = dataset.shuffle(4096, seed=0)
    return dataset


def columnar_dataset_fn(columns, mode, metadata, seed: int = 0):
    """JAX ``deepfm_functional_api.py:233``: the columnar task path's
    counterpart of ``dataset_fn`` (``data/columnar.py``): whole-column
    casts and, in training, one permutation seeded by the task (the same
    on every rank, different for every task and epoch)."""
    features = {
        "dense": np.ascontiguousarray(columns["dense"], np.float32),
        "cat": np.ascontiguousarray(columns["cat"], np.int32),
    }
    labels = columns["label"][:, 0].astype(np.int32)
    if mode == "training":
        perm = training_permutation(len(labels), seed=seed)
        features = {k: v[perm] for k, v in features.items()}
        labels = labels[perm]
    return features, labels


def _auc(outputs, labels):
    """JAX ``model_zoo/wide_and_deep/wide_and_deep.py:114``: the rank-sum
    AUC of logits against 0/1 labels (0.5 when a class is missing)."""
    order = np.argsort(outputs)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(outputs) + 1)
    pos = labels.astype(bool)
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def eval_metrics_fn():
    """JAX ``deepfm_functional_api.py:253``: accuracy of ``logit > 0`` and
    AUC, over a whole evaluation round's outputs and labels."""
    return {
        "accuracy": lambda outputs, labels: np.mean(
            (outputs > 0).astype(np.int64) == labels.astype(np.int64)
        ),
        "auc": _auc,
    }


def criteo_record_layout() -> RecordLayout:
    """One Criteo record in an ETRF file: 13 f32, 26 i32, a u8 label
    (157 bytes, little-endian, packed)."""
    return RecordLayout([
        ("dense", np.float32, NUM_DENSE),
        ("cat", np.int32, NUM_CAT),
        ("label", np.uint8, 1),
    ])


def write_criteo_etrf(path: str, dense, cat, label) -> int:
    """Write ``n`` Criteo records (``dense [n, 13]``, ``cat [n, 26]``,
    ``label [n]`` or ``[n, 1]``) to one ETRF file in
    ``criteo_record_layout``; returns ``n``."""
    n = len(dense)
    rows = np.concatenate([
        np.ascontiguousarray(dense, np.float32).view(np.uint8),
        np.ascontiguousarray(cat, np.int32).view(np.uint8),
        np.asarray(label, np.uint8).reshape(n, 1),
    ], axis=1)
    return recordfile.write_records(path, (row.tobytes() for row in rows))


class CriteoRecordReader(FixedWidthEtrfReader):
    """Criteo-layout ETRF, one file or a directory of shard files, each
    a shard of the master's queue.  The columnar path parses whole
    chunks; ``read_records`` yields the per-record path's items."""

    def __init__(self, path: str, **kwargs):
        super().__init__(path, **kwargs)
        self._layout = criteo_record_layout()

    def layout(self):
        return self._layout

    def _row(self, cols, i):
        return (
            {"dense": cols["dense"][i], "cat": cols["cat"][i]},
            np.int32(cols["label"][i, 0]),
        )


def custom_data_reader(data_path: str, **kwargs):
    """JAX ``deepfm_functional_api.py:298``: ``synthetic://`` paths give the
    zoo's generated records, a ``.etrf`` file or a directory of them
    (``recordio:`` prefix allowed) a ``CriteoRecordReader``; None for any
    other path."""
    name, params = parse_synthetic_path(data_path)
    if name is not None:
        return SyntheticCTRReader(
            n=params.get("n", 4096),
            vocab_size=params.get("vocab", VOCAB),
            seed=params.get("seed", 0),
            shard_name="criteo-synth",
        )
    path = data_path.removeprefix("recordio:")
    if path.endswith(".etrf") or is_etrf_dir(path):
        return CriteoRecordReader(path)
    return None
