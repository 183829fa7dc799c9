"""One rank of a gloo process mesh for tests/test_torch_sharded_training.py:
the port's sharded K1-K3 dispatch over 4 CPU processes, (data=2, model=2).

    python tests/torch_sparse_worker.py RANK WORLD STORE_FILE OUT_DIR

Every rank draws the same global inputs from a seed (``op_inputs``,
``train_batches``) and writes what it computed to
``OUT_DIR/rank{RANK}.npz``:

- ``lookup``, ``fm_{acts,first,sum_v,sum_sq}``: ``fused_lookup`` and
  ``fused_lookup_fm`` over its model shard of the table, on the ids of
  its data index (the rows of its data shard of the output);
- ``apply_{table,m,v,t}``: one sharded adam apply of its data shard's
  ``(ids, grads)`` to its model shard, gathered to full rows;
- ``train_{case}_losses``, ``train_{case}_var_{name}`` and
  ``train_{case}_eval``: 3 ``ShardedEmbeddingTrainer`` steps of a small
  DeepFM from a seeded initialisation (``TRAIN_CASES``: the merged and
  split layouts, strict and ``sparse_apply_every=2``), the gathered
  variables (after a ``state_to_host`` -> ``state`` round trip, which
  must leave them as they were), and ``eval_step`` on the first batch;
- ``serve_{case}``: the trained model exported (rank 0 writes to
  ``OUT_DIR/export_{case}``) and served by a ``ServingReplica`` over the
  mesh (each rank loads its rows), on the first batch.

It imports torch and the port only.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays  # noqa: E402
from elasticdl_tpu_torch.ops import sparse_embedding as ske  # noqa: E402
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from elasticdl_tpu_torch.parallel.packed import PackedSpec  # noqa: E402
from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer  # noqa: E402
from elasticdl_tpu_torch.parallel.sharding import (  # noqa: E402
    gather_to_host,
    place_rows,
    shard_batch,
)
from elasticdl_tpu_torch.serving.export import export_model  # noqa: E402
from elasticdl_tpu_torch.serving.runtime import ServingReplica  # noqa: E402
from elasticdl_tpu_torch.zoo import build_model  # noqa: E402
from elasticdl_tpu_torch.zoo import deepfm  # noqa: E402

MESH = (2, 2)
#: The ops' table: 40 storage blocks of dim 9 (padded 16), split over model.
OP_SPEC = PackedSpec(320, 9)
OP_BATCH, FIELDS = 8, 6
VOCAB, BATCH, STEPS, SEED = 64, 10, 3, 5
#: (name, split_tables, sparse_apply_every)
TRAIN_CASES = (("merged", False, 1), ("split", True, 1), ("merged_w2", False, 2))
ADAM = {"learning_rate": 0.01, "beta_1": 0.9, "beta_2": 0.999, "epsilon": 1e-8}


def op_inputs():
    """(table rows, ids [B, F], valid, bet, apply ids [n], apply grads)."""
    rng = np.random.default_rng(11)
    spec = OP_SPEC
    table = np.zeros(spec.rows_shape, np.float32)
    table[: spec.vocab_size, : spec.dim] = rng.standard_normal((spec.vocab_size, spec.dim))
    ids = rng.integers(0, spec.vocab_padded, (OP_BATCH, FIELDS)).astype(np.int32)
    ids[0, :3] = [-1, spec.vocab_padded, spec.vocab_padded + 9]  # no shard owns these
    ids[1, :2] = ids[2, :2]                                       # duplicates
    valid = rng.random((OP_BATCH, FIELDS)) > 0.2
    bet = rng.standard_normal((OP_BATCH, FIELDS, spec.dim)).astype(np.float32)
    apply_ids = ids.reshape(-1).copy()
    apply_grads = rng.standard_normal((apply_ids.size, spec.dim)).astype(np.float32)
    return table, ids, valid, bet, apply_ids, apply_grads


def train_batches():
    feats, labels = synthetic_ctr_arrays(BATCH * STEPS, vocab_size=VOCAB, seed=SEED)
    feats["cat"][0, :2] = -1            # padding
    feats["cat"][1, 25] = VOCAB + 5     # out of vocabulary
    return [({k: v[i * BATCH:(i + 1) * BATCH] for k, v in feats.items()},
             labels[i * BATCH:(i + 1) * BATCH]) for i in range(STEPS)]


def model_params(split: bool) -> str:
    return f"vocab_size={VOCAB},embedding_dim=4,hidden=16,split_tables={split}"


def train(mesh, split: bool, every: int, device=None, export_dir=None):
    """3 steps of a small DeepFM over ``mesh`` -> (losses, gathered
    variables, eval outputs on the first batch); the trained model is
    exported to ``export_dir`` when one is given."""
    model = build_model("deepfm.deepfm_functional_api",
                        dict(vocab_size=VOCAB, embedding_dim=4, hidden=16,
                             split_tables=split, mesh=mesh), device=device)
    trainer = ShardedEmbeddingTrainer(model, deepfm.loss, deepfm.optimizer(),
                                      embedding_optimizer=deepfm.embedding_optimizer(),
                                      seed=SEED, sparse_apply_every=every, mesh=mesh)
    batches = train_batches()
    if every == 1:
        losses = [float(trainer.train_step(f, lab)) for f, lab in batches]
    else:
        trainer.ensure_initialized()
        window = trainer.stage_window([(f, lab, np.ones(len(lab), np.float32))
                                       for f, lab in batches])
        losses = trainer.train_window(window).numpy().tolist()
    variables = trainer.get_variables_numpy()
    trainer.state = trainer.state_to_host()  # whole tables in, this rank's rows kept
    for name, value in trainer.get_variables_numpy().items():
        assert np.array_equal(value, variables[name]), name
    if export_dir is not None:
        export_model(trainer, export_dir, model_def="deepfm.deepfm_functional_api",
                     model_params=model_params(split))
    return np.asarray(losses), variables, trainer.eval_step(batches[0][0])


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = build_mesh(MeshConfig(*MESH))
        spec = OP_SPEC
        table, ids, valid, bet, apply_ids, apply_grads = op_inputs()
        assert ske.table_partition_axis(spec.num_blocks, mesh) == "model"
        local = place_rows(torch.from_numpy(table), mesh, "model")
        mine = shard_batch(ids, mesh)
        result = {"lookup": ske.fused_lookup(spec, local, torch.from_numpy(mine.reshape(-1)),
                                             mesh=mesh).numpy()}
        fm = ske.fused_lookup_fm(spec, local, torch.from_numpy(shard_batch(bet, mesh)),
                                 torch.from_numpy(mine), torch.from_numpy(shard_batch(valid, mesh)),
                                 mesh=mesh)
        for name, value in zip(("acts", "first", "sum_v", "sum_sq"), fm):
            result[f"fm_{name}"] = value.numpy()
        slots = {name: torch.zeros_like(local) for name in ("m", "v", "t")}
        ske.fused_dedup_apply(spec, "adam", ADAM, local, slots,
                              torch.from_numpy(shard_batch(apply_ids, mesh)),
                              torch.from_numpy(shard_batch(apply_grads, mesh)), mesh=mesh)
        result["apply_table"] = gather_to_host(local, mesh, "model")
        for name, value in slots.items():
            result[f"apply_{name}"] = gather_to_host(value, mesh, "model")
        for case, split, every in TRAIN_CASES:
            export_dir = os.path.join(out_dir, f"export_{case}")
            losses, variables, outputs = train(mesh, split, every, export_dir=export_dir)
            result[f"train_{case}_losses"] = losses
            result[f"train_{case}_eval"] = outputs
            for name, value in variables.items():
                result[f"train_{case}_var_{name}"] = value
            replica = ServingReplica(export_dir, mesh=mesh)
            result[f"serve_{case}"] = replica.execute(train_batches()[0][0], BATCH)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
