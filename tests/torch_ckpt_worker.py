"""One rank of a gloo process mesh for tests/test_torch_checkpoint.py: a
split-layout DeepFM checkpoint saved by 4 ranks, restored by 2 and by 1.

    python tests/torch_ckpt_worker.py MODE RANK WORLD STORE_FILE CKPT_DIR OUT_DIR

The mesh is (data=1, model=WORLD).  The dim-4 table's 52 storage blocks
split over ``model``; the dim-1 table's 13 do not divide it and
replicate.  Sparse Adam with global bias correction (the scalar slot
``t_global``), dense Adam.

- ``save``: ``STEPS`` steps from a seeded initialisation, then
  ``save_checkpoint`` into CKPT_DIR; rank 0 writes ``OUT_DIR/saved.npz``:
  the gathered state (``state_to_host``, a collective) and the loss of
  one more step.
- ``restore``: another seed, ``set_sharded_restore`` with the saver's
  ``latest_step``, ``ensure_initialized``; every block interval a rank
  reads (``load_rows``) must lie inside its own; rank 0 writes
  ``OUT_DIR/restored_{WORLD}.npz``: the gathered state, the loss of the
  same next step, how many ranks read only their own intervals and how
  many reads there were.

It imports torch and the port only.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver  # noqa: E402
from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays  # noqa: E402
from elasticdl_tpu_torch.parallel import sparse_optim  # noqa: E402
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer  # noqa: E402
from elasticdl_tpu_torch.parallel.sharding import axis_rows  # noqa: E402
from elasticdl_tpu_torch.zoo import build_model, deepfm  # noqa: E402

SAVE_WORLD = 4
RESTORE_WORLDS = (2, 1)
VOCAB, BATCH, STEPS = 64, 12, 2
MODEL_DEF = "deepfm.deepfm_functional_api"


def batches():
    feats, labels = synthetic_ctr_arrays(BATCH * (STEPS + 1), vocab_size=VOCAB, seed=6)
    return [({k: v[i * BATCH:(i + 1) * BATCH] for k, v in feats.items()},
             labels[i * BATCH:(i + 1) * BATCH]) for i in range(STEPS + 1)]


def trainer_over(mesh, seed):
    model = build_model(MODEL_DEF, dict(vocab_size=VOCAB, embedding_dim=4, hidden=16,
                                        split_tables=True, mesh=mesh))
    return ShardedEmbeddingTrainer(
        model, deepfm.loss, deepfm.optimizer(),
        embedding_optimizer=sparse_optim.adam(1e-3, bias_correction="global"),
        seed=seed, mesh=mesh)


def gathered(trainer):
    """A copy of the whole state (a collective), flat, by checkpoint-like
    names."""
    host = trainer.state_to_host()
    out = {f"param|{k}": v for k, v in host.params.items()}
    out["opt|count"] = np.asarray(host.opt_state["count"])
    for moment in ("mu", "nu"):
        out.update({f"opt|{moment}|{k}": v for k, v in host.opt_state[moment].items()})
    out.update({f"table|{k}": v for k, v in host.tables.items()})
    for key, group in host.slots.items():
        out.update({f"slot|{key}|{n}": np.asarray(v) for n, v in group.items()})
    return out


def own_blocks(trainer, mesh):
    """table key -> this rank's interval of its storage blocks."""
    out = {}
    for key, spec in trainer.table_specs.items():
        rows = axis_rows(spec.vocab_padded, mesh, trainer.table_placement[key])
        out[key] = (rows.start // spec.rows_per_block, rows.stop // spec.rows_per_block)
    return out


def main(mode: str, rank: int, world: int, store: str, ckpt_dir: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = build_mesh(MeshConfig(1, world))
        data = batches()
        saver = ShardedCheckpointSaver(ckpt_dir)
        result = {}
        if mode == "save":
            trainer = trainer_over(mesh, seed=3)
            assert trainer.table_placement == {"fm_embedding/embedding": "model",
                                               "linear_embedding/embedding": None}
            for features, labels in data[:STEPS]:
                trainer.train_step(features, labels)
            trainer.save_checkpoint(saver, trainer.step)
        else:
            trainer = trainer_over(mesh, seed=11)
            reads = []
            load_rows = saver.load_rows

            def counted(step, name, lo, hi):
                reads.append((name.split("|")[1], lo, hi))
                return load_rows(step, name, lo, hi)

            saver.load_rows = counted
            trainer.set_sharded_restore(saver, saver.latest_step())
            trainer.ensure_initialized()
            mine = own_blocks(trainer, mesh)
            ok = all(mine[key][0] <= lo and hi <= mine[key][1] for key, lo, hi in reads)
            checks = torch.tensor([int(ok), len(reads)])
            dist.all_reduce(checks)
            result["own_intervals_only"] = np.asarray(int(checks[0]) == world)
            result["reads"] = np.asarray(int(checks[1]))
        assert trainer.step == STEPS
        result.update(gathered(trainer))
        result["next_loss"] = np.asarray(float(trainer.train_step(*data[STEPS])))
        if rank == 0:
            name = "saved.npz" if mode == "save" else f"restored_{world}.npz"
            np.savez(os.path.join(out_dir, name), **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
         sys.argv[6])
