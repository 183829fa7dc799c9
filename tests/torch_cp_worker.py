"""One rank of a gloo process mesh for tests/test_torch_context_parallel.py:
the port's context-parallel path over 4 CPU processes, (data=2, model=2).

    python tests/torch_cp_worker.py RANK WORLD STORE_FILE OUT_DIR

Every rank draws the same global inputs from a seed (``cp_inputs``) and
writes what it computed to ``OUT_DIR/rank{RANK}.npz``:

- ``ring_{layout}_out``, ``ring_{layout}_d{q,k,v}``: causal ring
  attention over the model axis, this rank's rows and positions, the
  output and the gradients of ``sum(out * g)``;
- ``ring_{layout}_self_attention``: ``ring_self_attention`` on the
  global q, k, v, the gathered global output;
- ``train_{layout}_losses`` and ``train_{layout}_param_{name}``: 3
  ``DataParallelTrainer`` steps of the CP transformer from a seeded
  initialisation, on global batches of ``TRAIN_BATCH`` rows (padded to
  the data axis).

It imports torch and the port only.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays  # noqa: E402
from elasticdl_tpu_torch.parallel import ring_attention as ring  # noqa: E402
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer  # noqa: E402
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from elasticdl_tpu_torch.zoo import build_model  # noqa: E402
from elasticdl_tpu_torch.zoo import transformer_lm as lm  # noqa: E402

MESH = (2, 2)
#: Ring attention inputs: [B, T, H, D].
RING_SHAPE = (4, 32, 2, 8)
MODEL_PARAMS = dict(vocab=64, d_model=16, num_heads=2, num_layers=1, max_len=32,
                    use_bf16=False)
SEQ, TRAIN_BATCH, STEPS, SEED = 32, 5, 3, 3


def cp_inputs():
    """The global inputs every rank (and the in-process reference) uses:
    ring ``(q, k, v, g)`` and the training batches ``[(tokens, labels)]``."""
    rng = np.random.default_rng(17)
    qkvg = [rng.standard_normal(RING_SHAPE).astype(np.float32) for _ in range(4)]
    tokens, labels = synthetic_lm_arrays(TRAIN_BATCH * STEPS, SEQ, MODEL_PARAMS["vocab"], 5)
    batches = [(tokens[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]) for i in range(STEPS)]
    return qkvg, batches


def _ring(mesh, q, k, v, g, layout):
    """This rank's rows and positions through the ring, forward and
    backward."""
    n, rows = mesh.shape["model"], q.shape[0] // mesh.shape["data"]
    positions = ring.shard_positions(mesh.model_index, q.shape[1] // n, n, layout)

    def local(x):
        mine = x[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        return torch.from_numpy(mine[:, positions])

    leaves = [local(x).requires_grad_(True) for x in (q, k, v)]
    attend = ring.make_ring_attention(mesh, causal=True, layout=layout)
    out = attend(*leaves)
    grads = torch.autograd.grad(out, leaves, local(g))
    return [out.detach().numpy()] + [x.numpy() for x in grads]


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = build_mesh(MeshConfig(*MESH))
        (q, k, v, g), batches = cp_inputs()
        result = {}
        for layout in ring.LAYOUTS:
            for name, x in zip(("out", "dq", "dk", "dv"), _ring(mesh, q, k, v, g, layout)):
                result[f"ring_{layout}_{name}"] = x
            result[f"ring_{layout}_self_attention"] = ring.ring_self_attention(
                mesh, *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                layout=layout).numpy()
            model = build_model("transformer.transformer_lm",
                                dict(MODEL_PARAMS, mesh=mesh, cp_layout=layout), device="cpu")
            trainer = DataParallelTrainer(model, lm.loss, lm.optimizer(), mesh=mesh, seed=SEED)
            result[f"train_{layout}_losses"] = np.asarray(
                [float(trainer.train_step(tokens, labels)) for tokens, labels in batches])
            for name, p in trainer.state.params.items():
                result[f"train_{layout}_param_{name}"] = p.detach().numpy()
            result[f"train_{layout}_eval"] = trainer.eval_step(batches[0][0])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
