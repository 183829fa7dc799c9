"""One rank of a gloo process mesh of 4 CPU processes, for
tests/test_torch_tensor_parallel.py, test_torch_fsdp.py,
test_torch_whole_mesh.py and test_torch_collective.py: the port's
tensor parallelism, FSDP, the xla engine's whole-mesh tables and the
control-plane collectives, in one world.

    python tests/torch_mesh_worker.py RANK WORLD STORE_FILE OUT_DIR

``mesh_world(tmp_path_factory)`` runs the world once per test session,
also across pytest-xdist workers (a lock file in the session's shared
temporary directory), and returns each rank's results.  Every rank draws
the same global inputs from a seed and writes what it computed to
``OUT_DIR/rank{RANK}.npz``:

- ``tp_*``: the LM with ``model_axis_mode="tp"`` over (data=2, model=2):
  the reduced gradients of one step from the seeded initialisation
  (``tp_grad_<name>``), the model-axis all-reduces of that step
  (``tp_reduces``: forward, backward), then 3 ``DataParallelTrainer``
  steps (``tp_losses``, ``tp_var_<flax path>``, ``tp_eval``);
- ``fsdp_*``: the same LM (context parallelism off) with
  ``dense_sharding="fsdp"`` over (data=4, model=1): each sharded leaf's
  whole size and the sizes this rank holds of it and of its Adam slots,
  the storage left in the model's gathered parameters between steps, 3
  steps (``fsdp_losses``, ``fsdp_var_<flax path>``) and a sharded
  checkpoint of step 3 in ``OUT_DIR/fsdp_ckpt``;
- ``xla_{case}_*``: a small DeepFM with ``sparse_kernel="xla"`` over
  (2, 2), each ``XLA_CASES`` engine and layout: the tables' placement and
  3 steps (losses, gathered variables), the first case's sharded
  checkpoint in ``OUT_DIR/xla_ckpt``;
- ``coll_*``: ``CollectiveCommunicator.allreduce`` (MEAN and SUM of one
  value per process), ``barrier``, the ``ValueError`` of an unknown op;
- ``kill_*``: rank ``KILLED`` SIGKILLs itself after a barrier while the
  others are in an ``allreduce``; they record its status and how long
  it took (the group's timeout is ``TIMEOUT_S``).

It imports torch and the port only.
"""

from __future__ import annotations

import datetime
import fcntl
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from elasticdl_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_ctr_arrays,
    synthetic_lm_arrays,
)
from elasticdl_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from elasticdl_tpu_torch.parallel import sparse_optim  # noqa: E402
from elasticdl_tpu_torch.parallel.collective import (  # noqa: E402
    CollectiveCommunicator,
    CollectiveResult,
)
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer  # noqa: E402
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer  # noqa: E402
from elasticdl_tpu_torch.zoo import build_model  # noqa: E402
from elasticdl_tpu_torch.zoo import deepfm  # noqa: E402
from elasticdl_tpu_torch.zoo import transformer_lm as lm  # noqa: E402

WORLD = 4
TP_MESH, FSDP_MESH, XLA_MESH = (2, 2), (4, 1), (2, 2)
LM_DEF = "transformer.transformer_lm"
LM_PARAMS = dict(vocab=64, d_model=32, num_heads=4, num_layers=2, max_len=32, use_bf16=False)
SEQ, BATCH, STEPS, SEED = 32, 5, 3, 3
CTR_PARAMS = dict(vocab_size=128, embedding_dim=4, hidden=16)
CTR_BATCH, CTR_LR = 16, 0.01
#: (case name, split_tables, the embedding optimizer's engine)
XLA_CASES = (("stream", False, "stream"), ("scatter", False, "scatter"),
             ("split_stream", True, "stream"))
KILLED, TIMEOUT_S = 3, 30


def lm_batches():
    tokens, labels = synthetic_lm_arrays(BATCH * STEPS, SEQ, LM_PARAMS["vocab"], 5)
    return [(tokens[i * BATCH:(i + 1) * BATCH], labels[i * BATCH:(i + 1) * BATCH])
            for i in range(STEPS)]


def ctr_batches():
    feats, labels = synthetic_ctr_arrays(CTR_BATCH * STEPS, vocab_size=CTR_PARAMS["vocab_size"],
                                         seed=3)
    feats["cat"][0, :2] = [-1, -1]  # padding
    return [({k: v[i * CTR_BATCH:(i + 1) * CTR_BATCH] for k, v in feats.items()},
             labels[i * CTR_BATCH:(i + 1) * CTR_BATCH]) for i in range(STEPS)]


def lm_trainer(mesh, device=None, **kw):
    params = dict(LM_PARAMS, **kw.pop("model_params", {}))
    if mesh is not None:
        params["mesh"] = mesh
    model = build_model(LM_DEF, params, device="cpu")
    kw.setdefault("seed", SEED)
    return DataParallelTrainer(model, lm.loss, lm.optimizer(), mesh=mesh, device=device, **kw)


def ctr_trainer(mesh, split: bool, engine: str, device=None):
    params = dict(CTR_PARAMS, split_tables=split)
    if mesh is not None:
        params["mesh"] = mesh
    model = build_model("deepfm.deepfm_functional_api", params, device="cpu")
    return ShardedEmbeddingTrainer(
        model, deepfm.loss, deepfm.optimizer(),
        embedding_optimizer=sparse_optim.adam(CTR_LR, mode=engine), sparse_kernel="xla",
        mesh=mesh, seed=SEED, device=device)


def one_step_grads(trainer, tokens, labels):
    """The gradients of one step from the trainer's initial state, as
    the step reduces them (no update)."""
    trainer.ensure_initialized()
    mask = np.ones((len(labels),), np.float32)
    return trainer.backward(trainer.forward(*trainer.stage_batch(tokens, labels, mask)))


def _tp(result):
    mesh = build_mesh(MeshConfig(*TP_MESH))
    batches = lm_batches()
    pmesh.reset_tp_reduce_counts()
    grads = one_step_grads(lm_trainer(mesh, model_params={"model_axis_mode": "tp"}),
                           *batches[0])
    counts = pmesh.tp_reduce_counts()
    result["tp_reduces"] = np.asarray([counts["forward"], counts["backward"]])
    for name, g in grads.items():
        result[f"tp_grad_{name}"] = g.numpy()
    trainer = lm_trainer(mesh, model_params={"model_axis_mode": "tp"})
    result["tp_losses"] = np.asarray([float(trainer.train_step(*b)) for b in batches])
    for name, value in trainer.get_variables_numpy().items():
        result[f"tp_var_{name}"] = value
    result["tp_eval"] = trainer.eval_step(batches[0][0])


def _fsdp(result, out_dir):
    from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver

    mesh = build_mesh(MeshConfig(*FSDP_MESH))
    trainer = lm_trainer(mesh, dense_sharding="fsdp")
    batches = lm_batches()
    result["fsdp_losses"] = np.asarray([float(trainer.train_step(*b)) for b in batches])
    local = trainer.local_state
    for name, leaf in trainer.fsdp_leaves.items():
        result[f"fsdp_whole_{name}"] = np.asarray(int(np.prod(leaf.flax_shape)))
        result[f"fsdp_local_{name}"] = np.asarray([
            local.params[name].numel(), local.opt_state["mu"][name].numel(),
            local.opt_state["nu"][name].numel()])
    result["fsdp_freed"] = np.asarray(max(
        trainer.model.get_parameter(name).untyped_storage().size()
        for name in trainer.fsdp_leaves))
    saver = ShardedCheckpointSaver(os.path.join(out_dir, "fsdp_ckpt"))
    trainer.save_checkpoint(saver, trainer.step)
    for name, value in trainer.get_variables_numpy().items():
        result[f"fsdp_var_{name}"] = value


def _xla(result, out_dir):
    from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver

    mesh = build_mesh(MeshConfig(*XLA_MESH))
    batches = ctr_batches()
    for case, split, engine in XLA_CASES:
        trainer = ctr_trainer(mesh, split, engine)
        trainer.ensure_initialized()
        result[f"xla_{case}_placement"] = np.asarray(repr(sorted(trainer.table_placement.items())))
        result[f"xla_{case}_losses"] = np.asarray(
            [float(trainer.train_step(f, lab)) for f, lab in batches])
        if case == XLA_CASES[0][0]:  # each rank writes its interval of the tables
            trainer.save_checkpoint(ShardedCheckpointSaver(os.path.join(out_dir, "xla_ckpt")),
                                    trainer.step)
        for name, value in trainer.get_variables_numpy().items():
            result[f"xla_{case}_var_{name}"] = value
    return mesh


def _collectives(result, mesh, rank):
    comm = CollectiveCommunicator(mesh)
    value = np.asarray([rank, 2.0 * rank + 1], np.float32)
    status, mean = comm.allreduce(value, op="MEAN")
    result["coll_mean"], result["coll_mean_ok"] = mean, status == CollectiveResult.SUCCEEDED
    status, total = comm.allreduce(value, op="SUM")
    result["coll_sum"], result["coll_sum_ok"] = total, status == CollectiveResult.SUCCEEDED
    result["coll_barrier_ok"] = comm.barrier("mesh_worker") == CollectiveResult.SUCCEEDED
    try:
        comm.allreduce(value, op="MAX")
        result["coll_bad_op_raises"] = False
    except ValueError:
        result["coll_bad_op_raises"] = True


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    result = {}
    _tp(result)
    _fsdp(result, out_dir)
    mesh = _xla(result, out_dir)
    _collectives(result, mesh, rank)
    comm = CollectiveCommunicator(mesh)
    comm.barrier("before_kill")
    out = os.path.join(out_dir, f"rank{rank}.npz")
    if rank == KILLED:
        np.savez(out, **result)
        os.kill(os.getpid(), signal.SIGKILL)
    start = time.monotonic()
    status, value = comm.allreduce(np.asarray([1.0], np.float32), op="SUM")
    result["kill_failed"] = status == CollectiveResult.FAILED and value is None
    result["kill_seconds"] = time.monotonic() - start
    np.savez(out, **result)
    # The group lost a rank: leave without tearing it down.
    sys.stdout.flush()
    os._exit(0)


def _shared_root(tmp_path_factory) -> Path:
    base = tmp_path_factory.getbasetemp()
    # Under xdist each worker's base is popen-gw<N> in one session dir.
    return base.parent if base.name.startswith("popen-gw") else base


def mesh_world(tmp_path_factory):
    """Each rank's results (``[dict]``) and the output directory, the
    world run once per session."""
    root = _shared_root(tmp_path_factory) / "torch_mesh_world"
    root.mkdir(exist_ok=True)
    with open(root / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = root / "rcs"
        if not done.exists():
            env = dict(os.environ, OMP_NUM_THREADS="1")
            procs = [subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "torch_mesh_worker.py"), str(rank),
                 str(WORLD), str(root / "store"), str(root)],
                cwd=str(REPO), env=env, stdout=open(root / f"rank{rank}.log", "w"),
                stderr=subprocess.STDOUT) for rank in range(WORLD)]
            try:
                rcs = [p.wait(timeout=300) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            done.write_text(" ".join(str(rc) for rc in rcs))
    rcs = [int(rc) for rc in done.read_text().split()]
    for rank, rc in enumerate(rcs):
        want = -signal.SIGKILL if rank == KILLED else 0
        assert rc == want, f"rank {rank} exited {rc}:\n" + (root / f"rank{rank}.log").read_text()[-4000:]
    return [dict(np.load(root / f"rank{rank}.npz")) for rank in range(WORLD)], root


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
