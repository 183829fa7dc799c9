"""The port's PS trainer over a mesh (the sharded K1-K3 dispatch) against
the JAX trainer on the CPU, and the port's gloo process mesh against its
in-process mesh.

JAX runs ``ShardedEmbeddingTrainer`` with ``sparse_kernel="fused"`` over
``MeshConfig(2, 4)`` on the 8 virtual CPU devices of ``tests/conftest.py``
(its fused kernels in Pallas interpret mode under ``shard_map``); the port
runs over an in-process (2, 4) mesh (``virtual_devices(8, "cpu")``),
started from the JAX trainer's state.  DeepFM at vocab 128 per field,
``embedding_dim`` 4, ``hidden`` 16, batch 16, 3 steps, merged and split
layouts, strict and ``sparse_apply_every=2``.  Tolerances, those of the
one-card parity (``tests/test_torch_training.py``): losses rtol 1e-5 /
atol 1e-6; final variables atol 1e-6 / rtol 1e-5 for all but 0.5% of the
elements and every element within ``2·lr·steps`` (Adam's first steps are
sign-like: an element whose gradient is within reduction noise of zero
moves by up to ~2·lr per step in one framework only).

The gloo process mesh (data=2, model=2, 4 processes,
``tests/torch_sparse_worker.py``) against the in-process (2, 2) mesh:

- lookups and ``acts`` bit-exact (each id has one owner; the all-reduce
  adds exact zeros); the FM sums rtol = atol = 1e-6 (per shard, then
  across shards);
- one sharded adam apply of each rank's data shard, gathered: bit-exact
  (the apply gathers ``(ids, grads)`` over ``data`` in data-index order,
  so every row sums its grads in the in-process order);
- 3 trainer steps: losses rtol 1e-5 (each rank's share of the global
  mean, summed by the all-reduce); gathered variables as above, tables
  and dense params identical on every rank;
- the export rank 0 wrote, served over the process mesh (each rank
  holding its rows) and by the one-card loader: logits within rtol 1e-5
  / atol 1e-6 of the process mesh's own ``eval_step``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_sparse_worker as worker
from elasticdl_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from elasticdl_tpu.parallel.mesh import build_mesh as jax_build_mesh
from elasticdl_tpu.parallel.ps_trainer import ShardedEmbeddingTrainer as JaxTrainer
from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh, virtual_devices
from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.serving.export import load_for_serving
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import deepfm as port_zoo
from model_zoo.deepfm import deepfm_functional_api as zoo

REPO = Path(__file__).resolve().parent.parent
MODEL_DEF = "deepfm.deepfm_functional_api"
VOCAB, DIM, HIDDEN, BATCH, STEPS = 128, 4, 16, 16, 3
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
FINAL_TOL = dict(rtol=1e-5, atol=1e-6)
LOOSE_SHARE = 0.005
FM_TOL = dict(rtol=1e-6, atol=1e-6)
LR = 1e-3


def _port_mesh(data, model):
    return build_mesh(MeshConfig(data, model), devices=virtual_devices(data * model, "cpu"))


def _data(n_batches, seed=3):
    feats, labels = synthetic_ctr_arrays(BATCH * n_batches, vocab_size=VOCAB, seed=seed)
    feats["cat"][0, :2] = [-1, -1]            # padding
    feats["cat"][1, 25] = VOCAB + 5           # out of vocabulary
    return [({k: v[i * BATCH:(i + 1) * BATCH] for k, v in feats.items()},
             labels[i * BATCH:(i + 1) * BATCH]) for i in range(n_batches)]


def _assert_variables(got, want, lr_steps):
    """Every element within the Adam bound, all but LOOSE_SHARE of them
    within FINAL_TOL."""
    assert sorted(got) == sorted(want)
    loose = []
    for name, ref in want.items():
        diff = np.abs(got[name] - ref)
        assert diff.max() <= 2 * lr_steps + 1e-6, (name, diff.max())
        tight = diff <= FINAL_TOL["atol"] + FINAL_TOL["rtol"] * np.abs(ref)
        loose += [(name, tuple(int(i) for i in idx)) for idx in np.argwhere(~tight)]
    assert len(loose) <= LOOSE_SHARE * sum(v.size for v in want.values()), loose[:20]


@pytest.mark.parametrize("split,every", [(False, 1), (True, 1), (False, 2), (True, 2)])
def test_mesh_trainer_matches_jax_trainer(split, every):
    jax_mesh = jax_build_mesh(JaxMeshConfig(data=2, model=4))
    mesh = _port_mesh(2, 4)
    params = dict(vocab_size=VOCAB, embedding_dim=DIM, hidden=HIDDEN, split_tables=split)
    batches = _data(STEPS)
    jt = JaxTrainer(zoo.custom_model(**params, sparse_kernel="fused", mesh=jax_mesh), zoo.loss,
                    zoo.optimizer(), jax_mesh, embedding_optimizer=zoo.embedding_optimizer(),
                    sparse_kernel="fused", sparse_apply_every=every)
    jt.ensure_initialized(batches[0][0])
    model = build_model(MODEL_DEF, dict(params, mesh=mesh), device="cpu")
    pt = ShardedEmbeddingTrainer(model, port_zoo.loss, port_zoo.optimizer(),
                                 embedding_optimizer=port_zoo.embedding_optimizer(),
                                 sparse_apply_every=every, mesh=mesh)
    pt.ensure_initialized()
    assert pt.sparse_route == "shard_map"
    # 26 * 128 rows: merged dim 5 (16 rows a block) and split dim 4 (32)
    # divide 4 model shards; the split layout's dim-1 table (128 a block,
    # 26 blocks) does not, and is replicated.
    want = {"fm_embedding/embedding": "model"}
    if split:
        want["linear_embedding/embedding"] = None
    assert pt.table_placement == want
    pt.state = convert.trainer_state_from_jax(jax.device_get(jt.state), model)
    if every == 1:
        for features, labels in batches:
            j_loss, p_loss = jt.train_step(features, labels), pt.train_step(features, labels)
            np.testing.assert_allclose(float(p_loss), float(j_loss), **STEP_TOL)
    else:
        window = [(f, lab, np.ones((BATCH,), np.float32)) for f, lab in batches]
        np.testing.assert_allclose(pt.train_window(pt.stage_window(window)).numpy(),
                                   np.asarray(jt.train_window(jt.stage_window(window))),
                                   **STEP_TOL)
    assert pt.step == STEPS
    _assert_variables(pt.get_variables_numpy(), jt.get_variables_numpy(), LR * STEPS)
    assert pt.consume_oov_count() == jt.consume_oov_count() > 0


def test_mesh_trainer_refuses_a_model_built_without_its_mesh():
    mesh = _port_mesh(1, 4)
    model = build_model(MODEL_DEF, dict(vocab_size=VOCAB, embedding_dim=DIM), device="cpu")
    with pytest.raises(ValueError, match="build the model over the trainer's mesh"):
        ShardedEmbeddingTrainer(model, port_zoo.loss, port_zoo.optimizer(), mesh=mesh)
    ske.set_dispatch_mesh(mesh)  # the process default resolves the layers
    try:
        trainer = ShardedEmbeddingTrainer(model, port_zoo.loss, port_zoo.optimizer(), mesh=mesh)
        assert trainer.sparse_route == "shard_map"
    finally:
        ske.set_dispatch_mesh(None)
    with pytest.raises(ValueError, match="not the mesh's"):
        ShardedEmbeddingTrainer(build_model(MODEL_DEF, dict(vocab_size=VOCAB, mesh=mesh),
                                            device="cpu"),
                                port_zoo.loss, port_zoo.optimizer(), mesh=mesh, device="meta")


# ----------------------------------------------------------------------
# the gloo process mesh: 4 CPU processes against the in-process mesh
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def process_mesh_run(tmp_path_factory):
    """Runs tests/torch_sparse_worker.py on 4 gloo ranks (a file store
    under a fresh temporary directory); -> each rank's results."""
    out = tmp_path_factory.mktemp("gloo_sparse")
    world = worker.MESH[0] * worker.MESH[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_sparse_worker.py"),
                               str(rank), str(world), str(out / "store"), str(out)],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log}"
    results = [dict(np.load(out / f"rank{rank}.npz")) for rank in range(world)]
    for case, _, _ in worker.TRAIN_CASES:  # what rank 0 exported, as one card loads it
        served = load_for_serving(str(out / f"export_{case}"), device="cpu")
        results[0][f"one_card_serve_{case}"] = served.predict(worker.train_batches()[0][0])
    return results


def test_process_mesh_ops_equal_in_process(process_mesh_run):
    mesh = _port_mesh(*worker.MESH)
    spec = worker.OP_SPEC
    table, ids, valid, bet, apply_ids, apply_grads = worker.op_inputs()
    rows = torch.from_numpy(table.copy())
    lookup = ske.fused_lookup(spec, rows, torch.from_numpy(ids.reshape(-1)), mesh=mesh).numpy()
    fm = [x.numpy() for x in ske.fused_lookup_fm(
        spec, rows, torch.from_numpy(bet), torch.from_numpy(ids), torch.from_numpy(valid),
        mesh=mesh)]
    slots = {name: torch.zeros_like(rows) for name in ("m", "v", "t")}
    ske.fused_dedup_apply(spec, "adam", worker.ADAM, rows, slots, torch.from_numpy(apply_ids),
                          torch.from_numpy(apply_grads), mesh=mesh)
    assert not np.any(lookup[:3])  # ids no shard owns read zeros
    half = worker.OP_BATCH // worker.MESH[0]
    for rank, result in enumerate(process_mesh_run):
        d = rank // worker.MESH[1]
        mine = slice(d * half, (d + 1) * half)
        np.testing.assert_array_equal(
            result["lookup"], lookup.reshape(worker.OP_BATCH, worker.FIELDS, -1)[mine]
            .reshape(-1, spec.dim))
        np.testing.assert_array_equal(result["fm_acts"], fm[0][mine])
        for name, want in zip(("first", "sum_v", "sum_sq"), fm[1:]):
            np.testing.assert_allclose(result[f"fm_{name}"], want[mine], **FM_TOL)
        np.testing.assert_array_equal(result["apply_table"], rows.numpy())
        for name, value in slots.items():
            np.testing.assert_array_equal(result[f"apply_{name}"], value.numpy())


@pytest.mark.parametrize("case,split,every", worker.TRAIN_CASES)
def test_process_mesh_trainer_equals_in_process(process_mesh_run, case, split, every):
    losses, variables, outputs = worker.train(_port_mesh(*worker.MESH), split, every, "cpu")
    first = process_mesh_run[0]
    prefix = f"train_{case}_var_"
    for rank, result in enumerate(process_mesh_run):
        np.testing.assert_allclose(result[f"train_{case}_losses"], losses, **STEP_TOL)
        got = {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}
        _assert_variables(got, variables, LR * worker.STEPS)
        for name, value in got.items():  # replicated or gathered: one value on every rank
            assert np.array_equal(value, first[prefix + name]), (rank, name)
        np.testing.assert_allclose(result[f"train_{case}_eval"], outputs, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(result[f"serve_{case}"], result[f"train_{case}_eval"],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(first[f"one_card_serve_{case}"], first[f"train_{case}_eval"],
                               rtol=1e-5, atol=1e-6)
