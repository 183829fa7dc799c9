"""The xla engine's whole-mesh tables (JAX's ``ps-xla`` rule) in the
port's PS trainer, on the CPU.

- Placement: with ``sparse_kernel="xla"`` over a (2, 2) mesh a table and
  its table-shaped slots split their storage blocks over ``(data,
  model)`` when ``num_blocks`` divides 4, else replicate; the same
  tables as JAX's xla trainer on a (2, 2) mesh of its virtual CPU
  devices (its state's shardings), and as the journal's
  ``sparse_kernel_selected`` says.
- K2 on the whole-mesh intervals (its plain version, which the CPU
  runs) and the FM lookup: bit for bit the one-table lookups.
- 3 steps of an in-process (2, 2) mesh against JAX's xla trainer from
  its state, for the stream and scatter engines and sgd's scatter-add:
  losses at ``STEP_TOL``, variables within Adam's bound (``2·lr`` a
  step) and all but ``LOOSE_SHARE`` at ``FINAL_TOL``
  (``tests/test_torch_sharded_training.py``'s rule); against the port's
  one-card xla engine at ``ONE_CARD_TOL`` (only the FM sums' order
  differs).
- The gloo world (``tests/torch_mesh_worker.py``, (data=2, model=2)):
  the placement, 3 steps against one process at the one-card
  tolerances, and the sharded checkpoint every rank wrote its interval
  of, restored by one process bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from elasticdl_tpu.parallel import sparse_optim as jso
from elasticdl_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from elasticdl_tpu.parallel.mesh import build_mesh as jax_build_mesh
from elasticdl_tpu.parallel.ps_trainer import ShardedEmbeddingTrainer as JaxTrainer
from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel import sparse_optim
from elasticdl_tpu_torch.parallel.mesh import AXES, MeshConfig, build_mesh, virtual_devices
from elasticdl_tpu_torch.parallel.packed import PackedSpec
from elasticdl_tpu_torch.serving import convert
from model_zoo.deepfm import deepfm_functional_api as zoo

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
FINAL_TOL = dict(rtol=1e-5, atol=1e-6)
ONE_CARD_TOL = dict(rtol=1e-5, atol=1e-6)
LOOSE_SHARE = 0.005
LR, STEPS = worker.CTR_LR, worker.STEPS
#: (engine, split_tables, optimizer)
CASES = [("stream", False, "adam"), ("scatter", True, "adam"), ("stream", True, "sgd"),
         ("scatter", False, "sgd")]


def _mesh():
    return build_mesh(MeshConfig(2, 2), devices=virtual_devices(4, "cpu"))


def _jax_trainer(split, engine, name):
    mesh = jax_build_mesh(JaxMeshConfig(data=2, model=2), devices=jax.devices()[:4])
    params = dict(worker.CTR_PARAMS, split_tables=split)
    opt = jso.adam(LR, mode=engine) if name == "adam" else jso.sgd(LR, mode=engine)
    return JaxTrainer(zoo.custom_model(**params, sparse_kernel="xla", mesh=mesh), zoo.loss,
                      zoo.optimizer(), mesh, embedding_optimizer=opt, sparse_kernel="xla")


def _port_trainer(mesh, split, engine, name, device=None):
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.zoo import build_model, deepfm

    params = dict(worker.CTR_PARAMS, split_tables=split)
    if mesh is not None:
        params["mesh"] = mesh
    opt = (sparse_optim.adam(LR, mode=engine) if name == "adam"
           else sparse_optim.sgd(LR, mode=engine))
    return ShardedEmbeddingTrainer(build_model("deepfm.deepfm_functional_api", params,
                                               device="cpu"),
                                   deepfm.loss, deepfm.optimizer(), embedding_optimizer=opt,
                                   sparse_kernel="xla", mesh=mesh, seed=worker.SEED,
                                   device=device)


def _assert_variables(got, want, lr_steps):
    assert sorted(got) == sorted(want)
    loose = 0
    for name, ref in want.items():
        diff = np.abs(got[name] - ref)
        assert diff.max() <= 2 * lr_steps + 1e-6, (name, diff.max())
        loose += int((diff > FINAL_TOL["atol"] + FINAL_TOL["rtol"] * np.abs(ref)).sum())
    assert loose <= LOOSE_SHARE * sum(v.size for v in want.values()), loose


@pytest.mark.parametrize("split", [False, True])
def test_placement_is_jaxs_ps_xla_rule_and_journaled(split):
    jt = _jax_trainer(split, "stream", "adam")
    jt.ensure_initialized(worker.ctr_batches()[0][0])
    want = {key: AXES if table.sharding.spec and table.sharding.spec[0] == AXES else None
            for key, table in jt.state.tables.items()}
    assert want["fm_embedding/embedding"] == AXES
    if split:  # dim 1: 128 rows a block, 26 blocks do not split 4 ways
        assert want["linear_embedding/embedding"] is None
    pt = _port_trainer(_mesh(), split, "stream", "adam")
    assert pt.table_placement == want
    pt.ensure_initialized()
    table = pt.state.tables["fm_embedding/embedding"]
    assert all(v.shape == table.shape for v in pt.state.slots["fm_embedding/embedding"].values()
               if v.dim())
    record = [r for r in obs.journal().tail(50) if r["event"] == "sparse_kernel_selected"][-1]
    assert record["kernel"] == "xla" and record["route"] == "shard_map"
    assert record["placement"] == {key: None if axis is None else "data,model"
                                   for key, axis in want.items()}


@pytest.mark.parametrize("fm", [False, True])
def test_whole_mesh_lookups_equal_the_one_table_lookups(fm):
    """K2's plain body on each of the 4 intervals, summed: bit for bit
    the one-table lookup (the FM pass: its acts, and the sums to their
    reduction order)."""
    mesh = _mesh()
    spec = PackedSpec(320, 5 if fm else 9)
    assert ske.table_partition_axis(spec.num_blocks, mesh, whole_mesh=True) == AXES
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal(spec.rows_shape).astype(np.float32))
    if fm:
        ids = torch.from_numpy(rng.integers(0, spec.vocab_size, (8, 6)).astype(np.int32))
        valid = torch.from_numpy(rng.random((8, 6)) > 0.2)
        got = ske.fused_lookup_fm(spec, table, None, ids, valid, mesh=mesh, whole_mesh=True)
        want = ske.fused_lookup_fm(spec, table, None, ids, valid)
        assert torch.equal(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)
    else:
        ids = torch.from_numpy(rng.integers(0, spec.vocab_size, 64).astype(np.int32))
        got = ske.fused_lookup(spec, table, ids, mesh=mesh, whole_mesh=True)
        assert torch.equal(got, ske.fused_lookup(spec, table, ids))


@pytest.mark.parametrize("engine,split,name", CASES)
def test_whole_mesh_trainer_matches_jax_xla_trainer(engine, split, name):
    batches = worker.ctr_batches()
    jt = _jax_trainer(split, engine, name)
    jt.ensure_initialized(batches[0][0])
    mesh = _mesh()
    pt = _port_trainer(mesh, split, engine, name)
    pt.ensure_initialized()
    pt.state = convert.trainer_state_from_jax(jax.device_get(jt.state), pt.model)
    for features, labels in batches:
        np.testing.assert_allclose(float(pt.train_step(features, labels)),
                                   float(jt.train_step(features, labels)), **STEP_TOL)
    _assert_variables(pt.get_variables_numpy(), jt.get_variables_numpy(), LR * STEPS)


@pytest.mark.parametrize("engine,split,name", CASES)
def test_whole_mesh_trainer_matches_the_one_card_engine(engine, split, name):
    batches = worker.ctr_batches()
    runs = []
    for mesh in (None, _mesh()):
        trainer = _port_trainer(mesh, split, engine, name, device=None if mesh else "cpu")
        losses = [float(trainer.train_step(f, lab)) for f, lab in batches]
        runs.append((losses, trainer.get_variables_numpy()))
    np.testing.assert_allclose(runs[1][0], runs[0][0], **ONE_CARD_TOL)
    for key, value in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][key], value, **ONE_CARD_TOL, err_msg=key)


# ----------------------------------------------------------------------
# the gloo world (tests/torch_mesh_worker.py): the xla engine over (2, 2)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def world_and_root(tmp_path_factory):
    return worker.mesh_world(tmp_path_factory)


@pytest.fixture(scope="module")
def world(world_and_root):
    return world_and_root[0]


def test_process_mesh_whole_mesh_checkpoint_restores_in_one_process(world_and_root):
    """Each of the 4 ranks wrote its interval of the dim-8 table and its
    slots; one process restores the whole tables bit for bit."""
    from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver

    results, root = world_and_root
    case, split, engine = worker.XLA_CASES[0]
    step_dir = root / "xla_ckpt" / f"step_{STEPS:012d}"
    assert len(list(step_dir.glob("shards_p*of4.npz"))) == 4
    trainer = worker.ctr_trainer(None, split, engine, device="cpu")
    trainer.set_sharded_restore(ShardedCheckpointSaver(str(root / "xla_ckpt")), STEPS)
    trainer.ensure_initialized()
    prefix = f"xla_{case}_var_"
    for key, value in trainer.get_variables_numpy().items():
        assert np.array_equal(value, results[0][prefix + key]), key


@pytest.mark.parametrize("case,split,engine", worker.XLA_CASES)
def test_process_mesh_whole_mesh_tables_train_like_one_process(world, case, split, engine):
    trainer = worker.ctr_trainer(None, split, engine, device="cpu")
    losses = [float(trainer.train_step(f, lab)) for f, lab in worker.ctr_batches()]
    want = trainer.get_variables_numpy()
    placement = repr(sorted(_port_trainer(_mesh(), split, engine, "adam")
                            .table_placement.items()))
    prefix = f"xla_{case}_var_"
    for rank, result in enumerate(world):
        assert str(result[f"xla_{case}_placement"]) == placement
        np.testing.assert_allclose(result[f"xla_{case}_losses"], losses, **ONE_CARD_TOL)
        got = {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, **ONE_CARD_TOL,
                                       err_msg=f"{key}, rank {rank}")
