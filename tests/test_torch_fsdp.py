"""FSDP dense sharding of the port's ``DataParallelTrainer``
(``dense_sharding="fsdp"``), mirroring the JAX package's
``tests/test_fsdp.py`` on the CPU.

- The shards: over an in-process (4, 1) mesh the parameters JAX's rule
  shards (flax dim 0 divides the data axis, at least ``FSDP_MIN_LEAF``
  elements) are the ones JAX's FSDP trainer shards on a (4, 1) mesh of
  its virtual CPU devices, each held as 4 blocks of 1/4 with its Adam
  slots; small leaves replicate.
- FSDP trains like replicated: an in-process mesh bit for bit (the
  optimizer is elementwise), and the gloo world of (data=4, model=1)
  (``tests/torch_mesh_worker.py``) against one process: losses at
  ``STEP_RTOL``, parameters within Adam's bound and all but
  ``LOOSE_SHARE`` of them at ``FINAL_TOL``, each rank holding 1/4 of
  every sharded leaf and of its slots, and nothing of the gathered
  parameters between steps.
- Checkpoints: ``state_to_host`` into a fresh trainer, export and
  serving; the sharded save and restore; and JAX's
  ``ShardedCheckpointSaver`` restores the port's FSDP checkpoint (in
  process and the gloo world's) into JAX's FSDP trainer leaf for leaf,
  bit for bit.
- With no mesh, or a data axis of one, FSDP is the replicated layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_worker as worker
from elasticdl_tpu.checkpoint import ShardedCheckpointSaver as JaxSaver
from elasticdl_tpu.parallel import MeshConfig as JaxMeshConfig
from elasticdl_tpu.parallel import build_mesh as jax_build_mesh
from elasticdl_tpu.parallel.dp_trainer import DataParallelTrainer as JaxTrainer
from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver
from elasticdl_tpu_torch.parallel import dp_trainer as port_dp
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh, virtual_devices
from elasticdl_tpu_torch.serving.export import export_model, load_for_serving
from model_zoo.transformer import transformer_lm as zoo

STEPS, LR = worker.STEPS, 3e-3
STEP_RTOL = 1e-5
FINAL_TOL = dict(rtol=1e-5, atol=1e-6)
LOOSE_SHARE = 0.005


def _mesh(data=4, model=1):
    return build_mesh(MeshConfig(data, model), devices=virtual_devices(data * model, "cpu"))


def _trainer(mode, mesh=None, **kw):
    mesh = _mesh() if mesh is None else mesh
    return worker.lm_trainer(mesh, dense_sharding=mode, **kw)


def _train(trainer, batches=None):
    return [float(trainer.train_step(*b)) for b in batches or worker.lm_batches()]


def _assert_params_close(got, want, max_diff):
    """Every element within ``max_diff`` (Adam's bound: the key
    projection's bias has a zero gradient, so Adam moves it by reduction
    noise); all but LOOSE_SHARE of them within FINAL_TOL."""
    assert sorted(got) == sorted(want)
    loose = 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= max_diff, (name, float(diff.max()))
        loose += int((diff > FINAL_TOL["atol"] + FINAL_TOL["rtol"] * np.abs(w)).sum())
    assert loose <= LOOSE_SHARE * sum(w.size for w in want.values()), loose


def _jax_leaves(state):
    return {JaxTrainer._leaf_key(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]}


def _jax_fsdp_trainer():
    mesh = jax_build_mesh(JaxMeshConfig(data=4, model=1), devices=jax.devices()[:4])
    params = {k: v for k, v in worker.LM_PARAMS.items()}
    return JaxTrainer(zoo.custom_model(**params), zoo.loss, zoo.optimizer(), mesh,
                      seed=0, dense_sharding="fsdp")


def test_fsdp_state_actually_shards_as_jax_does():
    trainer = _trainer("fsdp")
    trainer.ensure_initialized()
    leaves = trainer.fsdp_leaves
    assert leaves, "test model has no shardable leaves"
    # The same leaves as JAX's FSDP trainer on a 4-way data axis.
    jt = _jax_fsdp_trainer()
    jt.ensure_initialized(jnp.asarray(worker.lm_batches()[0][0]))
    jax_sharded = {key for key, leaf in zip(
        (JaxTrainer._leaf_key(p) for p, _ in jax.tree_util.tree_flatten_with_path(
            jt.state.params)[0]), jax.tree.leaves(jt.state.params))
        if not leaf.sharding.is_fully_replicated}
    port_sharded = {"dense|" + path for path in trainer._fsdp_by_path}
    assert port_sharded == jax_sharded
    local = trainer.local_state
    for name, leaf in leaves.items():
        whole = int(np.prod(leaf.flax_shape))
        for i in range(4):
            for tree in (local.params, local.opt_state["mu"], local.opt_state["nu"]):
                assert tree[f"{name}@{i}"].numel() * 4 == whole
                assert tuple(tree[f"{name}@{i}"].shape) == leaf.block_shape
        # The model's gathered copy is released between steps.
        assert trainer.model.get_parameter(name).untyped_storage().size() == 0
    # ...and small leaves stay whole.
    small = [n for n in local.params if "@" not in n]
    assert small and all(n not in leaves for n in small)
    assert "block_0.LayerNorm_0.weight" in small


def test_fsdp_trains_equivalently_to_replicated():
    losses, variables = {}, {}
    for mode in ("replicated", "fsdp"):
        trainer = _trainer(mode)
        losses[mode] = _train(trainer, worker.lm_batches() * 2)
        variables[mode] = trainer.get_variables_numpy()
    assert losses["fsdp"] == losses["replicated"]
    for name, value in variables["replicated"].items():
        assert np.array_equal(variables["fsdp"][name], value), name
    assert losses["fsdp"][-1] < losses["fsdp"][0]  # it actually learns


def test_fsdp_checkpoint_roundtrip_and_export(tmp_path):
    batches = worker.lm_batches()
    t1 = _trainer("fsdp")
    _train(t1, batches[:2])
    host = t1.state_to_host()
    name = next(iter(t1.fsdp_leaves))
    assert host.params[name].shape == tuple(t1.model.get_parameter(name).shape)
    t2 = _trainer("fsdp")
    t2.ensure_initialized()
    t2.state = host  # restore re-shards under the fsdp layout
    assert float(t1.train_step(*batches[2])) == float(t2.train_step(*batches[2]))
    out = str(tmp_path / "export")
    export_model(t1, out, model_zoo="model_zoo", model_def=worker.LM_DEF,
                 model_params=",".join(f"{k}={v}" for k, v in worker.LM_PARAMS.items()))
    served = load_for_serving(out, device="cpu")
    tokens = batches[0][0][:2]
    pred = np.asarray(served.predict(tokens))
    np.testing.assert_allclose(pred, t1.eval_step(tokens), rtol=0, atol=1e-5)
    assert pred.shape == tokens.shape + (worker.LM_PARAMS["vocab"],) and np.isfinite(pred).all()


def test_fsdp_sharded_checkpoint_roundtrip(tmp_path):
    import json

    batches = worker.lm_batches()
    t1 = _trainer("fsdp")
    _train(t1, batches)
    saver = ShardedCheckpointSaver(str(tmp_path))
    t1.save_checkpoint(saver, t1.step)
    manifest = json.loads((tmp_path / f"step_{STEPS:012d}" / "manifest.json").read_text())
    sharded = {k for k in manifest["arrays"] if k.startswith("dense|")}
    assert sharded and "dense|.params/Embed_0/embedding" in sharded
    assert "dense|.opt_state/[0]/.mu/block_0/Dense_0/kernel" in sharded
    t2 = _trainer("fsdp", seed=9)
    t2.set_sharded_restore(saver, STEPS)
    assert t2.step == STEPS
    assert float(t1.train_step(*batches[0])) == float(t2.train_step(*batches[0]))


def _assert_jax_restores(saver_dir, step, want):
    jt = _jax_fsdp_trainer()
    jt.set_sharded_restore(JaxSaver(str(saver_dir)), step)
    jt.ensure_initialized(jnp.asarray(worker.lm_batches()[0][0]))
    got = _jax_leaves(jt.state)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key


def test_jax_sharded_saver_reads_the_ports_fsdp_checkpoint(tmp_path):
    trainer = _trainer("fsdp")
    _train(trainer)
    trainer.save_checkpoint(ShardedCheckpointSaver(str(tmp_path)), trainer.step)
    want = dict(port_dp._leaf_items(trainer.state_to_jax_host()))
    _assert_jax_restores(tmp_path, STEPS, want)


def test_fsdp_without_a_data_axis_is_the_replicated_layout():
    for mesh in (None, _mesh(1, 4)):
        if mesh is None:
            fsdp = worker.lm_trainer(None, device="cpu", dense_sharding="fsdp")
            replicated = worker.lm_trainer(None, device="cpu")
        else:
            fsdp, replicated = _trainer("fsdp", mesh), _trainer("replicated", mesh)
        assert fsdp.dense_sharding == "fsdp" and fsdp.fsdp_leaves == {}
        assert _train(fsdp) == _train(replicated)


def test_rejects_unknown_mode():
    with pytest.raises(ValueError, match="dense_sharding"):
        _trainer("zero3")


# ----------------------------------------------------------------------
# the gloo world (tests/torch_mesh_worker.py): FSDP over (data=4, model=1)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return worker.mesh_world(tmp_path_factory)


def test_process_mesh_fsdp_holds_one_nth_of_each_leaf_and_slot(world):
    results, _ = world
    data = worker.FSDP_MESH[0]
    names = [k[len("fsdp_whole_"):] for k in results[0] if k.startswith("fsdp_whole_")]
    assert names and set(names) == set(_trainer("fsdp").fsdp_leaves)
    for result in results:
        for name in names:
            whole = int(result[f"fsdp_whole_{name}"])
            assert list(result[f"fsdp_local_{name}"]) == [whole // data] * 3, name
        assert int(result["fsdp_freed"]) == 0


def test_process_mesh_fsdp_trains_like_replicated(world):
    results, _ = world
    trainer = worker.lm_trainer(None, device="cpu")
    losses = np.asarray(_train(trainer))
    want = trainer.get_variables_numpy()
    prefix = "fsdp_var_"
    for rank, result in enumerate(results):
        np.testing.assert_allclose(result["fsdp_losses"], losses, rtol=STEP_RTOL)
        got = {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}
        _assert_params_close(got, want, 2 * LR * STEPS * 1.5)
        for name, value in got.items():  # identical on every rank
            assert np.array_equal(value, results[0][prefix + name]), (rank, name)


def test_jax_sharded_saver_reads_the_process_meshs_checkpoint(world):
    """Each gloo rank wrote its own blocks; JAX reads the four shard
    files back into the state the world gathered."""
    results, root = world
    ckpt = root / "fsdp_ckpt"
    assert len(list((ckpt / f"step_{STEPS:012d}").glob("shards_p*of4.npz"))) == 4
    saver = ShardedCheckpointSaver(str(ckpt))
    trainer = _trainer("fsdp", _mesh(4, 1))
    trainer.set_sharded_restore(saver, STEPS)
    trainer.ensure_initialized()
    got = trainer.get_variables_numpy()
    for name, value in got.items():
        assert np.array_equal(value, results[0]["fsdp_var_" + name]), name
    _assert_jax_restores(ckpt, STEPS, dict(port_dp._leaf_items(trainer.state_to_jax_host())))

