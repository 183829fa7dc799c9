"""The port's checkpoints (``elasticdl_tpu_torch.checkpoint``) against the
JAX package's on the CPU: either package restores what the other wrote.

- PS mode: a small DeepFM (vocab 100 per field, ``embedding_dim`` 4,
  ``hidden`` 16, batch 16; merged and split layouts; sparse sgd, Adam
  with per-row and with global bias correction; dense Adam).  The JAX
  trainer writes a sharded checkpoint after one step and the port
  restores it; the port writes one and a fresh JAX trainer restores it.
  A restored state is bit-exact with what was saved (no arithmetic
  happens on the way), and the next step's losses agree at
  ``tests/test_torch_training.py``'s tolerance, rtol 1e-5 / atol 1e-6.
- The LM (vocab 64, d_model 16, 2 heads, 2 layers, T 16, AdamW): the
  same both ways, through the plain saver's ``state.pkl`` and through
  the sharded pair, losses at rtol 1e-5.
- The saver's own behaviour: JAX's ``verify_integrity`` on port-written
  directories, quarantine of a torn ``state.pkl`` and of a torn shard
  file, the stale-tmp sweep, GC at ``keep_max``, ``RowReader``'s cases,
  and the errors that name their cause.
- A gloo process mesh (``tests/torch_ckpt_worker.py``): 4 ranks save a
  split-table checkpoint, 2 ranks and 1 rank restore it, each reading
  only its own block intervals; tables bit-exact, the next loss at rtol
  1e-5 / atol 1e-6.
"""

import io
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import torch_ckpt_worker as ckpt_worker
from elasticdl_tpu.checkpoint import CheckpointSaver as JaxSaver
from elasticdl_tpu.checkpoint import ShardedCheckpointSaver as JaxShardedSaver
from elasticdl_tpu.checkpoint.saver import verify_integrity as jax_verify_integrity
from elasticdl_tpu.parallel import MeshConfig, build_mesh
from elasticdl_tpu.parallel import sparse_optim as jax_sparse_optim
from elasticdl_tpu.parallel.dp_trainer import DataParallelTrainer as JaxDPTrainer
from elasticdl_tpu.parallel.ps_trainer import ShardedEmbeddingTrainer as JaxTrainer
from elasticdl_tpu_torch.checkpoint import _pickle
from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
from elasticdl_tpu_torch.checkpoint.sharded import (
    RowReader,
    ShardedArray,
    ShardedCheckpointSaver,
)
from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays, synthetic_lm_arrays
from elasticdl_tpu_torch.parallel import optim, sparse_optim
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import deepfm as port_zoo
from elasticdl_tpu_torch.zoo import transformer_lm as port_lm
from model_zoo.deepfm import deepfm_functional_api as zoo
from model_zoo.transformer import transformer_lm as lm_zoo

REPO = Path(__file__).resolve().parent.parent
MODEL_DEF = "deepfm.deepfm_functional_api"
VOCAB, DIM, HIDDEN, BATCH = 100, 4, 16, 16
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
#: sparse optimizer kind -> (JAX factory, port factory)
KINDS = {
    "sgd": (lambda: jax_sparse_optim.sgd(0.01), lambda: sparse_optim.sgd(0.01)),
    "adam_per_row": (lambda: jax_sparse_optim.adam(LR), lambda: sparse_optim.adam(LR)),
    "adam_global": (lambda: jax_sparse_optim.adam(LR, bias_correction="global"),
                    lambda: sparse_optim.adam(LR, bias_correction="global")),
}
LM_DEF = "transformer.transformer_lm"
LM_PARAMS = dict(vocab=64, d_model=16, num_heads=2, num_layers=2, max_len=32)
LM_SEQ, LM_BATCH = 16, 4


def _batches(n=2, seed=3):
    feats, labels = synthetic_ctr_arrays(BATCH * n, vocab_size=VOCAB, seed=seed)
    feats["cat"][0, :2] = [-1, -1]       # padding
    feats["cat"][1, 25] = VOCAB + 5      # out of vocabulary
    return [({k: v[i * BATCH:(i + 1) * BATCH] for k, v in feats.items()},
             labels[i * BATCH:(i + 1) * BATCH]) for i in range(n)]


def _params(split):
    return dict(vocab_size=VOCAB, embedding_dim=DIM, hidden=HIDDEN, split_tables=split)


def _jax_trainer(split, kind, seed=0):
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    return JaxTrainer(zoo.custom_model(**_params(split), sparse_kernel="xla"), zoo.loss,
                      zoo.optimizer(), mesh, embedding_optimizer=KINDS[kind][0](),
                      sparse_kernel="xla", seed=seed)


def _port_trainer(split, kind, seed=0):
    model = build_model(MODEL_DEF, _params(split), device="cpu")
    return ShardedEmbeddingTrainer(model, port_zoo.loss, port_zoo.optimizer(),
                                   embedding_optimizer=KINDS[kind][1](), seed=seed,
                                   device="cpu")


def _assert_trees_equal(got, want):
    """Same structure (the optax and trainer classes included), every leaf
    bit-exact."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def _assert_port_ps_state(trainer, want):
    """The port trainer's state bit-exact with a port-layout ``want``."""
    got = trainer.state_to_host()
    assert got.step == want.step
    for part in ("params", "tables"):
        assert sorted(getattr(got, part)) == sorted(getattr(want, part))
        for key, value in getattr(want, part).items():
            assert np.array_equal(getattr(got, part)[key], value), key
    for key, group in want.slots.items():
        assert sorted(got.slots[key]) == sorted(group)
        for name, value in group.items():
            assert np.array_equal(np.asarray(got.slots[key][name]).reshape(-1),
                                  np.asarray(value).reshape(-1)), (key, name)
    assert sorted(got.opt_state) == sorted(want.opt_state)
    if want.opt_state:
        assert int(got.opt_state["count"]) == int(want.opt_state["count"])
        for moment in ("mu", "nu"):
            for name, value in want.opt_state[moment].items():
                assert np.array_equal(got.opt_state[moment][name], value), (moment, name)


# ----------------------------------------------------------------------
# PS mode, both ways
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("split", [False, True])
def test_ps_sharded_checkpoint_both_ways(tmp_path, split, kind):
    (f0, l0), (f1, l1) = _batches()
    jt = _jax_trainer(split, kind)
    jt.train_step(f0, l0)
    jt.save_checkpoint(JaxShardedSaver(str(tmp_path / "jax")), 1)

    # The port reads JAX: bit-exact with trainer_state_from_jax, into its
    # own tensors (their storage never moves).
    pt = _port_trainer(split, kind, seed=9)
    ptrs = {key: t.data_ptr() for key, t in
            ((k, layer.embedding) for k, layer in pt._layers.items())}
    saver = ShardedCheckpointSaver(str(tmp_path / "jax"))
    pt.set_sharded_restore(saver, saver.latest_step())
    pt.ensure_initialized()
    assert {k: t.data_ptr() for k, t in pt.state.tables.items()} == ptrs
    _assert_port_ps_state(pt, convert.trainer_state_from_jax(jax.device_get(jt.state),
                                                             pt.model))

    # JAX reads the port: a fresh JAX trainer restores what the port wrote.
    pt.save_checkpoint(ShardedCheckpointSaver(str(tmp_path / "port")), 1)
    assert jax_verify_integrity(str(tmp_path / "port" / "step_000000000001")) is None
    jt2 = _jax_trainer(split, kind, seed=4)
    jax_saver = JaxShardedSaver(str(tmp_path / "port"))
    jt2.set_sharded_restore(jax_saver, jax_saver.latest_step())
    jt2.ensure_initialized(f0)
    _assert_trees_equal(jax.device_get(jt2.state), jax.device_get(jt.state))
    assert jt2.step == pt.step == 1

    # The next step agrees across all three.
    want = float(jt.train_step(f1, l1))
    np.testing.assert_allclose(float(jt2.train_step(f1, l1)), want, rtol=0, atol=0)
    np.testing.assert_allclose(float(pt.train_step(f1, l1)), want, **STEP_TOL)


def test_ps_state_in_jax_layout(tmp_path):
    """``jax_trainer_state_from_port`` is the JAX state's exact layout: the
    JAX trainer takes it through its ``state`` setter, and
    ``trainer_state_from_jax`` of it gives the port's state back, and a
    plain ``state.pkl`` of it loads in JAX as the JAX ``PSTrainState``."""
    (f0, l0), _ = _batches()
    pt = _port_trainer(True, "adam_per_row", seed=2)
    pt.train_step(f0, l0)
    host = pt.state_to_host()
    jax_state = convert.jax_trainer_state_from_port(host, pt.model, "adam")
    jt = _jax_trainer(True, "adam_per_row")
    jt.ensure_initialized(f0)
    template = jax.device_get(jt.state)
    CheckpointSaver(str(tmp_path)).save(jax_state, 1)
    loaded, step = JaxSaver(str(tmp_path)).load_latest()
    assert step == 1 and type(loaded).__module__ == "elasticdl_tpu.parallel.ps_trainer"
    assert jax.tree.structure(loaded) == jax.tree.structure(template)
    jt.state = loaded
    _assert_trees_equal(jax.device_get(jt.state), loaded)
    _assert_port_ps_state(pt, convert.trainer_state_from_jax(loaded, pt.model))


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_opt_state_chain_is_optax_structure(name):
    params = {"w": torch.zeros(3, 2)}
    port = {"adam": optim.adam(LR), "adamw": optim.adamw(LR), "sgd": optim.sgd(LR)}[name]
    tx = {"adam": optax.adam(LR), "adamw": optax.adamw(LR), "sgd": optax.sgd(LR)}[name]
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(params["w"])
    chain = convert.jax_opt_state(name, port.init(dict(model.named_parameters())), model)
    buf = io.BytesIO()
    _pickle.dump(chain, buf)
    buf.seek(0)
    real = pickle.load(buf)  # optax's own classes
    assert jax.tree.structure(real) == jax.tree.structure(tx.init({}))


# ----------------------------------------------------------------------
# the LM, both ways, plain saver and sharded pair
# ----------------------------------------------------------------------


def _lm_data(seed=1):
    return synthetic_lm_arrays(LM_BATCH * 2, LM_SEQ, LM_PARAMS["vocab"], seed)


def _jax_lm(seed=0):
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    return JaxDPTrainer(lm_zoo.custom_model(**LM_PARAMS, use_bf16=False, attn_impl="xla"),
                        lm_zoo.loss, lm_zoo.optimizer(), mesh, seed=seed)


def _port_lm(seed=0):
    model = build_model(LM_DEF, dict(LM_PARAMS, use_bf16=False, attn_impl="xla"),
                        device="cpu")
    return DataParallelTrainer(model, port_lm.loss, port_lm.optimizer(), seed=seed,
                               device="cpu")


def _assert_port_dp_state(trainer, want):
    got = trainer.state_to_host()
    assert got.step == want.step
    for name, value in want.params.items():
        assert np.array_equal(got.params[name], value), name
    assert int(got.opt_state["count"]) == int(want.opt_state["count"])
    for moment in ("mu", "nu"):
        for name, value in want.opt_state[moment].items():
            assert np.array_equal(got.opt_state[moment][name], value), (moment, name)


@pytest.mark.parametrize("route", ["state_pkl", "sharded"])
def test_lm_checkpoint_both_ways(tmp_path, route):
    tokens, labels = _lm_data()
    first = (tokens[:LM_BATCH], labels[:LM_BATCH])
    second = (tokens[LM_BATCH:], labels[LM_BATCH:])
    jt = _jax_lm()
    jt.train_step(*first)
    pt = _port_lm(seed=7)
    if route == "state_pkl":
        JaxSaver(str(tmp_path / "jax")).save(jt.state_to_host(), 1)
        state, step = CheckpointSaver(str(tmp_path / "jax")).load_latest()
        assert step == 1 and isinstance(state, _pickle.TrainState)
        pt.state = convert.dp_trainer_state_from_jax(state, pt.model)
        pt.ensure_initialized()
    else:
        jt.save_checkpoint(JaxShardedSaver(str(tmp_path / "jax")), 1)
        pt.set_sharded_restore(ShardedCheckpointSaver(str(tmp_path / "jax")), 1)
        pt.ensure_initialized()
    _assert_port_dp_state(pt, convert.dp_trainer_state_from_jax(jax.device_get(jt.state),
                                                                pt.model))

    jt2 = _jax_lm(seed=5)
    if route == "state_pkl":
        CheckpointSaver(str(tmp_path / "port")).save(pt.state_to_jax_host(), 1)
        assert jax_verify_integrity(str(tmp_path / "port" / "step_000000000001")) is None
        state, step = JaxSaver(str(tmp_path / "port")).load_latest()
        assert step == 1
        jt2.state = state
    else:
        pt.save_checkpoint(ShardedCheckpointSaver(str(tmp_path / "port")), 1)
        assert sorted(JaxShardedSaver(str(tmp_path / "port")).load_dense(1)["leaves"]) == \
            sorted(JaxShardedSaver(str(tmp_path / "jax")).load_dense(1)["leaves"])
        jt2.set_sharded_restore(JaxShardedSaver(str(tmp_path / "port")), 1)
        jt2.ensure_initialized(first[0])
    _assert_trees_equal(jax.device_get(jt2.state), jax.device_get(jt.state))

    want = float(jt.train_step(*second))
    assert float(jt2.train_step(*second)) == want
    np.testing.assert_allclose(float(pt.train_step(*second)), want, rtol=1e-5)


# ----------------------------------------------------------------------
# the saver's own behaviour
# ----------------------------------------------------------------------


def _tear(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _small_sharded(saver, step, value):
    table = np.full((8, 4), value, np.float32)
    saver.save(step, {"step": np.asarray(step, np.int32)},
               {"t": ShardedArray((8, 4), "float32", [(0, 8, table)])})


@pytest.mark.parametrize("what", ["state_pkl", "shard_file"])
def test_torn_checkpoint_is_quarantined(tmp_path, what):
    if what == "state_pkl":
        saver = CheckpointSaver(str(tmp_path))
        for step in (1, 2):
            saver.save({"w": np.full(64, step, np.float32)}, step)
        _tear(tmp_path / "step_000000000002" / "state.pkl")
        state, step = saver.load_latest()
        assert step == 1 and state["w"][0] == 1.0
    else:
        saver = ShardedCheckpointSaver(str(tmp_path))
        for step in (1, 2):
            _small_sharded(saver, step, float(step))
        _tear(tmp_path / "step_000000000002" / "shards_p0of1.npz")
        assert saver.latest_step() == 1
        assert saver.load_rows(1, "t", 0, 8)[0, 0] == 1.0
    assert os.path.isdir(tmp_path / "step_000000000002.quarantined")
    assert not os.path.exists(tmp_path / "step_000000000002")


def test_unreadable_class_is_skipped_not_quarantined(tmp_path):
    saver = CheckpointSaver(str(tmp_path))
    saver.save({"w": np.zeros(2, np.float32)}, 1)
    JaxSaver(str(tmp_path)).save({"bad": optax.adam(LR).init({"w": np.zeros(2)}),
                                  "x": jax.numpy.float32}, 2)
    state, step = saver.load_latest()
    assert step == 1
    assert os.path.isdir(tmp_path / "step_000000000002")  # evidence untouched


def test_stale_tmp_sweep_and_gc(tmp_path):
    saver = CheckpointSaver(str(tmp_path), keep_max=2)
    stale, fresh = tmp_path / "step_000000000009.tmpab", tmp_path / "step_000000000010.tmpcd"
    stale.mkdir()
    fresh.mkdir()
    old = time.time() - 2 * 3600
    os.utime(stale, (old, old))
    for step in (1, 2, 3):
        saver.save({"w": np.full(2, step, np.float32)}, step)
    assert saver.steps() == [2, 3]
    assert not stale.exists() and fresh.exists()
    sharded = ShardedCheckpointSaver(str(tmp_path / "sharded"), keep_max=1)
    for step in (1, 2):
        _small_sharded(sharded, step, float(step))
    assert sharded.steps() == [2] and sharded.latest_step() == 2


def _write_shards(step_dir, files):
    os.makedirs(step_dir, exist_ok=True)
    for i, entries in enumerate(files):
        np.savez(os.path.join(step_dir, f"shards_p{i}of{len(files)}.npz"), **entries)


ROWS = np.arange(40, dtype=np.float32).reshape(10, 4)


@pytest.mark.parametrize("case", ["across_files", "one_entry", "overlapping_copies",
                                  "missing_rows", "name_isolation"])
def test_row_reader(tmp_path, case):
    if case == "name_isolation":
        _write_shards(tmp_path, [{"a|0|10": ROWS, "ab|0|10": -ROWS, "a|b|0|10": ROWS * 2}])
        np.testing.assert_array_equal(RowReader(str(tmp_path), "a").read(0, 10), ROWS)
        np.testing.assert_array_equal(RowReader(str(tmp_path), "ab").read(2, 5), -ROWS[2:5])
        np.testing.assert_array_equal(RowReader(str(tmp_path), "a|b").read(0, 10), ROWS * 2)
        with pytest.raises(ValueError, match="missing"):
            RowReader(str(tmp_path), "b").read(0, 1)
        return
    if case == "missing_rows":
        _write_shards(tmp_path, [{"t|0|3": ROWS[:3]}, {"t|6|10": ROWS[6:]}])
        reader = RowReader(str(tmp_path), "t")
        np.testing.assert_array_equal(reader.read(6, 9), ROWS[6:9])
        with pytest.raises(ValueError, match=r"rows \[3, 6\) missing"):
            reader.read(1, 8)
        with pytest.raises(ValueError, match=r"rows \[10, 12\) missing"):
            reader.read(8, 12)
        return
    files = {
        "across_files": [{"t|0|4": ROWS[:4]}, {"t|4|7": ROWS[4:7]}, {"t|7|10": ROWS[7:]}],
        "one_entry": [{"t|0|10": ROWS}],
        "overlapping_copies": [{"t|0|5": ROWS[:5]}, {"t|0|5": ROWS[:5], "t|5|10": ROWS[5:]}],
    }[case]
    _write_shards(tmp_path, files)
    reader = RowReader(str(tmp_path), "t")
    for lo, hi in ((0, 10), (3, 8), (4, 5), (9, 10)):
        np.testing.assert_array_equal(reader.read(lo, hi), ROWS[lo:hi])


def test_jax_row_reader_reads_port_shards(tmp_path):
    """A port-written shard file is np.savez's: the JAX reader takes it."""
    from elasticdl_tpu.checkpoint.sharded import RowReader as JaxRowReader

    saver = ShardedCheckpointSaver(str(tmp_path))
    saver.save(3, {"step": np.asarray(3, np.int32)},
               {"t": ShardedArray((10, 4), "float32",
                                  [(0, 10, torch.from_numpy(ROWS.copy()))])})
    step_dir = str(tmp_path / "step_000000000003")
    np.testing.assert_array_equal(JaxRowReader(step_dir, "t").read(2, 9), ROWS[2:9])
    assert JaxShardedSaver(str(tmp_path)).manifest(3) == saver.manifest(3)


# ----------------------------------------------------------------------
# errors that name their cause
# ----------------------------------------------------------------------


def test_table_set_and_scalar_slot_mismatches_raise(tmp_path):
    (f0, l0), _ = _batches()
    merged = _port_trainer(False, "adam_global")
    merged.train_step(f0, l0)
    merged.save_checkpoint(ShardedCheckpointSaver(str(tmp_path / "merged")), 1)
    split = _port_trainer(True, "adam_global")
    split.set_sharded_restore(ShardedCheckpointSaver(str(tmp_path / "merged")), 1)
    with pytest.raises(ValueError, match="table layout changed"):
        split.ensure_initialized()
    per_row = _port_trainer(False, "adam_per_row")
    per_row.train_step(f0, l0)
    per_row.save_checkpoint(ShardedCheckpointSaver(str(tmp_path / "per_row")), 1)
    global_bias = _port_trainer(False, "adam_global")
    global_bias.set_sharded_restore(ShardedCheckpointSaver(str(tmp_path / "per_row")), 1)
    with pytest.raises(ValueError, match="no scalar slot fm_embedding/embedding/t_global"):
        global_bias.ensure_initialized()
    wider = ShardedEmbeddingTrainer(
        build_model(MODEL_DEF, dict(_params(False), vocab_size=2 * VOCAB), device="cpu"),
        port_zoo.loss, port_zoo.optimizer(), embedding_optimizer=sparse_optim.adam(LR),
        device="cpu")
    wider.set_sharded_restore(ShardedCheckpointSaver(str(tmp_path / "per_row")), 1)
    with pytest.raises(ValueError, match="vocabulary changed"):
        wider.ensure_initialized()


def test_unpickler_refuses_other_globals(tmp_path):
    buf = io.BytesIO()
    pickle.dump({"x": np.zeros(2), "f": optax.adam}, buf)
    buf.seek(0)
    with pytest.raises(pickle.UnpicklingError, match="names optax"):
        _pickle.load(buf)
    buf = io.BytesIO()
    pickle.dump(_pickle.EmptyState(), buf)  # the stand-in's own module is no JAX name
    buf.seek(0)
    with pytest.raises(pickle.UnpicklingError, match="elasticdl_tpu_torch"):
        _pickle.load(buf)
    buf = io.BytesIO()
    pickle.dump(optax.EmptyState(), buf)  # a checkpoint's name, refused by the artifact reader
    buf.seek(0)
    with pytest.raises(pickle.UnpicklingError, match="only numpy arrays and containers"):
        _pickle.load(buf, jax_names=False)
    with pytest.raises(pickle.PicklingError, match="no JAX-readable name"):
        CheckpointSaver(str(tmp_path)).save({"t": torch.zeros(2)}, 1)
    assert CheckpointSaver(str(tmp_path)).steps() == []


# ----------------------------------------------------------------------
# a gloo process mesh: 4 ranks save, 2 and 1 restore
# ----------------------------------------------------------------------


def _spawn(world, mode, ckpt_dir, out_dir):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    store = out_dir / f"store_{mode}_{world}"
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_ckpt_worker.py"),
                               mode, str(rank), str(world), str(store), str(ckpt_dir),
                               str(out_dir)],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{mode} world {world} rank {rank}:\n{log}"


@pytest.fixture(scope="module")
def process_mesh_ckpt(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo_ckpt")
    ckpt = out / "ckpt"
    _spawn(ckpt_worker.SAVE_WORLD, "save", ckpt, out)
    for world in ckpt_worker.RESTORE_WORLDS:
        _spawn(world, "restore", ckpt, out)
    return out


@pytest.mark.parametrize("world", ckpt_worker.RESTORE_WORLDS)
def test_process_mesh_checkpoint_restores_under_fewer_ranks(process_mesh_ckpt, world):
    saved = dict(np.load(process_mesh_ckpt / "saved.npz"))
    restored = dict(np.load(process_mesh_ckpt / f"restored_{world}.npz"))
    manifest = ShardedCheckpointSaver(str(process_mesh_ckpt / "ckpt")).manifest(
        ckpt_worker.STEPS)
    assert manifest["n_processes"] == ckpt_worker.SAVE_WORLD
    state_keys = [k for k in saved if k.startswith(("table|", "slot|", "param|", "opt|"))]
    assert state_keys and sorted(state_keys) == sorted(
        k for k in restored if k.startswith(("table|", "slot|", "param|", "opt|")))
    for key in state_keys:
        assert np.array_equal(restored[key], saved[key]), key
    np.testing.assert_allclose(restored["next_loss"], saved["next_loss"], **STEP_TOL)
    # Every rank read only its own block interval of each table.
    assert restored["own_intervals_only"].all() and restored["reads"] > 0
