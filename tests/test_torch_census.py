"""The port's CTR zoo of this slice (``zoo/census_wide_deep.py``,
``zoo/census_feature_columns.py``, ``zoo/wide_and_deep.py``) and the
census reader against the JAX package, on the CPU.

- The synthetic census reader gives the JAX reader's records value for
  value; W&D's reader honours ``vocab`` and the ``census-synth`` shard.
- Each model's logits from JAX variables carried across
  (``serving.convert``) within rtol 1e-6 / atol 1e-6 of flax's.
- 3 PS steps of the port's ``ShardedEmbeddingTrainer`` against JAX's
  (its xla engine, and its Pallas kernels in interpret mode), started
  from the JAX trainer's state, at ``tests/test_torch_training.py``'s
  tolerances: losses, dense and sparse gradients at rtol 1e-5 / atol
  1e-6 each step; final variables likewise, except the elements whose
  two gradients differ in sign or by enough to move Adam's first-step
  update (held to ``2·lr·steps``, and few).
- Census learns from raw records, as JAX's does
  (``tests/test_preprocessing.py:206``).
- ``client.main train --distribution_strategy=ParameterServerStrategy``
  on ``synthetic://census`` with evaluation: the job's final metrics
  equal an in-process evaluation of its export.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.data.dataset import Dataset as JaxDataset
from elasticdl_tpu.layers.embedding import export_spec_map, strip_capture_collections
from elasticdl_tpu.ops import sparse_embedding as jske
from elasticdl_tpu.parallel import packed as jpk
from elasticdl_tpu.parallel.mesh import MeshConfig, build_mesh
from elasticdl_tpu.parallel.ps_trainer import ShardedEmbeddingTrainer as JaxTrainer
from elasticdl_tpu.worker.trainer import _unbox_partitioned
from elasticdl_tpu_torch.data.dataset import Dataset, _stack
from elasticdl_tpu_torch.data.synthetic import synthetic_census_records
from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.serving.export import load_for_serving
from elasticdl_tpu_torch.zoo import build_model, resolve
from model_zoo import datasets
from model_zoo.census import census_feature_columns as jax_fc
from model_zoo.census import census_wide_deep as jax_census
from model_zoo.wide_and_deep import wide_and_deep as jax_wd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
FINAL_TOL = dict(rtol=1e-5, atol=1e-6)
EPS = 1e-8
STEPS, BATCH = 3, 32
WD_PARAMS = dict(vocab_size=50)

#: model_def -> (the JAX zoo module, model params, the zoo's lr)
MODELS = {
    "census.census_wide_deep": (jax_census, {}, 0.01),
    "census.census_feature_columns": (jax_fc, {}, 0.01),
    "wide_and_deep.wide_and_deep": (jax_wd, WD_PARAMS, 0.005),
}


class _Task:
    def __init__(self, start, end, shard_name="s"):
        self.start, self.end, self.shard_name = start, end, shard_name


def _batches(model_def, n_batches, seed=3, batch=BATCH):
    """Evaluation-mode (unshuffled) batches of the model's dataset_fn."""
    n = batch * n_batches
    if model_def.startswith("census"):
        records = synthetic_census_records(n, seed)
        records[0][0]["education"] = "no-such-degree"  # the OOV bucket
    else:
        reader = resolve(model_def).custom_data_reader(f"synthetic://ctr?n={n}&vocab=50&seed={seed}")
        records = list(reader.read_records(_Task(0, n)))
        records[0][0]["cat"] = records[0][0]["cat"].copy()
        records[0][0]["cat"][:2] = [-1, -1]  # padding
    rows = list(resolve(model_def).dataset_fn(Dataset.from_iterable(records), "evaluation", None))
    return [_stack(rows[i * batch:(i + 1) * batch]) for i in range(n_batches)]


@pytest.mark.parametrize("seed", [0, 7])
def test_census_reader_matches_jax(seed):
    from elasticdl_tpu_torch.zoo import census_wide_deep

    reader = census_wide_deep.custom_data_reader(f"synthetic://census?n=300&seed={seed}")
    ref = datasets.synthetic_census_reader(n=300, seed=seed)
    assert reader.create_shards() == ref.create_shards() == {"census-synth": 300}
    task = _Task(0, 300)
    ours, theirs = list(reader.read_records(task)), list(ref.read_records(task))
    assert len(ours) == len(theirs) == 300
    for (raw, label), (jraw, jlabel) in zip(ours, theirs):
        assert type(label) is type(jlabel) and label == jlabel
        assert sorted(raw) == sorted(jraw)
        for key, value in jraw.items():
            assert type(raw[key]) is type(value) and raw[key] == value, key
    assert list(reader.read_records(_Task(290, 400))) == ours[290:]
    assert census_wide_deep.custom_data_reader("synthetic://criteo?n=5") is None


def test_wide_and_deep_reader_matches_jax():
    from elasticdl_tpu_torch.zoo import wide_and_deep

    path = "synthetic://anything?n=200&vocab=77&seed=4"
    reader, ref = wide_and_deep.custom_data_reader(path), jax_wd.custom_data_reader(path)
    assert reader.create_shards() == ref.create_shards() == {"census-synth": 200}
    task = _Task(10, 150)
    for (f, label), (jf, jlabel) in zip(reader.read_records(task), ref.read_records(task)):
        assert label == jlabel and f["cat"].max() < 77
        for key in jf:
            np.testing.assert_array_equal(f[key], jf[key])
            assert f[key].dtype == jf[key].dtype
    assert wide_and_deep.custom_data_reader("/no/such/file.csv") is None


def test_every_jax_zoo_model_def_resolves():
    zoo_dir = os.path.join(REPO, "model_zoo")
    defs = sorted(f"{family}.{name[:-3]}" for family in os.listdir(zoo_dir)
                  if os.path.isdir(os.path.join(zoo_dir, family))
                  for name in os.listdir(os.path.join(zoo_dir, family))
                  if name.endswith(".py") and name != "__init__.py")
    assert len(defs) == 9
    for model_def in defs:
        assert resolve(model_def) is not None, model_def


def _random_variables(model, features, seed):
    """Seeded numpy weights in the flax tree of ``model`` (tables packed
    from random logical tables)."""
    variables = dict(model.init(jax.random.PRNGKey(0), features))
    specs = export_spec_map(variables)
    params = _unbox_partitioned(strip_capture_collections(variables)["params"])
    rng = np.random.RandomState(seed)
    tree = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "params/" + "/".join(str(p.key) for p in path)
        if key in specs:
            spec = specs[key]
            logical = rng.uniform(-0.5, 0.5, (spec.vocab_size, spec.dim))
            value = np.asarray(jpk.pack(spec, jnp.asarray(logical, jnp.float32)))
        else:
            value = rng.uniform(-0.3, 0.3, leaf.shape).astype(np.float32)
        convert.set_in_tree(tree, key.split("/"), value)
    return tree


@pytest.mark.parametrize("model_def", sorted(MODELS))
def test_logits_match_flax(model_def):
    jax_zoo, params, _ = MODELS[model_def]
    features = _batches(model_def, 1)[0][0]
    model = jax_zoo.custom_model(**params)
    variables = _random_variables(model, features, seed=1)
    ref = np.asarray(model.apply(variables, features))
    port = build_model(model_def, params, device="cpu")
    convert.load_state(port, convert.state_dict_from_jax(variables, port))
    keys = {k for k, _, _, _ in convert._targets(port)}
    assert {"params/wide_embedding/embedding", "params/deep_embedding/embedding",
            "params/Dense_0/kernel", "params/Dense_1/bias"} <= keys
    with torch.inference_mode():
        got = port.eval()({k: torch.from_numpy(v) for k, v in features.items()}).numpy()
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def _jax_layout(model, dense):
    out = {}
    for jax_key, port_key, kind, _ in convert._targets(model):
        if kind != "table":
            g = np.asarray(dense[port_key])
            out[jax_key] = g.T if kind == "dense_kernel" else g
    return out


def _table_grads(pt, sparse):
    """Captured (ids, grads) -> each table's summed gradient, logical view."""
    out = {}
    for key, (ids, grads) in sparse.items():
        spec = pt.table_specs[key]
        acc = pk.grad_accumulate(spec, torch.zeros(spec.rows_shape),
                                 torch.as_tensor(np.array(ids)), torch.as_tensor(np.array(grads)))
        out["params/" + key] = acc[: spec.vocab_size, : spec.dim].numpy()
    return out


def _sign_sensitive(history, lr):
    """Per name, the elements whose two gradients differ in sign, or by
    enough to move Adam's first-step update by more than FINAL_TOL's
    atol / 10, in some step."""
    flags = {}
    for jax_g, port_g in history:
        for name, g in jax_g.items():
            diff = np.abs(g - port_g[name])
            moved = lr * diff * EPS / (np.abs(g) + EPS) ** 2
            bad = (np.sign(g) != np.sign(port_g[name])) | (moved > FINAL_TOL["atol"] / 10)
            flags[name] = flags.get(name, np.zeros(g.shape, bool)) | bad
    return flags


@pytest.mark.parametrize("kernel", ["xla", "fused"])
@pytest.mark.parametrize("model_def", sorted(MODELS))
def test_trainer_matches_jax_trainer(model_def, kernel, monkeypatch):
    jax_zoo, params, lr = MODELS[model_def]
    monkeypatch.setattr(jske, "_DEFAULT_KERNEL", kernel)  # the layers' engine
    batches = _batches(model_def, STEPS)
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jt = JaxTrainer(jax_zoo.custom_model(**params), jax_zoo.loss, jax_zoo.optimizer(), mesh,
                    embedding_optimizer=jax_zoo.embedding_optimizer(), sparse_kernel=kernel)
    jt.ensure_initialized(batches[0][0])
    port_zoo = resolve(model_def)
    model = build_model(model_def, params, device="cpu")
    pt = ShardedEmbeddingTrainer(model, port_zoo.loss, port_zoo.optimizer(),
                                 embedding_optimizer=port_zoo.embedding_optimizer(),
                                 device="cpu")
    pt.ensure_initialized()
    pt.state = convert.trainer_state_from_jax(jax.device_get(jt.state), model)
    forward_backward = jax.jit(jt._forward_backward)
    history = []
    for features, labels in batches:
        mask = np.ones((BATCH,), np.float32)
        j_loss, muts, j_dense, j_perturb = forward_backward(jt.state, features, labels, mask)
        p_loss, cap = pt.forward(*pt.stage_batch(features, labels, mask))
        p_dense, p_sparse, _ = pt.backward(p_loss, cap)
        np.testing.assert_allclose(float(p_loss.detach()), float(j_loss), **STEP_TOL)
        j_dense = convert._dense_from_jax(jax.device_get(j_dense), model)
        for name, g in j_dense.items():
            np.testing.assert_allclose(p_dense[name].numpy(), g, err_msg=name, **STEP_TOL)
        j_sparse = {key: (np.asarray(ids), np.asarray(grads))
                    for key, _, ids, grads in jt._sparse_batches(muts, j_perturb, jt.state.tables)}
        assert sorted(j_sparse) == sorted(p_sparse) == ["deep_embedding/embedding",
                                                         "wide_embedding/embedding"]
        for key, (ids, grads) in j_sparse.items():
            np.testing.assert_array_equal(p_sparse[key][0].numpy(), ids)
            np.testing.assert_allclose(p_sparse[key][1].numpy(), grads, err_msg=key, **STEP_TOL)
        history.append((
            {**_jax_layout(model, j_dense), **_table_grads(pt, j_sparse)},
            {**_jax_layout(model, {k: g.numpy() for k, g in p_dense.items()}),
             **_table_grads(pt, p_sparse)},
        ))
        jt.train_step(features, labels)
        pt.train_step(features, labels)
    assert pt.step == STEPS
    jv, pv = jt.get_variables_numpy(), pt.get_variables_numpy()
    assert sorted(jv) == sorted(pv)
    flags, named = _sign_sensitive(history, lr), []
    for name in jv:
        ref, got = jv[name], pv[name]
        sensitive = flags.get(name, np.zeros(ref.shape, bool))
        np.testing.assert_allclose(got[~sensitive], ref[~sensitive], err_msg=name, **FINAL_TOL)
        assert np.all(np.abs(got - ref)[sensitive] <= 2 * lr * STEPS + 1e-6), name
        named += [(name, tuple(int(i) for i in idx)) for idx in np.argwhere(sensitive)]
    assert len(named) <= 0.02 * sum(v.size for v in jv.values()), named[:20]


def test_census_learns_from_raw_features():
    """JAX's ``test_census_model_trains_from_raw_features`` on the port."""
    zoo = resolve("census.census_wide_deep")
    trainer = ShardedEmbeddingTrainer(build_model("census.census_wide_deep", "", device="cpu"),
                                      zoo.loss, zoo.optimizer(),
                                      embedding_optimizer=zoo.embedding_optimizer(),
                                      device="cpu")

    def batches(n, mb, seed):
        records = synthetic_census_records(n, seed)
        rows = list(zoo.dataset_fn(Dataset.from_iterable(records), "training", None))
        return [_stack(rows[i:i + mb]) for i in range(0, n, mb)]

    losses = []
    for epoch in range(8):
        for feats, labels in batches(64, 16, epoch % 2):
            losses.append(float(trainer.train_step(feats, labels)))
    assert losses[-1] < losses[0] * 0.9, f"no learning: {losses[:2]} -> {losses[-2:]}"
    feats, labels = batches(16, 16, 9)[0]
    out = trainer.eval_step(feats)
    metrics = {name: fn(np.asarray(out), labels) for name, fn in zoo.eval_metrics_fn().items()}
    assert 0.0 <= metrics["auc"] <= 1.0
    # JAX's dataset_fn gives the same training batches.
    records = synthetic_census_records(64, 0)
    ours = list(zoo.dataset_fn(Dataset.from_iterable(records), "training", None))
    theirs = list(jax_census.dataset_fn(JaxDataset.from_generator(lambda: iter(records)),
                                        "training", None))
    assert [label for _, label in ours] == [label for _, label in theirs]


def test_census_ps_job_metrics_equal_its_export(tmp_path):
    """A CPU PS job through ``client.main train``: the final evaluation
    round equals the export evaluated here on the same records."""
    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    n_val, batch = 512, 64
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train",
         "--distribution_strategy=ParameterServerStrategy", "--model_zoo=model_zoo",
         "--model_def=census.census_wide_deep", "--training_data=synthetic://census?n=2048",
         f"--validation_data=synthetic://census?n={n_val}&seed=1", f"--minibatch_size={batch}",
         "--records_per_task=512", "--num_epochs=1", "--evaluation_steps=16",
         f"--output={out}", f"--checkpoint_dir={ckpt}", "--device=cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]

    def events(name, event):
        with open(ckpt / name) as f:
            return [e for e in map(json.loads, f) if e["event"] == event]

    rounds = events("events.jsonl", "evaluation_metrics")
    assert [r["model_version"] for r in rounds] == [16, 32] and rounds[-1]["examples"] == n_val
    done = events("events_worker_0.jsonl", "worker_task_done")[-1]
    assert done["process_steps"] == 32 and done["forbidden_modules"] == []
    zoo = resolve("census.census_wide_deep")
    served = load_for_serving(str(out), device="cpu")
    with open(out / "signature.json") as f:
        assert json.load(f)["step"] == 32
    rows = list(zoo.dataset_fn(Dataset.from_iterable(synthetic_census_records(n_val, 1)),
                               "evaluation", None))
    outputs, labels = [], []
    for lo in range(0, n_val, batch):
        features, lab = _stack(rows[lo:lo + batch])
        outputs.append(served.predict(features))
        labels.append(lab)
    outputs, labels = np.concatenate(outputs), np.concatenate(labels)
    here = {k: float(fn(outputs, labels)) for k, fn in zoo.eval_metrics_fn().items()}
    final = rounds[-1]["metrics"]
    assert final["accuracy"] == here["accuracy"], (final, here)
    assert abs(final["auc"] - here["auc"]) <= 1e-4, (final, here)
    assert here["auc"] > 0.6, here  # it learned
