"""The port's serving path (elasticdl_tpu_torch/serving) on the CPU,
against the JAX package's.

A tiny DeepFM is trained and exported by the JAX package (one PS-mode
artifact per generation, as tests/test_serving.py does); the port loads
those artifacts and must predict within rtol=1e-5 of JAX's
``load_for_serving(...).predict``, through ``ServingReplica`` +
``MicroBatcher`` under concurrency, across a hot swap, and with a
corrupt artifact rejected while the old generation keeps serving.
"""

import os
import pickle
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest

from elasticdl_tpu.data import pipeline as jpipeline
from elasticdl_tpu.parallel import MeshConfig, build_mesh
from elasticdl_tpu.parallel.ps_trainer import ShardedEmbeddingTrainer
from elasticdl_tpu.serving import export_model
from elasticdl_tpu.serving import load_for_serving as jax_load_for_serving
from elasticdl_tpu.worker.trainer import Trainer
from elasticdl_tpu_torch.data import pipeline
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.serving.batcher import (
    BatcherConfig,
    MicroBatcher,
    QueueFullError,
    RequestError,
)
from elasticdl_tpu_torch.serving.export import (
    load_for_serving,
    read_variables,
    write_artifact,
)
from elasticdl_tpu_torch.serving.runtime import ServingReplica
from elasticdl_tpu_torch.zoo import build_model
from model_zoo.deepfm import deepfm_functional_api as zoo
from test_ctr_models import _batches

LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_DEF = "deepfm.deepfm_functional_api"


def _export(trainer, out_dir, model_params="vocab_size=100"):
    export_model(trainer, out_dir, model_zoo="model_zoo", model_def=MODEL_DEF,
                 model_params=model_params)
    return out_dir


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """gen1/gen2: one PS trainer exported after 2 and after 4 steps;
    local: a single-device Trainer's export (tables inside the pickle)."""
    root = tmp_path_factory.mktemp("torch_serving")
    batches = list(_batches(zoo, n=64, mb=16))
    trainer = ShardedEmbeddingTrainer(
        zoo.custom_model(vocab_size=100), zoo.loss, zoo.optimizer(lr=0.01),
        build_mesh(MeshConfig()), embedding_optimizer=zoo.embedding_optimizer(lr=0.01),
    )
    for feats, labels in batches[:2]:
        trainer.train_step(feats, labels)
    gen1 = _export(trainer, str(root / "gen1"))
    for feats, labels in batches[2:4]:
        trainer.train_step(feats, labels)
    gen2 = _export(trainer, str(root / "gen2"))
    local = Trainer(zoo.custom_model(vocab_size=100), zoo.loss, optax.sgd(0.1))
    local.train_step(*batches[0])
    local_dir = _export(local, str(root / "local"))
    feats = {k: np.concatenate([b[0][k] for b in batches]) for k in batches[0][0]}
    feats["cat"][0, :2] = [-1, 10_000]  # padding and out of vocabulary
    return {"gen1": gen1, "gen2": gen2, "local": local_dir, "features": feats,
            "root": root}


def _jax_predict(model_dir, features):
    return np.asarray(jax_load_for_serving(model_dir).predict(features))


@pytest.mark.parametrize("which", ["gen1", "local"])
def test_port_serves_jax_artifact(artifacts, which):
    features = artifacts["features"]
    served = load_for_serving(artifacts[which], device="cpu")
    got = served.predict(features)
    assert got.shape == (features["cat"].shape[0],)
    np.testing.assert_allclose(got, _jax_predict(artifacts[which], features), **LOGIT_TOL)
    # deterministic: repeat predictions are bit-identical
    np.testing.assert_array_equal(got, served.predict(features))


@pytest.mark.parametrize("which", ["gen1", "local"])
def test_jax_artifacts_pickle_only_numpy_globals(artifacts, which):
    """What the restricted reader must accept, found by exporting."""
    names = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            names.add((module, name))
            return super().find_class(module, name)

    with open(os.path.join(artifacts[which], "variables.pkl"), "rb") as f:
        Recorder(f).load()
    assert names <= {("numpy", "ndarray"), ("numpy", "dtype"),
                     ("numpy._core.multiarray", "_reconstruct"),
                     ("numpy.core.multiarray", "_reconstruct")}, names
    assert ("numpy", "ndarray") in names
    read_variables(os.path.join(artifacts[which], "variables.pkl"))


def test_restricted_unpickler_rejects_foreign_classes(tmp_path):
    import collections

    for obj in ({"params": collections.OrderedDict(a=np.zeros(2))},
                {"params": {"w": jnp.zeros(3)}}):
        path = tmp_path / "variables.pkl"
        path.write_bytes(pickle.dumps(obj))
        with pytest.raises(pickle.UnpicklingError, match="only numpy arrays"):
            read_variables(str(path))
    path.write_bytes(pickle.dumps({"params": {"w": np.arange(3.0), "s": np.float32(2)}}))
    assert read_variables(str(path))["params"]["w"].tolist() == [0.0, 1.0, 2.0]


def test_replica_batcher_concurrent_mixed_rows(artifacts):
    features = artifacts["features"]
    want = _jax_predict(artifacts["gen1"], features)
    replica = ServingReplica(artifacts["gen1"], device="cpu")
    batcher = MicroBatcher(
        replica.execute, BatcherConfig(max_batch_size=16, max_wait_us=2000, queue_limit=256)
    ).start()
    rng = np.random.RandomState(7)
    spans = []
    lo = 0
    while lo < features["cat"].shape[0]:
        rows = int(rng.randint(1, 8))
        spans.append((lo, min(lo + rows, features["cat"].shape[0])))
        lo += rows
    results = {}
    errors = []

    def client(w):
        try:
            for i in range(w, len(spans), 6):
                a, b = spans[i]
                results[i] = batcher.predict({k: v[a:b] for k, v in features.items()})
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(w,)) for w in range(6)]
    try:
        replica.warmup({k: v[:1] for k, v in features.items()}, batcher.buckets)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        batcher.stop()
    assert not errors, errors
    assert len(results) == len(spans)
    for i, (a, b) in enumerate(spans):
        assert results[i].shape == (b - a,)
        np.testing.assert_allclose(results[i], want[a:b], **LOGIT_TOL)
    batch = pipeline.pad_features({k: v[:5] for k, v in features.items()}, 8)
    np.testing.assert_array_equal(replica.execute(batch, 5), replica.execute(batch, 5))
    assert replica.generation.inflight() == 0


def test_reload_swaps_and_corrupt_artifact_keeps_serving(artifacts, tmp_path):
    features = {k: v[:16] for k, v in artifacts["features"].items()}
    want1 = _jax_predict(artifacts["gen1"], features)
    want2 = _jax_predict(artifacts["gen2"], features)
    replica = ServingReplica(artifacts["gen1"], device="cpu")
    gen1 = replica.generation
    np.testing.assert_allclose(replica.execute(features, 16), want1, **LOGIT_TOL)

    corrupt = str(tmp_path / "corrupt")
    shutil.copytree(artifacts["gen2"], corrupt)
    with open(os.path.join(corrupt, "variables.pkl"), "r+b") as f:
        f.truncate(100)
    with pytest.raises(pickle.UnpicklingError):
        replica.reload(corrupt)
    assert replica.generation is gen1 and replica.stats()["generation"] == 1
    np.testing.assert_allclose(replica.execute(features, 16), want1, **LOGIT_TOL)

    new = replica.reload(artifacts["gen2"])
    assert replica.generation is new and replica.stats()["generation"] == 2
    assert replica.stats()["step"] == 4 and gen1.inflight() == 0
    np.testing.assert_allclose(replica.execute(features, 16), want2, **LOGIT_TOL)
    # the old generation still answers when asked explicitly (canary path)
    np.testing.assert_allclose(replica.shadow_execute(features, gen1), want1, **LOGIT_TOL)

    missing_table = str(tmp_path / "missing_table")
    shutil.copytree(artifacts["gen1"], missing_table)
    os.remove(os.path.join(missing_table, "tables", "0.npy"))
    with pytest.raises(FileNotFoundError):
        replica.reload(missing_table)
    assert replica.generation is new
    np.testing.assert_allclose(replica.execute(features, 16), want2, **LOGIT_TOL)


def test_port_written_artifact_loads_in_jax(tmp_path):
    """write_artifact writes the JAX package's format: the JAX loader
    serves what the port wrote, and both agree."""
    params = "vocab_size=40,embedding_dim=4,hidden=16,split_tables=true"
    shapes_only = build_model(MODEL_DEF, params, device="meta")
    variables, tables = convert.random_jax_variables(shapes_only, seed=3)
    out = write_artifact(str(tmp_path / "art"), variables, tables,
                         {"model_def": MODEL_DEF, "model_params": params},
                         chunk_rows=7)
    rng = np.random.RandomState(8)
    features = {"dense": rng.rand(5, zoo.NUM_DENSE).astype(np.float32),
                "cat": rng.randint(-1, 42, size=(5, zoo.NUM_CAT)).astype(np.int32)}
    ref = np.asarray(jax_load_for_serving(out, model_zoo="model_zoo").predict(features))
    got = load_for_serving(out, device="cpu").predict(features)
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def test_bucket_math_matches_jax():
    for max_batch in list(range(1, 70)) + [128, 1000]:
        buckets = pipeline.bucket_sizes(max_batch)
        assert buckets == jpipeline.bucket_sizes(max_batch)
        for n in range(1, max_batch + 2):
            assert pipeline.bucket_for(n, buckets) == jpipeline.bucket_for(n, buckets)
    with pytest.raises(ValueError):
        pipeline.bucket_sizes(0)
    feats = {"dense": np.ones((3, 2), np.float32), "cat": np.arange(6).reshape(3, 2)}
    ours, bucket = pipeline.pad_and_stage(feats, 3, pipeline.bucket_sizes(8))
    ref, ref_bucket = jpipeline.pad_and_stage(feats, 3, jpipeline.bucket_sizes(8))
    assert bucket == ref_bucket == 4
    for key in feats:
        np.testing.assert_array_equal(ours[key], ref[key])


def _rows_fn(features, n_valid):
    return features["x"][:, 0] * 2.0


def test_batcher_sheds_drops_and_fans_out_errors():
    gate = threading.Event()

    def slow(features, n_valid):
        gate.wait(10)
        return _rows_fn(features, n_valid)

    batcher = MicroBatcher(slow, BatcherConfig(max_batch_size=4, max_wait_us=100,
                                               queue_limit=2)).start()
    try:
        first = batcher.submit({"x": np.ones((4, 1))})   # dispatched, blocks in slow()
        deadline = time.monotonic() + 5
        while batcher.queue_depth() and time.monotonic() < deadline:
            time.sleep(0.01)
        late = batcher.submit({"x": np.ones((1, 1))}, deadline_s=1e-4)
        kept = batcher.submit({"x": np.full((2, 1), 3.0)})
        with pytest.raises(QueueFullError):
            batcher.submit({"x": np.ones((1, 1))})
        with pytest.raises(ValueError):
            batcher.submit({"x": np.ones((5, 1))})
        time.sleep(0.01)
        gate.set()
        np.testing.assert_array_equal(first.wait(10), np.full(4, 2.0))
        with pytest.raises(RequestError, match="deadline"):
            late.wait(10)
        np.testing.assert_array_equal(kept.wait(10), np.full(2, 6.0))
    finally:
        batcher.stop()

    def broken(features, n_valid):
        raise RuntimeError("device lost")

    batcher = MicroBatcher(broken, BatcherConfig(max_batch_size=8, max_wait_us=50_000)).start()
    try:
        reqs = [batcher.submit({"x": np.ones((2, 1))}) for _ in range(3)]
        for req in reqs:
            with pytest.raises(RequestError, match="device lost"):
                req.wait(10)
    finally:
        batcher.stop()
    with pytest.raises(RequestError, match="stopped"):
        batcher.submit({"x": np.ones((1, 1))})
