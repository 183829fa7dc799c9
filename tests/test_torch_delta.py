"""The port's delta chain (``elasticdl_tpu_torch.checkpoint.delta``) and
the replica's delta apply (``ServingReplica.apply_delta``) against the
JAX package's on the CPU.

DeepFM at vocab 2000 per field, ``embedding_dim`` 4, ``hidden`` 16, batch
16, merged and split layouts.  A full is published, the trainer takes 2
steps, a delta is published:

- JAX's ``resolve_chain`` and ``load_delta`` read a port-published chain,
  and the full's tables patched with the delta's blocks equal a fresh
  export bit for bit; the JAX replica applies it and serves the port
  trainer's ``eval_step`` within rtol 1e-5 / atol 1e-6 (the hot-swap bar
  of ``tests/test_torch_serving.py``).
- The port's ``resolve_chain`` and ``ServingReplica.apply_delta`` consume
  a JAX-published chain: the port's logits equal the JAX replica's after
  its own ``apply_delta`` within the same bar.
- A torn delta is quarantined and ends the chain, the replica refuses it
  and keeps serving; compaction repairs the gap.  A chain gap is
  rejected and the old generation keeps serving; a built generation
  serves nothing until it is committed.
"""

import json
import os

import jax
import numpy as np
import pytest

from elasticdl_tpu.checkpoint import delta as jax_delta
from elasticdl_tpu.parallel.mesh import MeshConfig, build_mesh
from elasticdl_tpu.parallel.ps_trainer import ShardedEmbeddingTrainer as JaxTrainer
from elasticdl_tpu.serving.runtime import ServingReplica as JaxReplica
from elasticdl_tpu_torch.checkpoint import delta
from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
from elasticdl_tpu_torch.serving.export import export_model
from elasticdl_tpu_torch.serving.runtime import ServingReplica
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import deepfm as port_zoo
from model_zoo.deepfm import deepfm_functional_api as zoo

MODEL_DEF = "deepfm.deepfm_functional_api"
VOCAB, BATCH = 2000, 16
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)


def _params(split):
    return f"vocab_size={VOCAB},embedding_dim=4,hidden=16,split_tables={split}"


def _zoo_args(split):
    return dict(model_zoo="model_zoo", model_def=MODEL_DEF, model_params=_params(split))


def _batches(n=4, seed=5):
    feats, labels = synthetic_ctr_arrays(BATCH * n, vocab_size=VOCAB, seed=seed)
    return [({k: v[i * BATCH:(i + 1) * BATCH] for k, v in feats.items()},
             labels[i * BATCH:(i + 1) * BATCH]) for i in range(n)]


def _port_trainer(split):
    model = build_model(MODEL_DEF, _params(split), device="cpu")
    return ShardedEmbeddingTrainer(model, port_zoo.loss, port_zoo.optimizer(),
                                   embedding_optimizer=port_zoo.embedding_optimizer(),
                                   seed=1, device="cpu")


def _port_chain(pub_dir, split):
    """A port trainer, its full after 1 step and its delta after 2 more."""
    trainer = _port_trainer(split)
    batches = _batches()
    trainer.train_step(*batches[0])
    exporter = delta.DeltaExporter(pub_dir, **_zoo_args(split))
    full_dir = exporter.publish_full(trainer, event_time=1.0)
    assert exporter.publish_delta(trainer) is None  # nothing trained since
    for batch in batches[1:3]:
        trainer.train_step(*batch)
    delta_dir = exporter.publish_delta(trainer, event_time=2.0)
    return trainer, exporter, full_dir, delta_dir


def _packed_tables(model_dir):
    with open(os.path.join(model_dir, "signature.json")) as f:
        meta = json.load(f)["tables"]
    return {m["key"]: np.load(os.path.join(model_dir, m["file"])) for m in meta}


@pytest.mark.parametrize("split", [False, True])
def test_jax_reads_port_published_chain(tmp_path, split):
    pub = str(tmp_path / "pub")
    trainer, exporter, full_dir, delta_dir = _port_chain(pub, split)
    assert jax_delta.resolve_chain(pub) == (full_dir, [delta_dir])
    loaded = jax_delta.load_delta(delta_dir)
    assert loaded["manifest"]["format"] == "elasticdl_tpu_delta/1"
    assert loaded["manifest"]["base_step"] == 1 and loaded["manifest"]["step"] == 3
    fresh = export_model(trainer, str(tmp_path / "fresh"), **_zoo_args(split))
    want = _packed_tables(fresh)
    for key, table in _packed_tables(full_dir).items():
        rows, vals, meta = loaded["tables"][key]
        assert 0 < meta["rows"] < table.shape[0]
        patched = np.array(table)
        patched[rows] = vals
        assert np.array_equal(patched.view(np.uint32), want[key].view(np.uint32)), key
    replica = JaxReplica(full_dir, model_zoo="model_zoo")
    replica.apply_delta(delta_dir)
    assert replica.generation.step == 3
    features = _batches(1, seed=9)[0][0]
    np.testing.assert_allclose(replica.execute(features, n_valid=BATCH),
                               trainer.eval_step(features), **LOGIT_TOL)


@pytest.mark.parametrize("split", [False, True])
def test_port_consumes_jax_published_chain(tmp_path, split):
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jt = JaxTrainer(zoo.custom_model(vocab_size=VOCAB, embedding_dim=4, hidden=16,
                                     split_tables=split),
                    zoo.loss, zoo.optimizer(), mesh,
                    embedding_optimizer=zoo.embedding_optimizer())
    batches = _batches()
    jt.train_step(*batches[0])
    pub = str(tmp_path / "pub")
    exporter = jax_delta.DeltaExporter(pub, **_zoo_args(split))
    full_dir = exporter.publish_full(jt)
    for batch in batches[1:3]:
        jt.train_step(*batch)
    delta_dir = exporter.publish_delta(jt, event_time=3.0)
    assert delta.resolve_chain(pub) == (full_dir, [delta_dir])

    features = _batches(1, seed=9)[0][0]
    jax_replica = JaxReplica(full_dir, model_zoo="model_zoo")
    jax_replica.apply_delta(delta_dir)
    replica = ServingReplica(full_dir, device="cpu")
    before = replica.execute(features, BATCH)
    old = replica.generation
    gen = replica.apply_delta(delta_dir)
    assert replica.generation is gen and gen.gen_id == old.gen_id + 1
    assert gen.step == 3 and gen.served.signature["event_time"] == 3.0
    got = replica.execute(features, BATCH)
    np.testing.assert_allclose(got, jax_replica.execute(features, n_valid=BATCH), **LOGIT_TOL)
    assert not np.allclose(got, before)
    # The old generation's tensors were cloned, never written.
    np.testing.assert_array_equal(old.served.predict(features), before)


def test_torn_delta_is_quarantined_and_compaction_repairs(tmp_path):
    pub = str(tmp_path / "pub")
    trainer, exporter, full_dir, delta_dir = _port_chain(pub, True)
    replica = ServingReplica(full_dir, device="cpu")
    features = _batches(1, seed=9)[0][0]
    before = replica.execute(features, BATCH)
    vals = os.path.join(delta_dir, "vals_0.npy")
    with open(vals, "r+b") as f:
        f.truncate(os.path.getsize(vals) // 2)
    with pytest.raises(ValueError, match="corrupt delta"):
        replica.apply_delta(delta_dir)
    assert replica.generation.step == 1
    np.testing.assert_array_equal(replica.execute(features, BATCH), before)
    assert os.path.isdir(delta_dir + ".quarantined") and not os.path.exists(delta_dir)
    assert delta.resolve_chain(pub) == (full_dir, [])
    compacted = exporter.compact()
    assert os.path.basename(compacted) == "full_000000000003"
    assert delta.resolve_chain(pub) == (compacted, [])
    replica.reload(compacted)
    np.testing.assert_allclose(replica.execute(features, BATCH), trainer.eval_step(features),
                               **LOGIT_TOL)


def test_chain_gap_is_rejected_and_build_waits_for_commit(tmp_path):
    pub = str(tmp_path / "pub")
    trainer, exporter, full_dir, first = _port_chain(pub, False)
    trainer.train_step(*_batches(1, seed=11)[0])
    second = exporter.publish_delta(trainer)
    assert delta.resolve_chain(pub) == (full_dir, [first, second])
    replica = ServingReplica(full_dir, device="cpu")
    features = _batches(1, seed=9)[0][0]
    before = replica.execute(features, BATCH)
    with pytest.raises(ValueError, match="chains from step 3 but generation 1 serves step 1"):
        replica.apply_delta(second)
    assert replica.generation.gen_id == 1
    np.testing.assert_array_equal(replica.execute(features, BATCH), before)
    candidate = replica.build_delta_generation(first)
    assert replica.generation.gen_id == 1  # built, not served
    shadow = replica.shadow_execute(features, candidate)
    np.testing.assert_array_equal(replica.execute(features, BATCH), before)
    replica.commit_generation(candidate, first)
    replica.apply_delta(second)
    assert replica.generation.step == 4
    assert not np.array_equal(shadow, before)
    np.testing.assert_allclose(replica.execute(features, BATCH), trainer.eval_step(features),
                               **LOGIT_TOL)


def test_publish_events_and_metrics_match_jax(tmp_path, monkeypatch):
    """The same full, delta and compaction in both packages journal
    ``checkpoint_saved`` / ``delta_checkpoint`` / ``delta_compaction``
    with the same fields and move the same checkpoint counters."""
    batches = _batches()
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jt = JaxTrainer(zoo.custom_model(vocab_size=VOCAB, embedding_dim=4, hidden=16,
                                     split_tables=True),
                    zoo.loss, zoo.optimizer(), mesh,
                    embedding_optimizer=zoo.embedding_optimizer())
    pt = _port_trainer(True)
    got = {}
    for name, package, module, trainer in (("jax", "elasticdl_tpu", jax_delta, jt),
                                           ("port", "elasticdl_tpu_torch", delta, pt)):
        obs = __import__(package, fromlist=["obs"]).obs
        journal = obs.EventJournal()
        monkeypatch.setattr(obs, "journal", lambda journal=journal: journal)
        before = obs.registry().to_dict().get("elasticdl_checkpoint_saves_total",
                                              {}).get("values", {})
        trainer.train_step(*batches[0])
        exporter = module.DeltaExporter(str(tmp_path / name), **_zoo_args(True))
        exporter.publish_full(trainer, event_time=1.0)
        for batch in batches[1:3]:
            trainer.train_step(*batch)
        exporter.publish_delta(trainer, event_time=2.5)
        trainer.train_step(*batches[3])
        exporter.publish_delta(trainer, event_time=4.0)
        exporter.compact()
        after = obs.registry().to_dict()["elasticdl_checkpoint_saves_total"]["values"]
        # ``rows`` counts the blocks whose bits changed: each trainer's
        # own numbers, so it is only checked to be there.
        got[name] = ([{k: (v > 0 if k == "rows" else v) for k, v in e.items() if k != "ts"}
                      for e in journal.tail(100)
                      if e["event"] in ("checkpoint_saved", "delta_checkpoint",
                                        "delta_compaction")],
                     {k: v - before.get(k, 0.0) for k, v in after.items()
                      if v != before.get(k, 0.0)})
    assert got["port"] == got["jax"]
    events, counts = got["port"]
    assert [e["event"] for e in events] == ["checkpoint_saved", "delta_checkpoint",
                                            "delta_checkpoint", "delta_compaction"]
    assert events[0] == {"event": "checkpoint_saved", "step": 1, "kind": "serving_full",
                         "event_time": 1.0}
    assert (events[1]["base_step"], events[1]["step"], events[1]["tables"]) == (1, 3, 2)
    assert events[1]["rows"] is True and events[2]["event_time"] == 4.0
    assert events[3] == {"event": "delta_compaction", "step": 4, "deltas_folded": 2,
                         "event_time": 4.0}
    assert counts == {"serving_full": 2.0, "delta": 2.0}
