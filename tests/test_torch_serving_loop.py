"""The port's continuous serving loop (``elasticdl_tpu_torch.serving.
continuous.DeltaWatcher`` over ``ServingReplica``) against the JAX
package's, on the CPU.

A JAX ``ShardedEmbeddingTrainer`` (DeepFM, vocab 200 per field,
``embedding_dim`` 4, ``hidden`` 16, batch 32 of the synthetic CTR data)
publishes through JAX's ``DeltaExporter``.  Each package's watcher and
replica walk their own copy of the pub dir (a quarantine renames inside
one copy only), after every publish:

- each ``poll_once`` summary equals key for key (paths by basename);
- the served logits agree within rtol 1e-5 plus 1e-6 of the largest
  logit (the FM term's f32 cancellation: 0.5 * (sum^2 - sum of squares)
  loses the last bits of a logit that sits beside larger ones);
- the ``model_swap`` events agree on (kind, outcome, step, old_step).

Scenarios: a cold start, two deltas; the ``serving.delta_apply``
rollback and its retry; a delta torn by ``ckpt.delta:truncate``,
quarantined, then a compaction that repairs the gap; a chain gap; the
canary gate, ``passed`` and ``held``, on the same replay rows (outcome
equal, logloss and AUC within 1e-6).  Then the shared pieces against the
JAX package's copies (ledger, freshness, batcher hooks, metrics text,
fault grammar, wire codec) and the repairs (``state_to_host`` copies,
``commit_generation(gen, model_dir)``, ``event_time``).
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu import obs as jax_obs
from elasticdl_tpu.checkpoint import delta as jax_delta
from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.obs import freshness as jax_freshness
from elasticdl_tpu.obs import metrics as jax_metrics
from elasticdl_tpu.obs import quality as jax_quality
from elasticdl_tpu.parallel.mesh import MeshConfig, build_mesh
from elasticdl_tpu.parallel.ps_trainer import ShardedEmbeddingTrainer as JaxTrainer
from elasticdl_tpu.serving import batcher as jax_batcher
from elasticdl_tpu.serving import frontend as jax_frontend
from elasticdl_tpu.serving import ledger as jax_ledger
from elasticdl_tpu.serving.continuous import DeltaWatcher as JaxWatcher
from elasticdl_tpu.serving.runtime import ServingReplica as JaxReplica
from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.checkpoint import delta
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
from elasticdl_tpu_torch.obs import freshness, metrics, quality
from elasticdl_tpu_torch.serving import batcher, frontend, ledger
from elasticdl_tpu_torch.serving.continuous import DeltaWatcher
from elasticdl_tpu_torch.serving.runtime import ServingReplica
from model_zoo.deepfm import deepfm_functional_api as zoo

MODEL_DEF = "deepfm.deepfm_functional_api"
VOCAB, BATCH = 200, 32
LOGIT_RTOL = 1e-5


def assert_logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


def _params(split):
    return f"vocab_size={VOCAB},embedding_dim=4,hidden=16,split_tables={split}"


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture
def journals(tmp_path):
    """Both packages' journals pointed at files; (jax path, port path)."""
    paths = (jax_obs.init_journal(str(tmp_path / "jax_journal")),
             obs.init_journal(str(tmp_path / "port_journal")))
    try:
        yield paths
    finally:
        jax_obs.journal().configure(None)
        obs.journal().configure(None)


def _events(path, event):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r for r in map(json.loads, filter(str.strip, f)) if r["event"] == event]


def _batches(n, seed):
    feats, labels = synthetic_ctr_arrays(BATCH * n, vocab_size=VOCAB, seed=seed)
    return [({k: v[i * BATCH:(i + 1) * BATCH] for k, v in feats.items()},
             labels[i * BATCH:(i + 1) * BATCH]) for i in range(n)]


def _jax_trainer(split, lr=0.01):
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    return JaxTrainer(zoo.custom_model(vocab_size=VOCAB, embedding_dim=4, hidden=16,
                                       split_tables=split),
                      zoo.loss, zoo.optimizer(lr=lr), mesh,
                      embedding_optimizer=zoo.embedding_optimizer(lr=lr))


class Loop:
    """A JAX publisher and the two packages' consumers, each on its own
    mirror of the pub dir."""

    def __init__(self, tmp_path, split=False, jax_gate=None, port_gate=None):
        self.trainer = _jax_trainer(split)
        self.batches = _batches(16, seed=3)[:8]
        self.held_out = _batches(1, seed=9)[0][0]
        self.src = str(tmp_path / "pub")
        self.mirrors = {"jax": str(tmp_path / "pub_jax"), "port": str(tmp_path / "pub_port")}
        self._synced = set()
        self.exporter = jax_delta.DeltaExporter(self.src, model_zoo="model_zoo",
                                                model_def=MODEL_DEF, model_params=_params(split))
        self.cursor = 0
        self.train(1)
        full = self.exporter.publish_full(self.trainer, event_time=1.0)
        self.sync()
        name = os.path.basename(full)
        self.jax = JaxReplica(os.path.join(self.mirrors["jax"], name), model_zoo="model_zoo")
        self.port = ServingReplica(os.path.join(self.mirrors["port"], name), device="cpu")
        self.watchers = {
            "jax": JaxWatcher(self.jax, self.mirrors["jax"], gate=jax_gate, origin="replica_0"),
            "port": DeltaWatcher(self.port, self.mirrors["port"], gate=port_gate,
                                 origin="replica_0"),
        }
        self.assert_same_outputs()

    def train(self, steps, flip=False):
        for _ in range(steps):
            feats, labels = self.batches[self.cursor % len(self.batches)]
            self.trainer.train_step(feats, 1 - labels if flip else labels)
            self.cursor += 1

    def sync(self):
        """Mirror new publishes (and the exporter's deletions) into both
        copies; a consumer's quarantine renames stay in its copy."""
        names = {n for n in os.listdir(self.src) if ".tmp" not in n}
        for mirror in self.mirrors.values():
            os.makedirs(mirror, exist_ok=True)
            for name in names - self._synced:
                shutil.copytree(os.path.join(self.src, name), os.path.join(mirror, name))
            for name in self._synced - names:
                shutil.rmtree(os.path.join(mirror, name), ignore_errors=True)
        self._synced = names

    def _normal(self, summary, which):
        out = dict(summary)
        for key in ("failed", "held"):
            if out[key] is not None:
                out[key] = os.path.basename(out[key])
        if out["reason"] is not None:
            out["reason"] = out["reason"].replace(self.mirrors[which] + "/", "")
        return out

    def poll(self):
        self.sync()
        got = {which: self._normal(w.poll_once(), which) for which, w in self.watchers.items()}
        assert got["port"] == got["jax"]
        self.assert_same_outputs()
        return got["port"]

    def assert_same_outputs(self):
        assert self.port.generation.step == self.jax.generation.step
        assert_logits_close(self.port.execute(self.held_out, BATCH),
                            self.jax.execute(self.held_out, n_valid=BATCH))


def _swaps(path):
    return [(e["kind"], e["outcome"], e["step"], e["old_step"])
            for e in _events(path, "model_swap")]


def _assert_same_swaps(journals):
    jax_path, port_path = journals
    assert _swaps(port_path) == _swaps(jax_path)
    return _swaps(port_path)


@pytest.mark.parametrize("split", [False, True])
def test_cold_start_then_two_deltas(tmp_path, journals, split):
    loop = Loop(tmp_path, split)
    assert loop.poll()["outcome"] == "noop"
    # A newer full than the one the replicas started from: one reload.
    loop.train(2)
    loop.exporter.publish_full(loop.trainer, event_time=3.0)
    summary = loop.poll()
    assert summary["reloaded_full"] and summary["outcome"] == "applied"
    assert summary["step"] == 3
    for step, event_time in ((5, 5.0), (7, 7.0)):
        loop.train(2)
        loop.exporter.publish_delta(loop.trainer, event_time=event_time)
        summary = loop.poll()
        assert (summary["applied_deltas"], summary["step"]) == (1, step)
        assert loop.port.generation.event_time == loop.jax.generation.event_time == event_time
    assert _assert_same_swaps(journals) == [
        ("full", "applied", 3, 1), ("delta", "applied", 5, 3), ("delta", "applied", 7, 5)]


def test_delta_apply_fault_rolls_back_then_retries(tmp_path, journals):
    loop = Loop(tmp_path)
    loop.train(2)
    loop.exporter.publish_delta(loop.trainer, event_time=2.0)
    old = {"jax": loop.jax.generation, "port": loop.port.generation}
    before = loop.port.execute(loop.held_out, BATCH)
    faults.install("serving.delta_apply:error=injected@1")
    jax_faults.install("serving.delta_apply:error=injected@1")
    summary = loop.poll()
    assert summary["outcome"] == "rolled_back" and summary["failed"].startswith("delta_")
    assert "injected" in summary["reason"]
    # Rolled back: the same generation object, the same bits.
    assert loop.port.generation is old["port"] and loop.jax.generation is old["jax"]
    np.testing.assert_array_equal(loop.port.execute(loop.held_out, BATCH), before)
    summary = loop.poll()  # the fault is spent: the retry lands
    assert summary["outcome"] == "applied" and summary["step"] == 3
    assert _assert_same_swaps(journals) == [("delta", "rolled_back", 1, 1),
                                            ("delta", "applied", 3, 1)]
    port_swaps = _events(journals[1], "model_swap")
    assert port_swaps[0]["generation"] == old["port"].gen_id  # the pointer never moved
    assert all(not obs.missing_fields(e) for e in port_swaps)


def test_torn_delta_is_quarantined_and_compaction_repairs(tmp_path, journals):
    loop = Loop(tmp_path)
    jax_faults.install("ckpt.delta:truncate@1")
    loop.train(2)
    torn = loop.exporter.publish_delta(loop.trainer, event_time=2.0)
    summary = loop.poll()  # both resolves quarantine the torn link
    assert summary["outcome"] == "noop" and summary["step"] == 1
    for mirror in loop.mirrors.values():
        assert os.path.isdir(os.path.join(mirror, os.path.basename(torn)) + ".quarantined")
    loop.train(2)
    loop.exporter.publish_delta(loop.trainer, event_time=3.0)  # chains from the torn link
    assert loop.poll()["outcome"] == "noop"
    loop.exporter.compact()
    summary = loop.poll()
    assert summary["reloaded_full"] and summary["step"] == 5
    assert_logits_close(loop.port.execute(loop.held_out, BATCH),
                        loop.trainer.eval_step(loop.held_out))
    assert _assert_same_swaps(journals) == [("full", "applied", 5, 1)]


def test_port_publisher_tears_a_delta_for_both_readers(tmp_path):
    """The port's own ``ckpt.delta`` site: its torn delta fails both
    packages' integrity checks, and both quarantine it."""
    trainer = _port_ps_trainer()
    batches = _batches(2, seed=3)
    trainer.train_step(*batches[0])
    exporter = delta.DeltaExporter(str(tmp_path / "pub"), model_zoo="model_zoo",
                                   model_def=MODEL_DEF, model_params=_params(True))
    full = exporter.publish_full(trainer)
    trainer.train_step(*batches[1])
    faults.install("ckpt.delta:truncate@1")
    torn = exporter.publish_delta(trainer)
    assert faults.call_count("ckpt.delta") == 1
    copy = str(tmp_path / "pub_copy")
    shutil.copytree(str(tmp_path / "pub"), copy)
    assert jax_delta.resolve_chain(copy)[1] == []
    assert os.path.isdir(os.path.join(copy, os.path.basename(torn)) + ".quarantined")
    assert delta.resolve_chain(str(tmp_path / "pub")) == (full, [])
    assert os.path.isdir(torn + ".quarantined")


def test_chain_gap_waits_for_compaction(tmp_path, journals):
    from elasticdl_tpu.serving.export import export_model

    loop = Loop(tmp_path)
    loop.train(2)
    loop.exporter.publish_delta(loop.trainer, event_time=2.0)
    loop.train(2)
    second = loop.exporter.publish_delta(loop.trainer, event_time=3.0)
    loop.sync()
    # A link applied out of order is a gap: refused, journaled, the old
    # generation serving.
    name = os.path.basename(second)
    with pytest.raises(ValueError, match="chains from step"):
        loop.jax.apply_delta(os.path.join(loop.mirrors["jax"], name))
    with pytest.raises(ValueError, match="chains from step 3 but generation 1 serves step 1"):
        loop.port.apply_delta(os.path.join(loop.mirrors["port"], name))
    loop.assert_same_outputs()
    assert loop.poll()["step"] == 5
    # Replicas moved off the chain (a full reload of another export at
    # step 6) wait at the gap until a compaction gives them a full.
    loop.train(1)
    off_chain = export_model(loop.trainer, str(tmp_path / "off_chain"), model_zoo="model_zoo",
                             model_def=MODEL_DEF, model_params=_params(False))
    loop.jax.reload(off_chain)
    loop.port.reload(off_chain)
    loop.train(1)
    loop.exporter.publish_delta(loop.trainer, event_time=4.0)
    assert loop.poll()["outcome"] == "noop"
    loop.exporter.compact()
    summary = loop.poll()
    assert summary["reloaded_full"] and summary["step"] == 7
    assert _assert_same_swaps(journals) == [
        ("delta", "rolled_back", 1, 1), ("delta", "applied", 3, 1), ("delta", "applied", 5, 3),
        ("full", "applied", 6, 5), ("full", "applied", 7, 6)]


def _replay_rows():
    """Labeled rows the trainer never sees, from the draw (and so the
    label rule) of its batches: 256 rows both packages' gates score."""
    return _batches(16, seed=3)[8:]


def test_canary_gate_passes_healthy_and_holds_poisoned(tmp_path, journals):
    gates = {}
    for which, module in (("jax", jax_quality), ("port", quality)):
        replay = module.ReplayBuffer()
        for feats, labels in _replay_rows():
            replay.add(feats, labels)
        gates[which] = module.CanaryGate(replay, min_rows=64)
    assert gates["port"]._replay.rows() == 256
    loop = Loop(tmp_path, jax_gate=gates["jax"], port_gate=gates["port"])
    loop.train(23)
    loop.exporter.publish_delta(loop.trainer, event_time=2.0)
    summary = loop.poll()
    assert summary["outcome"] == "applied" and summary["step"] == 24
    loop.train(8, flip=True)  # a label-flipped feed poisons the next delta
    poisoned = loop.exporter.publish_delta(loop.trainer, event_time=3.0)
    step_before = loop.port.generation.step
    summary = loop.poll()
    assert summary["outcome"] == "held", summary
    assert summary["held"] == os.path.basename(poisoned)
    assert loop.port.generation.step == step_before  # the pointer did not move
    verdicts = {which: _events(path, "quality_gate")
                for which, path in zip(("jax", "port"), journals)}
    assert [v["outcome"] for v in verdicts["port"]] == [v["outcome"] for v in verdicts["jax"]] \
        == ["passed", "held"]
    for got, want in zip(verdicts["port"], verdicts["jax"]):
        assert (got["step"], got["origin"], got["rows"]) == (want["step"], want["origin"],
                                                              want["rows"])
        for key in ("baseline_logloss", "candidate_logloss", "baseline_auc", "candidate_auc"):
            assert abs(got[key] - want[key]) <= 1e-6, key
        assert not obs.missing_fields(got)
    assert _assert_same_swaps(journals) == [("delta", "applied", 24, 1)]


# ----------------------------------------------------------------------
# The shared pieces against the JAX package's copies
# ----------------------------------------------------------------------


class FakeClock:
    def __init__(self, step=0.25):
        self.now, self.step = 100.0, step

    def __call__(self):
        self.now += self.step
        return self.now


def test_availability_ledger_snapshot_matches_jax():
    books = {"jax": jax_ledger.AvailabilityLedger(clock=FakeClock(),
                                                  registry=jax_metrics.MetricsRegistry()),
             "port": ledger.AvailabilityLedger(clock=FakeClock(),
                                               registry=metrics.MetricsRegistry())}
    rng = np.random.default_rng(4)
    script = []
    for i in range(300):
        phases = {p: float(rng.uniform(0, 0.01)) for p in ledger.REQUEST_PHASES}
        outcome = ("served", "served", "served", "dropped", "error", "weird")[i % 6]
        script.append((phases, outcome, int(rng.integers(1, 9))))
    for book in books.values():
        for phases, outcome, rows in script:
            book.record_request(phases, outcome, rows)
        book.record_shed(5)
    assert ledger.REQUEST_PHASES == jax_ledger.REQUEST_PHASES
    assert books["port"].snapshot() == books["jax"].snapshot()
    assert books["port"].counts()["shed"] == 1


def test_freshness_components_and_events_match_jax(journals):
    trackers = {"jax": jax_freshness.FreshnessTracker(slo_s=5.0),
                "port": freshness.FreshnessTracker(slo_s=5.0)}
    script = [("watermark", 9.0), ("published", 8.0), ("served", 8.0), ("eval", 10.0),
              ("watermark", 19.0), ("published", 18.0), ("eval", 20.0), ("eval", 21.0),
              ("served", 18.0), ("eval", 22.0), ("eval", 23.0)]
    seen = {}
    for which, tracker in trackers.items():
        out = []
        for what, t in script:
            if what == "watermark":
                tracker.note_watermark(t)
            elif what == "published":
                tracker.note_published(int(t) * 10, t)
            elif what == "served":
                tracker.note_served(int(t), int(t) * 10, t)
            else:
                out.append((tracker.components(t), tracker.lag_s(t), tracker.attribute(t),
                            tracker.evaluate(t)))
        seen[which] = out
    assert seen["port"] == seen["jax"]
    states = [e["state"] for e in _events(journals[1], "freshness_slo")]
    assert states == [e["state"] for e in _events(journals[0], "freshness_slo")] \
        == ["breach", "clear"]


def _batcher_script(module, faults_module, journal_path):
    """One scripted sequence through a batcher driven by hand (no
    thread): a size trigger, a full queue, an expired deadline and an
    execute error.  Returns what the hooks saw and the shed events."""
    calls = []
    clock = FakeClock(0.001)

    def execute(features, n_valid):
        return features["x"][:, 0] * 2.0

    b = module.MicroBatcher(
        execute, module.BatcherConfig(max_batch_size=4, max_wait_us=1000, queue_limit=3),
        on_request=lambda phases, outcome, rows: calls.append(
            ("request", outcome, rows, sorted(phases.items()))),
        on_shed=lambda rows: calls.append(("shed", rows)),
        on_batch=lambda stacked: calls.append(("batch", stacked["x"].tolist())),
        clock=clock)
    x = lambda v, n: {"x": np.full((n, 1), v, np.float32)}  # noqa: E731
    first, second = b.submit(x(1, 2)), b.submit(x(2, 2))
    b._dispatch(b._take_batch())  # the size trigger: 4 rows
    results = [first.wait(0).tolist(), second.wait(0).tolist()]
    reqs = [b.submit(x(3, 1)), b.submit(x(4, 1), deadline_s=0.0005), b.submit(x(5, 1))]
    with pytest.raises(module.QueueFullError):
        b.submit(x(6, 1))
    faults_module.install("serving.execute:error=boom@1")
    with pytest.raises(RuntimeError, match="FAULT INJECTION"):
        b._dispatch(b._take_batch())
    errors = [str(r.error) for r in reqs]
    sheds = [{k: v for k, v in e.items() if k != "ts"} for e in _events(journal_path,
                                                                         "request_shed")]
    return calls, results, errors, sheds


def test_batcher_hooks_and_sheds_match_jax(journals):
    jax_side = _batcher_script(jax_batcher, jax_faults, journals[0])
    port_side = _batcher_script(batcher, faults, journals[1])
    assert port_side == jax_side
    calls, results, errors, sheds = port_side
    assert results == [[2.0, 2.0], [4.0, 4.0]]
    assert [c[1] for c in calls if c[0] == "request"] == [
        "served", "served", "dropped", "error", "error"]
    assert [s["reason"] for s in sheds] == ["queue_full", "deadline"]
    assert "deadline" in errors[1] and "boom" in errors[0]


def _registry_ops(module):
    reg = module.MetricsRegistry()
    c = reg.counter("elasticdl_serving_requests_total", "Finished requests\nby outcome",
                    labelnames=("outcome",))
    c.inc(outcome="served")
    c.inc(2.5, outcome='we"ird\\')
    reg.counter("elasticdl_plain_total", "unlabeled")
    g = reg.gauge("elasticdl_serving_queue_depth", "depth")
    g.set(3)
    g.set_function(lambda: 7.0)
    reg.gauge("elasticdl_x", "x", labelnames=("a", "b")).set(float("inf"), a="1", b="z")
    h = reg.histogram("elasticdl_serving_batch_rows", "rows", buckets=(1, 2, 4, 8))
    for v in (0.5, 1, 3, 9, 2):
        h.observe(v)
    reg.histogram("elasticdl_span_x_seconds", "s", labelnames=("kind",)).observe(0.003,
                                                                                 kind="delta")
    return reg.render_prometheus()


def test_metrics_exposition_matches_jax_byte_for_byte():
    port_text = _registry_ops(metrics)
    assert port_text == _registry_ops(jax_metrics)
    assert "# TYPE elasticdl_serving_batch_rows histogram" in port_text


FAULT_EXAMPLES = (
    "rpc.get_task:error=UNAVAILABLE@1x3",
    "rpc.get_task:latency=0.25@2",
    "ckpt.write:truncate@2",
    "worker.task:crash@3",
    "storm.preempt:crash@t2.5",
    "serving.delta_apply:error=injected@2, ckpt.delta:truncate=10;serving.execute:latency@4x*",
)


@pytest.mark.parametrize("text", FAULT_EXAMPLES)
def test_fault_grammar_matches_jax(text):
    def fields(specs):
        return [(s.site, s.kind, s.arg, s.after, s.count, s.at_s) for s in specs]

    assert fields(faults.parse_specs(text)) == fields(jax_faults.parse_specs(text))
    faults.install(text)
    jax_faults.install(text)
    site = text.split(":")[0]
    fired = [(faults.fire(site) is None, jax_faults.fire(site) is None) for _ in range(6)]
    assert all(a == b for a, b in fired)
    assert faults.call_count(site) == jax_faults.call_count(site) == 6


@pytest.mark.parametrize("text", ["nocolon", "a:explode", "a:error@0", "a:crash@t1x2",
                                  "a:error@t-1"])
def test_fault_grammar_refuses_what_jax_refuses(text):
    with pytest.raises(ValueError):
        jax_faults.parse_specs(text)
    with pytest.raises(ValueError):
        faults.parse_specs(text)


def test_wire_codec_both_ways():
    rng = np.random.default_rng(8)
    feats = {"dense": rng.standard_normal((5, 13)).astype(np.float32),
             "cat": rng.integers(0, 100, (5, 26)).astype(np.int32)}
    out = rng.standard_normal(5).astype(np.float32)
    for enc, dec in ((frontend.encode_features, jax_frontend.decode_features),
                     (jax_frontend.encode_features, frontend.decode_features)):
        got = dec(enc(feats))
        assert set(got) == set(feats)
        for k, v in feats.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
    for enc, dec in ((frontend.encode_array, jax_frontend.decode_array),
                     (jax_frontend.encode_array, frontend.decode_array)):
        got = dec(enc(out))
        assert got.dtype == out.dtype and np.array_equal(got, out)


# ----------------------------------------------------------------------
# The repairs
# ----------------------------------------------------------------------


def _port_ps_trainer():
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.zoo import build_model
    from elasticdl_tpu_torch.zoo import deepfm as port_zoo

    return ShardedEmbeddingTrainer(
        build_model(MODEL_DEF, _params(True), device="cpu"), port_zoo.loss,
        port_zoo.optimizer(lr=0.01), embedding_optimizer=port_zoo.embedding_optimizer(lr=0.01),
        seed=1, device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


def _assert_snapshot_kept(host, step):
    leaves = {k: np.asarray(v) for k, v in _flat(host._asdict()).items() if np.ndim(v)}
    copies = {k: v.copy() for k, v in leaves.items()}
    step()
    changed = [k for k, v in copies.items() if not np.array_equal(leaves[k], v)]
    assert not changed, changed


def test_ps_state_to_host_is_a_copy():
    trainer = _port_ps_trainer()
    batches = _batches(2, seed=5)
    trainer.train_step(*batches[0])
    _assert_snapshot_kept(trainer.state_to_host(), lambda: trainer.train_step(*batches[1]))


def test_dp_state_to_host_is_a_copy():
    from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.zoo import build_model, transformer_lm

    model = build_model("transformer.transformer_lm",
                        "vocab=32,d_model=16,num_heads=2,num_layers=1,max_len=8", device="cpu")
    trainer = DataParallelTrainer(model, transformer_lm.loss, transformer_lm.optimizer(1e-2),
                                  seed=0, device="cpu")
    tokens, nxt = synthetic_lm_arrays(4, 8, 32, 0)
    trainer.train_step(tokens[:2], nxt[:2])
    _assert_snapshot_kept(trainer.state_to_host(), lambda: trainer.train_step(tokens[2:],
                                                                              nxt[2:]))


def test_gather_to_host_is_a_copy():
    from elasticdl_tpu_torch.parallel.sharding import gather_to_host

    live = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    host = gather_to_host(live, None, None)
    live.add_(1.0)
    assert np.array_equal(host, np.arange(12, dtype=np.float32).reshape(4, 3))


def test_generation_event_time_and_commit_signature_match_jax(tmp_path, journals):
    jt = _jax_trainer(False)
    batches = _batches(3, seed=5)
    jt.train_step(*batches[0])
    pub = str(tmp_path / "pub")
    exporter = jax_delta.DeltaExporter(pub, model_zoo="model_zoo", model_def=MODEL_DEF,
                                       model_params=_params(False))
    full = exporter.publish_full(jt, event_time=11.5)
    jt.train_step(*batches[1])
    link = exporter.publish_delta(jt, event_time=12.25)
    jax_replica = JaxReplica(full, model_zoo="model_zoo")
    replica = ServingReplica(full, device="cpu")
    assert replica.generation.event_time == jax_replica.generation.event_time == 11.5
    assert replica.stats()["model_event_time"] == jax_replica.stats()["model_event_time"]
    jax_replica.commit_generation(jax_replica.build_delta_generation(link), link)
    gen = replica.commit_generation(replica.build_delta_generation(link), link)
    assert replica.generation is gen
    assert gen.event_time == jax_replica.generation.event_time == 12.25
    assert replica.stats()["model_event_time"] == jax_replica.stats()["model_event_time"]
    swaps = {which: _events(path, "model_swap")[-1] for which, path in zip(("jax", "port"),
                                                                            journals)}
    for key in ("kind", "outcome", "step", "old_step", "model_dir", "event_time"):
        assert swaps["port"][key] == swaps["jax"][key], key
