"""The port's model-quality plane (``elasticdl_tpu_torch/obs/quality.py``,
the ``labels`` request, the label feed) against the JAX package's
(``elasticdl_tpu/obs/quality.py``), on the same numpy inputs from seeds.

- The metric math (``binary_auc``, ``binary_logloss``,
  ``calibration_table``/``calibration_error``, ``prediction_entropy``)
  and ``FeatureSketch.divergence`` are the same numpy arithmetic: equal
  bit for bit (``==``).
- ``QualityLedger`` on one scripted fake-clock timeline through both
  packages (predictions with and without features, labels two virtual
  seconds late, labels past the join window, orphans, a bounded pending
  ring, a ``quality.label_join`` drop and a duplicate): every
  ``snapshot()``, every ``quality_window`` event (without its wall
  ``ts``), the replay buffer and the ``elasticdl_quality_*`` gauges are
  equal.  ``DriftMonitor``: the same divergences, gauge and breach/clear
  edges.
- JAX's ``test_poisoned_delta_canary_gate_e2e`` scenario at vocab 100
  (``tests/test_quality.py``) with a clean link first: a JAX trainer
  publishes through JAX's ``DeltaExporter``; each package's two replicas
  read their own mirror of the pub dir (the port's through its artifact
  loader, ``serving/convert.py``) and label-join their own served
  predictions with their own ``stream.labels`` feed.  The gate outcomes
  (passed, held on every retry, passed after the recovery) and the poll
  summaries are equal, the live logits agree within the split layout's
  tolerance (rtol 1e-5 plus 1e-6 of the largest logit), the windows join
  the same counts, and ``obs.report``/``obs.top`` read the port's
  ``quality_window``, ``quality_drift`` and ``quality_gate`` events as
  JAX's read JAX's.
- The ``labels`` request over the port's HTTP frontend on an in-process
  replica: ``received``/``joined`` counts, unknown ids absorbed, 400 on a
  payload that is not an npz, ``enabled: false`` without the plane.
- The label feed (``bench/loadgen.py``) against JAX's
  ``scripts/loadgen.py`` on the same requests and feed faults.
"""

import importlib.util
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest

from elasticdl_tpu import obs as jax_obs
from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.data import stream as jax_stream
from elasticdl_tpu.obs import quality as jax_quality
from elasticdl_tpu.obs import report as jax_report
from elasticdl_tpu.obs import top as jax_top
from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.data import stream
from elasticdl_tpu_torch.obs import quality, report, top

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_quality, jax_obs, jax_faults, jax_stream),
            "port": (quality, obs, faults, stream)}
LOGIT_RTOL = 1e-5
QUALITY_GAUGES = ("elasticdl_quality_auc", "elasticdl_quality_logloss",
                  "elasticdl_quality_calibration_error", "elasticdl_quality_prediction_mean",
                  "elasticdl_quality_joined_total", "elasticdl_quality_pending_joins",
                  "elasticdl_quality_drift")


def assert_logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture
def journals(tmp_path):
    """Each package's journal at its own file: {which: path}."""
    paths = {which: pkg[1].init_journal(str(tmp_path / f"{which}_journal"))
             for which, pkg in PACKAGES.items()}
    try:
        yield paths
    finally:
        for pkg in PACKAGES.values():
            pkg[1].journal().configure(None)


def _events(path, *names):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r for r in map(json.loads, filter(str.strip, f))
                if not names or r["event"] in names]


def _no_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def _gauges(obs_module, origin):
    dump = obs_module.registry().to_dict()
    return {name: dump[name]["values"].get(origin) for name in QUALITY_GAUGES if name in dump}


# ----------------------------------------------------------------------
# The math, bit for bit
# ----------------------------------------------------------------------


def _math_inputs(seed):
    rng = np.random.default_rng(seed)
    n = 257 + seed * 50
    labels = (rng.random(n) < 0.3).astype(np.float32)
    preds = rng.random(n)
    preds[: n // 4] = np.round(preds[: n // 4], 1)  # ties
    if seed == 3:
        preds = preds * 3.0 - 1.0  # outside [0, 1]: clipped as served logits are
    return labels, preds


@pytest.mark.parametrize("seed", range(4))
def test_metric_math_bit_equal(seed):
    labels, preds = _math_inputs(seed)
    got = {}
    for which, (module, *_rest) in PACKAGES.items():
        table = module.calibration_table(labels, preds, bins=10)
        got[which] = (module.binary_auc(labels, preds), module.binary_logloss(labels, preds),
                      table, module.calibration_error(table),
                      module.prediction_entropy(preds), module.binary_auc(np.ones(4), preds[:4]),
                      module.calibration_error([]))
    assert got["port"] == got["jax"]
    assert got["port"][0] is not None and got["port"][5] is None


@pytest.mark.parametrize("seed", range(3))
def test_feature_sketch_divergence_bit_equal(seed):
    rng = np.random.default_rng(seed)
    got = {}
    for which, (module, *_rest) in PACKAGES.items():
        a, b = module.FeatureSketch(64), module.FeatureSketch(64)
        a.update_ids({"cat": rng.integers(0, 1000, (128, 26)), "dense": rng.random((128, 13))})
        b.update_ids({"cat": rng.integers(0, 40, (96, 26))})
        ids_only = a.divergence(b)
        a.update_norms(rng.random((32, 8)) * 10 ** seed)
        b.update_norms(rng.random(40))
        got[which] = (ids_only, a.divergence(b), a.total_ids, b.id_frequency().tolist(),
                      a.norm_frequency().tolist())
        rng = np.random.default_rng(seed)  # the same draws for the other package
    assert got["port"] == got["jax"]
    assert 0.0 < got["port"][0] <= got["port"][1] <= 1.0


# ----------------------------------------------------------------------
# The ledger and the drift monitor on one scripted timeline
# ----------------------------------------------------------------------


def _ledger_timeline(which):
    module, obs_module, fault_module, _ = PACKAGES[which]
    replay = module.ReplayBuffer(max_batches=4)
    ledger = module.QualityLedger(window_size=24, join_window_s=3.0, max_pending=6,
                                  calibration_bins=5, origin="timeline", replay=replay)
    rng = np.random.default_rng(11)
    out = [ledger.journal_window(0.0)]  # silent before the first prediction
    for tick in range(24):
        now = 0.5 * tick
        feats = {"cat": rng.integers(0, 50, (3, 4)).astype(np.int32),
                 "dense": rng.random((3, 2)).astype(np.float32)}
        preds = rng.uniform(0.02, 0.98, 3)
        ledger.note_prediction(f"t{tick}", preds, now, features=feats if tick % 3 else None)
        labels = (rng.random(3) < 0.4).astype(np.float32)
        if tick >= 4:
            out.append(ledger.note_label(f"t{tick - 4}", labels, now))  # 2 s late
        if tick % 5 == 0:
            out.append(ledger.note_label("never-sampled", labels[:1], now))  # an orphan
        if tick == 9:
            fault_module.install("quality.label_join:error@1")  # the next label drops
        if tick == 14:
            fault_module.clear()
            fault_module.install("quality.label_join:truncate@1")  # delivered twice
        if tick == 18:
            fault_module.clear()
            out.append(ledger.note_label("t10", labels, now))  # 4 s late: expired
        out.append(ledger.snapshot())
        out.append(ledger.journal_window(now))
    out.append(ledger.pairs()[0].tolist() + ledger.pairs()[1].tolist())
    out.append([({k: v.tolist() for k, v in f.items()}, y.tolist()) for f, y in replay.batches()])
    out.append(_gauges(obs_module, "timeline"))
    return out


def test_ledger_timeline_matches_jax(journals):
    got = {which: _ledger_timeline(which) for which in PACKAGES}
    assert got["port"] == got["jax"]
    events = {which: _no_ts(_events(path, "quality_window")) for which, path in journals.items()}
    assert events["port"] == events["jax"]
    assert len(events["port"]) == 24 and not obs.missing_fields(events["port"][0] | {
        "event": "quality_window"})
    final = [s for s in got["port"] if isinstance(s, dict) and "orphans" in s][-1]
    assert final["dropped_injected"] == 1 and final["duplicates_injected"] == 1
    assert final["expired"] > 0 and final["orphans"] >= 5 and final["joined"] > 0


def _drift_timeline(which):
    module, obs_module, _, _ = PACKAGES[which]
    monitor = module.DriftMonitor(threshold=0.3, bins=32, origin="drift")
    rng = np.random.default_rng(5)
    out = [monitor.evaluate(0.0)]  # incomparable: no event
    same = {"cat": np.arange(512, dtype=np.int64).reshape(64, 8)}
    monitor.observe_train(same)
    monitor.observe_serve(same)
    out.append(monitor.evaluate(1.0))
    for tick in range(2, 12):
        if tick in (3, 4):  # the serve mix collapses onto a few hot keys
            monitor.observe_serve({"cat": rng.integers(0, 3, (4096, 8))})
        if tick == 7:  # the train side follows
            monitor.observe_train({"cat": rng.integers(0, 3, (8192, 8))})
        if tick == 9:
            monitor.observe_train_norms(rng.random((16, 4)))
            monitor.observe_serve_norms(rng.random((16, 4)) * 1e4)
        out.append(monitor.evaluate(float(tick)))
    out.append(_gauges(obs_module, "drift")["elasticdl_quality_drift"])
    return out


def test_drift_edges_match_jax(journals):
    got = {which: _drift_timeline(which) for which in PACKAGES}
    assert got["port"] == got["jax"]
    edges = {which: _no_ts(_events(path, "quality_drift")) for which, path in journals.items()}
    assert edges["port"] == edges["jax"]
    assert [e["state"] for e in edges["port"]] == ["breach", "clear", "breach"]


def test_selftest_cli():
    assert quality.main(["--selftest"]) == 0


# ----------------------------------------------------------------------
# The canary gate fed by served traffic, both packages
# ----------------------------------------------------------------------


class Fleet:
    """One package's two replicas, each with a QualityLedger (join window
    8 virtual seconds), a CanaryGate (``gate_kwargs`` over JAX's e2e
    thresholds) and a DeltaWatcher over the package's own mirror of the
    pub dir, plus one DriftMonitor."""

    def __init__(self, which, full_dir, mirror, gate_kwargs):
        module, _, _, stream_module = PACKAGES[which]
        if which == "jax":
            from elasticdl_tpu.serving.continuous import DeltaWatcher
            from elasticdl_tpu.serving.runtime import ServingReplica

            self.replicas = [ServingReplica(full_dir, model_zoo="model_zoo") for _ in range(2)]
        else:
            from elasticdl_tpu_torch.serving.continuous import DeltaWatcher
            from elasticdl_tpu_torch.serving.runtime import ServingReplica

            self.replicas = [ServingReplica(full_dir, device="cpu") for _ in range(2)]
        self.which, self.feed = which, stream_module.feedback_labels
        self.ledgers, self.watchers = [], []
        for rid, replica in enumerate(self.replicas):
            replay = module.ReplayBuffer(max_batches=16)
            self.ledgers.append(module.QualityLedger(window_size=256, join_window_s=8.0,
                                                     origin=f"replica_{rid}", replay=replay))
            gate = module.CanaryGate(replay, **{"max_logloss_regress": 0.10,
                                                "max_auc_drop": 0.05, "min_rows": 64,
                                                **gate_kwargs})
            self.watchers.append(DeltaWatcher(replica, mirror, gate=gate,
                                              origin=f"replica_{rid}"))
        self.drift = module.DriftMonitor(threshold=0.2, bins=64, origin="replica_0")

    def execute(self, rid, feats):
        replica = self.replicas[rid]
        if self.which == "jax":
            return np.asarray(replica.execute(feats, n_valid=16)).ravel()
        return np.asarray(replica.execute(feats, 16)).ravel()


class Scenario:
    """JAX's e2e setting at vocab 100: a JAX trainer publishing through
    JAX's DeltaExporter, each package's Fleet on its own mirror of the pub
    dir, 16-row requests whose labels join two ticks late through each
    package's own feed (and fault registry)."""

    def __init__(self, tmp_path, clean_steps, gate_kwargs=None):
        from elasticdl_tpu.checkpoint.delta import DeltaExporter
        from test_serving import _trained_deepfm

        _zoo, self.trainer, self.batches = _trained_deepfm(steps=0)
        self.ref = np.asarray(self.batches[0][1])
        self.src = str(tmp_path / "pub")
        self.mirrors = {which: str(tmp_path / f"pub_{which}") for which in PACKAGES}
        self.synced, self.fleets, self.pending, self.served = set(), {}, {}, 0
        self.exporter = DeltaExporter(self.src, model_zoo="model_zoo",
                                      model_def="deepfm.deepfm_functional_api",
                                      model_params="vocab_size=100")
        self.train_steps(clean_steps, start=0)
        full = os.path.basename(self.exporter.publish_full(self.trainer))
        self.sync()
        self.fleets = {which: Fleet(which, os.path.join(self.mirrors[which], full),
                                    self.mirrors[which], gate_kwargs or {})
                       for which in PACKAGES}

    def sync(self):
        names = {n for n in os.listdir(self.src) if ".tmp" not in n}
        for mirror in self.mirrors.values():
            os.makedirs(mirror, exist_ok=True)
            for name in names - self.synced:
                shutil.copytree(os.path.join(self.src, name), os.path.join(mirror, name))
            for name in self.synced - names:
                shutil.rmtree(os.path.join(mirror, name), ignore_errors=True)
        self.synced = names

    def train_steps(self, count, start):
        """``count`` JAX train steps, each finished before the next is
        dispatched.  The trainer's step is one program over 8 virtual CPU
        devices with all-reduces, and XLA aborts the process when an
        all-reduce's participants do not all arrive within 40 s: with a
        long run of steps dispatched ahead on a loaded host, the devices'
        tasks of different steps starved each other on XLA's thread pool
        ("Termination timeout for `all reduce` ... Expected 8 threads to
        join the rendezvous, but only 6 of them arrived", SIGABRT, in 2 of
        19 runs of this file beside other CPU work)."""
        for k in range(count):
            feats, _ = self.batches[(start + k) % len(self.batches)]
            labels = jax_stream.feedback_labels(feats)
            jax.block_until_ready(self.trainer.train_step(
                feats, labels.astype(self.ref.dtype).reshape(self.ref.shape)))
            for fleet in self.fleets.values():
                fleet.drift.observe_train(feats)

    def serve_tick(self, tick, attach):
        feats = self.batches[(tick * 7) % len(self.batches)][0]
        now = float(tick)
        self.pending[tick] = feats
        late = self.pending.pop(tick - 2, None)
        for fleet in self.fleets.values():
            for rid, ledger in enumerate(fleet.ledgers):
                preds = fleet.execute(rid, feats)
                ledger.note_prediction(f"t{tick}-r{rid}", preds, now,
                                       features=feats if attach else None)
            if late is not None:
                labels = fleet.feed(late)  # each package's own feed and fault registry
                for rid, ledger in enumerate(fleet.ledgers):
                    ledger.note_label(f"t{tick - 2}-r{rid}", labels, now)
            for ledger in fleet.ledgers:
                ledger.journal_window(now)
            fleet.drift.observe_serve(feats)
            fleet.drift.evaluate(now)
        self.served += 2
        assert_logits_close(self.fleets["port"].execute(0, feats),
                            self.fleets["jax"].execute(0, feats))

    def poll(self, outcome=None):
        """Every watcher polls once; the two packages' summaries must be
        equal (paths by basename) and the replicas at the same step."""
        self.sync()
        got = {}
        for which, fleet in self.fleets.items():
            got[which] = []
            for watcher in fleet.watchers:
                summary = dict(watcher.poll_once())
                for key in ("failed", "held"):
                    if summary[key] is not None:
                        summary[key] = os.path.basename(summary[key])
                if summary["reason"] is not None:
                    summary["reason"] = summary["reason"].replace(self.mirrors[which] + "/", "")
                got[which].append(summary)
        assert got["port"] == got["jax"]
        for summary in got["port"]:
            if outcome is not None:
                assert summary["outcome"] == outcome, summary
        for rid in range(2):
            assert self.fleets["port"].replicas[rid].generation.step == \
                self.fleets["jax"].replicas[rid].generation.step
        return got["port"]


def _gates(journals):
    return {which: [(e["origin"], e["outcome"], e["step"], e.get("quality"))
                    for e in _events(path, "quality_gate")]
            for which, path in journals.items()}


@pytest.mark.parametrize("gate_kwargs, outcome, summary_outcome", [
    ({"force": True}, "forced", "applied"),
    ({"min_rows": 10 ** 6}, "passed", "applied"),
    ({"min_rows": 10 ** 6, "unknown_policy": "closed"}, "held", "held"),
], ids=["forced", "unknown_open", "unknown_closed"])
def test_gate_outcomes_fed_by_the_ledger_match_jax(tmp_path, journals, gate_kwargs, outcome,
                                                   summary_outcome):
    """The gate's other verdicts on a replay buffer the ledger filled from
    served traffic: a forced swap of a regressing link, and quality
    unknown (too few joined rows) under each policy."""
    sc = Scenario(tmp_path, clean_steps=8, gate_kwargs=gate_kwargs)
    for tick in range(8):
        sc.serve_tick(tick, attach=True)
    for module in (faults, jax_faults):
        module.install("stream.labels:errorx*")
    sc.train_steps(30, start=8)
    assert sc.exporter.publish_delta(sc.trainer) is not None
    sc.poll(summary_outcome)
    gates = _gates(journals)
    assert gates["port"] == gates["jax"]
    want_quality = "known" if "force" in gate_kwargs else "unknown"
    assert [(o, q) for _, o, _, q in gates["port"]] == [(outcome, want_quality)] * 2


def test_canary_gate_fed_by_served_traffic_matches_jax(tmp_path, journals):
    sc = Scenario(tmp_path, clean_steps=24)
    fleets, batches, exporter, trainer = sc.fleets, sc.batches, sc.exporter, sc.trainer
    base_step = fleets["port"].replicas[0].generation.step

    # Phase A: clean labeled traffic fills the windows and replay buffers.
    for tick in range(30):
        sc.serve_tick(tick, attach=True)
    for which, fleet in fleets.items():
        for ledger in fleet.ledgers:
            snap = ledger.snapshot()
            labels, preds = ledger.pairs()
            assert snap["auc"] == quality.binary_auc(labels, preds)
            assert snap["logloss"] == quality.binary_logloss(labels, preds)
            assert snap["joined"] >= 256
    for rid in range(2):
        port_snap, jax_snap = (fleets[w].ledgers[rid].snapshot() for w in ("port", "jax"))
        for key in ("joined", "window", "pending", "expired", "orphans", "label_mean"):
            assert port_snap[key] == jax_snap[key], key
        for key in ("auc", "logloss", "prediction_mean"):
            assert port_snap[key] == pytest.approx(jax_snap[key], rel=1e-4, abs=1e-6), key

    # A clean link passes the gate.
    sc.train_steps(2, start=24)
    assert exporter.publish_delta(trainer) is not None
    sc.poll("applied")
    probe = batches[0][0]
    before = {w: f.execute(0, probe) for w, f in fleets.items()}
    live_step = fleets["port"].replicas[0].generation.step

    # Poison: the same flipped feed trains the delta and joins online.
    for module in (faults, jax_faults):
        module.install("stream.labels:errorx*")
    sc.train_steps(30, start=30)
    poisoned = exporter.publish_delta(trainer)
    assert poisoned is not None
    hot = {"dense": batches[0][0]["dense"],
           "cat": np.full_like(np.asarray(batches[0][0]["cat"]), 17)}
    for tick in range(30, 50):
        sc.serve_tick(tick, attach=False)
        for fleet in fleets.values():
            for rid in range(2):
                fleet.execute(rid, hot)
            fleet.drift.observe_serve(hot)
        sc.served += 2
        if tick in (31, 45):  # the watcher retries a held link forever
            for summary in sc.poll("held"):
                assert summary["held"] == os.path.basename(poisoned)
                assert "logloss_regress" in summary["reason"]
    for which, fleet in fleets.items():
        assert fleet.replicas[0].generation.step == live_step
        np.testing.assert_array_equal(fleet.execute(0, probe), before[which])  # bit for bit

    # Recovery: the feed heals, a clean retrain compacts past the held link
    # (an ungated reload), and the next clean link passes the gate.
    for module in (faults, jax_faults):
        module.clear()
    sc.train_steps(60, start=60)
    assert exporter.publish_delta(trainer) is not None
    assert exporter.compact() is not None
    for tick in range(50, 56):
        sc.serve_tick(tick, attach=True)
    for summary in sc.poll("applied"):
        assert summary["reloaded_full"] is True
    sc.train_steps(12, start=120)
    assert exporter.publish_delta(trainer) is not None
    for tick in range(56, 62):
        sc.serve_tick(tick, attach=True)
    for summary in sc.poll("applied"):
        assert summary["applied_deltas"] == 1
    assert fleets["port"].replicas[0].generation.step == exporter.head_step > base_step
    assert sc.served == 2 * 82

    # The journals: the same gate story, read by each package's tools.
    events = {which: _events(path) for which, path in journals.items()}
    gates = {which: [(e["origin"], e["outcome"], e["step"]) for e in ev
                     if e["event"] == "quality_gate"] for which, ev in events.items()}
    assert gates["port"] == gates["jax"]
    assert [o for _, o, _ in gates["port"]] == (["passed"] * 2 + ["held"] * 4 + ["passed"] * 2)
    for which in PACKAGES:
        windows = [e for e in events[which] if e["event"] == "quality_window"]
        assert len(windows) == 2 * 62  # one a tick a replica from the first prediction
    assert [(e["origin"], e["joined"], e["window"]) for e in events["port"]
            if e["event"] == "quality_window"] == [
        (e["origin"], e["joined"], e["window"]) for e in events["jax"]
        if e["event"] == "quality_window"]
    drift = {which: [e["state"] for e in ev if e["event"] == "quality_drift"]
             for which, ev in events.items()}
    assert drift["port"] == drift["jax"] and "breach" in drift["port"]
    for e in events["port"]:
        assert not obs.missing_fields(e), e
    assert _validator().validate_file(journals["port"]) == []
    sections = {"port": report.summarize(events["port"])["quality"],
                "jax": jax_report.summarize(events["jax"])["quality"]}
    for key in ("window_updates", "gate_decisions", "drift_events", "holds", "forced",
                "drift_breaches", "drift_final_state"):
        assert sections["port"][key] == sections["jax"][key], key
    assert [g["outcome"] for g in sections["port"]["gates"]] == [
        g["outcome"] for g in sections["jax"]["gates"]]
    rendered = report.render_report(report.summarize(events["port"]))
    assert "model quality" in rendered and "HELD" in rendered
    assert top.quality_note(events["port"]).split()[:2] == \
        jax_top.quality_note(events["jax"]).split()[:2]


def _validator():
    spec = importlib.util.spec_from_file_location(
        "validate_journal", os.path.join(REPO, "scripts", "validate_journal.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["validate_journal"] = module
    spec.loader.exec_module(module)
    return module


# ----------------------------------------------------------------------
# The labels request over HTTP, the label feed
# ----------------------------------------------------------------------


@pytest.fixture
def replica_dir(tmp_path):
    import chip_smoke

    path = str(tmp_path / "artifact")
    chip_smoke.write_random_artifact(path, "vocab_size=200,embedding_dim=4,hidden=8,"
                                     "split_tables=true", seed=3)
    return path


def _serve(replica_dir, with_quality):
    from elasticdl_tpu_torch.serving.batcher import BatcherConfig, MicroBatcher
    from elasticdl_tpu_torch.serving.frontend import ServingFrontend
    from elasticdl_tpu_torch.serving.ledger import ExemplarSampler
    from elasticdl_tpu_torch.serving.runtime import ServingReplica

    replica = ServingReplica(replica_dir, device="cpu")
    ledger = drift = None
    if with_quality:
        ledger = quality.QualityLedger(window_size=64, join_window_s=30.0, origin="replica_0",
                                       replay=quality.ReplayBuffer())
        drift = quality.DriftMonitor(bins=16, origin="replica_0")
    batcher = MicroBatcher(replica.execute, BatcherConfig(max_batch_size=8, max_wait_us=500),
                           on_batch=drift.observe_serve if drift else None).start()
    sampler = ExemplarSampler(head_every=2, quality=ledger)
    frontend = ServingFrontend(replica, batcher, sampler=sampler, quality=ledger)
    return frontend.start(), frontend, batcher, ledger, drift


def test_labels_request_over_http(replica_dir):
    import http.client

    from elasticdl_tpu_torch.serving.frontend import PredictClient, PredictError

    rng = np.random.default_rng(1)
    requests = [{"dense": rng.random((4, 13), dtype=np.float32),
                 "cat": rng.integers(0, 200, (4, 26)).astype(np.int32)} for _ in range(6)]
    port, frontend, batcher, ledger, drift = _serve(replica_dir, with_quality=True)
    client = PredictClient(f"127.0.0.1:{port}")
    try:
        outputs = {f"t{i}": client.predict(r, trace_id=f"t{i}", span_id=f"t{i}")
                   for i, r in enumerate(requests)}
        client.predict(requests[0])  # untraced: never sampled
        labels = {trace_id: stream.feedback_labels(r)
                  for trace_id, r in zip(outputs, requests)}
        reply = client.send_labels({**labels, "unknown": np.ones(4, np.float32)})
        assert reply == {"received": 7, "joined": 3, "enabled": True}  # t0, t2, t4 sampled
        assert client.send_labels(labels) == {"received": 6, "joined": 0, "enabled": True}
        snap = ledger.snapshot()
        assert (snap["joined"], snap["orphans"], snap["pending"]) == (12, 10, 0)
        y, p = ledger.pairs()
        np.testing.assert_array_equal(
            p, np.concatenate([outputs[t] for t in ("t0", "t2", "t4")]).astype(np.float32))
        np.testing.assert_array_equal(y, np.concatenate([labels[t] for t in ("t0", "t2", "t4")]))
        assert drift._serve.total_ids == 7 * 4 * 26  # every served row, sampled or not
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/labels", body=b"not an npz")
        response = conn.getresponse()
        body = json.loads(response.read())
        conn.close()
        assert response.status == 400 and body["code"] == "INVALID_ARGUMENT"
        assert PredictError(body["code"], body["message"]).status == 400
    finally:
        client.close()
        frontend.stop()
        batcher.stop()
    port, frontend, batcher, _, _ = _serve(replica_dir, with_quality=False)
    client = PredictClient(f"127.0.0.1:{port}")
    try:
        client.predict(requests[0], trace_id="t0")
        assert client.send_labels({"t0": np.ones(4, np.float32)}) == {
            "received": 1, "joined": 0, "enabled": False}
    finally:
        client.close()
        frontend.stop()
        batcher.stop()


def _jax_loadgen():
    spec = importlib.util.spec_from_file_location("jax_loadgen",
                                                  os.path.join(REPO, "scripts", "loadgen.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["jax_loadgen"] = module  # the dataclasses resolve their module
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("spec", ["", "stream.labels:truncate@2", "stream.labels:error@3x2"],
                         ids=["clean", "outage", "poisoned"])
def test_label_feed_matches_jax(spec):
    from elasticdl_tpu_torch.bench import loadgen

    jax_loadgen = _jax_loadgen()
    requests = jax_loadgen.RequestStream(jax_loadgen.StreamConfig(seed=4))
    pairs = [(jax_loadgen.trace_id_for(4, i), requests.request(i)) for i in range(10)]
    sent, stats, naps = {}, {}, {}
    for which, module in (("jax", jax_faults), ("port", faults)):
        if spec:
            module.install(spec)
        sent[which], naps[which] = [], []

        def send(mapping, out=sent[which]):
            out.append({k: v.tolist() for k, v in mapping.items()})
            return {"received": len(mapping), "joined": len(mapping) // 2}

        def failing(mapping):
            raise ConnectionRefusedError("replica gone")

        if which == "jax":
            stats[which] = jax_loadgen.run_label_feed([send, failing], requests, 10, group=3,
                                                      delay_s=0.25, sleep=naps[which].append)
        else:
            stats[which] = loadgen.run_label_feed([send, failing], pairs, group=3, delay_s=0.25,
                                                  sleep=naps[which].append)
    assert stats["port"] == stats["jax"]
    assert sent["port"] == sent["jax"]
    assert naps["port"] == naps["jax"] == [0.25] * 4
    assert stats["port"]["send_errors"] == stats["port"]["groups"] - stats["port"]["outages"]


def test_quality_slo_reads_the_ledger_gauge():
    """The replica's telemetry loop journals the window before the SLO
    tick: the model_quality SLO then scores the ledger's logloss gauge."""
    from elasticdl_tpu_torch.obs.slo import SLOPlane, quality_slo

    ledger = quality.QualityLedger(window_size=32, join_window_s=5.0, origin="replica_0")
    plane = SLOPlane(specs=[quality_slo(max_logloss=0.5, min_window_s=1.0,
                                        compliance_window_s=60.0)],
                     status_interval_s=1000.0, origin="replica_0")
    for tick in range(12):
        ledger.note_prediction(f"t{tick}", np.full(4, 0.9), float(tick))
        ledger.note_label(f"t{tick}", np.zeros(4) if tick >= 6 else np.ones(4), float(tick))
        ledger.journal_window(float(tick))
        plane.tick(float(tick))
    assert "model_quality" in plane.slos.alerting()


def test_worker_launched_with_drift_bins_sketches_its_batches():
    """``--quality_drift_bins`` reaches a launched worker: the master
    forwards it (``WORKER_FLAGS``), the worker's parser takes it, and
    ``worker.main`` enables the train sketch at the forwarded bins and
    threshold, which the Local worker's batches then feed."""
    import signal

    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.master.main import start_master
    from elasticdl_tpu_torch.master.pod_manager import worker_argv_from_args
    from elasticdl_tpu_torch.worker import main as worker_main

    args = parse_master_args([
        "--model_zoo=model_zoo", "--model_def=deepfm.deepfm_functional_api",
        "--model_params=vocab_size=50,embedding_dim=4,hidden=8",
        "--training_data=synthetic://ctr?n=256&vocab=50", "--minibatch_size=64",
        "--records_per_task=128", "--quality_drift_bins=64",
        "--quality_drift_threshold=0.4", "--device=cpu"])
    master = start_master(args)
    sigterm = signal.getsignal(signal.SIGTERM)
    try:
        argv = worker_argv_from_args(args, master.addr)(0)
        assert argv[1:3] == ["-m", "elasticdl_tpu_torch.worker.main"]
        assert worker_main.main(argv[3:]) == 0
        monitor = quality.train_monitor()
        assert monitor is not None
        assert (monitor._threshold, monitor._origin) == (0.4, "worker_0")
        assert monitor._train.bins == 64
        assert monitor._train.total_ids == 4 * 64 * 26  # 4 steps of 64 rows, 26 ids a row
    finally:
        quality.enable_train_sketch(None)
        signal.signal(signal.SIGTERM, sigterm)
        master.stop()


def test_local_worker_sketches_each_host_batch_like_jax():
    """The worker hook: with a monitor enabled (``--quality_drift_bins``
    on a worker), each Local train batch's ids fold into the train sketch
    as the host arrays they arrived as, the JAX worker's counts exactly."""
    from elasticdl_tpu.client import main as jax_client_main
    from elasticdl_tpu_torch.client import main as client_main

    argv = ["train", "--distribution_strategy=Local", "--model_zoo=model_zoo",
            "--model_def=deepfm.deepfm_functional_api",
            "--model_params=vocab_size=50,embedding_dim=4,hidden=8",
            "--training_data=synthetic://ctr?n=256&vocab=50", "--minibatch_size=64",
            "--records_per_task=128"]
    got = {}
    for which, run, extra in (("jax", jax_client_main.main, []),
                              ("port", client_main.main, ["--device=cpu"])):
        module = PACKAGES[which][0]
        monitor = module.DriftMonitor(bins=16, origin="worker_0")
        module.enable_train_sketch(monitor)
        try:
            assert run(argv + extra) == 0
        finally:
            module.enable_train_sketch(None)
        got[which] = (monitor._train.total_ids, monitor._train.id_frequency().tolist(),
                      monitor._serve.total_ids)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 4 * 64 * 26  # 4 steps of 64 rows, 26 ids a row
    quality.note_train_batch({"cat": np.ones((2, 2), np.int64)})  # disabled: free, no error
