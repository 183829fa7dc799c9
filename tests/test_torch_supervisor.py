"""The port's serving supervisor (``serving/supervisor.py``) and the pod
manager surface it stands on (``master/pod_manager.py``), on the CPU.

- ``replica_argv_fn`` gives the JAX package's argv for the same keyword
  arguments, run as the port's replica module, with ``--device``
  appended.
- The churn handler on a fake substrate: only the dead are replaced,
  with fresh ids; a spent budget with no replica left journals
  ``job_failed``; a ``stop()`` that races the repair terminates the
  fresh replicas; a stale snapshot is ignored.  The training manager
  still restarts the whole world.
- ``SLOAlertFollower`` forwards each ``slo_alert`` edge once to a stub
  policy (as JAX's ``tests/test_slo.py:405-460``).
- A supervised fleet of 2 replica processes (``device="cpu"``) serving a
  census export, through a live reload under load and a SIGKILL the
  supervisor repairs with a fresh replica.  Every wait is bounded.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.serving import supervisor as jax_supervisor
from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.data.dataset import _stack
from elasticdl_tpu_torch.data.synthetic import synthetic_census_records
from elasticdl_tpu_torch.master.pod_manager import LocalProcessManager
from elasticdl_tpu_torch.obs.journal import EventJournal
from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
from elasticdl_tpu_torch.serving import supervisor
from elasticdl_tpu_torch.serving.export import export_model
from elasticdl_tpu_torch.serving.frontend import PredictClient, encode_features
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import census_wide_deep as zoo

WAIT_S = 120.0
MODEL_DEF = "census.census_wide_deep"

ARGV_KWARGS = [
    {},
    {"model_zoo": "model_zoo", "max_batch_size": 16, "max_wait_us": 1000,
     "telemetry_interval_s": 0.5, "warmup_features": "/w.npz", "pub_dir": "/pub",
     "pub_poll_interval_s": 0.5, "freshness_slo_s": 30.0},
    {"sparse_kernel": "fused", "queue_limit": 8, "slo_availability_target": 0.999,
     "slo_p99_ms": 50.0, "trace_head_every": 4, "trace_tail_threshold_ms": 20.0,
     "quality_join_window_s": 5.0, "quality_gate_force": True, "quality_unknown_policy": "closed",
     "python": "/usr/bin/python3"},
]


@pytest.mark.parametrize("kwargs", ARGV_KWARGS, ids=["defaults", "continuous", "armed"])
def test_replica_argv_matches_jax(kwargs):
    want = jax_supervisor.replica_argv_fn("/m", "/s", **kwargs)(7)
    want[want.index("elasticdl_tpu.serving.replica_main")] = (
        "elasticdl_tpu_torch.serving.replica_main")
    assert supervisor.replica_argv_fn("/m", "/s", **kwargs)(7) == want + ["--device", "cuda"]
    assert supervisor.replica_argv_fn("/m", "/s", device="cpu", **kwargs)(3)[-2:] == [
        "--device", "cpu"]
    # The replica parses what the supervisor sends; armed, it builds the
    # quality plane with the supervisor's gate settings.
    from elasticdl_tpu_torch.serving import replica_main

    args = replica_main.parse_replica_args(supervisor.replica_argv_fn("/m", "/s", **kwargs)(7)[3:])
    _ledger, _drift, gate = replica_main._build_quality_plane(args)
    if kwargs.get("quality_join_window_s"):
        assert (gate._force, gate._unknown_policy) == (True, "closed")
    else:
        assert gate is None


# -- the churn handler on a fake substrate -------------------------------------


class _Proc:
    def __init__(self, worker_id):
        self.worker_id = worker_id
        self.log_path = os.devnull
        self.code = None


class _Fake:
    """The substrate hooks over ``_Proc``s, recording launches and
    terminations."""

    def _substrate_start(self):
        self.launched, self.terminated, self.on_launch = [], [], None

    def _substrate_launch(self, worker_ids):
        self.launched.append(list(worker_ids))
        if self.on_launch is not None:
            self.on_launch()
        return [_Proc(wid) for wid in worker_ids]

    def _substrate_poll(self, handle):
        return handle.code

    def _substrate_terminate(self, handles):
        for h in handles:
            self.terminated.append(h.worker_id)
            if h.code is None:
                h.code = -15

    def _substrate_kill(self, handle, sig=9):
        handle.code = -sig


class FakeFleet(_Fake, supervisor.ServingReplicaManager):
    pass


class FakeWorld(_Fake, LocalProcessManager):
    pass


@pytest.fixture
def journal(tmp_path):
    path = obs.init_journal(str(tmp_path))

    def events(event):
        with open(path) as f:
            return [e for e in map(json.loads, f) if e["event"] == event]

    try:
        yield events
    finally:
        obs.journal().configure(None)


def _fleet(cls, n, max_restarts=3):
    manager = cls(n, lambda wid: [], max_restarts=max_restarts, poll_interval_s=0.01)
    manager._substrate_start()
    manager._launch_world(n)
    return manager


def _crash(manager, *ids):
    handles = list(manager._handles)
    crashed = []
    for h in handles:
        if h.worker_id in ids:
            h.code = -9
            crashed.append((h, -9))
    manager._handle_churn(handles, crashed)
    return handles


def test_churn_replaces_only_the_dead_with_fresh_ids(journal):
    fleet = _fleet(FakeFleet, 3)
    assert fleet.current_worker_ids() == [0, 1, 2]
    _crash(fleet, 1)
    assert fleet.current_worker_ids() == [0, 2, 3]
    assert fleet.launched == [[0, 1, 2], [3]] and fleet.terminated == [1]
    _crash(fleet, 0, 3)
    assert fleet.current_worker_ids() == [2, 4, 5]
    assert fleet.terminated == [1, 0, 3]
    churn = journal("worker_churn")
    assert [(e["workers"], e["exit_codes"], e["old_size"], e["budget_left"]) for e in churn] == [
        ([1], [-9], 3, True), ([0, 3], [-9, -9], 3, True)]
    assert not journal("job_failed") and fleet.failed_reason is None


def test_churn_with_the_budget_spent(journal):
    fleet = _fleet(FakeFleet, 2, max_restarts=1)
    _crash(fleet, 0)
    assert fleet.current_worker_ids() == [1, 2]
    _crash(fleet, 1)  # over the budget: no replacement, the survivor serves
    assert fleet.current_worker_ids() == [2] and fleet.failed_reason is None
    _crash(fleet, 2)  # none left
    assert fleet.current_worker_ids() == []
    assert "restart budget exhausted" in fleet.failed_reason
    assert fleet.wait(timeout=1) is False
    assert [e["budget_left"] for e in journal("worker_churn")] == [True, False, False]
    assert len(journal("job_failed")) == 1
    assert fleet.launched == [[0, 1], [2]]


def test_stop_racing_the_repair_terminates_the_fresh_replicas(journal):
    fleet = _fleet(FakeFleet, 2)
    fleet.on_launch = fleet.stop
    _crash(fleet, 0)
    assert fleet.launched == [[0, 1], [2]]
    assert sorted(fleet.terminated) == [0, 0, 1, 2]  # the dead, the survivor, the fresh one
    assert not journal("job_failed")


def test_stale_snapshot_is_not_churn(journal):
    fleet = _fleet(FakeFleet, 2)
    stale = list(fleet._handles)
    _crash(fleet, 0)
    fleet._handle_churn(stale, [(stale[1], -9)])  # that world was already replaced
    assert fleet.current_worker_ids() == [1, 2] and len(journal("worker_churn")) == 1
    fleet.stop()
    fleet._handle_churn(list(fleet._handles), [(fleet._handles[0], -9)])
    assert len(journal("worker_churn")) == 1


def test_training_manager_still_restarts_the_world(journal):
    world = _fleet(FakeWorld, 2)
    _crash(world, 1)
    assert world.current_worker_ids() == [2, 3]
    assert world.terminated == [0, 1]  # the survivor dies with the world


def test_monitor_repairs_a_killed_replica(journal):
    fleet = FakeFleet(2, lambda wid: [], poll_interval_s=0.01)
    fleet.start()
    try:
        fleet.kill_worker(1, signal.SIGKILL)
        with pytest.raises(ValueError):
            fleet.kill_worker(9)
        deadline = time.monotonic() + 10
        while fleet.current_worker_ids() != [0, 2] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fleet.current_worker_ids() == [0, 2]
    finally:
        fleet.stop()
    assert [e["exit_codes"] for e in journal("worker_churn")] == [[-9]]


# -- the SLO alert follower -----------------------------------------------------


class _RecordingPolicy:
    def __init__(self, fail_on=()):
        self.calls, self.fail_on = [], fail_on

    def note_slo_alert(self, slo, alerting, evidence=None):
        self.calls.append((slo, alerting, dict(evidence or {})))
        if slo in self.fail_on:
            raise RuntimeError("boom")


def test_slo_alert_follower_forwards_each_edge_once():
    journal = EventJournal()
    journal.record("serving_replica_start", replica_id=0, port=1)
    journal.record("slo_alert", slo="serving_latency", state="fire", grade="page",
                   origin="replica_0", burn_rates={"1h": 14.0}, ignored=1)
    journal.record("slo_alert", slo="serving_latency", state="clear", grade="page",
                   origin="replica_0")
    policy = _RecordingPolicy()
    follower = supervisor.SLOAlertFollower(policy, journal=journal)
    assert follower.poll_once() == 2
    assert follower.poll_once() == 0  # the same tail again: nothing new
    journal.record("slo_alert", slo="serving_availability", state="fire", grade="warn",
                   origin="replica_1")
    assert follower.poll_once() == 1
    assert [(c[0], c[1]) for c in policy.calls] == [
        ("serving_latency", True), ("serving_latency", False), ("serving_availability", True)]
    assert policy.calls[0][2] == {"grade": "page", "burn_rates": {"1h": 14.0},
                                  "origin": "replica_0"}


def test_slo_alert_follower_survives_a_policy_exception():
    journal = EventJournal()
    journal.record("slo_alert", slo="a_slo", state="fire", origin="r")
    journal.record("slo_alert", slo="b_slo", state="fire", origin="r")
    policy = _RecordingPolicy(fail_on=("a_slo",))
    follower = supervisor.SLOAlertFollower(policy, journal=journal, poll_interval_s=0.01)
    assert follower.poll_once() == 1
    assert [c[0] for c in policy.calls] == ["a_slo", "b_slo"]
    follower.start()
    journal.record("slo_alert", slo="c_slo", state="fire", origin="r")
    deadline = time.monotonic() + 10
    while len(policy.calls) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    follower.stop()
    assert [c[0] for c in policy.calls] == ["a_slo", "b_slo", "c_slo"]


def test_start_serving_fleet_binds_a_policy(tmp_path, monkeypatch):
    class Policy(_RecordingPolicy):
        def bind(self, manager):
            self.manager = manager
            return self

        def start(self):
            self.started = True
            return self

        def stop(self):
            self.stopped = True

    monkeypatch.setattr(supervisor, "ServingReplicaManager", FakeFleet)
    policy = Policy()
    manager = supervisor.start_serving_fleet(2, "/m", str(tmp_path / "serve"), policy=policy,
                                             device="cpu")
    try:
        assert policy.manager is manager and policy.started and manager.policy is policy
        assert manager.slo_follower is not None and manager.current_worker_ids() == [0, 1]
        argv = manager._worker_argv_fn(0)
        assert argv[argv.index("-m") + 1] == "elasticdl_tpu_torch.serving.replica_main"
        import elasticdl_tpu_torch

        root = os.path.dirname(os.path.dirname(os.path.abspath(elasticdl_tpu_torch.__file__)))
        assert manager._worker_env["PYTHONPATH"].split(os.pathsep)[0] == root
    finally:
        manager.stop()
        obs.journal().configure(None)
    assert manager.slo_follower._thread is None
    assert policy.stopped  # the engine stops with the fleet
    with open(tmp_path / "serve" / "events.jsonl") as f:
        starts = [e for e in map(json.loads, f) if e["event"] == "serving_fleet_start"]
    assert starts and starts[0]["replicas"] == 2


# -- a supervised fleet of replica processes --------------------------------------


def _census_trainer():
    trainer = ShardedEmbeddingTrainer(build_model(MODEL_DEF, "", device="cpu"), zoo.loss,
                                      zoo.optimizer(),
                                      embedding_optimizer=zoo.embedding_optimizer(),
                                      device="cpu")
    records = synthetic_census_records(4 * 64 + 64, seed=5)
    rows = [(zoo.preprocess_record(raw), np.int32(label)) for raw, label in records]
    batches = [_stack(rows[i:i + 64]) for i in range(0, 4 * 64, 64)]
    requests = [_stack(rows[256 + i:256 + i + 8])[0] for i in range(0, 64, 8)]
    return trainer, batches, requests


def _drive(predicts, requests, n, threads=4):
    """n requests, closed loop over ``threads`` clients: (answered, errors)."""
    answered, errors, lock = [], [], threading.Lock()

    def client(w):
        for i in range(w, n, threads):
            try:
                out = predicts[i % len(predicts)](requests[i % len(requests)])
                assert out.shape == (8,) and np.all(np.isfinite(out))
                with lock:
                    answered.append(i)
            except Exception as exc:  # reported by the caller
                with lock:
                    errors.append(repr(exc))

    workers = [threading.Thread(target=client, args=(w,), daemon=True) for w in range(threads)]
    for t in workers:
        t.start()
    return workers, answered, errors


def test_supervised_fleet_reload_and_sigkill(tmp_path):
    trainer, batches, requests = _census_trainer()
    for features, labels in batches[:2]:
        trainer.train_step(features, labels)
    gen1 = export_model(trainer, str(tmp_path / "gen1"), model_zoo="model_zoo",
                        model_def=MODEL_DEF, model_params="")
    want1 = [trainer.eval_step(r) for r in requests]
    for features, labels in batches[2:]:
        trainer.train_step(features, labels)
    gen2 = export_model(trainer, str(tmp_path / "gen2"), model_zoo="model_zoo",
                        model_def=MODEL_DEF, model_params="")
    want2 = [trainer.eval_step(r) for r in requests]
    assert not np.allclose(want1[0], want2[0])
    serve = str(tmp_path / "serve")
    warm = str(tmp_path / "warm.npz")
    with open(warm, "wb") as f:
        f.write(encode_features({k: v[:1] for k, v in requests[0].items()}))
    manager = supervisor.start_serving_fleet(
        2, gen1, serve, worker_env={"PYTHONPATH": ""}, max_batch_size=16, max_wait_us=1000,
        telemetry_interval_s=0.5, warmup_features=warm, device="cpu")
    clients = {}
    try:
        live = supervisor.wait_for_replicas(serve, 2, timeout_s=WAIT_S)
        clients = {r["replica_id"]: PredictClient(f"127.0.0.1:{r['port']}", deadline_s=60.0)
                   for r in live}
        rid_swap, rid_kill = sorted(clients)
        assert (rid_swap, rid_kill) == (0, 1)
        for r, want in zip(requests, want1):
            a, b = clients[rid_swap].predict(r), clients[rid_kill].predict(r)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, want, rtol=1e-5)
        # A reload under load: every request answered.
        workers, answered, errors = _drive([clients[rid_swap].predict,
                                            clients[rid_kill].predict], requests, 80)
        time.sleep(0.2)
        assert clients[rid_swap].reload(gen2)["generation"] == 2
        for t in workers:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        assert not errors and len(answered) == 80, errors[:3]
        for r, w1, w2 in zip(requests, want1, want2):
            np.testing.assert_allclose(clients[rid_swap].predict(r), w2, rtol=1e-5)
            np.testing.assert_allclose(clients[rid_kill].predict(r), w1, rtol=1e-5)
        # SIGKILL: the supervisor replaces the replica with a fresh id.
        manager.kill_worker(rid_kill, signal.SIGKILL)
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            ids = manager.current_worker_ids()
            if rid_kill not in ids and len(ids) == 2:
                break
            np.testing.assert_allclose(clients[rid_swap].predict(requests[0]), want2[0],
                                       rtol=1e-5)  # the survivor serves throughout
            time.sleep(0.05)
        assert manager.current_worker_ids() == [rid_swap, 2]
        live = supervisor.wait_for_replicas(serve, 2, timeout_s=WAIT_S)
        fresh = [r for r in live if r["replica_id"] not in (rid_swap, rid_kill)]
        assert [r["replica_id"] for r in fresh] == [2]
        clients[2] = PredictClient(f"127.0.0.1:{fresh[0]['port']}", deadline_s=60.0)
        for r, want in zip(requests, want1):
            np.testing.assert_allclose(clients[2].predict(r), want, rtol=1e-5)
        assert clients[2].stats()["generation"] == 1
    finally:
        for client in clients.values():
            client.close()
        manager.stop()
        obs.journal().configure(None)
    with open(os.path.join(serve, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    names = {e["event"] for e in events}
    assert {"serving_fleet_start", "serving_replica_start", "model_swap",
            "worker_churn"} <= names, names
    churn = [e for e in events if e["event"] == "worker_churn"]
    assert [(e["workers"], e["exit_codes"]) for e in churn] == [([1], [-9])]
    starts = [e for e in events if e["event"] == "serving_replica_start"]
    assert sorted(e["replica_id"] for e in starts) == [0, 1, 2]
    assert all(e["forbidden_modules"] == [] and e["device"] == "cpu" for e in starts)
