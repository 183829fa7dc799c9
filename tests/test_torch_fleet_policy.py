"""The serving fleet under the port's real ``ElasticPolicyEngine``
(``master/policy.py`` over ``serving/supervisor.py``), on the CPU.

- JAX's acceptance e2e (``tests/test_slo.py:670-813``, ``_run_fleet``) on
  the port's in-process fleet: two replica-shaped sensors (a private
  registry, ``AvailabilityLedger`` and ``SLOPlane`` each) share one
  journal, a ``random.Random(4242)`` load on a virtual clock, and the
  supervisor's ``SLOAlertFollower`` feeds the real engine.  The port's
  run and JAX's fire and clear on the same ticks and journal the same
  ``slo_alert`` sequence and ``policy_decision`` reasons; the no-fault
  control fires nothing in either.
- Two replicas firing one SLO are two alerts: each fire and clear
  reaches the journal and the advisory lasts until the last one clears.
- ``start_serving_fleet(policy=ElasticPolicyEngine(...), device="cpu")``
  over two replica processes, a latency fault armed in one: its alert
  reaches the engine as an advisory hold, no replica is killed or
  rescaled, and ``stop()`` stops the engine with the fleet.
"""

import json
import os
import random
import stat
import sys
import threading
import time

import numpy as np
import pytest

import test_slo as jax_e2e
from elasticdl_tpu import obs as jax_obs
from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.analysis import journal_schema
from elasticdl_tpu_torch.master.policy import ElasticPolicyEngine, PolicyConfig
from elasticdl_tpu_torch.obs import report as report_mod
from elasticdl_tpu_torch.obs.metrics import MetricsRegistry
from elasticdl_tpu_torch.obs.slo import SLOPlane, serving_availability_slo, serving_latency_slo
from elasticdl_tpu_torch.serving import supervisor
from elasticdl_tpu_torch.serving.export import export_model
from elasticdl_tpu_torch.serving.frontend import PredictClient
from elasticdl_tpu_torch.serving.ledger import AvailabilityLedger
from test_torch_supervisor import MODEL_DEF, _census_trainer

FAULT_START, FAULT_END, TOTAL_TICKS = jax_e2e.FAULT_START, jax_e2e.FAULT_END, jax_e2e.TOTAL_TICKS
REQUESTS_PER_TICK = jax_e2e.REQUESTS_PER_TICK


def _run_port_fleet(tmp_path, fault: bool):
    """``tests/test_slo.py``'s ``_run_fleet`` on the port's classes."""
    journal_path = obs.init_journal(str(tmp_path))
    clock = jax_e2e.FakeClock(t=0.0)
    engine = ElasticPolicyEngine(PolicyConfig(), clock=clock)
    follower = supervisor.SLOAlertFollower(engine, journal=obs.journal())
    rng = random.Random(4242)

    replicas = []
    for rid in range(2):
        registry = MetricsRegistry()
        ledger = AvailabilityLedger(clock=clock, registry=registry)
        plane = SLOPlane(
            registry=registry,
            specs=[serving_latency_slo(20.0, objective=0.99, compliance_window_s=7200.0),
                   serving_availability_slo(0.999, compliance_window_s=7200.0)],
            origin=f"replica_{rid}",
        )
        replicas.append((rid, ledger, plane))

    fired_tick = cleared_tick = None
    for tick in range(TOTAL_TICKS):
        clock.advance(1.0)
        in_fault = fault and FAULT_START <= tick < FAULT_END
        for rid, ledger, plane in replicas:
            for _ in range(REQUESTS_PER_TICK):
                latency = 0.002 + rng.random() * 0.0005
                if in_fault and rid == 0:
                    latency = 0.05 + rng.random() * 0.01
                ledger.record_request({"execute": latency}, "served")
            if in_fault and rid == 0 and tick % 10 == 0:
                ledger.record_shed(rows=8)
                obs.journal().record("request_shed", reason="queue_full", queue_depth=256,
                                     queue_limit=256, rows=8)
            plane.tick(float(tick))
        follower.poll_once()
        alerts = engine.slo_alerts()
        if fired_tick is None and alerts:
            fired_tick = tick
        if fired_tick is not None and cleared_tick is None and tick >= FAULT_END \
                and not alerts:
            cleared_tick = tick
    return journal_path, engine, fired_tick, cleared_tick


def _events(path, event):
    with open(path) as f:
        return [e for e in map(json.loads, f) if e["event"] == event]


def _alerts(path):
    keys = ("slo", "state", "grade", "origin", "offending", "burn_rates",
            "budget_remaining_ratio")
    return [{k: e.get(k) for k in keys} for e in _events(path, "slo_alert")]


def _decisions(path):
    return [{k: v for k, v in e.items() if k != "ts"} for e in _events(path, "policy_decision")]


@pytest.mark.parametrize("fault", [True, False], ids=["latency_fault", "control"])
def test_fleet_e2e_matches_jax_tick_for_tick(tmp_path, fault, obs_registry_snapshot):
    try:
        jax_path, jax_engine, jax_fired, jax_cleared = jax_e2e._run_fleet(
            str(tmp_path / "jax"), fault)
    finally:
        jax_obs.journal().configure(None)
    try:
        path, engine, fired, cleared = _run_port_fleet(str(tmp_path / "port"), fault)
    finally:
        obs.journal().configure(None)
    assert (fired, cleared) == (jax_fired, jax_cleared)
    assert engine.slo_alerts() == jax_engine.slo_alerts() == {}
    assert _alerts(path) == _alerts(jax_path)
    assert _decisions(path) == _decisions(jax_path)
    assert journal_schema.validate_file(path) == []
    if not fault:
        assert fired is None and _alerts(path) == [] and _decisions(path) == []
        assert _events(path, "slo_status")
        return
    assert FAULT_START < fired <= FAULT_START + 20 and cleared is not None
    alerts = _alerts(path)
    assert [a["state"] for a in alerts] == ["fire", "clear"]
    assert {(a["slo"], a["origin"]) for a in alerts} == {("serving_latency", "replica_0")}
    assert alerts[0]["grade"] == "page"
    decisions = _decisions(path)
    assert [d["reason"] for d in decisions] == ["slo_alert", "slo_alert_cleared"]
    assert decisions[0]["slo_advisory"] == ["serving_latency"]
    assert decisions[0]["origin"] == "replica_0" and decisions[0]["action"] == "hold"
    summary = report_mod.summarize(report_mod.load_events(path))
    (breach,) = summary["slo"]["breaches"]
    assert (breach["slo"], breach["origin"], breach["grade"]) == (
        "serving_latency", "replica_0", "page")
    assert breach["cleared_ts"] >= breach["fired_ts"]
    assert breach["shed_reasons"]["queue_full"] >= 1


def test_two_replicas_firing_one_slo_are_two_alerts(tmp_path):
    path = obs.init_journal(str(tmp_path))
    clock = jax_e2e.FakeClock(t=0.0)
    engine = ElasticPolicyEngine(PolicyConfig(), clock=clock)
    try:
        for origin in ("replica_0", "replica_1"):
            clock.advance(1.0)
            engine.note_slo_alert("serving_latency", True, {"grade": "page", "origin": origin})
        clock.advance(1.0)
        engine.note_slo_alert("serving_latency", False, {"grade": "page", "origin": "replica_0"})
        assert engine.slo_alerts() == {"serving_latency": {"grade": "page",
                                                           "origin": "replica_1"}}
        clock.advance(1.0)
        engine.tick()  # a decision while replica_1 still pages carries the advisory
        clock.advance(1.0)
        engine.note_slo_alert("serving_latency", False, {"grade": "page", "origin": "replica_1"})
        engine.note_slo_alert("serving_latency", False, {"origin": "replica_1"})  # phantom
    finally:
        obs.journal().configure(None)
    assert engine.slo_alerts() == {}
    assert [(d["reason"], d.get("origin"), d.get("slo_advisory")) for d in _decisions(path)] == [
        ("slo_alert", "replica_0", ["serving_latency"]),
        ("slo_alert", "replica_1", ["serving_latency"]),
        ("slo_alert_cleared", "replica_0", ["serving_latency"]),
        ("steady", None, ["serving_latency"]),
        ("slo_alert_cleared", "replica_1", None),
    ]


def test_real_engine_over_a_cpu_fleet_takes_no_action_on_an_advisory(tmp_path):
    trainer, batches, requests = _census_trainer()
    for features, labels in batches[:2]:
        trainer.train_step(features, labels)
    gen1 = export_model(trainer, str(tmp_path / "gen1"), model_zoo="model_zoo",
                        model_def=MODEL_DEF, model_params="")
    want = [trainer.eval_step(r) for r in requests]
    # The fault is armed in replica 0 alone: its interpreter is a wrapper
    # that sets ELASTICDL_FAULTS when it starts replica 0.
    wrapper = tmp_path / "python.sh"
    wrapper.write_text(
        "#!/bin/sh\n"
        "case \" $* \" in *\" --replica_id 0 \"*)\n"
        "  ELASTICDL_FAULTS='serving.execute:latency=0.5@10x6'; export ELASTICDL_FAULTS;;\n"
        f"esac\nexec {sys.executable} \"$@\"\n")
    wrapper.chmod(wrapper.stat().st_mode | stat.S_IEXEC)
    serve = str(tmp_path / "serve")
    engine = ElasticPolicyEngine(PolicyConfig(tick_interval_s=0.2))
    manager = supervisor.start_serving_fleet(
        2, gen1, serve, worker_env={"PYTHONPATH": ""}, policy=engine, python=str(wrapper),
        max_batch_size=16, max_wait_us=1000, telemetry_interval_s=0.25, slo_p99_ms=250.0,
        slo_availability_target=0.999, slo_compliance_window_s=2400.0, device="cpu")
    stop, errors, clients = threading.Event(), [], {}
    try:
        assert manager.policy is engine and manager.slo_follower is not None
        live = supervisor.wait_for_replicas(serve, 2, timeout_s=120)
        clients = {r["replica_id"]: PredictClient(f"127.0.0.1:{r['port']}", deadline_s=60.0)
                   for r in live}

        def drive(rid):
            i = rid
            while not stop.is_set():
                try:
                    np.testing.assert_allclose(
                        clients[rid].predict(requests[i % len(requests)]),
                        want[i % len(requests)], rtol=1e-5)
                except Exception as exc:  # reported below
                    errors.append(repr(exc))
                i += 1

        threads = [threading.Thread(target=drive, args=(rid,), daemon=True) for rid in (0, 1)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while not any(d.get("reason") == "slo_alert" for d in _decisions(
                os.path.join(serve, "events.jsonl"))):
            assert time.monotonic() < deadline, "no advisory within 60 s"
            time.sleep(0.2)
        time.sleep(1.0)  # ticks after the advisory
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert manager.current_worker_ids() == [0, 1] and manager.restarts_used == 0
        assert not errors, errors[:3]
    finally:
        stop.set()
        for client in clients.values():
            client.close()
        manager.stop()
        obs.journal().configure(None)
    assert engine._thread is not None and not engine._thread.is_alive()
    path = os.path.join(serve, "events.jsonl")
    decisions = _decisions(path)
    assert {d["action"] for d in decisions} == {"hold"}
    advisory = next(d for d in decisions if d["reason"] == "slo_alert")
    assert advisory["slo"] == "serving_latency" and advisory["origin"] == "replica_0"
    assert advisory["slo_advisory"] == ["serving_latency"]
    alerts = _events(path, "slo_alert")
    assert {(a["slo"], a["origin"], a["state"]) for a in alerts} == {
        ("serving_latency", "replica_0", "fire")}
    assert not _events(path, "worker_churn") and not _events(path, "scale")
    assert journal_schema.validate_file(path) == []
    assert [e["forbidden_modules"] for e in _events(path, "serving_replica_start")] == [[], []]
