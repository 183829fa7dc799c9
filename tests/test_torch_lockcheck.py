"""The port's runtime lock-order checker (``elasticdl_tpu_torch.analysis.
runtime``) against the JAX package's (``elasticdl_tpu/analysis/runtime.py``).

JAX's ``test_lockcheck_*`` cases (``tests/test_concurrency_stress.py``)
run once through each package's checker, and the findings must be equal:
a deliberate A->B / B->A inversion (its ``describe()`` text), a
self-deadlock attempt, long holds (the lock named and flagged, the
default gate still green).  Then the port's own services under
``ELASTICDL_LOCKCHECK=1``: the TaskManager's dispatch/churn stress and
the rendezvous' redeclare/poll stress run clean with the checker engaged,
every lock the port creates through ``make_lock`` is a ``CheckedLock``
carrying JAX's name, and the ``analysis`` package imports no analyzer.
"""

import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.analysis import runtime as jax_lockcheck
from elasticdl_tpu_torch.analysis import runtime as lockcheck
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.master.rendezvous_server import ElasticRendezvous
from elasticdl_tpu_torch.master.task_manager import TaskManager

MODULES = {"jax": jax_lockcheck, "port": lockcheck}
N_RECORDS = 6400
RECORDS_PER_TASK = 64


@pytest.fixture
def lockcheck_enabled(monkeypatch):
    monkeypatch.setenv(lockcheck.ENV_VAR, "1")
    for module in MODULES.values():
        module.reset()
    yield
    for module in MODULES.values():
        module.reset()


def _inversion(module):
    a, b = module.CheckedLock("demo.A"), module.CheckedLock("demo.B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    found = module.inversions()
    with pytest.raises(AssertionError) as raised:
        module.assert_clean()
    return [inv.describe() for inv in found], str(raised.value)


def _self_deadlock(module):
    lock = module.CheckedLock("demo.self")
    assert lock.acquire()
    assert not lock.acquire(timeout=0.05)  # would deadlock; times out
    lock.release()
    return [(inv.first, inv.second, inv.witness, inv.prior_witness)
            for inv in module.inversions()]


def _long_hold(module):
    lock = module.CheckedLock("demo.slow")
    with lock:
        time.sleep(0.05)
    report = module.report()
    module.assert_clean()  # long holds are advisory by default
    with pytest.raises(AssertionError) as raised:
        module.assert_clean(ignore_long_holds=False)
    assert report["max_hold_s"]["demo.slow"] >= 0.05
    return ([(h.lock, h.thread) for h in report["long_holds"]],
            sorted(report["max_hold_s"]), str(raised.value).split("demo.slow")[0])


@pytest.mark.parametrize("case", [_inversion, _self_deadlock, _long_hold],
                         ids=["inversion", "self_deadlock", "long_hold"])
def test_findings_match_jax(case, lockcheck_enabled, monkeypatch):
    monkeypatch.setenv(lockcheck.HOLD_ENV_VAR, "0.01")
    got = {which: case(module) for which, module in MODULES.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0], "the checker found nothing"


def test_inversion_names_the_violating_order(lockcheck_enabled):
    found, _ = _inversion(lockcheck)
    first = lockcheck.inversions()[0]
    assert (first.first, first.second) == ("demo.B", "demo.A")
    assert len(found) == 1


def test_make_lock_follows_the_env(monkeypatch):
    monkeypatch.delenv(lockcheck.ENV_VAR, raising=False)
    assert type(lockcheck.make_lock("x")) is type(threading.Lock())
    for off in ("0", "false", ""):
        monkeypatch.setenv(lockcheck.ENV_VAR, off)
        assert not lockcheck.enabled()
    monkeypatch.setenv(lockcheck.ENV_VAR, "1")
    assert lockcheck.make_lock("x").name == "x"
    monkeypatch.setenv(lockcheck.HOLD_ENV_VAR, "nonsense")
    assert lockcheck.long_hold_threshold_s() == jax_lockcheck.long_hold_threshold_s() == 0.5


def _dispatch_churn_stress():
    """16 worker threads pull and report tasks while a churn thread keeps
    recovering random workers' in-flight tasks (JAX's
    ``test_many_workers_race_dispatch_and_churn`` on the port's
    TaskManager)."""
    manager = TaskManager(training_shards={"s": N_RECORDS}, records_per_task=RECORDS_PER_TASK,
                          num_epochs=1)
    seen, seen_lock, duplicates, errors = set(), threading.Lock(), [], []
    stop_churn = threading.Event()

    def worker(worker_id):
        try:
            while True:
                task = manager.get(worker_id)
                if task.task_id == -1 and task.type != msg.WAIT:
                    return
                if task.type == msg.WAIT:
                    time.sleep(0.001)
                    continue
                with seen_lock:
                    if task.task_id in seen:
                        duplicates.append(task.task_id)
                    seen.add(task.task_id)
                time.sleep(0.0005)
                manager.report(task.task_id, success=True, worker_id=worker_id)
        except Exception as exc:  # reported after the join
            errors.append(exc)

    def churn():
        rng = np.random.RandomState(0)
        while not stop_churn.is_set():
            manager.recover_tasks(int(rng.randint(0, 16)))
            time.sleep(0.002)

    workers = [threading.Thread(target=worker, args=(i,), name=f"stress-worker-{i}", daemon=True)
               for i in range(16)]
    churner = threading.Thread(target=churn, name="stress-churn", daemon=True)
    for t in workers:
        t.start()
    churner.start()
    for t in workers:
        t.join(timeout=120)
        assert not t.is_alive(), "worker thread wedged (deadlock?)"
    stop_churn.set()
    churner.join(timeout=10)
    assert not errors, errors
    assert not duplicates, f"task ids dispatched twice: {duplicates[:5]}"
    assert manager.finished()
    assert manager.finished_record_count >= N_RECORDS
    assert manager.finished_record_count % RECORDS_PER_TASK == 0
    return manager


def _rendezvous_stress():
    rdv = ElasticRendezvous(coordinator_port_fn=lambda host: 5000)
    stop, errors = threading.Event(), []

    def redeclare():
        i = 0
        while not stop.is_set():
            i += 1
            rdv.set_worker_hosts([(wid, "") for wid in range(i % 3, i % 3 + 4)])
            time.sleep(0.0005)

    def poll(wid):
        try:
            while not stop.is_set():
                rdv.report_liveness(wid, f"10.0.0.{wid}", 0)
                resp = rdv.get_comm_rank(wid, f"10.0.0.{wid}")
                assert -1 <= resp.rank_id < max(1, resp.world_size)
                if resp.coordinator_addr:
                    assert resp.coordinator_addr.startswith("10.0.0."), resp.coordinator_addr
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=redeclare, name="rdv-redeclare", daemon=True)] + [
        threading.Thread(target=poll, args=(wid,), name=f"rdv-poll-{wid}", daemon=True)
        for wid in range(7)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert not errors, errors
    return rdv


@pytest.mark.parametrize("stress, name", [
    (_dispatch_churn_stress, "TaskManager._lock"),
    (_rendezvous_stress, "ElasticRendezvous._lock"),
], ids=["task_manager", "rendezvous"])
def test_service_stress_runs_clean_under_lockcheck(stress, name, lockcheck_enabled):
    service = stress()
    assert isinstance(service._lock, lockcheck.CheckedLock)
    assert service._lock.name == name
    report = lockcheck.report()
    assert report["acquisitions"] > 0, "lockcheck never engaged"
    assert name in report["max_hold_s"]
    lockcheck.assert_clean()


def test_services_create_checked_locks_with_jax_names(lockcheck_enabled):
    """Each lock the port creates through ``make_lock`` carries the JAX
    package's name for it (the port's ``BuildWatcher`` is JAX's
    ``RetraceWatcher`` under its own name)."""
    from elasticdl_tpu_torch import obs
    from elasticdl_tpu_torch.obs.history import MetricsHistory
    from elasticdl_tpu_torch.obs.journal import EventJournal
    from elasticdl_tpu_torch.obs.quality import DriftMonitor, QualityLedger, ReplayBuffer
    from elasticdl_tpu_torch.obs.stepstats import BuildWatcher, StepAnatomy
    from elasticdl_tpu_torch.serving.ledger import AvailabilityLedger, ExemplarSampler

    registry = obs.MetricsRegistry()
    made = {
        "EventJournal._lock": EventJournal()._lock,
        "MetricsRegistry._lock": registry._lock,
        "obs.Counter._lock": registry.counter("c", "c")._lock,
        "obs.RateTracker._lock": obs.RateTracker()._lock,
        "MetricsHistory._lock": MetricsHistory(registry=registry)._lock,
        "StepAnatomy._lock": StepAnatomy(0)._lock,
        "BuildWatcher._lock": BuildWatcher()._lock,
        "AvailabilityLedger._lock": AvailabilityLedger(registry=registry)._lock,
        "ExemplarSampler._lock": ExemplarSampler()._lock,
        "QualityLedger._lock": QualityLedger()._lock,
        "ReplayBuffer._lock": ReplayBuffer()._lock,
        "DriftMonitor._lock": DriftMonitor()._lock,
    }
    assert {name: lock.name for name, lock in made.items()} == {n: n for n in made}


def test_analysis_package_loads_no_analyzer():
    code = ("import sys; import elasticdl_tpu_torch.analysis.runtime; "
            "print(sorted(m for m in sys.modules if m.startswith('elasticdl_tpu_torch.analysis')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == str(["elasticdl_tpu_torch.analysis",
                                      "elasticdl_tpu_torch.analysis.runtime"])
