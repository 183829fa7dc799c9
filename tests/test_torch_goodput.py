"""The port's goodput ledger (``elasticdl_tpu_torch/obs/goodput.py``)
against the JAX package's (``elasticdl_tpu/obs/goodput.py``).

Each scripted timeline (transitions, dispatches, completions, requeues,
rescales, straggler flags, scoped phases, a clock regression) drives a
ledger of each package on its own fake clock, and the two must agree
exactly: ``phase_seconds``, ``goodput_ratio``, ``counts``,
``last_rescale``, ``rescale_in_flight`` and every journal record (the
wall-clock ``ts`` aside).  ``seed_from_journal`` folds the repo's golden
journal into both with equal results.
"""

import json
import os

import pytest

from elasticdl_tpu import obs as jax_obs
from elasticdl_tpu.obs import goodput as jax_goodput
from elasticdl_tpu_torch import obs as port_obs
from elasticdl_tpu_torch.obs import goodput as port_goodput

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_journal.jsonl")


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# (method, args, kwargs) steps; ("advance", (seconds,), {}) moves the clock.
TIMELINES = {
    "churn_then_repaid_redo": [
        ("transition", ("idle",), {"cause": "master_start"}),
        ("advance", (1.5,), {}),
        ("on_world_declared", (1, 2), {}),
        ("advance", (2.25,), {}),
        ("on_world_formed", (1,), {}),
        ("note_dispatch", (), {}),
        ("advance", (4.0,), {}),
        ("note_task_done", (), {"records": 128}),
        ("note_dispatch", (), {}),
        ("advance", (1.0,), {}),
        ("on_rescale_detected", ("worker_churn", 2), {}),
        ("note_requeue", (128, "worker_churn"), {"tasks": 1}),
        ("advance", (0.5,), {}),
        ("on_drain_complete", (1,), {}),
        ("advance", (0.25,), {}),
        ("on_world_declared", (2, 1), {}),
        ("advance", (3.0,), {}),
        ("on_world_formed", (2,), {}),
        ("note_dispatch", (), {}),
        ("advance", (2.0,), {}),
        ("note_task_done", (), {"records": 64}),
        ("advance", (1.0,), {}),
        ("note_task_done", (), {"records": 64}),
        ("note_dispatch", (), {}),
        ("advance", (5.0,), {}),
        ("note_task_done", (), {"records": 128}),
        ("advance", (0.5,), {}),
        ("finish", ("job_complete",), {"restarts_used": 1}),
    ],
    "superseded_back_to_back_churn": [
        ("transition", ("training",), {"cause": "task_dispatch"}),
        ("advance", (3.0,), {}),
        ("on_rescale_detected", ("worker_churn", 3), {}),
        ("note_requeue", (256, "worker_churn"), {"tasks": 2}),
        ("advance", (1.0,), {}),
        ("on_drain_complete", (3,), {}),
        ("advance", (0.5,), {}),
        ("on_rescale_detected", ("worker_churn", 3), {}),
        ("advance", (0.75,), {}),
        ("on_world_declared", (3, 2), {}),
        ("advance", (1.0,), {}),
        ("note_dispatch", (), {}),
        ("advance", (2.0,), {}),
        ("note_task_done", (), {"records": 256}),
        ("advance", (1.0,), {}),
        ("finish", (), {}),
    ],
    "scale_up_waits_in_scaling_wait": [
        ("transition", ("training",), {}),
        ("advance", (10.0,), {}),
        ("on_rescale_detected", ("scale_up", 2), {}),
        ("advance", (1.0,), {}),
        ("on_drain_complete", (3,), {}),
        ("on_world_declared", (4, 3), {}),
        ("advance", (2.0,), {}),
        ("on_world_formed", (4,), {}),
        ("note_dispatch", (), {}),
        ("advance", (4.0,), {}),
        ("note_task_done", (), {"records": 32}),
        ("finish", (), {}),
    ],
    "stragglers_degrade_training": [
        ("transition", ("training",), {}),
        ("advance", (2.0,), {}),
        ("on_straggler", (7, True), {}),
        ("advance", (3.0,), {}),
        ("on_straggler", (8, True), {}),
        ("on_straggler", (7, False), {}),
        ("advance", (1.0,), {}),
        ("on_straggler", (8, False), {}),
        ("advance", (4.0,), {}),
        ("note_dispatch", (), {}),
        ("finish", ("job_complete",), {}),
    ],
    "failure_and_timeout_requeues": [
        ("note_dispatch", (), {}),
        ("advance", (2.0,), {}),
        ("note_requeue", (100, "failure"), {}),
        ("note_requeue", (0, "timeout"), {}),
        ("note_dispatch", (), {}),
        ("advance", (3.0,), {}),
        ("note_task_done", (), {"records": 40}),
        ("advance", (1.0,), {}),
        ("note_task_done", (), {"records": 0, "training": False}),
        ("note_task_done", (), {"records": 60}),
        ("advance", (2.0,), {}),
        ("finish", (), {}),
    ],
    "scoped_phases_and_clock_regression": [
        ("transition", ("training",), {}),
        ("advance", (1.0,), {}),
        ("phase", ("checkpoint_save",), {"cause": "cadence"}),
        ("advance", (2.0,), {}),
        ("phase", ("checkpoint_restore",), {"cause": "boot"}),
        ("advance", (-5.0,), {}),
        ("transition", ("idle",), {}),
        ("advance", (7.0,), {}),
        ("transition", ("rendezvous",), {}),
        ("advance", (1.0,), {}),
        ("finish", ("job_failed",), {}),
    ],
}


@pytest.fixture
def journals(tmp_path):
    """Each package's process journal on its own file."""
    paths = {"jax": jax_obs.init_journal(str(tmp_path / "jax")),
             "port": port_obs.init_journal(str(tmp_path / "port"))}
    yield paths
    jax_obs.journal().configure(None)
    port_obs.journal().configure(None)


def _records(path):
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    for record in records:
        record.pop("ts")
    return records


def _run(module, steps):
    clock = FakeClock()
    ledger = module.GoodputLedger(clock=clock)
    observed = []
    for name, args, kwargs in steps:
        if name == "advance":
            clock.t += args[0]
        elif name == "phase":
            # A scoped phase held across the next step, then closed.
            frame = ledger.phase(*args, **kwargs)
            frame.__enter__()
            observed.append(("open", ledger.current_phase()))
            clock.t += 0.125
            frame.__exit__(None, None, None)
        else:
            getattr(ledger, name)(*args, **kwargs)
        observed.append((name, ledger.current_phase(), ledger.rescale_in_flight(),
                         ledger.counts()))
    return ledger, observed


@pytest.mark.parametrize("timeline", sorted(TIMELINES))
def test_port_ledger_books_the_jax_ledger_timeline(timeline, journals):
    jax_ledger, jax_seen = _run(jax_goodput, TIMELINES[timeline])
    port_ledger, port_seen = _run(port_goodput, TIMELINES[timeline])
    assert port_seen == jax_seen
    assert port_ledger.phase_seconds() == jax_ledger.phase_seconds()
    assert port_ledger.goodput_ratio() == jax_ledger.goodput_ratio()
    assert port_ledger.counts() == jax_ledger.counts()
    assert port_ledger.last_rescale() == jax_ledger.last_rescale()
    assert (port_ledger.seconds_since_last_rescale()
            == jax_ledger.seconds_since_last_rescale())
    jax_records, port_records = _records(journals["jax"]), _records(journals["port"])
    assert port_records == jax_records
    kinds = [r["event"] for r in port_records]
    assert kinds[-1] == "goodput_summary" and "phase_transition" in kinds
    for record in port_records:
        assert port_obs.missing_fields(record) == ()
    summary = port_records[-1]
    assert summary["wall_s"] == pytest.approx(sum(summary["phases"].values()), rel=1e-6)


def test_rescale_cost_is_split_into_detection_rendezvous_and_redo(journals):
    port_ledger, _ = _run(port_goodput, TIMELINES["churn_then_repaid_redo"])
    costs = [r for r in _records(journals["port"]) if r["event"] == "rescale_cost"]
    assert len(costs) == 1
    cost = costs[0]
    assert (cost["cause"], cost["old_size"], cost["new_size"]) == ("worker_churn", 2, 1)
    assert (cost["detection_s"], cost["rendezvous_s"]) == (0.5, 3.25)
    assert cost["redo_s"] == 3.0 and cost["total_s"] == 6.75
    assert cost["redo_records"] == 128 and cost["redo_tasks"] == 1
    assert port_ledger.phase_seconds()["requeue_redo"] == 3.0


@pytest.mark.parametrize("phase_seconds_before", [0.0, 12.5])
def test_seed_from_the_golden_journal_matches_jax(phase_seconds_before, journals):
    jax_clock, port_clock = FakeClock(), FakeClock()
    jax_ledger = jax_goodput.GoodputLedger(clock=jax_clock)
    port_ledger = port_goodput.GoodputLedger(clock=port_clock)
    for ledger, clock in ((jax_ledger, jax_clock), (port_ledger, port_clock)):
        ledger.transition("training")
        clock.t += phase_seconds_before
        ledger.transition("idle")
    assert port_ledger.seed_from_journal(GOLDEN) == jax_ledger.seed_from_journal(GOLDEN) > 0
    assert port_ledger.phase_seconds() == jax_ledger.phase_seconds()
    assert port_ledger.counts() == jax_ledger.counts()
    assert port_ledger.goodput_ratio() == jax_ledger.goodput_ratio()
    assert port_goodput.GoodputLedger().seed_from_journal(GOLDEN + ".missing") == 0


def test_process_ledger_rebinds_the_ratio_gauge():
    ledger = port_goodput.reset_ledger()
    assert port_goodput.ledger() is ledger
    gauge = port_obs.registry().get("elasticdl_goodput_ratio")
    assert gauge.value() == 0.0
    fresh = port_goodput.reset_ledger()
    assert fresh is not ledger and port_goodput.ledger() is fresh
