"""The port's worker telemetry plane (``elasticdl_tpu_torch/obs/telemetry.py``)
against the JAX package's (``elasticdl_tpu/obs/telemetry.py``).

Identical snapshot streams through both aggregators, each on its own
fake clock, flag and clear the same stragglers with the same evidence
and journal the same records; the snapshot JSON is one wire format, so
a snapshot either package's ``WorkerTelemetry`` writes is read alike by
both aggregators.  The heartbeat (``parallel/elastic.HeartbeatReporter``,
at a short interval) carries the snapshot and journals a clock probe,
and a failing snapshot sends an empty one without stopping the beat.
"""

import copy
import json
import threading

import pytest

from elasticdl_tpu import obs as jax_obs
from elasticdl_tpu.obs import stepstats as jax_ss
from elasticdl_tpu.obs import telemetry as jax_tm
from elasticdl_tpu_torch import obs as port_obs
from elasticdl_tpu_torch.obs import stepstats as port_ss
from elasticdl_tpu_torch.obs import telemetry as port_tm


def _snap(wid, p50=None, examples=10.0, **extra):
    snap = {"v": 1, "worker_id": wid, "ts": 1000.0 + wid, "examples_per_s": examples, **extra}
    if p50 is not None:
        snap["step_p50_s"] = p50
        snap["step_p95_s"] = p50 * 1.5
    return json.dumps(snap)


# (seconds to advance, worker id, snapshot json) per ingest.
def _fleet(rounds, slow=None, silent_after=None, workers=(0, 1, 2, 3), slow_p50=0.2):
    stream = []
    for r, p50s in enumerate(rounds):
        for wid in workers:
            if silent_after is not None and wid == slow and r >= silent_after:
                continue
            p50 = slow_p50 if (wid == slow and p50s) else 0.01 + 0.0005 * wid
            anatomy = {"totals": {"data_wait": 8.0 if wid == slow else 1.0, "execute": 2.0}}
            stream.append((1.0, wid, _snap(wid, p50=p50, anatomy=anatomy)))
    return stream


STREAMS = {
    "slow_worker_flags_then_clears": _fleet([1, 1, 1, 0, 0, 0], slow=2),
    "one_noisy_sample_does_not_flag": _fleet([1, 0, 0, 0], slow=1),
    "slow_then_silent_flags_by_staleness": _fleet([1] * 12, slow=3, silent_after=1),
    "under_min_workers_stays_silent": _fleet([1, 1, 1], slow=1, workers=(0, 1)),
    "tight_healthy_fleet": _fleet([0] * 5),
}


@pytest.fixture
def journals(tmp_path):
    paths = {"jax": jax_obs.init_journal(str(tmp_path / "jax")),
             "port": port_obs.init_journal(str(tmp_path / "port"))}
    yield paths
    jax_obs.journal().configure(None)
    port_obs.journal().configure(None)


def _records(path, kinds=None):
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    for record in records:
        record.pop("ts")
    return [r for r in records if kinds is None or r["event"] in kinds]


def _drive(module, stream, current=None):
    clock = {"t": 100.0}
    transitions = []
    aggregator = module.TelemetryAggregator(
        detector=module.StragglerDetector(flag_after=2, clear_after=2),
        current_workers_fn=(lambda: list(current)) if current is not None else None,
        journal_interval_s=5.0, clock=lambda: clock["t"])
    aggregator.add_straggler_callback(
        lambda wid, flagged, evidence: transitions.append((wid, flagged, dict(evidence))))
    for advance, wid, payload in stream:
        clock["t"] += advance
        aggregator.ingest(wid, payload)
    return aggregator, transitions


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_port_aggregator_flags_the_jax_stragglers(stream, journals):
    jax_agg, jax_flags = _drive(jax_tm, STREAMS[stream])
    port_agg, port_flags = _drive(port_tm, STREAMS[stream])
    assert port_flags == jax_flags
    assert port_agg.stragglers() == jax_agg.stragglers()
    assert port_agg.worker_snapshots() == jax_agg.worker_snapshots()
    assert port_agg.fleet_attribution() == jax_agg.fleet_attribution()
    kinds = {"straggler_detected", "straggler_cleared", "worker_telemetry", "step_anatomy"}
    port_records = _records(journals["port"], kinds)
    assert port_records == _records(journals["jax"], kinds)
    for record in port_records:
        assert port_obs.missing_fields(record) == ()
    if stream == "slow_worker_flags_then_clears":
        assert [(w, f) for w, f, _ in port_flags] == [(2, True), (2, False)]
        assert port_flags[0][2]["dominant_phase"] == "data_wait"
    if stream == "slow_then_silent_flags_by_staleness":
        assert port_flags and port_flags[0][2]["metric"] == "staleness"
    if stream in ("one_noisy_sample_does_not_flag", "under_min_workers_stays_silent",
                  "tight_healthy_fleet"):
        assert port_flags == []


def test_departed_workers_drop_from_both_aggregators(journals):
    stream = STREAMS["slow_worker_flags_then_clears"][:12]
    jax_agg, _ = _drive(jax_tm, stream, current=[0, 1, 3])
    port_agg, _ = _drive(port_tm, stream, current=[0, 1, 3])
    assert sorted(port_agg.worker_snapshots()) == [0, 1, 3]
    assert port_agg.worker_snapshots() == jax_agg.worker_snapshots()


@pytest.mark.parametrize("values", [
    [0.010, 0.011, 0.012, 0.5], [1.0, 1.0, 1.0], [0.2, 0.4], [5.0, 0.0, 2.5, 7.5, 100.0]])
def test_detector_threshold_matches_jax(values):
    assert (port_tm.StragglerDetector().threshold(values, 1e-3)
            == jax_tm.StragglerDetector().threshold(values, 1e-3))


PAYLOADS = {
    "full": {"v": 1, "worker_id": 0, "ts": 5.5, "rendezvous_id": 3, "steps_total": 12,
             "records_total": 768, "step_p50_s": 0.1, "step_p95_s": 0.2,
             "examples_per_s": 640.0, "task": {"id": 9, "type": "TRAINING",
                                               "records_done": 64, "records_total": 128},
             "rpc": {"retries": 2, "give_ups": 0},
             "anatomy": {"totals": {"execute": 1.0}, "bound": "compute"}},
    "unknown_version": {"v": 2, "worker_id": 0},
    "string_number": {"v": 1, "step_p50_s": "fast"},
    "bool_number": {"v": 1, "examples_per_s": True},
    "bad_task": {"v": 1, "task": {"id": "seven"}},
    "bad_rpc": {"v": 1, "rpc": ["retries"]},
    "spoofed_event_dropped": {"v": 1, "event": "spoofed", "surprise": {"a": 1}},
    "broken_anatomy_degrades": {"v": 1, "step_p50_s": 0.1, "anatomy": {"windows": ["x"]}},
    "long_task_type": {"v": 1, "task": {"type": "T" * 80}},
}


@pytest.mark.parametrize("case", sorted(PAYLOADS))
def test_sanitize_snapshot_matches_jax(case):
    payload = PAYLOADS[case]
    assert (port_tm.sanitize_snapshot(copy.deepcopy(payload))
            == jax_tm.sanitize_snapshot(copy.deepcopy(payload)))


class _Stats:
    retries = 4
    give_ups = 1


def _filled(module, ss_module, windows=3, task_type="TRAINING"):
    telemetry = module.WorkerTelemetry(7)
    telemetry.bind_retry_stats(_Stats())
    telemetry.set_rendezvous(2)
    telemetry.begin_task(11, task_type, 512)
    clock = {"t": 0.0}
    anatomy = ss_module.StepAnatomy(7, clock=lambda: clock["t"])
    for _ in range(windows):
        with anatomy.phase("data_wait"):
            clock["t"] += 0.5
        with anatomy.dispatch(8, 512):
            clock["t"] += 1.0
        anatomy.close_window()
    telemetry.bind_anatomy(anatomy)
    telemetry.record_steps(8, 1.6, records=512)
    telemetry.record_steps(8, 0.8, records=512)
    return telemetry


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_read_both_ways(writer, obs_registry_snapshot):
    telemetry = (_filled(jax_tm, jax_ss) if writer == "jax" else _filled(port_tm, port_ss))
    payload = telemetry.snapshot_json()
    jax_agg = jax_tm.TelemetryAggregator(journal_interval_s=1e9)
    port_agg = port_tm.TelemetryAggregator(journal_interval_s=1e9)
    jax_agg.ingest(7, payload)
    port_agg.ingest(7, payload)
    read = port_agg.worker_snapshots()
    assert read == jax_agg.worker_snapshots() and 7 in read
    snap = read[7]
    assert snap["rendezvous_id"] == 2 and snap["steps_total"] == 16
    assert snap["task"] == {"id": 11, "type": "TRAINING", "records_done": 1024,
                            "records_total": 512}
    assert snap["rpc"] == {"retries": 4, "give_ups": 1}
    assert snap["anatomy"]["totals"] == {"data_wait": 1.5, "execute": 3.0}
    assert snap["step_p50_s"] == pytest.approx(0.2)


def test_both_writers_write_the_same_snapshot():
    jax_snap = json.loads(_filled(jax_tm, jax_ss).snapshot_json())
    port_snap = json.loads(_filled(port_tm, port_ss).snapshot_json())
    for snap in (jax_snap, port_snap):
        snap.pop("ts")
        snap["anatomy"].pop("mem_hwm_mb", None)
    assert port_snap == jax_snap


@pytest.mark.parametrize("windows,task_type", [(5, "T" * 32), (5, "TRAINING")])
def test_size_budget_trims_like_jax(monkeypatch, windows, task_type):
    for module in (jax_tm, port_tm):
        monkeypatch.setattr(module, "MAX_SNAPSHOT_BYTES", 600)
    jax_snap = json.loads(_filled(jax_tm, jax_ss, windows, task_type).snapshot_json())
    port_snap = json.loads(_filled(port_tm, port_ss, windows, task_type).snapshot_json())
    for snap in (jax_snap, port_snap):
        snap.pop("ts", None)
    assert port_snap == jax_snap
    assert len(json.dumps(port_snap, separators=(",", ":"))) <= 600


class _Client:
    worker_id = 4

    def __init__(self):
        self.payloads = []
        self.beat = threading.Event()

    def report_worker_liveness(self, host, rendezvous_id, telemetry_json=""):
        self.payloads.append(telemetry_json)
        if len(self.payloads) >= 3:
            self.beat.set()
        return False


class _BrokenTelemetry:
    last_snapshot_ts = 0.0

    def snapshot_json(self):
        raise RuntimeError("snapshot failed")


@pytest.mark.parametrize("broken", [False, True])
def test_heartbeat_carries_the_snapshot_and_a_clock_probe(broken, tmp_path):
    from elasticdl_tpu_torch.parallel.elastic import HeartbeatReporter, WorldInfo

    client = _Client()
    telemetry = _BrokenTelemetry() if broken else _filled(port_tm, port_ss)
    path = port_obs.init_journal(str(tmp_path))
    reporter = HeartbeatReporter(client, WorldInfo(0, 1, 2, ""), host="h", interval_s=0.02,
                                 telemetry=telemetry, jitter=0.0).start()
    try:
        assert client.beat.wait(10)
    finally:
        reporter.stop()
        port_obs.journal().configure(None)
    probes = [r for r in _records(path) if r["event"] == "clock_probe"]
    if broken:
        assert set(client.payloads) == {""} and probes == []
        assert reporter.error_count == 0
        return
    snap = json.loads(client.payloads[0])
    assert snap["worker_id"] == 7 and snap["v"] == 1
    assert probes and probes[0]["worker_id"] == 4
    assert port_obs.missing_fields(probes[0]) == ()
    assert probes[0]["t_send"] <= probes[0]["t_recv"]
