"""The port's offline report (``python -m elasticdl_tpu_torch.obs.report``)
and live table (``python -m elasticdl_tpu_torch.obs.top``) held to the
JAX package's: ``report --json`` equals JAX's summary on
``tests/golden_journal.jsonl`` and on the master journal of a port CPU
job (counts exact, seconds within 1e-9), the selftest holds on both, and
``--scrape`` joins a live ``/metrics``; ``top --once`` renders the same
frame as JAX's from a stub exporter (worker rows, the SLO header, the
serving table) and prints a status line, never a crash, when the
exporter is unreachable."""

import json
import socket
import subprocess
import sys
import time

import pytest

from elasticdl_tpu.obs import report as jax_report
from elasticdl_tpu.obs import top as jax_top
from elasticdl_tpu_torch.obs import report as port_report
from elasticdl_tpu_torch.obs import slo as port_slo
from elasticdl_tpu_torch.obs import top as port_top
from elasticdl_tpu_torch.obs.exporter import MetricsExporter
from elasticdl_tpu_torch.obs.journal import EventJournal
from elasticdl_tpu_torch.obs.metrics import MetricsRegistry

from torch_obs_job import REPO, events, job_log, observed_job

SECONDS_ABS = 1e-9
GOLDEN = REPO / "tests" / "golden_journal.jsonl"


def _close(got, want, path="summary"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _close(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, abs=SECONDS_ABS), path
    else:
        assert got == want, path


def _port_report_json(journal, tmp_path, *extra):
    out = tmp_path / "summary.json"
    proc = subprocess.run([sys.executable, "-m", "elasticdl_tpu_torch.obs.report",
                           str(journal), "--json", str(out), *extra],
                          cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(out.read_text()), proc.stdout


def test_report_json_matches_jax_on_the_golden_journal(tmp_path):
    got, text = _port_report_json(GOLDEN, tmp_path)
    want = json.loads(json.dumps(jax_report.summarize(jax_report.load_events(str(GOLDEN))),
                                 default=str))
    _close(got, want)
    assert len(got["rescales"]) == 1 and 0 < got["goodput_ratio"] <= 1
    assert port_report.render_report(port_report.summarize(port_report.load_events(
        str(GOLDEN)))) == jax_report.render_report(want)
    assert "goodput" in text
    assert port_report.selftest(str(GOLDEN)) == 0


def test_report_json_matches_jax_on_a_port_job(tmp_path, tmp_path_factory):
    root = observed_job(tmp_path_factory)
    assert (root / "rc").read_text() == "0", job_log(root)
    journal = root / "tb" / "events.jsonl"
    got, _ = _port_report_json(journal, tmp_path)
    want = json.loads(json.dumps(jax_report.summarize(jax_report.load_events(str(journal))),
                                 default=str))
    _close(got, want)
    assert 0 < got["goodput_ratio"] <= 1
    # The step anatomy reaches the master's journal at most every 10 s a
    # worker: a short job may end before one.
    assert "compute" not in got or got["compute"]["workers"]
    assert got["slo"]["slos"][0]["slo"] == "goodput"
    # The phases cover the wall clock.
    assert sum(got["phases"].values()) == pytest.approx(got["wall_s"], rel=1e-6)
    assert port_report.selftest(str(journal)) == 0
    # The worker's journal points at its profiler trace.
    windows = [e for e in events(root / "tb" / "events_worker_0.jsonl")
               if e["event"] == "profile_window"]
    assert [w["action"] for w in windows] == ["open", "close"]


def test_report_scrape_joins_live_metrics(tmp_path):
    registry = MetricsRegistry()
    registry.gauge("elasticdl_goodput_ratio", "").set(0.5)
    exporter = MetricsExporter(registry=registry, journal=EventJournal(),
                               host="127.0.0.1").start()
    try:
        got, text = _port_report_json(GOLDEN, tmp_path, "--scrape",
                                      f"127.0.0.1:{exporter.port}")
    finally:
        exporter.stop()
    assert got["metrics_goodput_ratio"] == 0.5
    assert "/metrics elasticdl_goodput_ratio: 0.5" in text


T0 = 1_800_000_000.0


@pytest.fixture
def stub_exporter():
    """A master-shaped exporter: fleet gauges, two workers' telemetry and
    anatomy in the journal, a goodput SLO plane; and a replica's
    serving telemetry."""
    registry, journal = MetricsRegistry(), EventJournal()
    registry.gauge("elasticdl_goodput_ratio", "").set(0.875)
    registry.gauge("elasticdl_fleet_examples_per_second", "").set(1234.5)
    registry.gauge("elasticdl_world_size", "").set(2)
    for wid, step_s in ((0, 0.02), (1, 0.03)):
        journal.record("worker_telemetry", worker_id=wid, step=40 + wid, step_p50_s=step_s,
                       step_p95_s=step_s * 1.5, examples_s=1000.0 + wid, data_wait_s=0.1,
                       host="h", task_id=3 + wid, rendezvous_id=2, worker_ts=T0)
        journal.record("step_anatomy", worker_id=wid,
                       totals={"data_wait": 0.5, "stage": 0.1, "compile": 1.0,
                               "execute": 4.0 + wid, "bookkeep": 0.2},
                       steps=40, examples=1280, dominant_phase="execute")
    journal.record("serving_telemetry", replica_id=0, generation=2, step=40, inflight=0,
                   queue_depth=1, qps=250.0, p50_ms=1.5, p99_ms=4.25, availability_ratio=1.0,
                   served=500, dropped=0, shed=0, errors=0, queue_p99_ms=0.5,
                   batch_p99_ms=0.25, execute_p99_ms=3.0, respond_p99_ms=0.1,
                   exemplar={"trace_id": "lg-9", "latency_ms": 4.5, "dominant_phase": "execute"})
    plane = port_slo.SLOPlane(registry=registry, specs=[port_slo.goodput_slo(0.5)],
                              origin="master")
    for tick in range(4):
        plane.tick(float(tick))
    exporter = MetricsExporter(registry=registry, journal=journal, host="127.0.0.1",
                               slo_plane=plane).start()
    try:
        yield f"127.0.0.1:{exporter.port}"
    finally:
        exporter.stop()


@pytest.mark.parametrize("serving", [False, True], ids=["workers", "serving"])
def test_top_frame_matches_jax(stub_exporter, monkeypatch, serving):
    monkeypatch.setattr(time, "time", lambda: T0 + 5.0)  # the rows' age column
    frame = port_top.snapshot_frame(stub_exporter, serving=serving)
    assert frame == jax_top.snapshot_frame(stub_exporter, serving=serving)
    if serving:
        assert "lg-9" in frame
    else:
        lines = frame.splitlines()
        assert any(line.split()[:1] == ["0"] for line in lines), frame
        assert any(line.split()[:1] == ["1"] for line in lines), frame
        assert "goodput" in frame


def test_top_once_cli_and_an_unreachable_exporter(stub_exporter):
    proc = subprocess.run([sys.executable, "-m", "elasticdl_tpu_torch.obs.top", "--addr",
                           stub_exporter, "--once"],
                          cwd=str(REPO), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    rows = [line.split()[0] for line in proc.stdout.splitlines()[3:] if line.strip()]
    assert "WORKER" in proc.stdout and rows[:2] == ["0", "1"], proc.stdout
    with socket.socket() as s:  # a port nobody listens on
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    proc = subprocess.run([sys.executable, "-m", "elasticdl_tpu_torch.obs.top", "--addr", dead,
                           "--once"], cwd=str(REPO), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "unreachable" in proc.stdout, proc.stdout + proc.stderr
