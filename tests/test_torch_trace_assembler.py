"""The port's trace assembler (``python -m elasticdl_tpu_torch.obs.trace``)
held to the JAX package's (``elasticdl_tpu.obs.trace``) on the same
journals: (i) the master and worker journals of a port CPU job and (ii)
the JAX assembler's ``--selftest`` fixture (two skewed workers, a task
chain, a serving waterfall).  Both give the same clock offsets, the same
spans and the same Chrome trace events, with times within 1e-6 s; and
the port's selftest and invariants hold."""

import subprocess
import sys

import pytest

from elasticdl_tpu.obs import trace as jax_trace
from elasticdl_tpu_torch.obs import trace as port_trace

from torch_obs_job import REPO, job_log, observed_job

#: Times: seconds within 1e-6 (the Chrome events are in microseconds).
TIME_ABS_S = 1e-6


def _assert_same_assembly(port, jax):
    assert port["sources"] == jax["sources"]
    assert port["clamped"] == jax["clamped"]
    assert port["invariant_problems"] == jax["invariant_problems"] == []
    assert sorted(port["offsets"]) == sorted(jax["offsets"])
    for label, info in jax["offsets"].items():
        got = port["offsets"][label]
        assert (got["method"], got["pairs"]) == (info["method"], info["pairs"])
        assert got["offset_s"] == pytest.approx(info["offset_s"], abs=TIME_ABS_S)
    assert len(port["spans"]) == len(jax["spans"])
    for got, want in zip(port["spans"], jax["spans"]):
        assert {k: v for k, v in got.items() if k not in ("start", "end")} == \
            {k: v for k, v in want.items() if k not in ("start", "end")}
        assert got["start"] == pytest.approx(want["start"], abs=TIME_ABS_S)
        assert got["end"] == pytest.approx(want["end"], abs=TIME_ABS_S)
    port_events, jax_events = port["chrome"]["traceEvents"], jax["chrome"]["traceEvents"]
    assert len(port_events) == len(jax_events)
    for got, want in zip(port_events, jax_events):
        assert {k: v for k, v in got.items() if k not in ("ts", "dur")} == \
            {k: v for k, v in want.items() if k not in ("ts", "dur")}
        for key in ("ts", "dur"):  # microseconds
            if key in want:
                assert got[key] == pytest.approx(want[key], abs=TIME_ABS_S * 1e6)
    assert port_trace.validate_chrome_trace(port["chrome"]) == []


def test_job_journals_assemble_as_jax_does(tmp_path_factory):
    root = observed_job(tmp_path_factory)
    assert (root / "rc").read_text() == "0", job_log(root)
    paths = [str(root / "tb")]
    port, jax = port_trace.assemble(paths), jax_trace.assemble(paths)
    assert port["sources"] == ["master", "worker_0"]
    # From the worker's heartbeats and the master's ingests (a midpoint
    # estimate from two round trips, else one-way, else none: a short job
    # may end before a heartbeat): near 0 on one host.
    assert port["offsets"]["worker_0"]["method"] in ("midpoint", "one_way", "none")
    assert abs(port["offsets"]["worker_0"]["offset_s"]) < 0.5
    _assert_same_assembly(port, jax)
    assert port_trace.render_waterfall(port["spans"]) == jax_trace.render_waterfall(jax["spans"])


def test_selftest_fixture_assembles_as_jax_does(monkeypatch):
    assembled = []
    jax_assemble = jax_trace.assemble

    def both(paths):
        jax = jax_assemble(paths)
        assembled.append((port_trace.assemble(paths), jax))
        return jax

    monkeypatch.setattr(jax_trace, "assemble", both)
    assert jax_trace._selftest() == 0
    (port, jax), = assembled
    assert port["clamped"] >= 1  # the fixture's child that escapes its root
    _assert_same_assembly(port, jax)
    for trace_id in ("lg-req-1", "lg-req-2"):
        assert [s["name"] for s in port_trace.request_chain(port["spans"], trace_id)] == \
            list(port_trace.SERVING_SPAN_ORDER)


def test_selftest_and_cli(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "elasticdl_tpu_torch.obs.trace", "--selftest"],
                          cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "trace selftest OK" in proc.stdout


def test_a_journal_cut_mid_span_still_clamps(tmp_path):
    """A SIGKILLed worker's journal ends mid-line and its flight recorder
    never ran: the torn line is dropped and every span still lies inside
    its parent."""
    t0 = 1_700_000_000.0
    master = [
        {"ts": t0, "event": "master_start"},
        {"ts": t0 + 5.0, "event": "span", "name": "task.lifetime", "start_ts": t0 + 1.0,
         "duration_s": 4.0, "span_id": "t-x-1", "trace_id": "t-x-1", "proc": "master",
         "error": "worker_churn"},
    ]
    worker = [
        {"ts": t0 + 2.0, "event": "span", "name": "worker.get_task", "start_ts": t0 + 0.9,
         "duration_s": 0.2, "span_id": "s-1", "parent_span_id": "t-x-1", "trace_id": "t-x-1",
         "proc": "worker_0"},
        {"ts": t0 + 6.0, "event": "span", "name": "checkpoint.save", "start_ts": t0 + 4.5,
         "duration_s": 3.0, "span_id": "s-2", "parent_span_id": "t-x-1", "trace_id": "t-x-1",
         "proc": "worker_0"},
    ]
    import json

    (tmp_path / "events.jsonl").write_text("".join(json.dumps(e) + "\n" for e in master))
    (tmp_path / "events_worker_0.jsonl").write_text(
        "".join(json.dumps(e) + "\n" for e in worker) + '{"ts": 17000000')
    port, jax = port_trace.assemble([str(tmp_path)]), jax_trace.assemble([str(tmp_path)])
    assert port["clamped"] == 2
    _assert_same_assembly(port, jax)
