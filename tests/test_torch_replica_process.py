"""The port's replica process (``python -m elasticdl_tpu_torch.serving.
replica_main``) and its HTTP edge, on the CPU, against the JAX package.

A JAX ``ShardedEmbeddingTrainer`` (DeepFM, vocab 100 per field,
``embedding_dim`` 4, ``hidden`` 16) publishes a full through JAX's
``DeltaExporter``; a replica subprocess (``--device cpu``) serves it,
shows in ``live_replicas``, answers ``/predict`` within rtol 1e-5 of the
JAX ``ServingReplica.execute``, follows a delta published while it runs
(the first apply rolled back by ``ELASTICDL_FAULTS``, the next poll
applies it) and exits 0 on SIGTERM.  Every wait on the subprocess has
its own timeout.  Then, in process: the transport's statuses (429, 504,
400, 500, 404), the client's retries against JAX's backoff schedule, the
exporter's endpoints, and the replica's flags against JAX's.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.checkpoint import delta as jax_delta
from elasticdl_tpu.common import grpc_utils
from elasticdl_tpu.parallel.mesh import MeshConfig, build_mesh
from elasticdl_tpu.parallel.ps_trainer import ShardedEmbeddingTrainer as JaxTrainer
from elasticdl_tpu.serving import replica_main as jax_replica_main
from elasticdl_tpu.serving.runtime import ServingReplica as JaxReplica
from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
from elasticdl_tpu_torch.obs.exporter import MetricsExporter
from elasticdl_tpu_torch.serving import replica_main
from elasticdl_tpu_torch.serving.batcher import BatcherConfig, MicroBatcher
from elasticdl_tpu_torch.serving.frontend import (
    DEADLINE_HEADER, PredictClient, PredictError, ServingFrontend, encode_features)
from model_zoo.deepfm import deepfm_functional_api as zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_DEF = "deepfm.deepfm_functional_api"
PARAMS = "vocab_size=100,embedding_dim=4,hidden=16"
WAIT_S = 60.0


def _batches(n, rows=16, seed=3):
    feats, labels = synthetic_ctr_arrays(rows * n, vocab_size=100, seed=seed)
    return [({k: v[i * rows:(i + 1) * rows] for k, v in feats.items()},
             labels[i * rows:(i + 1) * rows]) for i in range(n)]


def _wait_for(what, predicate, timeout_s=WAIT_S, proc=None):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"replica exited {proc.returncode} waiting for {what}: "
                                 f"{proc.stderr.read()[-4000:]}")
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s} s waiting for {what}")


def _journal(serve_dir, event):
    with open(os.path.join(serve_dir, "events.jsonl")) as f:
        return [r for r in map(json.loads, filter(str.strip, f)) if r["event"] == event]


def test_replica_process_serves_follows_a_delta_and_exits_on_sigterm(tmp_path):
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    trainer = JaxTrainer(zoo.custom_model(vocab_size=100, embedding_dim=4, hidden=16),
                         zoo.loss, zoo.optimizer(lr=0.01), mesh,
                         embedding_optimizer=zoo.embedding_optimizer(lr=0.01))
    batches = _batches(4)
    trainer.train_step(*batches[0])
    pub, serve = str(tmp_path / "pub"), str(tmp_path / "serve")
    exporter = jax_delta.DeltaExporter(pub, model_zoo="model_zoo", model_def=MODEL_DEF,
                                       model_params=PARAMS)
    full = exporter.publish_full(trainer, event_time=1.0)
    held_out = _batches(1, rows=16, seed=9)[0][0]
    warmup = str(tmp_path / "warmup.npz")
    with open(warmup, "wb") as f:
        f.write(encode_features({k: v[:1] for k, v in held_out.items()}))  # one example
    env = dict(os.environ, ELASTICDL_FAULTS="serving.delta_apply:error=injected@1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serving.replica_main", "--model_dir", full,
         "--pub_dir", pub, "--serve_dir", serve, "--device", "cpu", "--max_batch_size", "16",
         "--pub_poll_interval_s", "0.2", "--telemetry_interval_s", "0.2",
         "--warmup_features", warmup],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    client = None
    try:
        info = _wait_for("live_replicas", lambda: replica_main.live_replicas(serve), proc=proc)
        assert [i["pid"] for i in info] == [proc.pid]
        client = PredictClient(f"127.0.0.1:{info[0]['port']}", deadline_s=WAIT_S)
        jax_replica = JaxReplica(full, model_zoo="model_zoo")
        np.testing.assert_allclose(client.predict(held_out),
                                   jax_replica.execute(held_out, n_valid=16), rtol=1e-5, atol=1e-6)
        for batch in batches[1:3]:
            trainer.train_step(*batch)
        link = exporter.publish_delta(trainer, event_time=2.0)
        stats = _wait_for("the delta's step", lambda: (lambda s: s if s["step"] == 3 else None)(
            client.stats()), proc=proc)
        assert stats["model_event_time"] == 2.0 and stats["ledger"]["counts"]["error"] == 0
        jax_replica.apply_delta(link)
        np.testing.assert_allclose(client.predict(held_out),
                                   jax_replica.execute(held_out, n_valid=16), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(client.predict(held_out), trainer.eval_step(held_out),
                                   rtol=1e-5, atol=1e-6)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
        proc.stderr.close()
    start = _journal(serve, "serving_replica_start")
    assert len(start) == 1 and start[0]["forbidden_modules"] == [] and start[0]["device"] == "cpu"
    swaps = [(e["kind"], e["outcome"], e["step"]) for e in _journal(serve, "model_swap")]
    assert swaps == [("delta", "rolled_back", 1), ("delta", "applied", 3)]
    last = _journal(serve, "serving_telemetry")[-1]
    assert (last["served"], last["errors"], last["shed"], last["dropped"]) == (3, 0, 0, 0)
    assert last["step"] == 3 and last["model_event_time"] == 2.0
    assert all(not obs.missing_fields(e) for e in start + _journal(serve, "model_swap"))
    assert replica_main.live_replicas(serve) == []  # its pid is gone


class _StubReplica:
    def __init__(self, fail=False):
        self.fail = fail

    def execute(self, features, n_valid):
        if self.fail:
            raise RuntimeError("device on fire")
        return features["x"][:, 0] + 1.0

    def stats(self):
        return {"generation": 1, "step": 0, "model_event_time": 0.0}


@pytest.fixture
def edge():
    """Start a frontend over a stub replica; stop everything after."""
    started = []

    def start(replica, batcher, run=True):
        if run:
            batcher.start()
        front = ServingFrontend(replica, batcher, host="127.0.0.1")
        started.append((front, batcher))
        return front.start()

    yield start
    for front, batcher in started:
        front.stop()
        batcher.stop()


def _raw(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        response = conn.getresponse()
        return response.status, response.read()
    finally:
        conn.close()


def test_transport_statuses(edge):
    x = {"x": np.arange(4, dtype=np.float32).reshape(4, 1)}
    port = edge(_StubReplica(), MicroBatcher(_StubReplica().execute, BatcherConfig(8, 100, 8)))
    client = PredictClient(f"127.0.0.1:{port}", deadline_s=WAIT_S)
    np.testing.assert_array_equal(client.predict(x), np.arange(4, dtype=np.float32) + 1.0)
    assert _raw(port, "/predict", b"junk")[0] == 400
    assert _raw(port, "/slo", b"")[0] == 404  # the predict edge serves no /slo
    with pytest.raises(PredictError) as err:
        client.predict({"x": np.zeros((9, 1), np.float32)})  # rows > max_batch_size
    assert (err.value.code, err.value.status) == ("INVALID_ARGUMENT", 400)
    # Execute fails: INTERNAL.
    bad = edge(_StubReplica(), MicroBatcher(_StubReplica(fail=True).execute,
                                            BatcherConfig(8, 100, 8)))
    with pytest.raises(PredictError) as err:
        PredictClient(f"127.0.0.1:{bad}").predict(x)
    assert (err.value.code, err.value.status) == ("INTERNAL", 500)
    assert "device on fire" in str(err.value)
    # A full queue sheds: RESOURCE_EXHAUSTED, never retried.
    full = edge(_StubReplica(), MicroBatcher(_StubReplica().execute, BatcherConfig(8, 100, 0)))
    shed_client = PredictClient(f"127.0.0.1:{full}")
    with pytest.raises(PredictError) as err:
        shed_client.predict(x)
    assert (err.value.code, err.value.status, shed_client.retries) == (
        "RESOURCE_EXHAUSTED", 429, 0)
    # Nobody drains the queue: the server's deadline lapses, 504.
    stuck = edge(_StubReplica(), MicroBatcher(_StubReplica().execute, BatcherConfig(8, 100, 8)),
                 run=False)
    status, body = _raw(stuck, "/predict", encode_features(x), {DEADLINE_HEADER: "0.2"})
    assert status == 504 and json.loads(body)["code"] == "DEADLINE_EXCEEDED"
    client.close()


def test_client_retries_a_refused_connection_on_jax_schedule():
    import socket

    with socket.socket() as s:  # a port nobody listens on
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    sleeps = []
    client = PredictClient(addr, deadline_s=1.0, sleep=sleeps.append)
    with pytest.raises(ConnectionRefusedError):
        client.predict({"x": np.zeros((1, 1), np.float32)})
    policy = grpc_utils.IDEMPOTENT_POLICY
    assert len(sleeps) == policy.max_attempts - 1 == client.retries
    assert tuple(sleeps) == grpc_utils.expected_backoff_schedule("predict", policy, len(sleeps),
                                                                 seed=addr)


def test_exporter_endpoints_and_port_file(tmp_path):
    registry = obs.MetricsRegistry()
    registry.counter("elasticdl_serving_requests_total", "x", labelnames=("outcome",)).inc(
        outcome="served")
    journal = obs.EventJournal()
    journal.record("model_swap", generation=2, step=4)
    exporter = MetricsExporter(registry=registry, journal=journal, host="127.0.0.1").start()
    try:
        assert exporter.write_port_file(str(tmp_path)) is not None
        assert MetricsExporter.read_port_file(str(tmp_path)) == exporter.port
        conn = http.client.HTTPConnection("127.0.0.1", exporter.port, timeout=WAIT_S)
        got = {}
        for path in ("/metrics", "/healthz", "/journal?n=5", "/slo", "/debug/vars"):
            conn.request("GET", path)
            response = conn.getresponse()
            got[path] = (response.status, response.read())
        conn.close()
    finally:
        exporter.stop()
    assert got["/metrics"][0] == 200
    assert b'elasticdl_serving_requests_total{outcome="served"} 1' in got["/metrics"][1]
    assert json.loads(got["/healthz"][1])["status"] == "ok"
    assert json.loads(got["/journal?n=5"][1])["events"][0]["event"] == "model_swap"
    assert got["/slo"][0] == got["/debug/vars"][0] == 200
    assert json.loads(got["/slo"][1])["statuses"] == []  # no plane wired
    debug = json.loads(got["/debug/vars"][1])
    assert debug["metrics"]["elasticdl_serving_requests_total"]["values"] == {"served": 1.0}
    assert debug["journal"]["tail"][0]["event"] == "model_swap"


def test_replica_flags_match_jax_and_unported_planes_raise(monkeypatch, tmp_path):
    argv = ["--model_dir", "m", "--serve_dir", "s"]
    want = vars(jax_replica_main.parse_replica_args(argv))
    got = vars(replica_main.parse_replica_args(argv))
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cuda"
    # The quality plane is ported: its flags parse, select the plane, and
    # add the model_quality SLO.
    args = replica_main.parse_replica_args(argv + ["--quality_join_window_s", "0.5",
                                                   "--quality_slo_logloss", "0.7"])
    assert (args.quality_join_window_s, args.quality_slo_logloss) == (0.5, 0.7)
    quality_plane = replica_main._build_quality_plane(args)
    assert [type(p).__name__ for p in quality_plane] == ["QualityLedger", "DriftMonitor",
                                                        "CanaryGate"]
    assert [s.name for s in replica_main._build_slo_plane(args).slos.specs()] == [
        "model_quality"]
    assert replica_main._build_quality_plane(
        replica_main.parse_replica_args(argv)) == (None, None, None)
    # The SLO and tracing flags select their planes.
    args = replica_main.parse_replica_args(argv + [
        "--slo_p99_ms", "0.5", "--slo_availability_target", "0.5", "--trace_head_every", "4",
        "--sparse_kernel", "fused"])
    assert (args.slo_p99_ms, args.slo_availability_target, args.trace_head_every) == (
        0.5, 0.5, 4)
    # No card and no --device cpu: the replica raises, it never serves on
    # the CPU on its own.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replica_main.main(["--model_dir", str(tmp_path / "m"),
                               "--serve_dir", str(tmp_path / "s")])
    finally:
        obs.journal().configure(None)


def test_live_replicas_skips_dead_pids(tmp_path):
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait(timeout=WAIT_S)
    replica_main.write_replica_info(str(tmp_path), 1, {"replica_id": 1, "pid": proc.pid})
    replica_main.write_replica_info(str(tmp_path), 2, {"replica_id": 2, "pid": os.getpid()})
    assert [i["replica_id"] for i in replica_main.live_replicas(str(tmp_path))] == [2]
