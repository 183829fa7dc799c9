"""Request tracing in the port's serving plane, against the JAX package:
``ExemplarSampler`` (``serving/ledger.py``) makes JAX's sampling
decisions on the same sequence of latencies, outcomes and trace ids
(head 1-in-N of traced requests, tail over the threshold, every failed
request; untraced requests invisible), journals the same
``request_trace`` records and the shared ``serve.batch`` span once per
batch, and keeps the same exemplar ring; and a traced request through
the port's HTTP edge (``PredictClient`` -> ``ServingFrontend`` ->
``MicroBatcher``) journals the span tree ``rpc.predict`` under the
client's span, ``serve.queue`` and ``serve.respond`` under it and
``serve.execute`` under the batch's one ``serve.batch``, which carries
the serving generation."""

import numpy as np
import pytest

from elasticdl_tpu.obs.journal import EventJournal as JaxJournal
from elasticdl_tpu.obs import tracing as jax_tracing
from elasticdl_tpu.serving.ledger import ExemplarSampler as JaxSampler
from elasticdl_tpu_torch.obs.journal import EventJournal as PortJournal
from elasticdl_tpu_torch.obs import tracing as port_tracing
from elasticdl_tpu_torch.serving.batcher import BatcherConfig, MicroBatcher
from elasticdl_tpu_torch.serving.frontend import PredictClient, ServingFrontend
from elasticdl_tpu_torch.serving.ledger import ExemplarSampler as PortSampler

WAIT_S = 60.0


def _requests(seed=7, n=40):
    """(trace_id, phases, outcome, rows, batch) per request, from a seed:
    some untraced, some failed, latencies around the 30 ms threshold,
    batches of up to three requests sharing a serve.batch payload."""
    rng = np.random.default_rng(seed)
    out, batch = [], None
    for i in range(n):
        if i % 3 == 0:
            batch = {"name": "serve.batch", "start_ts": 1000.0 + i, "duration_s": 0.01,
                     "span_id": f"s-batch-{i}", "batch_rows": 8, "bucket": 8, "requests": 3}
        queue, execute = rng.uniform(0.0, 0.03, size=2)
        phases = {"queue": float(queue), "batch": 0.0005, "execute": float(execute),
                  "respond": 0.0001}
        outcome = ["served"] * 7 + ["shed", "dropped", "error"]
        out.append((f"req-{i}" if i % 5 else "", phases, outcome[int(rng.integers(10))],
                    int(rng.integers(1, 5)), dict(batch)))
    return out


def _run(sampler_cls, tracing_module, journal):
    saved = tracing_module._tracer._journal
    tracing_module._tracer._journal = journal
    try:
        sampler = sampler_cls(head_every=4, tail_threshold_ms=30.0, capacity=5, replica_id=2,
                              journal=journal)
        reasons = []
        for trace_id, phases, outcome, rows, batch in _requests():
            spans = [{"name": "rpc.predict", "start_ts": 999.0, "duration_s": 0.02,
                      "trace_id": trace_id, "span_id": f"s-rpc-{trace_id}",
                      "parent_id": "", "rows": rows, "outcome": outcome}]
            reasons.append(sampler.observe(trace_id, phases, outcome, rows=rows, spans=spans,
                                           batch=batch, generation=3, bucket=8))
    finally:
        tracing_module._tracer._journal = saved
    records = [{k: v for k, v in e.items() if k != "ts"} for e in journal.tail(1000)]
    for record in records:
        record.pop("proc", None)  # the process's own name
    return reasons, records, sampler


def test_sampler_decides_and_journals_as_jax_does():
    jax_reasons, jax_records, jax_sampler = _run(JaxSampler, jax_tracing, JaxJournal())
    port_reasons, port_records, port_sampler = _run(PortSampler, port_tracing, PortJournal())
    assert port_reasons == jax_reasons
    assert {"head", "tail", "outcome", ""} == set(port_reasons)
    assert port_records == jax_records
    assert port_sampler.counts() == jax_sampler.counts()
    assert port_sampler.exemplars() == jax_sampler.exemplars()
    assert port_sampler.slowest() == jax_sampler.slowest()
    assert port_sampler.trace_ids(3) == jax_sampler.trace_ids(3)
    # One serve.batch per batch that had a sampled member.
    batches = [r["span_id"] for r in port_records
               if r["event"] == "span" and r["name"] == "serve.batch"]
    assert len(batches) == len(set(batches)) > 0


class _Generation:
    gen_id = 5


class _StubReplica:
    generation = _Generation()

    def execute(self, features, n_valid):
        return features["x"][:, 0] * 2.0

    def stats(self):
        return {"generation": 5, "step": 0, "model_event_time": 0.0}


@pytest.fixture
def traced_edge():
    journal = PortJournal()
    saved = port_tracing._tracer._journal
    port_tracing._tracer._journal = journal
    replica = _StubReplica()
    batcher = MicroBatcher(replica.execute, BatcherConfig(8, 100, 8)).start()
    sampler = PortSampler(head_every=1, capacity=8, replica_id=0, journal=journal)
    front = ServingFrontend(replica, batcher, host="127.0.0.1", sampler=sampler)
    port = front.start()
    try:
        yield port, journal, sampler
    finally:
        front.stop()
        batcher.stop()
        port_tracing._tracer._journal = saved


def test_frontend_to_replica_span_tree(traced_edge):
    port, journal, sampler = traced_edge
    client = PredictClient(f"127.0.0.1:{port}", deadline_s=WAIT_S)
    x = {"x": np.arange(6, dtype=np.float32).reshape(3, 2)}
    try:
        np.testing.assert_array_equal(client.predict(x, trace_id="lg-1", span_id="lg-1"),
                                      x["x"][:, 0] * 2.0)
        client.predict(x)  # untraced: served, journals nothing
    finally:
        client.close()
    records = journal.tail(100)
    (trace,) = [r for r in records if r["event"] == "request_trace"]
    assert (trace["trace_id"], trace["sampled_by"], trace["generation"], trace["rows"]) == (
        "lg-1", "head", 5, 3)
    spans = {r["name"]: r for r in records if r["event"] == "span"}
    assert set(spans) == {"rpc.predict", "serve.queue", "serve.batch", "serve.execute",
                          "serve.respond"}
    rpc = spans["rpc.predict"]
    assert (rpc["parent_span_id"], rpc["trace_id"], rpc["outcome"]) == ("lg-1", "lg-1", "served")
    assert spans["serve.queue"]["parent_span_id"] == rpc["span_id"]
    assert spans["serve.respond"]["parent_span_id"] == rpc["span_id"]
    batch = spans["serve.batch"]
    assert (batch["generation"], batch["batch_rows"], batch["requests"]) == (5, 3, 1)
    assert spans["serve.execute"]["parent_span_id"] == batch["span_id"] == rpc["batch_span_id"]
    assert sampler.counts() == {"observed": 1, "sampled": 1}
