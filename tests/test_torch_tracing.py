"""The port's tracing plane (``elasticdl_tpu_torch/obs/tracing.py``) held
to the JAX package's (``elasticdl_tpu/obs/tracing.py``): span parentage
across nested calls, threads and ``contextvars``, the root-id rule and
the window spans give the same trees (ids mapped one to one, fields
equal); the trace headers over the port's HTTP transport nest the
master's handler spans under the worker's client spans, and a peer
without headers is still served; a CPU job's journals hold one
``task.lifetime`` root per dispatched task with its worker-side
children."""

import contextvars
import threading

import pytest

from elasticdl_tpu.obs.journal import EventJournal as JaxJournal
from elasticdl_tpu.obs import tracing as jax_tracing
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.common.http_rpc import (
    JsonRpcClient,
    JsonRpcServer,
    trace_metadata,
)
from elasticdl_tpu_torch.common.retry import IDEMPOTENT_POLICY
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.obs.journal import EventJournal as PortJournal
from elasticdl_tpu_torch.obs import tracing as port_tracing
from elasticdl_tpu_torch.worker.master_client import MasterClient

from torch_obs_job import events, job_log, observed_job

WINDOW = {"data_wait": 0.5, "stage": 0.25, "compile": 0.0, "execute": 2.0,
          "bookkeep": 0.125, "steps": 8}


def _scenario(tracing_module, journal):
    """Nested spans, a thread (a fresh context), a copied context, a root
    and after-the-fact spans, window spans; returns the span records."""
    tracer = tracing_module.Tracer(journal=journal, proc="p")
    with tracer.span("outer", trace_id="t-1", a=1) as outer:
        with tracer.span("inner", b=2):
            tracer.record_window_spans(WINDOW, end_ts=1000.0)

        def in_thread():
            with tracer.span("thread_root"):
                with tracer.span("thread_child"):
                    pass

        worker = threading.Thread(target=in_thread)
        worker.start()
        worker.join()
        ctx = contextvars.copy_context()
        ctx.run(lambda: tracer.record_span("copied", start_ts=5.0, duration_s=1.0,
                                           parent_id=tracer.current_span_id()))
        with tracer.span("explicit", parent_id=outer.span_id, c=3):
            pass
    tracer.record_span("task.lifetime", start_ts=1.0, duration_s=2.0, trace_id="t-2", root=True,
                       task_id=7)
    tracer.record_span("child_of_root", start_ts=1.5, duration_s=0.5, trace_id="t-2")
    with tracer.span("rooted", trace_id="t-3", root=True):
        with tracer.span("under_root"):
            pass
    try:
        with tracer.span("fails"):
            raise KeyError("x")
    except KeyError:
        pass
    return [e for e in journal.tail(1000) if e["event"] == "span"]


def _normalize(records):
    """Span ids mapped to their first-seen order (trace ids are given),
    wall stamps dropped where they are read from the clock."""
    ids = {}

    def norm(span_id):
        if not span_id or span_id.startswith("t-"):
            return span_id
        return ids.setdefault(span_id, f"#{len(ids)}")

    out = []
    for r in records:
        r = dict(r)
        r.pop("ts")
        r["span_id"] = norm(r["span_id"])
        if "parent_span_id" in r:
            r["parent_span_id"] = norm(r["parent_span_id"])
        if r["name"] not in ("copied", "task.lifetime", "child_of_root") and \
                not r["name"].startswith("step."):
            r.pop("start_ts")
            r.pop("duration_s")
        out.append(r)
    return out


def test_span_trees_match_jax():
    jax_records = _scenario(jax_tracing, JaxJournal())
    port_records = _scenario(port_tracing, PortJournal())
    assert _normalize(port_records) == _normalize(jax_records)
    by_name = {r["name"]: r for r in port_records}
    # Nesting, and a thread's span starts a tree of its own.
    assert by_name["inner"]["parent_span_id"] == by_name["outer"]["span_id"]
    assert "parent_span_id" not in by_name["thread_root"]
    assert by_name["thread_child"]["parent_span_id"] == by_name["thread_root"]["span_id"]
    assert by_name["copied"]["parent_span_id"] == by_name["outer"]["span_id"]
    # The window's phases lay out back to back, ending at end_ts, under
    # the current span.
    steps = [r for r in port_records if r["name"].startswith("step.")]
    assert [r["name"] for r in steps] == ["step.data_wait", "step.stage", "step.execute",
                                          "step.bookkeep"]
    assert all(r["parent_span_id"] == by_name["inner"]["span_id"] for r in steps)
    assert steps[-1]["start_ts"] + steps[-1]["duration_s"] == pytest.approx(1000.0, abs=1e-6)
    # The root rule: span_id == trace_id, and a contextless span of the
    # trace hangs off the root.
    assert by_name["task.lifetime"]["span_id"] == "t-2"
    assert "parent_span_id" not in by_name["task.lifetime"]
    assert by_name["child_of_root"]["parent_span_id"] == "t-2"
    assert by_name["rooted"]["span_id"] == "t-3"
    assert by_name["under_root"]["parent_span_id"] == "t-3"
    assert by_name["fails"]["error"] == "KeyError"


def test_flight_recorder_flushes_open_spans_like_jax():
    got = {}
    for name, module, journal_cls in (("jax", jax_tracing, JaxJournal),
                                      ("port", port_tracing, PortJournal)):
        journal = journal_cls()
        tracer = module.Tracer(journal=journal, proc="w")
        cm = tracer.span("open.forever", trace_id="t-9")
        cm.__enter__()
        assert tracer.flush_open("shutdown") == 1
        assert tracer.flush_open("shutdown") == 0  # idempotent
        (record,) = [e for e in journal.tail(10) if e["event"] == "span"]
        got[name] = {k: v for k, v in record.items()
                     if k not in ("ts", "span_id", "start_ts", "duration_s")}
    assert got["port"] == got["jax"]
    assert got["port"]["flushed"] == "shutdown" and got["port"]["trace_id"] == "t-9"


def test_span_ids_do_not_collide_across_tracers():
    a, b = port_tracing.Tracer(), port_tracing.Tracer()
    ids = {a.mint_span_id() for _ in range(50)} | {b.mint_span_id() for _ in range(50)}
    assert len(ids) == 100


@pytest.fixture
def master():
    journal = PortJournal()
    saved = port_tracing._tracer._journal
    port_tracing._tracer._journal = journal
    manager = TaskManager(training_shards={"s": 64}, records_per_task=32)
    server = JsonRpcServer(MasterServicer(manager), port=0, host="127.0.0.1")
    port = server.start()
    try:
        yield port, journal
    finally:
        server.stop()
        port_tracing._tracer._journal = saved


def test_trace_headers_nest_handler_spans_under_client_spans(master):
    port, journal = master
    client = MasterClient(f"127.0.0.1:{port}", worker_id=3)
    try:
        task = client.get_task()
        assert task.trace_id
        client.report_task_result(task.task_id, "", {"batch_count": 1}, trace_id=task.trace_id)
    finally:
        client.close()
    spans = {e["name"]: e for e in journal.tail(100) if e["event"] == "span"}
    assert spans["rpc.get_task"]["parent_span_id"] == spans["worker.get_task"]["span_id"]
    assert spans["worker.get_task"]["parent_span_id"] == task.trace_id
    assert (spans["rpc.report_task_result"]["parent_span_id"]
            == spans["worker.report_task"]["span_id"])
    assert spans["worker.report_task"]["parent_span_id"] == task.trace_id
    root = spans["task.lifetime"]
    assert root["span_id"] == root["trace_id"] == task.trace_id
    assert (root["task_id"], root["worker_id"]) == (task.task_id, 3)
    assert all(s["trace_id"] == task.trace_id for s in spans.values())


def test_a_peer_without_trace_headers_is_served(master):
    port, journal = master
    raw = JsonRpcClient(f"127.0.0.1:{port}")
    try:
        task = raw.call("get_task", msg.GetTaskRequest(worker_id=1), IDEMPOTENT_POLICY).task
        assert task.task_id == 1 and task.trace_id
        raw.call("report_task_result", msg.ReportTaskResultRequest(task_id=task.task_id),
                 IDEMPOTENT_POLICY)
    finally:
        raw.close()
    spans = [e for e in journal.tail(100) if e["event"] == "span"]
    by_name = {e["name"]: e for e in spans}
    # No caller span: the handler's span hangs off the task root; no trace
    # id echoed: no report span, the root still closes.
    assert by_name["rpc.get_task"]["parent_span_id"] == task.trace_id
    assert "rpc.report_task_result" not in by_name
    assert by_name["task.lifetime"]["span_id"] == task.trace_id
    assert trace_metadata("", "") is None
    assert trace_metadata("t", "s") == (("elasticdl-trace-id", "t"), ("elasticdl-span-id", "s"))


def test_cpu_job_task_lifetime_trees(tmp_path_factory):
    root = observed_job(tmp_path_factory)
    assert (root / "rc").read_text() == "0", job_log(root)
    master = events(root / "tb" / "events.jsonl")
    worker = events(root / "tb" / "events_worker_0.jsonl")
    spans = [e for e in master + worker if e["event"] == "span"]
    by_id = {s["span_id"]: s for s in spans}
    done = [e for e in master if e["event"] == "task_done"]
    assert len(done) >= 4
    for event in done:
        trace_id = event["trace_id"]
        root_span = by_id[trace_id]
        assert (root_span["name"], root_span["proc"]) == ("task.lifetime", "master")
        children = [s for s in spans if s.get("parent_span_id") == trace_id]
        names = {s["name"] for s in children}
        assert {"worker.get_task", "worker.task", "worker.report_task"} <= names, names
        assert all(s["proc"] == "worker_0" for s in children)
        task_span = next(s for s in children if s["name"] == "worker.task")
        below = {s["name"] for s in spans if s.get("parent_span_id") == task_span["span_id"]}
        if event["type"] == "TRAINING":
            assert "step.execute" in below, below
        report = next(s for s in children if s["name"] == "worker.report_task")
        assert any(s["name"] == "rpc.report_task_result"
                   and s["parent_span_id"] == report["span_id"] for s in spans)
