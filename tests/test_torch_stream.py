"""The port's stream source and streaming dispatcher
(``elasticdl_tpu_torch/data/stream.py``, ``master/stream.py``, the task
manager's streaming hooks, the faults schedule driver) against the JAX
package, through the scenarios of ``tests/test_stream.py``.

Each scenario runs once per package (a side: that package's stream,
manager, faults registry and journal) on the same inputs, and the two
runs must agree exactly: availability and event times, the dispatch
sequence (ranges, WAITs, job-complete), watermarks, the checkpoint JSON
and the journal events (``task_dispatch``, ``task_done``,
``task_requeue``, ``stream_watermark``, ``task_progress_resume``, with
timestamps, trace ids and durations left out).  Both resume paths are
also crossed: a JAX snapshot and a JAX journal resume the port's
manager.  Everything is integer offsets and virtual time, so "agree"
means equal, with no tolerance.
"""

import json
import types

import numpy as np
import pytest

from elasticdl_tpu import obs as jobs
from elasticdl_tpu.common import faults as jfaults
from elasticdl_tpu.data import stream as jdata
from elasticdl_tpu.master import stream as jmaster
from elasticdl_tpu.proto import elasticdl_pb2 as pb
from elasticdl_tpu_torch import obs as pobs
from elasticdl_tpu_torch.common import faults as pfaults
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.data import stream as pdata
from elasticdl_tpu_torch.master import stream as pmaster

JAX = types.SimpleNamespace(name="jax", obs=jobs, faults=jfaults, data=jdata,
                            Manager=jmaster.StreamingTaskManager, WAIT=pb.WAIT)
PORT = types.SimpleNamespace(name="port", obs=pobs, faults=pfaults, data=pdata,
                             Manager=pmaster.StreamingTaskManager, WAIT=msg.WAIT)
SIDES = (JAX, PORT)
_DROP = {"ts", "trace_id", "reported_trace_id", "duration_s", "trace_ids"}
_KEEP = {"task_dispatch", "task_done", "task_requeue", "stream_watermark",
         "task_progress_resume", "train_epoch_done"}


@pytest.fixture(autouse=True)
def _disarm():
    for side in SIDES:
        side.faults.clear()
    yield
    for side in SIDES:
        side.faults.clear()


@pytest.fixture
def journals(tmp_path):
    paths = {}
    for side in SIDES:
        paths[side.name] = side.obs.init_journal(str(tmp_path / side.name))
    try:
        yield paths
    finally:
        for side in SIDES:
            side.obs.journal().configure(None)


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _story(path):
    return [{k: v for k, v in e.items() if k not in _DROP}
            for e in _events(path) if e["event"] in _KEEP]


def _both(scenario, *args):
    """Run ``scenario(side, *args)`` on each package; they must agree."""
    got = {side.name: scenario(side, *args) for side in SIDES}
    assert got["port"] == got["jax"]
    return got["port"]


def _drain(side, manager, worker_id=2):
    """Dispatch and complete until WAIT or job-complete."""
    done = []
    while True:
        task = manager.get(worker_id=worker_id)
        if task.type == side.WAIT or task.task_id == -1:
            return done, (task.task_id, task.type == side.WAIT)
        done.append((task.start, task.end))
        manager.report(task.task_id, True, worker_id=worker_id)


# -- the source ---------------------------------------------------------------


def _schedule(side):
    stream = side.data.SyntheticClickStream([(4.0, 100), (2.0, 400)], name="clicks",
                                            label_delay_s=0.5)
    seen = [stream.available()]
    for dt in (2.0, 2.0, 2.0, 3.0):
        stream.advance(dt)
        seen.append((stream.available(), stream.labels_available()))
    stream.stall(1.25)
    seen.append((stream.available(), stream.elapsed_s))
    seen.append([stream.event_time(o) for o in (0, 1, 57, 200, 399, 400, 401, 999, 1200)])
    seen.append([stream.records_until(t) for t in (0.0, 0.5, 3.99, 4.0, 5.5, 100.0)])
    clone = side.data.SyntheticClickStream.from_json(stream.to_json())
    seen.append((stream.to_json(), clone.available(), clone.event_time(123)))
    return seen


def test_stream_schedule_spike_stall_and_round_trip():
    seen = _both(_schedule)
    assert seen[4][0] == 400 + 800 + 1200


def _source_faults(side, spec):
    side.faults.install(spec)
    stream = side.data.SyntheticClickStream([(10.0, 100)])
    seen = []
    for _ in range(4):
        stream.advance(1.0)
        for due in side.faults.due("stream.source", stream.elapsed_s):
            stream.stall(float(due.arg))
        seen.append((stream.available(), side.faults.remaining_due("stream.source")))
    return seen


@pytest.mark.parametrize("spec", ["stream.source:latency=3.0@2",
                                  "stream.source:latency=2.0@t1.5",
                                  "stream.source:latency=1.0@t1.0,stream.source:latency=0.5@t3"])
def test_stream_source_fault_by_count_and_by_schedule(spec):
    _both(_source_faults, spec)


def _bad_schedules(side):
    errors = []
    for schedule in ([], [(4.0, -1)], [(4.0, 100), (2.0, 0)]):
        with pytest.raises(ValueError):
            side.data.SyntheticClickStream(schedule)
        errors.append(len(schedule))
    with pytest.raises(ValueError):
        side.data.SyntheticClickStream([(1.0, 10)]).advance(-0.1)
    return errors


def test_stream_rejects_bad_schedules():
    _both(_bad_schedules)


def _batches_and_labels(side, spec):
    if spec:
        side.faults.install(spec)
    fields = ("C1", "C2", "C3")
    whole = side.data.synthetic_click_batch(0, 100, 50, fields)
    part = side.data.synthetic_click_batch(40, 60, 50, fields)
    stream = side.data.SyntheticClickStream([(10.0, 10)], label_delay_s=1.0)
    labels = [stream.labels_for(0, 30, 50, fields) for _ in range(3)]
    windows = list(side.data.iter_stream_batches(lambda lo, hi: (lo, hi), lo=10, hi=45,
                                                 batch_size=16))
    return ({k: v.tolist() for k, v in whole.items()}, {k: v.tolist() for k, v in part.items()},
            side.data.click_label_rule(whole).tolist(),
            [None if x is None else x.tolist() for x in labels], windows)


@pytest.mark.parametrize("spec", ["", "stream.labels:truncate@2", "stream.labels:error=flip@1x2"])
def test_click_batches_labels_and_windows(spec):
    whole, part, rule, labels, windows = _both(_batches_and_labels, spec)
    for name in whole:
        assert part[name] == whole[name][40:60]
    assert windows == [(10, 26), (26, 42), (42, 45)]
    assert 0.2 < np.mean(rule) < 0.45


# -- the dispatcher -----------------------------------------------------------


def _dispatch(side, journal):
    stream = side.data.SyntheticClickStream([(10.0, 10)], name="clicks")
    stream.advance(10.0)
    manager = side.Manager(stream, records_per_task=10, lookahead_tasks=3)
    tasks = [manager.get(worker_id=1) for _ in range(3)]
    seen = [[(t.start, t.end, t.shard_name) for t in tasks], manager.get(1).type == side.WAIT]
    for index in (2, 0, 1):  # a hole first, then the prefix closes
        manager.report(tasks[index].task_id, success=True, worker_id=1)
        seen.append((manager.watermark, manager.stream_counts()))
    seen.append(manager.watermark_event_time())
    return seen, _story(journal[side.name])


def test_streaming_dispatch_and_watermark_eviction(journals):
    seen, story = _both(_dispatch, journals)
    assert seen[0] == [(0, 10, "clicks"), (10, 20, "clicks"), (20, 30, "clicks")] and seen[1]
    assert [e["offset"] for e in story if e["event"] == "stream_watermark"] == [10, 30]


def _tail_and_close(side):
    stream = side.data.SyntheticClickStream([(10.0, 10)], name="clicks")
    stream.advance(2.5)
    manager = side.Manager(stream, records_per_task=10, lookahead_tasks=8)
    first, state = _drain(side, manager, worker_id=1)
    seen = [first, state, manager.finished()]
    stream.close()
    tail, state = _drain(side, manager, worker_id=1)
    seen += [tail, state, manager.watermark]
    final = manager.get(1)
    return seen + [(final.task_id, final.type == side.WAIT), manager.finished()]


def test_streaming_partial_tail_waits_for_close():
    seen = _both(_tail_and_close)
    assert seen[0] == [(0, 10), (10, 20)] and seen[1] == (-1, True) and not seen[2]
    assert seen[3] == [(20, 25)] and seen[5] == 25
    assert seen[6] == (-1, False) and seen[7]  # job complete only after close()


def _churn_and_failure(side, journal):
    stream = side.data.SyntheticClickStream([(10.0, 10)], name="clicks")
    stream.advance(4.0)
    manager = side.Manager(stream, records_per_task=10, lookahead_tasks=4, max_task_retries=2)
    victim = manager.get(worker_id=7)
    survivor = manager.get(worker_id=1)
    seen = [manager.recover_tasks(worker_id=7), manager.recovered_record_count]
    retry = manager.get(worker_id=1)
    seen.append((retry.start, retry.end) == (victim.start, victim.end))
    manager.report(retry.task_id, False, worker_id=1)  # a failure requeues it again
    again = manager.get(worker_id=1)
    manager.report(again.task_id, True, worker_id=1)
    manager.report(survivor.task_id, True, worker_id=1)
    seen += [(again.start, again.end), manager.watermark, manager.finished_record_count]
    return seen, _story(journal[side.name])


def test_streaming_churn_and_failure_ride_the_requeue_path(journals):
    seen, story = _both(_churn_and_failure, journals)
    assert seen[:3] == [1, 10, True] and seen[4] == 20
    assert [e["reason"] for e in story if e["event"] == "task_requeue"] == [
        "worker_churn", "failure"]


def _crash_point(side):
    stream = side.data.SyntheticClickStream([(10.0, 10)], name="clicks")
    stream.advance(6.0)
    manager = side.Manager(stream, records_per_task=10, lookahead_tasks=4)
    tasks = [manager.get(worker_id=1) for _ in range(4)]
    manager.report(tasks[0].task_id, True, worker_id=1)
    manager.report(tasks[2].task_id, True, worker_id=1)
    return stream, manager


def _snapshot_resume(side, journal, snapshot):
    resumed = side.Manager.from_checkpoint(snapshot)
    seen = [json.loads(snapshot)["stream"], resumed.watermark, resumed.stream_counts()]
    redo, state = _drain(side, resumed)
    return seen + [redo, state, resumed.watermark], _story(journal[side.name])


def _check_snapshot_resume(seen):
    cursor, watermark, counts, redo, _state, final = seen
    assert cursor["watermark"] == 10 and cursor["completed"] == [[20, 30]]
    assert watermark == 10 and counts["pending_ranges"] == 1
    assert (10, 20) in redo and (30, 40) in redo
    assert all(not (lo >= 20 and hi <= 30) for lo, hi in redo) and final == 60


def test_streaming_checkpoint_resume_mid_stream(journals):
    seen, _story_ = _both(
        lambda side, j: _snapshot_resume(side, j, _crash_point(side)[1].to_checkpoint()),
        journals)
    _check_snapshot_resume(seen)


def test_streaming_port_resumes_a_jax_snapshot(journals):
    snapshot = _crash_point(JAX)[1].to_checkpoint()
    got = {side.name: _snapshot_resume(side, journals, snapshot)[0] for side in SIDES}
    assert got["port"] == got["jax"]
    _check_snapshot_resume(got["port"])


def _journal_resume(side, journal, events, stream_json):
    resumed = side.Manager.resume_from_journal(
        events, side.data.SyntheticClickStream.from_json(stream_json),
        records_per_task=10, lookahead_tasks=4)
    seen = [resumed.watermark, resumed.stream_counts(), resumed.finished_record_count]
    redo, state = _drain(side, resumed)
    return seen + [redo, state, resumed.watermark], _story(journal[side.name])


def _check_journal_resume(seen):
    watermark, counts, finished, redo, _state, final = seen
    assert watermark == 10 and counts["pending_ranges"] == 1 and finished == 20
    assert redo[:2] == [(10, 20), (30, 40)] and final == 60


def test_streaming_resume_from_journal_redo_exact(journals):
    def scenario(side, journal):
        stream, manager = _crash_point(side)
        del manager  # SIGKILL: only the journal survives
        return _journal_resume(side, journal, _events(journal[side.name]), stream.to_json())

    seen, story = _both(scenario, journals)
    _check_journal_resume(seen)
    resumes = [e for e in story if e["event"] == "task_progress_resume"]
    assert resumes[-1]["watermark"] == 10 and resumes[-1]["completed_above_watermark"] == 1


def test_streaming_port_resumes_from_a_jax_journal(journals):
    stream, manager = _crash_point(JAX)
    del manager
    events = _events(journals["jax"])
    got = {side.name: _journal_resume(side, journals, events, stream.to_json())[0]
           for side in SIDES}
    assert got["port"] == got["jax"]
    _check_journal_resume(got["port"])


def _prefix_folds(side):
    stream = side.data.SyntheticClickStream([(10.0, 10)], name="clicks")
    stream.advance(5.0)
    events = [
        {"event": "stream_watermark", "stream": "clicks", "offset": 10,
         "event_time": 1.0, "next_offset": 30, "pending_ranges": 0},
        {"event": "task_dispatch", "task_id": 2, "shard": "clicks", "start": 10, "end": 20,
         "worker_id": 1},
        {"event": "task_dispatch", "task_id": 3, "shard": "clicks", "start": 20, "end": 30,
         "worker_id": 1},
        {"event": "task_done", "task_id": 2},
        {"event": "task_done", "task_id": 3},
    ]
    resumed = side.Manager.resume_from_journal(events, stream, records_per_task=10)
    task = resumed.get(worker_id=1)
    return [resumed.watermark, resumed.stream_counts(), resumed.finished_record_count,
            (task.start, task.end)]


def test_streaming_resume_from_journal_contiguous_prefix_advances():
    assert _both(_prefix_folds) == [30, {"watermark": 30, "next_offset": 50, "available": 50,
                                         "pending_ranges": 0}, 30, (30, 40)]


def test_bounded_task_manager_keeps_its_epochs():
    """The streaming hooks are no-ops on the bounded dispatcher."""
    from elasticdl_tpu_torch.master.task_manager import TaskManager

    manager = TaskManager({"s": 30}, records_per_task=10, num_epochs=2)
    ranges = []
    while True:
        task = manager.get(1)
        if task.task_id == -1:
            if task.type == msg.WAIT:
                continue
            break
        ranges.append((task.start, task.end, task.epoch))
        manager.report(task.task_id, True, worker_id=1)
    assert ranges == [(lo, lo + 10, e) for e in (0, 1) for lo in (0, 10, 20)]
    assert manager.finished() and "stream" not in json.loads(manager.to_checkpoint())
