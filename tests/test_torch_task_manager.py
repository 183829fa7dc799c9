"""The port's control plane (elasticdl_tpu_torch.master, parallel.elastic,
data.dataset, common.args/messages) against the JAX package's, driven by
one script on both sides: task sequences across epochs, the retry
budget, timeouts on an injected clock, recover_tasks and the train-end
task; the progress JSON read both ways; the rendezvous's answers to one
script of host changes; the lockstep batch ranges over a grid; the
record pipeline and the zoo's dataset_fn giving the same batches."""

import json
import types

import numpy as np
import pytest

from elasticdl_tpu.common import args as jax_args
from elasticdl_tpu.data import dataset as jax_dataset
from elasticdl_tpu.master import rendezvous_server as jax_rdzv
from elasticdl_tpu.master import task_manager as jax_tm
from elasticdl_tpu.parallel import elastic as jax_elastic
from elasticdl_tpu.proto import elasticdl_pb2 as pb
from elasticdl_tpu_torch.common import args as port_args
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.data import dataset as port_dataset
from elasticdl_tpu_torch.master import rendezvous_server as port_rdzv
from elasticdl_tpu_torch.master import task_manager as port_tm
from elasticdl_tpu_torch.parallel import elastic as port_elastic
from elasticdl_tpu_torch.zoo import deepfm as port_deepfm
from elasticdl_tpu_torch.zoo import transformer_lm as port_lm
from model_zoo.deepfm import deepfm_functional_api as jax_deepfm
from model_zoo.transformer import transformer_lm as jax_lm

TASK_FIELDS = ("task_id", "shard_name", "start", "end", "type", "model_version", "epoch")


class _Clock:
    """An injected wall clock for both task managers' timeouts."""

    def __init__(self, t=1000.0):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t


def _fields(task):
    return tuple(getattr(task, f) for f in TASK_FIELDS)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    fake = types.SimpleNamespace(time=c.time, monotonic=c.monotonic, perf_counter=c.monotonic)
    monkeypatch.setattr(jax_tm, "time", fake)
    monkeypatch.setattr(port_tm, "time", fake)
    return c


def _pair(**kwargs):
    return jax_tm.TaskManager(**kwargs), port_tm.TaskManager(**kwargs)


def _same_get(managers, worker_id):
    got = [m.get(worker_id) for m in managers]
    assert _fields(got[0]) == _fields(got[1])
    assert bool(got[0].trace_id) == bool(got[1].trace_id)
    return got[1]


def test_enum_numbers_and_fields_are_the_protos():
    assert (msg.TRAINING, msg.EVALUATION, msg.PREDICTION, msg.WAIT, msg.TRAIN_END_CALLBACK) == (
        pb.TRAINING, pb.EVALUATION, pb.PREDICTION, pb.WAIT, pb.TRAIN_END_CALLBACK)
    for number in range(5):
        assert msg.task_type_name(number) == pb.TaskType.Name(number)
    for name, (req, resp) in msg.METHODS.items():
        jax_req = getattr(pb, req.__name__)()
        port_fields = set(msg.to_json(req()))
        assert port_fields <= {f.name for f in jax_req.DESCRIPTOR.fields}, name
        jax_resp = getattr(pb, resp.__name__)()
        assert set(msg.to_json(resp())) == {f.name for f in jax_resp.DESCRIPTOR.fields}, name
    # proto3 defaults, and a JSON round trip
    assert _fields(msg.Task()) == _fields(pb.Task())
    task = msg.Task(task_id=3, shard_name="s", start=5, end=9, type=msg.WAIT, epoch=2,
                    trace_id="t-1")
    back = msg.from_json(msg.GetTaskResponse, json.loads(json.dumps(
        msg.to_json(msg.GetTaskResponse(task=task)))))
    assert back.task == task


@pytest.mark.parametrize("num_epochs,records_per_task", [(1, 4), (3, 5), (2, 16)])
def test_task_sequences_across_epochs(clock, num_epochs, records_per_task):
    shards = {"a": 13, "b": (100, 7)}
    managers = _pair(training_shards=shards, records_per_task=records_per_task,
                     num_epochs=num_epochs)
    seen = []
    while True:
        task = _same_get(managers, worker_id=0)
        if task.task_id == -1 and task.type != msg.WAIT:
            break
        if task.type == msg.WAIT:
            continue
        seen.append((task.epoch, task.shard_name, task.start, task.end))
        for m in managers:
            assert m.report(task.task_id, True, worker_id=0,
                            exec_counters={"batch_count": 2, "record_count": 3})
    per_epoch = -(-13 // records_per_task) + -(-7 // records_per_task)
    assert len(seen) == per_epoch * num_epochs
    assert {e for e, *_ in seen} == set(range(num_epochs))
    for m in managers:
        assert m.finished()
        assert m.finished_record_count == 20 * num_epochs
    assert managers[0].exec_counters() == managers[1].exec_counters() == {
        "batch_count": 2 * len(seen), "record_count": 3 * len(seen)}


def test_failures_spend_the_retry_budget_then_drop(clock):
    managers = _pair(training_shards={"s": 8}, records_per_task=4, max_task_retries=2)
    outcomes = []
    for _ in range(6):
        task = _same_get(managers, worker_id=1)
        if task.task_id == -1:
            outcomes.append(("done", task.type))
            continue
        fail = task.start == 0  # the first range fails every time
        for m in managers:
            m.report(task.task_id, not fail, worker_id=1)
        outcomes.append((task.task_id, task.start, fail))
    assert outcomes[:4] == [(1, 0, True), (2, 0, True), (3, 0, True), (4, 4, False)]
    dropped = [[_fields(t) for t in m.permanently_failed_tasks()] for m in managers]
    assert dropped[0] == dropped[1] and len(dropped[1]) == 1
    assert [m.recovered_record_count for m in managers] == [8, 8]
    assert not managers[1].report(99, True)  # unknown task


def test_timeouts_recover_and_churn_requeues(clock):
    managers = _pair(training_shards={"s": 12}, records_per_task=4, task_timeout_s=30)
    first = _same_get(managers, worker_id=0)
    second = _same_get(managers, worker_id=1)
    clock.t += 31  # both in flight past the timeout: requeued at the next get
    third = _same_get(managers, worker_id=2)
    assert (third.start, third.end) == (second.start, second.end)
    for m in managers:
        assert not m.report(first.task_id, True)  # expired: unknown now
        assert m.recover_tasks(2) == 1
        assert m.counts() == {"todo": 3, "doing": 0, "epoch": 0}
    order = [(t.start, t.end) for t in (_same_get(managers, 3) for _ in range(3))]
    assert order == [(4, 8), (0, 4), (8, 12)]
    assert [m.recovered_record_count for m in managers] == [12, 12]


def test_train_end_task_and_wait_while_finalizing(clock):
    managers = _pair(training_shards={"s": 4}, records_per_task=4)
    for m in managers:
        m.add_tasks_done_callback(m.create_train_end_task)
    task = _same_get(managers, worker_id=0)
    for m in managers:
        m.report(task.task_id, True, worker_id=0)
    end = _same_get(managers, worker_id=0)
    assert end.type == msg.TRAIN_END_CALLBACK and end.task_id == 2
    for m in managers:
        assert not m.finished()
        m.report(end.task_id, True, worker_id=0)
        assert m.finished()
    assert _same_get(managers, worker_id=0).task_id == -1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_progress_json_resumes_in_the_other_package(clock, writer):
    managers = _pair(training_shards={"a": 10, "b": 6}, records_per_task=3, num_epochs=2)
    # One done, one in flight, one failed once: the snapshot holds them.
    done = _same_get(managers, 0)
    flight = _same_get(managers, 0)
    failed = _same_get(managers, 0)
    for m in managers:
        m.report(done.task_id, True)
        m.report(failed.task_id, False)
    source = managers[0] if writer == "jax" else managers[1]
    snapshot = source.to_checkpoint()
    assert json.loads(managers[0].to_checkpoint()) == json.loads(managers[1].to_checkpoint())
    resumed = (jax_tm.TaskManager.from_checkpoint(snapshot),
               port_tm.TaskManager.from_checkpoint(snapshot))
    assert [m.finished_record_count for m in resumed] == [3, 3]
    ranges = []
    while True:
        task = _same_get(resumed, 5)
        if task.task_id == -1:
            break
        ranges.append((task.epoch, task.shard_name, task.start, task.end))
        for m in resumed:
            m.report(task.task_id, True)
    assert (0, flight.shard_name, flight.start, flight.end) in ranges
    assert sum(1 for r in ranges if r[0] == 1) == 6  # the second epoch, whole
    assert resumed[0].to_checkpoint() == resumed[1].to_checkpoint()


def test_progress_persister_writes_what_either_reads(tmp_path):
    """A master's task_progress.json, written by either package's
    persister, resumes in the other's master (build_master reads it)."""
    for writer, reader in ((port_tm, jax_tm), (jax_tm, port_tm)):
        directory = tmp_path / writer.__name__.split(".")[0]
        manager = writer.TaskManager(training_shards={"s": 9}, records_per_task=4)
        manager.get(0)
        persister = writer.TaskProgressPersister(manager, str(directory))
        persister.persist_now()
        path = reader.TaskProgressPersister.progress_path(str(directory))
        with open(path) as f:
            resumed = reader.TaskManager.from_checkpoint(f.read())
        assert resumed.counts() == {"todo": 3, "doing": 0, "epoch": 0}
        # the in-flight task is saved after the todo ones (at-least-once)
        assert [(t.start, t.end) for t in (resumed.get(1) for _ in range(3))] == [
            (4, 8), (8, 9), (0, 4)]
        persister.clear()
        assert not (directory / "task_progress.json").exists()


def test_rendezvous_answers_one_script_alike(monkeypatch):
    c = _Clock()
    fake = types.SimpleNamespace(time=c.time, monotonic=c.monotonic)
    monkeypatch.setattr(jax_rdzv, "time", fake)
    monkeypatch.setattr(port_rdzv, "time", fake)
    pair = [module.ElasticRendezvous(coordinator_port_fn=lambda host: 40000)
            for module in (jax_rdzv, port_rdzv)]
    script = [
        ("declare", [(3, "h3"), (1, "h1"), (2, "")]),
        ("rank", 1, ""), ("rank", 2, "h2"), ("rank", 3, ""), ("rank", 7, "h7"),
        ("beat", 1, "h1", 1), ("tick", 5), ("stale", 4, 10),
        ("declare", [(4, ""), (5, "")]),
        ("rank", 4, ""), ("rank", 5, "h5"), ("rank", 4, "h4"),
        ("beat", 1, "h1", 1), ("beat", 4, "h4", 2), ("tick", 20), ("stale", 10, 15),
        ("declare", []), ("rank", 4, ""),
    ]
    answers = [[], []]
    for side, r in enumerate(pair):
        c.t = 1000.0
        for step in script:
            kind = step[0]
            if kind == "declare":
                out = r.set_worker_hosts(step[1])
            elif kind == "rank":
                resp = r.get_comm_rank(step[1], step[2])
                out = (resp.rank_id, resp.world_size, resp.rendezvous_id,
                       resp.coordinator_addr, list(resp.worker_hosts))
            elif kind == "beat":
                out = r.report_liveness(step[1], step[2], step[3])
            elif kind == "tick":
                c.t += step[1]
                out = None
            else:
                out = sorted(r.stale_workers(step[1], step[2]))
            answers[side].append(out)
        answers[side].append((r.rendezvous_id, r.world()))
    assert answers[0] == answers[1]
    assert answers[1][1] == (0, 3, 1, "h1:40000", ["h1", "", "h3"])
    assert answers[1][4] == (-1, 3, 1, "h1:40000", ["h1", "h2", "h3"])  # not in the world
    # rank 0's host unknown: no coordinator until worker 4 advertises it
    assert answers[1][9][3] == "" and answers[1][11][3].startswith("h4:")
    assert answers[1][7] == [1]  # beat 5 s ago; 2 and 3 never beat but are in the grace
    assert answers[1][15] == [4, 5]  # 4 beat 20 s ago (past 10); 5 never, past the grace


def _world(rank, size):
    return port_elastic.WorldInfo(rank, size, 1, "h:1"), jax_elastic.WorldInfo(rank, size, 1, "h:1")


@pytest.mark.parametrize("world_size", [1, 2, 3, 4])
def test_lockstep_ranges_over_a_grid(world_size):
    for start, end in [(0, 0), (0, 1), (5, 37), (100, 164), (3, 1000)]:
        for per_rank in (1, 4, 7, 16):
            covered = []
            steps = set()
            for rank in range(world_size):
                port_w, jax_w = _world(rank, world_size)
                got = list(port_elastic.iter_local_batch_ranges(start, end, per_rank, port_w))
                want = list(jax_elastic.iter_local_batch_ranges(start, end, per_rank, jax_w))
                assert got == want
                steps.add(len(got))
                covered += [r for lo, hi, _ in got for r in range(lo, hi)]
            assert len(steps) == 1  # lockstep
            assert sorted(covered) == list(range(start, end))
            for real in range(0, per_rank * world_size + 1):
                assert port_elastic.per_rank_real_counts(real, per_rank, world_size) == \
                    jax_elastic.per_rank_real_counts(real, per_rank, world_size)


def test_task_broadcast_encoding_round_trips():
    names = ["a", "b"]
    task = msg.Task(task_id=4, shard_name="b", start=8, end=12, type=msg.TRAINING,
                    model_version=-1, epoch=1)
    enc = port_elastic._encode_task(task, names)
    jax_enc = jax_elastic._encode_task(pb.Task(**{f: getattr(task, f) for f in TASK_FIELDS}),
                                       names)
    np.testing.assert_array_equal(enc, jax_enc)
    assert port_elastic._decode_task(enc, names) == task
    np.testing.assert_array_equal(port_elastic._encode_task(None, names),
                                  jax_elastic._encode_task(None, names))
    world = port_elastic.WorldInfo(0, 1, 1, "")
    assert port_elastic.broadcast_task(task, names, world) is task
    with pytest.raises(ValueError):
        port_elastic.broadcast_task(None, names, world)


@pytest.mark.parametrize("buffer_size,seed", [(1, 0), (7, 3), (64, 0), (1000, 11)])
def test_dataset_shuffle_is_the_jax_draws(buffer_size, seed):
    records = list(range(150))
    got = list(port_dataset.Dataset.from_iterable(records).shuffle(buffer_size, seed=seed))
    want = list(jax_dataset.Dataset.from_iterable(records).shuffle(buffer_size, seed=seed))
    assert got == want and sorted(got) == records
    batched = list(port_dataset.Dataset.from_iterable(records).map(lambda r: r * 2)
                   .filter(lambda r: r % 3).batch(16).repeat(2))
    jax_batched = list(jax_dataset.Dataset.from_iterable(records).map(lambda r: r * 2)
                       .filter(lambda r: r % 3).batch(16).repeat(2))
    assert len(batched) == len(jax_batched)
    for a, b in zip(batched, jax_batched):
        np.testing.assert_array_equal(a, b)


def test_sequential_records_slices_like_jax():
    def make(module):
        return module.SequentialRecords(module.Dataset.from_iterable(list(range(30))))

    port, jax_ = make(port_dataset), make(jax_dataset)
    assert port.template() == jax_.template() == 0
    for lo, hi in [(0, 4), (4, 4), (6, 11), (25, 40), (40, 50)]:
        assert port.slice(lo, hi) == jax_.slice(lo, hi)
    with pytest.raises(ValueError):
        port.slice(0, 1)
    empty = port_dataset.SequentialRecords(port_dataset.Dataset.from_iterable([]))
    with pytest.raises(ValueError, match="zero records"):
        empty.template()


def _task(start, end):
    return types.SimpleNamespace(start=start, end=end, shard_name="criteo-synth")


@pytest.mark.parametrize("mode", ["training", "evaluation"])
def test_deepfm_dataset_fn_gives_the_zoo_batches(mode):
    path = "synthetic://criteo?n=300&vocab=50&seed=4"
    jax_reader = jax_deepfm.custom_data_reader(path)
    port_reader = port_deepfm.custom_data_reader(path)
    assert port_reader.create_shards() == jax_reader.create_shards()
    etrf = "/data/criteo.etrf"
    assert type(port_deepfm.custom_data_reader(etrf)).__name__ == \
        type(jax_deepfm.custom_data_reader(etrf)).__name__ == "CriteoRecordReader"
    assert port_deepfm.custom_data_reader("/data/records") is None
    assert jax_deepfm.custom_data_reader("/data/records") is None
    for start, end in [(0, 128), (128, 256), (256, 300)]:
        task = _task(start, end)
        want = port_dataset.SequentialRecords(jax_deepfm.dataset_fn(
            jax_dataset.Dataset.from_generator(lambda: jax_reader.read_records(task)), mode, None))
        got = port_dataset.SequentialRecords(port_deepfm.dataset_fn(
            port_dataset.Dataset.from_generator(lambda: port_reader.read_records(task)), mode,
            None))
        for lo in range(0, end - start, 32):
            w = jax_dataset._stack(want.slice(lo, lo + 32))
            g = port_dataset._stack(got.slice(lo, lo + 32))
            for key in ("dense", "cat"):
                np.testing.assert_array_equal(g[0][key], w[0][key])
                assert g[0][key].dtype == w[0][key].dtype
            np.testing.assert_array_equal(g[1], w[1])


def test_lm_dataset_fn_gives_the_zoo_batches():
    path = "synthetic://lm?n=40&len=8&vocab=31&seed=2"
    jax_reader, port_reader = jax_lm.custom_data_reader(path), port_lm.custom_data_reader(path)
    task = _task(0, 40)
    want = list(jax_lm.dataset_fn(jax_dataset.Dataset.from_generator(
        lambda: jax_reader.read_records(task)), "training", None))
    got = list(port_lm.dataset_fn(port_dataset.Dataset.from_generator(
        lambda: port_reader.read_records(task)), "training", None))
    assert len(got) == len(want) == 40
    for (gt, gn), (wt, wn) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gn, wn)


def test_parsers_keep_every_jax_flag_and_default():
    for build in ("build_master_parser", "build_worker_parser"):
        jax_p, port_p = getattr(jax_args, build)(), getattr(port_args, build)()
        jax_flags = {a.dest: a.default for a in jax_p._actions if a.dest != "help"}
        port_flags = {a.dest: a.default for a in port_p._actions if a.dest != "help"}
        assert set(port_flags) - set(jax_flags) == {"device"}
        assert set(jax_flags) <= set(port_flags)
        assert {k: port_flags[k] for k in jax_flags} == jax_flags
        assert port_flags["device"] == "cuda"
    required = ["--model_zoo", "model_zoo", "--model_def", "deepfm.deepfm_functional_api"]
    for flag, value in [("--profile_steps", "1,2"), ("--tensorboard_log_dir", "/tmp/tb"),
                        ("--slo_goodput_target", "0.9")]:
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
            port_args.parse_master_args(required + [flag, value])
    # The evaluation flags and jobs are ported.
    for job_type in ("evaluation_only", "prediction_only", "training_only"):
        args = port_args.parse_master_args(required + [
            "--validation_data", "x", "--prediction_data", "y", "--evaluation_steps", "5",
            "--job_type", job_type])
        assert (args.validation_data, args.evaluation_steps, args.job_type) == ("x", 5, job_type)
    args = port_args.parse_master_args(required + ["--jax_compilation_cache_dir", "/tmp/c",
                                                   "--policy_enabled", "false"])
    assert args.jax_compilation_cache_dir == "/tmp/c" and args.policy_enabled is False
    params = {"a": 1, "b": True, "c": "x=y"}
    assert port_args.format_dict_params(params) == jax_args.format_dict_params(params)
    assert port_args.args_to_argv(args, keys={"model_def", "device"}) == [
        "--device", "cuda", "--model_def", "deepfm.deepfm_functional_api"]
