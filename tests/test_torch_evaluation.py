"""The port's evaluation (``master/evaluation_service.py``, the task
manager's rounds, the zoo's ``eval_metrics_fn``) against the JAX
package's on the same reported outputs, and the port's job on the CPU:
``python -m elasticdl_tpu_torch.master.main`` with one worker process
(and a gloo world of two) trains DeepFM from ETRF shards through the
columnar route, evaluates a validation shard over HTTP, exits 0 and
reports the metrics an in-process evaluation of its export gives; an
``evaluation_only`` job over its checkpoint reports them again; the
LM's AllReduce job evaluates synthetic records by the per-record
route."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from elasticdl_tpu.common import tensor_utils as jax_tensor_utils
from elasticdl_tpu.master.evaluation_service import EvaluationService as JaxService
from elasticdl_tpu.master.task_manager import TaskManager as JaxTaskManager
from elasticdl_tpu_torch.common import tensor_utils as port_tensor_utils
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService as PortService
from elasticdl_tpu_torch.master.task_manager import TaskManager as PortTaskManager
from elasticdl_tpu_torch.serving.runtime import ServingReplica
from elasticdl_tpu_torch.zoo import deepfm as port_deepfm
from model_zoo.deepfm import deepfm_functional_api as jax_deepfm
from model_zoo.wide_and_deep import wide_and_deep as jax_wide_and_deep

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240


def _side(package):
    if package == "jax":
        manager = JaxTaskManager(training_shards={"train": 40},
                                 evaluation_shards={"val-a": 10, "val-b": 7},
                                 records_per_task=4)
        service = JaxService(manager, eval_metrics_fn=jax_deepfm.eval_metrics_fn,
                             evaluation_steps=5)
        to_tensor = jax_tensor_utils.ndarray_to_pb
    else:
        manager = PortTaskManager(training_shards={"train": 40},
                                  evaluation_shards={"val-a": 10, "val-b": 7},
                                  records_per_task=4)
        service = PortService(manager, eval_metrics_fn=port_deepfm.eval_metrics_fn,
                              evaluation_steps=5)
        to_tensor = port_tensor_utils.ndarray_to_tensor
    return manager, service, to_tensor


def _drive(package):
    """One script for both packages: training tasks with versions that
    trigger rounds, evaluation tasks reported in chunks (one attempt
    failing half-way), a late report after its round closed, and
    ``finalize`` over a round whose tasks never all completed."""
    manager, service, to_tensor = _side(package)
    rng = np.random.RandomState(0)
    log = []
    version = 0

    def report(task, rows):
        outputs = rng.randn(rows).astype(np.float32)
        labels = rng.randint(0, 2, rows).astype(np.int32)
        service.report_evaluation_metrics(task.model_version, [to_tensor(outputs, "output")],
                                          [to_tensor(labels, "")], task_id=task.task_id)

    failed_once = False
    for _ in range(40):
        task = manager.get(0)
        log.append((task.task_id, task.type, task.shard_name, task.start, task.end,
                    task.model_version))
        if task.task_id == -1:
            if task.type == 3:  # WAIT: the done callbacks are running
                continue
            break
        if task.type == 0:  # TRAINING: each task advances the model 2 versions
            version += 2
            service.add_evaluation_task_if_needed(version)
            manager.report(task.task_id, True)
        elif task.type == 1:
            n = task.end - task.start
            report(task, n // 2)
            if not failed_once and task.shard_name == "val-b":
                failed_once = True
                manager.report(task.task_id, False)  # its chunk never joins the round
                continue
            report(task, n - n // 2)
            manager.report(task.task_id, True)
            log.append(("metrics", dict(service.latest_metrics)))
            if task.model_version == 5:
                report(task, 3)  # late: the round is closed
    service.trigger_evaluation(99)
    first = manager.get(0)
    report(first, 2)
    manager.report(first.task_id, True)
    service.finalize()  # the round at 99 with one of its tasks done
    log.append(("final", dict(service.latest_metrics)))
    return log


def test_evaluation_rounds_equal_jax():
    jax_log, port_log = _drive("jax"), _drive("port")
    assert port_log == jax_log
    rounds = [entry for entry in port_log if entry[0] == "metrics"]
    assert len({json.dumps(r[1], sort_keys=True) for r in rounds}) >= 3
    assert port_log[-1][1] and port_log[-1][1] != rounds[-1][1]


@pytest.mark.parametrize("case", ["random", "ties", "one_class", "all_equal", "tiny"])
def test_auc_and_eval_metrics_equal_jax(case):
    rng = np.random.RandomState(1)
    n = 1000
    outputs = rng.randn(n).astype(np.float32)
    labels = rng.randint(0, 2, n).astype(np.int32)
    if case == "ties":
        outputs = np.round(outputs, 1)
    elif case == "one_class":
        labels[:] = 1
    elif case == "all_equal":
        outputs[:] = 0.25
    elif case == "tiny":
        outputs, labels = outputs[:2], np.array([0, 1], np.int32)
    assert port_deepfm._auc(outputs, labels) == jax_wide_and_deep._auc(outputs, labels)
    jax_fns, port_fns = jax_deepfm.eval_metrics_fn(), port_deepfm.eval_metrics_fn()
    assert port_fns.keys() == jax_fns.keys()
    for name in jax_fns:
        assert float(port_fns[name](outputs, labels)) == float(jax_fns[name](outputs, labels))


# -- the job on the CPU ------------------------------------------------------

PARAMS = "vocab_size=100,embedding_dim=4,hidden=16"
MB, PER_TASK, VALIDATION = 64, 256, 300


def _write_shards(directory: Path, sizes, seed):
    directory.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    for i, n in enumerate(sizes):
        port_deepfm.write_criteo_etrf(
            str(directory / f"part-{i:05d}.etrf"), rng.rand(n, 13).astype(np.float32),
            rng.randint(0, 100, (n, 26)).astype(np.int32), rng.randint(0, 2, (n, 1)))


PS_FLAGS = ["--distribution_strategy=ParameterServerStrategy",
            "--model_def=deepfm.deepfm_functional_api", f"--model_params={PARAMS}",
            f"--records_per_task={PER_TASK}", "--sparse_apply_every=1"]
#: The LM's AllReduce job evaluates by the per-record route.
LM_FLAGS = ["--distribution_strategy=AllreduceStrategy", "--model_def=transformer.transformer_lm",
            "--model_params=vocab=64,d_model=32,num_heads=2,num_layers=1,max_len=64",
            "--use_bf16=false", "--training_data=synthetic://lm?n=64&len=16&vocab=64",
            "--validation_data=synthetic://lm?n=24&len=16&vocab=64&seed=3",
            "--records_per_task=32", "--minibatch_size=8", "--evaluation_steps=4"]


def _start(root: Path, flags):
    argv = [sys.executable, "-m", "elasticdl_tpu_torch.master.main", "--model_zoo=model_zoo",
            "--device=cpu", f"--checkpoint_dir={root / 'ckpt'}", *flags]
    log = open(root / "master.log", "wb")
    proc = subprocess.Popen(argv, cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT,
                            env={**os.environ, "JAX_PLATFORMS": "cpu"})
    log.close()
    return proc


def _events(path: Path, name: str):
    return [e for e in map(json.loads, path.read_text().splitlines()) if e["event"] == name]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval_jobs")
    data = base / "data"
    _write_shards(data / "train", (512, 512), seed=0)
    _write_shards(data / "validation", (VALIDATION,), seed=1)
    files = PS_FLAGS + [f"--validation_data={data / 'validation'}"]
    train = files + [f"--training_data={data / 'train'}", "--evaluation_steps=8",
                     "--pipeline=async", "--parse_pool_workers=2"]
    plans = {"w1": train + [f"--minibatch_size={MB}", f"--output={base / 'w1' / 'out'}"],
             "w2": train + [f"--minibatch_size={MB // 2}", "--num_workers=2",
                            f"--output={base / 'w2' / 'out'}"],
             "lm": LM_FLAGS,
             "predict": PS_FLAGS + [f"--prediction_data={data / 'validation'}",
                                    "--job_type=prediction_only", f"--minibatch_size={MB}"]}
    roots, codes = {}, {}
    procs = {}
    for name, flags in plans.items():
        roots[name] = base / name
        roots[name].mkdir()
        procs[name] = _start(roots[name], flags)
    try:
        for name, proc in procs.items():
            codes[name] = proc.wait(timeout=TIMEOUT_S)
        if codes["w1"] == 0:  # evaluation only, over a copy of w1's checkpoints
            roots["eval_only"] = base / "eval_only"
            shutil.copytree(roots["w1"] / "ckpt", roots["eval_only"] / "ckpt",
                            ignore=shutil.ignore_patterns("*.jsonl", "*_worker_logs"))
            procs["eval_only"] = _start(roots["eval_only"],
                                        files + ["--job_type=evaluation_only",
                                                 f"--minibatch_size={MB}"])
            codes["eval_only"] = procs["eval_only"].wait(timeout=TIMEOUT_S)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"data": data, "roots": roots, "codes": codes}


def _log(jobs, name):
    root = jobs["roots"][name]
    out = [(root / "master.log").read_text()[-4000:]]
    for log in sorted((root / "ckpt").glob("*_worker_logs/*.log")):
        out.append(f"--- {log.name}\n" + log.read_text()[-4000:])
    return "\n".join(out)


def _in_process_metrics(out: Path, validation: Path, batch: int):
    """The zoo's metrics of the export's logits over the validation
    records, in the worker's batches (tasks of PER_TASK, batches of
    ``batch`` padded by repeating the first row)."""
    from elasticdl_tpu_torch.data.columnar import materialize_columnar_task
    from elasticdl_tpu_torch.parallel.sharding import pad_batch

    replica = ServingReplica(str(out), device="cpu")
    reader = port_deepfm.CriteoRecordReader(str(validation))
    outputs, labels = [], []
    for shard, count in reader.create_shards().items():
        for lo in range(0, count, PER_TASK):
            task = type("T", (), dict(shard_name=shard, start=lo, end=min(lo + PER_TASK, count)))
            cols = materialize_columnar_task(reader, task, port_deepfm.columnar_dataset_fn,
                                             "evaluation", None)
            for b in range(0, cols.n, batch):
                features, lab = cols.slice(b, b + batch)
                padded, _ = pad_batch(features, batch)
                outputs.append(replica.execute(padded, len(lab))[:len(lab)])
                labels.append(lab)
    outputs, labels = np.concatenate(outputs), np.concatenate(labels)
    return {k: float(np.asarray(fn(outputs, labels)))
            for k, fn in port_deepfm.eval_metrics_fn().items()}


@pytest.mark.parametrize("name,batch", [("w1", MB), ("w2", MB)])
def test_cpu_job_trains_and_evaluates_from_etrf(jobs, name, batch):
    assert jobs["codes"][name] == 0, _log(jobs, name)
    root = jobs["roots"][name]
    events = root / "ckpt" / "events.jsonl"
    rounds = _events(events, "evaluation_metrics")
    assert [r["model_version"] for r in rounds] == [8, 16], rounds
    assert all(r["examples"] == VALIDATION for r in rounds)
    worker_logs = "".join(p.read_text() for p in (root / "ckpt").glob("*_worker_logs/*.log"))
    for mode in ("training", "evaluation"):
        assert f"Columnar task path engaged ({mode}" in worker_logs
    for journal in sorted((root / "ckpt").glob("events_worker_*.jsonl")):
        done = _events(journal, "worker_task_done")
        assert done and done[-1]["etrf_per_record_reads"] == 0
        assert not done[-1]["forbidden_modules"]
        assert {e["type"] for e in done} == {"TRAINING", "EVALUATION"}
        assert _events(journal, "data_readers")[0]["record_codec"] == "native"
    got = _in_process_metrics(root / "out", jobs["data"] / "validation", batch)
    final = rounds[-1]["metrics"]
    assert final["accuracy"] == got["accuracy"]
    assert abs(final["auc"] - got["auc"]) <= 1e-4, (final, got)
    assert "Final metrics" in (root / "master.log").read_text()


def test_allreduce_lm_job_evaluates_by_the_per_record_route(jobs):
    assert jobs["codes"]["lm"] == 0, _log(jobs, "lm")
    root = jobs["roots"]["lm"]
    rounds = _events(root / "ckpt" / "events.jsonl", "evaluation_metrics")
    assert [r["model_version"] for r in rounds] == [4, 8] and all(
        r["examples"] == 24 for r in rounds), rounds
    assert all(np.isfinite(v) and v > 0 for r in rounds for v in r["metrics"].values())
    assert set(rounds[-1]["metrics"]) == {"perplexity", "accuracy"}
    worker_logs = "".join(p.read_text() for p in (root / "ckpt").glob("*_worker_logs/*.log"))
    assert "Columnar task path engaged" not in worker_logs


def test_prediction_only_job_runs_every_prediction_task(jobs):
    assert jobs["codes"]["predict"] == 0, _log(jobs, "predict")
    root = jobs["roots"]["predict"]
    events = root / "ckpt" / "events.jsonl"
    dispatched = _events(events, "task_dispatch")
    assert sorted((e["start"], e["end"]) for e in dispatched) == [(0, 256), (256, VALIDATION)]
    assert {e["type"] for e in dispatched} == {"PREDICTION"}
    assert len(_events(events, "task_done")) == 2 and not _events(events, "evaluation_metrics")
    (journal,) = (root / "ckpt").glob("events_worker_*.jsonl")
    done = _events(journal, "worker_task_done")
    assert done[-1]["process_eval_batches"] == 4 + 1 and done[-1]["process_steps"] == 0


def test_evaluation_only_job_reports_the_final_round_again(jobs):
    assert jobs["codes"]["w1"] == 0, _log(jobs, "w1")
    assert jobs["codes"]["eval_only"] == 0, _log(jobs, "eval_only")
    (round_,) = _events(jobs["roots"]["eval_only"] / "ckpt" / "events.jsonl",
                        "evaluation_metrics")
    trained = _events(jobs["roots"]["w1"] / "ckpt" / "events.jsonl", "evaluation_metrics")
    assert round_["model_version"] == 0 and round_["examples"] == VALIDATION
    assert round_["metrics"] == trained[-1]["metrics"]
