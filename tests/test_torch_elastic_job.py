"""The elastic job as a process tree on one host, on the CPU: the port's
``python -m elasticdl_tpu_torch.master.main`` (master, task dispatch,
rendezvous, worker processes over HTTP) against the JAX package's job,
and alone: a gloo world of two, a worker SIGKILLed mid-job, async
staging, and the AllReduce arm training the LM in worlds of one and two.

Every job here starts together (one module fixture), and each is read
by its own test.  The PS jobs train DeepFM at vocab 100 per field
(``embedding_dim`` 4, ``hidden`` 16) on ``synthetic://criteo?n=512&vocab=100``,
8 steps of 64 records, from one sharded checkpoint written beforehand
by the port's trainer in the JAX package's layout, which both packages
restore.  Tolerances: the JAX job and the port's job end within
``FINAL_TOL`` (``tests/test_torch_training.py``) on every element but
the sign-sensitive ones, which Adam can move by up to ``2·lr`` a step in
one framework and not the other; the per-step gradients that would name
them stay inside the worker processes, so every element is held to
``2·lr·steps`` and at most 0.5% of them may miss ``FINAL_TOL`` (the rule
of ``test_train_window_matches_jax_windowed_apply``).  A world of two
against a world of one with the same global batches: ``FINAL_TOL`` on
every element.  Async staging against sync: bit for bit.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver
from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
from elasticdl_tpu_torch.serving.export import read_variables
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import deepfm as port_zoo

REPO = Path(__file__).resolve().parent.parent
FINAL_TOL = dict(rtol=1e-5, atol=1e-6)
PS_LR, LM_LR = 1e-3, 3e-3
N, MB, PER_TASK = 512, 64, 128
PARAMS = "vocab_size=100,embedding_dim=4,hidden=16"
PS_FLAGS = [
    "--distribution_strategy=ParameterServerStrategy", "--model_zoo=model_zoo",
    "--model_def=deepfm.deepfm_functional_api", f"--model_params={PARAMS}",
    f"--training_data=synthetic://criteo?n={N}&vocab=100", f"--records_per_task={PER_TASK}",
    "--checkpoint_steps=100", "--sparse_apply_every=1",
]
LM_FLAGS = [
    "--distribution_strategy=AllreduceStrategy", "--model_zoo=model_zoo",
    "--model_def=transformer.transformer_lm",
    "--model_params=vocab=64,d_model=32,num_heads=2,num_layers=1,max_len=64",
    "--use_bf16=false", "--training_data=synthetic://lm?n=64&len=16&vocab=64",
    "--records_per_task=32", "--checkpoint_steps=4", "--device=cpu",
]
TIMEOUT_S = 240


def _seed_checkpoint(directory: Path) -> None:
    """One step of the port's trainer, saved sharded (step 1)."""
    model = build_model("deepfm.deepfm_functional_api", PARAMS, device="cpu")
    trainer = ShardedEmbeddingTrainer(model, port_zoo.loss, port_zoo.optimizer(),
                                      embedding_optimizer=port_zoo.embedding_optimizer(),
                                      device="cpu", seed=5)
    feats, labels = synthetic_ctr_arrays(MB, vocab_size=100, seed=9)
    trainer.train_step(feats, labels)
    trainer.save_checkpoint(ShardedCheckpointSaver(str(directory)), trainer.step)


def _start(package: str, root: Path, flags, env=None):
    root.mkdir(parents=True, exist_ok=True)
    argv = [sys.executable, "-m", f"{package}.master.main", *flags,
            f"--checkpoint_dir={root / 'ckpt'}", f"--output={root / 'out'}"]
    log = open(root / "master.log", "wb")
    proc = subprocess.Popen(argv, cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT,
                            env={**os.environ, "JAX_PLATFORMS": "cpu",
                                 "ELASTICDL_FORCE_PLATFORM": "cpu", **(env or {})})
    log.close()
    return proc


def _events(path: Path):
    """A journal's records; a last line still being written is skipped."""
    if not path.exists():
        return []
    records = []
    for line in path.read_text().splitlines():
        try:
            records.append(json.loads(line))
        except ValueError:
            break
    return records


def _in_flight(events, since_ts):
    done = {e["task_id"] for e in events if e["event"] == "task_done"}
    return [e["task_id"] for e in events if e["event"] == "task_dispatch"
            and e["worker_id"] == 0 and e["ts"] >= since_ts and e["task_id"] not in done]


def _kill_after_checkpoint(root: Path, step: int, record: dict):
    """SIGKILL worker 0 (the master's child, by its exact pid) once the
    step-``step`` checkpoint is committed and a task dispatched after it
    is in flight."""
    deadline = time.time() + TIMEOUT_S
    committed = root / "ckpt" / f"step_{step:012d}" / "manifest.json"
    journal = root / "ckpt" / "events.jsonl"
    while time.time() < deadline and not committed.exists():
        time.sleep(0.02)
    if not committed.exists():
        return
    since = committed.stat().st_mtime
    while time.time() < deadline and not _in_flight(_events(journal), since):
        time.sleep(0.02)
    launches = [e for e in _events(journal)
                if e["event"] == "worker_launch" and e["worker_id"] == 0]
    if launches and _in_flight(_events(journal), since):
        record["pid"] = launches[0]["pid"]
        os.kill(record["pid"], signal.SIGKILL)
        record["t"] = time.time()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    base = tmp_path_factory.mktemp("jobs")
    seed = base / "seed"
    _seed_checkpoint(seed)
    plans = {
        "jax": ("elasticdl_tpu", [f"--minibatch_size={MB}"], None),
        "port": ("elasticdl_tpu_torch", [f"--minibatch_size={MB}", "--device=cpu"], None),
        "port_async": ("elasticdl_tpu_torch", [f"--minibatch_size={MB}", "--device=cpu",
                                               "--pipeline=async", "--parse_pool_workers=2"],
                       None),
        "port_w2": ("elasticdl_tpu_torch", [f"--minibatch_size={MB // 2}", "--device=cpu",
                                            "--num_workers=2"], None),
        "kill": ("elasticdl_tpu_torch", [f"--minibatch_size={MB // 2}", "--device=cpu",
                                         "--records_per_task=64", "--checkpoint_steps=4"],
                 {"ELASTICDL_FAULTS": "rpc.get_task:latency=0.4@1x*"}),
    }
    procs, roots = {}, {}
    for name, (package, flags, env) in plans.items():
        roots[name] = base / name
        if name != "kill":  # the restoring jobs start from a copy of the seed
            shutil.copytree(seed, roots[name] / "ckpt")
        procs[name] = _start(package, roots[name], PS_FLAGS + flags, env)
    for world in (1, 2):
        name = f"lm{world}"
        roots[name] = base / name
        procs[name] = _start("elasticdl_tpu_torch", roots[name],
                             LM_FLAGS + [f"--num_workers={world}",
                                         f"--minibatch_size={8 // world}"])
    kill = {}
    killer = threading.Thread(target=_kill_after_checkpoint, args=(roots["kill"], 4, kill))
    killer.start()
    codes = {}
    try:
        for name, proc in procs.items():
            codes[name] = proc.wait(timeout=TIMEOUT_S)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        killer.join(timeout=TIMEOUT_S)
    return {"roots": roots, "codes": codes, "kill": kill}


def _log(jobs, name):
    root = jobs["roots"][name]
    out = [(root / "master.log").read_text()[-4000:]]
    for log in sorted((root / "ckpt").glob("*_worker_logs/*.log")):
        out.append(f"--- {log.name}\n" + log.read_text()[-4000:])
    return "\n".join(out)


def _ok(jobs, name):
    assert jobs["codes"][name] == 0, _log(jobs, name)


def _exported(root: Path):
    """The artifact's variables, flat, with each table's packed rows."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for key, value in tree.items():
                walk(value, path + [key])
        elif np.asarray(tree).dtype.kind == "f":  # not a table's file reference
            out["/".join(path)] = np.asarray(tree)

    walk(read_variables(str(root / "out" / "variables.pkl")), [])
    signature = json.loads((root / "out" / "signature.json").read_text())
    for table in signature["tables"]:
        out["table/" + table["key"]] = np.load(root / "out" / table["file"])
    return signature, out


def _hold_adam_bound(ref, got, lr, steps):
    assert sorted(ref) == sorted(got)
    loose, total = [], 0
    for name, want in ref.items():
        diff = np.abs(got[name] - want)
        assert diff.max() <= 2 * lr * steps + 1e-6, name
        tight = diff <= FINAL_TOL["atol"] + FINAL_TOL["rtol"] * np.abs(want)
        loose += [(name, tuple(int(i) for i in idx)) for idx in np.argwhere(~tight)]
        total += want.size
    assert len(loose) <= 0.005 * total, loose[:20]


def test_port_ps_job_matches_the_jax_job_from_one_checkpoint(jobs):
    _ok(jobs, "jax")
    _ok(jobs, "port")
    jax_sig, jax_vars = _exported(jobs["roots"]["jax"])
    port_sig, port_vars = _exported(jobs["roots"]["port"])
    steps = N // MB
    assert jax_sig["step"] == port_sig["step"] == 1 + steps  # both restored step 1
    assert jax_sig["model_params"] == port_sig["model_params"]
    assert jax_sig["tables"] == port_sig["tables"]
    _hold_adam_bound(jax_vars, port_vars, PS_LR, steps)
    events = _events(jobs["roots"]["port"] / "ckpt" / "events_worker_0.jsonl")
    assert [e["step"] for e in events if e["event"] == "checkpoint_restore"] == [1]


def test_async_staging_trains_the_sync_variables(jobs):
    _ok(jobs, "port")
    _ok(jobs, "port_async")
    _, sync_vars = _exported(jobs["roots"]["port"])
    _, async_vars = _exported(jobs["roots"]["port_async"])
    for name, want in sync_vars.items():
        np.testing.assert_array_equal(async_vars[name], want, err_msg=name)


def test_gloo_world_of_two_trains_and_checkpoints(jobs):
    _ok(jobs, "port_w2")
    root = jobs["roots"]["port_w2"]
    final = root / "ckpt" / f"step_{1 + N // MB:012d}"
    assert sorted(p.name for p in final.glob("shards_*")) == ["shards_p0of2.npz",
                                                             "shards_p1of2.npz"]
    steps = [[e["steps"] for e in _events(root / "ckpt" / f"events_worker_{w}.jsonl")
              if e["event"] == "worker_task_done"] for w in (0, 1)]
    assert steps[0] == steps[1] == [PER_TASK // MB] * (N // PER_TASK)  # lockstep
    rendezvous = [e for e in _events(root / "ckpt" / "events.jsonl") if e["event"] == "rendezvous"]
    assert [(e["world_size"], e["workers"]) for e in rendezvous] == [(2, [0, 1])]
    _, one = _exported(jobs["roots"]["port"])
    _, two = _exported(root)
    for name, want in one.items():
        np.testing.assert_allclose(two[name], want, err_msg=name, **FINAL_TOL)


def test_worker_sigkilled_mid_job_reforms_restores_and_finishes(jobs):
    _ok(jobs, "kill")
    root = jobs["roots"]["kill"]
    assert "pid" in jobs["kill"], _log(jobs, "kill")
    events = _events(root / "ckpt" / "events.jsonl")
    churn = [e for e in events if e["event"] == "worker_churn"]
    assert len(churn) == 1 and churn[0]["workers"] == [0] and churn[0]["exit_codes"] == [-9]
    requeued = [e for e in events if e["event"] == "task_requeue"]
    assert [e["reason"] for e in requeued] == ["worker_churn"] and requeued[0]["task_ids"]
    assert [e["workers"] for e in events if e["event"] == "rendezvous"] == [[0], [1]]
    # Every record range is done, the in-flight one after the churn.
    dispatched = {e["task_id"]: (e["start"], e["end"]) for e in events
                  if e["event"] == "task_dispatch"}
    done = sorted(dispatched[e["task_id"]] for e in events if e["event"] == "task_done")
    covered = sorted({r for lo, hi in done for r in range(lo, hi)})
    assert covered == list(range(N))
    assert dispatched[requeued[0]["task_ids"][0]] in done
    new = _events(root / "ckpt" / "events_worker_1.jsonl")
    restored = [e["step"] for e in new if e["event"] == "checkpoint_restore"]
    saved = [e["step"] for e in _events(root / "ckpt" / "events_worker_0.jsonl")
             if e["event"] == "checkpoint_saved"]
    assert restored == [max(saved)] and restored[0] >= 4  # the dead worker's last save
    exported = [e for e in new if e["event"] == "model_exported"]
    assert exported and exported[0]["step"] == json.loads(
        (root / "out" / "signature.json").read_text())["step"]
    master_exit = [e for e in events if e["event"] == "master_exit"]
    assert master_exit[-1]["succeeded"] and master_exit[-1]["restarts_used"] == 1


def test_allreduce_lm_in_worlds_of_one_and_two(jobs):
    _ok(jobs, "lm1")
    _ok(jobs, "lm2")
    sig1, one = _exported(jobs["roots"]["lm1"])
    sig2, two = _exported(jobs["roots"]["lm2"])
    assert sig1["step"] == sig2["step"] == 8 and not sig1["tables"]
    # The key projection's bias has a zero gradient (softmax ignores a
    # shift shared by every key), so Adam moves it by reduction noise.
    _hold_adam_bound(one, two, LM_LR, 8)
    for world in (1, 2):
        ckpt = jobs["roots"][f"lm{world}"] / "ckpt"
        assert (ckpt / f"step_{8:012d}" / "state.pkl").exists()
        for w in range(world):
            exits = [e for e in _events(ckpt / f"events_worker_{w}.jsonl")
                     if e["event"] == "worker_exit"]
            assert exits and exits[0]["steps"] == 8 and exits[0]["forbidden_modules"] == []
