"""The port's AllReduce job on ResNet-20 as processes on the CPU, under
the elastic control plane: ``python -m elasticdl_tpu_torch.master.main
--distribution_strategy=AllreduceStrategy --device=cpu`` with its
``LocalProcessManager`` workers (f32, ``synthetic://cifar10``).

- **Elastic drill**: a gloo world of 3 with ``--max_worker_restarts=0``
  and an ``ELASTICDL_CAPACITY_FILE`` holding 0.  Once a checkpoint is
  committed and a task is in flight, one worker is SIGKILLed: the world
  shrinks to 2 and restores.  The test then writes 1 to the capacity
  file; the policy engine's ``gate_scale_up`` approves once the churn's
  redo is repaid and its cooldown is over, and the world regrows to 3.
  Two rescales within the engine's thrash window would park the fleet
  at ``--policy_min_workers``; the floor is 3 here, so it holds.
  Every record is trained; the ledger books both rescales (detection,
  rendezvous, redo), its phases sum to its wall; ``batch_stats`` (their
  CRC32 in the journals) come through each save and restore bit for bit
  and agree on every rank; the journals pass
  ``scripts/validate_journal.py``.  The master runs through
  ``tests/torch_allreduce_master.py``, which only shortens the policy's
  post-rescale cooldown (30 s by default) to fit a test.
- **One checkpoint, both packages**: the JAX package's AllReduce job and
  the port's, each a world of one (JAX's multi-process CPU collectives do
  not run here), restore one checkpoint the port's ``DataParallelTrainer``
  wrote after a step and train the same next step; the exports agree
  within ``JOB_TOL`` (relative L2 over the params, and over the
  ``batch_stats``; measured 1.5e-4 and 6e-7).  One step: at the zoo's
  learning rate (SGD 0.1, Nesterov) the two frameworks' f32 rounding of
  21 train-mode batch norms grows about 25-fold a step (3.7e-3 and 4e-4
  after two), as ``tests/test_torch_vision_training.py`` explains; it
  holds 3 steps at 1e-3.  ``--policy_enabled=false`` leaves the engine
  off.
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

from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.serving.export import read_variables
from elasticdl_tpu_torch.worker.collective_worker import state_digest
from elasticdl_tpu_torch.zoo import cifar10

REPO = Path(__file__).resolve().parent.parent
MB = 8
FLAGS = [
    "--distribution_strategy=AllreduceStrategy", "--model_zoo=model_zoo",
    "--model_def=cifar10.cifar10_functional_api", "--model_params=use_bf16=false",
]
N_DRILL = 576
TIMEOUT_S = 240
JOB_TOL = {"params/": 1e-3, "batch_stats/": 1e-5}


def _start(root: Path, flags, env=None, package="elasticdl_tpu_torch"):
    root.mkdir(parents=True, exist_ok=True)
    if package == "elasticdl_tpu_torch":
        head = [sys.executable, str(REPO / "tests" / "torch_allreduce_master.py")]
    else:
        head = [sys.executable, "-m", f"{package}.master.main"]
    argv = [*head, *flags, f"--checkpoint_dir={root / 'ckpt'}", f"--output={root / 'out'}"]
    log = open(root / "master.log", "wb")
    proc = subprocess.Popen(argv, cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT,
                            env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
                                 "ELASTICDL_FORCE_PLATFORM": "cpu", **(env or {})})
    log.close()
    return proc


def _events(path: Path):
    if not path.exists():
        return []
    records = []
    for line in path.read_text().splitlines():
        try:
            records.append(json.loads(line))
        except ValueError:
            break
    return records


def _wait(predicate, deadline):
    while time.time() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    return None


def _drill(root: Path, record: dict):
    """Kill rank 0 of the first world (the rank that holds the task) after
    a committed save with a task in flight; once the world of 2 has
    formed, return one slot."""
    deadline = time.time() + TIMEOUT_S
    journal = root / "ckpt" / "events.jsonl"

    def saved():
        return [e for e in _events(root / "ckpt" / "events_worker_0.jsonl")
                if e["event"] == "checkpoint_saved" and e["step"] >= 4]

    if not _wait(saved, deadline):
        return
    since = time.time()

    def in_flight():
        events = _events(journal)
        done = {e["task_id"] for e in events if e["event"] == "task_done"}
        return [e for e in events if e["event"] == "task_dispatch" and e["ts"] >= since
                and e["task_id"] not in done]

    if not _wait(in_flight, deadline):
        return
    victim = [e for e in _events(journal) if e["event"] == "worker_launch"
              and e["worker_id"] == 0]
    record["killed_at_step"] = saved()[-1]["step"]
    os.kill(victim[0]["pid"], signal.SIGKILL)
    record["pid"] = victim[0]["pid"]
    shrunk = _wait(lambda: [e for e in _events(journal)
                            if e["event"] == "rendezvous" and e["world_size"] == 2], deadline)
    if shrunk:
        (root / "capacity").write_text("1")
        record["capacity_at"] = time.time()


def _seed_checkpoint(directory: Path) -> None:
    """One step of the port's ``DataParallelTrainer``, saved (step 1)."""
    trainer = DataParallelTrainer(cifar10.custom_model(use_bf16=False, device="cpu"),
                                  cifar10.loss, cifar10.optimizer(), device="cpu", seed=3)
    rng = np.random.default_rng(11)
    images = rng.standard_normal((32, 32, 32, 3)).astype(np.float32)
    trainer.train_step(images, rng.integers(0, 10, 32).astype(np.int32))
    CheckpointSaver(str(directory)).save(trainer.state_to_jax_host(), trainer.step)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    base = tmp_path_factory.mktemp("allreduce")
    roots = {name: base / name for name in ("drill", "port", "jax")}
    seed = base / "seed"
    _seed_checkpoint(seed)
    for name in ("port", "jax"):
        shutil.copytree(seed, roots[name] / "ckpt")
    (roots["drill"]).mkdir()
    (roots["drill"] / "capacity").write_text("0")
    one = [*FLAGS, "--training_data=synthetic://cifar10?n=32", "--minibatch_size=32",
           "--records_per_task=32", "--checkpoint_steps=100"]
    procs = {
        "drill": _start(roots["drill"], [
            *FLAGS, "--device=cpu", f"--training_data=synthetic://cifar10?n={N_DRILL}",
            f"--minibatch_size={MB}", "--records_per_task=24", "--num_workers=3",
            "--max_worker_restarts=0", "--checkpoint_steps=4", "--policy_tick_interval_s=0.5",
            "--policy_min_workers=3"],
            env={"ELASTICDL_CAPACITY_FILE": str(roots["drill"] / "capacity"),
                 "ELASTICDL_FAULTS": "rpc.get_task:latency=0.5@1x*"}),
        "port": _start(roots["port"], [*one, "--device=cpu", "--policy_enabled=false"]),
        "jax": _start(roots["jax"], one, package="elasticdl_tpu",
                      env={"ELASTICDL_WORKER_ENV":
                           "XLA_FLAGS=--xla_force_host_platform_device_count=1",
                           "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}),
    }
    drill = {}
    killer = threading.Thread(target=_drill, args=(roots["drill"], drill))
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
    return {"roots": roots, "codes": codes, "drill": drill}


def _log(jobs, name):
    root = jobs["roots"][name]
    out = [(root / "master.log").read_text()[-6000:]]
    for log in sorted((root / "ckpt").glob("*_worker_logs/*.log")):
        out.append(f"--- {log.name}\n" + log.read_text()[-3000:])
    return "\n".join(out)


def _ok(jobs, name):
    assert jobs["codes"][name] == 0, _log(jobs, name)


def _master_events(jobs, name):
    return _events(jobs["roots"][name] / "ckpt" / "events.jsonl")


def _worker_events(jobs, name):
    ckpt = jobs["roots"][name] / "ckpt"
    return {int(p.stem.rsplit("_", 1)[1]): _events(p)
            for p in ckpt.glob("events_worker_*.jsonl")}


def test_world_of_three_shrinks_on_a_kill_and_regrows_through_the_policy_gate(jobs):
    _ok(jobs, "drill")
    assert "pid" in jobs["drill"] and "capacity_at" in jobs["drill"], _log(jobs, "drill")
    events = _master_events(jobs, "drill")
    worlds = [(e["world_size"], e["workers"]) for e in events if e["event"] == "rendezvous"]
    assert [size for size, _ in worlds] == [3, 2, 3], worlds
    assert [w for _, w in worlds] == [[0, 1, 2], [3, 4], [5, 6, 7]]
    churn = [e for e in events if e["event"] == "worker_churn"]
    assert len(churn) == 1 and churn[0]["workers"][0] == 0 and churn[0]["exit_codes"][0] == -9
    assert churn[0]["budget_left"] is False
    (scale_up,) = [e for e in events if e["event"] == "scale_up"]
    assert (scale_up["old_size"], scale_up["new_size"]) == (2, 3)
    decisions = [e for e in events if e["event"] == "policy_decision"]
    (approved,) = [d for d in decisions if d["action"] == "scale_up"]
    assert approved["reason"] == "amortized" and approved["granted"] == 1
    assert approved["ts"] <= scale_up["ts"] and approved["ts"] >= jobs["drill"]["capacity_at"]
    # The gate held while the churn's redo was unpaid or cooling down.
    holds = {d["reason"] for d in decisions if d["action"] == "hold"}
    assert holds & {"rescale_in_flight", "cooldown"}, holds
    # Every record range is trained, the in-flight ones after the churn.
    dispatched = {e["task_id"]: (e["start"], e["end"]) for e in events
                  if e["event"] == "task_dispatch"}
    done = [dispatched[e["task_id"]] for e in events if e["event"] == "task_done"]
    assert sorted({r for lo, hi in done for r in range(lo, hi)}) == list(range(N_DRILL))
    requeued = [e for e in events if e["event"] == "task_requeue"]
    assert requeued and requeued[0]["reason"] == "worker_churn"
    assert [d["action"] for d in decisions if d["action"] != "hold"] == ["scale_up"]


def test_the_ledger_books_both_rescales_and_sums_to_its_wall(jobs):
    _ok(jobs, "drill")
    events = _master_events(jobs, "drill")
    costs = [e for e in events if e["event"] == "rescale_cost"]
    assert [c["cause"] for c in costs] == ["worker_churn", "scale_up"]
    churn_cost = costs[0]
    assert (churn_cost["old_size"], churn_cost["new_size"]) == (3, 2)
    assert churn_cost["redo_records"] > 0 and not churn_cost["superseded"]
    for cost in costs:
        parts = cost["detection_s"] + cost["rendezvous_s"] + cost["redo_s"]
        assert parts == pytest.approx(cost["total_s"], abs=3e-6) and cost["total_s"] > 0
    (summary,) = [e for e in events if e["event"] == "goodput_summary"]
    assert summary["outcome"] == "job_complete" and summary["rescales"] == 2
    assert summary["wall_s"] == pytest.approx(sum(summary["phases"].values()), rel=1e-6)
    assert 0 < summary["goodput_ratio"] < 1
    assert summary["phases"]["requeue_redo"] > 0 and summary["phases"]["rendezvous"] > 0
    assert summary["records_done"] >= N_DRILL and summary["records_redone"] > 0
    transitions = [e for e in events if e["event"] == "phase_transition"]
    assert {"scaling_wait", "requeue_redo", "training"} <= {e["to"] for e in transitions}


def _digest(record):
    return record["state_crc32"], record["model_state_crc32"]


def test_batch_stats_come_through_save_and_restore_and_agree_across_ranks(jobs):
    """``state_crc32`` covers params, the SGD trace and ``batch_stats``;
    ``model_state_crc32`` the ``batch_stats`` alone."""
    _ok(jobs, "drill")
    workers = _worker_events(jobs, "drill")
    assert sorted(workers) == list(range(8))
    saved = {}  # step -> {the digests of every rank that saved it}
    for events in workers.values():
        for e in events:
            if e["event"] == "checkpoint_saved":
                saved.setdefault(e["step"], set()).add(_digest(e))
    assert saved and all(len(digests) == 1 for digests in saved.values()), saved
    ranks_saving = {}
    for w, events in workers.items():
        for e in events:
            if e["event"] == "checkpoint_saved":
                ranks_saving.setdefault(e["step"], set()).add(w)
    assert any(len(ws) == 3 for ws in ranks_saving.values())  # every rank of a world of 3
    ckpt = jobs["roots"]["drill"] / "ckpt"
    for w in range(3, 8):  # both re-formed worlds restored
        (restore,) = [e for e in workers[w] if e["event"] == "checkpoint_restore"]
        assert _digest(restore) == next(iter(saved[restore["step"]]))
    final_restores = {e["step"] for w in (5, 6, 7) for e in workers[w]
                      if e["event"] == "checkpoint_restore"}
    assert len(final_restores) == 1
    # What the file holds is what the journal saw.
    state, step = CheckpointSaver(str(ckpt)).load_latest()
    digest = state_digest(state)
    assert (digest["state_crc32"], digest["model_state_crc32"]) == next(iter(saved[step]))
    for w in (5, 6, 7):
        exits = [e for e in workers[w] if e["event"] == "worker_exit"]
        assert exits and exits[0]["forbidden_modules"] == []


def test_the_journals_pass_the_jax_schema(jobs):
    _ok(jobs, "drill")
    from elasticdl_tpu_torch import obs

    ckpt = jobs["roots"]["drill"] / "ckpt"
    paths = sorted(str(p) for p in ckpt.glob("events*.jsonl"))
    check = subprocess.run([sys.executable, str(REPO / "scripts" / "validate_journal.py"),
                            *paths], capture_output=True, text=True, timeout=60)
    assert check.returncode == 0, check.stdout + check.stderr
    kinds = set()
    for path in paths:
        for record in _events(Path(path)):
            assert obs.missing_fields(record) == (), record
            kinds.add(record["event"])
    assert {"phase_transition", "rescale_cost", "goodput_summary", "policy_decision",
            "scale_up"} <= kinds
    # The workers' anatomy windows: one per flush, on every rank.
    anatomy = [e for e in _events(ckpt / "events_worker_0.jsonl")
               if e["event"] == "phase_transition"]
    assert {"rendezvous", "training"} <= {e["to"] for e in anatomy}


def _exported(root: Path):
    flat = convert.flatten_variables(read_variables(str(root / "out" / "variables.pkl")))
    return {k: np.asarray(v, np.float64) for k, v in flat.items()
            if np.asarray(v).dtype.kind == "f"}


def _rel_l2(got, want, prefix):
    keys = sorted(k for k in want if k.startswith(prefix))
    g = np.concatenate([np.ravel(got[k]) for k in keys])
    w = np.concatenate([np.ravel(want[k]) for k in keys])
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def test_port_job_matches_the_jax_job_from_one_checkpoint(jobs):
    _ok(jobs, "port")
    _ok(jobs, "jax")
    jax_vars, port_vars = _exported(jobs["roots"]["jax"]), _exported(jobs["roots"]["port"])
    assert sorted(port_vars) == sorted(jax_vars)
    for prefix, tol in JOB_TOL.items():
        assert _rel_l2(port_vars, jax_vars, prefix) <= tol, prefix
    sigs = [json.loads((jobs["roots"][n] / "out" / "signature.json").read_text())
            for n in ("port", "jax")]
    assert sigs[0]["step"] == sigs[1]["step"] == 2
    restores = [e for e in _worker_events(jobs, "port")[0] if e["event"] == "checkpoint_restore"]
    assert [e["step"] for e in restores] == [1]
    events = _master_events(jobs, "port")
    assert not [e for e in events if e["event"] == "policy_decision"]  # the engine is off
    (summary,) = [e for e in events if e["event"] == "goodput_summary"]
    assert summary["rescales"] == 0 and summary["phases"]["training"] > 0
