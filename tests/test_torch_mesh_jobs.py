"""The port's AllReduce job over a gloo world of two CPU workers with the
model axis as tensor parallelism and with FSDP dense state: the port's
counterpart of ``tests/test_transformer_lm.py::test_lm_cluster_e2e_cp_and_tp``.

Both jobs (``python -m elasticdl_tpu_torch.master.main``, started
together by one module fixture) train the LM on
``synthetic://lm?n=64&len=16&vocab=64``: ``--mesh_model_axis=2`` with
``model_axis_mode=tp`` (a (1, 2) mesh: heads and MLP split over the two
ranks), and ``--dense_sharding=fsdp`` (a (2, 1) mesh: the leaves JAX's
rule picks split over the two ranks).  Each must train every record,
write a checkpoint (a sharded one under FSDP, each rank's shard file),
and log the mesh that reached the model.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
N, MB, PER_TASK = 64, 8, 32
STEPS = N // (2 * MB)  # two workers' minibatches a step
PARAMS = "vocab=64,d_model=32,num_heads=2,num_layers=1,max_len=64"
FLAGS = [
    "--distribution_strategy=AllreduceStrategy", "--model_zoo=model_zoo",
    "--model_def=transformer.transformer_lm", "--use_bf16=false",
    f"--training_data=synthetic://lm?n={N}&len=16&vocab=64", f"--records_per_task={PER_TASK}",
    f"--minibatch_size={MB}", "--checkpoint_steps=4", "--num_workers=2", "--device=cpu",
]
JOBS = {
    "tp": ["--mesh_model_axis=2", f"--model_params={PARAMS},model_axis_mode=tp"],
    "fsdp": ["--dense_sharding=fsdp", f"--model_params={PARAMS}"],
}
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_jobs")
    procs = {}
    for name, flags in JOBS.items():
        root = base / name
        root.mkdir()
        with open(root / "master.log", "wb") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "elasticdl_tpu_torch.master.main", *FLAGS, *flags,
                 f"--checkpoint_dir={root / 'ckpt'}", f"--output={root / 'out'}"],
                cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT,
                env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
    codes = {}
    try:
        for name, proc in procs.items():
            codes[name] = proc.wait(timeout=TIMEOUT_S)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return base, codes


def _logs(root: Path) -> str:
    text = (root / "master.log").read_text()[-4000:]
    for log in sorted((root / "ckpt").glob("*_worker_logs/*.log")):
        text += f"\n--- {log.name}\n" + log.read_text()
    return text


def _events(path: Path):
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            break
    return out


@pytest.mark.parametrize("name,mesh", [("tp", "Mesh(1x2"), ("fsdp", "Mesh(2x1")])
def test_job_trains_every_record_checkpoints_and_reaches_the_model(jobs, name, mesh):
    base, codes = jobs
    root = base / name
    logs = _logs(root)
    assert codes[name] == 0, logs
    ckpt = root / "ckpt"
    events = _events(ckpt / "events.jsonl")
    done = {e["task_id"] for e in events if e["event"] == "task_done"}
    ranges = [(e["start"], e["end"]) for e in events
              if e["event"] == "task_dispatch" and e["task_id"] in done]
    assert sorted(ranges) == [(lo, lo + PER_TASK) for lo in range(0, N, PER_TASK)], events
    for worker in (0, 1):
        exits = [e for e in _events(ckpt / f"events_worker_{worker}.jsonl")
                 if e["event"] == "worker_exit"]
        assert exits and exits[0]["steps"] == STEPS and exits[0]["forbidden_modules"] == []
    step_dir = ckpt / f"step_{STEPS:012d}"
    if name == "fsdp":
        manifest = json.loads((step_dir / "manifest.json").read_text())
        assert manifest["n_processes"] == 2 and any(
            key.startswith("dense|.params/") for key in manifest["arrays"])
        assert sorted(p.name for p in step_dir.glob("shards_p*.npz")) == [
            "shards_p0of2.npz", "shards_p1of2.npz"]
    else:
        assert (step_dir / "state.pkl").exists()
    # The mesh reached the model in every worker.
    assert logs.count(f"Mesh-aware model: forwarding {mesh}") >= 2, logs
