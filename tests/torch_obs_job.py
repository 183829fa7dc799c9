"""One small observed CPU job of the port, shared by the observability
tests: ``python -m elasticdl_tpu_torch.master.main`` on the elastic PS
DeepFM with evaluation, TensorBoard scalars, a profiler window, the
goodput SLO and the metrics exporter, all on the CPU.

``observed_job(tmp_path_factory)`` runs it once per test session, also
across pytest-xdist workers (a lock file in the session's shared
temporary directory), and returns the directory that holds ``tb/`` (the
journals, the event file and ``profile/worker_0/``), ``ckpt/`` and
``out/``, with the master's exit code in ``rc``.
"""

from __future__ import annotations

import fcntl
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

N, VALIDATION, MB, PER_TASK, EVAL_STEPS = 512, 128, 32, 128, 8
PROFILE_STEPS = "6,8"  # inside the second task's one window of 4 steps


def job_argv(root: Path) -> list:
    return [
        sys.executable, "-m", "elasticdl_tpu_torch.master.main",
        "--distribution_strategy=ParameterServerStrategy", "--model_zoo=model_zoo",
        "--model_def=deepfm.deepfm_functional_api", "--model_params=vocab_size=100",
        f"--training_data=synthetic://criteo?n={N}&vocab=100",
        f"--validation_data=synthetic://criteo?n={VALIDATION}&vocab=100&seed=1",
        f"--evaluation_steps={EVAL_STEPS}", f"--minibatch_size={MB}",
        f"--records_per_task={PER_TASK}", "--checkpoint_steps=8", "--sparse_apply_every=1",
        f"--tensorboard_log_dir={root / 'tb'}", f"--profile_steps={PROFILE_STEPS}",
        "--slo_goodput_target=0.5", "--slo_tick_interval_s=0.2", "--metrics_port=0",
        f"--checkpoint_dir={root / 'ckpt'}", f"--output={root / 'out'}", "--device=cpu",
    ]


def _shared_root(tmp_path_factory) -> Path:
    base = tmp_path_factory.getbasetemp()
    # Under xdist each worker's base is popen-gw<N> in one session dir.
    return base.parent if base.name.startswith("popen-gw") else base


def observed_job(tmp_path_factory) -> Path:
    root = _shared_root(tmp_path_factory) / "torch_obs_job"
    root.mkdir(exist_ok=True)
    with open(root / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = root / "rc"
        if not done.exists():
            with open(root / "master.log", "w") as log:
                rc = subprocess.run(job_argv(root), cwd=str(REPO), stdout=log,
                                    stderr=subprocess.STDOUT, timeout=300).returncode
            done.write_text(str(rc))
    return root


def events(path: Path) -> list:
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def job_log(root: Path) -> str:
    text = (root / "master.log").read_text()[-4000:]
    for log in sorted((root / "ckpt").glob("*_worker_logs/*.log")):
        text += f"\n--- {log.name}\n" + log.read_text()[-3000:]
    return text
