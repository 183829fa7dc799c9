"""The port (elasticdl_tpu_torch) stands alone: it imports no JAX, no
flax/optax, no gRPC, no tensorboard (the card's machine has none of
them) and nothing of the JAX package or its model zoo, and its entry
points never drop to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from elasticdl_tpu_torch.common import device as port_device

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "elasticdl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "grpc", "google.protobuf", "model_zoo",
             "elasticdl_tpu", "tensorboard")


def _forbidden(module: str) -> bool:
    """Whole dotted names: elasticdl_tpu_torch is not elasticdl_tpu."""
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_forbidden_name_rule():
    assert _forbidden("elasticdl_tpu") and _forbidden("elasticdl_tpu.ops")
    assert _forbidden("jax.numpy") and _forbidden("grpc")
    assert _forbidden("google.protobuf") and _forbidden("google.protobuf.message")
    assert not _forbidden("google") and not _forbidden("google.cloud")
    assert not _forbidden("elasticdl_tpu_torch") and not _forbidden("jaxtyping_free")
    assert _forbidden("tensorboard") and _forbidden("tensorboard.backend.event_processing")
    assert not _forbidden("torch.utils") and not _forbidden("tensorboardX_free")


def test_port_sources_import_nothing_forbidden():
    offenders = []
    for path, _ in _port_modules():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: stays inside the port
                    continue
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert not offenders, offenders
    names = {name for _, name in _port_modules()}
    assert len(names) >= 15
    # The context-parallel slice's modules are scanned too, and their
    # transport, torch.distributed, is part of torch, not a forbidden name.
    assert {"elasticdl_tpu_torch.parallel.mesh",
            "elasticdl_tpu_torch.parallel.ring_attention"} <= names
    # So are the sharded dispatch's and K10's, and the experiment script.
    assert {"elasticdl_tpu_torch.parallel.compile",
            "elasticdl_tpu_torch.parallel.sharding",
            "elasticdl_tpu_torch.ops.sparse_gather",
            "elasticdl_tpu_torch.bench.exp_sparse_gather"} <= names
    # So are the checkpoint modules, which write the JAX package's names.
    assert {"elasticdl_tpu_torch.checkpoint._pickle",
            "elasticdl_tpu_torch.checkpoint.saver",
            "elasticdl_tpu_torch.checkpoint.sharded",
            "elasticdl_tpu_torch.checkpoint.delta"} <= names
    assert not _forbidden("torch.distributed")
    # So are the serving process and the continuous loop, with their
    # copies of the JAX package's JAX-free modules.
    assert {"elasticdl_tpu_torch.common.log_utils",
            "elasticdl_tpu_torch.common.faults",
            "elasticdl_tpu_torch.obs",
            "elasticdl_tpu_torch.obs.metrics",
            "elasticdl_tpu_torch.obs.journal",
            "elasticdl_tpu_torch.obs.freshness",
            "elasticdl_tpu_torch.obs.quality",
            "elasticdl_tpu_torch.obs.exporter",
            "elasticdl_tpu_torch.serving.ledger",
            "elasticdl_tpu_torch.serving.continuous",
            "elasticdl_tpu_torch.serving.frontend",
            "elasticdl_tpu_torch.serving.replica_main"} <= names
    # So are the elastic job's: the master, its transport, the worker.
    assert {"elasticdl_tpu_torch.common.args",
            "elasticdl_tpu_torch.common.boundary",
            "elasticdl_tpu_torch.common.constants",
            "elasticdl_tpu_torch.common.http_rpc",
            "elasticdl_tpu_torch.common.messages",
            "elasticdl_tpu_torch.common.model_utils",
            "elasticdl_tpu_torch.common.retry",
            "elasticdl_tpu_torch.data.dataset",
            "elasticdl_tpu_torch.data.reader",
            "elasticdl_tpu_torch.master.job_runner",
            "elasticdl_tpu_torch.master.main",
            "elasticdl_tpu_torch.master.pod_manager",
            "elasticdl_tpu_torch.master.rendezvous_server",
            "elasticdl_tpu_torch.master.servicer",
            "elasticdl_tpu_torch.master.task_manager",
            "elasticdl_tpu_torch.parallel.collective",
            "elasticdl_tpu_torch.parallel.elastic",
            "elasticdl_tpu_torch.worker.collective_worker",
            "elasticdl_tpu_torch.worker.main",
            "elasticdl_tpu_torch.worker.master_client"} <= names
    # So are the readers, the native codec's binding, the columnar path
    # and the evaluation service.
    assert {"elasticdl_tpu_torch.native",
            "elasticdl_tpu_torch.common.tensor_utils",
            "elasticdl_tpu_torch.data.columnar",
            "elasticdl_tpu_torch.data.odps_reader",
            "elasticdl_tpu_torch.data.recordfile",
            "elasticdl_tpu_torch.data.vectorized",
            "elasticdl_tpu_torch.master.evaluation_service"} <= names
    # So are the Local strategy's and the vision zoo's.
    assert {"elasticdl_tpu_torch.client",
            "elasticdl_tpu_torch.client.api",
            "elasticdl_tpu_torch.client.main",
            "elasticdl_tpu_torch.data.image",
            "elasticdl_tpu_torch.data.task_data_service",
            "elasticdl_tpu_torch.worker.trainer",
            "elasticdl_tpu_torch.worker.worker",
            "elasticdl_tpu_torch.zoo.vision",
            "elasticdl_tpu_torch.zoo.mnist",
            "elasticdl_tpu_torch.zoo.cifar10",
            "elasticdl_tpu_torch.zoo.resnet50"} <= names
    # So are the preprocessing layers, the CTR zoo and the supervisor.
    assert {"elasticdl_tpu_torch.preprocessing",
            "elasticdl_tpu_torch.preprocessing.layers",
            "elasticdl_tpu_torch.preprocessing.feature_column",
            "elasticdl_tpu_torch.zoo.census_wide_deep",
            "elasticdl_tpu_torch.zoo.census_feature_columns",
            "elasticdl_tpu_torch.zoo.wide_and_deep",
            "elasticdl_tpu_torch.serving.supervisor"} <= names
    # So are the elastic control plane's.
    assert {"elasticdl_tpu_torch.obs.goodput",
            "elasticdl_tpu_torch.obs.stepstats",
            "elasticdl_tpu_torch.obs.telemetry",
            "elasticdl_tpu_torch.master.policy"} <= names
    # So are the streaming master, its source and the cluster launch.
    assert {"elasticdl_tpu_torch.data.stream",
            "elasticdl_tpu_torch.master.stream",
            "elasticdl_tpu_torch.master.k8s_client",
            "elasticdl_tpu_torch.master.k8s_pod_manager",
            "elasticdl_tpu_torch.master.tpu_slice",
            "elasticdl_tpu_torch.client.submit"} <= names
    # So are the observability planes.
    assert {"elasticdl_tpu_torch.obs.tracing",
            "elasticdl_tpu_torch.obs.trace",
            "elasticdl_tpu_torch.obs.history",
            "elasticdl_tpu_torch.obs.slo",
            "elasticdl_tpu_torch.obs.report",
            "elasticdl_tpu_torch.obs.top",
            "elasticdl_tpu_torch.master.tensorboard_service",
            "elasticdl_tpu_torch.common.profiler"} <= names
    # So are the lock checker and the quality plane's label feed.
    assert {"elasticdl_tpu_torch.analysis",
            "elasticdl_tpu_torch.analysis.runtime",
            "elasticdl_tpu_torch.bench.loadgen"} <= names


_SUBPROCESS = r"""
import importlib, sys, tempfile
import numpy as np
modules = sys.argv[1].split(",")
for name in modules:
    importlib.import_module(name)
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.serving.export import load_for_serving, write_artifact
from elasticdl_tpu_torch.serving.runtime import ServingReplica
from elasticdl_tpu_torch.zoo import build_model
params = "vocab_size=20,embedding_dim=4,hidden=8"
variables, tables = convert.random_jax_variables(
    build_model("deepfm.deepfm_functional_api", params, device="meta"), seed=0)
with tempfile.TemporaryDirectory() as d:
    write_artifact(d, variables, tables,
                   {"model_def": "deepfm.deepfm_functional_api", "model_params": params})
    replica = ServingReplica(d, device="cpu")
    out = replica.execute({"dense": np.ones((2, 13), np.float32),
                           "cat": np.ones((2, 26), np.int32)}, 2)
    assert out.shape == (2,) and np.isfinite(out).all()
# Writing pickles that name optax's and the JAX package's classes, and
# reading them back, imports neither.
from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
from elasticdl_tpu_torch.parallel import optim
model = build_model("deepfm.deepfm_functional_api", params, device="cpu")
chain = convert.jax_opt_state(
    "adamw", optim.adamw(1e-3).init(dict(model.named_parameters())), model)
with tempfile.TemporaryDirectory() as d:
    saver = CheckpointSaver(d)
    saver.save({"opt_state": chain}, 1)
    state, step = saver.load_latest()
    assert step == 1 and type(state["opt_state"][0]).__name__ == "ScaleByAdamState"
forbidden = sys.argv[2].split(",")
loaded = [m for m in sys.modules
          if any(m == f or m.startswith(f + ".") for f in forbidden)]
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_port_runs_without_loading_forbidden_modules():
    modules = [name for _, name in _port_modules()]
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS, ",".join(modules), ",".join(FORBIDDEN)],
        cwd=str(REPO), capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_replica_main_import_closure_holds_no_jax_or_grpc():
    """What ``python -m elasticdl_tpu_torch.serving.replica_main`` loads
    before it serves: its imports and ``main``'s."""
    code = (
        "import sys\n"
        "from elasticdl_tpu_torch.serving import replica_main\n"
        "from elasticdl_tpu_torch.common import faults\n"
        "from elasticdl_tpu_torch.obs.exporter import MetricsExporter\n"
        "from elasticdl_tpu_torch.obs.freshness import FreshnessTracker\n"
        "from elasticdl_tpu_torch.serving.batcher import MicroBatcher\n"
        "from elasticdl_tpu_torch.serving.continuous import DeltaWatcher\n"
        "from elasticdl_tpu_torch.serving.frontend import ServingFrontend\n"
        "from elasticdl_tpu_torch.serving.ledger import ledger\n"
        "from elasticdl_tpu_torch.serving.runtime import ServingReplica\n"
        "from elasticdl_tpu_torch.obs.quality import QualityLedger\n"
        "from elasticdl_tpu_torch.bench.loadgen import run_label_feed\n"
        "print('LOADED', replica_main._loaded_forbidden())\n"
        "print('ALL', sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'grpc', 'flax', 'optax', 'elasticdl_tpu', 'model_zoo')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout and "ALL []" in proc.stdout, proc.stdout


def test_native_codec_loads_no_jax_package_module(tmp_path):
    """Building, loading and reading through the port's native ETRF
    codec (``elasticdl_tpu_torch/native``) loads nothing of the JAX
    package, its own native library included."""
    code = (
        "import sys\n"
        "from elasticdl_tpu_torch import native\n"
        "from elasticdl_tpu_torch.data import recordfile\n"
        "from elasticdl_tpu_torch.zoo import deepfm\n"
        f"path = {str(tmp_path / 'x.etrf')!r}\n"
        "recordfile.write_records(path, [b'a', b'bc'])\n"
        "assert native.record_file() is not None and recordfile.codec() == 'native'\n"
        "assert list(recordfile.read_all(path)) == [b'a', b'bc']\n"
        "assert deepfm.custom_data_reader(path).create_shards() == {path: 2}\n"
        f"forbidden = {FORBIDDEN!r}\n"
        "print('LOADED', sorted(m for m in sys.modules\n"
        "                       if any(m == f or m.startswith(f + '.') for f in forbidden)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "ELASTICDL_DISABLE_NATIVE"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("tool", ["report", "trace", "top"])
def test_obs_tools_load_nothing_forbidden(tool):
    """``python -m elasticdl_tpu_torch.obs.<tool> --help`` runs, and the
    tool's whole import closure holds no forbidden module."""
    proc = subprocess.run([sys.executable, "-m", f"elasticdl_tpu_torch.obs.{tool}", "--help"],
                          cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"elasticdl_tpu_torch.obs.{tool}" in proc.stdout
    code = (f"import sys, runpy\nsys.argv = ['x', '--help']\n"
            f"try:\n    runpy.run_module('elasticdl_tpu_torch.obs.{tool}', run_name='__main__')\n"
            f"except SystemExit:\n    pass\n"
            f"forbidden = {FORBIDDEN!r}\n"
            "print('LOADED', sorted(m for m in sys.modules\n"
            "                       if any(m == f or m.startswith(f + '.') for f in forbidden)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "LOADED []" in proc.stdout, proc.stdout + proc.stderr


def test_port_forbidden_list_is_this_tests():
    from elasticdl_tpu_torch.common import boundary

    assert set(boundary.FORBIDDEN_MODULES) == set(FORBIDDEN)


def test_master_and_worker_processes_load_nothing_forbidden(tmp_path):
    """A whole job (``python -m elasticdl_tpu_torch.master.main`` and the
    worker process it starts): each journals the forbidden modules it
    loaded at exit, and the lists are empty."""
    ckpt = tmp_path / "ckpt"
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
         "--distribution_strategy=ParameterServerStrategy", "--model_zoo=model_zoo",
         "--model_def=deepfm.deepfm_functional_api", "--model_params=vocab_size=20",
         "--training_data=synthetic://criteo?n=64&vocab=20", "--minibatch_size=32",
         "--records_per_task=32", f"--checkpoint_dir={ckpt}", "--device=cpu"],
        cwd=str(REPO), capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    import json

    def events(name):
        return [json.loads(line) for line in (ckpt / name).read_text().splitlines()]

    master = [e for e in events("events.jsonl") if e["event"] == "master_exit"]
    worker = [e for e in events("events_worker_0.jsonl") if e["event"] == "worker_exit"]
    assert master and master[0]["forbidden_modules"] == [] and master[0]["succeeded"]
    assert worker and worker[0]["forbidden_modules"] == [] and worker[0]["steps"] == 2
    assert "worker exit:" in (ckpt / "elasticdl-job_worker_logs" / "worker_0.log").read_text()


def test_job_refuses_to_start_without_a_card(monkeypatch):
    from elasticdl_tpu_torch.master import main as master_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        master_main.main(["--distribution_strategy=ParameterServerStrategy",
                          "--model_zoo=model_zoo", "--model_def=deepfm.deepfm_functional_api",
                          "--training_data=synthetic://criteo?n=64&vocab=20"])


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from elasticdl_tpu_torch.serving.export import load_for_serving
    from elasticdl_tpu_torch.serving.runtime import ServingReplica

    from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.zoo import build_model, deepfm, transformer_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (load_for_serving, ServingReplica):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("deepfm.deepfm_functional_api", "vocab_size=10")
    model = build_model("deepfm.deepfm_functional_api", "vocab_size=10", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEmbeddingTrainer(model, deepfm.loss, deepfm.optimizer())
    lm_params = "vocab=16,d_model=16,num_heads=2,num_layers=1"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("transformer.transformer_lm", lm_params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer_lm.custom_model(vocab=16, d_model=16, num_heads=2, num_layers=1)
    lm = build_model("transformer.transformer_lm", lm_params, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataParallelTrainer(lm, transformer_lm.loss, transformer_lm.optimizer())
    from elasticdl_tpu_torch.parallel.mesh import virtual_devices

    with pytest.raises(RuntimeError, match="no CUDA device"):
        virtual_devices(4)
    from elasticdl_tpu_torch.bench import exp_sparse_gather

    for measure in (exp_sparse_gather.main, exp_sparse_gather.main_shard_map):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            measure(64, 320)
    # The profiler window profiles the card, CUDA activity included.
    from elasticdl_tpu_torch.common import profiler

    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler.StepProfiler(str(tmp_path), "1,2")
    assert torch.profiler.ProfilerActivity.CUDA in profiler.profiler_activities(
        torch.device("cuda"))
    assert profiler.StepProfiler(str(tmp_path), "1,2", device="cpu").activities == [
        torch.profiler.ProfilerActivity.CPU]


def test_vision_entry_points_default_to_the_card(monkeypatch):
    from elasticdl_tpu_torch.worker.trainer import Trainer
    from elasticdl_tpu_torch.zoo import (build_model, census_feature_columns, census_wide_deep,
                                         cifar10, mnist, resnet50, wide_and_deep)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model_def in ("mnist.mnist_functional_api", "mnist.mnist_subclass",
                      "cifar10.cifar10_functional_api", "resnet50.resnet50_subclass",
                      "census.census_wide_deep", "census.census_feature_columns",
                      "wide_and_deep.wide_and_deep"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(model_def, "")
    for zoo in (mnist, cifar10, resnet50, census_wide_deep, census_feature_columns,
                wide_and_deep):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            zoo.custom_model()
    model = mnist.custom_model(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, mnist.loss, mnist.optimizer())


_ANALYZER_WITHOUT_TORCH = """
import runpy
import sys

# torch, numpy and the JAX package made unimportable: the analyzer and
# the journal registry run on the standard library alone.
for name in ("torch", "numpy", "jax", "elasticdl_tpu"):
    sys.modules[name] = None
sys.argv = sys.argv[1:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
except SystemExit as exc:
    code = exc.code
else:
    code = 0
print("LOADED", sorted(m for m in sys.modules if sys.modules[m] is not None
                       and m.split(".")[0] in ("torch", "numpy", "jax", "elasticdl_tpu")))
sys.exit(code)
"""


@pytest.mark.parametrize("argv", [
    ["elasticdl_tpu_torch.analysis", "elasticdl_tpu_torch"],
    ["elasticdl_tpu_torch.analysis.journal_schema", "--selftest"],
    ["elasticdl_tpu_torch.analysis.journal_schema", "--check-sources"],
], ids=["analysis-cli", "journal-selftest", "journal-check-sources"])
def test_analyzer_runs_without_torch_or_the_jax_package(argv):
    proc = subprocess.run([sys.executable, "-c", _ANALYZER_WITHOUT_TORCH, *argv],
                          cwd=str(REPO), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_analyzer_modules_import_the_standard_library_only():
    """The static analyzer and the journal registry (the runtime lock
    checker, ``runtime.py``, logs through ``common/log_utils``)."""
    offenders = []
    for path in sorted((PORT / "analysis").glob("*.py")):
        if path.name == "runtime.py":
            continue
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root not in sys.stdlib_module_names and not name.startswith(
                        "elasticdl_tpu_torch.analysis"):
                    offenders.append(f"{path.name}:{node.lineno} {name}")
    assert not offenders, offenders

