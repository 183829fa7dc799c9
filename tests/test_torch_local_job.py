"""The port's Local strategy end to end on the CPU: ``python -m
elasticdl_tpu_torch.client.main train --distribution_strategy=Local``
(the master and the ``Worker`` in one process), a bare Local master with
a worker process started by hand, exports read by both packages, a JAX
export evaluated by the port's ``Trainer``, and the SGD-trace and
``batch_stats`` checkpoints both ways."""

import json
import re
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.checkpoint import CheckpointSaver as JaxSaver
from elasticdl_tpu.parallel.dp_trainer import DataParallelTrainer as JaxDPTrainer
from elasticdl_tpu.serving.export import export_model as jax_export_model
from elasticdl_tpu.serving.export import load_for_serving as jax_load_for_serving
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.checkpoint import _pickle
from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver
from elasticdl_tpu_torch.client import main as client_main
from elasticdl_tpu_torch.data.image import write_image_etrf
from elasticdl_tpu_torch.data.synthetic import SyntheticImagenetReader
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.serving.export import load_for_serving, read_variables
from elasticdl_tpu_torch.worker.trainer import Trainer, TrainState
from elasticdl_tpu_torch.zoo import cifar10, mnist, resnet50
from model_zoo import datasets as jax_datasets
from model_zoo.mnist import mnist_functional_api as jax_mnist

REPO = Path(__file__).resolve().parent.parent
MNIST = ["--model_zoo=model_zoo", "--model_def=mnist.mnist_functional_api"]


def _run(argv, timeout=600):
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=str(REPO), capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout + proc.stderr


def _final_metrics(log):
    found = re.findall(r"Final metrics: (\{.*\})", log)
    assert found, log[-3000:]
    return eval(found[-1], {"__builtins__": {}}, {"np": np})  # a dict of floats


def _journal(path, event):
    return [e for e in map(json.loads, Path(path).read_text().splitlines())
            if e["event"] == event]


def test_local_mnist_job_trains_evaluates_and_exports_for_both_packages(tmp_path):
    out = tmp_path / "out"
    log = _run(["elasticdl_tpu_torch.client.main", "train", "--distribution_strategy=Local",
                *MNIST, "--training_data=synthetic://mnist?n=512",
                "--validation_data=synthetic://mnist?n=128&seed=1", "--minibatch_size=64",
                "--records_per_task=128", "--num_epochs=2", f"--output={out}",
                "--device", "cpu"])
    metrics = _final_metrics(log)
    assert set(metrics) == {"accuracy", "loss"} and metrics["accuracy"] >= 0.9
    signature = json.loads((out / "signature.json").read_text())
    assert signature["model_def"] == "mnist.mnist_functional_api" and signature["step"] == 16
    features = jax_datasets.synthetic_mnist_reader(n=16, seed=9)._features / np.float32(255.0)
    jax_served = jax_load_for_serving(str(out), model_zoo=str(REPO / "model_zoo"))
    want = np.asarray(jax_served.predict(features))
    got = load_for_serving(str(out), device="cpu").predict(features)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _image_shards(directory, n_train=64, n_val=32, size=32):
    reader = SyntheticImagenetReader(n=n_train + n_val, seed=0, image_size=size,
                                     num_classes=10)
    images = np.stack([reader.image(i) for i in range(n_train + n_val)])
    labels = np.asarray([label for _, label in reader.read_records(
        SimpleNamespace(start=0, end=n_train + n_val))])
    (directory / "train").mkdir(parents=True)
    (directory / "val").mkdir()
    write_image_etrf(str(directory / "train" / "part-0.etrf"), images[:n_train], labels[:n_train])
    write_image_etrf(str(directory / "val" / "part-0.etrf"), images[n_train:], labels[n_train:])
    return images[n_train:], labels[n_train:]


def test_local_resnet50_job_on_image_etrf(tmp_path):
    """ResNet-50 (full depth at 32x32, 10 classes) from image ETRF shards: the
    columnar route trains and evaluates, the journal books each task's
    host seconds, and the export, reloaded, gives the job's accuracy and
    loads in JAX's ``load_for_serving``."""
    val_images, val_labels = _image_shards(tmp_path)
    out, journal = tmp_path / "out", tmp_path / "journal"
    log = _run(["elasticdl_tpu_torch.client.main", "train", "--distribution_strategy=Local",
                "--model_zoo=model_zoo", "--model_def=resnet50.resnet50_subclass",
                "--model_params=num_classes=10,use_bf16=false",
                f"--training_data={tmp_path / 'train'}", f"--validation_data={tmp_path / 'val'}",
                "--minibatch_size=16", "--records_per_task=32", f"--output={out}",
                f"--checkpoint_dir={journal}", "--pipeline=async", "--device", "cpu"])
    for mode in ("training", "evaluation"):
        assert f"Columnar task path engaged ({mode}, 32 rows of [32, 32, 3]" in log
    done = _journal(journal / "events.jsonl", "worker_task_done")
    train = [e for e in done if e["type"] == "TRAINING"]
    assert len(train) == 2 and all(e["steps"] == 2 for e in train)
    assert all(e["columnar_s"] >= e["columnar_transform_s"] >= 0 and e["stage_s"] >= 0
               for e in train)
    metrics = _final_metrics(log)
    served = load_for_serving(str(out), device="cpu")
    logits = np.concatenate([served.predict(val_images[i:i + 16]) for i in range(0, 32, 16)])
    assert np.mean(np.argmax(logits, 1) == val_labels) == metrics["accuracy"]
    # the recorded model params are JAX's: its loader builds the model
    jax_load_for_serving(str(out), model_zoo=str(REPO / "model_zoo"))
    variables = read_variables(str(out / "variables.pkl"))
    assert set(variables) == {"params", "batch_stats"}
    # C-contiguous leaves, as a JAX export's (conv and dense kernels too)
    assert all(leaf.flags["C_CONTIGUOUS"]
               for leaf in convert.flatten_variables(variables).values())
    assert variables["batch_stats"]["BottleneckBlock_15"]["BatchNorm_2"]["var"].shape == (2048,)


def test_bare_local_master_and_worker_process(tmp_path):
    """``python -m elasticdl_tpu_torch.master.main`` with the default
    (Local) strategy serves a bare master until SIGTERM; a Local worker
    process started by hand drains its tasks and exports."""
    master = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.master.main", *MNIST,
         "--training_data=synthetic://mnist?n=256", "--records_per_task=128",
         "--minibatch_size=64", "--device=cpu"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, lines = None, []
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = master.stdout.readline()
            lines.append(line)
            found = re.search(r"Master running on port (\d+)", line)
            port = found and int(found.group(1))
        assert port, "".join(lines)
        out = tmp_path / "out"
        log = _run(["elasticdl_tpu_torch.worker.main", "--worker_id=0",
                    f"--master_addr=localhost:{port}", "--distribution_strategy=Local", *MNIST,
                    "--training_data=synthetic://mnist?n=256", "--minibatch_size=64",
                    f"--output={out}", "--device=cpu"])
        assert "Job complete; worker 0 exiting" in log
        assert '"steps": 4' in log and '"forbidden_modules": []' in log
        assert json.loads((out / "signature.json").read_text())["step"] == 4
        master.send_signal(signal.SIGTERM)
        assert master.wait(timeout=30) == 128 + signal.SIGTERM
    finally:
        if master.poll() is None:
            master.kill()
            master.wait()
        master.stdout.close()


def test_client_refuses_what_is_not_ported(monkeypatch, tmp_path):
    # The zoo subcommand is ported (client/zoo.py); an unknown command is refused.
    assert client_main.main(["zoo", "init", str(tmp_path / "zoo")]) == 0
    assert (tmp_path / "zoo" / "my_model.py").exists()
    assert client_main.main(["no_such_command"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        client_main.main(["train", "--distribution_strategy=Local", *MNIST,
                          "--training_data=synthetic://mnist?n=64"])


def test_jax_mnist_export_evaluated_by_the_port_trainer(tmp_path):
    """A JAX ``Trainer`` trains 8 steps and exports; the port's
    ``Trainer`` loads the artifact's variables and its evaluation gives
    JAX's accuracy exactly."""
    reader = jax_datasets.synthetic_mnist_reader(n=512, seed=0)
    images = reader._features.astype(np.float32) / 255.0
    labels = reader._labels
    trainer = JaxTrainer(jax_mnist.custom_model(), jax_mnist.loss, jax_mnist.optimizer())
    for i in range(8):
        trainer.train_step(images[i * 32:(i + 1) * 32], labels[i * 32:(i + 1) * 32])
    jax_export_model(trainer, str(tmp_path), model_def="mnist.mnist_functional_api")
    held_out, held_labels = images[256:], labels[256:]
    want = np.mean(np.argmax(np.asarray(trainer.eval_step(held_out)), 1) == held_labels)

    model = mnist.custom_model(device="cpu")
    convert.load_state(model, convert.state_dict_from_jax(
        read_variables(str(tmp_path / "variables.pkl")), model))
    port = Trainer(model, mnist.loss, mnist.optimizer(), device="cpu")
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    port.state = TrainState(8, params, mnist.optimizer().init(params), {})
    got = np.mean(np.argmax(port.eval_step(held_out), 1) == held_labels)
    assert port.step == 8 and 0.2 < got == want


def _resnet20_trainer(seed=0):
    model = cifar10.custom_model(use_bf16=False, device="cpu")
    return Trainer(model, cifar10.loss, cifar10.optimizer(), seed=seed, device="cpu")


def _images(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def test_sgd_trace_and_batch_stats_checkpoints_both_ways(tmp_path):
    """The port's ``Trainer`` state (ResNet-20: params, ``batch_stats``,
    the Nesterov trace) through its ``CheckpointSaver`` into JAX's
    ``load_latest``, which builds optax's ``TraceState`` and the JAX
    ``TrainState``; and back through JAX's saver into a fresh port
    trainer, bit for bit."""
    trainer = _resnet20_trainer()
    trainer.train_step(*_images())
    CheckpointSaver(str(tmp_path / "port")).save(trainer.state_to_jax_host(), 1)
    state, step = JaxSaver(str(tmp_path / "port")).load_latest()
    assert step == 1 and type(state).__module__ == "elasticdl_tpu.worker.trainer"
    assert isinstance(state.opt_state[0], optax.TraceState)
    assert type(state.opt_state[1]).__name__ == "EmptyState"
    mine = trainer.state_to_jax_host()
    for got, want in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(mine)):
        np.testing.assert_array_equal(np.asarray(got), want)
    assert "batch_stats" in state.model_state

    JaxSaver(str(tmp_path / "jax")).save(state, 2)
    loaded, step = CheckpointSaver(str(tmp_path / "jax")).load_latest()
    assert step == 2 and isinstance(loaded.opt_state[0], _pickle.TraceState)
    fresh = _resnet20_trainer(seed=3)
    fresh.state = convert.local_trainer_state_from_jax(loaded, fresh.model)
    fresh.ensure_initialized()
    back = fresh.state_to_jax_host()
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(mine)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    x, _ = _images(seed=1)
    np.testing.assert_array_equal(fresh.eval_step(x), trainer.eval_step(x))


def test_dp_sharded_checkpoint_names_model_state_as_jax(tmp_path):
    """``DataParallelTrainer.save_checkpoint`` writes every leaf under the
    JAX trainer's key (``JaxDPTrainer._leaf_key`` over the JAX tree):
    ``dense|.model_state/batch_stats/...`` and the trace's
    ``dense|.opt_state/[0]/.trace/...`` included; a fresh trainer restores
    it bit for bit."""
    model = resnet50.ResNet50(10, torch.float32, torch.float32, (1, 1, 1, 1), device="cpu")
    trainer = DataParallelTrainer(model, resnet50.loss, resnet50.optimizer(), device="cpu")
    rng = np.random.default_rng(0)
    trainer.train_step(rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8),
                       rng.integers(0, 10, 4).astype(np.int32))
    trainer.save_checkpoint(ShardedCheckpointSaver(str(tmp_path)), 1)
    dense = ShardedCheckpointSaver(str(tmp_path)).load_dense(1)
    CheckpointSaver(str(tmp_path / "pkl")).save(trainer.state_to_jax_host(), 1)
    jax_state, _ = JaxSaver(str(tmp_path / "pkl")).load_latest()
    want = {JaxDPTrainer._leaf_key(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jax_state)[0]}
    assert set(dense["leaves"]) == set(want)
    assert "dense|.model_state/batch_stats/BottleneckBlock_0/BatchNorm_2/mean" in want
    assert "dense|.opt_state/[0]/.trace/Conv_0/kernel" in want
    for key, leaf in want.items():
        np.testing.assert_array_equal(dense["leaves"][key], np.asarray(leaf))
    fresh = DataParallelTrainer(
        resnet50.ResNet50(10, torch.float32, torch.float32, (1, 1, 1, 1), device="cpu"),
        resnet50.loss, resnet50.optimizer(), seed=5, device="cpu")
    fresh.set_sharded_restore(ShardedCheckpointSaver(str(tmp_path)), 1)
    fresh.ensure_initialized()
    for got, want_leaf in zip(jax.tree_util.tree_leaves(fresh.state_to_jax_host()),
                              jax.tree_util.tree_leaves(trainer.state_to_jax_host())):
        np.testing.assert_array_equal(got, want_leaf)
