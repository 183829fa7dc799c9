"""The port's ``elasticdl zoo`` (``client/zoo.py``) and its loader of a
user's model zoo (``common/model_utils.load_module``), on the CPU: the
counterpart of ``tests/test_zoo.py``.

- ``init`` scaffolds a torch module that ``load_model_spec`` loads from
  the directory; its forward, on seeded numpy weights carried across,
  is JAX's scaffold's (``elasticdl_tpu.client.zoo``), and so is its loss.
- ``build`` renders a self-contained context: the port's package with
  its kernel sources, the zoo, no caches or built libraries, never the
  JAX package; a missing zoo, or a context that overwrites or nests with
  a source tree, returns 1.
- The nine registry names resolve to the port's modules whatever
  ``--model_zoo`` says; a user's zoo named ``model_zoo`` loads and stays
  out of the forbidden-module census, while the JAX zoo's modules and a
  user module that imports ``jax`` or ``flax`` are refused, naming them.
- An artifact exported with a user's zoo is served by
  ``load_for_serving`` (the override wins over the recorded zoo), by a
  Local job's export and by a replica process.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.client import zoo as jax_zoo
from elasticdl_tpu.common.args import parse_master_args as jax_parse_master_args
from elasticdl_tpu.common.model_utils import load_model_spec as jax_load_model_spec
from elasticdl_tpu_torch import zoo as port_zoo
from elasticdl_tpu_torch.client import main as client_main
from elasticdl_tpu_torch.client import zoo
from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.common.model_utils import load_model_spec, load_module
from elasticdl_tpu_torch.serving.export import export_model, load_for_serving
from elasticdl_tpu_torch.worker.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
JOB = ["--model_def", "my_model", "--training_data", "t"]


def _spec(path, **flags):
    return load_model_spec(parse_master_args(["--model_zoo", str(path), *JOB, *[
        f"--{k}={v}" for k, v in flags.items()]]))


def _subprocess(code: str, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_init_scaffolds_loadable_module(tmp_path):
    path = tmp_path / "initzoo"
    assert zoo.main(["init", str(path)]) == 0
    spec = _spec(path)
    model = spec.build_model(device="cpu")
    model.init_parameters(torch.Generator().manual_seed(0))
    out = model(torch.zeros((2, 4)))
    assert out.shape == (2, 2)
    source = (path / "my_model.py").read_text()
    imports = [line for line in source.splitlines() if line.startswith(("import ", "from "))]
    assert imports and not any(word in line for line in imports
                               for word in ("jax", "flax", "optax"))
    assert zoo.main(["init", str(path)]) == 0  # existing files are kept
    assert (path / "my_model.py").read_text() == source


def test_scaffold_matches_jax_scaffold_on_carried_weights(tmp_path):
    rng = np.random.default_rng(22)
    kernels = [rng.standard_normal((4, 64)).astype(np.float32) * 0.5,
               rng.standard_normal((64, 2)).astype(np.float32) * 0.2]
    biases = [rng.standard_normal(64).astype(np.float32) * 0.1,
              rng.standard_normal(2).astype(np.float32) * 0.1]
    x = rng.standard_normal((16, 4)).astype(np.float32)
    labels = rng.integers(0, 2, 16).astype(np.int32)

    assert jax_zoo.main(["init", str(tmp_path / "jaxscaffold")]) == 0
    jax_spec = jax_load_model_spec(jax_parse_master_args(
        ["--model_zoo", str(tmp_path / "jaxscaffold"), *JOB]))
    params = {f"Dense_{i}": {"kernel": k, "bias": b}
              for i, (k, b) in enumerate(zip(kernels, biases))}
    want = np.asarray(jax_spec.build_model().apply({"params": params}, x))
    want_loss = float(jax_spec.loss(labels, want))

    assert zoo.main(["init", str(tmp_path / "torchscaffold")]) == 0
    spec = _spec(tmp_path / "torchscaffold")
    model = spec.build_model(device="cpu")
    with torch.no_grad():  # flax's [in, out] kernels -> nn.Linear's [out, in]
        for i, (k, b) in enumerate(zip(kernels, biases)):
            getattr(model, f"Dense_{i}").weight.copy_(torch.from_numpy(k.T))
            getattr(model, f"Dense_{i}").bias.copy_(torch.from_numpy(b))
        got = model(torch.from_numpy(x)).numpy()
        loss = float(spec.loss(torch.from_numpy(labels), torch.from_numpy(got)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert spec.optimizer().name == "sgd"
    metrics = spec.eval_metrics_fn()["accuracy"](got, labels)
    assert metrics == jax_spec.eval_metrics_fn()["accuracy"](want, labels)


def test_build_renders_self_contained_context(tmp_path):
    zoo_dir = tmp_path / "myzoo"
    zoo.main(["init", str(zoo_dir)])
    (zoo_dir / "__pycache__").mkdir()
    context = tmp_path / "ctx"
    rc = zoo.main(["build", str(zoo_dir), "--context", str(context), "--dockerfile-only",
                   "--base-image", "my-torch-base:latest"])
    assert rc == 0
    dockerfile = (context / "Dockerfile").read_text()
    assert "FROM my-torch-base:latest" in dockerfile
    assert "COPY elasticdl_tpu_torch/" in dockerfile and "COPY myzoo/" in dockerfile
    assert "python -m elasticdl_tpu_torch.master.main" in dockerfile
    for rel in ("ops/csrc/flash_attention.cu", "ops/csrc/ring_attention.cu",
                "ops/csrc/flash_common.cuh", "ops/csrc/sparse_embedding.cu",
                "native/recordfile.cc", "master/pod_manager.py", "ops/_build.py"):
        assert (context / "elasticdl_tpu_torch" / rel).exists(), rel
    assert (context / "myzoo" / "my_model.py").exists()
    assert not (context / "elasticdl_tpu").exists()
    for root, dirs, files in os.walk(context):
        assert "__pycache__" not in dirs and "_build" not in dirs, root
        assert not any(f.endswith((".so", ".pyc")) for f in files), root


def test_build_missing_zoo_errors(tmp_path, capsys):
    rc = zoo.main(["build", str(tmp_path / "nope"), "--context", str(tmp_path / "ctx"),
                   "--dockerfile-only"])
    assert rc == 1
    assert "not found" in capsys.readouterr().err


def test_build_refuses_context_overwriting_source(tmp_path, capsys):
    zoo_dir = tmp_path / "myzoo"
    zoo.main(["init", str(zoo_dir)])
    rc = zoo.main(["build", str(zoo_dir), "--context", str(tmp_path), "--dockerfile-only"])
    assert rc == 1
    assert "overwrite or nest" in capsys.readouterr().err
    assert (zoo_dir / "my_model.py").exists()
    rc = zoo.main(["build", str(zoo_dir), "--context", str(zoo_dir / "ctx"),
                   "--dockerfile-only"])
    assert rc == 1
    assert (zoo_dir / "my_model.py").exists()
    # A context inside the port's own package nests with it too.
    package = REPO / "elasticdl_tpu_torch"
    rc = zoo.main(["build", str(zoo_dir), "--context", str(package / "ctx_never_made"),
                   "--dockerfile-only"])
    assert rc == 1 and not (package / "ctx_never_made").exists()


def test_build_and_push_without_docker(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(zoo.shutil, "which", lambda name: None)
    zoo_dir = tmp_path / "myzoo"
    assert client_main.main(["zoo", "init", str(zoo_dir)]) == 0
    argv = ["zoo", "build", str(zoo_dir), "--context", str(tmp_path / "ctx")]
    assert client_main.main(argv) == 1
    assert client_main.main(argv + ["--allow-no-docker"]) == 0
    assert "docker build -t <image>" in capsys.readouterr().err
    assert client_main.main(["zoo", "push", "img:1"]) == 1


def test_registry_names_and_a_user_zoo_named_model_zoo(tmp_path):
    """In a fresh process: the nine names resolve to the port's modules
    with ``--model_zoo model_zoo`` (the JAX zoo's directory in the repo
    root) and nothing forbidden loads; a scaffold in a directory named
    ``model_zoo`` loads and stays out of the census."""
    names = sorted(port_zoo.REGISTRY)
    out = _subprocess(f"""
        import json, os, sys
        from elasticdl_tpu_torch import zoo
        from elasticdl_tpu_torch.client import zoo as cli
        from elasticdl_tpu_torch.common.boundary import forbidden_modules_loaded
        from elasticdl_tpu_torch.common.model_utils import load_module
        for zoo_arg in ("model_zoo", os.path.join({str(REPO)!r}, "model_zoo"), ""):
            for name in {names!r}:
                assert load_module(zoo_arg, name) is zoo.REGISTRY[name], name
                assert zoo.resolve(name, zoo_arg) is zoo.REGISTRY[name], name
        assert forbidden_modules_loaded() == [], forbidden_modules_loaded()
        os.chdir({str(tmp_path)!r})
        assert cli.main(["init"]) == 0  # JAX's default path: ./model_zoo
        module = load_module("model_zoo", "my_model")
        model = module.custom_model(input_dim=3, device="cpu")
        print(json.dumps({{"file": module.__file__, "forbidden": forbidden_modules_loaded(),
                          "loaded": sorted(m for m in sys.modules if m.startswith("model_zoo"))}}))
    """, cwd=REPO)
    result = json.loads(out.strip().splitlines()[-1])
    assert result["file"] == str(tmp_path / "model_zoo" / "my_model.py")
    assert result["forbidden"] == []
    assert result["loaded"] == ["model_zoo", "model_zoo.my_model"]


def test_jax_zoo_and_jax_importing_user_modules_are_refused(tmp_path):
    bad = tmp_path / "badzoo"
    bad.mkdir()
    (bad / "__init__.py").write_text("")
    (bad / "uses_jax.py").write_text("import numpy as np\nimport jax.numpy as jnp\n")
    (bad / "uses_flax.py").write_text("from flax import linen as nn\n")
    (bad / "holds_optax.py").write_text(
        "import importlib\nsgd = importlib.import_module('optax').sgd\n")
    # In this process JAX is loaded already: the import statement is refused all the same.
    with pytest.raises(ImportError, match=r"badzoo\.uses_jax imports jax\.numpy"):
        load_module(str(bad), "uses_jax")
    with pytest.raises(ImportError, match=r"badzoo\.uses_flax imports flax"):
        _spec(bad, model_def="uses_flax")
    with pytest.raises(ImportError, match=r"\['optax"):
        load_module(str(bad), "holds_optax")
    with pytest.raises(ValueError, match="not ported"):
        load_module(str(bad), "no_such_module")
    # A fresh process loads none of them: the JAX zoo's modules import the
    # JAX package, a user's module imports jax.
    out = _subprocess(f"""
        import json, sys
        from elasticdl_tpu_torch.common.boundary import forbidden_modules_loaded
        from elasticdl_tpu_torch.common.model_utils import load_module
        errors = []
        for zoo_arg, name in (({str(REPO / 'model_zoo')!r}, "datasets"),
                              ("model_zoo", "datasets"), ({str(bad)!r}, "uses_jax")):
            try:
                load_module(zoo_arg, name)
            except ImportError as exc:
                errors.append(str(exc))
        print(json.dumps({{"errors": errors, "jax": "jax" in sys.modules,
                          "elasticdl_tpu": "elasticdl_tpu" in sys.modules}}))
    """, cwd=REPO)
    result = json.loads(out.strip().splitlines()[-1])
    assert len(result["errors"]) == 3, result
    assert "model_zoo.datasets imports elasticdl_tpu" in result["errors"][0]
    assert "model_zoo.datasets imports elasticdl_tpu" in result["errors"][1]
    assert "badzoo.uses_jax imports jax" in result["errors"][2]
    assert not result["jax"] and not result["elasticdl_tpu"]


def _trained_scaffold(tmp_path, name="servezoo", steps=3):
    zoo_dir = tmp_path / name
    zoo.main(["init", str(zoo_dir)])
    spec = _spec(zoo_dir, model_params="input_dim=5")
    trainer = Trainer(spec.build_model(device="cpu"), spec.loss, spec.optimizer(), seed=3,
                      device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(steps):
        trainer.train_step(rng.standard_normal((8, 5)).astype(np.float32),
                           rng.integers(0, 2, 8).astype(np.int32))
    return zoo_dir, trainer, rng.standard_normal((6, 5)).astype(np.float32)


def test_artifact_with_a_user_zoo_is_served_and_the_override_wins(tmp_path):
    zoo_dir, trainer, x = _trained_scaffold(tmp_path)
    want = trainer.eval_step(x)
    art = export_model(trainer, str(tmp_path / "art"), model_zoo=str(zoo_dir),
                       model_def="my_model", model_params="input_dim=5")
    got = load_for_serving(art, device="cpu").predict(x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # The artifact moved: its recorded zoo is gone, the override finds the module.
    moved = export_model(trainer, str(tmp_path / "moved"), model_zoo=str(tmp_path / "gone"),
                         model_def="my_model", model_params="input_dim=5")
    with pytest.raises(ValueError, match="not importable from model_zoo"):
        load_for_serving(moved, device="cpu")
    got = load_for_serving(moved, device="cpu", model_zoo=str(zoo_dir)).predict(x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_local_job_and_replica_process_load_a_user_zoo(tmp_path):
    """``client.main train --distribution_strategy=Local --model_zoo <init
    dir> --model_def my_model`` trains the user's module (a reader the
    user adds to it), and ``replica_main --model_zoo`` serves the export
    in a fresh process with no forbidden module loaded."""
    zoo_dir = tmp_path / "jobzoo"
    zoo.main(["init", str(zoo_dir)])
    with open(zoo_dir / "my_model.py", "a") as f:
        f.write(textwrap.dedent("""

            def custom_data_reader(data_path, **kwargs):
                from elasticdl_tpu_torch.data.reader import NumpyDataReader

                data = np.load(data_path)
                return NumpyDataReader(data["x"], data["y"], **kwargs)
        """))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((96, 4)).astype(np.float32)
    np.savez(tmp_path / "train.npz", x=x, y=(x[:, 0] > 0).astype(np.int32))
    out, serve = tmp_path / "out", tmp_path / "serve"
    proc = subprocess.run(
        [sys.executable, "-m", "elasticdl_tpu_torch.client.main", "train",
         "--distribution_strategy=Local", f"--model_zoo={zoo_dir}", "--model_def=my_model",
         f"--training_data={tmp_path / 'train.npz'}", "--minibatch_size=16",
         "--records_per_task=48", f"--output={out}", "--device=cpu"],
        cwd=str(REPO), capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    assert '"forbidden_modules": []' in log and '"steps": 6' in log
    signature = json.loads((out / "signature.json").read_text())
    assert (signature["model_zoo"], signature["model_def"], signature["step"]) == (
        str(zoo_dir), "my_model", 6)
    want = load_for_serving(str(out), device="cpu").predict(x[:8])
    replica = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serving.replica_main", "--model_dir",
         str(out), "--serve_dir", str(serve), "--model_zoo", str(zoo_dir), "--device", "cpu"],
        cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    try:
        from elasticdl_tpu_torch.serving.frontend import PredictClient
        from elasticdl_tpu_torch.serving.supervisor import wait_for_replicas

        (live,) = wait_for_replicas(str(serve), 1, timeout_s=120)
        client = PredictClient(f"127.0.0.1:{live['port']}", deadline_s=60.0)
        try:
            got = client.predict({"features": x[:8]})
        finally:
            client.close()
    finally:
        replica.terminate()
        assert replica.wait(timeout=60) == 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with open(serve / "events.jsonl") as f:
        starts = [e for e in map(json.loads, f) if e["event"] == "serving_replica_start"]
    assert [e["forbidden_modules"] for e in starts] == [[]]
