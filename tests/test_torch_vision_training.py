"""The port's single-device ``Trainer`` (``worker/trainer.py``) and
``DataParallelTrainer``'s ``batch_stats`` on the vision zoo, against the
JAX package on the CPU (the models' forwards:
``tests/test_torch_vision_zoo.py``).  Tolerances:

- 3 training steps of JAX's ``Trainer`` and the port's from one state:
  relative L2 ``<= 1e-4`` over the parameters and the SGD trace of the
  MNIST conv net; for ResNet-20 ``<= 1e-4`` over parameters and over
  ``batch_stats``, the trace (the gradients, which XLA's CPU sums through
  batch norm leave 1.8e-3 from the exact trace after 3 steps, the port
  8.2e-6) at ``1e-4`` plus JAX's own distance from the exact trace, and
  all three ``<= 1e-4`` of the exact result, JAX's ``Trainer`` run in
  f64;
- a ``DataParallelTrainer`` world of 2 against a world of 1: the losses at
  the schedule of JAX's own test of its mesh against one device, then
  relative L2 over all parameters ``<= 1e-3``, ``batch_stats`` ``<=
  1e-5``, evaluation outputs ``<= 1e-2`` (3 steps at lr 0.1 through batch
  norm amplify the reduction order; the ranks hold the same bits).
"""

import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch.distributed as dist

from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu.worker.trainer import TrainState as JaxTrainState
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.worker.trainer import Trainer
from elasticdl_tpu_torch.zoo import cifar10, mnist
from model_zoo.cifar10 import cifar10_functional_api as jax_cifar10
from model_zoo.mnist import mnist_functional_api as jax_mnist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
from test_torch_vision_zoo import (  # noqa: E402
    _close,
    _f64_interceptor,
    _input,
    _models,
    _variables,
)


def _jax_trainer_from(variables, jax_model, optimizer, loss):
    trainer = JaxTrainer(jax_model, loss, optimizer)
    params = variables["params"]
    model_state = {k: v for k, v in variables.items() if k != "params"}
    trainer.state = JaxTrainState(jnp.zeros((), jnp.int32), params, optimizer.init(params),
                                  model_state)
    return trainer


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _flat_state(state):
    """Params, ``batch_stats`` and the SGD trace of a JAX-layout
    ``TrainState`` as one f64 vector (sorted paths) and the paths."""
    flat = convert.flatten_variables(jax.device_get({
        "params": state.params, "model_state": state.model_state,
        "trace": state.opt_state[0].trace}))
    keys = sorted(flat)
    return np.concatenate([np.ravel(flat[k]).astype(np.float64) for k in keys]), keys


def _exact_steps(variables, jax_model, optimizer, loss, batches):
    """The exact result: JAX's ``Trainer`` with the variables, the batches
    and every flax module in f64 -> ``(losses, state)``."""
    with jax.enable_x64(True), fnn.intercept_methods(_f64_interceptor):
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        trainer = _jax_trainer_from(variables, jax_model, optimizer, loss)
        losses = [float(trainer.train_step(images.astype(np.float64), labels))
                  for images, labels in batches]
        return losses, jax.device_get(trainer.state)


def _three_steps(name, jax_optimizer, jax_loss, port_optimizer, port_loss, exact=False):
    """3 steps of JAX's ``Trainer`` and the port's (and, with ``exact``,
    JAX's in f64) from one state -> ``(losses, flat states)``."""
    jax_model, port_model = _models(name)
    x = _input(name, seed=5, batch=8)
    variables = _variables(port_model)
    trainers = {"jax": _jax_trainer_from(variables, jax_model, jax_optimizer, jax_loss)}
    start = jax.device_get(trainers["jax"].state)
    trainers["port"] = Trainer(port_model, port_loss, port_optimizer, device="cpu")
    trainers["port"].state = convert.local_trainer_state_from_jax(start, port_model)
    rng = np.random.default_rng(6)
    batches = [(_input(name, seed=int(rng.integers(1 << 30)), batch=8),
                rng.integers(0, 10, 8).astype(np.int32)) for _ in range(3)]
    losses = {key: [] for key in trainers}
    for images, labels in batches:
        for key, trainer in trainers.items():
            losses[key].append(float(trainer.train_step(images, labels)))
    assert trainers["port"].step == 3
    states = {"jax": trainers["jax"].state, "port": trainers["port"].state_to_jax_host()}
    if exact:
        losses["exact"], states["exact"] = _exact_steps(variables, jax_model, jax_optimizer,
                                                        jax_loss, batches)
    flat = {key: _flat_state(state) for key, state in states.items()}
    assert all(paths == flat["jax"][1] for _, paths in flat.values())
    return losses, {key: vector for key, (vector, _) in flat.items()}, states, trainers, x


def test_three_trainer_steps_match_jax_without_batch_norm():
    """MnistCNN (plain momentum SGD): params and trace after 3 steps within
    relative L2 1e-4 of JAX's."""
    losses, states, _, trainers, x = _three_steps(
        "mnist_subclass", jax_mnist.optimizer(), jax_mnist.loss, mnist.optimizer(), mnist.loss)
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    assert _rel_l2(states["port"], states["jax"]) <= 1e-4
    _close(trainers["port"].eval_step(x), trainers["jax"].eval_step(x), "eval", rel=1e-4)


def test_three_trainer_steps_match_jax():
    """ResNet-20 (f32, Nesterov SGD): JAX's ``Trainer`` and the port's from
    one state, 3 steps on the same batches; params, ``batch_stats`` and
    the SGD trace compared through the JAX layout, and against the exact
    result, JAX's ``Trainer`` with the state, the batches and every flax
    module in f64.

    The steps run at lr 1e-3.  At the zoo's 0.1, 8 random rows make the
    loss diverge (2.4 -> 7.7 in 3 steps) and rounding grows without bound:
    JAX's own trace then sits 23% (relative L2) from the exact one.  And
    after 3 steps at 1e-3 JAX's f32 trace, the gradients through 21
    train-mode batch norms, sits 1.8e-3 from the exact one (XLA's CPU sums
    of the norms' backward), the port's 8.2e-6; so the trace is held to
    JAX at 1e-4 plus JAX's own distance from the exact trace."""
    losses, _, states, trainers, x = _three_steps(
        "resnet20", jax_cifar10.optimizer(1e-3), jax_cifar10.loss, cifar10.optimizer(1e-3),
        cifar10.loss, exact=True)
    np.testing.assert_allclose(losses["port"], losses["exact"], rtol=1e-5)
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    keys = _flat_state(trainers["jax"].state)[1]
    for group in ("params/", "model_state/", "trace/"):
        flat = {}
        for name, state in states.items():
            leaves = convert.flatten_variables(jax.device_get({
                "params": state.params, "model_state": state.model_state,
                "trace": state.opt_state[0].trace}))
            flat[name] = np.concatenate([np.ravel(leaves[k]).astype(np.float64)
                                         for k in keys if k.startswith(group)])
        assert _rel_l2(flat["port"], flat["exact"]) <= 1e-4, group
        slack = 0.0 if group != "trace/" else _rel_l2(flat["jax"], flat["exact"])
        assert _rel_l2(flat["port"], flat["jax"]) <= 1e-4 + slack, group
    # evaluation reads the running averages the steps left
    _close(trainers["port"].eval_step(x), trainers["jax"].eval_step(x), "eval", rel=1e-4)


def test_data_parallel_world_of_two_matches_world_of_one(tmp_path):
    """``DataParallelTrainer`` on ResNet-20 over a gloo world of 2 (this
    file run as a script, ``dp_rank_main``; the
    batch statistics averaged over the ranks, so they are the global
    batch's) against the same trainer in one process, from one seeded
    initialisation, at the tolerances of the module docstring (the
    losses at those of JAX's
    ``tests/test_cifar10_model.py::test_resnet20_dp_matches_single_device``)."""
    world = 2
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__,
                               str(rank), str(world), str(tmp_path / "store"), str(tmp_path)],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log}"
    ranks = [dict(np.load(tmp_path / f"rank{rank}.npz")) for rank in range(world)]
    one = dp_train()
    assert sorted(ranks[0]) == sorted(one)
    assert sum(k.startswith("stat_") for k in one) == 2 * 21
    for step, rtol in enumerate((1e-3, 8e-3, 3e-2)):  # JAX's test's schedule
        for result in ranks:
            np.testing.assert_allclose(result["losses"][step], one["losses"][step], rtol=rtol,
                                       atol=1e-4)

    def flat(result, prefix):
        return np.concatenate([np.ravel(result[k]).astype(np.float64)
                               for k in sorted(result) if k.startswith(prefix)])

    for result in ranks:
        assert _rel_l2(flat(result, "param_"), flat(one, "param_")) <= 1e-3
        assert _rel_l2(flat(result, "stat_"), flat(one, "stat_")) <= 1e-5
        assert _rel_l2(result["eval"], one["eval"]) <= 1e-2
    for key in one:  # replicated: every rank holds the same bits
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


# -- one rank of the gloo world of test_data_parallel_world_of_two_... ------

DP_BATCH, DP_STEPS, DP_SEED = 8, 3, 4


def dp_inputs():
    """The global ``(images, labels)`` batches every rank (and the
    one-process reference) trains on."""
    rng = np.random.default_rng(23)
    return [(rng.standard_normal((DP_BATCH, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, DP_BATCH).astype(np.int32)) for _ in range(DP_STEPS)]


def dp_train(mesh=None):
    """``DP_STEPS`` steps -> ``{"losses", "param_<name>", "stat_<name>",
    "eval"}``."""
    model = cifar10.custom_model(use_bf16=False, device="cpu")
    trainer = DataParallelTrainer(model, cifar10.loss, cifar10.optimizer(), mesh=mesh,
                                  seed=DP_SEED, device=None if mesh is not None else "cpu")
    batches = dp_inputs()
    out = {"losses": np.asarray([float(trainer.train_step(x, y)) for x, y in batches])}
    host = trainer.state_to_host()
    out.update({f"param_{k}": v for k, v in host.params.items()})
    out.update({f"stat_{k}": v for k, v in host.model_state["batch_stats"].items()})
    out["eval"] = trainer.eval_step(batches[0][0])
    return out


def dp_rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the gloo world (this file run as a script)."""
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **dp_train(build_mesh(MeshConfig(data=world, model=1))))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    dp_rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
