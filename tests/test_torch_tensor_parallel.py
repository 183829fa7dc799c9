"""Tensor parallelism (``model_axis_mode="tp"``) of the port's transformer
LM against the JAX package's GSPMD tensor parallelism, on the CPU.

- The port's TP model on in-process (2, 4) and (1, 2) meshes
  (``virtual_devices(n, "cpu")``) against JAX's TP model on the same
  JAX mesh of its 8 virtual CPU devices, from the same weights through
  ``serving/convert.py``, in f32: ``TP_TOL``, JAX's own tolerance for
  its TP model against one device (``tests/test_transformer_lm.py``).
- The port's TP model against its one-card model: logits at
  ``ONE_CARD_TOL`` and every gradient within ``GRAD_SCALE`` of its leaf's
  largest element (the slots' partial products are summed in another
  order, and that noise scales with the summed terms).
- 3 ``DataParallelTrainer`` steps against JAX's trainer from the JAX
  trainer's state: losses at ``STEP_RTOL``, parameters within Adam's
  bound, all but ``LOOSE_SHARE`` of them at ``FINAL_TOL``.
- Heads (and hidden units) that the model axis does not divide raise
  ``ValueError`` in both packages; so does ``attn_impl="pallas"``.
- A gloo process mesh of (data=2, model=2) (``tests/torch_mesh_worker.py``)
  against one process: the one-step gradients at ``GRAD_SCALE`` (the
  replicated leaves summed over ``data`` only: not multiplied by the
  model axis), 2 model-axis all-reduces per block forward and 2
  backward, and 3 steps at the trainer tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from elasticdl_tpu.parallel import MeshConfig as JaxMeshConfig
from elasticdl_tpu.parallel import build_mesh as jax_build_mesh
from elasticdl_tpu.parallel.dp_trainer import DataParallelTrainer as JaxTrainer
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel import mesh as pmesh
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh, virtual_devices
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import transformer_lm as port_zoo
from model_zoo.transformer import transformer_lm as zoo

MODEL_DEF = "transformer.transformer_lm"
PARAMS = dict(vocab=256, d_model=64, num_heads=4, num_layers=2, max_len=64, use_bf16=False)
SEQ, BATCH, STEPS, LR = 32, 4, 3, 3e-3
TP_TOL = dict(rtol=2e-4, atol=2e-4)
ONE_CARD_TOL = dict(rtol=0, atol=1e-5)
GRAD_SCALE = 1e-5
STEP_RTOL = 1e-5
FINAL_TOL = dict(rtol=1e-5, atol=1e-6)
LOOSE_SHARE = 0.005


def _data(n, seed):
    from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays

    return synthetic_lm_arrays(n, SEQ, PARAMS["vocab"], seed)


def _port_mesh(data, model):
    return build_mesh(MeshConfig(data, model), devices=virtual_devices(data * model, "cpu"))


def _port_model(mesh=None, **kw):
    params = dict(PARAMS, **kw)
    if mesh is not None:
        params["mesh"] = mesh
    return build_model(MODEL_DEF, params, device="cpu")


def _jax_mesh(data, model):
    return jax_build_mesh(JaxMeshConfig(data=data, model=model),
                          devices=jax.devices()[:data * model])


def _assert_grad_close(got, want, err_msg):
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_SCALE * np.abs(want).max(),
                               err_msg=err_msg)


def _assert_params_close(got, want, max_diff):
    """Every element within ``max_diff``; all but LOOSE_SHARE of them
    within FINAL_TOL."""
    assert sorted(got) == sorted(want)
    loose = 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= max_diff, (name, float(diff.max()))
        loose += int((diff > FINAL_TOL["atol"] + FINAL_TOL["rtol"] * np.abs(w)).sum())
    assert loose <= LOOSE_SHARE * sum(w.size for w in want.values()), loose


@pytest.mark.parametrize("shape", [(2, 4), (1, 2)])
def test_tp_logits_match_jax_tp_model(shape):
    tokens, _ = _data(BATCH, seed=1)
    jax_model = zoo.custom_model(**PARAMS, mesh=_jax_mesh(*shape), model_axis_mode="tp")
    variables = jax.device_get(jax_model.init(jax.random.PRNGKey(0), jnp.asarray(tokens)))
    want = np.asarray(jax_model.apply(variables, jnp.asarray(tokens)))
    mesh = _port_mesh(*shape)
    model = _port_model(mesh, model_axis_mode="tp")
    assert model.model_axis_mode == "tp" and model.sequence_positions(SEQ) is None
    convert.load_state(model, convert.state_dict_from_jax(variables, model))
    fa.reset_launch_counts()
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, **TP_TOL)
    assert not any(fa.launch_counts().values())  # CPU tensors: plain versions


def test_tp_matches_the_one_card_model_forward_and_backward():
    tokens, _ = _data(BATCH, seed=2)
    one = _port_model()
    one.init_parameters(torch.Generator().manual_seed(5))
    tp = _port_model(_port_mesh(1, 4), model_axis_mode="tp")
    tp.load_state_dict(one.state_dict())
    tokens = torch.from_numpy(tokens)
    want, got = one(tokens), tp(tokens)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **ONE_CARD_TOL)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(want.shape).astype(np.float32))
    for (name, a), b in zip(one.named_parameters(),
                            torch.autograd.grad(got, list(tp.parameters()), g)):
        (a_grad,) = torch.autograd.grad(want, [a], g, retain_graph=True)
        _assert_grad_close(b.numpy(), a_grad.numpy(), name)


def test_tp_trainer_matches_jax_trainer():
    """3 steps on an in-process (2, 4) mesh against JAX's trainer on the
    same JAX mesh, from the JAX trainer's state."""
    tokens, labels = _data(BATCH * STEPS, seed=4)
    jax_mesh = _jax_mesh(2, 4)
    jt = JaxTrainer(zoo.custom_model(**PARAMS, mesh=jax_mesh, model_axis_mode="tp"),
                    zoo.loss, zoo.optimizer(), jax_mesh)
    jt.ensure_initialized(tokens[:BATCH])
    mesh = _port_mesh(2, 4)
    model = _port_model(mesh, model_axis_mode="tp")
    pt = DataParallelTrainer(model, port_zoo.loss, port_zoo.optimizer(), mesh=mesh)
    pt.state = convert.dp_trainer_state_from_jax(jax.device_get(jt.state), model)
    for i in range(STEPS):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        j_loss = float(jt.train_step(tokens[rows], labels[rows]))
        p_loss = float(pt.train_step(tokens[rows], labels[rows]))
        np.testing.assert_allclose(p_loss, j_loss, rtol=STEP_RTOL)
    _assert_params_close(pt.get_variables_numpy(), jt.get_variables_numpy(),
                         2 * LR * STEPS * 1.5)
    np.testing.assert_allclose(pt.eval_step(tokens[:BATCH]),
                               np.asarray(jt.eval_step(tokens[:BATCH])), rtol=0, atol=1e-4)


@pytest.mark.parametrize("heads,d_model", [(3, 48), (6, 48), (2, 32)])
def test_heads_the_model_axis_does_not_divide_raise_as_in_jax(heads, d_model):
    """JAX's sharding constraint over 4 model slots rejects 3, 6 and 2
    heads when the model is applied; the port rejects them when it is
    built."""
    tokens = jnp.asarray(_data(BATCH, seed=5)[0])
    params = dict(PARAMS, num_heads=heads, d_model=d_model, num_layers=1)
    jax_model = zoo.custom_model(**params, mesh=_jax_mesh(2, 4), model_axis_mode="tp")
    single = zoo.custom_model(**params)
    variables = single.init(jax.random.PRNGKey(0), tokens)
    with pytest.raises(ValueError, match="divisible"):
        jax_model.apply(variables, tokens)
    with pytest.raises(ValueError, match="divisible by 4"):
        build_model(MODEL_DEF, dict(params, mesh=_port_mesh(2, 4), model_axis_mode="tp"),
                    device="cpu")


def test_attn_impl_pallas_under_tp_raises_in_both_packages():
    tokens = jnp.asarray(_data(BATCH, seed=6)[0])
    jax_model = zoo.custom_model(**PARAMS, mesh=_jax_mesh(2, 4), model_axis_mode="tp",
                                 attn_impl="pallas")
    with pytest.raises(ValueError, match="pallas"):
        jax_model.init(jax.random.PRNGKey(0), tokens)
    with pytest.raises(ValueError, match="pallas"):
        _port_model(_port_mesh(2, 4), model_axis_mode="tp", attn_impl="pallas")
    # A model axis of 1 carries nothing: every attn_impl is accepted.
    _port_model(_port_mesh(4, 1), model_axis_mode="tp", attn_impl="pallas")


# ----------------------------------------------------------------------
# the gloo process mesh (tests/torch_mesh_worker.py) against one process
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return worker.mesh_world(tmp_path_factory)[0]


def _one_process_trainer():
    return worker.lm_trainer(None, device="cpu")


def test_process_mesh_tp_gradients_sum_each_leaf_once(world):
    """The reduced gradients of one step equal one process's: the sliced
    leaves summed over the world, the replicated ones (embeddings,
    LayerNorms, the head, the row-parallel biases) over data only."""
    batches = worker.lm_batches()
    want = worker.one_step_grads(_one_process_trainer(), *batches[0])
    for rank, result in enumerate(world):
        for name, g in want.items():
            _assert_grad_close(result[f"tp_grad_{name}"], g.numpy(), f"{name}, rank {rank}")


def test_process_mesh_tp_runs_two_model_axis_reduces_per_block(world):
    blocks = worker.LM_PARAMS["num_layers"]
    for result in world:
        assert list(result["tp_reduces"]) == [2 * blocks, 2 * blocks]


def test_process_mesh_tp_trains_like_one_process(world):
    trainer = _one_process_trainer()
    batches = worker.lm_batches()
    losses = np.asarray([float(trainer.train_step(*b)) for b in batches])
    want = trainer.get_variables_numpy()
    eval_want = trainer.eval_step(batches[0][0])
    prefix = "tp_var_"
    for rank, result in enumerate(world):
        np.testing.assert_allclose(result["tp_losses"], losses, rtol=STEP_RTOL)
        got = {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}
        _assert_params_close(got, want, 2 * LR * worker.STEPS * 1.5)
        for name, value in got.items():  # replicated: identical on every rank
            assert np.array_equal(value, world[0][prefix + name]), (rank, name)
        np.testing.assert_allclose(result["tp_eval"], eval_want, rtol=0, atol=1e-4)


def test_tp_reduce_counts_only_process_collectives():
    pmesh.reset_tp_reduce_counts()
    model = _port_model(_port_mesh(1, 2), model_axis_mode="tp")
    model(torch.from_numpy(_data(2, seed=7)[0])).sum().backward()
    assert pmesh.tp_reduce_counts() == {"forward": 0, "backward": 0}
