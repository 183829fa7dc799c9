"""The port's context-parallel LM computing in float16 (the sequence
sharded over the mesh's ``model`` axis, ring attention by the step
kernels K7-K9) against the JAX package on the CPU.

The LM is reached as a user reaches JAX's ``TransformerLM(dtype=
jnp.float16, mesh=..., cp_layout=...)``: from their own model module
(``chip_smoke.F16_ZOO_SOURCE``, the module phases 51 and 52 train on the
card), loaded by ``common/model_utils.load_module``, whose
``custom_model`` passes ``mesh`` and ``cp_layout`` on; the zoo's own
``custom_model`` takes bf16 or f32 only, as JAX's does.  The port runs
on an in-process (2, 4) mesh of CPU slots, where the step kernels run
their plain versions; JAX runs its Pallas ring engine in interpret mode
under ``shard_map`` on the 8 virtual CPU devices of ``tests/conftest.py``.
A tiny LM: vocab 256, d_model 32, 2 heads (head_dim 16), 1 layer, T=32
(shards of 8), batch 4, in both layouts.  Tolerances, those of
``test_torch_flash_attention_f16.py`` for the one-card float16 LM (its
module docstring gives the readings behind them): the ring regroups the
same f16 blocks, and the frameworks round at other places in them.

- logits: ``LOGIT_SHARE`` of the largest logit;
- the loss at ``LOSS_RTOL``, each parameter's gradient from one state
  within a relative L2 error of ``GRAD_REL_L2``;
- the trainers, 3 AdamW steps from the JAX trainer's state: per-step
  losses at ``LOSS_RTOL``; after the steps all but ``LOOSE_SHARE`` of the
  elements within ``FINAL_ATOL`` and every element within
  ``2·lr·steps·1.5`` (Adam's first steps are sign-like).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import F16_MODEL_DEF
from elasticdl_tpu.parallel import MeshConfig as JaxMeshConfig
from elasticdl_tpu.parallel import build_mesh as jax_build_mesh
from elasticdl_tpu.parallel.dp_trainer import DataParallelTrainer as JaxTrainer
from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh, virtual_devices
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import transformer_lm as port_zoo
from model_zoo.transformer import transformer_lm as zoo
from test_torch_flash_attention_f16 import (
    FINAL_ATOL,
    GRAD_REL_L2,
    LOGIT_SHARE,
    LOOSE_SHARE,
    LOSS_RTOL,
    _jax_logits_loss_grads,
    f16_user_zoo,
)

PARAMS = dict(vocab=256, d_model=32, num_heads=2, num_layers=1, max_len=64)
SEQ, BATCH, STEPS, LR = 32, 4, 3, 3e-3
LAYOUTS = ["contiguous", "zigzag"]


@pytest.fixture(scope="module")
def f16_zoo(tmp_path_factory):
    """The float16 LM's user module, loaded from a model zoo on disk."""
    return f16_user_zoo(tmp_path_factory)


def _jax_mesh():
    return jax_build_mesh(JaxMeshConfig(data=2, model=4))


def _port_mesh():
    return build_mesh(MeshConfig(2, 4), devices=virtual_devices(8, "cpu"))


def _cp_model(zoo_dir, layout):
    return build_model(F16_MODEL_DEF, dict(PARAMS, mesh=_port_mesh(), cp_layout=layout),
                       model_zoo=zoo_dir)


def _jax_cp_model(layout):
    return zoo.TransformerLM(**PARAMS, dtype=jnp.float16, mesh=_jax_mesh(), cp_layout=layout,
                             attn_impl="pallas")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_user_module_builds_the_f16_cp_lm(f16_zoo, layout):
    """``custom_model`` of the user's module takes a mesh and a layout: the
    LM computes in float16 over the mesh's device (f32 parameters, f32
    logits), its attention is the ring (the step functions, no
    whole-sequence kernel), and on CPU tensors nothing launches."""
    zoo_dir, _ = f16_zoo
    model = _cp_model(zoo_dir, layout)
    assert model.mesh is not None and model.cp_layout == layout
    assert model.Embed_0.compute_dtype == torch.float16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.device for p in model.parameters()} == {torch.device("cpu")}
    model.init_parameters(torch.Generator().manual_seed(0))
    tokens, _ = synthetic_lm_arrays(BATCH, SEQ, PARAMS["vocab"], 1)
    calls = []
    carry = fa.flash_ring_step_carry

    def spy(q, *args, **kwargs):
        calls.append(q.dtype)
        return carry(q, *args, **kwargs)

    fa.reset_launch_counts()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(fa, "flash_ring_step_carry", spy)
        with torch.no_grad():
            logits = model(torch.from_numpy(tokens))
    assert not any(fa.launch_counts().values())
    assert calls and set(calls) == {torch.float16}
    assert len(calls) == PARAMS["num_layers"] * 4 * 4  # slots x steps of a ring of 4
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_f16_cp_lm_matches_jax_model(f16_zoo, layout):
    """Logits, loss and every parameter's gradient of the float16 CP LM
    against JAX's TransformerLM(dtype=float16, mesh, cp_layout,
    attn_impl="pallas"), the weights carried across by
    ``state_dict_from_jax``."""
    zoo_dir, module = f16_zoo
    tokens, labels = synthetic_lm_arrays(BATCH, SEQ, PARAMS["vocab"], 2)
    jax_model = _jax_cp_model(layout)
    variables = jax.device_get(jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                                       jnp.asarray(tokens)))
    want_logits, want_loss, want_grads = _jax_logits_loss_grads(jax_model, variables, tokens,
                                                                labels)
    model = _cp_model(zoo_dir, layout)
    convert.load_state(model, convert.state_dict_from_jax(variables, model))
    logits = model(torch.from_numpy(tokens))
    loss = module.loss(torch.from_numpy(labels), logits)
    loss.backward()
    diff = np.abs(logits.detach().numpy() - want_logits)
    assert diff.max() <= LOGIT_SHARE * np.abs(want_logits).max(), diff.max()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_RTOL)
    want = convert.state_dict_from_jax({"params": want_grads}, model)
    for name, p in model.named_parameters():
        got, ref = p.grad.numpy(), want[name]
        rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= GRAD_REL_L2, (name, rel)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_f16_cp_trainer_matches_jax_trainer(f16_zoo, layout):
    """Three DataParallelTrainer steps of the float16 CP LM on the
    in-process (2, 4) mesh against the JAX trainer's on its 8-device CPU
    mesh, from the JAX trainer's state."""
    zoo_dir, module = f16_zoo
    tokens, labels = synthetic_lm_arrays(BATCH * STEPS, SEQ, PARAMS["vocab"], 4)
    jax_mesh = _jax_mesh()
    jt = JaxTrainer(_jax_cp_model(layout), zoo.loss, zoo.optimizer(LR), jax_mesh)
    jt.ensure_initialized(tokens[:BATCH])
    model = _cp_model(zoo_dir, layout)
    pt = DataParallelTrainer(model, module.loss, module.optimizer(LR), mesh=model.mesh)
    assert module.loss is port_zoo.loss and pt.device == torch.device("cpu")
    pt.state = convert.dp_trainer_state_from_jax(jax.device_get(jt.state), model)
    for i in range(STEPS):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        j_loss = float(jt.train_step(tokens[rows], labels[rows]))
        p_loss = float(pt.train_step(tokens[rows], labels[rows]))
        np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_RTOL)
    assert pt.step == STEPS
    jv, pv = jt.get_variables_numpy(), pt.get_variables_numpy()
    assert sorted(jv) == sorted(pv)
    loose = 0
    for name in jv:
        diff = np.abs(pv[name] - jv[name])
        assert diff.max() <= 2 * LR * STEPS * 1.5, name
        loose += int((diff > FINAL_ATOL).sum())
    assert loose <= LOOSE_SHARE * sum(v.size for v in jv.values()), loose
