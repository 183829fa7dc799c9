"""The port's float16 slice against the JAX package on the CPU: flash
attention on float16 inputs (the kernels' plain versions here, which the
CUDA kernels' f16 builds are held to on the card), the transformer LM
computing in float16, and ``DataParallelTrainer`` steps on it.

The float16 LM is reached as a user reaches JAX's
``TransformerLM(dtype=jnp.float16)``: from their own model module
(``chip_smoke.F16_ZOO_SOURCE``, the module phase 51 trains on the card),
loaded by ``common/model_utils.load_module``; the zoo's ``custom_model``
takes bf16 or f32 only, as JAX's does.  Inputs are numpy draws from a
seed.  Tolerances:

- attention (out, dq, dk, dv), against JAX's Pallas kernels in interpret
  mode on whole blocks: phase 51's f16 rule, within 2 f16 ulps (rtol
  2**-10, at least 2 subnormal steps) plus 2**-12 of the tensor's largest
  magnitude.  Both round the same f32 values to f16 (P before P V, the
  outputs), and a value a summation order away from a rounding boundary
  lands on either side; measured 1 ulp.
- the LM's logits: ``LOGIT_SHARE`` of the largest logit, the bf16 LM
  test's 2% scaled by f16's 8 times finer ulp.  The frameworks round at
  other places in the f16 blocks (a GEMM's output, GELU, the residual
  adds), so the f16 activations entering the f32 head differ by about an
  f16 ulp (2**-11 relative); measured 7.3e-4 of the largest (1.1e-3 at 2
  layers).
- the LM's loss at ``LOSS_RTOL``, and each parameter's gradient within a
  relative L2 error of ``GRAD_REL_L2``, phase 12's limits: the
  activations' gradients are f16 too, and each framework rounds them at
  its own places (measured 5.8e-6 and 1.2e-3; 2.2e-3 at 2 layers).
- the trainers (3 AdamW steps from the JAX trainer's state): per-step
  losses at ``LOSS_RTOL``; after the steps all but ``LOOSE_SHARE`` of the
  elements within ``FINAL_ATOL`` (1% of the steps' movement, lr·steps),
  and every element within ``2·lr·steps·1.5``: Adam's first steps are
  sign-like, so an element whose gradient is within f16 rounding of zero
  moves by up to ~2·lr a step in one framework and not the other
  (measured 0.18% of the elements past 1e-4, 0.10% past 3e-3, none past
  0.0135).
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    ATTN_F16_ATOL_SHARE,
    ATTN_F16_RTOL,
    F16_MODEL_DEF,
    F16_ULP_FLOOR,
    F16_ZOO,
    write_f16_zoo,
)
from elasticdl_tpu.parallel import MeshConfig, build_mesh
from elasticdl_tpu.parallel.dp_trainer import DataParallelTrainer as JaxTrainer
from elasticdl_tpu_torch.common.model_utils import load_module
from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import transformer_lm as port_zoo
from model_zoo.transformer import transformer_lm as zoo

jfa = importlib.import_module("elasticdl_tpu.ops.flash_attention")

PARAMS = dict(vocab=256, d_model=32, num_heads=2, num_layers=1, max_len=64)
SEQ, BATCH, STEPS, LR = 32, 4, 3, 3e-3
LOGIT_SHARE = 2.5e-3
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-2
#: After the trainers' steps: all but LOOSE_SHARE of the elements within
#: FINAL_ATOL, every element within 2·lr·steps·1.5.
FINAL_ATOL, LOOSE_SHARE = 1e-4, 0.005


def _assert_f16_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    limit = np.maximum(ATTN_F16_RTOL * np.abs(want), F16_ULP_FLOOR)
    limit = limit + ATTN_F16_ATOL_SHARE * np.abs(want).max()
    excess = np.abs(got - want) - limit
    assert excess.max() <= 0.0, (what, float(np.abs(got - want).max()))


def f16_user_zoo(tmp_path_factory):
    """The float16 LM's user module, loaded from a model zoo on disk: one
    directory for the whole test process, since a process holds one
    package of a name (``load_module`` refuses a second path for it) and
    ``tests/test_torch_cp_f16.py`` loads the same module."""
    zoo_dir = write_f16_zoo(str(tmp_path_factory.getbasetemp() / "f16_user"))
    return zoo_dir, load_module(zoo_dir, F16_MODEL_DEF)


@pytest.fixture(scope="module")
def f16_zoo(tmp_path_factory):
    """The float16 LM's user module, loaded from a model zoo on disk."""
    return f16_user_zoo(tmp_path_factory)


def _f16_model(zoo_dir):
    return build_model(F16_MODEL_DEF, PARAMS, device="cpu", model_zoo=zoo_dir)


def _jax_f16_model():
    return zoo.TransformerLM(**PARAMS, dtype=jnp.float16, attn_impl="pallas")


# (head_dim, T, causal): full JAX blocks (16 at T=64, 8 at T=32); 100 is
# no multiple of 8, and goes through the wrappers' pad to 104.
ATTN_CASES = [(16, 64, True), (16, 64, False), (100, 32, True)]


@pytest.mark.parametrize("d,t,causal", ATTN_CASES)
def test_f16_attention_matches_jax_kernels(d, t, causal):
    """out and dq, dk, dv at float16 against JAX's flash_attention and its
    custom_vjp (Pallas, interpret mode); head_dim 100 as the card runs it:
    q, k, v and dO padded with zero columns to 104, the outputs sliced
    back."""
    rng = np.random.default_rng(900 + d + t + causal)
    q, k, v, g = (rng.standard_normal((2, t, 2, d)).astype(np.float32) for _ in range(4))
    block = 16 if t % 16 == 0 else 8

    @jax.jit
    def forward_backward(a, b, c, cotangent):
        out, vjp = jax.vjp(lambda *x: jfa.flash_attention(*x, causal=causal, block_q=block,
                                                          block_k=block), a, b, c)
        return (out, *vjp(cotangent))

    want = forward_backward(*(jnp.asarray(x, jnp.float16) for x in (q, k, v, g)))
    qt, kt, vt, gt = (torch.from_numpy(x).to(torch.float16) for x in (q, k, v, g))
    if d % 8 == 0:
        leaves = [x.requires_grad_(True) for x in (qt, kt, vt)]
        out = fa.flash_attention(*leaves, causal=causal, block_q=block, block_k=block)
        out.backward(gt)
        got = [out.detach()] + [x.grad for x in leaves]
    else:
        scale = fa.default_scale(d)
        qp, kp, vp = fa._kernel_inputs(qt, kt, vt)
        gp = fa._kernel_dout(gt, qp)
        assert qp.shape[-1] == gp.shape[-1] == 104
        out, lse = fa.flash_attention_fwd_plain(qp, kp, vp, scale, causal, block)
        delta = fa.attention_delta(out, gp)
        dq = fa.flash_attention_dq_plain(qp, kp, vp, gp, lse, delta, scale, causal)
        dk, dv = fa.flash_attention_dkv_plain(qp, kp, vp, gp, lse, delta, scale, causal)
        got = [fa._unpad(x, d) for x in (out, dq, dk, dv)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float16 and tuple(a.shape) == (2, t, 2, d), name
        _assert_f16_close(a.float().numpy(), np.asarray(b, np.float32), name)


def test_user_module_builds_the_f16_lm(f16_zoo):
    """The user's module through ``load_module`` and ``zoo.build_model``:
    the repo's LM computing in float16 with f32 parameters, its f32
    logits; the zoo's own ``custom_model`` gains no dtype parameter."""
    zoo_dir, module = f16_zoo
    assert module.__name__ == f"{F16_ZOO}.{F16_MODEL_DEF}"
    assert load_module(zoo_dir, F16_MODEL_DEF) is module
    assert module.loss is port_zoo.loss and module.optimizer is port_zoo.optimizer
    model = _f16_model(zoo_dir)
    assert isinstance(model, port_zoo.TransformerLM)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.Embed_0.compute_dtype == torch.float16
    assert model.block_0.attn.qkv.compute_dtype == torch.float16
    assert model.lm_head.compute_dtype == torch.float32
    model.init_parameters(torch.Generator().manual_seed(0))
    tokens, _ = synthetic_lm_arrays(BATCH, SEQ, PARAMS["vocab"], 1)
    seen = []
    hook = model.block_0.attn.proj.register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    hook.remove()
    assert seen == [torch.float16]  # the attention's output, from K4's plain version
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert "dtype" not in inspect.signature(port_zoo.custom_model).parameters
    assert "dtype" not in inspect.signature(zoo.custom_model).parameters
    # Over a mesh it shards the sequence (tests/test_torch_cp_f16.py).
    assert {"mesh", "cp_layout"} <= set(inspect.signature(module.custom_model).parameters)


def _jax_logits_loss_grads(model, variables, tokens, labels):
    """JAX's logits, loss and parameter gradients, in one jitted call (its
    Pallas kernels run eagerly in interpret mode otherwise, and slowly)."""
    def loss_fn(params):
        logits = model.apply({"params": params}, jnp.asarray(tokens))
        return zoo.loss(jnp.asarray(labels), logits), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return np.asarray(logits), float(loss), jax.device_get(grads)


def test_f16_lm_matches_jax_model(f16_zoo):
    """Logits, loss and every parameter's gradient of the float16 LM
    against JAX's TransformerLM(dtype=float16, attn_impl="pallas"), the
    weights carried across by ``state_dict_from_jax``."""
    zoo_dir, module = f16_zoo
    tokens, labels = synthetic_lm_arrays(BATCH, SEQ, PARAMS["vocab"], 2)
    jax_model = _jax_f16_model()
    variables = jax.device_get(jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                                       jnp.asarray(tokens)))
    want_logits, want_loss, want_grads = _jax_logits_loss_grads(jax_model, variables, tokens,
                                                                labels)
    model = _f16_model(zoo_dir)
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


def test_f16_trainer_matches_jax_trainer(f16_zoo):
    """Three DataParallelTrainer steps on the float16 LM against the JAX
    trainer's, from the JAX trainer's state."""
    zoo_dir, module = f16_zoo
    tokens, labels = synthetic_lm_arrays(BATCH * STEPS, SEQ, PARAMS["vocab"], 4)
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jt = JaxTrainer(_jax_f16_model(), zoo.loss, zoo.optimizer(LR), mesh)
    jt.ensure_initialized(tokens[:BATCH])
    model = _f16_model(zoo_dir)
    pt = DataParallelTrainer(model, module.loss, module.optimizer(LR), device="cpu")
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
