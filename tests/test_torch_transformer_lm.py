"""The port's transformer LM slice (elasticdl_tpu_torch) against the JAX
package on the CPU: the conversion of the flax variables, the logits of
the model with both JAX attention engines, optax's AdamW, the synthetic
LM data, and ``DataParallelTrainer`` itself, started from the JAX
trainer's own state (``serving.convert.dp_trainer_state_from_jax``).

A tiny LM: vocab 256, d_model 32, 2 heads (head_dim 16), 2 layers,
T=32, batch 4.  Tolerances:

- f32 logits: atol 1e-5 (logits up to ~4; the frameworks reduce the
  matmuls and LayerNorm sums in other orders; measured 3e-6).
- bf16 logits: 2% of the largest logit elementwise, 1% of the mean
  magnitude on average.  The two frameworks round at other places in the
  bf16 blocks (a bf16 GEMM's output, GELU inside or outside f32, the
  flash kernel's P against the XLA engine's f32 P), so the bf16
  activations entering the f32 head differ by about a bf16 ulp (2**-8,
  0.4-0.8% relative); measured 1.0% of the largest logit, 0.6-0.7% of
  the mean magnitude.
- the bf16 head (``logits_compute="bf16"``): its logits against JAX's
  ``_Bf16AccF32Head`` at rtol 1e-5 / atol 1e-6 (the bf16 operands'
  products are exact in f32; only the summation order differs); dx and
  dkernel within one bf16 ulp (rtol 2**-7): each is an f32 sum rounded to
  bf16, and the two frameworks sum in other orders, so a sum near a
  rounding boundary may round to the neighbouring bf16 value; the whole
  f32-bodied model with that head within the bf16 logit shares above;
- trainer (f32): per-step losses rtol 1e-5; final params after 3 AdamW
  steps atol 1e-6 / rtol 1e-5 for all but 0.5% of the elements, every
  element within ``2·lr·steps·1.5``: Adam's first steps are sign-like,
  so an element whose gradient is within reduction noise of zero moves
  by up to ~2·lr per step in one framework and not the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.parallel import MeshConfig, build_mesh
from elasticdl_tpu.parallel.dp_trainer import DataParallelTrainer as JaxTrainer
from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel import optim
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import transformer_lm as port_zoo
from model_zoo import datasets
from model_zoo.transformer import transformer_lm as zoo

MODEL_DEF = "transformer.transformer_lm"
PARAMS = dict(vocab=256, d_model=32, num_heads=2, num_layers=2, max_len=64)
SEQ, BATCH, STEPS, LR = 32, 4, 3, 3e-3
F32_LOGIT_ATOL = 1e-5
BF16_LOGIT_MAX_SHARE, BF16_LOGIT_MEAN_SHARE = 2e-2, 1e-2
STEP_RTOL = 1e-5
FINAL_TOL = dict(rtol=1e-5, atol=1e-6)


def _data(n, seed=1):
    return synthetic_lm_arrays(n, SEQ, PARAMS["vocab"], seed)


def _port_model(use_bf16=False, **kw):
    return build_model(MODEL_DEF, dict(PARAMS, use_bf16=use_bf16, **kw), device="cpu")


def _jax_variables(model, tokens, seed=0):
    return jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.asarray(tokens)))


def _port_from_jax(variables, use_bf16=False, **kw):
    model = _port_model(use_bf16, **kw)
    convert.load_state(model, convert.state_dict_from_jax(variables, model))
    return model


def test_conversion_round_trip():
    tokens, _ = _data(BATCH)
    variables = _jax_variables(zoo.custom_model(**PARAMS), tokens)
    model = _port_from_jax(variables)
    names = {name for name, _ in model.named_parameters()}
    assert {"Embed_0.weight", "Embed_1.weight", "block_1.attn.qkv.kernel",
            "block_0.LayerNorm_1.weight", "LayerNorm_0.bias", "lm_head.weight"} <= names
    assert tuple(model.block_0.attn.qkv.kernel.shape) == (32, 3, 2, 16)
    back, tables = convert.jax_variables_from_port(model)
    assert tables == {}
    want = convert.flatten_variables(variables)
    got = convert.flatten_variables(back)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)
    # A leftover or missing JAX key raises.
    variables["params"]["extra"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(KeyError, match="without a port counterpart"):
        convert.state_dict_from_jax(variables, model)


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_logits_match_jax_model(attn_impl, use_bf16):
    tokens, _ = _data(BATCH)
    jax_model = zoo.custom_model(**PARAMS, use_bf16=use_bf16, attn_impl=attn_impl)
    variables = _jax_variables(jax_model, tokens)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(tokens)))
    model = _port_from_jax(variables, use_bf16, attn_impl=attn_impl)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, SEQ, PARAMS["vocab"])
    got = got.numpy()
    diff = np.abs(got - want)
    if not use_bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_LOGIT_ATOL)
    else:
        assert diff.max() <= BF16_LOGIT_MAX_SHARE * np.abs(want).max(), diff.max()
        assert diff.mean() <= BF16_LOGIT_MEAN_SHARE * np.abs(want).mean(), diff.mean()


def test_adamw_matches_optax():
    rng = np.random.RandomState(2)
    shapes = {"w": (5, 3), "b": (3,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.adamw(LR, weight_decay=0.01)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = port_zoo.optimizer(LR)
    assert opt.name == "adamw"
    p_state = opt.init(p_params)
    for step in range(4):
        grads = {k: rng.randn(*s).astype(np.float32) * 10.0 ** (-step) for k, s in shapes.items()}
        updates, j_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, j_state,
                                     j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.apply(p_params, {k: torch.from_numpy(g) for k, g in grads.items()}, p_state)
    assert int(p_state["count"]) == 4
    for k in shapes:  # the bias corrections' pow may differ by 1 ulp
        np.testing.assert_allclose(p_params[k].numpy(), np.asarray(j_params[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(p_state["mu"][k].numpy(), np.asarray(j_state[0].mu[k]),
                                   rtol=1e-6, atol=0)
    # weight_decay=0 is optax.adam step for step
    plain = {"w": torch.ones(3)}
    decayed = {"w": torch.ones(3)}
    a, w = optim.adam(LR), optim.adamw(LR, weight_decay=0.0)
    sa, sw = a.init(plain), w.init(decayed)
    for _ in range(2):
        a.apply(plain, {"w": torch.full((3,), 0.5)}, sa)
        w.apply(decayed, {"w": torch.full((3,), 0.5)}, sw)
    assert torch.equal(plain["w"], decayed["w"])


def _trainers():
    tokens, _ = _data(BATCH)
    mesh = build_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jt = JaxTrainer(zoo.custom_model(**PARAMS, use_bf16=False, attn_impl="pallas"),
                    zoo.loss, zoo.optimizer(), mesh)
    jt.ensure_initialized(tokens)
    model = _port_model(False, attn_impl="pallas")
    pt = DataParallelTrainer(model, port_zoo.loss, port_zoo.optimizer(), device="cpu")
    pt.state = convert.dp_trainer_state_from_jax(jax.device_get(jt.state), model)
    return jt, pt


def test_trainer_matches_jax_trainer():
    jt, pt = _trainers()
    tokens, labels = _data(BATCH * STEPS, seed=4)
    for i in range(STEPS):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        j_loss = float(jt.train_step(tokens[rows], labels[rows]))
        p_loss = float(pt.train_step(tokens[rows], labels[rows]))
        np.testing.assert_allclose(p_loss, j_loss, rtol=STEP_RTOL)
    assert pt.step == STEPS and int(pt.state.opt_state["count"]) == STEPS
    jv, pv = jt.get_variables_numpy(), pt.get_variables_numpy()
    assert sorted(jv) == sorted(pv)
    loose = []
    for name in jv:
        diff = np.abs(pv[name] - jv[name])
        assert diff.max() <= 2 * LR * STEPS * 1.5, name
        tight = diff <= FINAL_TOL["atol"] + FINAL_TOL["rtol"] * np.abs(jv[name])
        loose += [(name, tuple(int(i) for i in idx)) for idx in np.argwhere(~tight)]
    assert len(loose) <= 0.005 * sum(v.size for v in jv.values()), loose[:20]
    # eval_step is the same forward.
    want = np.asarray(jt.eval_step(tokens[:BATCH]))
    np.testing.assert_allclose(pt.eval_step(tokens[:BATCH]), want, rtol=0, atol=1e-4)


def test_dp_state_conversion_and_round_trip():
    jt, pt = _trainers()
    state = convert.dp_trainer_state_from_jax(jax.device_get(jt.state), pt.model)
    assert pt.state_to_host() is None  # applied at initialisation
    pt.ensure_initialized()
    assert sorted(state.opt_state) == ["count", "mu", "nu"]
    assert state.params["block_0.Dense_0.weight"].shape == (128, 32)  # transposed
    host = pt.state_to_host()
    for name, value in state.params.items():
        np.testing.assert_array_equal(host.params[name], value)
    bad = jax.device_get(jt.state)._replace(opt_state=optax.sgd(0.1).init(jt.state.params))
    with pytest.raises(ValueError, match="not an optax adam/adamw chain state"):
        convert.dp_trainer_state_from_jax(bad, pt.model)


def test_train_window_matches_train_steps():
    tokens, labels = _data(BATCH * 2, seed=5)
    batches = [(tokens[i * BATCH:(i + 1) * BATCH], labels[i * BATCH:(i + 1) * BATCH],
                np.ones((BATCH,), np.float32)) for i in range(2)]
    by_step = DataParallelTrainer(_port_model(), port_zoo.loss, port_zoo.optimizer(),
                                  seed=3, device="cpu")
    by_window = DataParallelTrainer(_port_model(), port_zoo.loss, port_zoo.optimizer(),
                                    seed=3, device="cpu")
    by_step.ensure_initialized()
    step_losses = [float(by_step.train_step_local(*b)) for b in batches]
    window_losses = by_window.train_window(by_window.stage_window(batches))
    assert window_losses.shape == (2,) and by_window.step == 2
    np.testing.assert_array_equal(window_losses.numpy(), np.asarray(step_losses, np.float32))
    for name, p in by_step.state.params.items():
        assert torch.equal(p, by_window.state.params[name]), name


def test_masked_rows_carry_no_gradient():
    tokens, labels = _data(BATCH, seed=6)
    trainer = DataParallelTrainer(_port_model(), port_zoo.loss, port_zoo.optimizer(),
                                  device="cpu")
    trainer.ensure_initialized()
    mask = np.array([1, 1, 0, 0], np.float32)
    full = trainer.forward(*trainer.stage_batch(tokens, labels, mask))
    half = trainer.forward(*trainer.stage_batch(tokens[:2], labels[:2], np.ones(2, np.float32)))
    np.testing.assert_allclose(float(full.detach()), float(half.detach()), rtol=1e-6)


def test_remat_matches_no_remat():
    tokens, labels = (torch.from_numpy(x) for x in _data(BATCH, seed=7))
    grads = []
    for remat in (False, True):
        model = _port_model(remat=remat)
        model.init_parameters(torch.Generator().manual_seed(11))
        fa.reset_launch_counts()
        loss = port_zoo.loss(labels, model(tokens))
        grads.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_loss_falls():
    tokens, labels = _data(64, seed=8)
    trainer = DataParallelTrainer(_port_model(), port_zoo.loss, port_zoo.optimizer(),
                                  device="cpu")
    losses = [float(trainer.train_step(tokens[i:i + 16], labels[i:i + 16]))
              for _ in range(3) for i in range(0, 64, 16)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < 0.9 * np.mean(losses[:3]), losses


def test_synthetic_lm_arrays_match_the_zoo_reader():
    n, seq_len, vocab = 50, 24, 97
    tokens, nxt = synthetic_lm_arrays(n, seq_len, vocab, seed=9)
    reader = datasets.synthetic_lm_reader(n=n, seq_len=seq_len, vocab=vocab, seed=9)
    task = type("Task", (), {"start": 0, "end": n})()
    records = list(reader.read_records(task))
    np.testing.assert_array_equal(tokens, np.stack([r[0] for r in records]))
    np.testing.assert_array_equal(nxt, np.stack([r[1] for r in records]))
    assert tokens.dtype == nxt.dtype == np.int32
    got = port_zoo.custom_data_reader(f"synthetic://lm?n={n}&len={seq_len}&vocab={vocab}&seed=9")
    port_records = list(got.read_records(task))
    np.testing.assert_array_equal(np.stack([r[0] for r in port_records]), tokens)
    np.testing.assert_array_equal(np.stack([r[1] for r in port_records]), nxt)
    assert port_zoo.custom_data_reader("synthetic://mnist?n=4") is None
    assert port_zoo.custom_data_reader("/data/records") is None


def test_eval_metrics_match_the_zoo():
    rng = np.random.default_rng(12)
    outputs = rng.standard_normal((2, 8, 16)).astype(np.float32)
    labels = rng.integers(0, 16, (2, 8)).astype(np.int32)
    want, got = zoo.eval_metrics_fn(), port_zoo.eval_metrics_fn()
    assert sorted(want) == sorted(got)
    for name in want:
        np.testing.assert_allclose(got[name](outputs, labels), want[name](outputs, labels),
                                   rtol=1e-5)


def test_unsupported_choices_raise():
    with pytest.raises(NotImplementedError, match="multi-card"):
        _port_model(mesh=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="logits_compute"):
        _port_model(logits_compute="fp8")
    with pytest.raises(ValueError, match="attn_impl"):
        _port_model(attn_impl="triton")
    with pytest.raises(ValueError, match="model_axis_mode"):
        _port_model(model_axis_mode="pp")
    with pytest.raises(ValueError, match="cp_layout"):
        _port_model(cp_layout="striped")
    # One device, or a mode that would act only over several: accepted.
    _port_model(mesh=["cuda:0"], model_axis_mode="tp", cp_layout="zigzag")
    model = _port_model()
    with pytest.raises(NotImplementedError, match="multi-card"):
        DataParallelTrainer(model, port_zoo.loss, port_zoo.optimizer(), device="cpu",
                            mesh=["cuda:0", "cuda:1"])
    # FSDP without a mesh is the replicated layout, as in JAX.
    fsdp = DataParallelTrainer(model, port_zoo.loss, port_zoo.optimizer(), device="cpu",
                               dense_sharding="fsdp")
    assert fsdp.dense_sharding == "fsdp" and fsdp.fsdp_leaves == {}
    with pytest.raises(ValueError, match="dense_sharding"):
        DataParallelTrainer(model, port_zoo.loss, port_zoo.optimizer(), device="cpu",
                            dense_sharding="zero3")


def test_bf16_logits_head_parity_and_checkpoint_names():
    """``logits_compute="bf16"``: the same parameter tree as the f32 head
    (one JAX checkpoint loads into both heads), and the head's logits,
    dx and dkernel against JAX's ``_Bf16AccF32Head`` under ``jax.vjp``."""
    tokens, _ = _data(BATCH)
    j32 = zoo.custom_model(**PARAMS, use_bf16=False)
    j16 = zoo.custom_model(**PARAMS, use_bf16=False, logits_compute="bf16")
    variables = _jax_variables(j32, tokens)
    paths = lambda v: {p for p, _ in jax.tree_util.tree_flatten_with_path(v)[0]}  # noqa: E731
    assert paths(variables) == paths(_jax_variables(j16, tokens))
    f32_head, bf16_head = _port_from_jax(variables), _port_from_jax(
        variables, logits_compute="bf16")
    assert isinstance(bf16_head.lm_head, port_zoo.Bf16AccF32Head)
    assert ({n for n, _ in f32_head.named_parameters()}
            == {n for n, _ in bf16_head.named_parameters()})
    want = np.asarray(j16.apply(variables, jnp.asarray(tokens)))
    with torch.no_grad():
        got = bf16_head(torch.from_numpy(tokens))
        ref = f32_head(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= BF16_LOGIT_MAX_SHARE * np.abs(want).max(), diff.max()
    assert diff.mean() <= BF16_LOGIT_MEAN_SHARE * np.abs(want).mean(), diff.mean()
    assert not torch.equal(got, ref)  # the operands really were rounded

    # The head alone, forward and backward, on both x dtypes.
    rng = np.random.default_rng(5)
    kernel = (rng.standard_normal((32, 200)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(200).astype(np.float32)
    g = rng.standard_normal((3, 7, 200)).astype(np.float32)
    head = zoo._Bf16AccF32Head(200)
    for x_dtype, t_dtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        x = jnp.asarray(rng.standard_normal((3, 7, 32)).astype(np.float32)).astype(x_dtype)
        params = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
        out, vjp = jax.vjp(lambda p, x: head.apply(p, x), params, x)
        dparams, dx = vjp(jnp.asarray(g))
        port = port_zoo.Bf16AccF32Head(32, 200, device="cpu")
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(kernel.T))
            port.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(t_dtype).requires_grad_()
        logits = port(xt)
        logits.backward(torch.from_numpy(g))
        assert logits.dtype == torch.float32 and xt.grad.dtype == t_dtype
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(out),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(dx.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=0)
        np.testing.assert_allclose(port.weight.grad.numpy().T,
                                   np.asarray(dparams["params"]["kernel"]), rtol=2 ** -7, atol=0)
        np.testing.assert_allclose(port.bias.grad.numpy(),
                                   np.asarray(dparams["params"]["bias"]), rtol=1e-5, atol=1e-5)
