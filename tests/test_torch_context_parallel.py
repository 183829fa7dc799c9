"""The port's context-parallel path (the transformer LM with its sequence
sharded over the mesh's ``model`` axis, ring attention by the step
kernels K7-K9) against the JAX package on the CPU, and the port's gloo
process mesh against its in-process mesh.

On CPU tensors the step kernels run their plain versions; the JAX side
runs its Pallas ring engine in interpret mode under ``shard_map`` on the 8
virtual CPU devices of ``tests/conftest.py``.  A tiny f32 LM: vocab 256,
d_model 32, 2 heads (head_dim 16), 2 layers, T=32 (shards of 8), batch 4.
Tolerances:

- logits: atol 1e-5, as the one-card slice's f32 logits
  (``test_torch_transformer_lm.py``); the ring only regroups the same f32
  sums.
- trainer, 3 AdamW steps on a (2, 4) mesh from the JAX trainer's state:
  losses rtol 1e-5; final params atol 1e-6 / rtol 1e-5 for all but 0.5%
  of the elements, every element within ``2·lr·steps·1.5`` (Adam's first
  steps are sign-like: an element whose gradient is within reduction
  noise of zero moves by up to ~2·lr per step in one framework only).
- the CP LM at head_dim 256 (the ring kernels' DP=256 build, JAX's
  Pallas ring) and 100 (the port's pad; JAX's blockwise ring, which
  takes a head_dim that is no multiple of 8): 2 heads, 1 layer, T=32 on
  a (2, 4) mesh; the loss rtol 1e-5 and each gradient within rtol 1e-5
  plus GRAD_ATOL_SHARE of its largest magnitude (a sum of terms of both
  signs, whose f32 rounding is relative to the terms).
- gloo process mesh (data=2, model=2, 4 processes) against the in-process
  mesh: ring output and gradients rtol 1e-5 / atol 1e-6 (the same
  kernels' plain versions on the same rows; the process ring sums the
  rotating dk/dv in the same step order); trainer losses rtol 1e-5 (each
  rank sums its share of the tokens' losses, and the all-reduce adds the
  shares: a regrouped f32 sum) and params as above; every rank's params
  bit-identical (one all-reduced gradient, one AdamW).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp_worker as worker
from elasticdl_tpu.parallel import MeshConfig as JaxMeshConfig
from elasticdl_tpu.parallel import build_mesh as jax_build_mesh
from elasticdl_tpu.parallel.dp_trainer import DataParallelTrainer as JaxTrainer
from elasticdl_tpu_torch.common import device as port_device
from elasticdl_tpu_torch.data.synthetic import synthetic_lm_arrays
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel import ring_attention as ring
from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer, pad_batch
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh, virtual_devices
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import transformer_lm as port_zoo
from model_zoo.transformer import transformer_lm as zoo

REPO = Path(__file__).resolve().parent.parent
MODEL_DEF = "transformer.transformer_lm"
PARAMS = dict(vocab=256, d_model=32, num_heads=2, num_layers=2, max_len=64, use_bf16=False)
SEQ, BATCH, STEPS, LR = 32, 4, 3, 3e-3
LOGIT_ATOL = 1e-5
STEP_RTOL = 1e-5
FINAL_TOL = dict(rtol=1e-5, atol=1e-6)
LOOSE_SHARE = 0.005
RING_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_ATOL_SHARE = 1e-5


def _data(n, seed):
    return synthetic_lm_arrays(n, SEQ, PARAMS["vocab"], seed)


def _jax_mesh():
    return jax_build_mesh(JaxMeshConfig(data=2, model=4))


def _port_mesh(data=2, model=4):
    return build_mesh(MeshConfig(data, model), devices=virtual_devices(data * model, "cpu"))


def _port_model(mesh, layout, **kw):
    return build_model(MODEL_DEF, dict(PARAMS, mesh=mesh, cp_layout=layout, **kw), device="cpu")


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


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_cp_logits_match_jax_model(layout):
    tokens, _ = _data(BATCH, seed=1)
    jax_model = zoo.custom_model(**PARAMS, mesh=_jax_mesh(), cp_layout=layout,
                                 attn_impl="pallas")
    variables = jax.device_get(jax_model.init(jax.random.PRNGKey(0), jnp.asarray(tokens)))
    want = np.asarray(jax_model.apply(variables, jnp.asarray(tokens)))
    model = _port_model(_port_mesh(), layout)
    convert.load_state(model, convert.state_dict_from_jax(variables, model))
    fa.reset_launch_counts()
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, SEQ, PARAMS["vocab"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    assert not any(fa.launch_counts().values())  # CPU tensors: plain versions


def test_cp_trainer_matches_jax_trainer():
    """3 DataParallelTrainer steps on an in-process (2, 4) mesh against the
    JAX trainer on the 8-device CPU mesh, from the JAX trainer's state;
    zigzag layout (the contiguous ring runs the same kernels, held to JAX
    above and in test_torch_ring_attention.py)."""
    tokens, labels = _data(BATCH * STEPS, seed=4)
    jax_mesh = _jax_mesh()
    jt = JaxTrainer(zoo.custom_model(**PARAMS, mesh=jax_mesh, cp_layout="zigzag",
                                     attn_impl="pallas"), zoo.loss, zoo.optimizer(), jax_mesh)
    jt.ensure_initialized(tokens[:BATCH])
    mesh = _port_mesh()
    model = _port_model(mesh, "zigzag")
    pt = DataParallelTrainer(model, port_zoo.loss, port_zoo.optimizer(), mesh=mesh)
    assert pt.mesh is mesh and pt.device == torch.device("cpu")
    pt.state = convert.dp_trainer_state_from_jax(jax.device_get(jt.state), model)
    for i in range(STEPS):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        j_loss = float(jt.train_step(tokens[rows], labels[rows]))
        p_loss = float(pt.train_step(tokens[rows], labels[rows]))
        np.testing.assert_allclose(p_loss, j_loss, rtol=STEP_RTOL)
    assert pt.step == STEPS
    _assert_params_close(pt.get_variables_numpy(), jt.get_variables_numpy(),
                         2 * LR * STEPS * 1.5)
    np.testing.assert_allclose(pt.eval_step(tokens[:BATCH]),
                               np.asarray(jt.eval_step(tokens[:BATCH])), rtol=0, atol=1e-4)


@pytest.mark.parametrize("head_dim,layout", [(256, "contiguous"), (100, "zigzag")])
def test_wide_head_dim_cp_loss_and_gradients_match_jax(head_dim, layout):
    """The CP LM at the ring kernels' widest build (256) and at a head_dim
    the port pads (100): loss and gradients against JAX's CP LM, from
    the JAX model's variables."""
    params = dict(PARAMS, d_model=2 * head_dim, num_heads=2, num_layers=1, vocab=64)
    tokens, labels = synthetic_lm_arrays(BATCH, SEQ, params["vocab"], 9)
    jax_model = zoo.custom_model(**params, mesh=_jax_mesh(), cp_layout=layout)
    variables = jax.device_get(jax.jit(jax_model.init)(jax.random.PRNGKey(2),
                                                       jnp.asarray(tokens)))
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda v: zoo.loss(jnp.asarray(labels), jax_model.apply(v, jnp.asarray(tokens)))))(
        variables)
    model = build_model(MODEL_DEF, dict(params, mesh=_port_mesh(), cp_layout=layout),
                        device="cpu")
    assert model.block_0.attn.qkv.kernel.shape[-1] == head_dim
    convert.load_state(model, convert.state_dict_from_jax(variables, model))
    loss = port_zoo.loss(torch.from_numpy(labels), model(torch.from_numpy(tokens)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=STEP_RTOL)
    want = convert.state_dict_from_jax(jax.device_get(j_grads), model)
    got = dict(model.named_parameters())
    assert set(got) <= set(want)
    for name, p in got.items():
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5,
                                   atol=GRAD_ATOL_SHARE * np.abs(w).max(), err_msg=name)


def test_in_process_cp_equals_one_card_forward_and_counts_positions():
    """The in-process CP model is the one-card model with ring attention:
    same logits; ``sequence_positions`` is None there (whole sequence)."""
    tokens, _ = _data(BATCH, seed=2)
    one = build_model(MODEL_DEF, PARAMS, device="cpu")
    one.init_parameters(torch.Generator().manual_seed(5))
    want = one(torch.from_numpy(tokens)).detach()
    for layout in ring.LAYOUTS:
        cp = _port_model(_port_mesh(1, 4), layout)
        cp.load_state_dict(one.state_dict())
        assert cp.sequence_positions(SEQ) is None
        np.testing.assert_allclose(cp(torch.from_numpy(tokens)).detach().numpy(), want.numpy(),
                                   rtol=0, atol=LOGIT_ATOL)


def test_unported_modes_and_meshes_raise():
    mesh = _port_mesh()
    # Tensor parallelism is ported: the mesh's model axis carries the heads.
    tp = _port_model(_port_mesh(4, 2), "contiguous", model_axis_mode="tp")
    assert tp.model_axis_mode == "tp" and tp.sequence_positions(SEQ) is None
    # A model axis of 1 carries nothing: "tp" is accepted there.
    _port_model(_port_mesh(8, 1), "contiguous", model_axis_mode="tp")
    with pytest.raises(NotImplementedError, match="multi-card"):
        build_model(MODEL_DEF, dict(PARAMS, mesh=["cuda:0", "cuda:1"]), device="cpu")
    with pytest.raises(ValueError, match="not the mesh's"):
        port_zoo.custom_model(**PARAMS, mesh=mesh, device="meta")
    # FSDP is ported: over this mesh's data axis of 2 it shards the
    # leaves JAX's rule picks.
    fsdp = DataParallelTrainer(_port_model(mesh, "contiguous"), port_zoo.loss,
                               port_zoo.optimizer(), mesh=mesh, dense_sharding="fsdp")
    assert fsdp.dense_sharding == "fsdp" and fsdp.fsdp_leaves
    with pytest.raises(NotImplementedError, match="in-process mesh"):
        build_mesh(MeshConfig(2, 1), devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="init_process_group"):
        build_mesh(MeshConfig(2, 2))
    with pytest.raises(ValueError, match="device count"):
        build_mesh(MeshConfig(3, 2), devices=virtual_devices(4, "cpu"))
    # The sharded K1-K3 dispatch, tensor parallelism and FSDP are ported:
    # what still raises is several real devices driven from one process.
    for item in ("SPARSE_DISPATCH_ITEM", "TENSOR_PARALLEL_ITEM", "FSDP_ITEM"):
        assert not hasattr(port_device, item)
    from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
    from elasticdl_tpu_torch.zoo import deepfm

    with pytest.raises(NotImplementedError, match="multi-card"):
        ShardedEmbeddingTrainer(deepfm.custom_model(vocab_size=10, device="cpu"), deepfm.loss,
                                deepfm.optimizer(), mesh=["cuda:0", "cuda:1"], device="cpu")
    with pytest.raises(NotImplementedError, match=port_device.MULTI_CARD_ITEM):
        deepfm.custom_model(vocab_size=10, mesh=["cuda:0", "cuda:1"], device="cpu")


def test_pad_batch_matches_jax():
    from elasticdl_tpu.parallel.sharding import pad_batch as jax_pad_batch

    for rows in (0, 3, 4, 5):
        x = np.arange(rows * 3, dtype=np.int32).reshape(rows, 3)
        feats = {"a": x, "b": x.astype(np.float32) * 2}
        got, got_mask = pad_batch(feats, 4)
        want, want_mask = jax_pad_batch(feats, 4)
        np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
        for key in feats:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))


# ----------------------------------------------------------------------
# the gloo process mesh: 4 CPU processes against the in-process mesh
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def process_mesh_run(tmp_path_factory):
    """Runs tests/torch_cp_worker.py on 4 gloo ranks (a file store under
    a fresh temporary directory); -> each rank's results."""
    out = tmp_path_factory.mktemp("gloo_cp")
    world = MESH_WORLD
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_cp_worker.py"),
                               str(rank), str(world), str(out / "store"), str(out)],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log}"
    return [dict(np.load(out / f"rank{rank}.npz")) for rank in range(world)]


MESH_WORLD = worker.MESH[0] * worker.MESH[1]


def test_process_mesh_ring_equals_in_process_ring(process_mesh_run):
    (q, k, v, g), _ = worker.cp_inputs()
    data, model = worker.MESH
    rows, t_local = q.shape[0] // data, q.shape[1] // model
    for layout in ring.LAYOUTS:
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        order, inv = ring.zigzag_orders(q.shape[1], model) if layout == "zigzag" else (None, None)
        attend = ring.make_ring_attention(_port_mesh(data, model), causal=True, layout=layout)
        if order is None:
            out = attend(*leaves)
        else:
            out = attend(*(x[:, order] for x in leaves))[:, inv]
        want = [out.detach().numpy()] + [
            x.numpy() for x in torch.autograd.grad(out, leaves, torch.from_numpy(g))]
        for rank, result in enumerate(process_mesh_run):
            d, m = divmod(rank, model)
            pos = ring.shard_positions(m, t_local, model, layout)
            for name, w in zip(("out", "dq", "dk", "dv"), want):
                np.testing.assert_allclose(result[f"ring_{layout}_{name}"],
                                           w[d * rows:(d + 1) * rows][:, pos], **RING_TOL,
                                           err_msg=f"{layout} {name} rank {rank}")
            # ring_self_attention's gather puts every rank's part in place.
            np.testing.assert_allclose(result[f"ring_{layout}_self_attention"], want[0],
                                       **RING_TOL, err_msg=f"{layout} gathered, rank {rank}")


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_process_mesh_trainer_equals_in_process(process_mesh_run, layout):
    _, batches = worker.cp_inputs()
    mesh = _port_mesh(*worker.MESH)
    model = build_model(MODEL_DEF, dict(worker.MODEL_PARAMS, mesh=mesh, cp_layout=layout),
                        device="cpu")
    trainer = DataParallelTrainer(model, port_zoo.loss, port_zoo.optimizer(), mesh=mesh,
                                  seed=worker.SEED)
    losses = np.asarray([float(trainer.train_step(t, lab)) for t, lab in batches])
    want = {name: p.detach().numpy() for name, p in trainer.state.params.items()}
    eval_want = trainer.eval_step(batches[0][0])
    first = process_mesh_run[0]
    prefix = f"train_{layout}_param_"
    for rank, result in enumerate(process_mesh_run):
        np.testing.assert_allclose(result[f"train_{layout}_losses"], losses, rtol=STEP_RTOL)
        got = {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}
        _assert_params_close(got, want, 2 * LR * worker.STEPS * 1.5)
        for name, value in got.items():  # replicated: identical on every rank
            assert np.array_equal(value, first[prefix + name]), (rank, name)
        np.testing.assert_allclose(result[f"train_{layout}_eval"], eval_want, rtol=0,
                                   atol=1e-4)
