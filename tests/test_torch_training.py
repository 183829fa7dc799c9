"""The port's PS-mode training slice (elasticdl_tpu_torch) against the JAX
package on the CPU: the FM and lookup backwards, the dense optimizer,
the seeded init and synthetic data, and ``ShardedEmbeddingTrainer``
itself, started from the JAX trainer's own state
(``serving.convert.trainer_state_from_jax``), through export to both
serving loaders.

DeepFM at vocab 100 per field, ``embedding_dim`` 4, ``hidden`` 16,
batch 16.  Tolerances:

- per-step losses, dense grads and captured sparse grads: rtol 1e-5 /
  atol 1e-6, the JAX engines' own bar (``tests/test_sparse_kernels.py``).
  The frameworks reduce the matmuls and sums in other orders;
- final variables after 3 Adam steps: atol 1e-6 / rtol 1e-5, except the
  elements NAMED by ``_sign_sensitive``: Adam's first step is
  ``lr·g/(|g|+eps)``, whose slope ``lr·eps/(|g|+eps)²`` is huge near
  ``g = 0``, so a gradient element within reduction noise of zero can
  move its parameter by anything up to ``2·lr`` per step in one
  framework and not the other.  An element is named when the two
  frameworks' measured gradients differ in sign, or by enough to move
  that step by more than a tenth of the final atol; those are held to
  ``2·lr·steps`` and must stay few.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.ops import sparse_embedding as jske
from elasticdl_tpu.parallel import packed as jpk
from elasticdl_tpu.parallel.mesh import MeshConfig, build_mesh
from elasticdl_tpu.parallel.ps_trainer import ShardedEmbeddingTrainer as JaxTrainer
from elasticdl_tpu.serving import load_for_serving as jax_load_for_serving
from elasticdl_tpu_torch.data.synthetic import synthetic_ctr_arrays
from elasticdl_tpu_torch.layers import embedding as emb
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel import optim, ps_trainer
from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.serving.export import export_model, load_for_serving
from elasticdl_tpu_torch.zoo import build_model
from elasticdl_tpu_torch.zoo import deepfm as port_zoo
from model_zoo import datasets
from model_zoo.deepfm import deepfm_functional_api as zoo

VOCAB, DIM, HIDDEN, BATCH, STEPS = 100, 4, 16, 16, 3
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
FINAL_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
EPS = 1e-8
MODEL_DEF = "deepfm.deepfm_functional_api"


def _data(n_batches, seed=3):
    feats, labels = synthetic_ctr_arrays(BATCH * n_batches, vocab_size=VOCAB, seed=seed)
    feats["cat"][0, :2] = [-1, -1]            # padding
    feats["cat"][1, 25] = VOCAB + 5           # out of vocabulary (last field)
    feats["cat"][2, 25] = VOCAB + 9
    return [
        ({k: v[i * BATCH:(i + 1) * BATCH] for k, v in feats.items()},
         labels[i * BATCH:(i + 1) * BATCH])
        for i in range(n_batches)
    ]


def _params(split):
    return dict(vocab_size=VOCAB, embedding_dim=DIM, hidden=HIDDEN, split_tables=split)


def _trainers(kernel, split, sparse_apply_every=1):
    """A JAX trainer and a port trainer started from its state."""
    mesh = build_mesh(MeshConfig(), devices=jax.devices()[:1])
    jax_model = zoo.custom_model(**_params(split), sparse_kernel=kernel)
    jt = JaxTrainer(jax_model, zoo.loss, zoo.optimizer(), mesh,
                    embedding_optimizer=zoo.embedding_optimizer(), sparse_kernel=kernel,
                    sparse_apply_every=sparse_apply_every)
    jt.ensure_initialized(_data(1)[0][0])
    model = build_model(MODEL_DEF, _params(split), device="cpu")
    pt = ShardedEmbeddingTrainer(model, port_zoo.loss, port_zoo.optimizer(),
                                 embedding_optimizer=port_zoo.embedding_optimizer(),
                                 sparse_apply_every=sparse_apply_every, sparse_kernel=kernel,
                                 device="cpu")
    pt.ensure_initialized()
    pt.state = convert.trainer_state_from_jax(jax.device_get(jt.state), model)
    return jt, pt


def _sign_sensitive(history):
    """history: per step, the JAX and the port grads ``{name: array}`` in
    the JAX layout -> per name, the bool mask of elements whose gradients
    differ in sign, or by enough to move Adam's first-step update
    ``lr·g/(|g|+eps)`` by more than FINAL_TOL's atol / 10, in some step."""
    flags = {}
    for jax_g, port_g in history:
        for name, g in jax_g.items():
            diff = np.abs(g - port_g[name])
            moved = LR * diff * EPS / (np.abs(g) + EPS) ** 2
            bad = (np.sign(g) != np.sign(port_g[name])) | (moved > FINAL_TOL["atol"] / 10)
            flags[name] = flags.get(name, np.zeros(g.shape, bool)) | bad
    return flags


def _assert_final(jv, pv, flags, steps):
    assert sorted(jv) == sorted(pv)
    named = []
    for name in jv:
        ref, got = jv[name], pv[name]
        sensitive = flags.get(name, np.zeros(ref.shape, bool))
        np.testing.assert_allclose(got[~sensitive], ref[~sensitive], err_msg=name, **FINAL_TOL)
        assert np.all(np.abs(got - ref)[sensitive] <= 2 * LR * steps + 1e-6), name
        named += [(name, tuple(int(i) for i in idx)) for idx in np.argwhere(sensitive)]
    total = sum(v.size for v in jv.values())
    assert len(named) <= 0.02 * total, named[:20]


def _jax_layout(model, dense):
    """{port parameter name: grad} -> {"params/<flax path>": grad}."""
    out = {}
    for jax_key, port_key, kind, _ in convert._targets(model):
        if kind != "table":
            g = np.asarray(dense[port_key])
            out[jax_key] = g.T if kind == "dense_kernel" else g
    return out


def _table_grads(pt, sparse):
    """Captured sparse grads -> per table key, the summed gradient table
    in the logical [vocab, dim] view (the rows the Adam step sees)."""
    out = {}
    for key, (ids, grads) in sparse.items():
        spec = pt.table_specs[key]
        acc = pk.grad_accumulate(spec, torch.zeros(spec.rows_shape),
                                 torch.as_tensor(np.array(ids)), torch.as_tensor(grads).detach())
        out["params/" + key] = acc[: spec.vocab_size, : spec.dim].numpy()
    return out


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("kernel", ["fused", "xla"])
def test_trainer_matches_jax_trainer(kernel, split):
    jt, pt = _trainers(kernel, split)
    forward_backward = jax.jit(jt._forward_backward)
    history = []
    for features, labels in _data(STEPS):
        mask = np.ones((BATCH,), np.float32)
        j_loss, muts, j_dense, j_perturb = forward_backward(jt.state, features, labels, mask)
        p_loss, cap = pt.forward(*pt.stage_batch(features, labels, mask))
        p_dense, p_sparse, _ = pt.backward(p_loss, cap)
        np.testing.assert_allclose(float(p_loss.detach()), float(j_loss), **STEP_TOL)
        j_dense = convert._dense_from_jax(jax.device_get(j_dense), pt.model)
        for name, g in j_dense.items():
            np.testing.assert_allclose(p_dense[name].numpy(), g, err_msg=name, **STEP_TOL)
        j_sparse = {
            key: (np.asarray(ids), np.asarray(grads))
            for key, _, ids, grads in jt._sparse_batches(muts, j_perturb, jt.state.tables)
        }
        assert sorted(j_sparse) == sorted(p_sparse)
        for key, (ids, grads) in j_sparse.items():
            np.testing.assert_array_equal(p_sparse[key][0].numpy(), ids)
            np.testing.assert_allclose(p_sparse[key][1].numpy(), grads, err_msg=key, **STEP_TOL)
        history.append((
            {**_jax_layout(pt.model, j_dense), **_table_grads(pt, j_sparse)},
            {**_jax_layout(pt.model, {k: g.numpy() for k, g in p_dense.items()}),
             **_table_grads(pt, p_sparse)},
        ))
        jt.train_step(features, labels)
        pt.train_step(features, labels)
    assert pt.step == STEPS
    _assert_final(jt.get_variables_numpy(), pt.get_variables_numpy(),
                  _sign_sensitive(history), STEPS)
    oov = sum(int(np.sum(f["cat"][:, -1] >= VOCAB)) for f, _ in _data(STEPS))
    assert pt.consume_oov_count() == jt.consume_oov_count() == oov * (2 if split else 1)


def test_train_window_matches_jax_windowed_apply():
    """sparse_apply_every=2 over 3 steps: one full chunk and a tail."""
    jt, pt = _trainers("fused", False, sparse_apply_every=2)
    batches = [(f, l, np.ones((BATCH,), np.float32)) for f, l in _data(3)]
    j_losses = np.asarray(jt.train_window(jt.stage_window(batches)))
    p_losses = pt.train_window(pt.stage_window(batches)).numpy()
    np.testing.assert_allclose(p_losses, j_losses, **STEP_TOL)
    assert pt.step == 3
    # The JAX window's per-step grads are not reachable to name the
    # sign-sensitive elements from, so every element is held to the Adam
    # bound and all but a few (named in the message) to the tight bar.
    jv, pv = jt.get_variables_numpy(), pt.get_variables_numpy()
    loose = []
    for name in jv:
        diff = np.abs(pv[name] - jv[name])
        assert diff.max() <= 2 * LR * 3 + 1e-6, name
        tight = diff <= FINAL_TOL["atol"] + FINAL_TOL["rtol"] * np.abs(jv[name])
        loose += [(name, tuple(int(i) for i in idx)) for idx in np.argwhere(~tight)]
    assert len(loose) <= 0.005 * sum(v.size for v in jv.values()), loose
    assert pt.consume_oov_count() == jt.consume_oov_count() > 0


def test_windowed_apply_reads_tables_as_of_chunk_start(monkeypatch):
    model = build_model(MODEL_DEF, _params(False), device="cpu")
    pt = ShardedEmbeddingTrainer(model, port_zoo.loss, port_zoo.optimizer(),
                                 embedding_optimizer=port_zoo.embedding_optimizer(),
                                 sparse_apply_every=4, device="cpu")
    pt.ensure_initialized()
    table0 = model.fm_embedding.embedding.clone()
    calls, seen = [], []
    real = ske.fused_dedup_apply

    def counting(spec, kind, hyper, table, slots, ids, grads):
        calls.append(ids.shape[0])
        seen.append(table.clone())
        return real(spec, kind, hyper, table, slots, ids, grads)

    monkeypatch.setattr(ske, "fused_dedup_apply", counting)
    batches = [(f, l, np.ones((BATCH,), np.float32)) for f, l in _data(6)]
    losses = pt.train_window(pt.stage_window(batches))
    assert losses.shape == (6,) and calls[0] == 4 * BATCH * 26 and len(calls) == 2
    assert calls[1] == 2 * BATCH * 26
    assert torch.equal(seen[0], table0)  # untouched through the first chunk
    assert not torch.equal(model.fm_embedding.embedding, table0)


@pytest.mark.parametrize("with_bet", [False, True])
def test_fm_backward_matches_jax_custom_vjp(with_bet):
    vocab, dim, batch, fields = 60 * 6, 9, 12, 6
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    rng = np.random.RandomState(0)
    packed = pk.pack(spec, rng.randn(vocab, dim).astype(np.float32))
    ids = rng.randint(0, vocab, (batch, fields)).astype(np.int32)
    ids[:3, 0] = ids[3:6, 1]  # duplicate rows across examples
    valid = rng.rand(batch, fields) > 0.2
    bet = (rng.randn(batch, fields, dim) if with_bet else np.zeros((batch, fields, dim)))
    bet = bet.astype(np.float32)
    cots = (rng.randn(batch, fields, dim), rng.randn(batch), rng.randn(batch, dim - 1),
            rng.randn(batch, dim - 1))
    cots = tuple(c.astype(np.float32) for c in cots)
    _, vjp = jax.vjp(
        lambda p, b: jske.fused_lookup_fm(jspec, p, b, jnp.asarray(ids), jnp.asarray(valid),
                                          interpret=True),
        jnp.asarray(packed), jnp.asarray(bet))
    ref_table, ref_bet = vjp(tuple(jnp.asarray(c) for c in cots))
    table = torch.from_numpy(pk.as_rows(spec, packed).copy()).requires_grad_(True)
    bet_t = torch.from_numpy(bet).requires_grad_(True)
    out = ske.fused_lookup_fm(spec, table, bet_t, torch.from_numpy(ids), torch.from_numpy(valid))
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cots])
    np.testing.assert_allclose(bet_t.grad.numpy(), np.asarray(ref_bet), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(table.grad.numpy(), np.asarray(ref_table).reshape(spec.rows_shape),
                               rtol=1e-6, atol=1e-6)
    # d_table only when asked for: the capture path never builds it.
    bet_only = torch.from_numpy(bet).requires_grad_(True)
    plain_table = torch.from_numpy(pk.as_rows(spec, packed).copy())
    out = ske.fused_lookup_fm(spec, plain_table, bet_only, torch.from_numpy(ids),
                              torch.from_numpy(valid))
    (d_bet,) = torch.autograd.grad(out, [bet_only], [torch.from_numpy(c) for c in cots])
    assert torch.equal(d_bet, bet_t.grad) and plain_table.grad is None


def test_lookup_backward_matches_jax():
    vocab, dim = 100, 3
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    rng = np.random.RandomState(1)
    packed = pk.pack(spec, rng.randn(vocab, dim).astype(np.float32))
    ids = rng.randint(-4, spec.vocab_padded + 4, 50).astype(np.int32)
    ids[:8] = ids[8:16]
    cot = rng.randn(50, dim).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jske.fused_lookup(jspec, p, jnp.asarray(ids), interpret=True),
                     jnp.asarray(packed))
    (ref,) = vjp(jnp.asarray(cot))
    table = torch.from_numpy(pk.as_rows(spec, packed).copy()).requires_grad_(True)
    ske.fused_lookup(spec, table, torch.from_numpy(ids)).backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(table.grad.numpy(), np.asarray(ref).reshape(spec.rows_shape))


def test_dense_adam_matches_optax():
    rng = np.random.RandomState(2)
    shapes = {"w": (5, 3), "b": (3,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.adam(1e-3)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = optim.adam(1e-3)
    p_state = opt.init(p_params)
    for step in range(4):
        grads = {k: rng.randn(*s).astype(np.float32) * 10.0 ** (-step) for k, s in shapes.items()}
        updates, j_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, j_state)
        j_params = optax.apply_updates(j_params, updates)
        opt.apply(p_params, {k: torch.from_numpy(g) for k, g in grads.items()}, p_state)
    assert int(p_state["count"]) == 4
    for k in shapes:  # the bias corrections' pow may differ by 1 ulp
        np.testing.assert_allclose(p_params[k].numpy(), np.asarray(j_params[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(p_state["nu"][k].numpy(), np.asarray(j_state[0].nu[k]),
                                   rtol=1e-6, atol=0)
    sgd = optim.sgd(0.5)
    x = {"w": torch.ones(2)}
    sgd.apply(x, {"w": torch.full((2,), 2.0)}, sgd.init(x))
    assert torch.equal(x["w"], torch.zeros(2))


def test_synthetic_data_matches_the_zoo_reader():
    n, vocab = 300, 50
    features, labels = synthetic_ctr_arrays(n, vocab_size=vocab, seed=7)
    reader = datasets.synthetic_ctr_reader(n=n, vocab_size=vocab, seed=7)
    task = type("Task", (), {"start": 0, "end": n})()
    records = list(reader.read_records(task))
    np.testing.assert_array_equal(features["dense"], np.stack([r[0]["dense"] for r in records]))
    np.testing.assert_array_equal(features["cat"], np.stack([r[0]["cat"] for r in records]))
    np.testing.assert_array_equal(labels, np.array([r[1] for r in records]))
    assert 0.3 < labels.mean() < 0.7


def test_seeded_init_follows_flax_defaults():
    model = build_model(MODEL_DEF, dict(vocab_size=400, embedding_dim=8, hidden=64), "cpu")
    again = build_model(MODEL_DEF, dict(vocab_size=400, embedding_dim=8, hidden=64), "cpu")
    for m in (model, again):
        m.init_parameters(torch.Generator().manual_seed(5))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    spec = model.fm_embedding.spec
    table = model.fm_embedding.embedding
    real = table[: spec.vocab_size, : spec.dim]
    assert float(real.abs().max()) <= emb.INIT_SCALE and float(real.std()) > 0.02
    assert not table[:, spec.dim:].any() and not table[spec.vocab_size:].any()
    w = model.Dense_0.weight.detach()  # lecun normal: std 1/sqrt(fan_in), cut at 2 std
    std = 1.0 / np.sqrt(w.shape[1])
    assert abs(float(w.std()) / std - 1.0) < 0.1 and float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
    assert not model.Dense_0.bias.any() and not model.dense_projection.bias.any()


def test_auto_apply_every_and_capture_rules(monkeypatch):
    model = build_model(MODEL_DEF, _params(False), device="cpu")
    pt = ShardedEmbeddingTrainer(model, port_zoo.loss, optim.sgd(0.1),
                                 sparse_apply_every="auto", device="cpu")
    monkeypatch.setattr(ps_trainer, "AUTO_APPLY_TABLE_ROWS", VOCAB * 26 - 1)
    pt.ensure_initialized()
    assert pt.sparse_apply_every == ps_trainer.AUTO_APPLY_W
    assert pt._emb_tx.name == "sgd"  # no embedding_optimizer: sparse SGD
    features = {k: torch.from_numpy(v) for k, v in _data(1)[0][0].items()}
    with emb.capture() as cap:
        model(features)
        with pytest.raises(RuntimeError, match="twice"):
            model(features)
        with pytest.raises(RuntimeError, match="already open"):
            with emb.capture():
                pass
    assert emb.active_capture() is None and len(cap.records) == 1
    model(features)  # no capture: no record, no perturbation
    # A Mesh takes the sharded dispatch; several real devices driven from
    # one process still wait for the multi-card item.
    with pytest.raises(NotImplementedError, match="one card.*multi-card routing"):
        ShardedEmbeddingTrainer(model, port_zoo.loss, optim.sgd(0.1), device="cpu",
                                mesh=["cuda:0", "cuda:1"])


def test_trainer_and_zoo_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(MODEL_DEF, _params(False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_zoo.custom_model(vocab_size=10)
    model = build_model(MODEL_DEF, _params(False), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEmbeddingTrainer(model, port_zoo.loss, port_zoo.optimizer())


@pytest.mark.parametrize("split", [False, True])
def test_export_serves_in_both_loaders(tmp_path, split):
    jt, pt = _trainers("fused", split)
    for features, labels in _data(2):
        pt.train_step(features, labels)
    params = ",".join(f"{k}={str(v).lower()}" for k, v in _params(split).items())
    out = export_model(pt, str(tmp_path / "model"), model_zoo="model_zoo",
                       model_def=MODEL_DEF, model_params=params)
    features = _data(1, seed=11)[0][0]
    want = pt.eval_step(features)
    jax_served = np.asarray(jax_load_for_serving(out, model_zoo="model_zoo").predict(features))
    port_served = load_for_serving(out, device="cpu")
    assert port_served.signature["step"] == 2
    np.testing.assert_allclose(jax_served, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port_served.predict(features), want, rtol=1e-5, atol=1e-6)
    flat = pt.get_variables_numpy()
    assert flat["params/fm_embedding/embedding"].shape == (VOCAB * 26, DIM if split else 1 + DIM)
