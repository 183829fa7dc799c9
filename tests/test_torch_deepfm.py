"""The port's DeepFM and Embedding (elasticdl_tpu_torch) against the flax
reference, with the same numpy weights carried across by
serving/convert.state_dict_from_jax.

Both table layouts (merged 1+d, split_tables) under both JAX engines
(xla; fused = the Pallas kernels in interpret mode) must give logits
within rtol=1e-5, atol=1e-6: the hot-swap bar of the serving plane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu.layers import Embedding as JaxEmbedding
from elasticdl_tpu.layers.embedding import export_spec_map, strip_capture_collections
from elasticdl_tpu.parallel import packed as jpk
from elasticdl_tpu.worker.trainer import Trainer, _unbox_partitioned
from elasticdl_tpu_torch.layers.embedding import Embedding
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.zoo import build_model, resolve
from elasticdl_tpu_torch.zoo import deepfm as port_deepfm
from model_zoo.deepfm import deepfm_functional_api as zoo

LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB, DIM, HIDDEN, BATCH = 64, 4, 16, 9


def _features(seed=0, batch=BATCH, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, vocab, size=(batch, zoo.NUM_CAT)).astype(np.int32)
    cat[0, :3] = [-1, vocab, vocab + 5]  # padding and out-of-vocabulary ids
    return {
        "dense": rng.rand(batch, zoo.NUM_DENSE).astype(np.float32),
        "cat": cat,
    }


def _random_params(model, features, seed):
    """Seeded numpy weights in the flax param tree of `model`; tables
    are packed from random logical tables (pad cells zero)."""
    variables = dict(model.init(jax.random.PRNGKey(0), features))
    specs = export_spec_map(variables)
    params = _unbox_partitioned(strip_capture_collections(variables)["params"])
    rng = np.random.RandomState(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "params/" + "/".join(str(p.key) for p in path)
        if key in specs:
            spec = specs[key]
            logical = rng.uniform(-0.5, 0.5, (spec.vocab_size, spec.dim))
            flat[key] = np.asarray(jpk.pack(spec, jnp.asarray(logical, jnp.float32)))
        else:
            flat[key] = rng.uniform(-0.3, 0.3, leaf.shape).astype(np.float32)
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _port_model(params: dict, variables):
    model = build_model("deepfm.deepfm_functional_api", params, device="cpu")
    convert.load_state(model, convert.state_dict_from_jax(variables, model))
    return model.eval()


def _port_logits(model, features):
    with torch.inference_mode():
        return model({k: torch.from_numpy(v) for k, v in features.items()}).numpy()


@pytest.mark.parametrize("kernel", ["xla", "fused"])
@pytest.mark.parametrize("split", [False, True])
def test_deepfm_logits_match_flax(split, kernel):
    features = _features()
    model = zoo.custom_model(vocab_size=VOCAB, embedding_dim=DIM, hidden=HIDDEN,
                             split_tables=split, sparse_kernel=kernel)
    variables = _random_params(model, features, seed=1)
    ref = np.asarray(model.apply(variables, features))
    port = _port_model(
        dict(vocab_size=VOCAB, embedding_dim=DIM, hidden=HIDDEN,
             split_tables=split, sparse_kernel=kernel),
        variables,
    )
    assert port.split == split
    got = _port_logits(port, features)
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def test_deepfm_from_trainer_flat_variables():
    """get_variables_numpy()'s flat keys with LOGICAL (unpacked) tables."""
    features = _features(seed=2)
    model = zoo.custom_model(vocab_size=VOCAB, embedding_dim=DIM, hidden=HIDDEN)
    trainer = Trainer(model, zoo.loss, optax.sgd(0.1))
    labels = np.arange(BATCH, dtype=np.int32) % 2
    trainer.train_step(features, labels)
    flat = trainer.get_variables_numpy()
    assert flat["params/fm_embedding/embedding"].shape == (VOCAB * zoo.NUM_CAT, 1 + DIM)
    port = _port_model(dict(vocab_size=VOCAB, embedding_dim=DIM, hidden=HIDDEN), flat)
    np.testing.assert_allclose(
        _port_logits(port, features), np.asarray(trainer.eval_step(features)), **LOGIT_TOL
    )


def test_state_dict_from_jax_rejects_leftover_and_missing_keys():
    features = _features()
    model = zoo.custom_model(vocab_size=VOCAB, embedding_dim=DIM, hidden=HIDDEN)
    variables = _random_params(model, features, seed=3)
    port = build_model("deepfm.deepfm_functional_api",
                       dict(vocab_size=VOCAB, embedding_dim=DIM, hidden=HIDDEN), device="cpu")
    extra = {"params": {**variables["params"], "stray": {"kernel": np.zeros(3, np.float32)}}}
    with pytest.raises(KeyError, match="stray"):
        convert.state_dict_from_jax(extra, port)
    missing = {"params": {k: v for k, v in variables["params"].items() if k != "Dense_1"}}
    with pytest.raises(KeyError, match="Dense_1"):
        convert.state_dict_from_jax(missing, port)
    wrong = {"params": {**variables["params"], "Dense_2": {
        "kernel": np.zeros((3, 1), np.float32), "bias": np.zeros(1, np.float32)}}}
    with pytest.raises(ValueError, match="Dense_2"):
        convert.state_dict_from_jax(wrong, port)
    # A split-layout artifact does not load into the merged model.
    split = zoo.custom_model(vocab_size=VOCAB, embedding_dim=DIM, hidden=HIDDEN,
                             split_tables=True)
    with pytest.raises((KeyError, ValueError)):
        convert.state_dict_from_jax(_random_params(split, features, seed=3), port)


@pytest.mark.parametrize("kernel", ["xla", "fused"])
@pytest.mark.parametrize("combiner", [None, "sum", "mean"])
def test_embedding_combiners_match_flax(combiner, kernel):
    vocab, dim = 100, 5
    rng = np.random.RandomState(4)
    ids = rng.randint(0, vocab, size=(12, 7)).astype(np.int32)
    ids[0, :] = -1                          # an all-padding row
    ids[1, :4] = [-1, -7, vocab, vocab + 40]  # padding + out of vocabulary
    layer = JaxEmbedding(vocab, dim, combiner=combiner, sparse_kernel=kernel)
    variables = layer.init(jax.random.PRNGKey(1), ids)
    table = np.asarray(_unbox_partitioned(variables["params"])["embedding"])
    ref = np.asarray(layer.apply({"params": {"embedding": table}}, ids))
    port = Embedding(vocab, dim, combiner=combiner, device="cpu")
    convert.load_state(port, convert.state_dict_from_jax({"params": {"embedding": table}}, port))
    got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == ref.shape
    if combiner is None:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_fm_interaction_layer_matches_flax():
    vocab, dim = 80, 9
    ids = np.random.RandomState(5).randint(-2, vocab + 2, size=(6, 26)).astype(np.int32)
    layer = JaxEmbedding(vocab, dim, fm_interaction=True, sparse_kernel="fused")
    variables = layer.init(jax.random.PRNGKey(2), ids)
    table = np.asarray(_unbox_partitioned(variables["params"])["embedding"])
    ref = layer.apply({"params": {"embedding": table}}, ids)
    port = Embedding(vocab, dim, fm_interaction=True, device="cpu")
    convert.load_state(port, convert.state_dict_from_jax({"params": {"embedding": table}}, port))
    got = port(torch.from_numpy(ids))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("vocab", [100, 1_000_000])
def test_split_rule_matches_flax(vocab):
    for split in (None, True, False):
        for every in (1, 4):
            for kernel in (None, "xla", "fused", "auto"):
                ref = zoo.DeepFM(vocab_size=vocab, split_tables=split,
                                 sparse_apply_every=every, sparse_kernel=kernel)
                ours = port_deepfm.use_split_tables(split, every, kernel, vocab * zoo.NUM_CAT)
                assert ours == ref._split(vocab * zoo.NUM_CAT), (split, every, kernel)
    # custom_model resolves sparse_apply_every='auto' from the rows as the JAX one does
    meta = port_deepfm.custom_model(vocab_size=vocab, sparse_apply_every="auto", device="meta")
    assert meta.split == zoo.custom_model(vocab_size=vocab, sparse_apply_every="auto")._split(
        vocab * zoo.NUM_CAT)


def test_registry_resolves_only_ported_models():
    assert resolve("deepfm.deepfm_functional_api") is port_deepfm
    with pytest.raises(ValueError, match="not ported"):
        resolve("no_such.model")
    with pytest.raises(ValueError):
        port_deepfm.custom_model(sparse_kernel="pallas", device="meta")
