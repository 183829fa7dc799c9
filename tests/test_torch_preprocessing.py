"""The port's preprocessing layers and feature columns
(``elasticdl_tpu_torch/preprocessing``) against the JAX package's, on
the same seeded numpy inputs.

Every transform is held bit-exact: the port's on numpy arrays and on CPU
torch tensors against JAX's on numpy arrays and (device transforms) on
``jnp`` arrays.  The census schema's ``FeatureLayer`` gives the same
columns and table sizes, and the census model's host transforms give
the same features through ``dataset_fn`` as through
``preprocess_record`` (train == serve).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu import preprocessing as jpp
from elasticdl_tpu.data.dataset import Dataset as JaxDataset
from elasticdl_tpu_torch import preprocessing as pp
from elasticdl_tpu_torch.data.dataset import Dataset, _stack
from elasticdl_tpu_torch.data.synthetic import synthetic_census_records
from elasticdl_tpu_torch.zoo import census_feature_columns as port_fc
from elasticdl_tpu_torch.zoo import census_wide_deep as port_census
from model_zoo.census import census_feature_columns as jax_fc
from model_zoo.census import census_wide_deep as jax_census


def _same(got, want):
    """Bit-exact: values, dtype width and shape."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype.itemsize == want.dtype.itemsize and got.dtype.kind == want.dtype.kind, (
        got.dtype, want.dtype)
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8), want.reshape(-1).view(np.uint8))


def _tokens(rng, n):
    words = np.array([f"tok-{i}" for i in range(40)] + ["", "ünï", "a\x00b", "0", "-1"])
    return words[rng.integers(0, len(words), size=n)]


@pytest.mark.parametrize("salt", [0, 1, 2])
@pytest.mark.parametrize("bins", [1, 7, 64, 1 << 20])
def test_hashing_strings_match_jax(salt, bins):
    rng = np.random.default_rng(salt * 31 + bins)
    tokens = _tokens(rng, 60).reshape(6, 10)
    want = jpp.Hashing(bins, salt=salt)(tokens)
    _same(pp.Hashing(bins, salt=salt)(tokens), want)
    _same(pp.Hashing(bins, salt=salt)(tokens.astype(object)), want)
    assert np.all((want >= 0) & (want < bins))


@pytest.mark.parametrize("salt", [0, 1, 2])
@pytest.mark.parametrize("bins", [1, 10, 64, 1000003])
def test_hashing_ints_match_jax(salt, bins):
    rng = np.random.default_rng(100 + salt)
    ids32 = rng.integers(-2**31, 2**31, size=(8, 16), dtype=np.int64).astype(np.int32)
    ids32[0, :6] = [0, -1, 1, 2**31 - 1, -2**31, 7]
    jax_h = jpp.Hashing(bins, salt=salt)
    port_h = pp.Hashing(bins, salt=salt)
    want = jax_h(ids32)
    _same(want, jax_h(jnp.asarray(ids32)))  # the JAX package agrees with itself
    _same(port_h(ids32), want)
    _same(port_h(torch.from_numpy(ids32)), want)
    # int64 ids past int32 (2**31 and above, past 2**32, negative) wrap to
    # their uint32 value, as numpy's astype(uint32) does.
    ids64 = np.concatenate([
        rng.integers(2**31, 2**32, size=64, dtype=np.int64),
        rng.integers(2**32, 2**40, size=16, dtype=np.int64),
        rng.integers(-2**40, 0, size=16, dtype=np.int64),
        np.array([2**31, 2**32 - 1, 2**32, -2**31 - 1], np.int64),
    ])
    want64 = jax_h(ids64)
    _same(port_h(ids64), want64)
    _same(port_h(torch.from_numpy(ids64)), want64)
    _same(port_h(ids64.astype(np.uint32)), jax_h(ids64.astype(np.uint32)))


def test_hashing_rejects_bad_bins():
    with pytest.raises(ValueError):
        pp.Hashing(0)


@pytest.mark.parametrize("oov", [0, 1, 3])
def test_index_lookup_matches_jax(oov):
    vocab = [f"w{i}" for i in range(11)]
    port, ref = pp.IndexLookup(vocab, oov), jpp.IndexLookup(vocab, oov)
    assert port.vocab_size == ref.vocab_size == len(vocab) + oov
    known = np.array(vocab[::-1] * 2).reshape(2, 11)
    _same(port(known), ref(known))
    _same(port(known), np.asarray([[oov + 10 - i for i in range(11)]] * 2, np.int32))
    unknown = np.array(["x", "", "w11", "W0", "tok-3", "zz"])
    if oov == 0:
        with pytest.raises(KeyError):
            port(unknown)
        with pytest.raises(KeyError):
            ref(unknown)
        return
    got = port(unknown)
    _same(got, ref(unknown))
    assert np.all(got < oov)
    if oov == 1:
        assert np.all(got == 0)


def test_discretization_at_every_boundary():
    bounds = [18, 25, 30, 35, 40, 45, 50, 55, 60, 65]
    port, ref = pp.Discretization(bounds), jpp.Discretization(bounds)
    b32 = np.asarray(bounds, np.float32)
    x = np.concatenate([b32, np.nextafter(b32, -np.inf), np.nextafter(b32, np.inf),
                        np.float32([-1e30, 0.0, 17.5, 90.0, 1e30]),
                        np.random.default_rng(5).uniform(10, 80, size=64).astype(np.float32)])
    want = ref(x)
    _same(want, ref(jnp.asarray(x)))
    _same(port(x), want)
    _same(port(torch.from_numpy(x)), want)
    _same(port(torch.from_numpy(x.reshape(9, -1))), want.reshape(9, -1))
    # A value equal to a boundary goes to the upper bin.
    np.testing.assert_array_equal(port(b32), np.arange(1, len(bounds) + 1))
    # f64 inputs are compared over f32 boundaries, as in JAX.
    x64 = np.array([24.999999999, 25.0000001, 40.0], np.float64)
    _same(port(x64), ref(x64))
    _same(port(torch.from_numpy(x64)), ref(x64))
    with pytest.raises(ValueError):
        pp.Discretization([2, 1])


def test_normalizer_matches_jax():
    x = np.random.default_rng(6).normal(3000, 8000, size=257).astype(np.float32)
    for mean, std in ((3000.0, 8000.0), (40.0, 15.0), (0.1, 3.0), (5.0, 0.0)):
        port, ref = pp.Normalizer.from_stats(mean, std), jpp.Normalizer.from_stats(mean, std)
        want = ref(x)
        _same(want, ref(jnp.asarray(x)))
        _same(port(x), want)
        _same(port(torch.from_numpy(x)), want)
        _same(port(x.astype(np.float64)), ref(x.astype(np.float64)))
    with pytest.raises(ValueError):
        pp.Normalizer(divide=0.0)


def test_round_identity_half_to_even_and_clip():
    port, ref = pp.RoundIdentity(100), jpp.RoundIdentity(100)
    halves = np.arange(-3, 103, dtype=np.float32) + np.float32(0.5)
    x = np.concatenate([halves, np.float32([-1e9, -0.5, -0.49, 0.49, 99.4, 99.5, 1e9, 42.0])])
    want = ref(x)
    _same(want, ref(jnp.asarray(x)))
    _same(port(x), want)
    _same(port(torch.from_numpy(x)), want)
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2; clipped into [0, 99]
    np.testing.assert_array_equal(port(np.float32([0.5, 1.5, 2.5, 98.5, 120.0, -7.0])),
                                  [0, 2, 2, 98, 99, 0])


def test_concatenate_with_offset_keeps_pads():
    sizes = [17, 9, 64, 11, 100]
    port, ref = pp.ConcatenateWithOffset(sizes), jpp.ConcatenateWithOffset(sizes)
    assert port.total_id_space == ref.total_id_space == 201
    rng = np.random.default_rng(7)
    cols = [rng.integers(-1, s, size=12).astype(np.int32) for s in sizes]
    cols[2] = rng.integers(-1, 64, size=(12, 3)).astype(np.int32)  # a multi-hot column
    cols[0][:3] = -1
    want = ref(cols)
    _same(want, ref([jnp.asarray(c) for c in cols]))
    _same(port(cols), want)
    _same(port([torch.from_numpy(c) for c in cols]), want)
    assert want.shape == (12, 7) and np.all(want[:3, 0] == -1)
    with pytest.raises(ValueError):
        port(cols[:2])


def test_to_padded_ids_matches_jax():
    rows = [[], [3], [1, 2, 3, 4, 5, 6], [7, 8], [2**31 - 1, 0, 9]]
    for max_len, pad in ((4, -1), (1, -1), (6, -7)):
        _same(pp.to_padded_ids(rows, max_len, pad_id=pad),
              jpp.to_padded_ids(rows, max_len, pad_id=pad))
    _same(pp.to_padded_ids(rows, 3, dtype=np.int64), jpp.to_padded_ids(rows, 3, dtype=np.int64))


def _raw_batch(n, seed):
    records = synthetic_census_records(n, seed)
    return {k: np.asarray([r[k] for r, _ in records]) for k in records[0][0]}


def test_census_feature_layer_matches_jax():
    assert port_fc.FEATURES.embedding_specs() == jax_fc.FEATURES.embedding_specs() == {
        "default": (229, 8)}
    for seed in (0, 1):
        raw = _raw_batch(300, seed)
        raw["education"][:3] = ["unknown", "", "Masters"]  # out of vocabulary: the OOV id
        want = jax_fc.FEATURES(raw)
        got = port_fc.FEATURES(raw)
        assert sorted(got) == sorted(want) == ["cat", "dense"]
        for key in want:
            _same(got[key], want[key])
    # The crossed column joins the str-cast columns with "\x01", salt 2.
    raw = {"education": np.array(["Masters", "9th"]), "occupation": np.array([3, "x"], object)}
    _same(port_fc.EDU_X_OCC.ids(raw), jax_fc.EDU_X_OCC.ids(raw))


def test_census_train_serve_consistency():
    """The host transforms dataset_fn applies are the ones a serving
    caller applies to a raw record, and both equal the JAX package's."""
    records = synthetic_census_records(64, 3)
    served = [port_census.preprocess_record(dict(raw)) for raw, _ in records]
    jax_served = [jax_census.preprocess_record(dict(raw)) for raw, _ in records]
    trained = list(port_census.dataset_fn(Dataset.from_iterable(records), "evaluation", None))
    jax_trained = list(jax_census.dataset_fn(JaxDataset.from_generator(lambda: iter(records)),
                                             "evaluation", None))
    for one, mine, jax_one, (features, label), (jax_features, jax_label) in zip(
            records, served, jax_served, trained, jax_trained):
        assert label == jax_label == one[1]
        for key in jax_one:
            _same(mine[key], jax_one[key])
            _same(features[key], mine[key])
            _same(jax_features[key], jax_one[key])
        assert 0 <= mine["occ_id"] < 64 and mine["edu_id"] >= 0
    # The feature-column model: dataset_fn's rows are FEATURES' rows.
    rows = list(port_fc.dataset_fn(Dataset.from_iterable(records), "evaluation", None))
    batch = _stack([f for f, _ in rows])
    raw = {k: np.asarray([r[k] for r, _ in records]) for k in records[0][0]}
    for key, value in port_fc.FEATURES(raw).items():
        _same(batch[key], value)
    # The training order is the JAX package's seeded shuffle.
    shuffled = [label for _, label in port_census.dataset_fn(
        Dataset.from_iterable(records), "training", None)]
    jax_shuffled = [label for _, label in jax_census.dataset_fn(
        JaxDataset.from_generator(lambda: iter(records)), "training", None)]
    assert shuffled == jax_shuffled
