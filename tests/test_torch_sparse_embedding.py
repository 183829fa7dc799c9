"""The port's sparse-embedding ops (elasticdl_tpu_torch/ops/sparse_embedding.py)
against the JAX package's Pallas kernels.

Runs on the CPU, where the port's wrappers take their plain PyTorch
versions and the JAX kernels run in Pallas interpret mode (the real
kernel bodies).  The CUDA kernels are held to the same plain versions
on the card by chip_smoke.py.  Contracts (docs/design.md):

- fused_lookup: bit-exact with the JAX kernel for EVERY id (negative and
  past the table included: both clamp by the same rule) and with
  pk.lookup for ids in [0, vocab_padded);
- fused_lookup_fm: acts bit-exact; first/sum_v/sum_sq within
  rtol=atol=1e-6 (reduction order: the TPU kernel's sequential field
  loop vs torch.sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import sparse_embedding as jske
from elasticdl_tpu.parallel import packed as jpk
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel import packed as pk

SUM_TOL = dict(rtol=1e-6, atol=1e-6)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _table(spec, seed=0):
    """Seeded logical table -> (packed numpy for JAX, row tensor for the port)."""
    rng = np.random.RandomState(seed)
    logical = rng.randn(spec.vocab_size, spec.dim).astype(np.float32)
    packed = jpk.pack(jpk.PackedSpec(spec.vocab_size, spec.dim), jnp.asarray(logical))
    packed = np.asarray(packed)
    rows = torch.from_numpy(pk.as_rows(spec, packed).copy())
    return packed, rows


@pytest.mark.parametrize("dim", [1, 2, 8, 9, 16, 100, 130])
def test_packed_spec_matches_jax(dim):
    for vocab in (1, 64, 100, 2600):
        ours, ref = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
        for field in ("dim_padded", "rows_per_block", "vocab_padded",
                      "num_blocks", "block_width", "packed_shape"):
            assert getattr(ours, field) == getattr(ref, field), (vocab, dim, field)
        assert ours.rows_shape[0] * ours.rows_shape[1] == int(np.prod(ref.packed_shape))


def test_pack_unpack_match_jax():
    spec = pk.PackedSpec(37, 5)
    logical = np.random.RandomState(1).randn(37, 5).astype(np.float32)
    packed = pk.pack(spec, logical)
    np.testing.assert_array_equal(
        packed, np.asarray(jpk.pack(jpk.PackedSpec(37, 5), jnp.asarray(logical)))
    )
    np.testing.assert_array_equal(pk.unpack(spec, packed), logical)
    # every stored form maps to the same rows
    rows = pk.as_rows(spec, packed)
    np.testing.assert_array_equal(pk.as_rows(spec, logical), rows)
    np.testing.assert_array_equal(pk.as_rows(spec, rows), rows)
    with pytest.raises(ValueError):
        pk.as_rows(spec, np.zeros((3, 3), np.float32))


@pytest.mark.parametrize("vocab,dim", [(64, 8), (100, 9), (100, 1), (33, 130)])
def test_fused_lookup_plain_bit_exact_with_pallas_for_all_ids(vocab, dim):
    spec = pk.PackedSpec(vocab, dim)
    packed, rows = _table(spec)
    rng = np.random.RandomState(2)
    ids = rng.randint(-3 * spec.vocab_padded, 3 * spec.vocab_padded, size=61)
    ids[:6] = [-1, -spec.rows_per_block - 1, spec.vocab_padded,
               spec.vocab_padded + spec.rows_per_block, 0, spec.vocab_padded - 1]
    ids = ids.astype(np.int32)
    ref = jske.fused_lookup(jpk.PackedSpec(vocab, dim), jnp.asarray(packed),
                            jnp.asarray(ids), interpret=True)
    got = ske.fused_lookup(spec, rows, torch.from_numpy(ids))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(
        _bits(ske.fused_lookup_plain(spec, rows, torch.from_numpy(ids))), _bits(ref)
    )


@pytest.mark.parametrize("vocab,dim", [(64, 8), (100, 9), (100, 1)])
def test_fused_lookup_plain_bit_exact_with_pk_lookup_in_range(vocab, dim):
    spec = pk.PackedSpec(vocab, dim)
    packed, rows = _table(spec, seed=3)
    ids = np.random.RandomState(4).randint(0, spec.vocab_padded, size=50).astype(np.int32)
    ref = jpk.lookup(jpk.PackedSpec(vocab, dim), jnp.asarray(packed), jnp.asarray(ids))
    got = ske.fused_lookup_plain(spec, rows, torch.from_numpy(ids))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def _fm_inputs(spec, batch, fields, with_bet, seed=5):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, spec.vocab_size, size=(batch, fields)).astype(np.int32)
    valid = rng.rand(batch, fields) > 0.2
    valid[0, :] = False  # a fully masked example
    bet = (rng.randn(batch, fields, spec.dim).astype(np.float32)
           if with_bet else np.zeros((batch, fields, spec.dim), np.float32))
    return ids, valid, bet


@pytest.mark.parametrize("with_bet", [False, True])
@pytest.mark.parametrize("vocab,dim", [(64 * 26, 9), (100, 3)])
def test_fused_lookup_fm_plain_matches_pallas(vocab, dim, with_bet):
    spec = pk.PackedSpec(vocab, dim)
    packed, rows = _table(spec, seed=6)
    ids, valid, bet = _fm_inputs(spec, batch=11, fields=26, with_bet=with_bet)
    ref = jske.fused_lookup_fm(
        jpk.PackedSpec(vocab, dim), jnp.asarray(packed), jnp.asarray(bet),
        jnp.asarray(ids), jnp.asarray(valid), interpret=True,
    )
    got = ske.fused_lookup_fm(
        spec, rows, torch.from_numpy(bet) if with_bet else None,
        torch.from_numpy(ids), torch.from_numpy(valid),
    )
    np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SUM_TOL)
    # the XLA twin of the statistics, on the same acts
    for g, r in zip(ske.fm_stats(got[0]), jske.fm_stats_xla(jnp.asarray(got[0].numpy()))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SUM_TOL)


def test_wrappers_use_plain_versions_on_cpu_and_count_no_launch():
    spec = pk.PackedSpec(50, 9)
    _, rows = _table(spec)
    ids = torch.randint(0, 50, (4, 26), dtype=torch.int32)
    valid = torch.ones((4, 26), dtype=torch.bool)
    ske.reset_launch_counts()
    out = ske.fused_lookup_fm(spec, rows, None, ids, valid)
    plain = ske.fused_lookup_fm_plain(spec, rows, None, ids, valid)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert torch.equal(ske.fused_lookup(spec, rows, ids[0]),
                       ske.fused_lookup_plain(spec, rows, ids[0]))
    assert ske.launch_counts() == {"fused_lookup": 0, "fused_lookup_fm": 0,
                                   "fused_dedup_apply": 0}


def test_wrappers_check_operands():
    spec = pk.PackedSpec(50, 9)
    _, rows = _table(spec)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    valid = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(TypeError):
        ske.fused_lookup(spec, rows, ids[0].long())
    with pytest.raises(ValueError):
        ske.fused_lookup(spec, rows[:-1], ids[0])
    with pytest.raises(ValueError):
        ske.fused_lookup(spec, rows, ids)  # 2-D ids
    with pytest.raises(TypeError):
        ske.fused_lookup(spec, rows.double(), ids[0])
    with pytest.raises(ValueError):
        ske.fused_lookup_fm(spec, rows, None, ids, valid.to(torch.uint8))
    with pytest.raises(ValueError):
        ske.fused_lookup_fm(spec, rows, torch.zeros(2, 3, 4), ids, valid)
    with pytest.raises(ValueError):
        ske.fused_lookup_fm(pk.PackedSpec(50, 1), torch.zeros(pk.PackedSpec(50, 1).rows_shape),
                            None, ids, valid)
    with pytest.raises(ValueError):
        ske.fused_lookup(spec, rows.to("meta"), ids[0].to("meta"))
