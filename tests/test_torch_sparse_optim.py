"""The port's sparse optimizer update (``ops/sparse_embedding.
fused_dedup_apply``, ``parallel/sparse_optim.py``, the row-form scatter
side of ``parallel/packed.py``) against the JAX package.

Runs on the CPU, where the port takes its plain version (the JAX scatter
path, step for step) and the JAX kernel runs in Pallas interpret mode.
The CUDA kernel is held to the same plain version on the card by
``chip_smoke.py``.

Tolerances:

- the dedup prologue, ``grad_accumulate`` and ``scatter_add`` are
  BIT-EXACT: both sides add the grads in position order onto zeros;
- tables and slots after 3 applies: rtol 1e-6, atol 5e-7.  XLA may fuse
  any multiply feeding an add into an FMA on the JAX side (the JAX
  docstring's <= 1 ulp per apply, rtol 3e-7), three applies compound it,
  and near zero a 1-ulp error of a unit-scale operand is many ulps of the
  result, which the atol covers;
- JAX sgd in scatter mode adds ``-lr * g`` once per occurrence instead of
  once per row, so duplicates round differently: rtol 1e-6, atol 1e-6;
- the per-row step count ``t`` is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import sparse_embedding as jske
from elasticdl_tpu.parallel import packed as jpk
from elasticdl_tpu.parallel import sparse_optim as jso
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel import sparse_optim as pso

APPLY_TOL = dict(rtol=1e-6, atol=5e-7)
SGD_SCATTER_TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = [(100, 1), (150, 3), (300, 9)]  # rows_per_block > 1; dim_padded > dim for 3, 9

KINDS = {
    "sgd": ("sgd", {"learning_rate": 0.1}),
    "momentum": ("momentum", {"learning_rate": 0.1, "momentum": 0.9, "nesterov": False}),
    "nesterov": ("momentum", {"learning_rate": 0.1, "momentum": 0.9, "nesterov": True}),
    "adagrad": ("adagrad", {"learning_rate": 0.1, "epsilon": 1e-7}),
    "adam": ("adam", {"learning_rate": 0.01, "beta_1": 0.9, "beta_2": 0.999,
                      "epsilon": 1e-8}),
    "adam_global": ("adam", {"learning_rate": 0.01, "beta_1": 0.9, "beta_2": 0.999,
                             "epsilon": 1e-8}),
}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _batch(spec, step, n=40):
    """ids with duplicates, -1 padding, ids >= vocab_padded, and one row
    whose two grads cancel exactly."""
    rng = np.random.RandomState(100 + step)
    ids = rng.randint(0, spec.vocab_padded, n).astype(np.int32)
    ids[:6] = ids[6:12]                                   # duplicates
    ids[12:14] = [-1, -3]                                 # padding
    ids[14:16] = [spec.vocab_padded, spec.vocab_padded + 7]  # past the table
    grads = rng.randn(n, spec.dim).astype(np.float32)
    ids[ids == 7] = -1
    ids[20] = ids[21] = 7
    grads[21] = -grads[20]                                # row 7 sums to zero
    return ids, grads


def _table0(spec):
    rng = np.random.RandomState(0)
    return pk.pack(spec, rng.randn(spec.vocab_size, spec.dim).astype(np.float32))


def _port_slots(kind, spec, table):
    if kind == "adam_global":
        return pso.adam(bias_correction="global").init_slots(spec, table)
    return {name: torch.zeros_like(table) for name in ske.KIND_SLOTS[kind]}


def _jax_slots(kind, packed):
    if kind == "adam_global":
        return {"m": jnp.zeros_like(packed), "v": jnp.zeros_like(packed),
                "t_global": jnp.zeros((), jnp.float32)}
    return {name: jnp.zeros_like(packed) for name in jske._KIND_SLOTS[kind]}


def _assert_state(spec, j_table, j_slots, p_table, p_slots, tol, what):
    np.testing.assert_allclose(
        p_table.numpy(), np.asarray(j_table).reshape(spec.rows_shape), err_msg=f"{what} table",
        **tol)
    assert sorted(p_slots) == sorted(j_slots)
    for name, value in p_slots.items():
        ref = np.asarray(j_slots[name]).reshape(value.shape)
        if name in ("t", "t_global"):
            np.testing.assert_array_equal(value.numpy(), ref, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(value.numpy(), ref, err_msg=f"{what} {name}", **tol)
    # pad lanes of every operand stay zero (ids in [vocab, vocab_padded)
    # address real rows of the table, for JAX as well)
    for arr in [p_table] + [v for v in p_slots.values() if v.dim() == 2]:
        assert not arr[:, spec.dim:].any()


@pytest.mark.parametrize("vocab,dim", SHAPES)
@pytest.mark.parametrize("name", list(KINDS))
def test_fused_dedup_apply_matches_pallas_kernel(name, vocab, dim):
    base, hyper = KINDS[name]
    kind = "adam_global" if name == "adam_global" else base
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    packed0 = _table0(spec)
    j_table, j_slots = jnp.asarray(packed0), _jax_slots(kind, jnp.asarray(packed0))
    p_table = torch.from_numpy(pk.as_rows(spec, packed0).copy())
    p_slots = _port_slots(kind, spec, p_table)
    for step in range(3):
        ids, grads = _batch(spec, step)
        j_table, j_slots = jske.fused_dedup_apply(
            jspec, base, hyper, j_table, j_slots, jnp.asarray(ids), jnp.asarray(grads),
            interpret=True)
        out = ske.fused_dedup_apply(spec, base, hyper, p_table, p_slots,
                                    torch.from_numpy(ids), torch.from_numpy(grads))
        assert out[0] is p_table  # in place
    _assert_state(spec, j_table, j_slots, p_table, p_slots, APPLY_TOL, name)
    np.testing.assert_array_equal(p_table[7].numpy(), pk.as_rows(spec, packed0)[7])
    if kind == "adam":
        t = p_slots["t"]
        assert torch.equal(t[:, : spec.dim], t[:, :1].expand(-1, spec.dim))
        assert float(t[7].abs().sum()) == 0.0  # the cancelled row never counted


def _jax_optimizer(name, mode):
    base, hyper = KINDS[name]
    if base == "sgd":
        return jso.sgd(hyper["learning_rate"], mode=mode)
    if base == "momentum":
        return jso.momentum(hyper["learning_rate"], hyper["momentum"], hyper["nesterov"],
                            mode=mode)
    if base == "adagrad":
        return jso.adagrad(hyper["learning_rate"], hyper["epsilon"], mode=mode)
    return jso.adam(hyper["learning_rate"], hyper["beta_1"], hyper["beta_2"],
                    hyper["epsilon"], mode=mode,
                    bias_correction="global" if name == "adam_global" else "per_row")


def _port_optimizer(name):
    base, hyper = KINDS[name]
    if base == "sgd":
        return pso.by_name("sgd", learning_rate=hyper["learning_rate"], mode="fused")
    if base == "momentum":
        return pso.momentum(hyper["learning_rate"], hyper["momentum"], hyper["nesterov"],
                            mode="fused")
    if base == "adagrad":
        return pso.adagrad(hyper["learning_rate"], hyper["epsilon"], mode="fused")
    return pso.adam(hyper["learning_rate"], hyper["beta_1"], hyper["beta_2"],
                    hyper["epsilon"], mode="fused",
                    bias_correction="global" if name == "adam_global" else "per_row")


@pytest.mark.parametrize("vocab,dim", SHAPES)
@pytest.mark.parametrize("name", list(KINDS))
def test_sparse_optim_matches_jax_scatter_path(name, vocab, dim):
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    packed0 = _table0(spec)
    jopt, popt = _jax_optimizer(name, "scatter"), _port_optimizer(name)
    j_table = jnp.asarray(packed0)
    j_slots = jopt.init_slots(jspec, j_table)
    p_table = torch.from_numpy(pk.as_rows(spec, packed0).copy())
    p_slots = popt.init_slots(spec, p_table)
    for step in range(3):
        ids, grads = _batch(spec, step)
        j_table, j_slots = jopt.apply(jspec, j_table, j_slots, jnp.asarray(ids),
                                      jnp.asarray(grads))
        popt.apply(spec, p_table, p_slots, torch.from_numpy(ids), torch.from_numpy(grads))
    tol = SGD_SCATTER_TOL if name == "sgd" else APPLY_TOL
    _assert_state(spec, j_table, j_slots, p_table, p_slots, tol, name)


@pytest.mark.parametrize("vocab,dim", SHAPES)
def test_dedup_and_segment_sums_bit_exact_with_jax(vocab, dim):
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    rng = np.random.RandomState(1)
    ids = rng.randint(-5, spec.vocab_padded + 5, 400).astype(np.int32)
    ids[:60] = ids[60:120]
    grads = rng.randn(400, dim).astype(np.float32)
    ids[ids == 7] = 8
    ids[20] = ids[21] = 7
    grads[21] = -grads[20]
    ref = jpk.dedup_representatives(jspec, jnp.asarray(ids), jnp.asarray(grads))
    got = pk.dedup_representatives(spec, torch.from_numpy(ids), torch.from_numpy(grads))
    for name, r, g in zip(("safe", "gsum", "touched"), ref, got):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(r), err_msg=name)
    assert not got[2][20] and not got[2][21]  # the cancelled row is untouched
    acc_ref = jpk.grad_accumulate(jspec, jnp.zeros(jspec.packed_shape), jnp.asarray(ids),
                                  jnp.asarray(grads))
    acc = pk.grad_accumulate(spec, torch.zeros(spec.rows_shape), torch.from_numpy(ids),
                             torch.from_numpy(grads))
    np.testing.assert_array_equal(_bits(acc.numpy()),
                                  _bits(np.asarray(acc_ref).reshape(spec.rows_shape)))
    table = _table0(spec)
    added = jpk.scatter_add(jspec, jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads))
    ours = pk.scatter_add(spec, torch.from_numpy(pk.as_rows(spec, table).copy()),
                          torch.from_numpy(ids), torch.from_numpy(grads))
    np.testing.assert_array_equal(_bits(ours.numpy()),
                                  _bits(np.asarray(added).reshape(spec.rows_shape)))
    mask = pk.real_lane_mask(spec).numpy()
    np.testing.assert_array_equal(
        np.tile(mask, spec.rows_per_block), np.asarray(jpk.real_lane_mask(jspec)))


def test_apply_constants_round_like_jax():
    c = ske.apply_constants("adam", KINDS["adam"][1])
    assert c["omb1"] == float(np.float32(1 - 0.9)) and c["omb2"] == float(np.float32(1 - 0.999))
    assert c["lr_neg"] == float(np.float32(-0.01))
    assert ske.apply_constants("momentum", KINDS["nesterov"][1])["nesterov"] is True


def test_sparse_optimizers_surface():
    spec = pk.PackedSpec(50, 3)
    table = torch.zeros(spec.rows_shape)
    assert sorted(pso.adam().init_slots(spec, table)) == ["m", "t", "v"]
    glob = pso.adam(bias_correction="global").init_slots(spec, table)
    assert sorted(glob) == ["m", "t_global", "v"] and glob["t_global"].shape == ()
    assert pso.by_name("momentum", learning_rate=0.1).kind == "momentum"
    for mode in ("auto", "stream", "scatter", "fused"):
        assert pso.adagrad(mode=mode).hyperparams["learning_rate"] == 0.01
    with pytest.raises(ValueError):
        pso.sgd(mode="bogus")
    with pytest.raises(ValueError):
        pso.by_name("rmsprop")
    with pytest.raises(ValueError):
        pso.adam(bias_correction="sometimes")


def test_fused_dedup_apply_checks_operands_and_never_launches_on_cpu():
    spec = pk.PackedSpec(50, 3)
    table = torch.zeros(spec.rows_shape)
    slots = pso.adam().init_slots(spec, table)
    ids = torch.tensor([1, 2, 2], dtype=torch.int32)
    grads = torch.ones((3, 3))
    ske.reset_launch_counts()
    ske.fused_dedup_apply(spec, "adam", KINDS["adam"][1], table, slots, ids, grads)
    assert ske.launch_counts()["fused_dedup_apply"] == 0
    assert float(slots["t"][2, 0]) == 1.0 and float(slots["t"][2, 3]) == 0.0
    hyper = KINDS["adam"][1]
    with pytest.raises(TypeError):
        ske.fused_dedup_apply(spec, "adam", hyper, table, slots, ids.long(), grads)
    with pytest.raises(ValueError):
        ske.fused_dedup_apply(spec, "adam", hyper, table, slots, ids, grads[:, :2])
    with pytest.raises(KeyError):
        ske.fused_dedup_apply(spec, "momentum", {"learning_rate": 0.1, "momentum": 0.9,
                                                 "nesterov": False}, table, {}, ids, grads)
    with pytest.raises(ValueError):
        ske.fused_dedup_apply(spec, "rmsprop", hyper, table, slots, ids, grads)
    meta = {k: v.to("meta") for k, v in slots.items()}
    with pytest.raises(ValueError, match="no kernel"):
        ske.fused_dedup_apply(spec, "adam", hyper, table.to("meta"), meta,
                              ids.to("meta"), grads.to("meta"))
