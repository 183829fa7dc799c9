"""The port's host optimizer kernels (``elasticdl_tpu_torch/native/
kernel_api.cc``, ``NativeKernels``) against the JAX package's library of
the same source, bit for bit, and against optax and the port's sparse
optimizers where ``tests/test_native_kernels.py`` compares JAX's with
optax and JAX's sparse path (its tolerances: optax's Adam rtol/atol 2e-5
for the reassociation of a sequential C++ loop, the sparse path rtol
1e-4 / atol 1e-6, the step counts exact).

Each case runs 3 steps from the same seeded numpy arrays through both
libraries: tables, slots and step counts equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elasticdl_tpu import native as jax_native
from elasticdl_tpu_torch import native
from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel import sparse_optim

if native.load_kernels() is None or jax_native.load() is None:
    pytest.skip("no C++ toolchain available", allow_module_level=True)

VOCAB, DIM, N = 16, 4, 32
IDS = np.array([3, 7, 3, 0, 7], np.int64)


@pytest.fixture(scope="module")
def both():
    return native.NativeKernels(), jax_native.NativeKernels()


def _rng(seed):
    return np.random.RandomState(seed)


#: name -> (call on (kernels, state, grad, step), state names)
DENSE = {
    "sgd": (lambda k, s, g, t: k.sgd(s["param"], g, 0.1), ()),
    "momentum": (lambda k, s, g, t: k.momentum(s["param"], s["velocity"], g, 0.1, 0.9),
                 ("velocity",)),
    "nesterov": (lambda k, s, g, t: k.momentum(s["param"], s["velocity"], g, 0.1, 0.9,
                                               nesterov=True), ("velocity",)),
    "adagrad": (lambda k, s, g, t: k.adagrad(s["param"], s["accum"], g, 0.1), ("accum",)),
    "adam": (lambda k, s, g, t: k.adam(s["param"], s["m"], s["v"], g, 0.01, 0.9, 0.999,
                                       1e-8, t), ("m", "v")),
}


@pytest.mark.parametrize("name", list(DENSE))
def test_dense_kernels_equal_jax_bit_for_bit(both, name):
    call, slots = DENSE[name]
    rng = _rng(1)
    start = {"param": rng.rand(N).astype(np.float32)}
    start.update({s: np.zeros(N, np.float32) for s in slots})
    states = [{k: v.copy() for k, v in start.items()} for _ in both]
    for step in range(1, 4):
        grad = rng.rand(N).astype(np.float32) - 0.5
        for kernels, state in zip(both, states):
            call(kernels, state, grad, step)
    for key in start:
        assert np.array_equal(states[0][key], states[1][key]), key
    assert not np.array_equal(states[0]["param"], start["param"])


#: name -> (call on (kernels, table, state, ids, grads), state names)
SPARSE = {
    "sgd": (lambda k, t, s, i, g: k.sgd_sparse(t, i, g, 0.1), ()),
    "momentum": (lambda k, t, s, i, g: k.momentum_sparse(t, s["velocity"], i, g, 0.1, 0.9),
                 ("velocity",)),
    "nesterov": (lambda k, t, s, i, g: k.momentum_sparse(t, s["velocity"], i, g, 0.1, 0.9,
                                                         nesterov=True), ("velocity",)),
    "adagrad": (lambda k, t, s, i, g: k.adagrad_sparse(t, s["accum"], i, g, 0.1), ("accum",)),
    "adam": (lambda k, t, s, i, g: k.adam_sparse(t, s["m"], s["v"], s["t_rows"], i, g, 0.01),
             ("m", "v", "t_rows")),
}


@pytest.mark.parametrize("name", list(SPARSE))
def test_sparse_kernels_equal_jax_bit_for_bit(both, name):
    call, slots = SPARSE[name]
    rng = _rng(2)
    table0 = rng.rand(VOCAB, DIM).astype(np.float32)
    tables = [table0.copy() for _ in both]
    states = [{s: (np.zeros(VOCAB, np.int64) if s == "t_rows" else np.zeros_like(table0))
               for s in slots} for _ in both]
    for _ in range(3):
        grads = rng.rand(len(IDS), DIM).astype(np.float32)
        grads[1] = 0.0  # a zero-gradient occurrence
        for kernels, table, state in zip(both, tables, states):
            call(kernels, table, state, IDS, grads)
    assert np.array_equal(tables[0], tables[1])
    for key in slots:
        assert np.array_equal(states[0][key], states[1][key]), key


def test_dense_sgd_and_adam_match_optax(both):
    kernels = both[0]
    rng = _rng(3)
    param = rng.rand(N).astype(np.float32)
    grad = rng.rand(N).astype(np.float32)
    tx = optax.sgd(0.1)
    want = optax.apply_updates(jnp.asarray(param),
                               tx.update(jnp.asarray(grad), tx.init(jnp.asarray(param)))[0])
    got = param.copy()
    kernels.sgd(got, grad, 0.1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)

    tx = optax.adam(0.01, b1=0.9, b2=0.999, eps=1e-8)
    jp = jnp.asarray(param)
    opt_state = tx.init(jp)
    got, m, v = param.copy(), np.zeros_like(param), np.zeros_like(param)
    for step in range(1, 4):
        g = rng.rand(N).astype(np.float32)
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        kernels.adam(got, m, v, g, 0.01, 0.9, 0.999, 1e-8, step)
    np.testing.assert_allclose(got, np.asarray(jp), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adagrad", "adam"])
def test_sparse_kernels_match_the_ports_sparse_optimizers(both, name):
    """The host kernels against the port's scatter engine over three
    applies with duplicate ids (JAX's test holds its own sparse path)."""
    kernels = both[0]
    spec = pk.PackedSpec(VOCAB, DIM)
    rng = _rng(4)
    table0 = rng.rand(VOCAB, DIM).astype(np.float32)
    opt = {"sgd": sparse_optim.sgd(0.1, mode="scatter"),
           "momentum": sparse_optim.momentum(0.1, mu=0.9, mode="scatter"),
           "adagrad": sparse_optim.adagrad(0.1, epsilon=1e-7, mode="scatter"),
           "adam": sparse_optim.adam(0.01, mode="scatter")}[name]
    rows = torch.zeros(spec.rows_shape)
    rows[:VOCAB, :DIM] = torch.from_numpy(table0)
    slots = opt.init_slots(spec, rows)
    table = table0.copy()
    state = {"velocity": np.zeros_like(table), "accum": np.zeros_like(table),
             "m": np.zeros_like(table), "v": np.zeros_like(table),
             "t_rows": np.zeros(VOCAB, np.int64)}
    for _ in range(3):
        grads = rng.rand(len(IDS), DIM).astype(np.float32)
        opt.apply(spec, rows, slots, torch.from_numpy(IDS.astype(np.int32)),
                  torch.from_numpy(grads))
        SPARSE[name][0](kernels, table, state, IDS, grads)
    np.testing.assert_allclose(table, rows[:VOCAB, :DIM].numpy(), rtol=1e-4, atol=1e-6)
    if name == "adam":
        np.testing.assert_array_equal(state["t_rows"], slots["t"][:VOCAB, 0].numpy())


def test_sparse_zero_grad_rows_untouched(both):
    kernels = both[0]
    table0 = _rng(5).rand(VOCAB, DIM).astype(np.float32)
    table, m, v = table0.copy(), np.zeros_like(table0), np.zeros_like(table0)
    t_rows = np.zeros((VOCAB,), np.int64)
    kernels.adam_sparse(table, m, v, t_rows, np.array([2, 5], np.int64),
                        np.zeros((2, DIM), np.float32), 0.01)
    np.testing.assert_array_equal(table, table0)
    assert t_rows.sum() == 0


def test_library_is_built_into_the_ports_build_dir():
    import os

    path = native.build_kernels()
    assert path == native.KERNELS_SO_PATH and os.path.dirname(path) == native.BUILD_DIR
    assert os.path.exists(path) and path != jax_native._SO_PATH
