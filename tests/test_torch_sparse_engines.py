"""The port's stream and scatter engines and ``apply_acc``
(``parallel/sparse_optim.py``) against the JAX package's same mode, for
sgd, momentum (plain and Nesterov), adagrad and adam (per-row and
global bias correction), and ``mode`` selection against JAX's
``select_mode``.

Runs on the CPU: both sides are plain array code (JAX computes these
engines outside Pallas).  The same seeded numpy batches (duplicates,
padding ids, ids past the table, a row whose grads cancel) go through
three applies.  Tolerances are those ``tests/test_torch_sparse_optim.py``
states for K3 against the JAX scatter path: tables and slots rtol 1e-6 /
atol 5e-7 (XLA may fuse a multiply feeding an add into an FMA, and three
applies compound it; near zero the atol covers a 1-ulp error of a
unit-scale operand), sgd in scatter mode rtol 1e-6 / atol 1e-6, and the
step counts exact.  ``apply_acc`` on ``grad_accumulate``'s table
against ``apply`` of the same batch in stream mode: bit-exact, the one
engine on the same sums (sgd, whose ``apply`` adds once per occurrence,
at sgd's scatter tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.parallel import packed as jpk
from elasticdl_tpu.parallel import sparse_optim as jso
from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel import ps_trainer
from elasticdl_tpu_torch.parallel import sparse_optim as pso
from test_torch_sparse_optim import (
    APPLY_TOL,
    KINDS,
    SGD_SCATTER_TOL,
    SHAPES,
    _assert_state,
    _batch,
    _jax_optimizer,
    _table0,
)

ENGINES = ("stream", "scatter")


def _port(name, mode):
    base, hyper = KINDS[name]
    hyper = dict(hyper)
    if name == "adam_global":
        hyper["bias_correction"] = "global"
    if base == "momentum":
        hyper["mu"] = hyper.pop("momentum")
    return pso.by_name(base, mode=mode, **hyper)


def _start(spec, jspec, jopt, popt):
    packed0 = _table0(spec)
    j_table = jnp.asarray(packed0)
    p_table = torch.from_numpy(pk.as_rows(spec, packed0).copy())
    return j_table, jopt.init_slots(jspec, j_table), p_table, popt.init_slots(spec, p_table)


@pytest.mark.parametrize("vocab,dim", SHAPES)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", list(KINDS))
def test_engine_matches_jax_same_mode(name, engine, vocab, dim):
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    jopt, popt = _jax_optimizer(name, engine), _port(name, engine)
    j_table, j_slots, p_table, p_slots = _start(spec, jspec, jopt, popt)
    for step in range(3):
        ids, grads = _batch(spec, step)
        assert pso.select_mode(spec, len(ids), engine) == jso.select_mode(jspec, len(ids), engine)
        j_table, j_slots = jopt.apply(jspec, j_table, j_slots, jnp.asarray(ids),
                                      jnp.asarray(grads))
        out = popt.apply(spec, p_table, p_slots, torch.from_numpy(ids), torch.from_numpy(grads))
        assert out[0] is p_table  # in place
    tol = SGD_SCATTER_TOL if name == "sgd" and engine == "scatter" else APPLY_TOL
    _assert_state(spec, j_table, j_slots, p_table, p_slots, tol, f"{name} {engine}")
    if name != "sgd":  # sgd adds once per occurrence, in both engines
        # The row whose grads cancel is untouched (no moment decay either).
        np.testing.assert_array_equal(p_table[7].numpy(), pk.as_rows(spec, _table0(spec))[7])


@pytest.mark.parametrize("vocab,dim", SHAPES)
@pytest.mark.parametrize("name", list(KINDS))
def test_apply_acc_matches_jax_and_apply(name, vocab, dim):
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    jopt, popt = _jax_optimizer(name, "stream"), _port(name, "stream")
    j_table, j_slots, p_table, p_slots = _start(spec, jspec, jopt, popt)
    _, _, q_table, q_slots = _start(spec, jspec, jopt, popt)
    for step in range(3):
        ids, grads = _batch(spec, step)
        j_acc = jpk.grad_accumulate(jspec, j_table, jnp.asarray(ids), jnp.asarray(grads))
        j_table, j_slots = jopt.apply_acc(jspec, j_table, j_slots, j_acc)
        acc = pk.grad_accumulate(spec, p_table, torch.from_numpy(ids), torch.from_numpy(grads))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc).reshape(spec.rows_shape))
        popt.apply_acc(spec, p_table, p_slots, acc)
        popt.apply(spec, q_table, q_slots, torch.from_numpy(ids), torch.from_numpy(grads))
    _assert_state(spec, j_table, j_slots, p_table, p_slots, APPLY_TOL, f"{name} apply_acc")
    if name == "sgd":
        # apply scatters -lr*g once per occurrence; apply_acc subtracts lr*sum.
        np.testing.assert_allclose(p_table.numpy(), q_table.numpy(), **SGD_SCATTER_TOL)
        return
    assert torch.equal(p_table, q_table)
    for key in p_slots:
        assert torch.equal(p_slots[key], q_slots[key]), key


@pytest.mark.parametrize("vocab,dim,n_ids", [
    (100, 1, 40), (300, 9, 1), (40_000, 4, 1), (40_000, 4, 2), (2_000_000, 8, 100),
    (2_000_000, 8, 500),
])
def test_mode_selection_matches_jax(vocab, dim, n_ids):
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    assert pso._SCATTER_CROSSOVER == jso._SCATTER_CROSSOVER
    for mode in ("auto", "stream", "scatter", "fused"):
        assert pso.select_mode(spec, n_ids, mode) == jso.select_mode(jspec, n_ids, mode), mode
    with pytest.raises(ValueError):
        pso.select_mode(spec, n_ids, "bogus")


def test_sparse_kernel_flag_selects_the_engine():
    assert ps_trainer.resolve_sparse_kernel("xla") == "xla"
    for value in (None, "auto", "fused"):
        assert ps_trainer.resolve_sparse_kernel(value) == "fused"  # auto -> K3 on the card
    with pytest.raises(ValueError):
        ps_trainer.resolve_sparse_kernel("pallas")
    spec = pk.PackedSpec(50, 3)
    table = torch.zeros(spec.rows_shape)
    opt = pso.adagrad(0.1)
    with pytest.raises(ValueError, match="acc shape"):
        opt.apply_acc(spec, table, opt.init_slots(spec, table), torch.zeros(3, 4))
