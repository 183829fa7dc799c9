"""The port's ring attention (elasticdl_tpu_torch/parallel/ring_attention.py)
and its step kernels K7-K9 (ops/flash_attention.py) against the JAX
package on the CPU.

On CPU tensors the step functions run their plain versions, which repeat
the Pallas ring kernels' arithmetic; the JAX side runs those kernels in
interpret mode (``interpret=True``), and its ring under ``shard_map`` on
the 8 virtual CPU devices of ``tests/conftest.py``.  Inputs are numpy
draws from a seed: B=2, H=2, D=16, shards of 16-32 rows, so every key
block is one block on both sides (the port blocks its online softmax by
64 keys, the JAX kernel by min(512, Tk)).  Tolerances:

- f32: rtol 1e-5 / atol 1e-6 on the carry and the ring output (the
  frameworks sum the products in other orders); the lse carry atol 2e-6
  (a logaddexp of values up to ~5).  Gradients sum terms of both signs
  (a step's, from stats that do not normalise its P, up to ~5), so their
  rounding is relative to the terms: rtol 1e-5 plus 1e-5 of the largest
  magnitude, the f32 tolerance ``chip_smoke.py`` holds the kernels to.
- bf16 and f16 step inputs: the same, since the carry and the step
  gradients are f32 and both round P to q's dtype relative to the same
  running max; except the carry of f16 inputs, held to the f16 rule
  below: the two sides' p, an f32 ulp apart, land on different f16
  neighbours far more often than on bf16's 8 times coarser grid
  (measured 0.7% of the elements past the f32 tolerance, the worst by
  4.8e-5).  The ring's bf16 output and gradients within 2 bf16 ulps
  (rtol 2**-7) plus 2**-10 of the largest magnitude, its f16 ones within
  ``chip_smoke.py``'s f16 rule (phase 51's): 2 f16 ulps (rtol 2**-10,
  at least two subnormal steps) plus 2**-12 of the largest magnitude.
- A fully masked step leaves the carry bit for bit.
- The wide head dims of the DP=256 builds (136, 256) at B=1, T=32 on
  16-row blocks and T=40 on 8-row blocks (the JAX kernels need whole
  blocks, and the port's plain forward blocks its online softmax as
  they do): the gradients as above; the f32 carry with the atol times
  sqrt(D / 16), as ``test_torch_flash_attention.py`` scales it (a score
  sums D products); the carry of bf16 inputs within ``chip_smoke.py``'s
  RING_CARRY_TOL, 2 bf16 ulps (rtol 2**-7) plus 2**-10 of the largest
  magnitude: scores summed over 136-256 products in two orders differ
  by enough f32 ulps that some p round to the other bf16 neighbour
  before P V (at D=136, 1.3% of the elements past the f32 tolerance,
  the worst by 7.2e-5); the carry of f16 inputs within the f16 rule
  above, for the same reason at f16's finer step.
- A head_dim that is no multiple of 8 (100) through the pad: each step
  bit-equal to the unpadded computation; the ring, which pads once
  before it, bit-equal in its output and within the gradient tolerance
  above in its gradients (its delta = sum(dO * out) then sums 104
  columns, four of them zero, in another order than 100); in f16 the
  ring's gradients within the f16 rule.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_F16_ATOL_SHARE, ATTN_F16_RTOL, F16_ULP_FLOOR
from elasticdl_tpu.parallel import MeshConfig as JaxMeshConfig
from elasticdl_tpu.parallel import build_mesh as jax_build_mesh
from elasticdl_tpu.parallel import ring_attention as jring
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel import ring_attention as ring
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh, virtual_devices

jfa = importlib.import_module("elasticdl_tpu.ops.flash_attention")

F32_TOL = dict(rtol=1e-5, atol=1e-6)
LSE_ATOL = 2e-6
BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -7, 2.0 ** -10
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-5, 1e-5
B, H, D, N = 2, 2, 16, 4
SCALE = fa.default_scale(D)

# (q shard, K/V source shard, layout, causal): an unmasked step, the
# diagonal, a fully masked step, zigzag steps, and a non-causal one.
STEPS = [
    (1, 0, "contiguous", True),
    (2, 2, "contiguous", True),
    (0, 3, "contiguous", True),
    (0, 3, "zigzag", True),
    (2, 1, "zigzag", True),
    (3, 3, "zigzag", True),
    (1, 2, "contiguous", False),
]


def _draw(shape, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _carry(t, seed):
    """A non-trivial incoming carry: a normalised acc with its lse, and
    rows that have seen nothing yet (lse NEG_INF, acc 0)."""
    acc, lse = _draw((B, H, t, D), seed, 1)[0], _draw((B, H, t, 1), seed + 1, 1)[0]
    lse[:, 0, : t // 4] = fa.NEG_INF
    acc[:, 0, : t // 4] = 0.0
    return acc, lse


def _positions(q_index, src, layout, t):
    return (ring.shard_positions(q_index, t, N, layout).astype(np.int32),
            ring.shard_positions(src, t, N, layout).astype(np.int32))


def _assert_bf16_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    limit = BF16_RTOL * np.abs(want) + BF16_ATOL_SHARE * np.abs(want).max()
    assert (np.abs(got - want) - limit).max() <= 0.0, (what, float(np.abs(got - want).max()))


def _assert_f16_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    limit = np.maximum(ATTN_F16_RTOL * np.abs(want), F16_ULP_FLOOR)
    limit = limit + ATTN_F16_ATOL_SHARE * np.abs(want).max()
    assert (np.abs(got - want) - limit).max() <= 0.0, (what, float(np.abs(got - want).max()))


def _assert_low_close(got, want, what, dtype):
    """The 2-byte dtypes' rule: bf16's or f16's."""
    (_assert_f16_close if dtype == "float16" else _assert_bf16_close)(got, want, what)


def _assert_grad_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, err_msg=what, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SHARE * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("q_index,src,layout,causal", STEPS)
def test_step_carry_plain_matches_jax_kernel(q_index, src, layout, causal, dtype):
    t = 32
    q, k, v = _draw((B, H, t, D), seed=10 * q_index + src, n=3)
    acc, lse = _carry(t, seed=7)
    q_pos, k_pos = _positions(q_index, src, layout, t)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_acc, j_lse = jfa.flash_ring_step_carry(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(acc), jnp.asarray(lse),
        jnp.asarray(q_pos), jnp.asarray(k_pos), causal=causal, scale=SCALE, interpret=True)
    p_acc, p_lse = torch.from_numpy(acc.copy()), torch.from_numpy(lse.copy())
    got = fa.flash_ring_step_carry(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), p_acc, p_lse,
                                   q_pos, k_pos, causal=causal, scale=SCALE)
    assert got[0] is p_acc and got[1] is p_lse  # updated in place
    if dtype == "float16":
        _assert_f16_close(p_acc.numpy(), np.asarray(j_acc), "acc")
    else:
        np.testing.assert_allclose(p_acc.numpy(), np.asarray(j_acc), **F32_TOL)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse), rtol=0, atol=LSE_ATOL)
    if causal and layout == "contiguous" and src > q_index:  # fully masked: carry kept
        assert np.array_equal(p_acc.numpy(), acc) and np.array_equal(p_lse.numpy(), lse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("q_index,src,layout,causal", STEPS)
def test_step_bwd_plain_matches_jax_kernels(q_index, src, layout, causal, dtype):
    t = 32
    q, k, v, do = _draw((B, H, t, D), seed=20 + q_index, n=4)
    # The final stats of a whole ring: lse of the order of log(T), delta
    # of the order of dO . out.
    lse = np.log(2.0 + np.abs(_draw((B, H, t, 1), 3, 1)[0])) + 1.0
    delta = 0.3 * _draw((B, H, t, 1), 4, 1)[0]
    q_pos, k_pos = _positions(q_index, src, layout, t)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa.flash_ring_step_bwd(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(do), jnp.asarray(lse),
        jnp.asarray(delta), jnp.asarray(q_pos), jnp.asarray(k_pos), causal=causal, scale=SCALE,
        interpret=True)
    got = fa.flash_ring_step_bwd(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                 torch.from_numpy(do), torch.from_numpy(lse),
                                 torch.from_numpy(delta), q_pos, k_pos, causal=causal,
                                 scale=SCALE)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32, name
        _assert_grad_close(g, w, name)


def test_step_bwd_gives_no_gradient_to_a_row_that_saw_no_key():
    """A row whose final lse is NEG_INF saw no key in the whole ring: K8
    and K9 (and so their plain versions) give it P = 0, where the Pallas
    formula gives exp(NEG_INF - NEG_INF) = 1 to its masked keys.  The
    other rows match JAX as in the test above."""
    t = 32
    q, k, v, do = _draw((B, H, t, D), seed=5, n=4)
    lse = np.log(2.0 + np.abs(_draw((B, H, t, 1), 6, 1)[0])) + 1.0
    delta = 0.3 * _draw((B, H, t, 1), 7, 1)[0]
    q_pos = np.arange(t, dtype=np.int32)
    k_pos = np.arange(8, 8 + t, dtype=np.int32)  # queries 0-7 see no key here
    lse[:, :, :8] = fa.NEG_INF  # ... nor anywhere else
    want = jfa.flash_ring_step_bwd(
        *(jnp.asarray(x) for x in (q, k, v, do, lse, delta)), jnp.asarray(q_pos),
        jnp.asarray(k_pos), causal=True, scale=SCALE, interpret=True)
    got = fa.flash_ring_step_bwd(*(torch.from_numpy(x) for x in (q, k, v, do, lse, delta)),
                                 q_pos, k_pos, causal=True, scale=SCALE)
    assert np.all(got[0].numpy()[:, :, :8] == 0.0)
    _assert_grad_close(got[0][:, :, 8:], np.asarray(want[0])[:, :, 8:], "dq of the seen rows")
    # dk/dv without the unseen rows' terms: JAX on the seen rows alone.
    seen = [jnp.asarray(x[:, :, 8:]) for x in (q, do, lse, delta)]
    want_kv = jfa.flash_ring_step_bwd(
        seen[0], jnp.asarray(k), jnp.asarray(v), *seen[1:], jnp.asarray(q_pos[8:]),
        jnp.asarray(k_pos), causal=True, scale=SCALE, interpret=True)
    for name, g, w in zip(("dk", "dv"), got[1:], want_kv[1:]):
        _assert_grad_close(g, w, name)


WIDE = [(d, t, layout, dtype) for d in (136, 256)
        for t, layout in ((32, "contiguous"), (40, "zigzag"))
        for dtype in ("float32", "bfloat16", "float16")]


@pytest.mark.parametrize("d,t,layout,dtype", WIDE)
def test_wide_head_dim_step_matches_jax_kernels(d, t, layout, dtype):
    """K7-K9's plain versions at the head dims of their DP=256 build
    against the Pallas ring kernels (interpret mode) on one step of
    shard 2 against shard 1's block (the carry from a non-trivial
    state), on the same blocks."""
    block = 16 if t % 16 == 0 else 8
    q, k, v, do = _draw((1, H, t, d), seed=d + t, n=4)
    acc = _draw((1, H, t, d), seed=d + t + 1, n=1)[0]
    lse = _draw((1, H, t, 1), seed=d + t + 2, n=1)[0]
    lse[:, 0, : t // 4], acc[:, 0, : t // 4] = fa.NEG_INF, 0.0
    q_pos, k_pos = _positions(2, 1, layout, t)
    scale = fa.default_scale(d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    blocks = dict(block_q=block, block_k=block)
    j_acc, j_lse = jfa.flash_ring_step_carry(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(acc), jnp.asarray(lse),
        jnp.asarray(q_pos), jnp.asarray(k_pos), causal=True, scale=scale, interpret=True,
        **blocks)
    p_acc, p_lse = torch.from_numpy(acc.copy()), torch.from_numpy(lse.copy())
    fa.flash_ring_step_carry(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), p_acc, p_lse,
                             q_pos, k_pos, causal=True, scale=scale, **blocks)
    if dtype == "float32":
        np.testing.assert_allclose(p_acc.numpy(), np.asarray(j_acc), rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] * np.sqrt(d / 16))
    else:
        _assert_low_close(p_acc.numpy(), np.asarray(j_acc), "acc", dtype)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse), rtol=0, atol=LSE_ATOL)
    f_lse = np.log(2.0 + np.abs(lse)) + 1.0  # a whole ring's final stats
    delta = 0.3 * _draw((1, H, t, 1), seed=d + t + 3, n=1)[0]
    want = jfa.flash_ring_step_bwd(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(do), jnp.asarray(f_lse),
        jnp.asarray(delta), jnp.asarray(q_pos), jnp.asarray(k_pos), causal=True, scale=scale,
        interpret=True, **blocks)
    got = fa.flash_ring_step_bwd(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                 torch.from_numpy(do), torch.from_numpy(f_lse),
                                 torch.from_numpy(delta), q_pos, k_pos, causal=True,
                                 scale=scale, **blocks)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape[-1] == d, name
        _assert_grad_close(g, w, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_head_dim_pad_changes_nothing_on_the_ring(dtype):
    """What the step wrappers do on the card for a head_dim that is no
    multiple of 8 (100), run through the plain versions: q, the K/V
    block, dO and the carry padded with zero columns
    (``_ring_kernel_inputs``, ``_ring_kernel_dout``, ``_pad8``), ``scale``
    from the true head_dim, the outputs sliced back, equal the unpadded
    step bit for bit; and the ring itself, which pads once before it
    (``ring_attention_pallas``), equals the unpadded ring bit for bit in
    its output, and within the gradient tolerance in its gradients (its
    delta sums 104 columns)."""
    d, t = 100, 32
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(td) for x in _draw((B, H, t, d), seed=71, n=3))
    do = torch.from_numpy(_draw((B, H, t, d), seed=72, n=1)[0])
    acc, lse = (torch.from_numpy(x) for x in _carry_d(t, d, seed=73))
    q_pos, k_pos = (torch.from_numpy(x) for x in _positions(2, 1, "zigzag", t))
    scale = fa.default_scale(d)
    qp, kp, vp = fa._ring_kernel_inputs(q, k, v)
    dop = fa._ring_kernel_dout(do, qp)
    assert qp.shape[-1] == dop.shape[-1] == 104 and not bool(dop[..., d:].any())
    kw = dict(causal=True, scale=scale)
    want = fa.flash_ring_step_carry_plain(q, k, v, acc.clone(), lse.clone(), q_pos, k_pos, **kw)
    got = fa.flash_ring_step_carry_plain(qp, kp, vp, fa._pad8(acc), lse.clone(), q_pos, k_pos,
                                         **kw)
    assert not bool(got[0][..., d:].any())
    assert torch.equal(got[0][..., :d], want[0]) and torch.equal(got[1], want[1])
    f_lse, delta = want[1], torch.sum(do * want[0], dim=-1, keepdim=True)
    want = fa.flash_ring_step_bwd_plain(q, k, v, do, f_lse, delta, q_pos, k_pos, **kw)
    got = fa.flash_ring_step_bwd_plain(qp, kp, vp, dop, f_lse, delta, q_pos, k_pos, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert not bool(a[..., d:].any()), name
        assert torch.equal(fa._unpad(a, d), b), name

    x, y, g = (torch.from_numpy(a).to(td) for a in _draw((B, 2 * t, H, d), seed=74, n=3))
    r = ring.Ring(N, range(N))
    leaves = [a.clone().requires_grad_(True) for a in (x, y, y)]
    out = ring.ring_attention_pallas(*leaves, ring=r, causal=True, layout="zigzag")
    grads = torch.autograd.grad(out, leaves, g)
    bare = [a.clone().requires_grad_(True) for a in (x, y, y)]
    want = ring._RingFlash.apply(*bare, r, True, scale, "zigzag")
    want_grads = torch.autograd.grad(want, bare, g)
    assert out.shape[-1] == d and torch.equal(out, want)
    for name, a, b in zip("qkv", grads, want_grads):
        assert a.shape[-1] == d, name
        if dtype == "float32":
            _assert_grad_close(a.float(), b.float().numpy(), f"d{name}")
        else:
            _assert_low_close(a.float(), b.float().numpy(), f"d{name}", dtype)


def _carry_d(t, d, seed):
    acc, lse = _draw((B, H, t, d), seed, 1)[0], _draw((B, H, t, 1), seed + 1, 1)[0]
    lse[:, 0, : t // 4], acc[:, 0, : t // 4] = fa.NEG_INF, 0.0
    return acc, lse


def test_uneven_shards_and_the_plain_blocking():
    """Tq != Tk, and the plain forward blocked by 16 keys matches JAX
    blocked by 16 (the online softmax's roundings depend on the blocks)."""
    q, = _draw((B, H, 32, D), 1, 1)
    k, v = _draw((B, H, 48, D), 2, 2)
    acc, lse = _carry(32, seed=3)
    q_pos = np.arange(40, 72, dtype=np.int32)
    k_pos = np.arange(0, 96, 2, dtype=np.int32)
    j_acc, j_lse = jfa.flash_ring_step_carry(
        *(jnp.asarray(x) for x in (q, k, v, acc, lse)), jnp.asarray(q_pos), jnp.asarray(k_pos),
        causal=True, scale=SCALE, block_q=16, block_k=16, interpret=True)
    p_acc, p_lse = torch.from_numpy(acc.copy()), torch.from_numpy(lse.copy())
    fa.flash_ring_step_carry_plain(*(torch.from_numpy(x) for x in (q, k, v)), p_acc, p_lse,
                                   torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                                   causal=True, scale=SCALE, block_k=16)
    np.testing.assert_allclose(p_acc.numpy(), np.asarray(j_acc), **F32_TOL)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse), rtol=0, atol=LSE_ATOL)


def test_step_input_checks_and_no_launch_on_cpu():
    q, k, v = (torch.zeros((1, 2, 8, 16)) for _ in range(3))
    acc, lse = torch.zeros((1, 2, 8, 16)), torch.full((1, 2, 8, 1), fa.NEG_INF)
    pos = np.arange(8)
    fa.reset_launch_counts()
    fa.flash_ring_step_carry(q, k, v, acc, lse, pos, pos, causal=True, scale=0.25)
    fa.flash_ring_step_bwd(q, k, v, q, lse, lse, pos, pos, causal=True, scale=0.25)
    assert not any(fa.launch_counts().values())
    with pytest.raises(ValueError, match="acc must be float32"):
        fa.flash_ring_step_carry(q, k, v, acc.double(), lse, pos, pos, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="q_pos must be"):
        fa.flash_ring_step_carry(q, k, v, acc, lse, pos[:4], pos, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_ring_step_dq(q, k, v, q, lse[:, :1], lse, pos, pos, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="K/V"):
        fa.flash_ring_step_carry(q, k[:, :1], v, acc, lse, pos, pos, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="tiles"):
        fa._check_tiles(fa.BLOCK, 512)


def test_layout_helpers_match_jax():
    for t, n in ((16, 2), (64, 4)):
        np.testing.assert_array_equal(ring.zigzag_order(t, n), jring.zigzag_order(t, n))
        order, inv = ring.zigzag_orders(t, n)
        np.testing.assert_array_equal(order[inv], np.arange(t))
        for layout in ring.LAYOUTS:
            for i in range(n):
                np.testing.assert_array_equal(
                    ring.shard_positions(i, t // n, n, layout),
                    np.asarray(jring._shard_positions(i, t // n, n, layout)))
    with pytest.raises(ValueError, match="2\\*4 chunks"):
        ring.zigzag_order(12, 4)
    with pytest.raises(ValueError, match="unknown layout"):
        ring.shard_positions(0, 8, 2, "striped")


def _jax_mesh():
    return jax_build_mesh(JaxMeshConfig(data=2, model=4))


def _port_mesh():
    return build_mesh(MeshConfig(data=2, model=4), devices=virtual_devices(8, "cpu"))


def _jax_ring_grads(q, k, v, g, causal, layout):
    mesh = _jax_mesh()

    def f(q, k, v):
        return jring.ring_self_attention(mesh, q, k, v, causal=causal, layout=layout,
                                         impl="pallas")

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return out, vjp(jnp.asarray(g))


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
@pytest.mark.parametrize("causal", [True, False])
def test_in_process_ring_matches_jax_ring(causal, layout):
    """The port's in-process ring of 4 (a (2, 4) mesh) against the JAX
    Pallas ring on the 8-device CPU mesh: output and gradients, f32."""
    q, k, v, g = _draw((4, 64, H, D), seed=31 + causal, n=4)
    want, want_grads = _jax_ring_grads(q, k, v, g, causal, layout)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ring.ring_self_attention(_port_mesh(), *leaves, causal=causal, layout=layout)
    got_grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    for name, got, w in zip("qkv", got_grads, want_grads):
        _assert_grad_close(got, w, f"d{name}")


def test_bf16_ring_matches_jax_ring():
    q, k, v, g = _draw((2, 64, H, D), seed=41, n=4)
    mesh = _jax_mesh()

    def f(q, k, v):
        return jring.ring_self_attention(mesh, q, k, v, causal=True, layout="zigzag",
                                         impl="pallas")

    want, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g, jnp.bfloat16))
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    out = ring.ring_self_attention(_port_mesh(), *leaves, causal=True, layout="zigzag")
    got_grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    _assert_bf16_close(out.detach().float(), np.asarray(want, np.float32), "out")
    for name, got, w in zip("qkv", got_grads, want_grads):
        assert got.dtype == torch.bfloat16
        _assert_bf16_close(got.float(), np.asarray(w, np.float32), f"d{name}")


def test_f16_ring_matches_jax_ring():
    """The float16 ring: JAX's Pallas ring under ``shard_map`` (its
    kernels cast q, k, v to f32 inside and round P to f16 before P V)
    against the port's, output and gradients in float16 at the f16
    rule."""
    q, k, v, g = _draw((2, 64, H, D), seed=43, n=4)
    mesh = _jax_mesh()

    def f(q, k, v):
        return jring.ring_self_attention(mesh, q, k, v, causal=True, layout="zigzag",
                                         impl="pallas")

    want, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g, jnp.float16))
    leaves = [torch.from_numpy(x).to(torch.float16).requires_grad_(True) for x in (q, k, v)]
    out = ring.ring_self_attention(_port_mesh(), *leaves, causal=True, layout="zigzag")
    got_grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(torch.float16))
    assert out.dtype == torch.float16 and want.dtype == jnp.float16
    _assert_f16_close(out.detach().float(), np.asarray(want, np.float32), "out")
    for name, got, w in zip("qkv", got_grads, want_grads):
        assert got.dtype == torch.float16 and w.dtype == jnp.float16
        _assert_f16_close(got.float(), np.asarray(w, np.float32), f"d{name}")


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_block_math_ring_matches_jax_and_the_flash_ring(layout):
    """``ring_attention`` (the XLA engine) against the JAX ring with
    impl="xla", and against the port's flash ring."""
    q, k, v = _draw((2, 64, H, D), seed=51, n=3)
    want = jring.ring_self_attention(_jax_mesh(), *(jnp.asarray(x) for x in (q, k, v)),
                                     causal=True, layout=layout, impl="xla")
    tq = [torch.from_numpy(x) for x in (q, k, v)]
    if layout == "zigzag":
        order, inv = ring.zigzag_orders(64, N)
        tq = [x[:, order] for x in tq]
    got = ring.ring_attention(*tq, ring=ring.Ring(N, range(N)), causal=True, layout=layout)
    flash = ring.ring_attention_pallas(*tq, ring=ring.Ring(N, range(N)), causal=True,
                                       layout=layout)
    if layout == "zigzag":
        got, flash = got[:, inv], flash[:, inv]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(flash.numpy(), got.numpy(), **F32_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_backward_takes_the_gradient_in_its_dtype(layout, dtype):
    """The ring backward hands K8 and K9 the gradient in q's dtype (bf16
    or f16 on a model computing in it) where it used to hand them an f32
    copy: the plain
    route's dq, dk and dv are bit-identical to those from the f32 copy,
    through autograd and called directly."""
    q, k, v, g = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in _draw((2, 64, H, D), seed=61, n=4))
    r = ring.Ring(N, range(N))
    if layout == "zigzag":
        order, _ = ring.zigzag_orders(64, N)
        q, k, v, g = (x[:, order] for x in (q, k, v, g))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ring.ring_attention_pallas(*leaves, ring=r, causal=True, layout=layout)
    got = torch.autograd.grad(out, leaves, g)
    out2, lses = ring._ring_flash_forward(r, True, SCALE, layout, q, k, v)
    assert torch.equal(out2, out.detach())
    as_given = ring._ring_flash_backward(r, True, SCALE, layout, q, k, v, out2, lses, g)
    upcast = ring._ring_flash_backward(r, True, SCALE, layout, q, k, v, out2, lses, g.float())
    for name, a, b, c in zip(("dq", "dk", "dv"), got, as_given, upcast):
        assert a.dtype == getattr(torch, dtype), name
        assert torch.equal(a, b) and torch.equal(b, c), name


def test_bf16_gradient_reaches_the_step_kernels_without_an_upcast(monkeypatch):
    """On a bf16 ring the step functions receive the bf16 gradient, and
    the kernels' wrapper passes a bf16 dO beside bf16 q through as it is
    (a copy only where it is not 16-byte aligned); any other dO is f32."""
    seen = []

    def spy(fn):
        def wrapped(q, k_blk, v_blk, do, *args, **kwargs):
            seen.append((fn.__name__, do.dtype))
            return fn(q, k_blk, v_blk, do, *args, **kwargs)
        return wrapped

    for name in ("flash_ring_step_dq", "flash_ring_step_dkv"):
        monkeypatch.setattr(fa, name, spy(getattr(fa, name)))
    q = torch.from_numpy(_draw((2, 64, H, D), seed=62, n=1)[0]).to(torch.bfloat16)
    q.requires_grad_(True)
    ring.ring_attention_pallas(q, q, q, ring=ring.Ring(N, range(N)), causal=True).sum().backward()
    assert len(seen) == 2 * N * N and {dtype for _, dtype in seen} == {torch.bfloat16}

    bf16 = torch.zeros((2, 2, 64, 16), dtype=torch.bfloat16)
    f32 = torch.zeros((2, 2, 64, 16))
    assert fa._ring_kernel_dout(bf16, bf16) is bf16
    assert fa._ring_kernel_dout(f32, bf16) is f32
    assert fa._ring_kernel_dout(bf16, f32).dtype == torch.float32
    off = torch.zeros(bf16.numel() + 1, dtype=torch.bfloat16)[1:].view(bf16.shape)
    aligned = fa._ring_kernel_dout(off, bf16)
    assert aligned.data_ptr() % 16 == 0 and aligned.dtype == torch.bfloat16
    assert torch.equal(aligned, off)


def test_f16_gradient_reaches_the_step_kernels_as_f16(monkeypatch):
    """On an f16 ring the step functions receive the f16 gradient, and the
    kernels' wrapper passes an f16 dO beside f16 q through as it is, with
    no f32 copy (a copy only where it is not 16-byte aligned); an f32 dO
    stays f32, and an f16 dO beside q of another dtype is read as f32."""
    seen = []

    def spy(fn):
        def wrapped(q, k_blk, v_blk, do, *args, **kwargs):
            seen.append((fn.__name__, do.dtype, fa._ring_kernel_dout(do, q).dtype))
            return fn(q, k_blk, v_blk, do, *args, **kwargs)
        return wrapped

    for name in ("flash_ring_step_dq", "flash_ring_step_dkv"):
        monkeypatch.setattr(fa, name, spy(getattr(fa, name)))
    q = torch.from_numpy(_draw((2, 64, H, D), seed=63, n=1)[0]).to(torch.float16)
    q.requires_grad_(True)
    ring.ring_attention_pallas(q, q, q, ring=ring.Ring(N, range(N)), causal=True).sum().backward()
    assert len(seen) == 2 * N * N
    assert {(given, read) for _, given, read in seen} == {(torch.float16, torch.float16)}

    f16 = torch.zeros((2, 2, 64, 16), dtype=torch.float16)
    f32 = torch.zeros((2, 2, 64, 16))
    bf16 = f16.to(torch.bfloat16)
    assert fa._ring_kernel_dout(f16, f16) is f16
    assert fa._ring_kernel_dout(f32, f16) is f32
    assert fa._ring_kernel_dout(f16, bf16).dtype == torch.float32
    assert fa._ring_kernel_dout(f16, f32).dtype == torch.float32
    off = torch.zeros(f16.numel() + 1, dtype=torch.float16)[1:].view(f16.shape)
    aligned = fa._ring_kernel_dout(off, f16)
    assert aligned.data_ptr() % 16 == 0 and aligned.dtype == torch.float16
    assert torch.equal(aligned, off)


def test_ring_launches_nothing_on_cpu_and_validates():
    q = torch.zeros((2, 32, H, D), requires_grad=True)
    fa.reset_launch_counts()
    ring.ring_self_attention(_port_mesh(), q, causal=True).sum().backward()
    assert not any(fa.launch_counts().values())
    with pytest.raises(ValueError, match="'model' axis"):
        ring.make_ring_attention(_port_mesh(), axis="data")
    with pytest.raises(ValueError, match="unknown layout"):
        ring.make_ring_attention(_port_mesh(), layout="striped")
    with pytest.raises(ValueError, match="equal q/k/v"):
        ring.ring_self_attention(_port_mesh(), q, q[:, :16], q[:, :16], layout="zigzag")
    rotated = ring.Ring(3, range(3)).rotate([("a",), ("b",), ("c",)])
    assert rotated == [("c",), ("a",), ("b",)]
