"""The port's flash attention (elasticdl_tpu_torch/ops/flash_attention.py)
and its blockwise engine against the JAX package on the CPU.

On CPU tensors the kernel functions run their plain versions, which
follow the CUDA kernels' formulas and roundings; the JAX side runs its
Pallas kernels in interpret mode with 16-wide blocks (as
``tests/test_flash_attention.py`` does).  Inputs are numpy draws from a
seed, B=2, H=2, D=16; the wide head dims of the DP=256 build (136, 256)
at B=1, H=2, and a head_dim that is no multiple of 8 through the pad.
Tolerances:

- f32: rtol 1e-5 / atol 1e-6 (out, lse, and the gradients of a random
  cotangent).  The frameworks sum the products in other orders.
- f32 at the wide head dims: the same rtol, and the atol times
  sqrt(D / 16): a score sums D products, so its f32 rounding noise grows
  with sqrt(D) against the file's D=16 (measured at D=256: dk 1.56e-6 on
  an element of 2.8e-4).
- bf16: out and gradients within 2 bf16 ulps (rtol 2**-7) plus 2**-10 of
  the tensor's largest magnitude.  Both round the same f32 values to
  bf16 (P before P V, the outputs), and a value a summation order away
  from a rounding boundary lands on either side.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.parallel.ring_attention import blockwise_attention as jax_blockwise
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel.ring_attention import blockwise_attention

# The module (the package's __init__ exports the function under its name).
jfa = importlib.import_module("elasticdl_tpu.ops.flash_attention")

BLOCK = dict(block_q=16, block_k=16)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -7, 2.0 ** -10


def _draw(t, seed, b=2, h=2, d=16, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(n)]


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _jax(x, dtype):
    return jnp.asarray(x, dtype)


def _assert_bf16_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    limit = BF16_RTOL * np.abs(want) + BF16_ATOL_SHARE * np.abs(want).max()
    excess = np.abs(got - want) - limit
    assert excess.max() <= 0.0, (what, float(np.abs(got - want).max()))


@pytest.mark.parametrize("t", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_jax_kernel(causal, t):
    q, k, v, _ = _draw(t, seed=t + causal)
    scale = 1.0 / np.sqrt(q.shape[-1])
    j_out, j_lse = jfa._fwd(*(_jax(x, jnp.float32).transpose(0, 2, 1, 3) for x in (q, k, v)),
                            scale, causal, 16, 16, True)
    out, lse = fa.flash_attention_fwd(*(_torch(x, torch.float32) for x in (q, k, v)),
                                      fa.default_scale(16), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out).transpose(0, 2, 1, 3), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], **F32_TOL)
    # the public function: the same forward
    public = fa.flash_attention(*(_torch(x, torch.float32) for x in (q, k, v)), causal=causal)
    assert torch.equal(public, out)


def _jax_grads(q, k, v, g, causal, dtype):
    args = [_jax(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal, **BLOCK),
                       *args)
    return out, vjp(_jax(g, dtype))


def _port_grads(q, k, v, g, causal, dtype):
    leaves = [_torch(x, dtype).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, **BLOCK)
    out.backward(_torch(g, dtype))
    return out.detach(), [x.grad for x in leaves]


@pytest.mark.parametrize("t", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_custom_vjp_f32(causal, t):
    q, k, v, g = _draw(t, seed=10 + t + causal)
    j_out, j_grads = _jax_grads(q, k, v, g, causal, jnp.float32)
    out, grads = _port_grads(q, k, v, g, causal, torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **F32_TOL)
    for name, got, want in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name}", **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_custom_vjp_bf16(causal):
    q, k, v, g = _draw(64, seed=20 + causal)
    j_out, j_grads = _jax_grads(q, k, v, g, causal, jnp.bfloat16)
    out, grads = _port_grads(q, k, v, g, causal, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in grads)
    _assert_bf16_close(out.float().numpy(), j_out, "out")
    for name, got, want in zip("qkv", grads, j_grads):
        _assert_bf16_close(got.float().numpy(), want, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_backward_pieces_match_the_whole(causal):
    """dq / (dk, dv) from the two kernel functions, delta formed outside
    them, equal the plain backward's; the autograd backward is the same
    computation."""
    q, k, v, g = (_torch(x, torch.float32) for x in _draw(48, seed=3))
    scale = fa.default_scale(16)
    out, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
    delta = fa.attention_delta(out, g)
    np.testing.assert_allclose(delta.numpy(), np.einsum("bthd,bthd->bht", out.numpy(),
                                                        g.numpy()), rtol=1e-6, atol=1e-6)
    dq = fa.flash_attention_dq(q, k, v, g, lse, delta, scale, causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, g, lse, delta, scale, causal)
    whole = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, scale, causal)
    for got, want in zip((dq, dk, dv), whole):
        assert torch.equal(got, want)


@pytest.mark.parametrize("t", [40, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_ragged_lengths_and_blocks(causal, t):
    """T = 40 is no multiple of the 16-wide blocks (the JAX kernel raises
    there); the port's plain version blocks by any block_k, and agrees
    with the JAX blockwise engine at the f32 bar."""
    q, k, v, _ = _draw(t, seed=30 + t)
    want = np.asarray(jax_blockwise(*(_jax(x, jnp.float32) for x in (q, k, v)), causal=causal))
    for block_k in (16, 64, 7):
        out, _ = fa.flash_attention_fwd(*(_torch(x, torch.float32) for x in (q, k, v)),
                                        fa.default_scale(16), causal, block_k)
        np.testing.assert_allclose(out.numpy(), want, err_msg=f"block_k={block_k}", **F32_TOL)


@pytest.mark.parametrize("kv_chunk", [16, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_attention_matches_jax(dtype, causal, kv_chunk):
    q, k, v, _ = _draw(64, seed=40 + causal)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_blockwise(*(_jax(x, jd) for x in (q, k, v)), causal=causal, kv_chunk=kv_chunk)
    got = blockwise_attention(*(_torch(x, td) for x in (q, k, v)), causal=causal,
                              kv_chunk=kv_chunk)
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    else:
        _assert_bf16_close(got.float().numpy(), want, "blockwise")


def test_blockwise_offsets_match_jax():
    q, k, v, _ = _draw(32, seed=50)
    want = jax_blockwise(*(_jax(x, jnp.float32) for x in (q, k, v)), causal=True,
                         q_offset=32, k_offset=16)
    got = blockwise_attention(*(_torch(x, torch.float32) for x in (q, k, v)), causal=True,
                              q_offset=32, k_offset=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_cpu_calls_count_no_launch():
    fa.reset_launch_counts()
    leaves = [_torch(x, torch.float32).requires_grad_(True) for x in _draw(32, seed=1)[:3]]
    fa.flash_attention(*leaves, causal=True).sum().backward()
    assert fa.launch_counts() == {name: 0 for name in fa.KERNELS + fa.RING_KERNELS}


def test_kernel_input_checks():
    """What the CUDA kernels take is checked before any launch (the
    checks need no card: they read dtypes, shapes and strides)."""
    x = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    q, k, v = fa._kernel_inputs(x, x, x)
    assert q is x  # one set of strides, contiguous last dim: no copy
    fused = torch.zeros((1, 8, 3, 2, 16), dtype=torch.bfloat16)
    q, k, v = fused.unbind(2)
    assert fa._kernel_inputs(q, k, v)[0] is q  # slices of one projection go in as views
    for d in (12, 136, 256):  # 12 is padded with zero columns to 16
        y = torch.zeros((1, 8, 2, d))
        assert all(x.shape[-1] == d + -d % 8 for x in fa._kernel_inputs(y, y, y))
    y = torch.zeros((1, 8, 2, 264))
    with pytest.raises(ValueError, match="head_dim up to 256"):
        fa._kernel_inputs(y, y, y)
    for d in (100, 136, 256):  # the ring kernels' DP=256 build; 100 is padded to 104
        r = torch.zeros((1, 2, 8, d))
        assert all(x.shape[-1] == d + -d % 8 for x in fa._ring_kernel_inputs(r, r, r))
    r = torch.zeros((1, 2, 8, 264))
    with pytest.raises(ValueError, match="head_dim up to 256"):
        fa._ring_kernel_inputs(r, r, r)
    # float16: K4-K9 take it, aligned as bf16 is: an aligned tensor goes
    # in as it is, a misaligned one is copied to 16-byte alignment; K8 and
    # K9 read an f16 dO beside f16 q as it is; a dtype no build takes
    # (float64) raises, naming K7-K9.
    h = torch.zeros((1, 8, 2, 16), dtype=torch.float16)
    assert fa._kernel_inputs(h, h, h)[0] is h
    assert all(y is h for y in fa._ring_kernel_inputs(h, h, h))
    assert fa._ring_kernel_dout(h, h) is h
    off = torch.zeros(1 * 8 * 2 * 16 + 1, dtype=torch.float16)[1:].view(1, 8, 2, 16)
    assert off.data_ptr() % 16
    for y in (fa._kernel_inputs(off, off, off) + (fa._kernel_dout(off, h),)
              + fa._ring_kernel_inputs(off, off, off) + (fa._ring_kernel_dout(off, h),)):
        assert y.dtype == torch.float16 and y.data_ptr() % 16 == 0 and torch.equal(y, off)
    with pytest.raises(TypeError, match="K7-K9 are not built for torch.float64"):
        f64 = torch.zeros((1, 2, 8, 16), dtype=torch.float64)
        fa._ring_kernel_inputs(f64, f64, f64)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        i = torch.zeros((1, 8, 2, 16), dtype=torch.float64)
        fa._kernel_inputs(i, i, i)
    with pytest.raises(ValueError, match="one \\[B, T, H, D\\] shape"):
        fa.flash_attention(x, x[:, :4], x)
    with pytest.raises(ValueError, match="no kernel for device"):
        m = torch.zeros((1, 8, 2, 16), device="meta")
        fa.flash_attention_fwd(m, m, m, 0.25, True)


WIDE = [(d, t, dtype) for d in (136, 256) for t in (32, 40) for dtype in ("float32", "bfloat16")]


def _wide_blocks(t):
    """JAX's kernels need whole blocks: 16 at T=32, 8 at T=40."""
    return 16 if t % 16 == 0 else 8


@pytest.mark.parametrize("d,t,dtype", WIDE)
def test_wide_head_dim_forward_matches_jax_kernel(d, t, dtype):
    """K4's plain version at the head dims of its DP=256 build against
    the Pallas forward (interpret mode), causal, on the same blocks."""
    q, k, v, _ = _draw(t, seed=60 + d + t, b=1, d=d)
    block = _wide_blocks(t)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j_out, j_lse = jfa._fwd(*(_jax(x, jd).transpose(0, 2, 1, 3) for x in (q, k, v)),
                            1.0 / np.sqrt(d), True, block, block, True)
    out, lse = fa.flash_attention_fwd(*(_torch(x, td) for x in (q, k, v)),
                                      fa.default_scale(d), True, block)
    want = np.asarray(j_out.astype(jnp.float32)).transpose(0, 2, 1, 3)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), want, **F32_TOL)
    else:
        _assert_bf16_close(out.float().numpy(), want, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], **F32_TOL)


@pytest.mark.parametrize("d,t,dtype", WIDE)
def test_wide_head_dim_autograd_matches_jax_custom_vjp(d, t, dtype):
    """K4-K6's plain versions through the public function at the wide
    head dims against JAX's custom_vjp (its Pallas kernels in interpret
    mode), causal."""
    q, k, v, g = _draw(t, seed=70 + d + t, b=1, d=d)
    block = dict(block_q=_wide_blocks(t), block_k=_wide_blocks(t))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j_out, j_vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal=True, **block),
                           *(_jax(x, jd) for x in (q, k, v)))
    j_grads = j_vjp(_jax(g, jd))
    leaves = [_torch(x, td).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, **block)
    out.backward(_torch(g, td))
    for name, got, want in zip(("out", "dq", "dk", "dv"), [out.detach()] + [x.grad for x in leaves],
                               [j_out, *j_grads]):
        assert got.dtype == td
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, err_msg=name, rtol=F32_TOL["rtol"],
                                       atol=F32_TOL["atol"] * np.sqrt(d / 16))
        else:
            _assert_bf16_close(got.float().numpy(), want, name)


@pytest.mark.parametrize("d", [12, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_pad_changes_nothing(dtype, d):
    """What the K4-K6 wrappers do on the card for a head_dim that is not a
    multiple of 8, run through the plain versions: q, k, v and dO padded
    with zero columns (``_kernel_inputs``, ``_kernel_dout``), ``scale``
    from the true head_dim, the outputs sliced back (``_unpad``), equal
    the unpadded computation bit for bit (zero columns add exact zeros to
    every score and give zero output columns)."""
    td = getattr(torch, dtype)
    q, k, v, g = (_torch(x, td) for x in _draw(40, seed=80 + d, d=d))
    scale = fa.default_scale(d)
    qp, kp, vp = fa._kernel_inputs(q, k, v)
    gp = fa._kernel_dout(g, qp)
    assert qp.shape[-1] == gp.shape[-1] == d + -d % 8
    assert not bool(qp[..., d:].any()) and not bool(gp[..., d:].any())
    out, lse = fa.flash_attention_fwd_plain(q, k, v, scale, True)
    out_p, lse_p = fa.flash_attention_fwd_plain(qp, kp, vp, scale, True)
    assert not bool(out_p[..., d:].any())
    assert torch.equal(fa._unpad(out_p, d), out) and torch.equal(lse_p, lse)
    delta = fa.attention_delta(out, g)
    want = (fa.flash_attention_dq_plain(q, k, v, g, lse, delta, scale, True),
            *fa.flash_attention_dkv_plain(q, k, v, g, lse, delta, scale, True))
    got = (fa.flash_attention_dq_plain(qp, kp, vp, gp, lse, delta, scale, True),
           *fa.flash_attention_dkv_plain(qp, kp, vp, gp, lse, delta, scale, True))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert not bool(a[..., d:].any()), name
        assert torch.equal(fa._unpad(a, d), b), name
