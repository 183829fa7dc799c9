"""The rounding design of the bf16 and f16 tensor-core builds of K4-K9
(``flash_fwd_mma_kernel``, ``flash_dq_mma_kernel``,
``flash_dkv_mma_kernel`` in ``elasticdl_tpu_torch/ops/csrc/flash_attention.cu``;
``ring_fwd_mma_kernel``, ``ring_dq_mma_kernel`` and ``ring_dkv_mma_kernel``
in ``ring_attention.cu``), emulated in
PyTorch on the CPU and held to the port's plain versions and to the JAX
kernels in interpret mode, at the tolerances ``chip_smoke.py`` holds the
kernels to on the card.

What the emulation repeats of the kernels' arithmetic (the tensor cores
multiply bf16 operands exactly and sum in f32, which an f32 matmul of the
upcast operands does up to summation order):

- K4: S = Q K^T from the unscaled bf16 q, multiplied by ``scale`` in f32
  after the product; the online softmax per 64-key tile, l summing the
  unrounded p, P rounded to bf16 before P V.  Its f16 build the same in
  f16 (f16 products are exact in f32 too).
- K5: S = Q K^T scaled in f32 after the product, P = exp(S - lse) and dS
  = P (dO V^T - delta) in f32, then dQ = dS K with dS split into hi =
  bf16(x) and lo = bf16(x - hi), two products summed in f32.
- K6: S^T = K Q^T scaled in f32 after the product, P and dS in f32, then
  dV = P^T dO and dK = dS^T Q with P and dS each split as in K5.
- K7: K4's forward with the ring's rules: the mask k_pos > q_pos, the
  online softmax's max clamped to 0 while a row has seen only masked
  keys (p = 0 there), then the lse-space combine with the carry in the
  JAX order; a row that sees no key keeps its carry bit for bit.
- K8 and K9 (f32 outputs, held to ``ATTN_F32_*``): S from the unscaled
  bf16 q, scaled in f32; P = exp(S - lse), 0 where masked or where the
  row's final lse is NEG_INF; dP from dO, a bf16 dO as it is and an f32
  dO in three bf16 parts (each the bf16 of what the parts before it
  left); dS = P (dP - delta) in f32; P and dS each split in two (hi, lo)
  before dQ = dS K, dK = dS^T Q and dV = P^T dO, every cross product
  kept.

The f16 builds of K5 and K6 keep K5's and K6's rules in f16, and take
each product with a split P or dS against a bf16 split of the f16 tile:
f16's 11 significant bits are bf16(x) and a bf16 remainder, exactly, in
bf16's f32 range; three products (hi hi, lo hi, hi lo).  They are held at
dO scaled by 2**-20, the LM's gradient scale, where an f16 hi/lo split of
dS (no scaling) flushes it and fails.

The f16 builds of K7-K9 (ring_mma.cuh's templates on __half) keep K7's,
K8's and K9's rules in f16 the same way: S and dP (on an f16 dO) are
exact f16 products with f32 sums, K7 rounds P to f16 per 64 keys, and
dQ = dS K, dK = dS^T Q and dV = P^T dO take the f16 tile split exactly
into two bf16 parts against P's and dS's hi/lo (three products); an f32
dO's three bf16 parts meet f16 V's two exact parts, whose sum is V, so
dP is the bf16 builds' sum.  Their outputs are f32, held to phase 52's
rule (``chip_smoke.py``'s phase 51 rule, ``ATTN_F16_*``, without its
floor of two f16 subnormal steps, which f32 outputs do not have) at dO x
1 and x 2**-20 with no entry flushed to zero, where an f16 hi/lo split
of P and dS fails.

The DP=256 builds keep these rules and this split of every sum: K4, K5,
K7 and K8 only read their Q and dO fragments from shared memory instead
of registers (K8 with an f32 dO also stages one K/V tile set, not two),
and the pairs of warps of K6 and K9 per 16 key rows compute S^T and dP^T
once each and give each warp half of the columns of dK and dV, so every
accumulator element gets the same products in the same order.

Inputs are seeded numpy draws at D=64 and D=128 (the kernels' two
narrower builds) and D=256 (the third), causal and full; T is ragged
(not a multiple of the 64-row tile) against the plain versions and a
multiple of 64 against JAX, whose kernels need whole blocks.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    ATTN_ATOL_SHARE,
    ATTN_F16_ATOL_SHARE,
    ATTN_F16_RTOL,
    ATTN_F32_ATOL_SHARE,
    ATTN_F32_RTOL,
    ATTN_RTOL,
    F16_DO_SCALES,
    F16_ULP_FLOOR,
    LSE_ATOL,
    RING_CARRY_TOL,
    f16_zero_flushes,
)
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel import ring_attention as ring

jfa = importlib.import_module("elasticdl_tpu.ops.flash_attention")

TILE = fa.BLOCK


def _draw(b, t, h, d, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(n)]


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _split(x):
    """x = hi + lo: hi = bf16(x), lo = bf16(x - hi), both as f32."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def emulate_k4(q, k, v, scale, causal):
    """K4's arithmetic: ``(out [B, T, H, D] in q's dtype, lse [B, H, T]
    f32)``; P rounded to v's dtype (bf16, or f16 in the f16 build)."""
    b, t, h, d = q.shape
    qf = q.transpose(1, 2).float()
    kf = k.transpose(1, 2).float()
    vf = v.transpose(1, 2).float()
    pos = torch.arange(t)
    m = torch.full((b, h, t), fa.NEG_INF)
    l = torch.zeros((b, h, t))
    acc = torch.zeros((b, h, t, d))
    for k0 in range(0, t, TILE):
        k1 = min(t, k0 + TILE)
        s = torch.matmul(qf, kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            s = torch.where(pos[k0:k1][None, :] > pos[:, None], fa.NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p.to(v.dtype).float(), vf[:, :, k0:k1])
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).to(q.dtype).transpose(1, 2).contiguous()
    return out, m + torch.log(l_safe)


def emulate_k6(q, k, v, do, lse, delta, scale, causal, split=True):
    """K6's arithmetic: ``(dk, dv)`` bf16 ``[B, T, H, D]``.  ``split=False``
    rounds P and dS once to bf16 instead (the design the kernel avoids)."""
    t = q.shape[1]
    qf, kf, vf, dof = (x.transpose(1, 2).float() for x in (q, k, v, do))
    s_t = torch.matmul(kf, qf.transpose(-1, -2)) * scale      # [B, H, keys, queries]
    if causal:
        pos = torch.arange(t)
        s_t = torch.where(pos[:, None] > pos[None, :], fa.NEG_INF, s_t)
    p_t = torch.exp(s_t - lse[:, :, None, :])
    dp_t = torch.matmul(vf, dof.transpose(-1, -2))
    ds_t = p_t * (dp_t - delta[:, :, None, :])
    if split:
        p_parts, ds_parts = _split(p_t), _split(ds_t)
    else:
        p_parts = (p_t.to(torch.bfloat16).float(),)
        ds_parts = (ds_t.to(torch.bfloat16).float(),)
    dv = sum(torch.matmul(part, dof) for part in p_parts)
    dk = sum(torch.matmul(part, qf) for part in ds_parts) * scale
    return (dk.to(torch.bfloat16).transpose(1, 2).contiguous(),
            dv.to(torch.bfloat16).transpose(1, 2).contiguous())


def emulate_k5(q, k, v, do, lse, delta, scale, causal, split=True):
    """K5's arithmetic: dq bf16 ``[B, T, H, D]``.  ``split=False`` rounds
    dS once to bf16 instead (the design the kernel avoids)."""
    t = q.shape[1]
    qf, kf, vf, dof = (x.transpose(1, 2).float() for x in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale          # [B, H, queries, keys]
    if causal:
        pos = torch.arange(t)
        s = torch.where(pos[None, :] > pos[:, None], fa.NEG_INF, s)
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    parts = _split(ds) if split else (ds.to(torch.bfloat16).float(),)
    dq = sum(torch.matmul(part, kf) for part in parts) * scale
    return dq.to(torch.bfloat16).transpose(1, 2).contiguous()


def _half_neg_inf(x):
    return x <= fa.NEG_INF / 2


def emulate_k7(q, k, v, acc, lse, q_pos, k_pos, scale, causal):
    """K7's arithmetic on ``[B, H, T, D]`` inputs: the updated carry
    ``(acc [B, H, Tq, D], lse [B, H, Tq, 1])`` as new tensors."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, tq, 1), fa.NEG_INF)
    l = torch.zeros((b, h, tq, 1))
    o = torch.zeros((b, h, tq, d))
    for k0 in range(0, tk, TILE):
        k1 = min(tk, k0 + TILE)
        s = torch.matmul(qf, kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            s = torch.where(k_pos[k0:k1][None, :] > q_pos[:, None], fa.NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        safe_m = torch.where(_half_neg_inf(m_new), 0.0, m_new)
        p = torch.where(_half_neg_inf(s), 0.0, torch.exp(s - safe_m))
        corr = torch.where(_half_neg_inf(m), 0.0, torch.exp(m - safe_m))
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.matmul(p.to(v.dtype).float(), vf[:, :, k0:k1])
        m = m_new
    seen = l != 0.0
    l_safe = torch.where(seen, l, 1.0)
    lse_i = torch.where(_half_neg_inf(m), 0.0, m) + torch.log(l_safe)
    lse_c = lse.reshape(b, h, tq, 1)
    lse_new = torch.maximum(lse_c, lse_i) + torch.log1p(torch.exp(-(lse_c - lse_i).abs()))
    safe = torch.where(_half_neg_inf(lse_new), 0.0, lse_new)
    alpha = torch.exp(torch.where(_half_neg_inf(lse_c), fa.NEG_INF, lse_c) - safe)
    beta = torch.exp(lse_i - safe)
    return (torch.where(seen, acc * alpha + (o / l_safe) * beta, acc),
            torch.where(seen, lse_new, lse_c).reshape(lse.shape))


def _excess(got, want):
    """Largest amount by which |got - want| passes phase 10's bf16 rule
    (<= 0 passes)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    limit = ATTN_RTOL * np.abs(want) + ATTN_ATOL_SHARE * np.abs(want).max()
    return float((np.abs(got - want) - limit).max())


def _assert_close(got, want, what):
    excess = _excess(got, want)
    assert excess <= 0.0, (what, excess)


CASES = [(d, causal) for d in (64, 128) for causal in (True, False)]
#: With the DP=256 build.
K456_CASES = CASES + [(256, causal) for causal in (True, False)]


@pytest.mark.parametrize("t", [100, 200])
@pytest.mark.parametrize("d,causal", K456_CASES)
def test_k4_rounding_matches_plain_version(d, causal, t):
    q, k, v = (_bf16(x) for x in _draw(2, t, 2, d, seed=d + t + causal, n=3))
    scale = fa.default_scale(d)
    out, lse = emulate_k4(q, k, v, scale, causal)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, causal)
    assert float((lse - lse_p).abs().max()) <= LSE_ATOL
    _assert_close(out.float(), out_p.float(), "out")


@pytest.mark.parametrize("t", [100, 200])
@pytest.mark.parametrize("d,causal", K456_CASES)
def test_k6_rounding_matches_plain_version(d, causal, t):
    q, k, v, do = (_bf16(x) for x in _draw(2, t, 2, d, seed=7 * d + t + causal))
    scale = fa.default_scale(d)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, causal)
    delta = fa.attention_delta(out_p, do)
    dk, dv = emulate_k6(q, k, v, do, lse_p, delta, scale, causal)
    dk_p, dv_p = fa.flash_attention_dkv_plain(q, k, v, do, lse_p, delta, scale, causal)
    _assert_close(dk.float(), dk_p.float(), "dk")
    _assert_close(dv.float(), dv_p.float(), "dv")


def _jax_bhtd(x):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16).transpose(0, 2, 1, 3)


def _from_jax_bhtd(x):
    return np.asarray(x, np.float32).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("d,causal", K456_CASES)
def test_k4_rounding_matches_jax_kernel(d, causal):
    q, k, v = (_bf16(x) for x in _draw(1, 2 * TILE, 2, d, seed=31 + d + causal, n=3))
    scale = fa.default_scale(d)
    j_out, j_lse = jfa._fwd(*(_jax_bhtd(x) for x in (q, k, v)), scale, causal, TILE, TILE,
                            True)
    out, lse = emulate_k4(q, k, v, scale, causal)
    assert float(np.abs(lse.numpy() - np.asarray(j_lse)[..., 0]).max()) <= LSE_ATOL
    _assert_close(out.float().numpy(), _from_jax_bhtd(j_out), "out")


@pytest.mark.parametrize("d,causal", K456_CASES)
def test_k6_rounding_matches_jax_kernel(d, causal):
    q, k, v, do = (_bf16(x) for x in _draw(1, 2 * TILE, 2, d, seed=53 + d + causal))
    scale = fa.default_scale(d)
    jq, jk, jv, jdo = (_jax_bhtd(x) for x in (q, k, v, do))
    j_out, j_lse = jfa._fwd(jq, jk, jv, scale, causal, TILE, TILE, True)
    _, j_dk, j_dv = jfa._bwd(scale, causal, TILE, TILE, True, (jq, jk, jv, j_out, j_lse), jdo)
    out = torch.from_numpy(_from_jax_bhtd(j_out)).to(torch.bfloat16)
    lse = torch.from_numpy(np.array(j_lse, np.float32)[..., 0])
    dk, dv = emulate_k6(q, k, v, do, lse, fa.attention_delta(out, do), scale, causal)
    _assert_close(dk.float().numpy(), _from_jax_bhtd(j_dk), "dk")
    _assert_close(dv.float().numpy(), _from_jax_bhtd(j_dv), "dv")


@pytest.mark.parametrize("d", [64, 128, 256])
def test_k6_split_is_closer_than_one_rounding(d):
    """The hi/lo split of P and dS lands nearer the f32 plain version
    than one bf16 rounding of them, the design it replaces."""
    q, k, v, do = (_bf16(x) for x in _draw(2, 200, 2, d, seed=71 + d))
    scale = fa.default_scale(d)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, True)
    delta = fa.attention_delta(out_p, do)
    dk_p, dv_p = fa.flash_attention_dkv_plain(q, k, v, do, lse_p, delta, scale, True)
    split = emulate_k6(q, k, v, do, lse_p, delta, scale, True)
    once = emulate_k6(q, k, v, do, lse_p, delta, scale, True, split=False)
    for got_split, got_once, want in zip(split, once, (dk_p, dv_p)):
        err_split = float((got_split.float() - want.float()).abs().sum())
        err_once = float((got_once.float() - want.float()).abs().sum())
        assert err_split < err_once


def test_k4_scale_before_the_product_in_bf16_fails_the_gate():
    """Why K4 scales S in f32 after the product: rounding q * scale to
    bf16 (inexact at D=128, scale 2**-3.5) moves lse past LSE_ATOL."""
    q, k, v = (_bf16(x) for x in _draw(2, 200, 2, 128, seed=329, n=3))
    scale = fa.default_scale(128)
    q_scaled = (q.float() * scale).to(torch.bfloat16)
    _, lse = emulate_k4(q_scaled, k, v, 1.0, True)
    _, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, True)
    assert float((lse - lse_p).abs().max()) > LSE_ATOL


@pytest.mark.parametrize("d", [64, 128])
def test_k6_one_rounding_fails_the_gate(d):
    """Why K6 splits P and dS: one bf16 rounding of them puts dk or dv
    past phase 10's bf16 tolerance on these inputs."""
    q, k, v, do = (_bf16(x) for x in _draw(2, 200, 2, d, seed=7 * d + 201))
    scale = fa.default_scale(d)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, True)
    delta = fa.attention_delta(out_p, do)
    dk, dv = emulate_k6(q, k, v, do, lse_p, delta, scale, True, split=False)
    dk_p, dv_p = fa.flash_attention_dkv_plain(q, k, v, do, lse_p, delta, scale, True)
    assert max(_excess(dk.float(), dk_p.float()), _excess(dv.float(), dv_p.float())) > 0.0


def _carry(b, h, t, d, seed):
    """A non-trivial incoming carry: an acc with its lse, and rows that
    have seen nothing yet (lse NEG_INF, acc 0)."""
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((b, h, t, d)).astype(np.float32)
    lse = rng.standard_normal((b, h, t, 1)).astype(np.float32) + 2.0
    lse[:, 0, : t // 4] = fa.NEG_INF
    acc[:, 0, : t // 4] = 0.0
    return torch.from_numpy(acc), torch.from_numpy(lse)


def _assert_carry_close(got, want, what):
    (acc, lse), (acc_w, lse_w) = got, want
    assert float((lse - lse_w).abs().max()) <= LSE_ATOL, what
    rtol, share = RING_CARRY_TOL
    limit = rtol * acc_w.abs() + share * acc_w.abs().max()
    assert float(((acc - acc_w).abs() - limit).max()) <= 0.0, what


def _bhtd(x):
    return torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2).contiguous()


@pytest.mark.parametrize("t", [100, 200])
@pytest.mark.parametrize("d,causal", K456_CASES)
def test_k5_rounding_matches_plain_version(d, causal, t):
    q, k, v, do = (_bf16(x) for x in _draw(2, t, 2, d, seed=11 * d + t + causal))
    scale = fa.default_scale(d)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, causal)
    delta = fa.attention_delta(out_p, do)
    dq = emulate_k5(q, k, v, do, lse_p, delta, scale, causal)
    dq_p = fa.flash_attention_dq_plain(q, k, v, do, lse_p, delta, scale, causal)
    _assert_close(dq.float(), dq_p.float(), "dq")


@pytest.mark.parametrize("tq,tk", [(100, 200), (200, 130)])
@pytest.mark.parametrize("d,causal", K456_CASES)
def test_k7_rounding_matches_plain_version(d, causal, tq, tk):
    """Tq != Tk, ragged tiles, random positions (any order), a carry
    with rows that have seen nothing."""
    q, k, v = (_bhtd(x) for x in _draw(2, max(tq, tk), 2, d, seed=13 * d + tq + causal, n=3))
    q, k, v = q[:, :, :tq], k[:, :, :tk], v[:, :, :tk]
    rng = np.random.default_rng(d + tq)
    q_pos = torch.from_numpy(rng.integers(0, tq + tk, tq).astype(np.int32))
    k_pos = torch.from_numpy(rng.permutation(tq + tk)[:tk].astype(np.int32))
    acc, lse = _carry(2, 2, tq, d, seed=d + tk)
    scale = fa.default_scale(d)
    got = emulate_k7(q, k, v, acc, lse, q_pos, k_pos, scale, causal)
    want = fa.flash_ring_step_carry_plain(q, k, v, acc.clone(), lse.clone(), q_pos, k_pos,
                                          causal=causal, scale=scale)
    _assert_carry_close(got, want, (d, causal, tq, tk))


@pytest.mark.parametrize("d,causal", K456_CASES)
def test_k5_rounding_matches_jax_kernel(d, causal):
    q, k, v, do = (_bf16(x) for x in _draw(1, 2 * TILE, 2, d, seed=61 + d + causal))
    scale = fa.default_scale(d)
    jq, jk, jv, jdo = (_jax_bhtd(x) for x in (q, k, v, do))
    j_out, j_lse = jfa._fwd(jq, jk, jv, scale, causal, TILE, TILE, True)
    j_dq, _, _ = jfa._bwd(scale, causal, TILE, TILE, True, (jq, jk, jv, j_out, j_lse), jdo)
    out = torch.from_numpy(_from_jax_bhtd(j_out)).to(torch.bfloat16)
    lse = torch.from_numpy(np.array(j_lse, np.float32)[..., 0])
    dq = emulate_k5(q, k, v, do, lse, fa.attention_delta(out, do), scale, causal)
    _assert_close(dq.float().numpy(), _from_jax_bhtd(j_dq), "dq")


# (q shard, K/V source shard, layout) of a ring of 4: an unmasked step,
# the diagonal, a fully masked step, zigzag steps.
RING_STEPS = [(1, 0, "contiguous"), (2, 2, "contiguous"), (0, 3, "contiguous"),
              (0, 3, "zigzag"), (2, 1, "zigzag")]


@pytest.mark.parametrize("q_index,src,layout", RING_STEPS)
@pytest.mark.parametrize("d", [64, 128])
def test_k7_rounding_matches_jax_kernel(d, q_index, src, layout):
    t, n = 2 * TILE, 4
    q, k, v = (_bhtd(x) for x in _draw(1, t, 2, d, seed=83 + d + 7 * q_index + src, n=3))
    q_pos, k_pos = (torch.from_numpy(ring.shard_positions(i, t, n, layout).astype(np.int32))
                    for i in (q_index, src))
    acc, lse = _carry(1, 2, t, d, seed=91 + d)
    scale = fa.default_scale(d)
    j_acc, j_lse = jfa.flash_ring_step_carry(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(acc.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(q_pos.numpy()),
        jnp.asarray(k_pos.numpy()), causal=True, scale=scale, block_q=TILE, block_k=TILE,
        interpret=True)
    got = emulate_k7(q, k, v, acc, lse, q_pos, k_pos, scale, True)
    want = (torch.from_numpy(np.array(j_acc)), torch.from_numpy(np.array(j_lse)))
    _assert_carry_close(got, want, (d, q_index, src, layout))
    if int(k_pos.min()) > int(q_pos.max()):  # fully masked: the carry kept bit for bit
        for new, old in zip(got + want, (acc, lse) * 2):
            assert torch.equal(new, old)


@pytest.mark.parametrize("d", [64, 128])
def test_k5_one_rounding_fails_the_gate(d):
    """Why K5 splits dS: over 8 seeded draws, one bf16 rounding of it puts
    dq past phase 10's bf16 tolerance on some (about half), while the
    split passes them all.  A tolerance holds for every input, so one
    failing draw rejects the design."""
    scale = fa.default_scale(d)
    once, split = [], []
    for i in range(8):
        q, k, v, do = (_bf16(x) for x in _draw(2, 200, 2, d, seed=11 * d + 201 + i))
        out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, True)
        delta = fa.attention_delta(out_p, do)
        dq_p = fa.flash_attention_dq_plain(q, k, v, do, lse_p, delta, scale, True).float()
        for got, rounded in ((once, False), (split, True)):
            dq = emulate_k5(q, k, v, do, lse_p, delta, scale, True, split=rounded)
            got.append(_excess(dq.float(), dq_p))
    assert max(once) > 0.0 and max(split) <= 0.0, (once, split)


def test_k7_scale_before_the_product_in_bf16_fails_the_gate():
    """Why K7 scales S in f32 after the product, as K4 does: rounding q *
    scale to bf16 (inexact at D=128) moves the carry's lse past LSE_ATOL."""
    q, k, v = (_bhtd(x) for x in _draw(2, 200, 2, 128, seed=331, n=3))
    pos = torch.arange(200, dtype=torch.int32)
    acc = torch.zeros((2, 2, 200, 128))
    lse = torch.full((2, 2, 200, 1), fa.NEG_INF)
    scale = fa.default_scale(128)
    q_scaled = (q.float() * scale).to(torch.bfloat16)
    _, lse_got = emulate_k7(q_scaled, k, v, acc, lse, pos, pos, 1.0, True)
    _, lse_p = fa.flash_ring_step_carry_plain(q, k, v, acc.clone(), lse.clone(), pos, pos,
                                              causal=True, scale=scale)
    assert float((lse_got - lse_p).abs().max()) > LSE_ATOL


def test_ring_kernel_inputs_copy_only_what_lacks_alignment():
    """The bf16 K7 build's 16-byte copies need 16-byte-aligned data and
    strides, q's and the K/V block's each: the wrapper copies a bf16
    tensor that lacks them and passes an aligned view (the ring's
    transposed q) through.  The checks need no card."""
    x = torch.zeros((2, 64, 2, 16), dtype=torch.bfloat16)
    q = x.transpose(1, 2)  # the ring's q: a view with its own strides
    k = torch.zeros((2, 2, 64, 16), dtype=torch.bfloat16)
    got = fa._ring_kernel_inputs(q, k, k)
    assert got[0] is q and got[1] is k and got[2] is k
    flat = torch.zeros(2 * 2 * 64 * 16 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(2, 2, 64, 16)  # contiguous, but 2 bytes past an aligned address
    assert off.data_ptr() % 16
    q2, k2, v2 = fa._ring_kernel_inputs(off, off, k)
    for y in (q2, k2, v2):
        assert y.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in y.stride()[:-1])
    assert torch.equal(q2, off) and torch.equal(k2, off)
    f32 = torch.zeros(2 * 2 * 64 * 16 + 1)[1:].view(2, 2, 64, 16)
    assert fa._ring_kernel_inputs(f32, f32, f32)[0] is f32  # f32 takes any alignment


# ----------------------------------------------------------------------
# K8 and K9: the ring step's backward, f32 outputs
# ----------------------------------------------------------------------

#: kF32DoParts of ring_attention.cu: the bf16 parts of an f32 dO.
F32_DO_PARTS = 3


def _parts(x, n):
    """x as n bf16 values (as f32), each the bf16 of what the ones before
    it left (every remainder exact in f32); their sum is x to ~8 n bits."""
    parts, rest = [], x
    for _ in range(n):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return parts


def emulate_k8_k9(q, k, v, do, lse, delta, q_pos, k_pos, scale, causal, once=None,
                  do_parts=F32_DO_PARTS):
    """K8's and K9's arithmetic on ``[B, H, T, D]`` inputs (q, k, v bf16;
    dO bf16 or f32; lse, delta f32 ``[B, H, Tq]``): ``(dq, dk, dv)`` f32.
    ``once`` names one operand, "p", "ds" or "do", rounded once to bf16
    instead of split (the designs the kernels avoid); ``do_parts`` is the
    count of bf16 parts of an f32 dO."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale      # [B, H, queries, keys]
    row = lse[..., None]
    dead = _half_neg_inf(row)
    if causal:
        dead = dead | (k_pos[None, :] > q_pos[:, None])
    p = torch.where(dead, 0.0, torch.exp(s - row))
    split_do = do.dtype == torch.float32 and once != "do"
    do_parts = _parts(do.float(), do_parts if split_do else 1)
    dp = sum(torch.matmul(part, vf.transpose(-1, -2)) for part in do_parts)
    ds = p * (dp - delta[..., None])
    p_parts = _parts(p, 1 if once == "p" else 2)
    ds_parts = _parts(ds, 1 if once == "ds" else 2)
    dq = sum(torch.matmul(part, kf) for part in ds_parts) * scale
    dk = sum(torch.matmul(part.transpose(-1, -2), qf) for part in ds_parts) * scale
    dv = sum(torch.matmul(a.transpose(-1, -2), b) for a in p_parts for b in do_parts)
    return dq, dk, dv


def _f32_share(got, want):
    """The worst |got - want| as a share of phase 13's f32 limit, rtol
    |want| + atol_share max|want| (> 1 fails the gate)."""
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    diff = (got - want).abs()
    limit = ATTN_F32_RTOL * want.abs() + ATTN_F32_ATOL_SHARE * want.abs().max()
    return float(torch.where(diff == 0.0, 0.0, diff / limit).max())


def _ring_stats(q, k, v, do, q_pos, k_steps, scale, causal):
    """The final lse and delta ``[B, H, Tq]`` of a ring over the K/V
    blocks' positions ``k_steps`` (one block, k and v, for every step),
    from the plain K7 steps: delta = sum(dO * out rounded to q's dtype)."""
    b, h, tq, d = q.shape
    acc = torch.zeros((b, h, tq, d))
    lse = torch.full((b, h, tq, 1), fa.NEG_INF)
    for k_pos in k_steps:
        fa.flash_ring_step_carry_plain(q, k, v, acc, lse, q_pos, k_pos, causal=causal,
                                       scale=scale)
    delta = torch.sum(do.float() * acc.to(q.dtype).float(), dim=-1)
    return lse[..., 0], delta


def _ring_case(case, d, dout, seed, dtype=torch.bfloat16, do_scale=1.0):
    """Inputs of a K8/K9 case: ``(q, k, v, do, lse, delta, q_pos, k_pos,
    causal)``, q, k, v in ``dtype``, dO times ``do_scale`` in q's dtype
    (``dout`` "bf16" or "f16") or f32; q is a transposed view, as the ring
    passes it."""
    kind, tq, tk, causal = case
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((2, tq, 2, d)).astype(np.float32))
    q = q.to(dtype).transpose(1, 2)
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, tk, d)).astype(np.float32)).to(
        dtype) for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((2, 2, tq, d)).astype(np.float32)) * do_scale
    do = do.to(dtype) if dout in ("bf16", "f16") else do
    if kind == "random":  # any order; some queries see no key (lse NEG_INF)
        q_pos = torch.from_numpy(rng.integers(0, tq + tk, tq).astype(np.int32))
        k_pos = torch.from_numpy(rng.permutation(tq + tk)[:tk].astype(np.int32))
        steps = [k_pos]
    else:  # shard 2 of a ring of 4 against every source, here source 1 or 2
        layout, src = kind.split()
        pos = [torch.from_numpy(ring.shard_positions(i, tq, 4, layout).astype(np.int32))
               for i in range(4)]
        q_pos, k_pos, steps = pos[2], pos[int(src)], pos
    scale = fa.default_scale(d)
    lse, delta = _ring_stats(q, k, v, do, q_pos, steps, scale, causal)
    return q, k, v, do, lse, delta, q_pos, k_pos, causal


# (kind, Tq, Tk, causal): ring steps of a ragged shard (96 rows: a whole
# and a half tile), the unmasked step and the diagonal, contiguous and
# zigzag; random positions with Tq != Tk, causal and full.
K89_CASES = [("contiguous 1", 96, 96, True), ("contiguous 2", 96, 96, True),
             ("zigzag 1", 96, 96, True), ("zigzag 2", 96, 96, True),
             ("random", 100, 200, True), ("random", 200, 130, True),
             ("random", 130, 100, False)]


@pytest.mark.parametrize("dout", ["bf16", "f32"])
@pytest.mark.parametrize("case", K89_CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-{c[3]}")
@pytest.mark.parametrize("d", [64, 128, 256])
def test_k8_k9_rounding_matches_plain_version(d, case, dout):
    q, k, v, do, lse, delta, q_pos, k_pos, causal = _ring_case(case, d, dout, seed=d + case[1])
    scale = fa.default_scale(d)
    got = emulate_k8_k9(q, k, v, do, lse, delta, q_pos, k_pos, scale, causal)
    want = fa.flash_ring_step_bwd_plain(q, k, v, do, lse, delta, q_pos, k_pos, causal=causal,
                                        scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _f32_share(g, w) <= 1.0, (name, _f32_share(g, w))
    unseen = _half_neg_inf(lse)
    assert torch.equal(got[0][unseen], torch.zeros_like(got[0][unseen]))


@pytest.mark.parametrize("dout", ["bf16", "f32"])
@pytest.mark.parametrize("q_index,src,layout", RING_STEPS)
@pytest.mark.parametrize("d", [64, 128])
def test_k8_k9_rounding_matches_jax_kernel(d, q_index, src, layout, dout):
    """Against JAX's ``flash_ring_step_bwd`` (its Pallas kernels in
    interpret mode) from a whole ring's final lse and delta, so every row
    has seen a key; the bf16 dO enters JAX as its f32 values."""
    t, n = 2 * TILE, 4
    q, k, v = (_bhtd(x) for x in _draw(1, t, 2, d, seed=97 + d + 7 * q_index + src, n=3))
    do = torch.from_numpy(_draw(1, t, 2, d, seed=5 + d, n=1)[0]).transpose(1, 2).contiguous()
    do = do.to(torch.bfloat16) if dout == "bf16" else do
    pos = [torch.from_numpy(ring.shard_positions(i, t, n, layout).astype(np.int32))
           for i in range(n)]
    scale = fa.default_scale(d)
    lse, delta = _ring_stats(q, k, v, do, pos[q_index], pos, scale, True)
    want = jfa.flash_ring_step_bwd(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(do.float().numpy()), jnp.asarray(lse[..., None].numpy()),
        jnp.asarray(delta[..., None].numpy()), jnp.asarray(pos[q_index].numpy()),
        jnp.asarray(pos[src].numpy()), causal=True, scale=scale, block_q=TILE, block_k=TILE,
        interpret=True)
    got = emulate_k8_k9(q, k, v, do, lse, delta, pos[q_index], pos[src], scale, True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _f32_share(g, np.array(w)) <= 1.0, (name, _f32_share(g, np.array(w)))


@pytest.mark.parametrize("once", ["ds", "p", "do"])
def test_k8_k9_one_rounding_fails_the_gate(once):
    """Why K8 and K9 split P and dS in two and an f32 dO in three: over 4
    seeded draws, one bf16 rounding of any of them puts dq, dk or dv past
    ATTN_F32_* on every draw, while the split passes them all."""
    split, rounded = [], []
    for i in range(4):
        q, k, v, do, lse, delta, q_pos, k_pos, causal = _ring_case(
            ("contiguous 1", 96, 96, True), 64, "f32", seed=401 + i)
        scale = fa.default_scale(64)
        want = fa.flash_ring_step_bwd_plain(q, k, v, do, lse, delta, q_pos, k_pos,
                                            causal=causal, scale=scale)
        for shares, rule in ((split, None), (rounded, once)):
            got = emulate_k8_k9(q, k, v, do, lse, delta, q_pos, k_pos, scale, causal, once=rule)
            shares.append(max(_f32_share(g, w) for g, w in zip(got, want)))
    assert min(rounded) > 1.0 and max(split) <= 1.0, (rounded, split)


@pytest.mark.parametrize("dout", ["bf16", "f32"])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
@pytest.mark.parametrize("d", [64, 128])
def test_k8_k9_split_stays_under_half_the_gate(d, layout, dout):
    """The split's margin at phase 13's ring shapes (T_local = 2048, a ring
    of 4, causal; B and H cut to 1 and 2): against the plain versions,
    on every live step of shard 1 from the ring's final lse and delta, the
    worst element of dq, dk and dv stays under half of ATTN_F32_*.  (At
    the full shapes, ``tests/torch_k89_split_margin.py``, an f32 dO in
    two parts reaches 0.56-0.88 of it, in three 0.36-0.44.)"""
    t, n = 2048, 4
    rng = np.random.default_rng(1000 * d + len(layout) + len(dout))
    x = rng.standard_normal((4, 1, 2, t, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(x[i]).to(torch.bfloat16) for i in range(3))
    do = torch.from_numpy(x[3])
    do = do.to(torch.bfloat16) if dout == "bf16" else do
    pos = [torch.from_numpy(ring.shard_positions(i, t, n, layout).astype(np.int32))
           for i in range(n)]
    scale = fa.default_scale(d)
    lse, delta = _ring_stats(q, k, v, do, pos[1], [pos[(1 - s) % n] for s in range(n)], scale,
                             True)
    worst = 0.0
    for k_pos in pos:
        if int(k_pos.min()) > int(pos[1].max()):
            continue  # fully masked: zeros on both sides
        got = emulate_k8_k9(q, k, v, do, lse, delta, pos[1], k_pos, scale, True)
        want = fa.flash_ring_step_bwd_plain(q, k, v, do, lse, delta, pos[1], k_pos,
                                            causal=True, scale=scale)
        worst = max([worst] + [_f32_share(g, w) for g, w in zip(got, want)])
    assert worst < 0.5, worst


def _f32_round_toward_zero(x):
    """f64 -> f32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0.0))
    return f


def test_k9_sums_each_step_in_a_fresh_fragment():
    """Why K8 and K9 sum each step's products in a fresh fragment and add
    it to the running sum in f32: the tensor cores do not round their f32
    sums to nearest, and on the card a dV sum carried through every mma
    of a 2048-query shard (f32 dO: 3 x 2 mma per 16 queries, 768 in all)
    missed ATTN_F32_*.  With each mma's sum rounded toward zero, as a
    model of that, the carried sum misses the gate at the CP slot's width
    (D=64, unmasked step), and the design's, a fresh fragment per 16
    queries rounded toward zero and added to nearest, lands within half
    of it, as the round-to-nearest emulation does."""
    t, n, d = 2048, 4, 64
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 1, 1, t, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(x[i]).to(torch.bfloat16) for i in range(3))
    do = torch.from_numpy(x[3])
    pos = [torch.from_numpy(ring.shard_positions(i, t, n, "contiguous").astype(np.int32))
           for i in range(n)]
    scale = fa.default_scale(d)
    lse, delta = _ring_stats(q, k, v, do, pos[1], [pos[1], pos[0]], scale, True)
    want = fa.flash_ring_step_bwd_plain(q, k, v, do, lse, delta, pos[1], pos[0], causal=True,
                                        scale=scale)[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])[0, 0]  # shard 1 against shard 0: every key unmasked
    p_parts = [a.numpy().astype(np.float64) for a in _parts(p, 2)]
    do_parts = [a[0, 0].numpy().astype(np.float64) for a in _parts(do, F32_DO_PARTS)]
    carried, fresh_sum = np.zeros((t, d), np.float32), np.zeros((t, d), np.float32)
    for q0 in range(0, t, 16):
        fresh = np.zeros((t, d), np.float32)
        for dd in do_parts:
            for pp in p_parts:
                prod = pp[q0:q0 + 16].T @ dd[q0:q0 + 16]  # one mma's products, exact
                carried = _f32_round_toward_zero(carried.astype(np.float64) + prod)
                fresh = _f32_round_toward_zero(fresh.astype(np.float64) + prod)
        fresh_sum += fresh
    assert _f32_share(carried, want[0, 0]) > 1.0
    assert _f32_share(fresh_sum, want[0, 0]) < 0.5


# ----------------------------------------------------------------------
# The f16 builds of K4-K6 (flash_mma.cuh's templates on __half)
# ----------------------------------------------------------------------


def _f16(x):
    return torch.from_numpy(x).to(torch.float16)


def _split_exact(x):
    """An f16 tensor as two bf16 parts (f32 values), hi + lo == x exactly."""
    xf = x.float()
    hi = xf.to(torch.bfloat16).float()
    lo = (xf - hi).to(torch.bfloat16).float()
    assert torch.equal(hi + lo, xf)
    return hi, lo


def _split_f16(x):
    """x = hi + lo in f16 without scaling (hi = f16(x), lo = f16(x - hi)):
    the split the f16 builds avoid."""
    hi = x.to(torch.float16).float()
    return hi, (x - hi).to(torch.float16).float()


def _split_product(a, b, f16_parts):
    """a (f32) times b (f16 tile) as the f16 builds take it: a split in
    bf16 hi/lo, b exactly in two bf16 parts, three products; with
    ``f16_parts``, a split in f16 hi/lo instead, times b itself."""
    if f16_parts:
        a_hi, a_lo = _split_f16(a)
        return torch.matmul(a_hi, b.float()) + torch.matmul(a_lo, b.float())
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split_exact(b)
    return (torch.matmul(a_hi, b_hi) + torch.matmul(a_lo, b_hi)) + torch.matmul(a_hi, b_lo)


def emulate_k5_k6_f16(q, k, v, do, lse, delta, scale, causal, f16_parts=False):
    """K5's and K6's f16 arithmetic: ``(dq, dk, dv)`` f16 ``[B, T, H, D]``.
    S and dP are products of f16 inputs (exact, f32 sums), S scaled after
    the product; P and dS in f32; dQ = dS K, dV = P^T dO and dK = dS^T Q
    by ``_split_product``."""
    t = q.shape[1]
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if causal:
        pos = torch.arange(t)
        s = torch.where(pos[None, :] > pos[:, None], fa.NEG_INF, s)
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.matmul(dot.float(), vt.float().transpose(-1, -2)) - delta[..., None])
    dq = _split_product(ds, kt, f16_parts) * scale
    dk = _split_product(ds.transpose(-1, -2), qt, f16_parts) * scale
    dv = _split_product(p.transpose(-1, -2), dot, f16_parts)
    return tuple(x.to(torch.float16).transpose(1, 2).contiguous() for x in (dq, dk, dv))


def _f16_excess(got, want):
    """Largest amount by which |got - want| passes phase 51's f16 rule (<=
    0 passes)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    limit = np.maximum(ATTN_F16_RTOL * np.abs(want), F16_ULP_FLOOR)
    limit = limit + ATTN_F16_ATOL_SHARE * np.abs(want).max()
    return float((np.abs(got - want) - limit).max())


def _f16_inputs(b, t, h, d, seed, do_scale):
    q, k, v, do = (_f16(x) for x in _draw(b, t, h, d, seed))
    return q, k, v, (do.float() * do_scale).to(torch.float16)


@pytest.mark.parametrize("d,causal", K456_CASES)
def test_k4_f16_rounding_matches_plain_version(d, causal):
    q, k, v, _ = _f16_inputs(2, 100, 2, d, seed=17 * d + causal, do_scale=1.0)
    scale = fa.default_scale(d)
    out, lse = emulate_k4(q, k, v, scale, causal)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, causal)
    assert out.dtype == out_p.dtype == torch.float16
    assert float((lse - lse_p).abs().max()) <= LSE_ATOL
    assert _f16_excess(out.float(), out_p.float()) <= 0.0


def _f16_backward_case(d, causal, do_scale, seed, t=200):
    q, k, v, do = _f16_inputs(2, t, 2, d, seed, do_scale)
    scale = fa.default_scale(d)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, causal)
    delta = fa.attention_delta(out_p, do)
    want = (fa.flash_attention_dq_plain(q, k, v, do, lse_p, delta, scale, causal),
            *fa.flash_attention_dkv_plain(q, k, v, do, lse_p, delta, scale, causal))
    return (q, k, v, do, lse_p, delta, scale), want


@pytest.mark.parametrize("do_scale", F16_DO_SCALES)
@pytest.mark.parametrize("d,causal", [(64, True), (64, False), (256, True)])
def test_k5_k6_f16_split_matches_plain_version(d, causal, do_scale):
    """The f16 builds' backward against the plain versions at phase 51's
    rule, dO at unit scale and at the LM's 2**-20, and no gradient
    flushed to zero where the plain version's is not."""
    args, want = _f16_backward_case(d, causal, do_scale, seed=19 * d + causal)
    got = emulate_k5_k6_f16(*args, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _f16_excess(a.float(), b.float()) <= 0.0, name
        assert f16_zero_flushes(a, b) == 0, name


@pytest.mark.parametrize("d", [64, 256])
def test_k5_k6_f16_split_matches_jax_kernel(d):
    """The same at dO x 2**-20, causal, against JAX's f16 kernels
    (interpret mode): dq, dk, dv of ``_bwd`` on its own forward."""
    q, k, v, do = _f16_inputs(1, 2 * TILE, 2, d, seed=23 + d, do_scale=F16_DO_SCALES[-1])
    scale = fa.default_scale(d)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jnp.float16).transpose(0, 2, 1, 3)
                       for x in (q, k, v, do))
    j_out, j_lse = jfa._fwd(jq, jk, jv, scale, True, TILE, TILE, True)
    want = jfa._bwd(scale, True, TILE, TILE, True, (jq, jk, jv, j_out, j_lse), jdo)
    out = torch.from_numpy(_from_jax_bhtd(j_out)).to(torch.float16)
    lse = torch.from_numpy(np.array(j_lse, np.float32)[..., 0])
    got = emulate_k5_k6_f16(q, k, v, do, lse, fa.attention_delta(out, do), scale, True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = torch.from_numpy(_from_jax_bhtd(b))
        assert _f16_excess(a.float(), b) <= 0.0, name
        assert f16_zero_flushes(a, b) == 0, name


def test_k5_k6_unscaled_f16_split_fails_at_the_path_scale():
    """Why the f16 builds split in bf16: P and dS split into f16 hi and lo
    without scaling meet the rule at unit scale, but at dO x 2**-20 dS
    lies below f16's range, and dq and dk flush to zero."""
    for do_scale, fails in zip(F16_DO_SCALES, (False, True)):
        args, want = _f16_backward_case(64, True, do_scale, seed=29)
        got = emulate_k5_k6_f16(*args, True, f16_parts=True)
        failed = [name for name, a, b in zip(("dq", "dk", "dv"), got, want)
                  if _f16_excess(a.float(), b.float()) > 0.0 or f16_zero_flushes(a, b)]
        assert bool(failed) == fails, (do_scale, failed)


# ----------------------------------------------------------------------
# The f16 builds of K7-K9 (ring_mma.cuh's templates on __half)
# ----------------------------------------------------------------------


def emulate_k8_k9_f16(q, k, v, do, lse, delta, q_pos, k_pos, scale, causal, f16_parts=False):
    """K8's and K9's f16 arithmetic on ``[B, H, T, D]`` inputs (q, k, v
    f16; dO f16 or f32; lse, delta f32 ``[B, H, Tq]``): ``(dq, dk, dv)``
    f32.  S and dP on an f16 dO are exact f16 products (f32 sums); an
    f32 dO's three bf16 parts meet f16 V's two exact bf16 parts, every
    cross product kept (their sum is each part times V); P and dS in
    f32; dQ = dS K, dK = dS^T Q and, on an f16 dO, dV = P^T dO by
    ``_split_product`` (``f16_parts``: P and dS split in f16 instead, the
    design the builds avoid); on an f32 dO dV takes P's two parts against
    each of dO's three."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    row = lse[..., None]
    dead = _half_neg_inf(row)
    if causal:
        dead = dead | (k_pos[None, :] > q_pos[:, None])
    p = torch.where(dead, 0.0, torch.exp(s - row))
    if do.dtype == torch.float16:
        do_parts = [do.float()]
        dp = torch.matmul(do_parts[0], vf.transpose(-1, -2))
    else:
        do_parts = _parts(do.float(), F32_DO_PARTS)
        v_hi, v_lo = _split_exact(v)
        dp = sum(torch.matmul(part, vp.transpose(-1, -2)) for part in do_parts
                 for vp in (v_hi, v_lo))
    ds = p * (dp - delta[..., None])
    dq = _split_product(ds, k, f16_parts) * scale
    dk = _split_product(ds.transpose(-1, -2), q, f16_parts) * scale
    if do.dtype == torch.float16:
        dv = _split_product(p.transpose(-1, -2), do, f16_parts)
    else:
        dv = sum(torch.matmul(a.transpose(-1, -2), b) for a in _split(p) for b in do_parts)
    return dq, dk, dv


def _f16_ring_excess(got, want):
    """Largest amount by which |got - want| passes phase 52's rule on the
    ring's f32 outputs from f16 inputs (<= 0 passes): phase 51's rtol
    and share, without its floor of two f16 subnormal steps, which f32
    outputs do not have."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    limit = ATTN_F16_RTOL * np.abs(want) + ATTN_F16_ATOL_SHARE * np.abs(want).max()
    return float((np.abs(got - want) - limit).max())


def _assert_f16_ring_close(got, want, what):
    """Phase 52's rule, and no entry zero where the plain version's is
    not (f16_zero_flushes)."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = torch.from_numpy(np.array(b, np.float32))
        assert _f16_ring_excess(a, b) <= 0.0, (what, name, _f16_ring_excess(a, b))
        assert f16_zero_flushes(a, b) == 0, (what, name, f16_zero_flushes(a, b))


#: (kind, Tq, Tk, causal) of the f16 K8/K9 cases: K89_CASES' unmasked
#: step, a zigzag step, and random positions with Tq != Tk.
F16_K89_CASES = [K89_CASES[0], K89_CASES[3], K89_CASES[4]]


@pytest.mark.parametrize("tq,tk", [(100, 200), (200, 130)])
@pytest.mark.parametrize("d,causal", K456_CASES)
def test_k7_f16_rounding_matches_plain_version(d, causal, tq, tk):
    """K7's f16 build: P rounded to f16 per 64 keys; Tq != Tk, random
    positions, a carry with rows that have seen nothing; the carry at
    phase 52's rule, lse at LSE_ATOL."""
    x = _draw(2, max(tq, tk), 2, d, seed=37 * d + tq + causal, n=3)
    q, k, v = (torch.from_numpy(a).to(torch.float16).transpose(1, 2).contiguous() for a in x)
    q, k, v = q[:, :, :tq], k[:, :, :tk], v[:, :, :tk]
    rng = np.random.default_rng(d + tq + 1)
    q_pos = torch.from_numpy(rng.integers(0, tq + tk, tq).astype(np.int32))
    k_pos = torch.from_numpy(rng.permutation(tq + tk)[:tk].astype(np.int32))
    acc, lse = _carry(2, 2, tq, d, seed=d + tk + 1)
    scale = fa.default_scale(d)
    got = emulate_k7(q, k, v, acc, lse, q_pos, k_pos, scale, causal)
    want = fa.flash_ring_step_carry_plain(q, k, v, acc.clone(), lse.clone(), q_pos, k_pos,
                                          causal=causal, scale=scale)
    assert float((got[1] - want[1]).abs().max()) <= LSE_ATOL
    assert _f16_ring_excess(got[0], want[0]) <= 0.0


@pytest.mark.parametrize("q_index,src,layout", RING_STEPS)
def test_k7_f16_rounding_matches_jax_kernel(q_index, src, layout):
    """Against JAX's f16 ``flash_ring_step_carry`` (interpret mode):
    both layouts' positions, a fully masked step's carry bit for bit."""
    t, n, d = 2 * TILE, 4, 64
    x = _draw(1, t, 2, d, seed=131 + 7 * q_index + src, n=3)
    q, k, v = (torch.from_numpy(a).to(torch.float16).transpose(1, 2).contiguous() for a in x)
    q_pos, k_pos = (torch.from_numpy(ring.shard_positions(i, t, n, layout).astype(np.int32))
                    for i in (q_index, src))
    acc, lse = _carry(1, 2, t, d, seed=139)
    scale = fa.default_scale(d)
    j_acc, j_lse = jfa.flash_ring_step_carry(
        *(jnp.asarray(a.float().numpy(), jnp.float16) for a in (q, k, v)),
        jnp.asarray(acc.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(q_pos.numpy()),
        jnp.asarray(k_pos.numpy()), causal=True, scale=scale, block_q=TILE, block_k=TILE,
        interpret=True)
    got = emulate_k7(q, k, v, acc, lse, q_pos, k_pos, scale, True)
    want = (torch.from_numpy(np.array(j_acc)), torch.from_numpy(np.array(j_lse)))
    assert float((got[1] - want[1]).abs().max()) <= LSE_ATOL
    assert _f16_ring_excess(got[0], want[0]) <= 0.0
    if int(k_pos.min()) > int(q_pos.max()):  # fully masked: the carry kept bit for bit
        for new, old in zip(got + want, (acc, lse) * 2):
            assert torch.equal(new, old)


@pytest.mark.parametrize("do_scale", F16_DO_SCALES)
@pytest.mark.parametrize("dout", ["f16", "f32"])
@pytest.mark.parametrize("case", F16_K89_CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-{c[3]}")
@pytest.mark.parametrize("d", [64, 256])
def test_k8_k9_f16_split_matches_plain_version(d, case, dout, do_scale):
    """K8's and K9's f16 builds against the plain versions at phase 52's
    rule, dO (f16, or f32 in three bf16 parts) at unit scale and at the
    LM's 2**-20, no entry flushed to zero; a row that saw no key gets no
    gradient."""
    q, k, v, do, lse, delta, q_pos, k_pos, causal = _ring_case(
        case, d, dout, seed=3 * d + case[1], dtype=torch.float16, do_scale=do_scale)
    scale = fa.default_scale(d)
    got = emulate_k8_k9_f16(q, k, v, do, lse, delta, q_pos, k_pos, scale, causal)
    want = fa.flash_ring_step_bwd_plain(q, k, v, do, lse, delta, q_pos, k_pos, causal=causal,
                                        scale=scale)
    _assert_f16_ring_close(got, want, (d, case, dout, do_scale))
    unseen = _half_neg_inf(lse)
    assert torch.equal(got[0][unseen], torch.zeros_like(got[0][unseen]))


@pytest.mark.parametrize("dout", ["f16", "f32"])
@pytest.mark.parametrize("q_index,src,layout", RING_STEPS)
def test_k8_k9_f16_split_matches_jax_kernel(q_index, src, layout, dout):
    """Against JAX's f16 ``flash_ring_step_bwd`` (interpret mode) at dO x
    2**-20, from a whole ring's final lse and delta; the f16 dO enters
    JAX as its f32 values, as JAX's ring hands its kernels dO in f32."""
    t, n, d = 2 * TILE, 4, 64
    x = _draw(1, t, 2, d, seed=151 + 7 * q_index + src, n=3)
    q, k, v = (torch.from_numpy(a).to(torch.float16).transpose(1, 2).contiguous() for a in x)
    do = torch.from_numpy(_draw(1, t, 2, d, seed=157, n=1)[0]).transpose(1, 2).contiguous()
    do = do * F16_DO_SCALES[-1]
    do = do.to(torch.float16) if dout == "f16" else do
    pos = [torch.from_numpy(ring.shard_positions(i, t, n, layout).astype(np.int32))
           for i in range(n)]
    scale = fa.default_scale(d)
    lse, delta = _ring_stats(q, k, v, do, pos[q_index], pos, scale, True)
    want = jfa.flash_ring_step_bwd(
        *(jnp.asarray(a.float().numpy(), jnp.float16) for a in (q, k, v)),
        jnp.asarray(do.float().numpy()), jnp.asarray(lse[..., None].numpy()),
        jnp.asarray(delta[..., None].numpy()), jnp.asarray(pos[q_index].numpy()),
        jnp.asarray(pos[src].numpy()), causal=True, scale=scale, block_q=TILE, block_k=TILE,
        interpret=True)
    got = emulate_k8_k9_f16(q, k, v, do, lse, delta, pos[q_index], pos[src], scale, True)
    _assert_f16_ring_close(got, want, (q_index, src, layout, dout))


def test_k8_k9_unscaled_f16_split_fails_at_the_path_scale():
    """Why K8's and K9's f16 builds split in bf16: P and dS split into
    f16 hi and lo without scaling meet phase 52's rule at unit scale,
    but at dO x 2**-20 dS lies below f16's normal range, where its
    subnormal step (6e-8) is a large part of each entry, and dq, dk and
    dv leave the rule."""
    for do_scale, fails in zip(F16_DO_SCALES, (False, True)):
        q, k, v, do, lse, delta, q_pos, k_pos, causal = _ring_case(
            K89_CASES[0], 64, "f16", seed=163, dtype=torch.float16, do_scale=do_scale)
        scale = fa.default_scale(64)
        got = emulate_k8_k9_f16(q, k, v, do, lse, delta, q_pos, k_pos, scale, causal,
                                f16_parts=True)
        want = fa.flash_ring_step_bwd_plain(q, k, v, do, lse, delta, q_pos, k_pos,
                                            causal=causal, scale=scale)
        failed = [name for name, a, b in zip(("dq", "dk", "dv"), got, want)
                  if _f16_ring_excess(a, b) > 0.0 or f16_zero_flushes(a, b)]
        assert bool(failed) == fails, (do_scale, failed)
