"""The rounding design of the bf16 tensor-core builds of K4 and K6
(``flash_fwd_mma_kernel`` and ``flash_dkv_mma_kernel`` in
``elasticdl_tpu_torch/ops/csrc/flash_attention.cu``), emulated in
PyTorch on the CPU and held to the port's plain versions and to the JAX
kernels in interpret mode, at the tolerances ``chip_smoke.py`` holds the
kernels to on the card.

What the emulation repeats of the kernels' arithmetic (the tensor cores
multiply bf16 operands exactly and sum in f32, which an f32 matmul of the
upcast operands does up to summation order):

- K4: S = Q K^T from the unscaled bf16 q, multiplied by ``scale`` in f32
  after the product; the online softmax per 64-key tile, l summing the
  unrounded p, P rounded to bf16 before P V.
- K6: S^T = K Q^T scaled in f32 after the product, P and dS in f32, then
  dV = P^T dO and dK = dS^T Q with P and dS each split into hi = bf16(x)
  and lo = bf16(x - hi), two products summed in f32.

Inputs are seeded numpy draws at D=64 and D=128 (the kernels' two
builds), causal and full; T is ragged (not a multiple of the 64-row
tile) against the plain versions and a multiple of 64 against JAX, whose
kernels need whole blocks.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_ATOL_SHARE, ATTN_RTOL, LSE_ATOL
from elasticdl_tpu_torch.ops import flash_attention as fa

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
    """K4's arithmetic: ``(out [B, T, H, D] bf16, lse [B, H, T] f32)``."""
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
        acc = acc * corr[..., None] + torch.matmul(p.to(torch.bfloat16).float(), vf[:, :, k0:k1])
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).to(torch.bfloat16).transpose(1, 2).contiguous()
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


@pytest.mark.parametrize("t", [100, 200])
@pytest.mark.parametrize("d,causal", CASES)
def test_k4_rounding_matches_plain_version(d, causal, t):
    q, k, v = (_bf16(x) for x in _draw(2, t, 2, d, seed=d + t + causal, n=3))
    scale = fa.default_scale(d)
    out, lse = emulate_k4(q, k, v, scale, causal)
    out_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, scale, causal)
    assert float((lse - lse_p).abs().max()) <= LSE_ATOL
    _assert_close(out.float(), out_p.float(), "out")


@pytest.mark.parametrize("t", [100, 200])
@pytest.mark.parametrize("d,causal", CASES)
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


@pytest.mark.parametrize("d,causal", CASES)
def test_k4_rounding_matches_jax_kernel(d, causal):
    q, k, v = (_bf16(x) for x in _draw(1, 2 * TILE, 2, d, seed=31 + d + causal, n=3))
    scale = fa.default_scale(d)
    j_out, j_lse = jfa._fwd(*(_jax_bhtd(x) for x in (q, k, v)), scale, causal, TILE, TILE,
                            True)
    out, lse = emulate_k4(q, k, v, scale, causal)
    assert float(np.abs(lse.numpy() - np.asarray(j_lse)[..., 0]).max()) <= LSE_ATOL
    _assert_close(out.float().numpy(), _from_jax_bhtd(j_out), "out")


@pytest.mark.parametrize("d,causal", CASES)
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


@pytest.mark.parametrize("d", [64, 128])
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
