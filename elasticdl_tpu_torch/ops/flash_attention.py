"""Flash attention: the port of the Pallas kernels of
``elasticdl_tpu/ops/flash_attention.py``.  Six kernels, each a
hand-written CUDA kernel; three for one device, in
``csrc/flash_attention.cu``:

``flash_attention_fwd``  K4, replaces ``_fwd_kernel``: online-softmax
                         attention; ``(out, lse)``.
``flash_attention_dq``   K5, replaces ``_dq_kernel``: dQ from q, k, v,
                         dO, lse and delta.
``flash_attention_dkv``  K6, replaces ``_dkv_kernel``: dK and dV.

and three for one step of the context-parallel ring
(``parallel/ring_attention.py``), in ``csrc/ring_attention.cu`` (both
files take their helpers from ``csrc/flash_common.cuh``), with the JAX
functions' signatures and their ``[B, H, T, D]`` layout, the causal mask
read from position arrays:

``flash_ring_step_carry``  K7, replaces ``_fwd_ring_carry_kernel``: the
                           step's forward, combined in lse space with the
                           ``(acc, lse)`` carry, which it updates in place.
``flash_ring_step_dq``     K8, replaces ``_dq_ring_kernel``: the step's
                           f32 dq contribution.
``flash_ring_step_dkv``    K9, replaces ``_dkv_ring_kernel``: f32 dk and
                           dv of the rotating block.

``flash_ring_step_bwd`` is the JAX function of that name: K8 then K9.

``flash_attention`` is the public function, a ``torch.autograd.Function``
with the JAX ``custom_vjp``'s split: the forward launches K4 and saves
``out`` and ``lse``; the backward forms ``delta = sum(dO * out)`` in f32
in plain PyTorch (as the JAX ``_bwd`` does outside its kernels), then
launches K5 and K6.

Each kernel function dispatches on the device of the tensors it is given:
on ``cuda`` it launches its kernel (or raises), on ``cpu`` it runs its
``*_plain`` version, which follows the kernel's formulas and roundings
(q upcast and scaled in f32 before Q K^T, masked scores ``NEG_INF``, P
rounded to v's dtype before P V, f32 backward, dq and dk scaled at the
end).  The tests hold the plain versions against the JAX package;
``chip_smoke.py`` holds the kernels against them on the card.  Nothing
falls back from a kernel to its plain version.

Two designs stand behind the kernels, chosen by dtype.  For bf16 inputs
K4-K9 run their products on the tensor cores (``mma.sync``, bf16
operands, f32 sums), bounded by the card's bf16 rate: S is computed from
the unscaled bf16 q and scaled in f32 after the product, P is rounded to
bf16 per ``BLOCK`` keys, and K5, K6, K8 and K9 feed P and dS to their
products split as ``hi = bf16(x)``, ``lo = bf16(x - hi)``, since the
reference keeps them f32 and one bf16 rounding of them would put dq and
dk past the kernels' tolerance; K8 and K9 split an f32 dO so too
(``tests/test_torch_flash_mma_rounding.py`` emulates these rules).  f32
inputs run f32 FMA kernels on the CUDA cores.  float16 inputs take K4-K9
on the tensor cores with the bf16 builds' rules in f16 (S, dP and P V
native f16 products, P rounded to f16), except that beside the split P
or dS the f16 operand is itself split exactly into two bf16 parts: bf16
keeps f32's exponent range, which the gradients of a long batch need
(f16's normal range ends at 6.1e-5).  K8 and K9 read an f16 dO beside f16
q as it is, and an f32 dO in three bf16 parts, each meeting f16 V's two
(``csrc/ring_mma.cuh``).  Any other dtype raises ``TypeError``.

Layouts: q, k, v, out and the gradients are ``[B, T, H, D]`` as in the
JAX function; the kernels read q, k, v through their strides, so the
query/key/value slices of a fused projection go in without a copy.
``lse`` and ``delta`` are ``[B, H, T]`` f32.  K4-K9 take f32, bf16 or
f16 inputs and any T >= 1 (a ragged last tile is masked); their tile is
``BLOCK`` queries by ``BLOCK`` keys.

Head dims: K4-K6 take any head_dim up to ``MAX_HEAD_DIM`` (256), in
builds for 64, 128 and 256 columns, each staging the columns past
head_dim as zeros.  The JAX kernels take any multiple of 8 (and JAX's LM
computes other head dims blockwise), so a head_dim that is not a
multiple of 8 is padded here with zero columns up to the next one: zero
columns of q and k change no score, zero columns of v give zero output
columns, and the wrappers slice out, dq, dk and dv back (``scale`` is
the caller's, from the true head_dim).  At 256 a warp's 16 rows of an
f32 accumulator take 128 registers a thread, so K4 and K5 read their Q
(and dO) fragments from shared memory at each step and K6 gives each 16
key rows two warps, each owning half of the columns of dK and dV; the
f32 builds of K5 and K6 share one shared-memory tile between two
operands (``csrc/flash_attention.cu`` sets out what bounds each build).
Above 256 they raise: that is ``wgmma``'s widest N and the widest build.
The ring kernels K7-K9 (``csrc/ring_attention.cu``; their tensor-core
builds in ``csrc/ring_mma.cuh``, instantiated for f16 in
``csrc/ring_attention_f16.cu``) take the same head dims, up to
``MAX_HEAD_DIM``, in the same three builds and through the same pad: the
step wrappers pad q, the K/V block, dO and the ``acc`` carry, and slice
``acc``, dq, dk and dv back; the CP path pads once, before the ring
(``parallel/ring_attention.py``).  At 256 K7 and K8 read their Q (and
dO) fragments at each step and K9 gives each 16 key rows a pair of
warps, as K4-K6 do; the bf16 and f16 K8 and K9 stage one tile set
instead of two beside an f32 dO, whose three bf16 parts fill the rest of
a block's shared memory.  Above 256 they raise.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
RING_KERNELS = ("flash_ring_step_carry", "flash_ring_step_dq", "flash_ring_step_dkv")

NEG_INF = -1e30
#: The CUDA kernels' tile: BLOCK queries by BLOCK keys.
BLOCK = 64
#: The widest head_dim of K4-K9 (their widest build).
MAX_HEAD_DIM = 256
#: Query rows per step of the plain backward (bounds its [B, H, rows, T]
#: score slab).
PLAIN_BWD_ROWS = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: What the ring kernels K7-K9 are built for.
_RING_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_launch_lock = threading.Lock()
_launches: Dict[str, int] = {name: 0 for name in KERNELS + RING_KERNELS}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name.  Only a
    wrapper that launches its CUDA kernel counts; the plain versions
    never do."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


def _count_launch(name: str) -> None:
    with _launch_lock:  # noqa-invariant: trace-purity (the launch counter chip_smoke.py reads: an uncontended lock around one integer add, after the launch is queued)
        _launches[name] += 1


def default_scale(head_dim: int) -> float:
    """``1/sqrt(D)`` rounded to f32, as the kernels receive it."""
    return float(np.float32(1.0 / math.sqrt(head_dim)))


def _route(x: torch.Tensor) -> str:
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel for device {x.device}")


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one [B, T, H, D] shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    _check_dtypes_devices(q, k, v)


def _check_dtypes_devices(q, k, v) -> None:
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")


def _check_kernel_dtype(q) -> None:
    """K4-K6 take f32, bf16 or f16."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the flash-attention kernels take float32, bfloat16 or float16, got "
                        f"{q.dtype}")


def _check_ring_kernel_dtype(q) -> None:
    """K7-K9 take f32, bf16 or f16: any other dtype raises (no build takes
    it, and nothing falls back to the plain versions)."""
    if q.dtype not in _RING_DTYPES:
        raise TypeError(f"the ring-step kernels K7-K9 are not built for {q.dtype} (they take "
                        f"float32, bfloat16 or float16)")


def _check_head_dim(q) -> None:
    """K4-K9 take head_dim up to MAX_HEAD_DIM (the wrappers pad one that
    is not a multiple of 8)."""
    d = q.shape[-1]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(
            f"the flash-attention kernels take head_dim up to {MAX_HEAD_DIM} (one that is "
            f"not a multiple of 8 padded with zero columns), got {d}"
        )


def _pad8(x: torch.Tensor) -> torch.Tensor:
    """``x`` with zero columns appended up to a head_dim that is a
    multiple of 8 (``x`` itself when it already is one)."""
    pad = -x.shape[-1] % 8
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _aligned16(x: torch.Tensor) -> bool:
    """16-byte aligned data and row strides, as the tensor-core kernels'
    16-byte copies of 2-byte elements (bf16, f16) need (f32 inputs take
    any alignment)."""
    if x.element_size() != 2:
        return True
    return x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:-1])


def _kernel_inputs(q, k, v):
    """Check what the CUDA kernels take; q, k, v with one set of strides,
    a contiguous last dimension, a head_dim padded to a multiple of 8
    and, in bf16 and f16, 16-byte alignment (copied only when they lack
    it)."""
    _check_kernel_dtype(q)
    _check_head_dim(q)
    q, k, v = _pad8(q), _pad8(k), _pad8(v)
    if (not (q.stride() == k.stride() == v.stride()) or q.stride(-1) != 1
            or not all(_aligned16(x) for x in (q, k, v))):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if not all(_aligned16(x) for x in (q, k, v)):
            q, k, v = q.clone(), k.clone(), v.clone()
    return q, k, v


def _kernel_dout(do, q):
    """dO in (padded) q's dtype and head_dim, contiguous and, in bf16 and
    f16, 16-byte aligned."""
    do = _pad8(do.to(q.dtype)).contiguous()
    return do if _aligned16(do) else do.clone()


def _unpad(x: torch.Tensor, d: int) -> torch.Tensor:
    """A kernel's output back to head_dim ``d`` (contiguous)."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch(name: str, fn, *tensors_and_args) -> None:
    from elasticdl_tpu_torch.ops import _build

    code = getattr(_build.library(), fn)(*tensors_and_args)
    _build.check(code, name)
    _count_launch(name)


def _shape_args(q: torch.Tensor, scale: float, causal: bool):
    b, t, h, d = q.shape
    sb, st, sh, _ = q.stride()
    return (b, h, t, d, sb, st, sh, float(np.float32(scale)), int(bool(causal)),
            _DTYPE_CODE[q.dtype], _stream())


# ----------------------------------------------------------------------
# K4: forward
# ----------------------------------------------------------------------


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, causal: bool,
    block_k: int = BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: the kernel's online softmax over
    key blocks of ``block_k``.  -> ``(out [B, T, H, D] in q's dtype, lse
    [B, H, T] f32)``."""
    b, t, h, d = q.shape
    scale = float(np.float32(scale))
    qs = q.transpose(1, 2).to(torch.float32) * scale        # [B, H, T, D]
    kf = k.transpose(1, 2).to(torch.float32)
    vt = v.transpose(1, 2)
    pos = torch.arange(t, device=q.device)
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, block_k):
        k1 = min(t, k0 + block_k)
        s = torch.matmul(qs, kf[:, :, k0:k1].transpose(-1, -2))  # [B, H, T, bk]
        if causal:
            s = torch.where(pos[k0:k1][None, :] > pos[:, None], NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(-1)
        pv = torch.matmul(p.to(v.dtype).to(torch.float32),
                          vt[:, :, k0:k1].to(torch.float32))
        acc = acc * correction[..., None] + pv
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).to(q.dtype).transpose(1, 2).contiguous()
    return out, m + torch.log(l_safe)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, causal: bool,
    block_k: int = BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(out [B, T, H, D], lse [B, H, T] f32)``.  On the card the
    kernel's tile is ``BLOCK``; ``block_k`` must be ``BLOCK`` there.  bf16
    and f16 run on the tensor cores (S = Q K^T from the unscaled q,
    scaled in f32; P rounded to the input type per ``BLOCK`` keys), f32
    on the CUDA cores."""
    _check_qkv(q, k, v)
    if _route(q) == "plain":
        return flash_attention_fwd_plain(q, k, v, scale, causal, block_k)
    if block_k != BLOCK:
        raise ValueError(f"the flash-attention kernels are built for {BLOCK}-wide tiles, "
                         f"got block_k={block_k}")
    d = q.shape[-1]
    q, k, v = _kernel_inputs(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    b, t, h, _ = q.shape
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel():
        with torch.cuda.device(q.device):
            _launch("flash_attention_fwd", "edl_flash_fwd", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), lse.data_ptr(), *_shape_args(q, scale, causal))
    return _unpad(out, d), lse


# ----------------------------------------------------------------------
# K5, K6: backward
# ----------------------------------------------------------------------


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32, ``[B, H, T]``: the JAX
    ``_bwd``'s softmax-jacobian diagonal term, formed outside the
    kernels."""
    delta = torch.sum(do.to(torch.float32) * out.to(torch.float32), dim=-1)
    return delta.transpose(1, 2).contiguous()


def _bwd_rows(q, k, v, do, lse, delta, scale, causal, r0, r1):
    """P and dS of query rows [r0, r1) against every key, f32 [B, H,
    rows, T], with the kernels' formulas: s = (q * scale) . k, masked to
    NEG_INF; P = exp(s - lse); dS = P * (dO . v - delta)."""
    t = q.shape[1]
    scale = float(np.float32(scale))
    qs = q[:, r0:r1].transpose(1, 2).to(torch.float32) * scale
    kf = k.transpose(1, 2).to(torch.float32)
    s = torch.matmul(qs, kf.transpose(-1, -2))
    if causal:
        pos = torch.arange(t, device=q.device)
        s = torch.where(pos[None, :] > pos[r0:r1, None], NEG_INF, s)
    p = torch.exp(s - lse[:, :, r0:r1, None])
    dp = torch.matmul(do[:, r0:r1].transpose(1, 2).to(torch.float32),
                      v.transpose(1, 2).to(torch.float32).transpose(-1, -2))
    return p, p * (dp - delta[:, :, r0:r1, None])


def flash_attention_dq_plain(q, k, v, do, lse, delta, scale, causal,
                             rows: int = PLAIN_BWD_ROWS) -> torch.Tensor:
    """Plain PyTorch version of K5: ``dq = scale * dS K`` in q's dtype."""
    t = q.shape[1]
    kf = k.transpose(1, 2).to(torch.float32)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for r0 in range(0, t, rows):
        r1 = min(t, r0 + rows)
        _, ds = _bwd_rows(q, k, v, do, lse, delta, scale, causal, r0, r1)
        dq[:, r0:r1] = (torch.matmul(ds, kf) * float(np.float32(scale))).to(q.dtype).transpose(1, 2)
    return dq


def flash_attention_dkv_plain(q, k, v, do, lse, delta, scale, causal,
                              rows: int = PLAIN_BWD_ROWS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6: ``dk = scale * dS^T Q`` and ``dv =
    P^T dO``, f32 sums cast to k's / v's dtype."""
    b, t, h, d = q.shape
    dk = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    for r0 in range(0, t, rows):
        r1 = min(t, r0 + rows)
        p, ds = _bwd_rows(q, k, v, do, lse, delta, scale, causal, r0, r1)
        dv += torch.matmul(p.transpose(-1, -2), do[:, r0:r1].transpose(1, 2).to(torch.float32))
        dk += torch.matmul(ds.transpose(-1, -2), q[:, r0:r1].transpose(1, 2).to(torch.float32))
    dk = (dk * float(np.float32(scale))).to(k.dtype).transpose(1, 2).contiguous()
    return dk, dv.to(v.dtype).transpose(1, 2).contiguous()


def _check_bwd(q, do, lse, delta) -> None:
    b, t, h, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"dO shape {tuple(do.shape)} != q's {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (b, h, t) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [B, H, T] = {(b, h, t)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device} but q on {q.device}")


def flash_attention_dq(q, k, v, do, lse, delta, scale, causal) -> torch.Tensor:
    """K5: dq ``[B, T, H, D]`` in q's dtype.  bf16 and f16 run on the
    tensor cores (S and dP by mma from the unscaled q and dO, S scaled in
    f32; dS split into two bf16 terms before dQ += dS K, an f16 K into two
    bf16 parts beside it); f32 on the CUDA cores."""
    _check_qkv(q, k, v)
    _check_bwd(q, do, lse, delta)
    if _route(q) == "plain":
        return flash_attention_dq_plain(q, k, v, do, lse, delta, scale, causal)
    d = q.shape[-1]
    q, k, v = _kernel_inputs(q, k, v)
    do = _kernel_dout(do, q)
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        with torch.cuda.device(q.device):
            _launch("flash_attention_dq", "edl_flash_dq", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), *_shape_args(q, scale, causal))
    return _unpad(dq, d)


def flash_attention_dkv(q, k, v, do, lse, delta, scale, causal):
    """K6: ``(dk, dv)``, each ``[B, T, H, D]`` in the input dtype.  bf16
    and f16 run on the tensor cores, P and dS split into two bf16 terms
    each before dV += P^T dO and dK += dS^T Q (an f16 dO and Q into two
    bf16 parts beside them); f32 on the CUDA cores."""
    _check_qkv(q, k, v)
    _check_bwd(q, do, lse, delta)
    if _route(q) == "plain":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    d = q.shape[-1]
    q, k, v = _kernel_inputs(q, k, v)
    do = _kernel_dout(do, q)
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dk.numel():
        with torch.cuda.device(q.device):
            _launch("flash_attention_dkv", "edl_flash_dkv", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), *_shape_args(q, scale, causal))
    return _unpad(dk, d), _unpad(dv, d)


def flash_attention_bwd_plain(q, k, v, out, lse, do, scale, causal):
    """Plain PyTorch version of the whole backward: ``(dq, dk, dv)``."""
    delta = attention_delta(out, do)
    dq = flash_attention_dq_plain(q, k, v, do, lse, delta, scale, causal)
    return (dq, *flash_attention_dkv_plain(q, k, v, do, lse, delta, scale, causal))


def flash_attention_bwd(q, k, v, out, lse, do, scale, causal):
    """The JAX ``_bwd``: delta in plain PyTorch, then K5 and K6.  dO
    arrives in q's dtype (the JAX kernels read the cotangent as given
    and upcast it; delta uses it upcast)."""
    delta = attention_delta(out, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, scale, causal)
    return (dq, *flash_attention_dkv(q, k, v, do, lse, delta, scale, causal))


class _FlashAttention(torch.autograd.Function):
    """K4 forward; delta + K5 + K6 backward (the JAX ``custom_vjp``).
    The module-level functions are looked up at call time, so a caller
    can patch the plain versions in (``chip_smoke.py`` does)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_k):
        out, lse = flash_attention_fwd(q, k, v, scale, causal, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = BLOCK,
    block_k: int = BLOCK,
) -> torch.Tensor:
    """Self-attention ``[B, T, H, D] -> [B, T, H, D]`` (the JAX
    ``flash_attention``), differentiable in q, k, v.

    ``scale`` defaults to ``1/sqrt(D)``.  ``block_q``/``block_k`` are the
    tile sizes: on the card the kernels' tile is ``BLOCK`` for both (any
    other value raises), and the plain version on the CPU blocks its
    online softmax by ``block_k``.  Unlike the JAX function, T need not
    be a multiple of the blocks: the kernels mask a ragged last tile."""
    _check_qkv(q, k, v)
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be >= 1, got ({block_q}, {block_k})")
    if q.device.type == "cuda" and block_q != BLOCK:
        raise ValueError(f"the flash-attention kernels are built for {BLOCK}-wide tiles, "
                         f"got block_q={block_q}")
    scale = default_scale(q.shape[-1]) if scale is None else float(np.float32(scale))
    return _FlashAttention.apply(q, k, v, scale, bool(causal), block_k)


# ----------------------------------------------------------------------
# K7-K9: one step of the context-parallel ring
# ----------------------------------------------------------------------
#
# The JAX functions' layout: q [B, H, Tq, D], the rotating K/V block [B,
# H, Tk, D], the carry acc [B, H, Tq, D] f32 and lse [B, H, Tq, 1] f32,
# the global positions q_pos [Tq] and k_pos [Tk] (causal: k_pos > q_pos
# is masked).  The plain versions repeat the Pallas ring kernels'
# arithmetic step by step: q upcast and scaled in f32 before Q K^T, the
# masked scores NEG_INF, the online softmax with its max clamped where a
# row has seen only masked keys, P rounded to v's dtype before P V (over
# key blocks of ``block_k``, as the CUDA kernel blocks them by BLOCK),
# the lse-space combine in the JAX order, and an f32 backward from the
# final lse and delta with dq and dk scaled at the end.


def _half_neg_inf(x: torch.Tensor) -> torch.Tensor:
    return x <= NEG_INF / 2


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp``'s formula: max + log1p(exp(-|a - b|))."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _check_ring(q, k_blk, v_blk) -> None:
    if q.dim() != 4 or k_blk.dim() != 4 or k_blk.shape != v_blk.shape:
        raise ValueError(
            f"q, k_blk, v_blk must be [B, H, T, D] with one K/V shape, got "
            f"{tuple(q.shape)}, {tuple(k_blk.shape)}, {tuple(v_blk.shape)}"
        )
    b, h, _, d = q.shape
    if (k_blk.shape[0], k_blk.shape[1], k_blk.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and the K/V block {tuple(k_blk.shape)} differ "
                         f"outside the sequence dimension")
    _check_dtypes_devices(q, k_blk, v_blk)


def _positions(pos, n: int, device: torch.device, name: str) -> torch.Tensor:
    """Global positions as a contiguous int32 ``[n]`` tensor on ``device``."""
    pos = pos if isinstance(pos, torch.Tensor) else torch.from_numpy(np.array(pos))  # noqa-invariant: jit-host-sync (the host branch: pos is a numpy or list position table here, never a tensor)
    if tuple(pos.shape) != (n,):
        raise ValueError(f"{name} must be [{n}], got {tuple(pos.shape)}")
    return pos.to(device=device, dtype=torch.int32).contiguous()


def _rows(x: torch.Tensor, q: torch.Tensor, name: str) -> torch.Tensor:
    """lse/delta as f32 ``[B, H, Tq]`` (the JAX ``[B, H, Tq, 1]`` accepted)."""
    b, h, tq, _ = q.shape
    if x.dtype != torch.float32 or tuple(x.shape) not in ((b, h, tq), (b, h, tq, 1)):
        raise ValueError(f"{name} must be float32 [B, H, Tq(, 1)] = {(b, h, tq)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != q.device:
        raise ValueError(f"{name} on {x.device} but q on {q.device}")
    return x.reshape(b, h, tq)


def _ring_kernel_inputs(q, k, v):
    """What the ring kernels take: f32, bf16 or f16 (any other dtype
    raises), head_dim up to MAX_HEAD_DIM padded to a multiple of 8, a
    contiguous last dimension, one set of K/V strides and, in bf16 and
    f16, 16-byte alignment of q and of the K/V block, each with its own
    strides (copied only when missing)."""
    _check_ring_kernel_dtype(q)
    _check_head_dim(q)
    q, k, v = _pad8(q), _pad8(k), _pad8(v)
    if q.stride(-1) != 1 or not _aligned16(q):
        q = q.contiguous()
        if not _aligned16(q):
            q = q.clone()
    if (k.stride() != v.stride() or k.stride(-1) != 1
            or not (_aligned16(k) and _aligned16(v))):
        k, v = k.contiguous(), v.contiguous()
        if not (_aligned16(k) and _aligned16(v)):
            k, v = k.clone(), v.clone()
    return q, k, v


def _ring_kernel_dout(do, q):
    """dO as K8 and K9 read it, at (padded) q's head_dim: a bf16 or f16 dO
    beside q of its dtype as it is (the CP path's gradient; contiguous and
    16-byte aligned, copied only when it is not), any other as f32
    (beside bf16 or f16 q the kernels split it in three bf16 parts; the
    f32 builds read it as it is)."""
    do = _pad8(do)
    if not (do.dtype == q.dtype and do.element_size() == 2):
        return do.to(torch.float32).contiguous()
    do = do.contiguous()
    return do if _aligned16(do) else do.clone()


def _check_tiles(block_q: int, block_k: int) -> None:
    if block_q != BLOCK or block_k != BLOCK:
        raise ValueError(f"the ring-step kernels are built for {BLOCK}-wide tiles, got "
                         f"block_q={block_q}, block_k={block_k}")


def _ring_shape_args(q: torch.Tensor, k: torch.Tensor, scale: float, causal: bool):
    b, h, tq, d = q.shape
    q_sb, q_sh, q_st, _ = q.stride()
    kv_sb, kv_sh, kv_st, _ = k.stride()
    return (b, h, tq, k.shape[2], d, q_sb, q_st, q_sh, kv_sb, kv_st, kv_sh,
            float(np.float32(scale)), int(bool(causal)), _DTYPE_CODE[q.dtype], _stream())


def flash_ring_step_carry_plain(q, k_blk, v_blk, acc, lse, q_pos, k_pos, *, causal, scale,
                                block_k: int = BLOCK):
    """Plain PyTorch version of K7: ``(acc, lse)`` updated in place and
    returned.  A row that sees no key keeps its carry (the Pallas
    formulas give it back there)."""
    b, h, tq, d = q.shape
    scale = float(np.float32(scale))
    qs = q.to(torch.float32) * scale
    kf = k_blk.to(torch.float32)
    m = torch.full((b, h, tq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, k_blk.shape[2], block_k):
        k1 = min(k_blk.shape[2], k0 + block_k)
        s = torch.matmul(qs, kf[:, :, k0:k1].transpose(-1, -2))
        if causal:
            s = torch.where(k_pos[k0:k1][None, :] > q_pos[:, None], NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        safe_m = torch.where(_half_neg_inf(m_new), 0.0, m_new)
        p = torch.exp(s - safe_m)
        if causal:
            p = torch.where(_half_neg_inf(s), 0.0, p)
        correction = torch.where(_half_neg_inf(m), 0.0, torch.exp(m - safe_m))
        l = l * correction + p.sum(-1, keepdim=True)
        pv = torch.matmul(p.to(v_blk.dtype).to(torch.float32),
                          v_blk[:, :, k0:k1].to(torch.float32))
        o = o * correction + pv
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    o_i = o / l_safe
    lse_i = torch.where(l == 0.0, NEG_INF,
                        torch.where(_half_neg_inf(m), 0.0, m) + torch.log(l_safe))
    lse_c = lse.reshape(b, h, tq, 1)
    lse_new = _logaddexp(lse_c, lse_i)
    safe = torch.where(_half_neg_inf(lse_new), 0.0, lse_new)
    alpha = torch.exp(torch.where(_half_neg_inf(lse_c), NEG_INF, lse_c) - safe)
    beta = torch.exp(torch.where(_half_neg_inf(lse_i), NEG_INF, lse_i) - safe)
    seen = l != 0.0
    acc.copy_(torch.where(seen, acc * alpha + o_i * beta, acc))
    lse.copy_(torch.where(seen, lse_new, lse_c).reshape(lse.shape))
    return acc, lse


def flash_ring_step_carry(q, k_blk, v_blk, acc, lse, q_pos, k_pos, *, causal, scale,
                          block_q: int = BLOCK, block_k: int = BLOCK):
    """K7: one ring step with the combine fused; the carry ``acc`` [B, H,
    Tq, D] f32 and ``lse`` [B, H, Tq, 1] f32 are updated in place and
    returned (the JAX function aliases them to its outputs).  On the
    card the kernel's tile is ``BLOCK``.  bf16 and f16 run on the tensor
    cores (K4's rules: S from the unscaled q, scaled in f32; P rounded to
    q's dtype per ``BLOCK`` keys; wholly masked key tiles skipped), with q
    and the K/V block copied first where they lack 16-byte alignment; f32
    on the CUDA cores.  A head_dim that is no multiple of 8 runs on a padded
    copy of the carry, copied back."""
    _check_ring(q, k_blk, v_blk)
    b, h, tq, d = q.shape
    if acc.dtype != torch.float32 or tuple(acc.shape) != (b, h, tq, d):
        raise ValueError(f"acc must be float32 {(b, h, tq, d)}, got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    _rows(lse, q, "lse")
    q_pos = _positions(q_pos, tq, q.device, "q_pos")
    k_pos = _positions(k_pos, k_blk.shape[2], q.device, "k_pos")
    if _route(q) == "plain":
        return flash_ring_step_carry_plain(q, k_blk, v_blk, acc, lse, q_pos, k_pos,
                                           causal=causal, scale=scale, block_k=block_k)
    _check_tiles(block_q, block_k)
    if acc.device != q.device or not (acc.is_contiguous() and lse.is_contiguous()):
        raise ValueError("the ring-step forward updates acc and lse in place: they must be "
                         "contiguous and on q's device")
    q, k_blk, v_blk = _ring_kernel_inputs(q, k_blk, v_blk)
    carry = _pad8(acc).contiguous()  # acc itself at a multiple of 8
    if acc.numel() and k_blk.shape[2]:
        with torch.cuda.device(q.device):
            _launch("flash_ring_step_carry", "edl_ring_fwd", q.data_ptr(), k_blk.data_ptr(),
                    v_blk.data_ptr(), carry.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
                    k_pos.data_ptr(), *_ring_shape_args(q, k_blk, scale, causal))
    if carry is not acc:
        acc.copy_(carry[..., :d])
    return acc, lse


def _ring_bwd_rows(q, k, v, do, lse, delta, q_pos, k_pos, scale, causal, r0, r1):
    """P and dS of query rows [r0, r1) against the block, f32 [B, H, rows,
    Tk]: s = (q * scale) . k; P = exp(s - lse), 0 where the key is masked
    or the row's final lse is NEG_INF (a row that saw no key in the whole
    ring, where the Pallas formula's exp(NEG_INF - NEG_INF) would give 1;
    K8 and K9 give 0 there too); dS = P * (dO . v - delta)."""
    qs = q[:, :, r0:r1].to(torch.float32) * float(np.float32(scale))
    s = torch.matmul(qs, k.to(torch.float32).transpose(-1, -2))
    row_lse = lse[:, :, r0:r1, None]
    p = torch.exp(s - row_lse)
    dead = _half_neg_inf(row_lse)
    if causal:
        dead = dead | (k_pos[None, :] > q_pos[r0:r1, None])
    p = torch.where(dead, 0.0, p)
    dp = torch.matmul(do[:, :, r0:r1].to(torch.float32),
                      v.to(torch.float32).transpose(-1, -2))
    return p, p * (dp - delta[:, :, r0:r1, None])


def flash_ring_step_dq_plain(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos, *, causal, scale,
                             rows: int = PLAIN_BWD_ROWS) -> torch.Tensor:
    """Plain PyTorch version of K8: ``dq = scale * dS K``, f32 [B, H, Tq,
    D]; ``lse``/``delta`` are f32 [B, H, Tq]."""
    tq = q.shape[2]
    kf = k_blk.to(torch.float32)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for r0 in range(0, tq, rows):
        r1 = min(tq, r0 + rows)
        _, ds = _ring_bwd_rows(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos, scale, causal,
                               r0, r1)
        dq[:, :, r0:r1] = torch.matmul(ds, kf) * float(np.float32(scale))
    return dq


def flash_ring_step_dkv_plain(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos, *, causal, scale,
                              rows: int = PLAIN_BWD_ROWS):
    """Plain PyTorch version of K9: ``dk = scale * dS^T Q`` and ``dv =
    P^T dO``, f32 [B, H, Tk, D]."""
    tq = q.shape[2]
    dk = torch.zeros(k_blk.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(k_blk.shape, dtype=torch.float32, device=q.device)
    for r0 in range(0, tq, rows):
        r1 = min(tq, r0 + rows)
        p, ds = _ring_bwd_rows(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos, scale, causal,
                               r0, r1)
        dv += torch.matmul(p.transpose(-1, -2), do[:, :, r0:r1].to(torch.float32))
        dk += torch.matmul(ds.transpose(-1, -2), q[:, :, r0:r1].to(torch.float32))
    return dk * float(np.float32(scale)), dv


def _ring_bwd_inputs(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos):
    _check_ring(q, k_blk, v_blk)
    if tuple(do.shape) != tuple(q.shape) or do.device != q.device:
        raise ValueError(f"do must be {tuple(q.shape)} on {q.device}, got {tuple(do.shape)} "
                         f"on {do.device}")
    return (_rows(lse, q, "lse"), _rows(delta, q, "delta"),
            _positions(q_pos, q.shape[2], q.device, "q_pos"),
            _positions(k_pos, k_blk.shape[2], q.device, "k_pos"))


def flash_ring_step_dq(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos, *, causal, scale,
                       block_q: int = BLOCK, block_k: int = BLOCK) -> torch.Tensor:
    """K8: the step's dq contribution, f32 [B, H, Tq, D], from the FINAL
    ring-combined ``lse`` and ``delta``.  bf16 and f16 run on the tensor
    cores (K5's rules; dO read in q's dtype as given, or as f32 split in
    three bf16 parts; in f16, dS's hi/lo parts meet K split exactly into
    two bf16 parts), f32 on the CUDA cores."""
    lse, delta, q_pos, k_pos = _ring_bwd_inputs(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos)
    d = q.shape[-1]
    if _route(q) == "plain":
        return flash_ring_step_dq_plain(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos,
                                        causal=causal, scale=scale)
    _check_tiles(block_q, block_k)
    q, k_blk, v_blk = _ring_kernel_inputs(q, k_blk, v_blk)
    do = _ring_kernel_dout(do, q)
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    if dq.numel() and k_blk.shape[2]:
        with torch.cuda.device(q.device):
            _launch("flash_ring_step_dq", "edl_ring_dq", q.data_ptr(), k_blk.data_ptr(),
                    v_blk.data_ptr(), do.data_ptr(), _DTYPE_CODE[do.dtype], lse.data_ptr(),
                    delta.data_ptr(), dq.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                    *_ring_shape_args(q, k_blk, scale, causal))
    return _unpad(dq, d)


def flash_ring_step_dkv(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos, *, causal, scale,
                        block_q: int = BLOCK, block_k: int = BLOCK):
    """K9: ``(dk, dv)`` of the rotating block, each f32 [B, H, Tk, D].
    bf16 and f16 run on the tensor cores (K6's rules; dO as in K8; in
    f16, P's and dS's hi/lo parts meet dO and Q split exactly into two
    bf16 parts), f32 on the CUDA cores."""
    lse, delta, q_pos, k_pos = _ring_bwd_inputs(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos)
    d = q.shape[-1]
    if _route(q) == "plain":
        return flash_ring_step_dkv_plain(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos,
                                         causal=causal, scale=scale)
    _check_tiles(block_q, block_k)
    q, k_blk, v_blk = _ring_kernel_inputs(q, k_blk, v_blk)
    do = _ring_kernel_dout(do, q)
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.zeros(k_blk.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(k_blk.shape, dtype=torch.float32, device=q.device)
    if dk.numel() and q.shape[2]:
        with torch.cuda.device(q.device):
            _launch("flash_ring_step_dkv", "edl_ring_dkv", q.data_ptr(), k_blk.data_ptr(),
                    v_blk.data_ptr(), do.data_ptr(), _DTYPE_CODE[do.dtype], lse.data_ptr(),
                    delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), q_pos.data_ptr(),
                    k_pos.data_ptr(), *_ring_shape_args(q, k_blk, scale, causal))
    return _unpad(dk, d), _unpad(dv, d)


def flash_ring_step_bwd(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos, *, causal, scale,
                        block_q: int = BLOCK, block_k: int = BLOCK):
    """The JAX ``flash_ring_step_bwd``: one step's ``(dq [B, H, Tq, D],
    dk, dv [B, H, Tk, D])``, all f32, by K8 then K9."""
    kw = dict(causal=causal, scale=scale, block_q=block_q, block_k=block_k)
    dq = flash_ring_step_dq(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos, **kw)
    return (dq, *flash_ring_step_dkv(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos, **kw))


def flash_ring_step_bwd_plain(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos, *, causal, scale,
                              block_q: int = BLOCK, block_k: int = BLOCK):
    """Plain PyTorch version of the whole step backward (K8 and K9)."""
    lse, delta, q_pos, k_pos = _ring_bwd_inputs(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos)
    dq = flash_ring_step_dq_plain(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos,
                                  causal=causal, scale=scale)
    return (dq, *flash_ring_step_dkv_plain(q, k_blk, v_blk, do, lse, delta, q_pos, k_pos,
                                           causal=causal, scale=scale))
