"""Flash attention: the port of the single-device Pallas kernels of
``elasticdl_tpu/ops/flash_attention.py``.  Three kernels, each a
hand-written CUDA kernel in ``csrc/flash_attention.cu``:

``flash_attention_fwd``  K4, replaces ``_fwd_kernel``: online-softmax
                         attention; ``(out, lse)``.
``flash_attention_dq``   K5, replaces ``_dq_kernel``: dQ from q, k, v,
                         dO, lse and delta.
``flash_attention_dkv``  K6, replaces ``_dkv_kernel``: dK and dV.

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

Layouts: q, k, v, out and the gradients are ``[B, T, H, D]`` as in the
JAX function; the kernels read q, k, v through their strides, so the
query/key/value slices of a fused projection go in without a copy.
``lse`` and ``delta`` are ``[B, H, T]`` f32.  The kernels take bf16 or
f32 inputs, any T >= 1 (a ragged last tile is masked) and head_dim up to
``MAX_HEAD_DIM``, a multiple of 8; their tile is ``BLOCK`` queries by
``BLOCK`` keys.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")

NEG_INF = -1e30
#: The CUDA kernels' tile: BLOCK queries by BLOCK keys.
BLOCK = 64
MAX_HEAD_DIM = 128
#: Query rows per step of the plain backward (bounds its [B, H, rows, T]
#: score slab).
PLAIN_BWD_ROWS = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_launch_lock = threading.Lock()
_launches: Dict[str, int] = {name: 0 for name in KERNELS}


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
    with _launch_lock:
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
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")


def _kernel_inputs(q, k, v):
    """Check what the CUDA kernels take; q, k, v with one set of strides
    and a contiguous last dimension (copied only when they lack it)."""
    d = q.shape[-1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the flash-attention kernels take bfloat16 or float32, got {q.dtype}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(
            f"the flash-attention kernels take head_dim a multiple of 8 up to "
            f"{MAX_HEAD_DIM}, got {d}"
        )
    if not (q.stride() == k.stride() == v.stride()) or q.stride(-1) != 1:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


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
    kernel's tile is ``BLOCK``; ``block_k`` must be ``BLOCK`` there."""
    _check_qkv(q, k, v)
    if _route(q) == "plain":
        return flash_attention_fwd_plain(q, k, v, scale, causal, block_k)
    if block_k != BLOCK:
        raise ValueError(f"the flash-attention kernels are built for {BLOCK}-wide tiles, "
                         f"got block_k={block_k}")
    q, k, v = _kernel_inputs(q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if out.numel():
        with torch.cuda.device(q.device):
            _launch("flash_attention_fwd", "edl_flash_fwd", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), lse.data_ptr(), *_shape_args(q, scale, causal))
    return out, lse


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
    """K5: dq ``[B, T, H, D]`` in q's dtype."""
    _check_qkv(q, k, v)
    _check_bwd(q, do, lse, delta)
    if _route(q) == "plain":
        return flash_attention_dq_plain(q, k, v, do, lse, delta, scale, causal)
    q, k, v = _kernel_inputs(q, k, v)
    do = do.to(q.dtype).contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        with torch.cuda.device(q.device):
            _launch("flash_attention_dq", "edl_flash_dq", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), *_shape_args(q, scale, causal))
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, scale, causal):
    """K6: ``(dk, dv)``, each ``[B, T, H, D]`` in the input dtype."""
    _check_qkv(q, k, v)
    _check_bwd(q, do, lse, delta)
    if _route(q) == "plain":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    q, k, v = _kernel_inputs(q, k, v)
    do = do.to(q.dtype).contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dk.numel():
        with torch.cuda.device(q.device):
            _launch("flash_attention_dkv", "edl_flash_dkv", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), *_shape_args(q, scale, causal))
    return dk, dv


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
