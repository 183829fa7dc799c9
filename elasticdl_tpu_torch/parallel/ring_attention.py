"""The blockwise attention engine of ``elasticdl_tpu/parallel/
ring_attention.py``: ``blockwise_attention`` with ``_attn_block`` and
``_finalize``, the XLA block math the JAX model runs off the TPU
(``attn_impl="xla"``).

Here it is a second reference for the tests: nothing on the card calls
it (every ``attn_impl`` of the port's transformer runs the flash kernels,
``ops/flash_attention.py``).  Its numerics differ from the flash kernel's
in two roundings, both the JAX engine's own: the scale multiplies the
scores after ``Q K^T`` (not q before it), and P stays f32 in ``P V``.

The ring itself (``ring_attention``, the zigzag layout, the per-step
Pallas kernels) needs more than one card and is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _attn_block(q, k, v, scale, q_pos, k_pos, causal, m, l, acc):
    """One (q-block, kv-block) flash update.  q: [B, Tq, H, D], k, v:
    [B, Tk, H, D]; m, l: [B, H, Tq]; acc: [B, Tq, H, D].  f32
    throughout."""
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) * scale
    mask = None
    if causal:
        mask = k_pos[None, None, None, :] > q_pos[None, None, :, None]
        scores = torch.where(mask, NEG_INF, scores)
    m_new = torch.maximum(m, scores.amax(-1))
    # exp of a fully-masked row's NEG_INF max would overflow: clamp.
    safe_m = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(scores - safe_m[..., None])
    if causal:
        p = torch.where(mask, 0.0, p)
    correction = torch.exp(torch.where(m <= NEG_INF / 2, NEG_INF, m) - safe_m)
    l_new = l * correction + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    acc_new = acc * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def _finalize(m, l, acc, dtype):
    denom = torch.where(l == 0.0, 1.0, l)
    return (acc / denom.transpose(1, 2)[..., None]).to(dtype)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_offset: int = 0,
    k_offset: int = 0,
    scale: Optional[float] = None,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Single-device attention with flash numerics, ``[B, T, H, D]``.
    K/V go in ``kv_chunk`` blocks when the chunk divides the KV length
    (as in JAX); ``q_offset``/``k_offset`` are the global positions of
    the first rows, for causal masking."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    device = q.device
    q_pos = q_offset + torch.arange(tq, device=device)
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=device)
    acc = torch.zeros((b, tq, h, d), dtype=torch.float32, device=device)
    if kv_chunk and tk > kv_chunk and tk % kv_chunk == 0:
        for start in range(0, tk, kv_chunk):
            k_pos = k_offset + start + torch.arange(kv_chunk, device=device)
            m, l, acc = _attn_block(
                q, k[:, start:start + kv_chunk], v[:, start:start + kv_chunk],
                scale, q_pos, k_pos, causal, m, l, acc,
            )
    else:
        k_pos = k_offset + torch.arange(tk, device=device)
        m, l, acc = _attn_block(q, k, v, scale, q_pos, k_pos, causal, m, l, acc)
    return _finalize(m, l, acc, q.dtype)
