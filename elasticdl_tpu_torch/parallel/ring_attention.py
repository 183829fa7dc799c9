"""Ring attention, context parallelism over a mesh axis: the port of
``elasticdl_tpu/parallel/ring_attention.py``.

The sequence is sharded over the mesh's ``model`` axis; each slot keeps
its q shard and the K/V blocks rotate around the ring, one step per
slot, so the [T, T] score matrix never exists.

- ``blockwise_attention`` (with ``_attn_block`` and ``_finalize``) and
  ``ring_attention`` are the JAX package's XLA block math, the reference
  the tests hold the ring to.  Nothing on the card calls them.
- The flash-engined ring (``ring_attention_pallas``, the JAX name; an
  autograd ``Function``) runs one hand-written kernel per step: K7
  (``flash_ring_step_carry``) in the forward, K8 and K9
  (``flash_ring_step_bwd``) in the backward, in the JAX step order.  The
  dk/dv accumulators ride the K/V rotation home.  It is the port's only
  engine, so the JAX ``impl`` argument is not taken.
- ``make_ring_attention`` and ``ring_self_attention`` take a
  ``parallel.mesh.Mesh``.

The ring's rotation is one object, ``Ring``, with two transports: on an
in-process mesh every slot is held here and a step is a list roll; on a
process mesh this rank holds one slot and a step sends its blocks to the
next rank of its model-axis group and receives the previous rank's
(``torch.distributed.batch_isend_irecv``).

Shapes follow the JAX convention, ``[batch, seq, heads, head_dim]``;
the step kernels run in ``[B, H, T, D]``, which q enters as a transposed
view and the rotating K/V blocks as one copy per call.  Positions: under
``layout="contiguous"`` slot i holds ``[i * T_local, (i + 1) * T_local)``;
under ``"zigzag"`` it holds chunks i and 2N-1-i of 2N, which balances
the causal work (``zigzag_order`` permutes a global sequence into that
layout).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

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


# ----------------------------------------------------------------------
# layouts and positions
# ----------------------------------------------------------------------

LAYOUTS = ("contiguous", "zigzag")


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")


def zigzag_order(t: int, n_shards: int) -> np.ndarray:
    """Global-position permutation for ``layout="zigzag"``: applied to
    the sequence and then sharded contiguously, it gives shard i the
    position chunks (i, 2N-1-i).  ``t % (2 * n_shards) == 0``; invert
    with ``inverse_order``."""
    if t % (2 * n_shards):
        raise ValueError(f"t={t} must divide into 2*{n_shards} chunks")
    h = t // (2 * n_shards)
    idx = []
    for i in range(n_shards):
        idx.extend(range(i * h, (i + 1) * h))
        j = 2 * n_shards - 1 - i
        idx.extend(range(j * h, (j + 1) * h))
    return np.asarray(idx)


def inverse_order(order: np.ndarray) -> np.ndarray:
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return inv


def zigzag_orders(t: int, n_shards: int):
    """``(order, inverse)`` for ``layout="zigzag"``."""
    order = zigzag_order(t, n_shards)
    return order, inverse_order(order)


def shard_positions(index: int, t_local: int, axis_size: int, layout: str) -> np.ndarray:
    """Global positions of shard ``index``'s local rows under ``layout``
    (the JAX ``_shard_positions``), int64."""
    _check_layout(layout)
    if layout == "contiguous":
        return index * t_local + np.arange(t_local)
    half = t_local // 2
    late = 2 * axis_size - 1 - index
    return np.concatenate([index * half + np.arange(half), late * half + np.arange(half)])


@functools.lru_cache(maxsize=64)
def _position_table(axis_size: int, t_local: int, layout: str, device: torch.device):
    """Every shard's positions as int32 tensors on ``device``, made once:
    the step kernels read them, and they never change."""
    return tuple(
        torch.from_numpy(shard_positions(i, t_local, axis_size, layout).astype(np.int32)).to(device)
        for i in range(axis_size)
    )


# ----------------------------------------------------------------------
# the rotation
# ----------------------------------------------------------------------


class Ring:
    """The ring of a mesh axis: ``size`` slots, the slots this process
    holds (``slots``, in order) and the rotation, after which slot i
    holds what slot i-1 held.  ``group``/``ranks`` (the axis's process
    group and its global ranks in axis order) make it a process ring;
    without them every slot is held here."""

    def __init__(self, size: int, slots: Sequence[int], group=None,
                 ranks: Optional[Sequence[int]] = None):
        if group is not None and len(slots) != 1:
            raise ValueError("a process ring holds one slot per rank")
        self.size = size
        self.slots = list(slots)
        self.group = group
        self.ranks = list(ranks) if ranks is not None else None

    @classmethod
    def from_mesh(cls, mesh: Mesh, axis: str = MODEL_AXIS) -> "Ring":
        if axis != MODEL_AXIS:
            raise ValueError(f"the ring runs over the {MODEL_AXIS!r} axis, not {axis!r}")
        size = mesh.shape[axis]
        if mesh.in_process:
            return cls(size, range(size))
        return cls(size, [mesh.model_index], mesh.group(axis), mesh.axis_ranks(axis))

    def rotate(self, held: List[Sequence[torch.Tensor]]) -> List[Sequence[torch.Tensor]]:
        """``held[j]``: the blocks of local slot j; returns what each local
        slot holds after one step."""
        if self.group is None:
            return held[-1:] + held[:-1]
        index = self.slots[0]
        to, frm = self.ranks[(index + 1) % self.size], self.ranks[(index - 1) % self.size]
        received = [torch.empty_like(t) for t in held[0]]
        ops = [dist.P2POp(dist.isend, t, to, self.group) for t in held[0]]
        ops += [dist.P2POp(dist.irecv, t, frm, self.group) for t in received]
        for request in dist.batch_isend_irecv(ops):
            request.wait()
        return [received]


# ----------------------------------------------------------------------
# the block-math ring (a test reference)
# ----------------------------------------------------------------------


def ring_attention(q, k, v, *, ring: Ring, causal: bool = False, scale: Optional[float] = None,
                   layout: str = "contiguous") -> torch.Tensor:
    """The JAX ``ring_attention``, the XLA block math, over ``ring``: q,
    k, v ``[B, T_here, H, D]`` hold the ring's local slots one after the
    other along the sequence.  Under ``"contiguous"`` a causal block from
    a later shard is skipped (the Pallas-free engine's ``lax.cond``)."""
    _check_layout(layout)
    n, slots = ring.size, ring.slots
    tq, tk = q.shape[1] // len(slots), k.shape[1] // len(slots)
    b, _, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    device = q.device
    qs = q.split(tq, dim=1)
    held = list(zip(k.split(tk, dim=1), v.split(tk, dim=1)))
    states = [
        (torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=device),
         torch.zeros((b, h, tq), dtype=torch.float32, device=device),
         torch.zeros((b, tq, h, d), dtype=torch.float32, device=device))
        for _ in slots
    ]
    for step in range(n):
        for j, i in enumerate(slots):
            src = (i - step) % n
            if causal and layout == "contiguous" and src > i:
                continue
            q_pos = torch.from_numpy(shard_positions(i, tq, n, layout)).to(device)
            k_pos = torch.from_numpy(shard_positions(src, tk, n, layout)).to(device)
            states[j] = _attn_block(qs[j], *held[j], scale, q_pos, k_pos, causal, *states[j])
        if step < n - 1:
            held = ring.rotate(held)
    return torch.cat([_finalize(*state, q.dtype) for state in states], dim=1)


# ----------------------------------------------------------------------
# the flash-engined ring: K7 forward, K8 + K9 backward
# ----------------------------------------------------------------------


def _to_kernel(x: torch.Tensor) -> torch.Tensor:  # [B, T, H, D] <-> [B, H, T, D]
    return x.transpose(1, 2)


def _shards(ring: Ring, layout: str, q, k):
    """Rows of one local slot in q and in K/V, and every slot's q and K/V
    positions."""
    tq, tk = q.shape[1] // len(ring.slots), k.shape[1] // len(ring.slots)
    positions = _position_table(ring.size, tq, layout, q.device)
    k_positions = positions if tk == tq else _position_table(ring.size, tk, layout, q.device)
    return tq, tk, positions, k_positions


def _ring_flash_forward(ring: Ring, causal: bool, scale: float, layout: str, q, k, v):
    """Each step runs K7 on the held K/V block, which combines into the
    slot's (acc, lse) carry in place; a fully masked step leaves the carry
    as it was.  -> (out [B, T_here, H, D] in q's dtype, the slots' lse)."""
    n, slots = ring.size, ring.slots
    tq, tk, positions, k_positions = _shards(ring, layout, q, k)
    qs = [_to_kernel(x) for x in q.split(tq, dim=1)]
    # K/V rotate in the kernel layout: one transpose before the ring.
    held = [(_to_kernel(a).contiguous(), _to_kernel(c).contiguous())
            for a, c in zip(k.split(tk, dim=1), v.split(tk, dim=1))]
    accs = [torch.zeros(x.shape, dtype=torch.float32, device=q.device) for x in qs]
    lses = [torch.full(x.shape[:3] + (1,), NEG_INF, dtype=torch.float32, device=q.device)
            for x in qs]
    for step in range(n):
        for j, i in enumerate(slots):
            src = (i - step) % n
            fa.flash_ring_step_carry(qs[j], *held[j], accs[j], lses[j], positions[i],
                                     k_positions[src], causal=causal, scale=scale)
        if step < n - 1:
            held = ring.rotate(held)
    out = torch.cat([_to_kernel(acc) for acc in accs], dim=1).to(q.dtype)
    return out, lses


def _ring_flash_backward(ring: Ring, causal: bool, scale: float, layout: str, q, k, v, out,
                         lses, g):
    """Every step reuses P = exp(S - lse_final) through K8 and K9; the
    dk/dv accumulators rotate with their K/V block, so after the n-th
    rotation each block's gradient is home.  The kernels read the
    gradient ``g`` in its own dtype (q's: bf16 or f16 on a model that
    computes in it, whose values an f32 copy would only widen); delta
    takes it upcast, in f32."""
    n, slots = ring.size, ring.slots
    tq, tk, positions, k_positions = _shards(ring, layout, q, k)
    qs = [_to_kernel(x) for x in q.split(tq, dim=1)]
    dos = [_to_kernel(x).contiguous() for x in g.split(tq, dim=1)]
    deltas = [torch.sum(do.to(torch.float32) * _to_kernel(o).to(torch.float32), dim=-1,
                        keepdim=True)
              for do, o in zip(dos, out.split(tq, dim=1))]
    held = [(_to_kernel(a).contiguous(), _to_kernel(c).contiguous(),
             torch.zeros((a.shape[0], a.shape[2], tk, a.shape[3]), dtype=torch.float32,
                         device=q.device),
             torch.zeros((a.shape[0], a.shape[2], tk, a.shape[3]), dtype=torch.float32,
                         device=q.device))
            for a, c in zip(k.split(tk, dim=1), v.split(tk, dim=1))]
    dqs = [torch.zeros(x.shape, dtype=torch.float32, device=q.device) for x in qs]
    for step in range(n):
        for j, i in enumerate(slots):
            src = (i - step) % n
            k_blk, v_blk, dk_blk, dv_blk = held[j]
            dq_i, dk_i, dv_i = fa.flash_ring_step_bwd(
                qs[j], k_blk, v_blk, dos[j], lses[j], deltas[j], positions[i],
                k_positions[src], causal=causal, scale=scale)
            dqs[j] += dq_i
            dk_blk += dk_i
            dv_blk += dv_i
        if step < n - 1:
            held = ring.rotate(held)
    # The n-th rotation brings dk/dv home (K/V themselves are done).
    home = ring.rotate([blocks[2:] for blocks in held])
    dq = torch.cat([_to_kernel(x) for x in dqs], dim=1).to(q.dtype)
    dk = torch.cat([_to_kernel(x[0]) for x in home], dim=1).to(k.dtype)
    dv = torch.cat([_to_kernel(x[1]) for x in home], dim=1).to(v.dtype)
    return dq, dk, dv


class _RingFlash(torch.autograd.Function):
    """The JAX ``_ring_pallas`` custom VJP.  The kernel functions are
    looked up on ``ops.flash_attention`` at call time, so a caller can
    wrap or replace them (``chip_smoke.py`` times them in the step)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale, layout):
        out, lses = _ring_flash_forward(ring, causal, scale, layout, q, k, v)
        ctx.save_for_backward(q, k, v, out, *lses)
        ctx.cfg = (ring, causal, scale, layout)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, *lses = ctx.saved_tensors
        dq, dk, dv = _ring_flash_backward(*ctx.cfg, q, k, v, out, lses, g)
        return dq, dk, dv, None, None, None, None


def ring_attention_pallas(q, k, v, *, ring: Ring, causal: bool = False,  # hot-path
                          scale: Optional[float] = None, layout: str = "contiguous"):
    """Ring attention with the flash step kernels, K7-K9 (the JAX name):
    the contract of ``ring_attention``, differentiable in q, k, v.  A
    head_dim that is not a multiple of 8 is padded with zero columns once,
    before the ring, and the output sliced back after it (the pad's
    backward slices the gradients; ``scale`` comes from the true
    head_dim), so no step copies for it."""
    _check_layout(layout)
    d = q.shape[-1]
    scale = fa.default_scale(d) if scale is None else float(np.float32(scale))
    q, k, v = fa._pad8(q), fa._pad8(k), fa._pad8(v)
    out = _RingFlash.apply(q, k, v, ring, bool(causal), scale, layout)
    return out if out.shape[-1] == d else out[..., :d]


def make_ring_attention(mesh: Mesh, *, axis: str = MODEL_AXIS, causal: bool = False,
                        layout: str = "contiguous"):
    """The ring-attention callable for ``mesh``, ``attend(q, k, v)``.  On
    an in-process mesh q, k, v are the whole ``[B, T, H, D]`` (the data
    axis splits nothing); on a process mesh they are this rank's rows and
    its shard of the sequence.  With ``layout="zigzag"`` the caller holds
    the sequence in the zigzag layout (``zigzag_order``; a process mesh's
    rank holds its positions, ``shard_positions``).  The JAX ``impl``
    argument is not taken: the port has one engine, the step kernels."""
    _check_layout(layout)
    return functools.partial(ring_attention_pallas, ring=Ring.from_mesh(mesh, axis),
                             causal=causal, layout=layout)


def ring_self_attention(mesh: Mesh, q, k=None, v=None, *, axis: str = MODEL_AXIS,
                        causal: bool = False, layout: str = "contiguous"):
    """Host-level entry: the global ``[B, T, H, D]`` in (on every rank of
    a process mesh), attention out, computed ring-wise; the zigzag
    permutation is internal.  On a process mesh each rank computes its
    rows and positions and the outputs are gathered (``Mesh.
    gather_sequence``; no gradient flows through the gather)."""
    k = q if k is None else k
    v = q if v is None else v
    if layout == "zigzag" and (k.shape[1] != q.shape[1] or v.shape[1] != q.shape[1]):
        raise ValueError(
            "layout='zigzag' requires equal q/k/v sequence lengths "
            f"(got q={q.shape[1]}, k={k.shape[1]}, v={v.shape[1]}); "
            "the balanced layout is a self-attention arrangement"
        )
    fn = make_ring_attention(mesh, axis=axis, causal=causal, layout=layout)
    n = mesh.shape[axis]
    if mesh.in_process:
        if layout != "zigzag":
            return fn(q, k, v)
        order, inv = (torch.from_numpy(o).to(q.device) for o in zigzag_orders(q.shape[1], n))
        return fn(q[:, order], k[:, order], v[:, order])[:, inv]
    rows = q.shape[0] // mesh.shape[DATA_AXIS]
    if rows * mesh.shape[DATA_AXIS] != q.shape[0]:
        raise ValueError(f"batch {q.shape[0]} does not divide over {mesh.shape[DATA_AXIS]} "
                         f"data slots")
    t_local = q.shape[1] // n

    def positions(index):
        return shard_positions(index, t_local, n, layout)

    def local(x):
        own = x[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        return own[:, torch.from_numpy(positions(mesh.model_index)).to(x.device)]

    out = fn(local(q), local(k), local(v))
    return mesh.gather_sequence(out.detach(), q.shape[1], positions)
