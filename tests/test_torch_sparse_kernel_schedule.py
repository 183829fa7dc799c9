"""The schedules of the port's K1 and K3 CUDA kernels
(``elasticdl_tpu_torch/ops/csrc/sparse_embedding.cu``: ``lookup_fm_kernel``,
``dedup_apply_kernel``), emulated on the CPU in plain PyTorch and numpy,
against the plain versions and the JAX package.

A CUDA kernel cannot run here, but what fixes its bits can: which values
it adds, and in which order.  Each emulation follows its kernel's
schedule step for step, with the kernel's own constants read from the
source:

- K3: the raw ids stably sorted; the group at a sorted position that
  starts the segment of a real row reads the row's operands first, takes
  the first occurrence's grad (``0.0f + g``), then, while the segment
  goes on, ``kChunk`` sorted positions at a time: the chunk's ids and
  positions, then the grads of the row's entries in it (a prefix, the
  ids being sorted) added in position order, the next chunk only while
  the chunk's last id is the row's; then the touched rule and the slot
  math in delta form.  It must give the plain version's bits (tables and every
  slot, all six kinds, two applies), and the summed gradients must be
  the bits of JAX's ``dedup_representatives`` (its prologue).  JAX's
  applied tables are held at ``tests/test_torch_sparse_optim.py``'s
  tolerance, rtol 1e-6 / atol 5e-7: XLA fuses FMAs into the JAX slot
  math (ROADMAP Queue 3, "K3's plain version against JAX").  Adding a
  chunk's grads in another order must change the bits: the test can see
  a reordering.
- K1: tiles of batch rows (the kernel's rule, and fixed sizes with a
  ragged last tile); a tile's acts staged, then each (row, lane) summed
  over the fields in order from 0.0f.  acts bit-equal to the plain
  version; the sums bit-equal to a sequential field loop, and within the
  reduction-order bound ``2 * F * 2**-24 * sum|terms|`` (``chip_smoke.py``
  phase 2's) of the plain version and of JAX's kernel in interpret mode.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import sparse_embedding as jske
from elasticdl_tpu.parallel import packed as jpk
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel import sparse_optim as pso

SOURCE = Path(ske.__file__).resolve().parent / "csrc" / "sparse_embedding.cu"


def _constant(name: str) -> int:
    match = re.search(rf"constexpr (?:int|long long) {name} = ([0-9* ]+);", SOURCE.read_text())
    assert match, f"{name} not found in {SOURCE}"
    value = 1
    for factor in match.group(1).split("*"):
        value *= int(factor)
    return value


CHUNK = _constant("kChunk")
FM_ROWS = _constant("kFmRows")
FM_MIN_BLOCKS = _constant("kFmMinBlocks")
FM_SMEM = _constant("kDefaultSmem")

APPLY_TOL = dict(rtol=1e-6, atol=5e-7)
SUM_ORDER_ULPS = 2.0 * 2.0 ** -24

KINDS = {
    "sgd": ("sgd", {"learning_rate": 0.1}),
    "momentum": ("momentum", {"learning_rate": 0.1, "momentum": 0.9, "nesterov": False}),
    "nesterov": ("momentum", {"learning_rate": 0.1, "momentum": 0.9, "nesterov": True}),
    "adagrad": ("adagrad", {"learning_rate": 0.1, "epsilon": 1e-7}),
    "adam": ("adam", {"learning_rate": 0.01, "beta_1": 0.9, "beta_2": 0.999, "epsilon": 1e-8}),
    "adam_global": ("adam", {"learning_rate": 0.01, "beta_1": 0.9, "beta_2": 0.999,
                             "epsilon": 1e-8}),
}
#: (vocab, dim): DeepFM's dim 9 (9 lanes a group), dim 1 (32 groups a
#: warp), dim 3, dim 40 (two column passes).
K3_SHAPES = [(3000, 9), (2000, 1), (500, 3), (300, 40)]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


# ----------------------------------------------------------------------
# K3
# ----------------------------------------------------------------------


def _k3_batch(spec, seed: int, edges: bool):
    """Phase 5's recipe at a small vocabulary, with its segment shapes
    placed on purpose: segments of 150 and 65 occurrences (many chunks),
    34 (ends inside a chunk), 33 (its first grad, then four chunks filled
    to the end, so a fifth is read and holds none of it), 2 and 1; rows
    that occur exactly twice with opposite grads.
    ``edges``: rows 0 and vocab_padded - 1 occur 5 and 4 times and no id
    lies outside the table, so a segment starts at sorted position 0 and
    one ends at n - 1; else ids -1, -7 and past the table are mixed in."""
    rng = np.random.RandomState(seed)
    vp = spec.vocab_padded
    ids = list(rng.randint(100, vp - 100, 200))
    for row, count in ((10, 150), (20, 65), (30, 34), (40, 33), (45, 2)):
        ids += [row] * count
    cancel = list(range(50, 58))
    ids += cancel * 2
    if edges:
        ids += [0] * 5 + [vp - 1] * 4
    else:
        ids += [-1] * 10 + [-7] * 2 + [vp] * 4 + [vp + 3] * 2
    ids = np.asarray(ids, np.int32)
    rng.shuffle(ids)
    grads = (rng.randn(len(ids), spec.dim) * 0.01).astype(np.float32)
    for row in cancel:
        a, b = np.flatnonzero(ids == row)
        grads[b] = -grads[a]
    return ids, grads


def _add_in_order(acc, gathered):
    """The kernel's adds of one chunk: its grads in position order (one
    f32 rounding per add)."""
    for g in gathered:
        acc = acc + g
    return acc


def _add_reversed(acc, gathered):
    for g in gathered[::-1]:
        acc = acc + g
    return acc


def _segment_sums(spec, ids, grads, add=_add_in_order):
    """{row: (summed grad [dim] f32, its first sorted position)} by K3's
    schedule: stable sort of the raw ids, 0.0f + the first grad, then
    chunks of CHUNK sorted positions, each adding the grads of the row's
    entries in it, until a chunk ends on another id (-1 past the end)."""
    order = np.argsort(ids, kind="stable")
    s = ids[order]
    n = len(s)
    sums = {}
    for i in range(n):
        row = int(s[i])
        if row < 0 or row >= spec.vocab_padded or (i > 0 and s[i - 1] == row):
            continue
        acc = np.zeros(spec.dim, np.float32) + grads[order[i]]
        tail = i + 1 < n and s[i + 1] == row
        j0 = i + 1
        while tail:
            chunk = np.full(CHUNK, -1, s.dtype)
            chunk[:max(0, min(CHUNK, n - j0))] = s[j0:j0 + CHUNK]
            m = int((chunk == row).sum())
            assert (chunk[:m] == row).all()  # a prefix: the ids are sorted
            acc = add(acc, grads[order[j0:j0 + m]])
            tail = chunk[-1] == row
            j0 += CHUNK
        sums[row] = (acc, i)
    return sums


def _emulated_body(add=_add_in_order):
    """A body for ``ske._dedup_apply`` that runs K3's schedule: operand
    rows read before the sums, the touched rule, the slot math (the
    kernel's operations, ``apply_math``), each real lane written as
    ``old + delta``."""

    def body(spec, kind, c, operands, t_global, ids, grads):
        dim = spec.dim
        for row, (acc, _) in _segment_sums(spec, ids.numpy(), grads.numpy(), add).items():
            subs = [op[row, :dim].clone()[None] for op in operands]
            if not np.any(acc != 0):
                continue
            if kind == "adam":
                tr = torch.clamp(subs[3][:, :1] + 1.0, min=1.0)
            else:
                tr = t_global
            deltas = ske.apply_math(kind, c, torch.from_numpy(acc)[None], subs, tr)
            for op, sub, delta in zip(operands, subs, deltas):
                op[row, :dim] = (sub + delta)[0]

    return body


def _port_state(kind, spec, packed0):
    table = torch.from_numpy(pk.as_rows(spec, packed0).copy())
    if kind == "adam_global":
        return table, pso.adam(bias_correction="global").init_slots(spec, table)
    return table, {name: torch.zeros_like(table) for name in ske.KIND_SLOTS[kind]}


def _jax_slots(kind, packed):
    if kind == "adam_global":
        return {"m": jnp.zeros_like(packed), "v": jnp.zeros_like(packed),
                "t_global": jnp.zeros((), jnp.float32)}
    return {name: jnp.zeros_like(packed) for name in jske._KIND_SLOTS[kind]}


def _table0(spec):
    rng = np.random.RandomState(0)
    return pk.pack(spec, (rng.randn(spec.vocab_size, spec.dim) * 0.05).astype(np.float32))


def _state_bits_equal(a_table, a_slots, b_table, b_slots) -> bool:
    if not np.array_equal(_bits(a_table), _bits(b_table)):
        return False
    return all(np.array_equal(_bits(v), _bits(b_slots[k])) for k, v in a_slots.items())


def test_schedule_constants_are_the_kernels():
    assert CHUNK == 8
    assert FM_ROWS >= 1 and FM_MIN_BLOCKS >= 1 and FM_SMEM == 48 * 1024


def test_k3_batches_have_the_segment_shapes():
    spec = pk.PackedSpec(3000, 9)
    for edges in (False, True):
        ids, grads = _k3_batch(spec, 1, edges)
        s = np.sort(ids, kind="stable")
        lengths = {row: int((s == row).sum()) for row in (10, 20, 30, 40, 45)}
        assert lengths == {10: 150, 20: 65, 30: 34, 40: 33, 45: 2}
        assert max(lengths.values()) > 3 * CHUNK and (lengths[40] - 1) % CHUNK == 0
        if edges:
            assert s[0] == 0 and s[-1] == spec.vocab_padded - 1
            assert ((s >= 0) & (s < spec.vocab_padded)).all()
        else:
            assert (s < 0).any() and (s >= spec.vocab_padded).any()
        for row in range(50, 58):
            a, b = grads[ids == row]
            assert np.array_equal(a, -b)


@pytest.mark.parametrize("vocab,dim", K3_SHAPES)
@pytest.mark.parametrize("name", list(KINDS))
def test_k3_schedule_matches_plain_bits_and_jax(name, vocab, dim):
    """Two applies (the second reads non-zero slots): the emulated
    schedule gives the plain version's bits in the table and every slot;
    JAX's fused_dedup_apply agrees within APPLY_TOL, its counts exactly."""
    base, hyper = KINDS[name]
    kind = "adam_global" if name == "adam_global" else base
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    packed0 = _table0(spec)
    e_table, e_slots = _port_state(kind, spec, packed0)
    p_table, p_slots = _port_state(kind, spec, packed0)
    j_table, j_slots = jnp.asarray(packed0), _jax_slots(kind, jnp.asarray(packed0))
    body = _emulated_body()
    for step, edges in enumerate((False, True)):
        ids, grads = _k3_batch(spec, 10 + step, edges)
        t_ids, t_grads = torch.from_numpy(ids), torch.from_numpy(grads)
        ske._dedup_apply(body, spec, base, hyper, e_table, e_slots, t_ids, t_grads, None)
        ske.fused_dedup_apply_plain(spec, base, hyper, p_table, p_slots, t_ids, t_grads)
        j_table, j_slots = jske.fused_dedup_apply(
            jspec, base, hyper, j_table, j_slots, jnp.asarray(ids), jnp.asarray(grads),
            interpret=True)
    assert _state_bits_equal(e_table, e_slots, p_table, p_slots)
    np.testing.assert_allclose(e_table.numpy(), np.asarray(j_table).reshape(spec.rows_shape),
                               **APPLY_TOL)
    for slot, value in e_slots.items():
        ref = np.asarray(j_slots[slot]).reshape(value.shape)
        if slot in ("t", "t_global"):
            np.testing.assert_array_equal(value.numpy(), ref)
        else:
            np.testing.assert_allclose(value.numpy(), ref, **APPLY_TOL)
    # rows whose grads cancel are untouched; no pad lane is written
    rows0 = pk.as_rows(spec, packed0)
    np.testing.assert_array_equal(e_table[50:58].numpy(), rows0[50:58])
    assert not e_table[:, dim:].any()


@pytest.mark.parametrize("vocab,dim", K3_SHAPES)
@pytest.mark.parametrize("edges", [False, True])
def test_k3_segment_sums_are_jax_dedup_bits(vocab, dim, edges):
    """Each row's chunked sum is the bits of JAX's dedup prologue at the
    row's representative (its last occurrence); rows JAX leaves
    untouched are exactly the rows whose sum is zero."""
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    ids, grads = _k3_batch(spec, 3, edges)
    safe, gsum, touched = (np.asarray(x) for x in jpk.dedup_representatives(
        jspec, jnp.asarray(ids), jnp.asarray(grads)))
    sums = _segment_sums(spec, ids, grads)
    rows = {int(safe[i]): i for i in np.flatnonzero(touched)}
    assert set(rows) == {row for row, (acc, _) in sums.items() if np.any(acc != 0)}
    for row, i in rows.items():
        np.testing.assert_array_equal(_bits(sums[row][0]), _bits(gsum[i]))


@pytest.mark.parametrize("vocab,dim", K3_SHAPES)
def test_k3_reordered_adds_change_the_bits(vocab, dim):
    """The check can see an order: adding each chunk's grads in reverse
    gives other bits than the plain version (and than the kernel's
    order), on the same inputs."""
    spec = pk.PackedSpec(vocab, dim)
    packed0 = _table0(spec)
    ids, grads = _k3_batch(spec, 10, False)
    in_order = _segment_sums(spec, ids, grads)
    reversed_ = _segment_sums(spec, ids, grads, _add_reversed)
    assert any(not np.array_equal(_bits(in_order[r][0]), _bits(reversed_[r][0]))
               for r in in_order)
    base, hyper = KINDS["adam"]
    e_table, e_slots = _port_state("adam", spec, packed0)
    p_table, p_slots = _port_state("adam", spec, packed0)
    t_ids, t_grads = torch.from_numpy(ids), torch.from_numpy(grads)
    ske._dedup_apply(_emulated_body(_add_reversed), spec, base, hyper, e_table, e_slots,
                     t_ids, t_grads, None)
    ske.fused_dedup_apply_plain(spec, base, hyper, p_table, p_slots, t_ids, t_grads)
    assert not _state_bits_equal(e_table, e_slots, p_table, p_slots)


# ----------------------------------------------------------------------
# K1
# ----------------------------------------------------------------------


def _fm_tile_rows(batch: int, fields: int, dim: int) -> int:
    """``edl_fused_lookup_fm``'s tile: the rows that fit FM_SMEM bytes
    (row offset, flag and acts per id), at most FM_ROWS, down to what
    gives FM_MIN_BLOCKS blocks, at least 1."""
    per_row = fields * (8 + 4 + 4 * dim)
    return max(1, min(FM_SMEM // per_row, FM_ROWS, batch // FM_MIN_BLOCKS))


def _emulated_lookup_fm(spec, table, bet, ids, valid, tile_rows):
    """K1's schedule: per tile, every element's (row + bet) * valid,
    staged; then each (row, lane) summed over the fields in order from
    0.0f (acc, and acc_sq of a * a)."""
    batch, fields = ids.shape
    dim = spec.dim
    rows = pk.row_index(spec, ids.reshape(-1)).reshape(batch, fields)
    acts = torch.empty((batch, fields, dim))
    first = torch.empty((batch,))
    sum_v = torch.empty((batch, dim - 1))
    sum_sq = torch.empty((batch, dim - 1))
    for b0 in range(0, batch, tile_rows):
        b1 = min(batch, b0 + tile_rows)
        x = table[rows[b0:b1]][..., :dim]
        add = bet[b0:b1] if bet is not None else torch.zeros_like(x)
        staged = (x + add) * valid[b0:b1].to(torch.float32)[..., None]
        acts[b0:b1] = staged
        acc = torch.zeros((b1 - b0, dim))
        acc_sq = torch.zeros((b1 - b0, dim))
        for f in range(fields):
            a = staged[:, f]
            acc = acc + a
            acc_sq = acc_sq + a * a
        first[b0:b1] = acc[:, 0]
        sum_v[b0:b1] = acc[:, 1:]
        sum_sq[b0:b1] = acc_sq[:, 1:]
    return acts, first, sum_v, sum_sq


def _sequential_sums(acts):
    """A field loop per (row, lane) in numpy f32 scalars."""
    acts = acts.numpy()
    batch, fields, dim = acts.shape
    acc = np.zeros((batch, dim), np.float32)
    acc_sq = np.zeros((batch, dim), np.float32)
    for b in range(batch):
        for lane in range(dim):
            s, ss = np.float32(0.0), np.float32(0.0)
            for f in range(fields):
                a = acts[b, f, lane]
                s = np.float32(s + a)
                ss = np.float32(ss + np.float32(a * a))
            acc[b, lane], acc_sq[b, lane] = s, ss
    return acc[:, 0], acc[:, 1:], acc_sq[:, 1:]


def _fm_case(vocab, dim, batch, fields, with_bet, seed):
    spec = pk.PackedSpec(vocab, dim)
    rng = np.random.RandomState(seed)
    logical = rng.randn(spec.vocab_size, dim).astype(np.float32)
    packed = pk.pack(spec, logical)
    ids = rng.randint(-3, spec.vocab_padded + 3, size=(batch, fields)).astype(np.int32)
    valid = rng.rand(batch, fields) > 0.2
    valid[0, :] = False
    bet = rng.randn(batch, fields, dim).astype(np.float32) if with_bet else None
    return spec, packed, ids, valid, bet


def _within_order_bound(got, want, acts):
    fields = acts.shape[1]
    terms = (acts[..., 0].abs().sum(-1), acts[..., 1:].abs().sum(1),
             (acts[..., 1:] * acts[..., 1:]).sum(1))
    for g, w, t in zip(got, want, terms):
        excess = (torch.as_tensor(np.array(g)) - torch.as_tensor(np.array(w))).abs() \
            - SUM_ORDER_ULPS * fields * t
        assert float(excess.max()) <= 0.0


def test_k1_tile_rule():
    assert _fm_tile_rows(64, 26, 9) == 1  # serving's bucket: 64 blocks
    assert _fm_tile_rows(8192, 26, 9) == FM_ROWS  # training: 1024 blocks
    assert _fm_tile_rows(8192, 26, 1000) == 1  # one row per tile past 48 KB a row
    assert _fm_tile_rows(13, 26, 9) == 1


@pytest.mark.parametrize("with_bet", [False, True])
@pytest.mark.parametrize("batch,fields,dim,tile", [
    (13, 26, 9, 8),    # a ragged last tile of 5 rows
    (13, 26, 9, None),  # the kernel's rule
    (70, 1, 2, 8),     # one field, the least dim
    (70, 26, 2, 3),
    (9, 1, 9, 4),
    (20, 26, 9, 20),   # one tile holds the batch
])
def test_k1_tiles_match_plain_acts_and_sequential_sums(batch, fields, dim, tile, with_bet):
    spec, packed, ids, valid, bet = _fm_case(300, dim, batch, fields, with_bet, seed=batch + dim)
    table = torch.from_numpy(pk.as_rows(spec, packed).copy())
    t_ids, t_valid = torch.from_numpy(ids), torch.from_numpy(valid)
    t_bet = torch.from_numpy(bet) if bet is not None else None
    tile = tile or _fm_tile_rows(batch, fields, dim)
    got = _emulated_lookup_fm(spec, table, t_bet, t_ids, t_valid, tile)
    plain = ske.fused_lookup_fm_plain(spec, table, t_bet, t_ids, t_valid)
    np.testing.assert_array_equal(_bits(got[0]), _bits(plain[0]))
    for g, w in zip(got[1:], _sequential_sums(plain[0])):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    _within_order_bound(got[1:], plain[1:], plain[0])


@pytest.mark.parametrize("with_bet", [False, True])
@pytest.mark.parametrize("fields,dim", [(26, 9), (1, 2), (26, 2)])
def test_k1_sums_within_the_order_bound_of_jax(fields, dim, with_bet):
    """JAX's _fm_kernel in interpret mode: acts the same bits, the sums
    within the reduction-order bound."""
    spec, packed, ids, valid, bet = _fm_case(64 * 26, dim, 11, fields, with_bet, seed=7)
    ids = np.clip(ids, 0, spec.vocab_size - 1)  # JAX and the port agree on every id; keep real rows
    table = torch.from_numpy(pk.as_rows(spec, packed).copy())
    t_bet = torch.from_numpy(bet) if bet is not None else None
    got = _emulated_lookup_fm(spec, table, t_bet, torch.from_numpy(ids),
                              torch.from_numpy(valid), _fm_tile_rows(11, fields, dim))
    ref = jske.fused_lookup_fm(
        jpk.PackedSpec(spec.vocab_size, dim), jnp.asarray(packed),
        jnp.asarray(bet if bet is not None else np.zeros((11, fields, dim), np.float32)),
        jnp.asarray(ids), jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
    _within_order_bound(got[1:], [np.asarray(r).reshape(g.shape) for r, g in
                                  zip(ref[1:], got[1:])], got[0])
