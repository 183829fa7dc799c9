"""The schedule of the port's K2 CUDA kernel
(``elasticdl_tpu_torch/ops/csrc/sparse_embedding.cu``: ``lookup_kernel``
and its launcher ``edl_fused_lookup``), replayed on the CPU in PyTorch,
against the plain versions and the JAX package.

A CUDA kernel cannot run here, but its index map can: which table lanes
each output element copies, and what a shard does with an id it does not
own.  The replay follows the kernel block by block, with its constants
read from the source:

- the launcher: the unit width V (4, 2 or 1 floats: the widest that
  divides ``dim`` and ``dim_padded``), ``tile`` ids a block (one pass of
  ``kThreads * kLookupLoads`` units, fewer until the grid has
  ``kLookupMinBlocks`` blocks), a ragged last tile;
- thread ``tid`` of pass ``p`` takes units ``tid + (p * kLookupLoads +
  u) * kThreads``; unit ``e`` of the tile belongs to tile id ``e // w``
  (``w = dim / V``), whose row is, on one card, the clamp rule as the
  kernel writes it (C's truncating division, then the floor fix-up and
  the clamp), and on a model shard ``rel = id - start`` in 64 bits,
  owned when ``0 <= rel < rows``, else local row 0 kept as 0.0;
- the unit copies the V lanes at ``e % w`` of that row into output unit
  ``e`` (times the keep flag on a shard).

Each output element must be written exactly once, and the replay must
give, bit for bit, ``fused_lookup_plain`` and JAX's ``fused_lookup``
(Pallas in interpret mode) on one card, and over a (2, 4) mesh (the
model shards summed in slot order) the port's plain sharded route; JAX's
``shard_map`` route on the 8 virtual CPU devices of
``tests/conftest.py`` gives the same values (its psum turns a sum of
-0.0s into +0.0).  Cases: dims 1, 3, 8, 9, 16, 40, 128 and 130; n
of 0, 1 and one that ends in a ragged tile; ids negative, past
``vocab_padded`` and near +-2**31; on the mesh, shard boundaries and a
-0.0 and a NaN in two shards' row 0, which every id another shard owns
reads times 0.0.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import sparse_embedding as jske
from elasticdl_tpu.parallel import packed as jpk
from elasticdl_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from elasticdl_tpu.parallel.mesh import build_mesh as jax_build_mesh
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh, virtual_devices

SOURCE = Path(ske.__file__).resolve().parent / "csrc" / "sparse_embedding.cu"


def _constant(name: str) -> int:
    match = re.search(rf"constexpr int {name} = ([0-9]+);", SOURCE.read_text())
    assert match, f"{name} not found in {SOURCE}"
    return int(match.group(1))


THREADS = _constant("kThreads")
LOADS = _constant("kLookupLoads")
MIN_BLOCKS = _constant("kLookupMinBlocks")
UNITS = THREADS * LOADS

DIMS = [1, 3, 8, 9, 16, 40, 128, 130]
#: The unit width the launcher takes at each dim (aligned pointers).
WIDTHS = {1: 1, 3: 1, 8: 4, 9: 1, 16: 4, 40: 4, 128: 4, 130: 2}
MESH = (2, 4)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _spec(dim: int) -> pk.PackedSpec:
    """40 storage blocks (they split over 4 model shards), the last one
    part vocabulary, part padding where a block holds several rows."""
    r = pk.PackedSpec(1, dim).rows_per_block
    return pk.PackedSpec(40 * r - r // 2, dim)


def _table(spec, seed=0):
    """(packed numpy table for JAX, the port's row tensor of it)."""
    rng = np.random.RandomState(seed)
    packed = pk.pack(spec, rng.randn(spec.vocab_size, spec.dim).astype(np.float32))
    return packed, torch.from_numpy(pk.as_rows(spec, packed).copy())


def _ids(spec, n: int, seed: int = 1) -> np.ndarray:
    """n ids over and around the table, the edges first."""
    vp = spec.vocab_padded
    edges = [-2**31, 2**31 - 1, -1, vp, -2**31 + 1, 2**31 - 2, -spec.rows_per_block - 1,
             vp + spec.rows_per_block, 0, vp - 1, spec.vocab_size]
    ids = np.random.RandomState(seed).randint(-vp, 2 * vp, size=n)
    ids[:min(n, len(edges))] = edges[:n]
    return ids.astype(np.int32)


def _launch_plan(n: int, dim: int, dim_padded: int):
    """``edl_fused_lookup``'s choices: (V, units a row, ids a tile, blocks)."""
    v = 4
    while v > 1 and (dim % v or dim_padded % v):
        v //= 2
    w = dim // v
    tile = max(1, min(UNITS // w, -(-n // MIN_BLOCKS)))
    return v, w, tile, -(-n // tile)


def _row_of(ids: torch.Tensor, r: int, nb: int) -> torch.Tensor:
    """``row_of`` as the kernel writes it: C's truncating division, then
    the floor fix-up for a negative remainder, then the clamp."""
    block = torch.div(ids, r, rounding_mode="trunc")
    slot = ids - block * r
    neg = slot < 0
    slot = torch.where(neg, slot + r, slot)
    block = torch.where(neg, block - 1, block)
    return torch.clamp(block, 0, nb - 1) * r + slot


@functools.lru_cache(maxsize=None)
def _units(count: int, w: int) -> np.ndarray:
    """The tile's units in the order the threads take them: thread tid,
    pass p, load u -> unit tid + (p * LOADS + u) * THREADS; each must be
    taken once."""
    units = count * w
    taken = [tid + (p * LOADS + u) * THREADS
             for tid in range(THREADS)
             for p in range(-(-units // UNITS))
             for u in range(LOADS)]
    taken = np.asarray([e for e in taken if e < units], np.int64)
    assert np.array_equal(np.sort(taken), np.arange(units)), "a unit taken twice or never"
    return taken


def _replay(spec, table: torch.Tensor, ids: torch.Tensor, start=None) -> torch.Tensor:
    """K2's output by its schedule (``start``: the shard's first row, or
    None on one card)."""
    n, dim = ids.shape[0], spec.dim
    v, w, tile, blocks = _launch_plan(n, dim, spec.dim_padded)
    flat = table.reshape(-1)
    out = torch.zeros(n * dim, dtype=table.dtype)
    written = torch.zeros(n * dim, dtype=torch.int64)
    for b in range(blocks):
        i0 = b * tile
        count = min(tile, n - i0)
        # each id's row (the kernel finds it once per unit; the same row)
        local = ids[i0:i0 + count].to(torch.int64)
        keep = torch.ones(count, dtype=table.dtype)
        if start is not None:
            rel = local - start
            owned = (rel >= 0) & (rel < spec.rows_per_block * spec.num_blocks)
            local = torch.where(owned, rel, 0)
            keep = owned.to(table.dtype)
        base = _row_of(local, spec.rows_per_block, spec.num_blocks) * spec.dim_padded
        # the units, V lanes each, in the threads' order
        e = torch.from_numpy(_units(count, w))
        t, q = e // w, e % w
        lanes = torch.arange(v)
        got = flat[(base[t] + q * v)[:, None] + lanes]
        if start is not None:
            got = got * keep[t][:, None]
        dest = ((i0 * dim + e * v)[:, None] + lanes).reshape(-1)
        out[dest] = got.reshape(-1)
        written.index_add_(0, dest, torch.ones_like(dest))
    assert bool((written == 1).all()), "an output element written twice or never"
    return out.reshape(n, dim)


def _replay_sharded(spec, table, ids, slots: int) -> torch.Tensor:
    """The sharded call: K2's replay on each model shard's rows with its
    first row, then the parts added in slot order (``axis_all_reduce``)."""
    local = pk.PackedSpec(spec.vocab_padded // slots, spec.dim)
    parts = [_replay(local, rows, ids, start=s * local.vocab_padded)
             for s, rows in enumerate(table.chunk(slots))]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


@pytest.mark.parametrize("dim", DIMS)
def test_unit_width_and_tiles(dim):
    """V by dim; a tile holds one pass of units, fewer ids while the grid
    has under kLookupMinBlocks blocks; every id lands in one tile."""
    spec = _spec(dim)
    assert _launch_plan(1, dim, spec.dim_padded)[0] == WIDTHS[dim]
    for n in (1, 1664, 65_536, 212_992):
        v, w, tile, blocks = _launch_plan(n, dim, spec.dim_padded)
        assert tile * w <= max(UNITS, w) and (blocks - 1) * tile < n <= blocks * tile
        assert tile <= -(-n // MIN_BLOCKS) or tile == 1


@pytest.mark.parametrize("n", [0, 1, 2 * UNITS + 5])
@pytest.mark.parametrize("dim", DIMS)
def test_one_card_replay_bit_exact(dim, n):
    """On one card the replay gives the plain version's bits and JAX's
    kernel's for every id (n = 2 * UNITS + 5 ends in a ragged tile)."""
    spec = _spec(dim)
    packed, rows = _table(spec)
    ids = _ids(spec, n)
    got = _replay(spec, rows, torch.from_numpy(ids))
    want = ske.fused_lookup_plain(spec, rows, torch.from_numpy(ids))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ref = jske.fused_lookup(jpk.PackedSpec(spec.vocab_size, dim), jnp.asarray(packed),
                            jnp.asarray(ids[:300]), interpret=True)
    np.testing.assert_array_equal(_bits(got[:300]), _bits(ref))


@pytest.mark.parametrize("dim", DIMS)
def test_shard_replay_bit_exact(dim):
    """Over a (2, 4) mesh the shards' replays, summed in slot order, give
    the port's plain route bit for bit and JAX's shard_map route value for
    value (the sign of a zero sum aside, and NaN where JAX's is): ids
    at the shard boundaries, past both ends and near +-2**31, and with a
    -0.0 and a NaN in row 0 of shards 1 and 2 (every id another shard
    owns reads them times 0.0; the owner's own ids read them times 1.0)."""
    spec = _spec(dim)
    slots = MESH[1]
    assert ske.table_partition_axis(spec.num_blocks, _port_mesh()) == "model"
    packed, rows = _table(spec, seed=dim)
    local_rows = spec.vocab_padded // slots
    ids = _ids(spec, 200, seed=dim)
    ids[20:20 + 2 * slots] = [s * local_rows + d for s in range(slots) for d in (0, -1)]
    for what in ("", "planted"):
        if what:
            rows[local_rows, 0] = -0.0
            rows[2 * local_rows, min(2, dim - 1)] = float("nan")
            packed = rows.numpy().reshape(spec.packed_shape)
        got = _replay_sharded(spec, rows, torch.from_numpy(ids), slots)
        want = ske.fused_lookup_plain(spec, rows, torch.from_numpy(ids), mesh=_port_mesh())
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)
        ref = jske.fused_lookup(jpk.PackedSpec(spec.vocab_size, dim), jnp.asarray(packed),
                                jnp.asarray(ids), mesh=_jax_mesh(), interpret=True)
        # JAX's psum gives +0.0 where every shard adds a -0.0 (row 0's
        # negative lanes times 0.0); the port adds the parts in slot order
        # and keeps -0.0.  Every other value is equal, NaN where JAX's is.
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=what)
    outside = (ids < 0) | (ids >= spec.vocab_padded)
    assert outside.sum() >= 8 and np.isnan(got.numpy()[outside, min(2, dim - 1)]).all()


def _port_mesh():
    return build_mesh(MeshConfig(*MESH), devices=virtual_devices(MESH[0] * MESH[1], "cpu"))


def _jax_mesh():
    return jax_build_mesh(JaxMeshConfig(data=MESH[0], model=MESH[1]))
