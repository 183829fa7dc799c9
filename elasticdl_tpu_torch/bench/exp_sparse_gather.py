"""Experiment: how fast does each engine of the sparse embedding path run
on the card, per touched row?  The port of ``scripts/exp_sparse_gather.py``
(its four modes and defaults: 212,992 ids into a 26M-row, dim-16 table).

Default mode, one card, each engine's median time per call and ns/row:

  lookup:  the raw packed-row gather (``index_select`` of 512-B storage
           rows), the plain ``fused_lookup`` and K2, and the block gather
           K10 (``ops/sparse_gather.py``: the 4096-B aligned 8-row block
           of each index; 8x the useful bytes, the one-row-per-step floor
           probe) beside its plain version;
  dedup:   ``packed.dedup_representatives`` alone;
  apply:   the full sparse-adam update (global bias correction), the
           plain version (the JAX scatter path) against K3;
  scatter: ``packed.scatter_add`` (the raw write side, context);

then the bandwidth floor of reading and writing every touched storage
row once at the card's 3.35 TB/s.

``--shard_map``: the sharded dispatch over an in-process mesh of 4 model
slots on the card (``virtual_devices(4)``): the table's storage blocks
split over ``model``, each op one kernel per shard.  Tables ns/row and
ns/row/shard (each shard owns a quarter of the touched rows).

``--selftest`` and ``--shard_map --selftest`` (``--device cpu|cuda``): a
small configuration through every engine, asserted against independent
references (the lookups bit-exact, the adam apply within rtol 3e-7 /
atol 1e-7); on the card each kernel is also held to its plain version
(bit-exact, the apply under PyTorch's deterministic algorithms).

Timing: CUDA events around ``INNER`` back-to-back calls (call ``i`` on
the ids shifted by ``i``, as the JAX script's ``fori_loop`` does), the
median of 5 such runs after 2 warm-up runs.  The card's name and power
limit are printed first.  The measuring modes need a CUDA card.

Usage: python -m elasticdl_tpu_torch.bench.exp_sparse_gather [n_ids] [vocab]
       python -m elasticdl_tpu_torch.bench.exp_sparse_gather --shard_map [n_ids] [vocab]
       python -m elasticdl_tpu_torch.bench.exp_sparse_gather --selftest [--device cpu]
       python -m elasticdl_tpu_torch.bench.exp_sparse_gather --shard_map --selftest [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.ops import sparse_gather as sg
from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel import sparse_optim
from elasticdl_tpu_torch.parallel.mesh import MODEL_AXIS, MeshConfig, build_mesh, virtual_devices
from elasticdl_tpu_torch.parallel.packed import PackedSpec

INNER = 32
#: Published H100 SXM memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
SHARDS = 4
APPLY_TOL = dict(rtol=3e-7, atol=1e-7)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _cuda(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the measuring modes time on a CUDA card (CUDA events)")
    return dev


def _time(fn) -> float:
    """Seconds per call of ``fn(i)``: CUDA events around INNER calls, the
    median of 5 runs after 2 warm-up runs."""
    times = []
    for rep in range(7):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(INNER):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        if rep >= 2:
            times.append(start.elapsed_time(end) / 1e3 / INNER)
    return sorted(times)[2]


def _row(results, label: str, t: float, n_ids: int, shards: int = 0) -> None:
    results[label] = {"ms": t * 1e3, "ns_per_row": t / n_ids * 1e9}
    line = f"{label:<28} {t * 1e3:9.4f} ms  {t / n_ids * 1e9:7.2f} ns/row"
    if shards:
        results[label]["ns_per_row_per_shard"] = t / (n_ids / shards) * 1e9
        line += f"  {t / (n_ids / shards) * 1e9:7.2f} ns/row/shard"
    print(line, flush=True)


def _inputs(n_ids: int, vocab: int, dev):
    """The table ``PackedSpec(vocab, 16)`` (8 logical rows to a 128-lane
    storage row), ids and grads, seeded on the device."""
    spec = PackedSpec(vocab, 16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.rand(spec.rows_shape, generator=gen, device=dev)
    ids = torch.randint(0, vocab, (n_ids,), generator=gen, device=dev, dtype=torch.int32)
    grads = torch.rand((n_ids, spec.dim), generator=gen, device=dev)
    return spec, table, ids, grads


def main(n_ids: int = 212_992, vocab: int = 26_000_000, device=None) -> dict:
    """The one-card engines (module docstring); -> {engine: {ms,
    ns_per_row}}, the floor, and K10's launches in this run."""
    dev = _cuda(device)
    print(f"card: {card_line()}", flush=True)
    spec, table, ids, grads = _inputs(n_ids, vocab, dev)
    print(f"table {list(spec.rows_shape)} f32 ({table.numel() * 4 / 2**30:.2f} GiB), "
          f"{n_ids} ids", flush=True)
    r = spec.rows_per_block
    shifted = [ids + i for i in range(INNER)]
    rows = [torch.clamp(torch.div(x, r, rounding_mode="floor"), max=spec.num_blocks - 1)
            for x in shifted]
    blocks = [ids // r // sg.BLOCK_ROWS + i for i in range(INNER)]
    packed = table.view(spec.packed_shape)
    results = {}
    sg.reset_launch_counts()
    with torch.no_grad():
        _row(results, "raw row gather:", _time(lambda i: packed.index_select(0, rows[i])), n_ids)
        _row(results, "fused_lookup plain:",
             _time(lambda i: ske.fused_lookup_plain(spec, table, shifted[i])), n_ids)
        _row(results, "fused_lookup (K2):",
             _time(lambda i: ske.fused_lookup(spec, table, shifted[i])), n_ids)
        _row(results, "block gather plain:",
             _time(lambda i: sg.block_gather_plain(table, spec, blocks[i])), n_ids)
        _row(results, "block gather (K10):",
             _time(lambda i: sg.block_gather(table, spec, blocks[i])), n_ids)
        k10_launches = sg.launch_counts()["block_gather"]
        _row(results, "dedup:",
             _time(lambda i: pk.dedup_representatives(spec, shifted[i], grads)), n_ids)
        opt = sparse_optim.adam(0.001, bias_correction="global", mode="fused")
        slots = opt.init_slots(spec, table)
        _row(results, "adam apply plain:", _time(lambda i: ske.fused_dedup_apply_plain(
            spec, opt.kind, opt.hyperparams, table, slots, shifted[i], grads)), n_ids)
        _row(results, "adam apply (K3):",
             _time(lambda i: opt.apply(spec, table, slots, shifted[i], grads)), n_ids)
        _row(results, "scatter_add:",
             _time(lambda i: pk.scatter_add(spec, table, shifted[i], grads)), n_ids)
    floor = 2 * n_ids * spec.block_width * 4 / HBM_BYTES_PER_S
    _row(results, "sequential-BW floor:", floor, n_ids)
    results["block_gather_launches"] = k10_launches
    results["block_gather_calls"] = 7 * INNER
    return results


def _mesh(device):
    return build_mesh(MeshConfig(1, SHARDS), devices=virtual_devices(SHARDS, device))


def main_shard_map(n_ids: int = 212_992, vocab: int = 26_000_000, device=None) -> dict:
    """The sharded dispatch over an in-process mesh of 4 model slots,
    against the one-card kernels; -> {engine: {ms, ns_per_row[,
    ns_per_row_per_shard]}}."""
    dev = _cuda(device)
    print(f"card: {card_line()}", flush=True)
    mesh = _mesh(dev)
    spec, table, ids, grads = _inputs(n_ids, vocab, dev)
    if ske.table_partition_axis(spec.num_blocks, mesh) != MODEL_AXIS:
        raise ValueError(f"{spec.num_blocks} storage blocks do not split over {SHARDS} shards")
    print(f"table {list(spec.rows_shape)} split over {SHARDS} model-axis shard(s) "
          f"in process, {n_ids} ids", flush=True)
    shifted = [ids + i for i in range(INNER)]
    results = {}
    with torch.no_grad():
        _row(results, "fused_lookup plain:",
             _time(lambda i: ske.fused_lookup_plain(spec, table, shifted[i])), n_ids)
        _row(results, "fused_lookup (K2):",
             _time(lambda i: ske.fused_lookup(spec, table, shifted[i])), n_ids)
        _row(results, "fused_lookup (K2, sm):",
             _time(lambda i: ske.fused_lookup(spec, table, shifted[i], mesh=mesh)), n_ids, SHARDS)
        opt = sparse_optim.adam(0.001, bias_correction="global", mode="fused")
        sharded = opt.remake("fused", mesh=mesh)
        slots = opt.init_slots(spec, table)
        _row(results, "adam apply plain:", _time(lambda i: ske.fused_dedup_apply_plain(
            spec, opt.kind, opt.hyperparams, table, slots, shifted[i], grads)), n_ids)
        _row(results, "adam apply (K3):",
             _time(lambda i: opt.apply(spec, table, slots, shifted[i], grads)), n_ids)
        _row(results, "adam apply (K3, sm):",
             _time(lambda i: sharded.apply(spec, table, slots, shifted[i], grads)), n_ids, SHARDS)
    return results


# ----------------------------------------------------------------------
# selftests
# ----------------------------------------------------------------------


@contextlib.contextmanager
def _deterministic():
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(previous)


def _small(vocab: int, dev, n: int = 64):
    rng = np.random.RandomState(0)
    spec = PackedSpec(vocab, 16)
    table = torch.from_numpy(rng.rand(*spec.rows_shape).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.randint(0, vocab, size=n).astype(np.int32)).to(dev)
    grads = torch.from_numpy(rng.rand(n, spec.dim).astype(np.float32)).to(dev)
    return spec, table, ids, grads


def _adam_reference(spec, table, ids, grads, hyper):
    """numpy, from zero slots: each distinct id's grads summed in position
    order, then one per-row Adam step (t = 1) on every row whose sum is
    not zero, written as ``old + (new - old)``."""
    table, ids, grads = (x.cpu().numpy() for x in (table, ids, grads))
    out = {"table": table.copy()}
    for name in ("m", "v", "t"):
        out[name] = np.zeros_like(table)
    f32 = np.float32
    b1, b2 = f32(hyper["beta_1"]), f32(hyper["beta_2"])
    lr, eps = f32(hyper["learning_rate"]), f32(hyper["epsilon"])
    dim = spec.dim
    for row in np.unique(ids):
        g = np.zeros(dim, f32)
        for j in np.flatnonzero(ids == row):
            g = g + grads[j]
        if not g.any():
            continue
        m = (f32(1) - b1) * g
        v = (f32(1) - b2) * g * g
        update = -lr * (m / (f32(1) - b1)) / (np.sqrt(v / (f32(1) - b2)) + eps)
        out["table"][row, :dim] += update
        out["m"][row, :dim], out["v"][row, :dim], out["t"][row, :dim] = m, v, 1.0
    return out


def _block_reference(b: int, num_blocks: int) -> int:
    """K10's index rule in Python integers (``ops/sparse_gather.py``)."""
    start = ((b * 8 + 2**31) % 2**32) - 2**31
    if start < 0:
        start += num_blocks
    return min(max(start, 0), num_blocks - 8) // 8


def selftest(device="cpu") -> int:
    """Every engine at a small size: the lookup and the block gather
    bit-exact against plain gathers, the adam apply within rtol 3e-7 /
    atol 1e-7 of a numpy reference; on the card each kernel also against
    its plain version."""
    dev = resolve_device(device)
    spec, table, ids, grads = _small(300, dev)
    got = ske.fused_lookup(spec, table, ids)
    assert torch.equal(got, table.index_select(0, ids.long())[:, : spec.dim]), "fused_lookup"
    gspec = PackedSpec(2560, 16)  # 320 storage blocks: 40 blocks of 8
    gtable = torch.arange(gspec.num_blocks * 128, dtype=torch.float32, device=dev)
    gtable = gtable.view(gspec.rows_shape)
    b = torch.tensor([0, 5, 39, 40, 45, 1000, 2**30, -1, -2, -39, -40, -41, -2**31] + list(
        range(-60, 60, 7)), dtype=torch.int32, device=dev)
    want = torch.stack([gtable.view(-1, 8, 128)[_block_reference(int(x), gspec.num_blocks)]
                        for x in b.tolist()])
    assert torch.equal(sg.block_gather(gtable, gspec, b), want), "block_gather"
    opt = sparse_optim.adam(0.001, mode="fused")
    applied, slots = table.clone(), opt.init_slots(spec, table)
    opt.apply(spec, applied, slots, ids, grads)
    ref = _adam_reference(spec, table, ids, grads, opt.hyperparams)
    np.testing.assert_allclose(applied.cpu().numpy(), ref["table"], err_msg="adam table",
                               **APPLY_TOL)
    for name, value in slots.items():
        np.testing.assert_allclose(value.cpu().numpy(), ref[name], err_msg=f"adam {name}",
                                   **APPLY_TOL)
    if dev.type == "cuda":
        assert torch.equal(got, ske.fused_lookup_plain(spec, table, ids)), "K2 vs plain"
        assert torch.equal(sg.block_gather(gtable, gspec, b),
                           sg.block_gather_plain(gtable, gspec, b)), "K10 vs plain"
        plain, plain_slots = table.clone(), opt.init_slots(spec, table)
        with _deterministic():
            ske.fused_dedup_apply_plain(spec, opt.kind, opt.hyperparams, plain, plain_slots,
                                        ids, grads)
        assert torch.equal(applied, plain), "K3 vs plain"
        for name in slots:
            assert torch.equal(slots[name], plain_slots[name]), f"K3 vs plain, slot {name}"
        torch.cuda.synchronize()
    print(f"exp_sparse_gather selftest OK on {dev} (lookup and block gather bit-exact, "
          "adam apply within rtol 3e-7 of the numpy reference"
          + ("; K2, K10 and K3 bit-exact with their plain versions)" if dev.type == "cuda"
             else ")"), flush=True)
    return 0


def selftest_shard_map(device="cpu") -> int:
    """The sharded dispatch over an in-process mesh of 4 model slots: the
    lookup bit-exact against a plain gather, the adam apply within rtol
    3e-7 / atol 1e-7 of the one-card plain apply; on the card the sharded
    kernels also against the sharded plain versions."""
    dev = resolve_device(device)
    mesh = _mesh(dev)
    spec, table, ids, grads = _small(320, dev)
    assert ske.table_partition_axis(spec.num_blocks, mesh) == MODEL_AXIS
    got = ske.fused_lookup(spec, table, ids, mesh=mesh)
    assert torch.equal(got, table.index_select(0, ids.long())[:, : spec.dim]), "sharded lookup"
    opt = sparse_optim.adam(0.001)
    sharded, slots = table.clone(), opt.init_slots(spec, table)
    opt.remake("fused", mesh=mesh).apply(spec, sharded, slots, ids, grads)
    one_card, one_slots = table.clone(), opt.init_slots(spec, table)
    with _deterministic():
        ske.fused_dedup_apply_plain(spec, opt.kind, opt.hyperparams, one_card, one_slots,
                                    ids, grads)
    np.testing.assert_allclose(sharded.cpu().numpy(), one_card.cpu().numpy(),
                               err_msg="sharded adam table", **APPLY_TOL)
    for name in slots:
        np.testing.assert_allclose(slots[name].cpu().numpy(), one_slots[name].cpu().numpy(),
                                   err_msg=f"sharded adam {name}", **APPLY_TOL)
    if dev.type == "cuda":
        assert torch.equal(got, ske.fused_lookup_plain(spec, table, ids, mesh=mesh)), \
            "sharded K2 vs sharded plain"
        plain, plain_slots = table.clone(), opt.init_slots(spec, table)
        with _deterministic():
            ske.fused_dedup_apply_plain(spec, opt.kind, opt.hyperparams, plain, plain_slots,
                                        ids, grads, mesh=mesh)
        assert torch.equal(sharded, plain), "sharded K3 vs sharded plain"
        for name in slots:
            assert torch.equal(slots[name], plain_slots[name]), f"sharded K3, slot {name}"
        torch.cuda.synchronize()
    print(f"exp_sparse_gather shard_map selftest OK on {dev} ({SHARDS}-shard in-process mesh: "
          "lookup bit-exact, adam apply within rtol 3e-7 of the one-card apply"
          + ("; sharded K2 and K3 bit-exact with their plain versions)" if dev.type == "cuda"
             else ")"), flush=True)
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_ids", nargs="?", type=int, default=212_992)
    parser.add_argument("vocab", nargs="?", type=int, default=26_000_000)
    parser.add_argument("--selftest", action="store_true")
    parser.add_argument("--shard_map", action="store_true",
                        help="the sharded dispatch over an in-process mesh of 4 model slots")
    parser.add_argument("--device", default=None,
                        help="cpu or cuda for the selftests (default: the card)")
    args = parser.parse_args()
    if args.selftest:
        sys.exit(selftest_shard_map(args.device) if args.shard_map else selftest(args.device))
    if args.shard_map:
        main_shard_map(args.n_ids, args.vocab, args.device)
    else:
        main(args.n_ids, args.vocab, args.device)
