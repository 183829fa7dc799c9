"""The port's sharded K1-K3 dispatch (``ops/sparse_embedding.py`` with a
``mesh``) and mesh-built serving against the JAX package on the CPU.

JAX dispatches its fused kernels through ``shard_map`` over
``MeshConfig(2, 4)`` on the 8 virtual CPU devices of ``tests/conftest.py``
(Pallas in interpret mode); the port runs over an in-process (2, 4) mesh
(``virtual_devices(8, "cpu")``), its per-shard bodies the kernels' plain
versions.  Tables of vocab 320 (split over ``model``), 300 (blocks that
do not divide 4: replicated) and 512, dim 1, 8, 9 and 16; ids with
duplicates, ``-1`` and ids past the table.  Tolerances:

- lookups and ``acts`` bit-exact, out-of-range ids included (they read
  zeros on the split route, the clamp rule's row on the replicated one);
  the lookups' table cotangent rtol = atol = 1e-6 (a segment sum);
- FM sums rtol = atol = 1e-6: per shard, then across shards;
- one apply of every optimizer kind: rtol 3e-7 / atol 1e-7 (the JAX
  kernel's own per-apply bar: XLA may fuse a multiply into an FMA);
- the port's sharded apply against its one-card apply: bit-exact (each
  id keeps its occurrence order within its shard);
- a mesh-built ``ServingReplica`` against the JAX ``ServingReplica(mesh=
  ..., sparse_kernel="fused")``: logits rtol 1e-5 / atol 1e-6, the
  one-card serving bar, through a hot swap to a split-table artifact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.ops import sparse_embedding as jske
from elasticdl_tpu.parallel import compile as jpc
from elasticdl_tpu.parallel import packed as jpk
from elasticdl_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from elasticdl_tpu.parallel.mesh import build_mesh as jax_build_mesh
from elasticdl_tpu.parallel.sharding import pad_batch as jax_pad_batch
from elasticdl_tpu.serving.runtime import ServingReplica as JaxReplica
from elasticdl_tpu_torch.layers.embedding import Embedding
from elasticdl_tpu_torch.ops import sparse_embedding as ske
from elasticdl_tpu_torch.parallel import compile as pc
from elasticdl_tpu_torch.parallel import packed as pk
from elasticdl_tpu_torch.parallel import sharding, sparse_optim
from elasticdl_tpu_torch.parallel.mesh import (
    MeshConfig,
    axis_all_gather,
    axis_all_reduce,
    axis_index,
    build_mesh,
    virtual_devices,
)
from elasticdl_tpu_torch.serving import convert
from elasticdl_tpu_torch.serving.export import write_artifact
from elasticdl_tpu_torch.serving.runtime import ServingReplica
from elasticdl_tpu_torch.zoo import build_model

MODEL_DEF = "deepfm.deepfm_functional_api"
FM_TOL = dict(rtol=1e-6, atol=1e-6)
APPLY_TOL = dict(rtol=3e-7, atol=1e-7)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
KINDS = {
    "sgd": ("sgd", {"learning_rate": 0.1}),
    "momentum": ("momentum", {"learning_rate": 0.1, "momentum": 0.9, "nesterov": False}),
    "nesterov": ("momentum", {"learning_rate": 0.1, "momentum": 0.9, "nesterov": True}),
    "adagrad": ("adagrad", {"learning_rate": 0.1, "epsilon": 1e-7}),
    "adam": ("adam", {"learning_rate": 0.01, "beta_1": 0.9, "beta_2": 0.999, "epsilon": 1e-8}),
    "adam_global": ("adam_global", {"learning_rate": 0.01, "beta_1": 0.9, "beta_2": 0.999,
                                    "epsilon": 1e-8}),
}


def _jax_mesh(data=2, model=4):
    return jax_build_mesh(JaxMeshConfig(data=data, model=model))


def _port_mesh(data=2, model=4):
    return build_mesh(MeshConfig(data, model), devices=virtual_devices(data * model, "cpu"))


def _table(spec, seed=0):
    """(packed numpy table, the port's row tensor of it)."""
    rng = np.random.RandomState(seed)
    packed = pk.pack(spec, rng.randn(spec.vocab_size, spec.dim).astype(np.float32))
    return packed, torch.from_numpy(pk.as_rows(spec, packed).copy())


def _ids(spec, n, seed=1):
    """ids with duplicates, padding, ids past the vocabulary and the table."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, spec.vocab_size, n).astype(np.int32)
    ids[:6] = ids[6:12]
    ids[12:18] = [-1, -7, spec.vocab_size, spec.vocab_padded - 1, spec.vocab_padded,
                  spec.vocab_padded + 100]
    return ids


def test_dispatch_rules_match_jax():
    for shape in ((2, 4), (8, 1), (1, 8), (4, 2)):
        mesh, jax_mesh = _port_mesh(*shape), _jax_mesh(*shape)
        assert ske.dispatch_route(mesh) == jske.dispatch_route(jax_mesh) == "shard_map"
        for blocks in (1, 3, 8, 20, 38, 40, 20_313, 162_500):
            assert ske.table_partition_axis(blocks, mesh) == \
                jske.table_partition_axis(blocks, jax_mesh), (shape, blocks)
        spec = pk.PackedSpec(320, 16)
        local = ske._shard_local_spec(spec, mesh)
        if ske.table_partition_axis(spec.num_blocks, mesh):
            want = jske._shard_local_spec(jpk.PackedSpec(320, 16), jax_mesh)
            assert (local.vocab_size, local.dim) == (want.vocab_size, want.dim)
    one = _port_mesh(1, 1)
    assert ske.dispatch_route(None) == ske.dispatch_route(one) == "single_device"
    assert ske.table_partition_axis(40, None) is None
    assert ske.dispatch_mesh() is None


@pytest.mark.parametrize("vocab,dim", [(320, 16), (300, 16), (320, 8), (300, 8), (512, 1),
                                       (300, 1)])
def test_sharded_lookup_matches_jax(vocab, dim):
    spec, jspec = pk.PackedSpec(vocab, dim), jpk.PackedSpec(vocab, dim)
    mesh = _port_mesh()
    packed, rows = _table(spec)
    ids = _ids(spec, 64)
    g = np.random.RandomState(2).randn(64, dim).astype(np.float32)
    want, vjp = jax.vjp(
        lambda p: jske.fused_lookup(jspec, p, jnp.asarray(ids), mesh=_jax_mesh(),
                                    interpret=True), jnp.asarray(packed))
    (want_d,) = vjp(jnp.asarray(g))
    rows.requires_grad_(True)
    got = ske.fused_lookup(spec, rows, torch.from_numpy(ids), mesh=mesh)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    outside = (ids < 0) | (ids >= spec.vocab_padded)
    if ske.table_partition_axis(spec.num_blocks, mesh):  # no shard owns them: zeros
        assert outside.sum() >= 4 and not np.any(got.detach().numpy()[outside])
    (got_d,) = torch.autograd.grad(got, [rows], torch.from_numpy(g))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d).reshape(spec.rows_shape),
                               **FM_TOL)


@pytest.mark.parametrize("vocab", [320, 300])
def test_sharded_lookup_fm_matches_jax(vocab):
    spec, jspec = pk.PackedSpec(vocab, 9), jpk.PackedSpec(vocab, 9)
    mesh = _port_mesh()
    packed, rows = _table(spec)
    rng = np.random.RandomState(3)
    ids = _ids(spec, 16 * 6).reshape(16, 6)
    valid = rng.rand(16, 6) > 0.2
    valid[2, :4] = True  # ids no shard owns, marked valid
    bet = rng.randn(16, 6, 9).astype(np.float32)
    cots = (rng.randn(16, 6, 9), rng.randn(16), rng.randn(16, 8), rng.randn(16, 8))
    cots = tuple(c.astype(np.float32) for c in cots)
    want, vjp = jax.vjp(
        lambda p, b: jske.fused_lookup_fm(jspec, p, b, jnp.asarray(ids), jnp.asarray(valid),
                                          mesh=_jax_mesh(), interpret=True),
        jnp.asarray(packed), jnp.asarray(bet))
    want_table, want_bet = vjp(tuple(jnp.asarray(c) for c in cots))
    rows.requires_grad_(True)
    bet_t = torch.from_numpy(bet).requires_grad_(True)
    got = ske.fused_lookup_fm(spec, rows, bet_t, torch.from_numpy(ids),
                              torch.from_numpy(valid), mesh=mesh)
    np.testing.assert_array_equal(got[0].detach().numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **FM_TOL)
    d_table, d_bet = torch.autograd.grad(got, [rows, bet_t], [torch.from_numpy(c) for c in cots])
    np.testing.assert_allclose(d_bet.numpy(), np.asarray(want_bet), **FM_TOL)
    np.testing.assert_allclose(d_table.numpy(), np.asarray(want_table).reshape(spec.rows_shape),
                               **FM_TOL)


def _jax_slots(kind, spec):
    if kind == "adam_global":
        return {"m": jnp.zeros(spec.packed_shape), "v": jnp.zeros(spec.packed_shape),
                "t_global": jnp.zeros((), jnp.float32)}
    return {name: jnp.zeros(spec.packed_shape) for name in ske.KIND_SLOTS[kind]}


def _port_slots(kind, table):
    slots = {name: torch.zeros_like(table) for name in ske.KIND_SLOTS[kind]}
    if kind == "adam_global":
        slots["t_global"] = torch.zeros((), dtype=torch.float32)
    return slots


def _apply_batch(spec, seed):
    ids = _ids(spec, 64, seed)
    grads = np.random.RandomState(seed).randn(64, spec.dim).astype(np.float32)
    ids[20] = ids[21] = 7   # a row whose two grads cancel
    ids[(ids == 7) & (np.arange(64) < 20)] = -1
    grads[21] = -grads[20]
    return ids, grads


@pytest.mark.parametrize("vocab,name", [(320, k) for k in KINDS] + [(300, "adam")])
def test_sharded_apply_matches_jax(vocab, name):
    kind, hyper = KINDS[name]
    spec, jspec = pk.PackedSpec(vocab, 8), jpk.PackedSpec(vocab, 8)
    packed, rows = _table(spec)
    ids, grads = _apply_batch(spec, 4)
    jax_kind = "adam" if kind == "adam_global" else kind
    want_table, want_slots = jske.fused_dedup_apply(
        jspec, jax_kind, hyper, jnp.asarray(packed), _jax_slots(kind, jspec), jnp.asarray(ids),
        jnp.asarray(grads), mesh=_jax_mesh(), interpret=True)
    slots = _port_slots(kind, rows)
    ske.fused_dedup_apply(spec, kind, hyper, rows, slots, torch.from_numpy(ids),
                          torch.from_numpy(grads), mesh=_port_mesh())
    np.testing.assert_allclose(rows.numpy(), np.asarray(want_table).reshape(spec.rows_shape),
                               **APPLY_TOL)
    for slot, value in slots.items():
        want = np.asarray(want_slots[slot])
        np.testing.assert_allclose(value.numpy(), want.reshape(value.shape), err_msg=slot,
                                   **APPLY_TOL)
    assert torch.equal(rows[7], torch.from_numpy(pk.as_rows(spec, packed)[7]))


@pytest.mark.parametrize("name", list(KINDS))
def test_sharded_apply_equals_one_card_apply(name):
    """Two applies (the second reads non-zero slots) on both routes, the
    split (vocab 320) and the replicated (300) table."""
    kind, hyper = KINDS[name]
    for vocab in (320, 300):
        spec = pk.PackedSpec(vocab, 8)
        _, sharded = _table(spec)
        one_card = sharded.clone()
        slots_s, slots_1 = _port_slots(kind, sharded), _port_slots(kind, one_card)
        for step in range(2):
            ids, grads = (torch.from_numpy(x) for x in _apply_batch(spec, 10 + step))
            ske.fused_dedup_apply(spec, kind, hyper, sharded, slots_s, ids, grads,
                                  mesh=_port_mesh())
            ske.fused_dedup_apply_plain(spec, kind, hyper, one_card, slots_1, ids, grads)
        assert torch.equal(sharded, one_card), (name, vocab)
        for slot in slots_s:
            assert torch.equal(slots_s[slot], slots_1[slot]), (name, vocab, slot)


def test_sharded_route_runs_one_body_per_model_shard(monkeypatch):
    """4 model shards: 4 bodies per op (each the kernel on a card); a
    replicated table: one body on the whole table; the data axis adds
    none in process.  The sparse optimizer and the Embedding layer carry
    the mesh to the ops."""
    calls = []
    for name in ("_lookup_forward", "_lookup_fm_forward", "_apply_body"):
        real = getattr(ske, name)

        def counting(spec, *args, _real=real, _name=name):
            calls.append((_name, spec.vocab_padded))
            return _real(spec, *args)

        monkeypatch.setattr(ske, name, counting)
    mesh = _port_mesh()
    split, replicated = pk.PackedSpec(320, 9), pk.PackedSpec(300, 9)
    layer = Embedding(320, 9, fm_interaction=True, mesh=mesh, device="cpu")
    layer.embedding.zero_()
    layer(torch.zeros((4, 3), dtype=torch.int32))
    assert calls == [("_lookup_fm_forward", 80)] * 4
    calls.clear()
    opt = sparse_optim.adam().remake("fused", mesh=mesh)
    assert opt.mesh is mesh and opt.mode == "fused"
    _, rows = _table(replicated)
    opt.apply(replicated, rows, opt.init_slots(replicated, rows),
              torch.arange(10, dtype=torch.int32), torch.ones((10, 9)))
    ske.fused_lookup(split, _table(split)[1], torch.arange(10, dtype=torch.int32), mesh=mesh)
    assert calls == [("_apply_body", 304)] + [("_lookup_forward", 80)] * 4


def test_axis_helpers_and_rule_tables():
    mesh = _port_mesh()
    assert axis_index(mesh, "model") == (0, 1, 2, 3) and axis_index(mesh, "data") == (0, 1)
    parts = [torch.full((2,), float(i)) for i in range(4)]
    assert torch.equal(axis_all_reduce(mesh, "model", parts), torch.full((2,), 6.0))
    x = torch.arange(6)
    assert axis_all_gather(mesh, "data", x) is x
    assert sharding.data_axis_size(mesh) == 2 and sharding.data_axis_size(None) == 1
    assert sharding.shard_batch({"a": x}, mesh)["a"] is x
    assert sharding.place_rows(x, mesh, "model") is x
    # The rule tables: JAX's matcher (PartitionSpecs) and the port's (axis
    # names) place the same tree alike; a miss raises in both.
    tree = {"tables": {"t/embedding": np.zeros((40, 128))},
            "params": {"w": np.zeros((3, 4)), "b": np.zeros(())}}

    def split(path, shape):
        return "model" if shape[0] % 4 == 0 else None

    port = pc.RuleTable([pc.Rule(r"^tables/", split), pc.Rule(".*", None)], name="t")
    placements, stats = port.match(tree)
    specs, jax_stats = jpc.RuleTable([
        jpc.Rule(r"^tables/", lambda p, s: jax.sharding.PartitionSpec(split(p, s))),
        jpc.Rule(".*", jax.sharding.PartitionSpec()),
    ]).match(tree)
    assert placements == {"tables": {"t/embedding": "model"}, "params": {"w": None, "b": None}}
    assert specs["tables"]["t/embedding"] == jax.sharding.PartitionSpec("model")
    assert {k: stats[k] for k in ("rule_hits", "rule_misses", "unused_rules", "scalars")} == \
        {k: jax_stats[k] for k in ("rule_hits", "rule_misses", "unused_rules", "scalars")}
    assert pc.match_partition_rules([pc.Rule(".*", "data")], [np.zeros((2, 2))]) == ["data"]
    with pytest.raises(ValueError, match="no rule"):
        pc.RuleTable([pc.Rule("^tables/", None)]).match(tree)
    for rows in (0, 3, 4, 5):
        feats = {"a": np.arange(rows * 3, dtype=np.int32).reshape(rows, 3)}
        got, got_mask = sharding.pad_batch(feats, 4)
        want, want_mask = jax_pad_batch(feats, 4)
        np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
        np.testing.assert_array_equal(got["a"], np.asarray(want["a"]))


def _artifact(out_dir, vocab, split, seed):
    params = f"vocab_size={vocab},embedding_dim=8,hidden=16,split_tables={split},sparse_kernel=fused"
    variables, tables = convert.random_jax_variables(
        build_model(MODEL_DEF, params, device="meta"), seed)
    write_artifact(str(out_dir), variables, tables, {"model_zoo": "model_zoo",
                                                     "model_def": MODEL_DEF,
                                                     "model_params": params})
    return str(out_dir)


def _requests(vocab, rows=8, seed=0):
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, vocab, size=(rows, 26)).astype(np.int32)
    cat[0, :3] = [-1, vocab + 3, vocab]
    return {"dense": rng.random((rows, 13), dtype=np.float32), "cat": cat}


def test_mesh_serving_replica_matches_jax(tmp_path):
    # 64 ids per field: 1664 rows, dim 9 -> 208 storage blocks (split over
    # 4); 40 per field: 1040 rows -> 130 blocks (replicated).  The split
    # layout at 64: dim 8 -> 104 blocks (split), dim 1 -> 13 (replicated).
    gen1 = _artifact(tmp_path / "gen1", 64, False, 1)
    gen2 = _artifact(tmp_path / "gen2", 64, True, 2)
    gen3 = _artifact(tmp_path / "gen3", 40, False, 3)
    mesh = _port_mesh()
    replica = ServingReplica(gen1, mesh=mesh)
    assert replica.device.type == "cpu" and replica.mesh is mesh
    assert replica.stats()["tables"] == {"fm_embedding/embedding": "model"}
    jax_replica = JaxReplica(gen1, mesh=_jax_mesh(), sparse_kernel="fused")
    try:
        for gen, vocab, tables in ((gen1, 64, None),
                                   (gen2, 64, {"fm_embedding/embedding": "model",
                                               "linear_embedding/embedding": None}),
                                   (gen3, 40, {"fm_embedding/embedding": None})):
            if tables is not None:
                replica.reload(gen)
                jax_replica.reload(gen)
                assert replica.generation.served.mesh is mesh
                assert replica.stats()["tables"] == tables
            features = _requests(vocab)
            np.testing.assert_allclose(replica.execute(features, 8),
                                       np.asarray(jax_replica.execute(features, 8)), **LOGIT_TOL)
        assert replica.stats()["generation"] == 3
    finally:
        jske.set_dispatch_mesh(None)  # the JAX replica registered its mesh process-wide
