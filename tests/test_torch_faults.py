"""The fault sites this slice adds to the port, against the JAX package's.

- ``ckpt.write`` (``checkpoint/saver._apply_write_fault``): on the same
  file, the port tears exactly the bytes JAX's site tears (the default
  half, an explicit ``keep_bytes``, nothing when disarmed or of another
  kind).  Armed through a saver (``ckpt.write:truncate@2``), the second
  save commits a state file torn after its CRC was recorded: each
  package's ``load_latest`` quarantines that step and falls back to the
  first, bit for bit, and each package restores the other's torn
  directory the same way; the sharded saver tears its ``dense.pkl`` and
  falls back too.  Both journal the same events.
- ``quality.label_join`` and ``quality.shadow_eval``
  (``obs/quality.py``): the same specs parse to the same ``FaultSpec``s,
  and the sites fire on the same calls in both packages (the ledger's
  counters and the gate's unknown verdict equal).
"""

import os
import shutil

import jax
import numpy as np
import pytest

from elasticdl_tpu import obs as jax_obs
from elasticdl_tpu.checkpoint import CheckpointSaver as JaxSaver
from elasticdl_tpu.checkpoint import ShardedCheckpointSaver as JaxShardedSaver
from elasticdl_tpu.checkpoint import saver as jax_saver_mod
from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.obs import quality as jax_quality
from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.checkpoint import saver as saver_mod
from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
from elasticdl_tpu_torch.checkpoint.sharded import ShardedArray, ShardedCheckpointSaver
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.obs import quality

PACKAGES = {
    "jax": dict(faults=jax_faults, saver=JaxSaver, sharded=JaxShardedSaver,
                array=lambda table: jax.numpy.asarray(table),
                site=jax_saver_mod._apply_write_fault, obs=jax_obs, quality=jax_quality),
    "port": dict(faults=faults, saver=CheckpointSaver, sharded=ShardedCheckpointSaver,
                 array=lambda table: ShardedArray(table.shape, "float32", [(0, 8, table)]),
                 site=saver_mod._apply_write_fault, obs=obs, quality=quality),
}


@pytest.fixture(autouse=True)
def _disarmed():
    for p in PACKAGES.values():
        p["faults"].clear()
    yield
    for p in PACKAGES.values():
        p["faults"].clear()


@pytest.fixture
def journals(monkeypatch):
    """A fresh in-memory journal per package."""
    out = {}
    for which, p in PACKAGES.items():
        journal = p["obs"].EventJournal()
        monkeypatch.setattr(p["obs"], "journal", lambda j=journal: j)
        out[which] = journal
    return out


def _events(journal):
    keep = ("checkpoint_saved", "checkpoint_restored", "checkpoint_quarantined")
    return [(e["event"], e.get("kind"), e.get("step")) for e in journal.tail(100)
            if e["event"] in keep]


@pytest.mark.parametrize("spec", [
    "ckpt.write:truncate@1", "ckpt.write:truncate=100@1", "ckpt.write:truncate@2",
    "ckpt.write:error=boom@1", "",
], ids=["half", "keep_100", "not_this_call", "other_kind", "disarmed"])
def test_write_fault_tears_the_bytes_jax_tears(tmp_path, spec):
    payload = np.random.default_rng(3).integers(0, 256, size=4099, dtype=np.uint8).tobytes()
    torn = {}
    for which, p in PACKAGES.items():
        path = tmp_path / f"{which}.pkl"
        path.write_bytes(payload)
        if spec:
            p["faults"].install(spec)
        p["site"](str(path))
        torn[which] = path.read_bytes()
        assert p["faults"].call_count("ckpt.write") == (1 if spec else 0)  # counts once armed
    assert torn["port"] == torn["jax"]
    if spec in ("ckpt.write:truncate@1", "ckpt.write:truncate=100@1"):
        assert len(torn["port"]) == (100 if "=100" in spec else len(payload) // 2)
    else:
        assert torn["port"] == payload


def _state(step):
    rng = np.random.default_rng(step)
    return {"w": rng.standard_normal((16, 4)).astype(np.float32),
            "step": np.asarray(step, np.int64)}


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_torn_state_file_is_quarantined_and_restore_falls_back(tmp_path, journals):
    restored = {}
    for which, p in PACKAGES.items():
        root = tmp_path / which
        saver = p["saver"](str(root))
        p["faults"].install("ckpt.write:truncate@2")
        saver.save(_state(1), 1)
        saver.save(_state(2), 2)  # committed with its CRC, then torn
        assert saver_mod.verify_integrity(str(root / "step_000000000002")) is not None
        shutil.copytree(root, tmp_path / f"{which}_copy")  # the other package's turn
        state, step = saver.load_latest()
        assert step == 1
        _assert_state_equal(state, _state(1))
        assert os.path.isdir(root / "step_000000000002.quarantined")
        assert not os.path.exists(root / "step_000000000002")
        restored[which] = state
    assert _events(journals["port"]) == _events(journals["jax"]) == [
        ("checkpoint_saved", "full", 1), ("checkpoint_saved", "full", 2),
        ("checkpoint_quarantined", None, None), ("checkpoint_restored", "full", 1)]
    # Each package reads the other's torn directory the same way.
    for reader, writer in (("port", "jax"), ("jax", "port")):
        copy = tmp_path / f"{writer}_copy"
        state, step = PACKAGES[reader]["saver"](str(copy)).load_latest()
        assert step == 1
        _assert_state_equal(state, restored[writer])
        assert os.path.isdir(copy / "step_000000000002.quarantined")


def test_sharded_save_tears_dense_and_falls_back(tmp_path, journals):
    for which, p in PACKAGES.items():
        saver = p["sharded"](str(tmp_path / which))
        p["faults"].install("ckpt.write:truncate@2")
        for step in (1, 2):
            table = np.full((8, 4), float(step), np.float32)
            saver.save(step, {"step": np.asarray(step, np.int32)}, {"t": p["array"](table)})
        assert saver.latest_step() == 1
        assert int(saver.load_dense(1)["step"]) == 1
        assert os.path.isdir(tmp_path / which / "step_000000000002.quarantined")
    assert _events(journals["port"]) == _events(journals["jax"])


@pytest.mark.parametrize("text", [
    "ckpt.write:truncate=100@2", "quality.label_join:error@1x*",
    "quality.label_join:truncate@3x2", "quality.shadow_eval:error=boom@1",
])
def test_new_sites_parse_like_jax(text):
    assert [vars(s) for s in faults.parse_specs(text)] == [
        vars(s) for s in jax_faults.parse_specs(text)]


def _label_join_run(p):
    ledger = p["quality"].QualityLedger(window_size=16, join_window_s=5.0)
    p["faults"].install("quality.label_join:error@2,quality.label_join:truncate@4")
    joined = []
    for i in range(5):
        ledger.note_prediction(f"t{i}", np.array([0.2 + 0.1 * i]), now=float(i))
        joined.append(ledger.note_label(f"t{i}", np.ones(1), now=float(i)))
    return joined, ledger.snapshot()


def _shadow_eval_run(p):
    replay = p["quality"].ReplayBuffer()
    replay.add({"x": np.arange(64)}, (np.arange(64) % 2).astype(np.float32))
    gate = p["quality"].CanaryGate(replay, min_rows=64)
    p["faults"].install("quality.shadow_eval:error=boom@2")

    def score(features):
        return np.clip(features["x"] / 64.0, 0.05, 0.95)

    return [gate.evaluate(score, score) for _ in range(3)]


@pytest.mark.parametrize("run", [_label_join_run, _shadow_eval_run],
                         ids=["label_join", "shadow_eval"])
def test_quality_sites_fire_on_the_same_calls(run):
    got = {which: run(p) for which, p in PACKAGES.items()}
    assert got["port"] == got["jax"]
    if run is _label_join_run:
        joined, snap = got["port"]
        assert joined == [True, False, True, True, True]
        assert (snap["dropped_injected"], snap["duplicates_injected"], snap["orphans"]) == (1, 1, 1)
    else:
        assert [v["quality"] for v in got["port"]] == ["known", "unknown", "known"]
        assert got["port"][1]["reason"] == "shadow_eval_fault:boom"
