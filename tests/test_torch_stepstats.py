"""The port's step anatomy (``elasticdl_tpu_torch/obs/stepstats.py``)
against the JAX package's (``elasticdl_tpu/obs/stepstats.py``).

The same scripted windows (phases, dispatches, after-the-fact seconds,
overlap credit, compiles) on a fake clock give equal windows, totals and
snapshots; ``sanitize_anatomy``, ``phase_fractions``,
``fleet_attribution`` and ``journal_anatomy`` agree on the same inputs;
the roofline's verdict logic agrees once both modules' ceilings are
injected equal.  The port's ceilings are the card's (an NVIDIA H100
80GB HBM3 at 700 W: 989 TFLOP/s dense bf16, 3.35 TB/s, 32-byte
sectors), not the TPU's, and its ``TRANSFORMER_BENCH`` is JAX's.
"""

import copy
import json

import pytest

from elasticdl_tpu import obs as jax_obs
from elasticdl_tpu.obs import stepstats as jax_ss
from elasticdl_tpu_torch import obs as port_obs
from elasticdl_tpu_torch.obs import stepstats as port_ss
from elasticdl_tpu_torch.ops import _build


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeJit:
    """A jitted function as JAX's watcher reads it: a compile-cache size."""

    def __init__(self, counts):
        self.counts = counts

    def _cache_size(self):
        return self.counts["step"]


# ("phase", name, seconds) | ("dispatch", steps, examples, seconds, compiles)
# | ("note", name, seconds) | ("overlap", seconds) | ("close",)
SCRIPTS = {
    "starved": [
        ("phase", "data_wait", 6.0), ("phase", "stage", 0.5),
        ("dispatch", 32, 2048, 1.0, 0), ("phase", "bookkeep", 0.25), ("close",),
        ("note", "data_wait", 3.0), ("dispatch", 32, 2048, 1.0, 0), ("close",),
    ],
    "first_build_then_execute": [
        ("phase", "compile", 2.0), ("dispatch", 1, 64, 4.0, 1), ("close",),
        ("dispatch", 1, 64, 0.5, 0), ("phase", "bookkeep", 0.125), ("close",),
        ("dispatch", 1, 64, 0.5, 1), ("close",),
    ],
    "async_overlap": [
        ("phase", "data_wait", 0.25), ("overlap", 1.5), ("phase", "stage", 0.125),
        ("dispatch", 8, 512, 3.0, 0), ("close",), ("overlap", 0.75), ("close",),
        ("close",),
    ],
    "many_windows": [step for _ in range(7) for step in (
        ("phase", "data_wait", 0.5), ("dispatch", 4, 256, 1.25, 0),
        ("phase", "bookkeep", 0.0625), ("close",))],
}


def _run_script(module, script):
    clock = _Clock()
    anatomy = module.StepAnatomy(worker_id=3, clock=clock)
    counts = {"step": 0}
    if module is jax_ss:
        anatomy.watch_jits(lambda: {"step": _FakeJit(counts)})
    else:
        anatomy.watch_builds(lambda: {"step": counts["step"]})
    windows = []
    for op in script:
        if op[0] == "phase":
            with anatomy.phase(op[1]):
                clock.t += op[2]
        elif op[0] == "dispatch":
            with anatomy.dispatch(op[1], op[2]):
                clock.t += op[3]
                counts["step"] += op[4]
        elif op[0] == "note":
            anatomy.note_phase_seconds(op[1], op[2])
        elif op[0] == "overlap":
            anatomy.note_overlap_seconds(op[1])
        else:
            windows.append(anatomy.close_window())
    snapshot = anatomy.snapshot()
    snapshot.pop("mem_hwm_mb", None)  # the device's, where one exists
    return windows, anatomy.totals(), snapshot


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_port_anatomy_books_the_jax_windows(script):
    jax_out = _run_script(jax_ss, SCRIPTS[script])
    port_out = _run_script(port_ss, SCRIPTS[script])
    assert port_out == jax_out
    windows, totals, snapshot = port_out
    assert len(snapshot["windows"]) <= port_ss.MAX_SNAPSHOT_WINDOWS
    assert port_ss.sanitize_anatomy(snapshot) == jax_ss.sanitize_anatomy(snapshot)


def test_build_watcher_counts_the_kernel_library_like_jit_compiles():
    watcher = port_ss.BuildWatcher()
    watcher.watch(lambda: None)
    watcher.watch(lambda: {"odd": "not a count"})

    def exploding():
        raise RuntimeError("trainer not initialized yet")

    watcher.watch(exploding)
    library = {"kernel_library": 0}
    watcher.watch(lambda: dict(library))
    assert watcher.poll() == {}
    library["kernel_library"] = 1  # a dispatch that built the library
    assert watcher.poll() == {"kernel_library": 1} and watcher.poll() == {}
    assert watcher.compiles == {"kernel_library": 1} and watcher.retraces_total() == 0
    # No card here: nothing loaded the library.
    assert _build.build_counts() == {"kernel_library": 0}


WIRE_ANATOMIES = {
    "clean": {"windows": [{"steps": 4, "examples": 256, "data_wait": 0.5, "execute": 1.0,
                           "overlap_s": 0.25, "compiles": 1}],
              "totals": {"data_wait": 0.5, "execute": 1.0}, "steps": 4, "examples": 256,
              "retraces": 0, "bound": "host", "mfu": 0.01, "overlap_s": 0.25,
              "compiles": {"kernel_library": 1}, "mem_hwm_mb": 15000.5},
    "unknown_fields_dropped": {"totals": {"stage": 2, "made_up": 1.0}, "event": "x",
                               "bound": "warp-speed", "steps": True},
    "bad_window_rejects_anatomy": {"windows": [{"steps": 1}, "not a window"]},
    "too_many_windows": {"windows": [{"steps": i, "execute": 0.1 * i} for i in range(12)]},
    "long_compile_names": {"compiles": {("x" * 60 + str(i)): i for i in range(10)}},
    "not_a_dict": ["windows"],
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(WIRE_ANATOMIES))
def test_sanitize_anatomy_matches_jax(case):
    wire = WIRE_ANATOMIES[case]
    assert (port_ss.sanitize_anatomy(copy.deepcopy(wire))
            == jax_ss.sanitize_anatomy(copy.deepcopy(wire)))


@pytest.mark.parametrize("seconds", [
    {"data_wait": 6.0, "execute": 1.0, "bookkeep": 0.5},
    {"compile": 2.0, "execute": 2.0, "stage": 0.0},
    {"execute": 0.0},
    {"stage": 1, "not_a_phase": 9.0},
    {},
])
def test_phase_fractions_match_jax(seconds):
    assert port_ss.phase_fractions(seconds) == jax_ss.phase_fractions(seconds)


def test_fleet_attribution_matches_jax():
    snapshots = {
        0: {"anatomy": {"totals": {"data_wait": 1.0, "execute": 9.0}, "retraces": 1}},
        1: {"anatomy": {"totals": {"data_wait": 1.2, "execute": 8.8}, "bound": "compute"}},
        2: {"anatomy": {"totals": {"data_wait": 8.0, "execute": 2.0}, "bound": "host"}},
        3: {},
        4: {"anatomy": "not a dict"},
    }
    port = port_ss.fleet_attribution(snapshots)
    assert port == jax_ss.fleet_attribution(snapshots)
    assert port["bottleneck"] == "execute" and port["workers"][2]["dominant_phase"] == "data_wait"
    assert port_ss.fleet_attribution({0: {}}) == jax_ss.fleet_attribution({0: {}})


def test_journal_anatomy_writes_the_jax_record(tmp_path):
    anatomy = WIRE_ANATOMIES["clean"]
    paths = [jax_obs.init_journal(str(tmp_path / "jax")),
             port_obs.init_journal(str(tmp_path / "port"))]
    try:
        jax_ss.journal_anatomy(5, dict(anatomy))
        port_ss.journal_anatomy(5, dict(anatomy))
        assert jax_ss.journal_anatomy(6, {}) is None and port_ss.journal_anatomy(6, {}) is None
    finally:
        jax_obs.journal().configure(None)
        port_obs.journal().configure(None)
    records = []
    for path in paths:
        with open(path) as f:
            (record,) = [json.loads(line) for line in f]
        record.pop("ts")
        records.append(record)
    assert records[0] == records[1]
    assert records[1]["dominant_phase"] == "execute" and "windows" not in records[1]
    assert port_obs.missing_fields(records[1]) == ()


def _equal_ceilings(monkeypatch):
    """The port's ceilings and table set so each verdict input equals
    JAX's: its peak and bandwidth, and sectors a row that put the sector
    floor at JAX's 25 ns a row."""
    monkeypatch.setattr(port_ss, "PEAK_BF16_FLOPS", jax_ss.PEAK_BF16_FLOPS)
    monkeypatch.setattr(port_ss, "HBM_BYTES_PER_SEC", jax_ss.HBM_BYTES_PER_SEC)
    table = copy.deepcopy(jax_ss.MODEL_FLOPS)
    table["deepfm"]["sparse_sectors_per_row"] = (
        jax_ss.SPARSE_FLOOR_NS_PER_ROW * 1e-9 * jax_ss.HBM_BYTES_PER_SEC / port_ss.SECTOR_BYTES)
    monkeypatch.setattr(port_ss, "MODEL_FLOPS", table)


@pytest.mark.parametrize("model", ["deepfm", "resnet50", "transformer_lm", None])
@pytest.mark.parametrize("rate", [0.0, 50.0, 2e3, 1e5, 1.6e6])
@pytest.mark.parametrize("fractions", [{"execute": 1.0}, {"data_wait": 0.7, "execute": 0.3},
                                       {"stage": 0.3, "bookkeep": 0.25, "execute": 0.45}])
def test_roofline_verdict_logic_matches_jax_with_equal_ceilings(monkeypatch, model, rate,
                                                                fractions):
    _equal_ceilings(monkeypatch)
    assert (port_ss.roofline(rate, fractions, model)
            == jax_ss.roofline(rate, fractions, model))


def test_port_ceilings_are_the_cards_not_the_tpus():
    assert port_ss.PEAK_BF16_FLOPS == 989e12 != jax_ss.PEAK_BF16_FLOPS
    assert port_ss.HBM_BYTES_PER_SEC == 3.35e12 != jax_ss.HBM_BYTES_PER_SEC
    assert port_ss.SECTOR_BYTES == 32
    assert not hasattr(port_ss, "SPARSE_FLOOR_NS_PER_ROW")
    # The FLOP counts are the model's and stay; the TPU's HBM bytes go.
    for key, spec in jax_ss.MODEL_FLOPS.items():
        assert (port_ss.MODEL_FLOPS[key]["train_flops_per_example"]
                == spec["train_flops_per_example"])
    assert "hbm_bytes_per_example" not in port_ss.MODEL_FLOPS["resnet50"]
    assert port_ss.MODEL_FLOPS["deepfm"]["sparse_sectors_per_row"] == 2
    # ResNet-50 at its measured H100 rate: host or compute, never hbm.
    assert port_ss.roofline(800.0, {"execute": 1.0}, "resnet50") == {
        "mfu": round(800.0 * 12.3e9 / 989e12, 4), "bound": "compute"}
    starved = port_ss.roofline(800.0, {"data_wait": 0.6, "execute": 0.4}, "resnet50")
    assert starved["bound"] == "host"
    # DeepFM's sector floor: 26 rows x 2 sectors x 32 bytes at 3.35 TB/s.
    rate = 1e6
    floor = round((2 * 32 / 3.35e12 * 1e9) / (1e9 / (rate * 26)), 3)
    assert port_ss.roofline(rate, {"execute": 1.0}, "deepfm")["floor_frac"] == floor


def test_transformer_bench_is_jax_s():
    assert port_ss.TRANSFORMER_BENCH == jax_ss.TRANSFORMER_BENCH
    assert port_ss.transformer_flops_per_token() == jax_ss.transformer_flops_per_token()


@pytest.mark.parametrize("name", ["model_zoo/deepfm/deepfm_functional_api.py",
                                  "resnet50.resnet50_subclass", "transformer.transformer_lm",
                                  "cifar10.cifar10_subclass", ""])
def test_infer_model_key_matches_jax(name):
    assert port_ss.infer_model_key(name) == jax_ss.infer_model_key(name)


def test_device_memory_hwm_is_none_without_a_card():
    assert port_ss.device_memory_hwm_mb() is None
