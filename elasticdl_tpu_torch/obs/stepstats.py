"""Step-time anatomy: the port's copy of ``elasticdl_tpu/obs/stepstats.py``
(``StepAnatomy`` :297, ``sanitize_anatomy`` :532, ``journal_anatomy``
:596, ``fleet_attribution`` :619, ``phase_fractions`` :194,
``roofline`` :152).

It decomposes each step's wall time into exclusive sub-phases with
HOST-side clocks:

- ``data_wait``  — host waiting for records (reader/parse/batch, the
  task-queue wait, the lockstep task broadcast on non-leader ranks);
- ``stage``      — host->device staging (``stage_batch``/``stage_window``);
- ``compile``    — the trainer's first ``ensure_initialized`` and any
  dispatch during which the kernel library was built or loaded
  (``BuildWatcher``: the port has no ``jit``, its first-use compile is
  ``ops/_build.py``);
- ``execute``    — every other dispatch;
- ``bookkeep``   — host work after a dispatch (telemetry, version
  reports, checkpoint cadence decisions).

``execute`` is host time, as in the JAX package: ``dispatch`` adds no
``torch.cuda.synchronize()``.  PyTorch on the card is eager and
asynchronous, so a dispatch returns once its kernels are queued, and
the card's time shows up where the host first waits for it: in the
staging pipeline's backpressure (``data/pipeline.py``
``StagingPipeline``, booked as ``stage``), in the first ``float`` of a
loss, or in a checkpoint's copy to the host (``bookkeep``).  Read the
fractions with that in mind.

``overlap_s`` rides BESIDE the exclusive phases: host work that ran
concurrently with the card (prefetch, staging behind an outstanding
dispatch) costs no step-loop latency, so it is credited apart and the
phase fractions still sum to 1.0 over the time serialized on the step
loop.

On top of the phase clocks it keeps build counters, the device-memory
high-water mark (``torch.cuda.max_memory_allocated``), and a per-zoo
analytic FLOPs table (``MODEL_FLOPS``) that turns measured examples/s
into MFU and a roofline ``bound:`` verdict (compute / hbm / host /
sparse-row) against the card's ceilings below.

Windowed summaries ride the telemetry heartbeat: ``WorkerTelemetry``
embeds ``StepAnatomy.snapshot()`` under the ``anatomy`` key, and the
master's ``TelemetryAggregator`` folds fleet phase-fraction gauges
(bounded ``phase`` label only), journals ``step_anatomy`` events and
adds the dominant phase to straggler evidence.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("obs.stepstats")

#: The exclusive sub-phases of a training step's wall time.
PHASES = ("data_wait", "stage", "compile", "execute", "bookkeep")

#: Host-side phases: when these dominate, the accelerator is starved.
HOST_PHASES = ("data_wait", "stage", "bookkeep")

#: Roofline verdicts (bounded enum — safe for journal consumers).
BOUNDS = ("compute", "hbm", "host", "sparse-row")

#: Windows a snapshot carries (oldest trimmed first near the heartbeat
#: size budget — see WorkerTelemetry.snapshot_json).
MAX_SNAPSHOT_WINDOWS = 5

# -- the card's ceilings: an NVIDIA H100 80GB HBM3 at 700.00 W
# (nvidia-smi --query-gpu=name,power.limit), the figures the port's kernel
# bounds use (PERF.md, "TPU kernels in the repo").
PEAK_BF16_FLOPS = 989e12          # dense bf16 tensor-core peak
HBM_BYTES_PER_SEC = 3.35e12       # HBM3 bandwidth
#: A random row read moves whole 32-byte DRAM sectors: the sparse floor
#: is a row's sectors x rows over HBM_BYTES_PER_SEC (K2's bound).
SECTOR_BYTES = 32

#: The transformer bench shape (the JAX package's, which mirrors
#: ``bench.TRANSFORMER_BENCH``; ``tests/test_torch_stepstats.py`` holds
#: the two equal).
TRANSFORMER_BENCH = dict(
    vocab=32768, d_model=512, num_heads=8, num_layers=4, seq_len=2048,
    mlp_ratio=4,
)


def transformer_flops_per_token(cfg: dict = TRANSFORMER_BENCH) -> float:
    """Analytic fwd FLOPs/token, causal (``bench.py``'s formula)."""
    d, layers = cfg["d_model"], cfg["num_layers"]
    per_layer = (
        8 * d * d
        + 4 * cfg["mlp_ratio"] * d * d
        + 4 * d * (cfg["seq_len"] / 2)
    )
    return 2 * d * cfg["vocab"] + layers * per_layer


#: Per-zoo-model analytic cost table.  ``train_flops_per_example`` is
#: TRAIN flops (3x fwd), properties of the model; the optional resource
#: keys drive the roofline verdict: ``sparse_rows_per_example`` x
#: ``sparse_sectors_per_row`` -> the sector floor (SECTOR_BYTES a sector
#: over HBM_BYTES_PER_SEC).
MODEL_FLOPS: Dict[str, dict] = {
    # Dense tower ~50k params; sparse row traffic is the scarce resource:
    # 26 rows an example, each a dim-8 f32 row and a dim-1 one (the split
    # layout) or one dim-9 row straddling two sectors (the merged one) —
    # two 32-byte sectors either way.  Rows/example is a model property,
    # so the floor is the same whichever engine runs the lookups.
    "deepfm": {
        "train_flops_per_example": 3 * 2 * 49_856.0,
        "sparse_rows_per_example": 26,
        "sparse_sectors_per_row": 2,
    },
    # 12.3 GFLOP/image train.  The JAX package's HBM-bytes figure (from
    # BASELINE.md) counts what XLA's fused program moved on a TPU; eager
    # PyTorch on the card moves other bytes (its batch norm runs as
    # separate elementwise and reduction kernels), so it is left out and
    # the verdict falls to host or compute.
    "resnet50": {
        "train_flops_per_example": 12.3e9,
    },
    # One example = one 2048-token sequence of the bench config.
    "transformer_lm": {
        "train_flops_per_example": (
            3 * transformer_flops_per_token()
            * TRANSFORMER_BENCH["seq_len"]
        ),
    },
}


def infer_model_key(name: str) -> Optional[str]:
    """Best-effort MODEL_FLOPS key from a model-zoo path or job name
    (``.../model_zoo/deepfm/deepfm_functional_api.py`` -> ``deepfm``)."""
    lowered = (name or "").lower()
    for key in MODEL_FLOPS:
        if key in lowered or key.replace("_", "") in lowered.replace("_", ""):
            return key
    return None


def roofline(examples_per_s: float, fractions: Dict[str, float],
             model_key: Optional[str]) -> dict:
    """MFU + ``bound:`` verdict for a measured rate against the card's
    ceilings.

    Priority: a host-starved step is host-bound no matter the model
    (the chip's ceilings are unreachable while it waits); then the
    model's named scarce resource (sparse row traffic / HBM bytes);
    compute is the default when the MXU is the binding engine."""
    out: dict = {}
    spec = MODEL_FLOPS.get(model_key or "")
    if spec and examples_per_s > 0:
        out["mfu"] = round(
            examples_per_s * spec["train_flops_per_example"]
            / PEAK_BF16_FLOPS,
            4,
        )
    host_frac = sum(fractions.get(p, 0.0) for p in HOST_PHASES)
    if host_frac > 0.5:
        out["bound"] = "host"
        return out
    if spec and examples_per_s > 0:
        rows = spec.get("sparse_rows_per_example")
        if rows:
            ns_per_row = 1e9 / (examples_per_s * rows)
            floor_ns_per_row = (
                spec.get("sparse_sectors_per_row", 1) * SECTOR_BYTES
                / HBM_BYTES_PER_SEC * 1e9
            )
            out["floor_frac"] = round(floor_ns_per_row / ns_per_row, 3)
            if out["floor_frac"] > 0.5:
                out["bound"] = "sparse-row"
                return out
        hbm_bytes = spec.get("hbm_bytes_per_example")
        if hbm_bytes:
            out["bw_frac"] = round(
                examples_per_s * hbm_bytes / HBM_BYTES_PER_SEC, 3
            )
            if out["bw_frac"] > out.get("mfu", 0.0):
                out["bound"] = "hbm"
                return out
        out["bound"] = "compute"
    return out


def phase_fractions(seconds: Dict[str, float]) -> Dict[str, float]:
    """Normalize per-phase seconds to fractions of accounted time
    (sums to ~1.0 when any time is accounted; {} otherwise)."""
    total = sum(
        float(seconds.get(p, 0.0)) for p in PHASES
        if isinstance(seconds.get(p, 0.0), (int, float))
    )
    if total <= 0:
        return {}
    return {
        p: round(float(seconds.get(p, 0.0)) / total, 4)
        for p in PHASES
        if seconds.get(p)
    }


def device_memory_hwm_mb() -> Optional[float]:
    """``torch.cuda.max_memory_allocated`` of the current card, in MiB —
    None on the CPU (no card, or no CUDA context in this process)."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return round(torch.cuda.max_memory_allocated() / 2**20, 1)
    except Exception:  # any backend quirk: anatomy must never crash a step
        pass
    return None


class BuildWatcher:
    """Compile detection per watched entry point: the counterpart of the
    JAX package's ``RetraceWatcher``, which reads each jitted function's
    compile-cache size.  The port has no ``jit``; what it compiles at
    first use is its kernel library (``ops/_build.py``: ``build`` runs
    ``nvcc`` when no library for the sources exists, ``library`` loads
    it), so trainers register a PROVIDER (``() -> {name: count}``, the
    trainers' ``kernel_builds``) and ``poll()`` returns each count's
    delta since the last poll.  Polled on the host between dispatches."""

    def __init__(self):
        # Own lock: poll() runs on the task-loop thread while the
        # heartbeat thread reads `compiles` for the snapshot.
        self._lock = make_lock("BuildWatcher._lock")
        self._providers: List[Callable[[], Optional[Dict[str, int]]]] = []  # guarded-by: _lock
        self._last: Dict[str, int] = {}  # guarded-by: _lock
        self._compiles: Dict[str, int] = {}  # guarded-by: _lock

    def watch(self, provider: Callable[[], Optional[Dict[str, int]]]):
        with self._lock:
            self._providers.append(provider)

    def poll(self) -> Dict[str, int]:
        """{name: new builds} since the last poll (empty = the dispatch
        ran on what was already built)."""
        delta: Dict[str, int] = {}
        with self._lock:
            for provider in list(self._providers):
                try:
                    counts = provider() or {}
                except Exception:
                    continue
                for name, count in counts.items():
                    if not isinstance(count, int):
                        continue
                    prev = self._last.get(name, 0)
                    if count > prev:
                        delta[name] = delta.get(name, 0) + (count - prev)
                        self._compiles[name] = self._compiles.get(name, 0) + (count - prev)
                    self._last[name] = max(prev, count)
        return delta

    @property
    def compiles(self) -> Dict[str, int]:
        """Cumulative builds per watched entry point (the first included;
        retraces = builds beyond the first)."""
        with self._lock:
            return dict(self._compiles)

    def retraces_total(self) -> int:
        with self._lock:
            return sum(max(0, c - 1) for c in self._compiles.values())


class StepAnatomy:
    """Per-worker accumulator decomposing step wall time into PHASES.

    Usage (one instance per worker process, driven from the task loop —
    all clocks are host-side):

        anatomy = StepAnatomy(worker_id)
        anatomy.watch_builds(trainer.kernel_builds)
        with anatomy.phase("data_wait"):
            batch = next(batches)
        with anatomy.phase("stage"):
            staged = trainer.stage_window(batches)
        with anatomy.dispatch(n_steps, n_examples):
            trainer.train_window(staged)   # books compile OR execute
        with anatomy.phase("bookkeep"):
            report_version(); maybe_checkpoint()
        anatomy.close_window()             # one window per dispatch flush

    ``snapshot()`` is called from the heartbeat thread; mutators run on
    the task-loop thread — the lock covers the hand-off."""

    def __init__(
        self,
        worker_id: int = 0,
        clock: Callable[[], float] = time.monotonic,
        max_windows: int = MAX_SNAPSHOT_WINDOWS,
    ):
        self._lock = make_lock("StepAnatomy._lock")
        self._worker_id = int(worker_id)
        self._clock = clock
        self._watcher = BuildWatcher()
        self._model_key: Optional[str] = None
        self._open_phase: Optional[str] = None
        # Current-window accumulators.  # guarded-by: _lock
        self._acc = {p: 0.0 for p in PHASES}
        self._acc_steps = 0
        self._acc_examples = 0
        self._acc_compiles = 0
        self._acc_overlap = 0.0
        # Job-lifetime totals.  # guarded-by: _lock
        self._totals = {p: 0.0 for p in PHASES}
        self._overlap_total = 0.0
        self._steps_total = 0
        self._examples_total = 0
        self._windows: deque = deque(maxlen=int(max_windows))

    @property
    def worker_id(self) -> int:
        return self._worker_id

    def set_model(self, key_or_name: Optional[str]) -> Optional[str]:
        """Bind the analytic FLOPs row (exact MODEL_FLOPS key or a path
        to infer one from).  Returns the bound key (None = no row; MFU
        and the roofline verdict are simply omitted)."""
        key = (
            key_or_name
            if key_or_name in MODEL_FLOPS
            else infer_model_key(key_or_name or "")
        )
        with self._lock:
            self._model_key = key
        return key

    @property
    def model_key(self) -> Optional[str]:
        return self._model_key

    def watch_builds(self, provider) -> None:
        """Register a build-count provider (``() -> {name: count}``) for
        compile detection — the trainers expose ``kernel_builds``."""
        self._watcher.watch(provider)

    # -- phase clocks ---------------------------------------------------

    @contextlib.contextmanager
    def phase(self, name: str):
        """Book host wall time under one exclusive sub-phase.  Nesting
        is a caller bug (phases are exclusive by contract) and raises
        immediately rather than silently double-counting."""
        if name not in PHASES:
            raise ValueError(f"unknown step phase {name!r} (not in {PHASES})")
        with self._lock:
            if self._open_phase is not None:
                raise RuntimeError(
                    f"step phase {name!r} opened inside open phase "
                    f"{self._open_phase!r} — sub-phases are exclusive"
                )
            self._open_phase = name
        start = self._clock()
        try:
            yield
        finally:
            elapsed = max(0.0, self._clock() - start)
            with self._lock:
                self._open_phase = None
                self._acc[name] += elapsed

    def note_phase_seconds(self, name: str, seconds: float) -> None:
        """Book already-measured host seconds under a phase — for
        callers that can only attribute AFTER the fact (e.g. the task
        queue wait, which may turn out to be a WAIT idle poll that must
        NOT count as data_wait)."""
        if name not in PHASES:
            raise ValueError(f"unknown step phase {name!r} (not in {PHASES})")
        with self._lock:
            self._acc[name] += max(0.0, float(seconds))

    def note_overlap_seconds(self, seconds: float) -> None:
        """Book host seconds that ran CONCURRENTLY with device execution
        (async staging engine credit — parse/prefetch/stage hidden
        behind an outstanding dispatch).  Kept OUTSIDE the exclusive
        PHASES so phase fractions keep summing to 1.0 over time actually
        serialized on the step loop."""
        with self._lock:
            self._acc_overlap += max(0.0, float(seconds))

    @contextlib.contextmanager
    def dispatch(self, n_steps: int = 1, n_examples: int = 0):
        """Time one dispatch on the host; books ``compile`` when a
        watched build count rose during it, else ``execute``.  Also
        accumulates the window's step/example counts."""
        self._watcher.poll()  # absorb compiles that happened before us
        with self._lock:
            if self._open_phase is not None:
                raise RuntimeError(
                    f"dispatch opened inside open phase "
                    f"{self._open_phase!r} — sub-phases are exclusive"
                )
            self._open_phase = "execute"
        start = self._clock()
        try:
            yield
        finally:
            elapsed = max(0.0, self._clock() - start)
            compiled = self._watcher.poll()
            phase = "compile" if compiled else "execute"
            with self._lock:
                self._open_phase = None
                self._acc[phase] += elapsed
                self._acc_steps += int(n_steps)
                self._acc_examples += int(n_examples)
                self._acc_compiles += sum(compiled.values())

    def close_window(self) -> Optional[dict]:
        """Seal the current accumulation as one summary window (rides
        the next heartbeat snapshot).  No-op when nothing accumulated."""
        with self._lock:
            accounted = sum(self._acc.values())
            if accounted <= 0 and self._acc_steps == 0 and self._acc_overlap <= 0:
                return None
            window = {"steps": self._acc_steps, "examples": self._acc_examples}
            for p in PHASES:
                if self._acc[p] > 0:
                    window[p] = round(self._acc[p], 6)
                self._totals[p] += self._acc[p]
            if self._acc_compiles:
                window["compiles"] = self._acc_compiles
            if self._acc_overlap > 0:
                window["overlap_s"] = round(self._acc_overlap, 6)
            self._overlap_total += self._acc_overlap
            self._steps_total += self._acc_steps
            self._examples_total += self._acc_examples
            self._windows.append(window)
            self._acc = {p: 0.0 for p in PHASES}
            self._acc_steps = 0
            self._acc_examples = 0
            self._acc_compiles = 0
            self._acc_overlap = 0.0
            return window

    # -- read side ------------------------------------------------------

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return {p: round(s, 6) for p, s in self._totals.items() if s > 0}

    def snapshot(self) -> dict:
        """Bounded JSON-able anatomy summary (the ``anatomy`` sub-dict
        of the telemetry snapshot).  Per-function compile counts are journal-only detail;
        they never become metric labels."""
        with self._lock:
            windows = [dict(w) for w in self._windows]
            totals = {
                p: round(s, 6) for p, s in self._totals.items() if s > 0
            }
            steps = self._steps_total
            examples = self._examples_total
            model_key = self._model_key
            overlap_total = self._overlap_total
        snap: dict = {
            "windows": windows,
            "totals": totals,
            "steps": steps,
            "examples": examples,
        }
        if overlap_total > 0:
            snap["overlap_s"] = round(overlap_total, 6)
        compiles = self._watcher.compiles
        if compiles:
            snap["compiles"] = {
                name[:48]: count
                for name, count in sorted(compiles.items())[:8]
            }
            snap["retraces"] = self._watcher.retraces_total()
        hwm = device_memory_hwm_mb()
        if hwm is not None:
            snap["mem_hwm_mb"] = hwm
        accounted = sum(totals.values())
        if accounted > 0 and examples > 0:
            fractions = phase_fractions(totals)
            snap.update(roofline(examples / accounted, fractions, model_key))
        return snap


# ---------------------------------------------------------------------------
# Wire-side sanitation (the master ingests anatomy off the heartbeat)
# ---------------------------------------------------------------------------

_WINDOW_INT_FIELDS = ("steps", "examples", "compiles")
_WINDOW_FLOAT_FIELDS = ("overlap_s",)  # beside the PHASES floats
_SCALAR_FLOAT_FIELDS = ("mem_hwm_mb", "mfu", "floor_frac", "bw_frac",
                        "overlap_s")
_SCALAR_INT_FIELDS = ("steps", "examples", "retraces")
MAX_WIRE_WINDOWS = 8


def _clean_number(value) -> Optional[float]:
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    return None


def sanitize_anatomy(anatomy) -> Optional[dict]:
    """Whitelist a wire anatomy sub-dict.  Unlike the snapshot's core
    liveness fields (where a wrong type rejects the whole snapshot), a
    malformed anatomy degrades to None — the heartbeat's liveness/step
    signal must survive a skewed worker's broken anatomy."""
    if not isinstance(anatomy, dict):
        return None
    clean: dict = {}
    windows = anatomy.get("windows")
    if isinstance(windows, list):
        clean_windows = []
        for window in windows[-MAX_WIRE_WINDOWS:]:
            if not isinstance(window, dict):
                return None
            clean_window = {}
            for key in _WINDOW_INT_FIELDS:
                value = _clean_number(window.get(key))
                if value is not None:
                    clean_window[key] = int(value)
            for phase in PHASES:
                value = _clean_number(window.get(phase))
                if value is not None:
                    clean_window[phase] = value
            for key in _WINDOW_FLOAT_FIELDS:
                value = _clean_number(window.get(key))
                if value is not None:
                    clean_window[key] = value
            clean_windows.append(clean_window)
        clean["windows"] = clean_windows
    totals = anatomy.get("totals")
    if isinstance(totals, dict):
        clean_totals = {
            phase: _clean_number(totals.get(phase))
            for phase in PHASES
            if _clean_number(totals.get(phase)) is not None
        }
        if clean_totals:
            clean["totals"] = clean_totals
    for key in _SCALAR_INT_FIELDS:
        value = _clean_number(anatomy.get(key))
        if value is not None:
            clean[key] = int(value)
    for key in _SCALAR_FLOAT_FIELDS:
        value = _clean_number(anatomy.get(key))
        if value is not None:
            clean[key] = value
    bound = anatomy.get("bound")
    if isinstance(bound, str) and bound in BOUNDS:
        clean["bound"] = bound
    compiles = anatomy.get("compiles")
    if isinstance(compiles, dict):
        clean_compiles = {}
        valid = sorted(
            (name, count)
            for name, count in compiles.items()
            if isinstance(name, str) and _clean_number(count) is not None
        )
        for name, count in valid[:8]:
            clean_compiles[name[:48]] = int(count)
        if clean_compiles:
            clean["compiles"] = clean_compiles
    return clean or None


def journal_anatomy(worker_id: int, anatomy: dict) -> Optional[dict]:
    """Record one ``step_anatomy`` journal event from an anatomy dict
    (cumulative totals — windows stay heartbeat-only).  Shared by the
    master's TelemetryAggregator (wire snapshots) and workers without a
    telemetry carrier (Local mode, which journals its own anatomy at
    task end into the process journal).  Returns the record, or None
    when there is nothing to attribute yet."""
    from elasticdl_tpu_torch import obs

    fields = {
        key: value for key, value in anatomy.items() if key != "windows"
    }
    fractions = phase_fractions(anatomy.get("totals") or {})
    if fractions:
        fields["fractions"] = fractions
        fields["dominant_phase"] = max(fractions, key=fractions.get)
    elif not fields:
        return None
    return obs.journal().record(
        "step_anatomy", worker_id=worker_id, **fields
    )


def fleet_attribution(snapshots: Dict[int, dict]) -> dict:
    """Fold per-worker telemetry snapshots (with ``anatomy``) into the
    fleet view: summed per-phase seconds, normalized fractions, the
    bottleneck phase, and each worker's dominant phase.  Per-worker
    detail stays journal/report-side — only the bounded per-phase
    aggregates feed metrics."""
    fleet_seconds = {p: 0.0 for p in PHASES}
    workers: Dict[int, dict] = {}
    retraces = 0
    for wid, snapshot in snapshots.items():
        anatomy = snapshot.get("anatomy")
        if not isinstance(anatomy, dict):
            continue
        retraces += int(anatomy.get("retraces", 0) or 0)
        totals = anatomy.get("totals") or {}
        fractions = phase_fractions(totals)
        if not fractions:
            continue
        for phase in PHASES:
            fleet_seconds[phase] += float(totals.get(phase, 0.0))
        workers[wid] = {
            "fractions": fractions,
            "dominant_phase": max(fractions, key=fractions.get),
            "bound": anatomy.get("bound"),
        }
    fractions = phase_fractions(fleet_seconds)
    return {
        "seconds": {p: round(s, 6) for p, s in fleet_seconds.items() if s > 0},
        "fractions": fractions,
        "bottleneck": max(fractions, key=fractions.get) if fractions else None,
        "workers": workers,
        "retraces": retraces,
    }
