"""Model-quality observability plane: the port's copy of
``elasticdl_tpu/obs/quality.py`` (online label-join evaluation,
train/serve drift sketches, and the canary gate of the continuous loop).

The obs stack watches the *system* — goodput, step anatomy, traces, SLO
burn rates — but a recommender's first page is whether the MODEL is any
good online: AUC/calibration against delayed click labels and
training-serving skew.  This module is that plane, and it closes the
observe→decide loop the SLO plane opened: a delta checkpoint that
regresses quality beyond threshold is HELD out of serving before
`apply_delta` ever runs.

Three pieces, wired across the planes:

- **`QualityLedger`** — the label-join ledger.  Serving samples
  predictions into a bounded pending-join ring keyed by trace id
  (riding `ExemplarSampler`, so the hot path pays O(sampled), not
  O(requests)); the delayed-label feedback channel (the frontend's
  ``labels`` request, fed by ``bench/loadgen.run_label_feed`` from
  ``data/stream.feedback_labels``) replays labels; the joiner matches
  within a watermark window and maintains windowed online AUC / logloss
  / calibration buckets / prediction-mean+entropy drift, journaled as
  `quality_window` events and exported as `elasticdl_quality_*` gauges
  (which `MetricsHistory` then samples, so the `quality_slo` burn-rate
  alert in obs/slo.py rides the existing SLO plane for free).  Joined
  labeled batches also feed the gate's `ReplayBuffer`.

- **`FeatureSketch` / `DriftMonitor`** — compact feature-id frequency
  (+ optional embedding-row-norm histogram) sketches, computed at train
  time (worker step loop via `note_train_batch`, on the host batch
  before it is staged) and serve time (the micro-batcher's dispatch
  hook), compared as total-variation train-serve divergence with
  edge-triggered `quality_drift` journal events.  All sketch math is
  host-side numpy; it never reads a device tensor.

- **`CanaryGate`** — shadow-evaluates a resolved delta on the replay
  buffer of recent labeled batches BEFORE the swap: candidate-vs-live
  logloss/AUC regression beyond threshold yields outcome ``held`` (the
  `DeltaWatcher` keeps the old generation serving and retries next
  poll); a healthy delta yields ``passed``; `--quality_gate_force`
  yields ``forced``.  When quality is UNKNOWN (label-feed outage, too
  few joined rows, shadow-eval fault) the gate degrades by explicit
  policy — ``open`` (default: don't block swaps on a broken label
  pipe) or ``closed`` — and says so in the verdict, so the journaled
  `quality_gate` event records *why* a swap proceeded blind.

Split-process caveat: the train-side sketch hook
(`note_train_batch`) observes into a process-local `DriftMonitor`, so
two-sided divergence is computed where trainer and replica share a
process (the in-process runs).  Split-process deployments see
serve-side sketches only until a transport ships the train sketch
across; the drift gauge simply stays unset there.

Fault sites (`common/faults.py`): `quality.label_join` (error = drop
the label, truncate = deliver it twice) and `quality.shadow_eval`
(error = canary evaluation blows up → quality unknown).

`python -m elasticdl_tpu_torch.obs.quality --selftest` proves the join
discipline, window math, drift edges, gate verdicts, and fault
degradation deterministically on the CPU.
"""

from __future__ import annotations

import argparse
import math
import sys
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("obs.quality")

_EPS = 1e-7


# ---------------------------------------------------------------------------
# Pure metric math (host-side numpy; None = undefined, never NaN)
# ---------------------------------------------------------------------------


def binary_auc(labels: np.ndarray, preds: np.ndarray) -> Optional[float]:
    """Rank-based ROC AUC with tie averaging (the Mann-Whitney U form).
    Returns None when the window holds a single class — undefined, and
    the caller must not fold it into an average as if it were 0.5."""
    labels = np.asarray(labels, dtype=np.float64).ravel()
    preds = np.asarray(preds, dtype=np.float64).ravel()
    if labels.shape != preds.shape:
        raise ValueError("labels/preds shape mismatch")
    pos = int((labels > 0.5).sum())
    neg = labels.size - pos
    if pos == 0 or neg == 0:
        return None
    order = np.argsort(preds, kind="mergesort")
    ranks = np.empty(preds.size, dtype=np.float64)
    ranks[order] = np.arange(1, preds.size + 1, dtype=np.float64)
    # average ranks across tied prediction values
    sorted_preds = preds[order]
    i = 0
    while i < sorted_preds.size:
        j = i
        while (j + 1 < sorted_preds.size
               and sorted_preds[j + 1] == sorted_preds[i]):
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    rank_sum_pos = float(ranks[labels > 0.5].sum())
    u = rank_sum_pos - pos * (pos + 1) / 2.0
    return u / (pos * neg)


def binary_logloss(labels: np.ndarray, preds: np.ndarray,
                   eps: float = _EPS) -> float:
    labels = np.asarray(labels, dtype=np.float64).ravel()
    preds = np.clip(np.asarray(preds, dtype=np.float64).ravel(),
                    eps, 1.0 - eps)
    if labels.shape != preds.shape:
        raise ValueError("labels/preds shape mismatch")
    if labels.size == 0:
        raise ValueError("logloss of an empty window")
    return float(-np.mean(labels * np.log(preds)
                          + (1.0 - labels) * np.log(1.0 - preds)))


def calibration_table(labels: np.ndarray, preds: np.ndarray,
                      bins: int = 10) -> List[dict]:
    """Equal-width predicted-probability buckets: each row compares the
    bucket's mean predicted CTR against its observed CTR.  Empty
    buckets are omitted (a table row with no mass says nothing)."""
    labels = np.asarray(labels, dtype=np.float64).ravel()
    preds = np.asarray(preds, dtype=np.float64).ravel()
    idx = np.clip((preds * bins).astype(np.int64), 0, bins - 1)
    table: List[dict] = []
    for b in range(bins):
        mask = idx == b
        count = int(mask.sum())
        if count == 0:
            continue
        table.append({
            "lo": b / bins,
            "hi": (b + 1) / bins,
            "count": count,
            "mean_pred": float(preds[mask].mean()),
            "mean_label": float(labels[mask].mean()),
        })
    return table


def calibration_error(table: Sequence[dict]) -> Optional[float]:
    """Expected calibration error: count-weighted |pred - observed|
    over the bucket table.  None on an empty table."""
    total = sum(row["count"] for row in table)
    if total == 0:
        return None
    return float(sum(
        row["count"] * abs(row["mean_pred"] - row["mean_label"])
        for row in table
    ) / total)


def prediction_entropy(preds: np.ndarray, eps: float = _EPS) -> float:
    """Mean binary entropy of the predictions — a collapsed model
    (all-0 or all-1 outputs) drives this to zero, which is a drift
    signal even before labels arrive."""
    p = np.clip(np.asarray(preds, dtype=np.float64).ravel(),
                eps, 1.0 - eps)
    if p.size == 0:
        raise ValueError("entropy of an empty window")
    return float(-np.mean(p * np.log(p) + (1.0 - p) * np.log(1.0 - p)))


# ---------------------------------------------------------------------------
# Replay buffer (labeled batches for the canary gate)
# ---------------------------------------------------------------------------


class ReplayBuffer:
    """Bounded ring of recent labeled feature batches — the canary
    gate's shadow-evaluation set.  Batches enter when the ledger joins
    a sampled prediction with its label, so the buffer is exactly the
    population the online window scored."""

    def __init__(self, max_batches: int = 32):
        self._lock = make_lock("ReplayBuffer._lock")
        # guarded-by: _lock
        self._batches: deque = deque(maxlen=int(max_batches))

    def add(self, features: Dict[str, np.ndarray],
            labels: np.ndarray) -> None:
        batch = (
            {k: np.asarray(v).copy() for k, v in features.items()},
            np.asarray(labels, dtype=np.float32).copy(),
        )
        with self._lock:
            self._batches.append(batch)

    def batches(self) -> List[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        with self._lock:
            return list(self._batches)

    def rows(self) -> int:
        with self._lock:
            return sum(int(labels.shape[0]) for _, labels in self._batches)


# ---------------------------------------------------------------------------
# Label-join ledger
# ---------------------------------------------------------------------------


class QualityLedger:
    """Joins sampled serving predictions with delayed feedback labels
    and maintains the windowed online-quality metrics.

    `note_prediction` is called from the exemplar sampler (already
    O(sampled)); `note_label` from the label feed (frontend `labels`
    RPC or a caller).  Predictions wait in a bounded pending ring for
    at most `join_window_s` of the caller-owned clock; labels for
    expired or never-sampled requests count as `orphans` rather than
    erroring — a join plane must absorb feed disorder."""

    def __init__(
        self,
        window_size: int = 2048,
        join_window_s: float = 60.0,
        max_pending: int = 4096,
        calibration_bins: int = 10,
        origin: str = "",
        replay: Optional[ReplayBuffer] = None,
    ):
        if window_size <= 0 or max_pending <= 0:
            raise ValueError("window_size/max_pending must be > 0")
        if join_window_s <= 0:
            raise ValueError("join_window_s must be > 0")
        self._window_size = int(window_size)
        self._join_window_s = float(join_window_s)
        self._max_pending = int(max_pending)
        self._calibration_bins = int(calibration_bins)
        self._origin = origin
        self._replay = replay
        self._lock = make_lock("QualityLedger._lock")
        # guarded-by: _lock — trace_id -> (preds, features|None, t_noted)
        self._pending: "OrderedDict[str, tuple]" = OrderedDict()
        # guarded-by: _lock — joined (pred, label) scalar pairs
        self._window: deque = deque(maxlen=self._window_size)
        # guarded-by: _lock
        self._predictions_total = 0
        self._labels_total = 0
        self._joined = 0
        self._expired = 0
        self._orphans = 0
        self._dropped_injected = 0
        self._duplicates_injected = 0
        registry = obs.registry()
        self._g_auc = registry.gauge(
            "elasticdl_quality_auc",
            "Windowed online AUC of joined (prediction, label) pairs",
            labelnames=("origin",))
        self._g_logloss = registry.gauge(
            "elasticdl_quality_logloss",
            "Windowed online logloss of joined pairs",
            labelnames=("origin",))
        self._g_cal = registry.gauge(
            "elasticdl_quality_calibration_error",
            "Windowed expected calibration error (predicted vs observed)",
            labelnames=("origin",))
        self._g_pred_mean = registry.gauge(
            "elasticdl_quality_prediction_mean",
            "Windowed mean predicted probability",
            labelnames=("origin",))
        self._g_joined = registry.gauge(
            "elasticdl_quality_joined_total",
            "Total (prediction, label) pairs joined since start",
            labelnames=("origin",))
        self._g_pending = registry.gauge(
            "elasticdl_quality_pending_joins",
            "Sampled predictions awaiting their delayed label",
            labelnames=("origin",))

    @property
    def join_window_s(self) -> float:
        return self._join_window_s

    def note_prediction(
        self,
        trace_id: str,
        predictions: np.ndarray,
        now: float,
        features: Optional[Dict[str, np.ndarray]] = None,
    ) -> None:
        """A sampled served request's predictions enter the pending
        ring (features ride along so a later join can feed the gate's
        replay buffer)."""
        preds = np.asarray(predictions, dtype=np.float32).ravel().copy()
        feats = (None if features is None else
                 {k: np.asarray(v).copy() for k, v in features.items()})
        with self._lock:
            self._predictions_total += 1
            self._pending[str(trace_id)] = (preds, feats, float(now))
            self._pending.move_to_end(str(trace_id))
            self._expire_locked(float(now))

    def note_label(self, trace_id: str, labels: np.ndarray,
                   now: float) -> bool:
        """A delayed feedback label arrives; join it if its prediction
        is still pending.  Returns True on a join.  The
        `quality.label_join` fault site models feed pathologies: kind
        `error` drops the label on the floor, kind `truncate` delivers
        it twice (an at-least-once feed duplicating)."""
        spec = faults.fire("quality.label_join")
        if spec is not None and spec.kind == "error":
            logger.warning(
                "FAULT INJECTION: label for %s dropped", trace_id)
            with self._lock:
                self._labels_total += 1
                self._dropped_injected += 1
            return False
        duplicate = spec is not None and spec.kind == "truncate"
        label_arr = np.asarray(labels, dtype=np.float32).ravel()
        joined = self._join(str(trace_id), label_arr, float(now))
        if duplicate:
            logger.warning(
                "FAULT INJECTION: label for %s delivered twice", trace_id)
            with self._lock:
                self._duplicates_injected += 1
            self._join(str(trace_id), label_arr, float(now))
        return joined

    def _join(self, trace_id: str, labels: np.ndarray,
              now: float) -> bool:
        replay_feed = None
        with self._lock:
            self._labels_total += 1
            self._expire_locked(now)
            entry = self._pending.pop(trace_id, None)
            if entry is None:
                # late (already expired), duplicate, or never sampled
                self._orphans += 1
                return False
            preds, feats, _ = entry
            n = min(preds.size, labels.size)
            for p, y in zip(preds[:n], labels[:n]):
                self._window.append((float(p), float(y)))
            self._joined += int(n)
            if feats is not None and self._replay is not None:
                replay_feed = (feats, labels[:n])
        if replay_feed is not None:
            self._replay.add(*replay_feed)
        return True

    def _expire_locked(self, now: float) -> None:
        # guarded-by: _lock (caller holds)
        horizon = now - self._join_window_s
        while self._pending:
            oldest_id, (_, _, t_noted) = next(iter(self._pending.items()))
            if t_noted >= horizon and len(self._pending) <= self._max_pending:
                break
            self._pending.pop(oldest_id)
            self._expired += 1

    def pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(labels, predictions) of the current window — the exact set
        an offline audit must reproduce the online AUC from."""
        with self._lock:
            window = list(self._window)
        if not window:
            return (np.zeros(0, dtype=np.float64),
                    np.zeros(0, dtype=np.float64))
        preds, labels = zip(*window)
        return np.asarray(labels, dtype=np.float64), np.asarray(
            preds, dtype=np.float64)

    def snapshot(self) -> dict:
        """Current windowed metrics + join counters.  Metric values are
        None (not a sentinel number) whenever the window can't define
        them."""
        with self._lock:
            window = list(self._window)
            counters = {
                "predictions_total": self._predictions_total,
                "labels_total": self._labels_total,
                "joined": self._joined,
                "expired": self._expired,
                "orphans": self._orphans,
                "pending": len(self._pending),
                "dropped_injected": self._dropped_injected,
                "duplicates_injected": self._duplicates_injected,
            }
        snap = dict(counters)
        snap["window"] = len(window)
        if window:
            preds = np.asarray([p for p, _ in window], dtype=np.float64)
            labels = np.asarray([y for _, y in window], dtype=np.float64)
            table = calibration_table(labels, preds,
                                      bins=self._calibration_bins)
            snap.update(
                auc=binary_auc(labels, preds),
                logloss=binary_logloss(labels, preds),
                calibration_error=calibration_error(table),
                calibration=table,
                prediction_mean=float(preds.mean()),
                label_mean=float(labels.mean()),
                entropy=prediction_entropy(preds),
            )
        else:
            snap.update(auc=None, logloss=None, calibration_error=None,
                        calibration=[], prediction_mean=None,
                        label_mean=None, entropy=None)
        return snap

    def journal_window(self, now: float) -> Optional[dict]:
        """Export the window as gauges + one `quality_window` journal
        event.  Silent (returns None) until the first prediction is
        sampled — a pre-quality run journals nothing new."""
        snap = self.snapshot()
        if snap["predictions_total"] == 0:
            return None
        origin = self._origin
        # Gauges always get a value so the SLO plane's threshold math
        # sees a series: AUC defaults to the no-skill 0.5 and logloss
        # to 0.0 while the window is empty (quality unknown is not
        # quality bad — the quality_slo only pages on real windows).
        self._g_auc.set(
            snap["auc"] if snap["auc"] is not None else 0.5, origin=origin)
        self._g_logloss.set(
            snap["logloss"] if snap["logloss"] is not None else 0.0,
            origin=origin)
        if snap["calibration_error"] is not None:
            self._g_cal.set(snap["calibration_error"], origin=origin)
        if snap["prediction_mean"] is not None:
            self._g_pred_mean.set(snap["prediction_mean"], origin=origin)
        self._g_joined.set(snap["joined"], origin=origin)
        self._g_pending.set(snap["pending"], origin=origin)
        extra = {
            key: snap[key]
            for key in ("auc", "logloss", "calibration_error",
                        "prediction_mean", "label_mean", "entropy")
            if snap[key] is not None
        }
        obs.journal().record(
            "quality_window",
            joined=snap["joined"],
            window=snap["window"],
            pending=snap["pending"],
            expired=snap["expired"],
            orphans=snap["orphans"],
            origin=origin,
            **extra,
        )
        return snap


# ---------------------------------------------------------------------------
# Train/serve skew sketches
# ---------------------------------------------------------------------------


class FeatureSketch:
    """Compact distribution sketch of a feature stream: feature-id
    frequency folded into `bins` hash buckets, plus an optional
    log-spaced embedding-row-norm histogram.  O(bins) memory however
    many ids flow through; all math is host-side numpy."""

    def __init__(self, bins: int = 64):
        if bins <= 0:
            raise ValueError("bins must be > 0")
        self._bins = int(bins)
        self._id_counts = np.zeros(self._bins, dtype=np.int64)
        # log-spaced norm edges: [0, 1e-3) .. [1e3, inf)
        self._norm_edges = np.logspace(-3, 3, self._bins - 1)
        self._norm_counts = np.zeros(self._bins, dtype=np.int64)
        self._total_ids = 0
        self._total_norms = 0

    @property
    def bins(self) -> int:
        return self._bins

    @property
    def total_ids(self) -> int:
        return self._total_ids

    def update_ids(self, features: Dict[str, np.ndarray]) -> None:
        for name in sorted(features):
            arr = np.asarray(features[name])
            if not np.issubdtype(arr.dtype, np.integer):
                continue
            ids = arr.astype(np.int64).ravel() % self._bins
            self._id_counts += np.bincount(ids, minlength=self._bins)
            self._total_ids += ids.size

    def update_norms(self, rows: np.ndarray) -> None:
        """Histogram the L2 norms of embedding rows (one norm per
        row of a (N, dim) array, or the values of a 1-D norm array)."""
        arr = np.asarray(rows, dtype=np.float64)
        norms = (np.linalg.norm(arr, axis=-1).ravel()
                 if arr.ndim > 1 else np.abs(arr).ravel())
        idx = np.searchsorted(self._norm_edges, norms, side="right")
        self._norm_counts += np.bincount(idx, minlength=self._bins)
        self._total_norms += norms.size

    def id_frequency(self) -> Optional[np.ndarray]:
        if self._total_ids == 0:
            return None
        return self._id_counts / float(self._total_ids)

    def norm_frequency(self) -> Optional[np.ndarray]:
        if self._total_norms == 0:
            return None
        return self._norm_counts / float(self._total_norms)

    def divergence(self, other: "FeatureSketch") -> Optional[float]:
        """Total-variation distance between the two id-frequency
        sketches (0 = identical, 1 = disjoint); when both sides also
        carry norm histograms, the max of the two distances.  None
        until both sides have mass — incomparable is not zero."""
        if self._bins != other._bins:
            raise ValueError("sketch bin counts differ")
        p, q = self.id_frequency(), other.id_frequency()
        if p is None or q is None:
            return None
        tv = 0.5 * float(np.abs(p - q).sum())
        pn, qn = self.norm_frequency(), other.norm_frequency()
        if pn is not None and qn is not None:
            tv = max(tv, 0.5 * float(np.abs(pn - qn).sum()))
        return tv


class DriftMonitor:
    """Two `FeatureSketch`es — train side and serve side — compared on
    a caller tick as train-serve divergence, with edge-triggered
    `quality_drift` journal events (one per breach, one per clear, like
    the freshness tracker's discipline)."""

    def __init__(self, threshold: float = 0.25, bins: int = 64,
                 origin: str = ""):
        if not 0.0 < threshold <= 1.0:
            raise ValueError("drift threshold must be in (0, 1]")
        self._threshold = float(threshold)
        self._origin = origin
        self._lock = make_lock("DriftMonitor._lock")
        # guarded-by: _lock
        self._train = FeatureSketch(bins)
        # guarded-by: _lock
        self._serve = FeatureSketch(bins)
        # guarded-by: _lock
        self._breached = False
        self._g_drift = obs.registry().gauge(
            "elasticdl_quality_drift",
            "Train-serve feature distribution divergence "
            "(total variation)",
            labelnames=("origin",))

    @property
    def threshold(self) -> float:
        return self._threshold

    def observe_train(self, features: Dict[str, np.ndarray]) -> None:
        with self._lock:
            self._train.update_ids(features)

    def observe_train_norms(self, rows: np.ndarray) -> None:
        with self._lock:
            self._train.update_norms(rows)

    def observe_serve(self, features: Dict[str, np.ndarray]) -> None:
        with self._lock:
            self._serve.update_ids(features)

    def observe_serve_norms(self, rows: np.ndarray) -> None:
        with self._lock:
            self._serve.update_norms(rows)

    def divergence(self) -> Optional[float]:
        with self._lock:
            return self._train.divergence(self._serve)

    def evaluate(self, now: float) -> Optional[float]:
        """Tick: compute divergence, export the gauge, journal a
        `quality_drift` event on each breach/clear EDGE (never one per
        tick).  Returns the divergence (None while incomparable)."""
        edge = None
        with self._lock:
            tv = self._train.divergence(self._serve)
            if tv is not None:
                breach = tv > self._threshold
                if breach and not self._breached:
                    edge = "breach"
                elif not breach and self._breached:
                    edge = "clear"
                self._breached = breach
        if tv is not None:
            self._g_drift.set(tv, origin=self._origin)
        if edge is not None:
            logger.warning("train-serve drift %s: tv=%.4f threshold=%.4f",
                           edge, tv, self._threshold)
            obs.journal().record(
                "quality_drift",
                state=edge,
                divergence=float(tv),
                threshold=self._threshold,
                origin=self._origin,
            )
        return tv


# -- module-level train-side hook (worker step loop) ------------------------

_train_monitor: Optional[DriftMonitor] = None


def enable_train_sketch(monitor: Optional[DriftMonitor]) -> None:
    """Point the worker-side hook at a monitor (None disables)."""
    global _train_monitor
    _train_monitor = monitor


def train_monitor() -> Optional[DriftMonitor]:
    return _train_monitor


def note_train_batch(features) -> None:
    """Worker step-loop hook: free when no monitor is enabled, and
    swallows its own errors — sketching must never fail a train step."""
    monitor = _train_monitor
    if monitor is None:
        return
    try:
        if isinstance(features, dict):
            monitor.observe_train(features)
    except Exception:
        logger.exception("train sketch update failed (ignored)")


# ---------------------------------------------------------------------------
# Canary gate
# ---------------------------------------------------------------------------


class CanaryGate:
    """Shadow-evaluates a candidate generation against the live one on
    the replay buffer of recent labeled batches, BEFORE the swap.

    `evaluate` never raises: every path collapses to a verdict dict —
    outcome ``passed`` | ``held`` | ``forced`` plus the evidence
    (rows scored, both sides' logloss/AUC, and whether quality was
    ``known`` or ``unknown``).  Unknown quality (label outage, cold
    buffer, shadow-eval fault) resolves by `unknown_policy`: ``open``
    passes the swap (a broken label pipe must not freeze serving
    forever), ``closed`` holds it; either way the verdict says
    quality="unknown" so the journal records the blind swap."""

    def __init__(
        self,
        replay: ReplayBuffer,
        max_logloss_regress: float = 0.10,
        max_auc_drop: float = 0.05,
        min_rows: int = 64,
        unknown_policy: str = "open",
        force: bool = False,
    ):
        if unknown_policy not in ("open", "closed"):
            raise ValueError(
                f"unknown_policy must be open|closed, "
                f"got {unknown_policy!r}")
        if max_logloss_regress < 0 or max_auc_drop < 0:
            raise ValueError("gate thresholds must be >= 0")
        self._replay = replay
        self._max_logloss_regress = float(max_logloss_regress)
        self._max_auc_drop = float(max_auc_drop)
        self._min_rows = int(min_rows)
        self._unknown_policy = unknown_policy
        self._force = bool(force)

    def _unknown(self, reason: str, rows: int) -> dict:
        if self._force:
            outcome = "forced"
        elif self._unknown_policy == "open":
            outcome = "passed"
        else:
            outcome = "held"
        return {"outcome": outcome, "quality": "unknown",
                "reason": reason, "rows": rows}

    def evaluate(
        self,
        baseline_fn: Callable[[Dict[str, np.ndarray]], np.ndarray],
        candidate_fn: Callable[[Dict[str, np.ndarray]], np.ndarray],
    ) -> dict:
        spec = faults.fire("quality.shadow_eval")
        if spec is not None and spec.kind == "error":
            logger.warning("FAULT INJECTION: shadow eval failed (%s)",
                           spec.arg or "injected")
            return self._unknown(
                f"shadow_eval_fault:{spec.arg or 'injected'}", 0)
        batches = self._replay.batches()
        rows = sum(int(labels.shape[0]) for _, labels in batches)
        if rows < self._min_rows:
            return self._unknown("insufficient_labeled_rows", rows)
        base_chunks: List[np.ndarray] = []
        cand_chunks: List[np.ndarray] = []
        label_chunks: List[np.ndarray] = []
        try:
            for features, labels in batches:
                n = int(labels.shape[0])
                base = np.asarray(
                    baseline_fn(features), dtype=np.float64).ravel()[:n]
                cand = np.asarray(
                    candidate_fn(features), dtype=np.float64).ravel()[:n]
                if base.size != n or cand.size != n:
                    raise ValueError(
                        f"shadow eval returned {base.size}/{cand.size} "
                        f"predictions for {n} rows")
                base_chunks.append(base)
                cand_chunks.append(cand)
                label_chunks.append(
                    np.asarray(labels, dtype=np.float64).ravel()[:n])
        except Exception as exc:  # a broken candidate is unknown, not fatal
            logger.exception("canary shadow evaluation failed")
            return self._unknown(f"shadow_eval_error:{exc}", rows)
        labels_all = np.concatenate(label_chunks)
        base_all = np.concatenate(base_chunks)
        cand_all = np.concatenate(cand_chunks)
        base_logloss = binary_logloss(labels_all, base_all)
        cand_logloss = binary_logloss(labels_all, cand_all)
        base_auc = binary_auc(labels_all, base_all)
        cand_auc = binary_auc(labels_all, cand_all)
        verdict = {
            "quality": "known",
            "rows": rows,
            "baseline_logloss": base_logloss,
            "candidate_logloss": cand_logloss,
        }
        if base_auc is not None:
            verdict["baseline_auc"] = base_auc
        if cand_auc is not None:
            verdict["candidate_auc"] = cand_auc
        reasons: List[str] = []
        if cand_logloss - base_logloss > self._max_logloss_regress:
            reasons.append(
                f"logloss_regress:{cand_logloss - base_logloss:.4f}")
        if (base_auc is not None and cand_auc is not None
                and base_auc - cand_auc > self._max_auc_drop):
            reasons.append(f"auc_drop:{base_auc - cand_auc:.4f}")
        if reasons:
            verdict["reason"] = ",".join(reasons)
            verdict["outcome"] = "forced" if self._force else "held"
        else:
            verdict["reason"] = "within_thresholds"
            verdict["outcome"] = "passed"
        return verdict


# ---------------------------------------------------------------------------
# Selftest (quality-gates; deterministic, CPU-only, virtual clock)
# ---------------------------------------------------------------------------


def _selftest_math() -> None:
    labels = np.array([0, 0, 1, 1], dtype=np.float64)
    assert binary_auc(labels, np.array([0.1, 0.2, 0.8, 0.9])) == 1.0
    assert binary_auc(labels, np.array([0.9, 0.8, 0.2, 0.1])) == 0.0
    assert abs(binary_auc(labels, np.array([0.5, 0.5, 0.5, 0.5])) - 0.5) \
        < 1e-12  # full tie -> 0.5 by tie averaging
    assert binary_auc(np.ones(4), np.linspace(0, 1, 4)) is None
    ll = binary_logloss(labels, np.array([0.1, 0.2, 0.8, 0.9]))
    assert 0.0 < ll < 0.25, ll
    perfect = np.concatenate([np.full(50, 0.2), np.full(50, 0.8)])
    obs_labels = np.concatenate([
        np.r_[np.ones(10), np.zeros(40)],   # 0.2 observed
        np.r_[np.ones(40), np.zeros(10)],   # 0.8 observed
    ])
    table = calibration_table(obs_labels, perfect, bins=10)
    ece = calibration_error(table)
    assert ece is not None and ece < 1e-9, ece
    assert calibration_error([]) is None
    assert prediction_entropy(np.full(8, 0.5)) > \
        prediction_entropy(np.full(8, 0.01))


def _selftest_ledger(tmp: str) -> None:
    import json
    import os

    journal_path = obs.init_journal(os.path.join(tmp, "ledger"))
    replay = ReplayBuffer(max_batches=8)
    ledger = QualityLedger(window_size=64, join_window_s=5.0,
                           origin="selftest", replay=replay)
    rng = np.random.default_rng(7)
    # quality ledger silent before any prediction
    assert ledger.journal_window(0.0) is None
    # sample 20 predictions with features, labels arrive for 15
    for i in range(20):
        feats = {"user": np.array([i, i + 1], dtype=np.int64)}
        preds = rng.uniform(0.05, 0.95, size=2)
        ledger.note_prediction(f"t{i}", preds, now=float(i) * 0.1,
                               features=feats)
    for i in range(15):
        labels = rng.integers(0, 2, size=2).astype(np.float32)
        assert ledger.note_label(f"t{i}", labels, now=2.0)
    snap = ledger.snapshot()
    assert snap["joined"] == 30 and snap["pending"] == 5, snap
    assert replay.rows() == 16  # ring bounded at 8 batches x 2 rows
    # orphan: label with no pending prediction
    assert not ledger.note_label("never-sampled", np.zeros(1), now=2.0)
    assert ledger.snapshot()["orphans"] == 1
    # watermark expiry: remaining 5 predictions age out
    ledger.note_prediction("late", np.array([0.5]), now=100.0)
    snap = ledger.snapshot()
    assert snap["expired"] == 5 and snap["pending"] == 1, snap
    # online == offline on the same joined set
    y, p = ledger.pairs()
    assert snap["auc"] == binary_auc(y, p)
    assert abs(snap["logloss"] - binary_logloss(y, p)) < 1e-12
    # journal_window emits a schema-shaped event
    out = ledger.journal_window(now=100.0)
    assert out is not None and out["window"] == 30
    obs.journal().configure(None)
    with open(journal_path) as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    windows = [e for e in events if e["event"] == "quality_window"]
    assert len(windows) == 1
    for key in ("joined", "origin", "auc", "logloss", "window"):
        assert key in windows[0], key

    # fault site: label drop, then duplicate delivery
    faults.install("quality.label_join:error@1")
    try:
        ledger.note_prediction("drop-me", np.array([0.7]), now=101.0)
        assert not ledger.note_label("drop-me", np.ones(1), now=101.0)
        assert ledger.snapshot()["dropped_injected"] == 1
    finally:
        faults.clear()
    faults.install("quality.label_join:truncate@1")
    try:
        before = ledger.snapshot()["orphans"]
        ledger.note_prediction("twice", np.array([0.7]), now=102.0)
        assert ledger.note_label("twice", np.ones(1), now=102.0)
        snap = ledger.snapshot()
        # second delivery of the same label is an orphan, not a double join
        assert snap["duplicates_injected"] == 1
        assert snap["orphans"] == before + 1
    finally:
        faults.clear()


def _selftest_drift(tmp: str) -> None:
    import json
    import os

    journal_path = obs.init_journal(os.path.join(tmp, "drift"))
    monitor = DriftMonitor(threshold=0.3, bins=32, origin="selftest")
    assert monitor.evaluate(0.0) is None  # incomparable, no event
    same = {"user": np.arange(256, dtype=np.int64)}
    monitor.observe_train(same)
    monitor.observe_serve(same)
    tv = monitor.evaluate(1.0)
    assert tv is not None and tv < 1e-9
    # serve distribution collapses onto one bucket -> breach edge
    monitor.observe_serve(
        {"user": np.zeros(100000, dtype=np.int64)})
    assert monitor.evaluate(2.0) > 0.3
    assert monitor.evaluate(3.0) > 0.3  # still breached: no second event
    # train side follows -> clear edge
    monitor.observe_train(
        {"user": np.zeros(100000, dtype=np.int64)})
    assert monitor.evaluate(4.0) < 0.3
    obs.journal().configure(None)
    with open(journal_path) as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    drift = [e for e in events if e["event"] == "quality_drift"]
    assert [e["state"] for e in drift] == ["breach", "clear"], drift
    for e in drift:
        assert "divergence" in e and "origin" in e
    # norm-histogram path
    sketch_a, sketch_b = FeatureSketch(16), FeatureSketch(16)
    sketch_a.update_ids(same)
    sketch_b.update_ids(same)
    sketch_a.update_norms(np.full((32, 4), 0.01))
    sketch_b.update_norms(np.full((32, 4), 100.0))
    assert sketch_a.divergence(sketch_b) > 0.9


def _selftest_gate() -> None:
    rng = np.random.default_rng(11)
    replay = ReplayBuffer(max_batches=8)
    # labels follow a noisy monotone rule on a dense score
    scores = {}
    for b in range(6):
        feats = {"user": rng.integers(0, 100, size=32).astype(np.int64)}
        s = (feats["user"] % 97) / 97.0
        labels = (rng.uniform(size=32) < s).astype(np.float32)
        replay.add(feats, labels)
        scores[b] = s

    def good(features):
        return np.clip((features["user"] % 97) / 97.0, 0.02, 0.98)

    def poisoned(features):
        return 1.0 - good(features)

    gate = CanaryGate(replay, max_logloss_regress=0.10,
                      max_auc_drop=0.05, min_rows=64)
    held = gate.evaluate(good, poisoned)
    assert held["outcome"] == "held" and held["quality"] == "known", held
    assert "logloss_regress" in held["reason"]
    passed = gate.evaluate(good, good)
    assert passed["outcome"] == "passed", passed
    assert passed["rows"] == 6 * 32
    # forced overrides a hold, with the evidence intact
    forced = CanaryGate(replay, max_logloss_regress=0.10, min_rows=64,
                        force=True).evaluate(good, poisoned)
    assert forced["outcome"] == "forced" and "logloss_regress" in \
        forced["reason"]
    # cold buffer: unknown -> policy open passes, closed holds
    cold = ReplayBuffer()
    open_gate = CanaryGate(cold, unknown_policy="open")
    v = open_gate.evaluate(good, good)
    assert v["outcome"] == "passed" and v["quality"] == "unknown"
    closed_gate = CanaryGate(cold, unknown_policy="closed")
    v = closed_gate.evaluate(good, good)
    assert v["outcome"] == "held" and v["quality"] == "unknown"
    # shadow-eval fault -> unknown, not a crash
    faults.install("quality.shadow_eval:error=boom@1")
    try:
        v = gate.evaluate(good, good)
        assert v["quality"] == "unknown" and "shadow_eval_fault" in \
            v["reason"], v
    finally:
        faults.clear()
    # a candidate_fn that raises is unknown too
    def broken(features):
        raise RuntimeError("candidate blew up")
    v = gate.evaluate(good, broken)
    assert v["quality"] == "unknown" and "shadow_eval_error" in v["reason"]


def _selftest() -> int:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _selftest_math()
        _selftest_ledger(tmp)
        _selftest_drift(tmp)
        _selftest_gate()
    print("quality selftest: join ledger, window math, drift edges, "
          "canary gate, fault degradation OK")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Model-quality plane selftest")
    parser.add_argument("--selftest", action="store_true",
                        help="run the deterministic CPU selftest")
    args = parser.parse_args(argv)
    if args.selftest:
        return _selftest()
    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
