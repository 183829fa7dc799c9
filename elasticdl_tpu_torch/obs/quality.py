"""The canary gate of the continuous loop: the port's copy of the gate
half of ``elasticdl_tpu/obs/quality.py``.

``CanaryGate`` shadow-evaluates a resolved delta on a ``ReplayBuffer`` of
recent labeled batches BEFORE the swap: a candidate-vs-live logloss or
AUC regression beyond threshold yields outcome ``held`` (the
``DeltaWatcher`` keeps the old generation serving and retries next
poll); a healthy delta yields ``passed``; ``force`` yields ``forced``.
Unknown quality (too few labeled rows, a shadow evaluation that raised)
resolves by the explicit ``unknown_policy`` and says so in the verdict.
``binary_auc`` and ``binary_logloss`` are the metric math (host-side
numpy; None = undefined, never NaN).

Not ported yet (ROADMAP.md Queue 1 item 8, what the observability slice
leaves): ``QualityLedger`` (the label join that fills the replay buffer
from served traffic, fed by the exemplar sampler's sampled requests),
``DriftMonitor`` and its sketches, the ``labels`` request, the
``model_quality`` SLO (``quality_slo``) and the replica's
``--quality_join_window_s`` and the workers' ``--quality_drift_bins``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("obs.quality")

_EPS = 1e-7


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


# ---------------------------------------------------------------------------
# Replay buffer (labeled batches for the canary gate)
# ---------------------------------------------------------------------------


class ReplayBuffer:
    """Bounded ring of recent labeled feature batches — the canary
    gate's shadow-evaluation set.  The caller adds labeled batches (the
    JAX package's label-join ledger, which feeds it there, waits for
    ROADMAP.md Queue 1 item 8)."""

    def __init__(self, max_batches: int = 32):
        self._lock = threading.Lock()
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
    quality="unknown" so the journal records the blind swap.  The JAX
    package's ``quality.shadow_eval`` fault site is not wired here."""

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
