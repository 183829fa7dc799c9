"""Continuous serving: keep a replica tracking the published delta chain,
the port's copy of ``elasticdl_tpu/serving/continuous.py``.

The training side publishes into a *pub dir* (checkpoint/delta.py): full
serving artifacts plus delta links chaining forward from them.  The
``DeltaWatcher`` is the serving-side consumer: each poll resolves the
newest good chain (corrupt links are quarantined by ``resolve_chain``
itself) and walks the replica forward:

- behind the newest full  -> one hot-swap ``reload`` to the full,
- then every delta link    -> ``apply_delta`` (no reload),
- a failed/corrupt apply   -> STOP.  The replica keeps serving its
  current generation (``build_delta_generation`` rolled back and
  journaled ``model_swap`` outcome=rolled_back); the next poll retries,
  and a compaction publish repairs a gap.

That is the degradation ladder's middle rung, *stale-serving*: behind
the stream but answering every request, visible in the freshness lag,
never down.

With a **canary gate** (``obs/quality.py``), every delta link is
shadow-evaluated BEFORE the swap: ``build_delta_generation`` constructs
the candidate off to the side, the gate scores live-vs-candidate
logloss/AUC on its replay batches, and a beyond-threshold regression
HOLDs the link (candidate discarded, old generation serving, journaled
``quality_gate`` outcome=held, retried next poll).  The shadow evaluation
runs in a ``quality.shadow_eval`` span (the port's addition), so a
replica process's journal carries the gate's seconds.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.checkpoint.delta import resolve_chain
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.data.pipeline import bucket_for, pad_features

logger = get_logger("serving.continuous")


def _parse_steps(path: str) -> Tuple[Optional[int], Optional[int]]:
    """(base_step, step) for a delta dir, (None, step) for a full dir."""
    name = os.path.basename(path.rstrip("/"))
    if name.startswith("full_"):
        return None, int(name[len("full_"):])
    if name.startswith("delta_"):
        base, step = name[len("delta_"):].split("_")[:2]
        return int(base), int(step)
    raise ValueError(f"not a chain artifact: {path}")


class DeltaWatcher:
    """Polls a pub dir and advances one ServingReplica along the chain.

    `poll_once()` is the whole protocol (deterministic, driver-callable
    from tests); `start(interval_s)` runs it on a daemon thread for real
    replicas.  `freshness` (an obs.freshness.FreshnessTracker) is
    optional: when present, every applied generation feeds its
    serving-side event-time frontier.  `gate` (an obs.quality.CanaryGate)
    is optional: when present, every delta link is shadow-evaluated on
    `buckets`-padded replay batches before its swap (see module
    docstring)."""

    def __init__(self, replica, pub_dir: str, freshness=None,
                 gate=None, buckets: Optional[Sequence[int]] = None,
                 origin: str = ""):
        self._replica = replica
        self._pub_dir = pub_dir
        self._freshness = freshness
        self._gate = gate
        self._buckets = tuple(buckets) if buckets else None
        self._origin = origin
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _shadow_fn(self, generation):
        """Predictions for a raw replay batch against an explicit
        generation: pad to a warmed bucket (a shape live traffic has
        already run), shadow-execute off the serving pointer, slice the
        pad rows back off."""
        def predict(features):
            rows = next(iter(features.values())).shape[0]
            bucket = (bucket_for(rows, self._buckets)
                      if self._buckets else rows)
            outputs = self._replica.shadow_execute(
                pad_features(features, bucket), generation=generation)
            return np.asarray(outputs).reshape(bucket, -1)[:rows].ravel()
        return predict

    def _gate_delta(self, delta_dir: str, delta_step: int):
        """Build-evaluate-commit for one delta link under the gate.
        Returns the verdict dict (outcome passed|held|forced); raises
        on build failure, same as the ungated `apply_delta` path."""
        candidate = self._replica.build_delta_generation(delta_dir)
        live = self._replica.generation
        # The shadow evaluation's seconds ride a span (the port's own: a
        # replica process's gate is otherwise timed by nothing).
        with obs.span("quality.shadow_eval", step=int(delta_step), origin=self._origin):
            verdict = self._gate.evaluate(
                self._shadow_fn(live), self._shadow_fn(candidate))
        extra = {
            key: verdict[key]
            for key in ("reason", "rows", "quality", "baseline_logloss",
                        "candidate_logloss", "baseline_auc",
                        "candidate_auc")
            if verdict.get(key) is not None
        }
        obs.journal().record(
            "quality_gate",
            outcome=verdict["outcome"],
            step=int(delta_step),
            delta_dir=delta_dir,
            origin=self._origin,
            **extra,
        )
        if verdict["outcome"] == "held":
            logger.warning(
                "Canary gate HELD delta %s (step %d): %s",
                delta_dir, delta_step, verdict.get("reason", ""),
            )
            return verdict
        self._replica.commit_generation(candidate, delta_dir)
        return verdict

    def poll_once(self) -> dict:
        """One resolve-and-advance pass.  Never raises: a failed link
        leaves the replica stale-serving and is retried next poll.

        The summary is a structured outcome, not just counters:
        ``outcome`` is ``applied`` (any forward progress),
        ``held`` (the canary gate stopped a link), ``rolled_back`` (a
        link's apply failed and rolled back), ``error`` (the chain
        resolve itself failed), or ``noop``; ``reason`` carries the
        offending path / gate reason so supervisors and tests assert
        the gate path without tailing the journal."""
        summary = {
            "reloaded_full": False,
            "applied_deltas": 0,
            "failed": None,
            "held": None,
            "outcome": "noop",
            "reason": None,
            "step": self._replica.generation.step,
        }
        try:
            base_dir, chain = resolve_chain(self._pub_dir)
        except OSError as exc:
            logger.exception("Chain resolve failed (transient I/O?)")
            summary["outcome"] = "error"
            summary["reason"] = repr(exc)
            return summary
        if base_dir is None:
            return summary
        _none, base_step = _parse_steps(base_dir)
        current = self._replica.generation.step
        if current < base_step:
            # Behind the newest full (cold start, or a quarantine gap a
            # compaction just repaired): one full hot-swap catches up.
            try:
                self._replica.reload(base_dir)
            except Exception as exc:
                summary["failed"] = base_dir
                summary["reason"] = repr(exc)
                return self._resolve_outcome(summary)
            current = self._replica.generation.step
            summary["reloaded_full"] = True
            self._note_freshness()
        for delta_dir in chain:
            delta_base, delta_step = _parse_steps(delta_dir)
            if delta_step <= current:
                continue  # already ahead of this link
            if delta_base != current:
                break  # gap relative to our position; wait for compaction
            try:
                if self._gate is not None:
                    verdict = self._gate_delta(delta_dir, delta_step)
                    if verdict["outcome"] == "held":
                        summary["held"] = delta_dir
                        summary["reason"] = verdict.get("reason")
                        break
                else:
                    self._replica.apply_delta(delta_dir)
            except Exception as exc:
                # Rolled back (journaled by the runtime).  Stale-serving
                # from here; the next poll retries the link.
                summary["failed"] = delta_dir
                summary["reason"] = repr(exc)
                break
            current = delta_step
            summary["applied_deltas"] += 1
            self._note_freshness()
        return self._resolve_outcome(summary)

    def _resolve_outcome(self, summary: dict) -> dict:
        summary["step"] = self._replica.generation.step
        if summary["failed"] is not None:
            summary["outcome"] = "rolled_back"
        elif summary["held"] is not None:
            summary["outcome"] = "held"
        elif summary["reloaded_full"] or summary["applied_deltas"]:
            summary["outcome"] = "applied"
        else:
            summary["outcome"] = "noop"
        return summary

    def _note_freshness(self):
        if self._freshness is not None:
            gen = self._replica.generation
            self._freshness.note_served(gen.gen_id, gen.step, gen.event_time)

    # -- background operation -------------------------------------------

    def start(self, interval_s: float = 2.0) -> "DeltaWatcher":
        def _loop():
            while not self._stop.wait(interval_s):
                try:
                    self.poll_once()
                except Exception:
                    logger.exception("Delta watcher poll failed; will retry")

        self._thread = threading.Thread(
            target=_loop, name="delta-watcher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
