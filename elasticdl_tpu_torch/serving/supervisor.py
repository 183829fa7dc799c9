"""Elastic supervision for serving replicas: the port of
``elasticdl_tpu/serving/supervisor.py``.

The pod manager and its restart budget are what a serving fleet needs,
with ONE inversion: training workers form a collective (any death
invalidates the world, so the pod manager restarts all of them), while
serving replicas are independent and a death must NOT take the
survivors down.  ``ServingReplicaManager`` therefore subclasses the
subprocess substrate and overrides only the churn handler: the dead
replicas are replaced with FRESH ids (never reused), the survivors keep
serving, and the same ``worker_churn`` journal event records the
repair.  ``kill_worker`` (the SIGKILL drill), ``current_worker_ids``,
the restart budget and the monitor thread are inherited.

``start_serving_fleet`` is the one call that assembles it: journal into
the shared serve dir, build each replica's argv (``replica_argv_fn``:
``python -m elasticdl_tpu_torch.serving.replica_main`` on the card
unless ``device="cpu"``), start the manager and, given a policy engine
(``master/policy.ElasticPolicyEngine``), bind it to the manager, start
its tick and forward the replicas' ``slo_alert`` edges to its
``note_slo_alert`` (``SLOAlertFollower``).  An alert is advisory: the
engine journals a ``policy_decision`` hold carrying the alert's origin
and ``slo_advisory``, and kills or rescales no replica for it.  The
manager's ``stop()`` stops the follower and the engine with the fleet
(JAX's stops the follower only, ``elasticdl_tpu/serving/
supervisor.py:131-134``, and its engine's tick thread outlived the
fleet, journaling holds into whatever journal came next).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.master.pod_manager import LocalProcessManager, _exit_reason
from elasticdl_tpu_torch.serving.replica_main import live_replicas

logger = get_logger("serving.supervisor")


class SLOAlertFollower:
    """Forwards the ``slo_alert`` edges the replicas journal into the
    shared serve-dir journal to the policy's ``note_slo_alert``, each
    once.  ``poll_once()`` reads the journal's tail; ``start()`` runs it
    on a named daemon thread."""

    def __init__(self, policy, journal=None, poll_interval_s: float = 1.0, tail_n: int = 400):
        self._policy = policy
        self._journal = journal if journal is not None else obs.journal()
        self._poll_interval_s = float(poll_interval_s)
        self._tail_n = int(tail_n)
        # (ts, slo, origin, state) of the forwarded edges, bounded: every
        # poll re-reads old events.
        self._seen: set = set()
        self._seen_order: List[tuple] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> int:
        forwarded = 0
        for event in self._journal.tail(self._tail_n):
            if event.get("event") != "slo_alert":
                continue
            key = (event.get("ts"), event.get("slo"), event.get("origin"), event.get("state"))
            if key in self._seen:
                continue
            self._seen.add(key)
            self._seen_order.append(key)
            while len(self._seen_order) > 4 * self._tail_n:
                self._seen.discard(self._seen_order.pop(0))
            evidence = {k: event[k] for k in ("grade", "burn_rates", "budget_remaining_ratio",
                                              "offending", "origin") if k in event}
            try:
                self._policy.note_slo_alert(event.get("slo", ""), event.get("state") == "fire",
                                            evidence)
                forwarded += 1
            except Exception:  # one failing forward must not starve the next
                logger.exception("SLO alert forward failed")
        return forwarded

    def start(self) -> "SLOAlertFollower":
        if self._thread is not None:
            return self

        def _loop():
            while not self._stop.wait(self._poll_interval_s):
                try:
                    self.poll_once()
                except Exception:
                    logger.exception("SLO alert poll failed")

        self._thread = threading.Thread(target=_loop, name="slo-alert-follower", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            self._thread = None


class ServingReplicaManager(LocalProcessManager):
    """Subprocess pod manager that replaces the dead (not
    restart-the-world)."""

    #: Set by start_serving_fleet when a policy is given; stop() drains
    #: them with the fleet.
    slo_follower: Optional[SLOAlertFollower] = None
    policy = None

    def stop(self):
        follower = self.slo_follower
        if follower is not None:
            follower.stop()
        if self.policy is not None:
            self.policy.stop()
        super().stop()

    def _handle_churn_serialized(self, handles: List, crashed):
        dead_ids = {h.worker_id for h, _ in crashed}
        survivors = [h for h in handles if h.worker_id not in dead_ids]
        for h, code in crashed:
            logger.warning("%s died (exit %s) — replacing it (survivors keep serving)",
                           self._describe(h), code)
            self._m_relaunches.inc(reason=_exit_reason(code))
        with self._lock:
            self._restarts_used += 1
            restarts_used = self._restarts_used
            budget_left = restarts_used <= self._max_restarts
            n_new = len(dead_ids) if budget_left else 0
            new_ids = list(range(self._next_worker_id, self._next_worker_id + n_new))
            self._next_worker_id += n_new
        obs.journal().record(
            "worker_churn", workers=sorted(dead_ids), exit_codes=[code for _, code in crashed],
            old_size=len(handles), restarts_used=restarts_used, budget_left=budget_left)
        # Reap the dead (they have exited: this closes their handles),
        # never the survivors.
        self._substrate_terminate([h for h, _ in crashed])
        new_handles = self._substrate_launch(new_ids) if new_ids else []
        with self._lock:
            stopped = self._stopped
            if not stopped:
                self._handles = survivors + new_handles
            remaining = [] if stopped else self._handles
        if stopped:  # stop() raced the repair: no fresh replica outlives it
            self._substrate_terminate(new_handles)
            return
        if not remaining:
            with self._lock:
                self._failed_reason = reason = (
                    f"restart budget exhausted ({restarts_used - 1} used) and no serving "
                    "replicas left")
                self._stopped = True
            logger.error("Serving fleet failed: %s", reason)
            obs.journal().record("job_failed", reason=reason)
            self._done_event.set()


def replica_argv_fn(
    model_dir: str,
    serve_dir: str,
    *,
    model_zoo: str = "",
    sparse_kernel: str = "auto",
    max_batch_size: int = 64,
    max_wait_us: int = 2000,
    queue_limit: int = 256,
    telemetry_interval_s: float = 1.0,
    warmup_features: str = "",
    pub_dir: str = "",
    pub_poll_interval_s: float = 2.0,
    freshness_slo_s: float = 0.0,
    slo_availability_target: float = 0.0,
    slo_p99_ms: float = 0.0,
    slo_compliance_window_s: float = 3600.0,
    trace_head_every: int = 128,
    trace_exemplar_capacity: int = 64,
    trace_tail_threshold_ms: float = 0.0,
    quality_join_window_s: float = 0.0,
    quality_window_size: int = 2048,
    quality_gate_max_logloss_regress: float = 0.10,
    quality_gate_max_auc_drop: float = 0.05,
    quality_gate_min_rows: int = 64,
    quality_unknown_policy: str = "open",
    quality_gate_force: bool = False,
    quality_drift_threshold: float = 0.25,
    quality_slo_logloss: float = 0.0,
    device: str = "cuda",
    python: str = sys.executable,
) -> Callable[[int], List[str]]:
    """The pod manager's ``worker_argv_fn`` for serving replicas: the
    worker id IS the replica id (fresh per launch, never reused).  The
    JAX package's argv for the same arguments, run as
    ``elasticdl_tpu_torch.serving.replica_main``, with ``--device``
    appended."""

    def argv(worker_id: int) -> List[str]:
        cmd = [
            python, "-m", "elasticdl_tpu_torch.serving.replica_main",
            "--model_dir", model_dir,
            "--serve_dir", serve_dir,
            "--replica_id", str(worker_id),
            "--model_zoo", model_zoo,
            "--sparse_kernel", sparse_kernel,
            "--max_batch_size", str(max_batch_size),
            "--max_wait_us", str(max_wait_us),
            "--queue_limit", str(queue_limit),
            "--telemetry_interval_s", str(telemetry_interval_s),
        ]
        if warmup_features:
            cmd += ["--warmup_features", warmup_features]
        if slo_availability_target > 0 or slo_p99_ms > 0:
            cmd += [
                "--slo_availability_target", str(slo_availability_target),
                "--slo_p99_ms", str(slo_p99_ms),
                "--slo_compliance_window_s", str(slo_compliance_window_s),
            ]
        if pub_dir:  # each replica tracks the delta chain itself
            cmd += [
                "--pub_dir", pub_dir,
                "--pub_poll_interval_s", str(pub_poll_interval_s),
                "--freshness_slo_s", str(freshness_slo_s),
            ]
        # The tracing and quality flags go only when tuned away from the
        # replica's defaults (tracing) or armed (quality), as in JAX.
        if (trace_head_every != 128 or trace_exemplar_capacity != 64
                or trace_tail_threshold_ms > 0):
            cmd += [
                "--trace_head_every", str(trace_head_every),
                "--trace_exemplar_capacity", str(trace_exemplar_capacity),
                "--trace_tail_threshold_ms", str(trace_tail_threshold_ms),
            ]
        if quality_join_window_s > 0:
            cmd += [
                "--quality_join_window_s", str(quality_join_window_s),
                "--quality_window_size", str(quality_window_size),
                "--quality_gate_max_logloss_regress", str(quality_gate_max_logloss_regress),
                "--quality_gate_max_auc_drop", str(quality_gate_max_auc_drop),
                "--quality_gate_min_rows", str(quality_gate_min_rows),
                "--quality_unknown_policy", quality_unknown_policy,
                "--quality_drift_threshold", str(quality_drift_threshold),
                "--quality_slo_logloss", str(quality_slo_logloss),
            ]
            if quality_gate_force:
                cmd += ["--quality_gate_force"]
        return cmd + ["--device", device]

    return argv


def start_serving_fleet(
    num_replicas: int,
    model_dir: str,
    serve_dir: str,
    *,
    worker_env: Optional[Dict[str, str]] = None,
    log_dir: str = "",
    max_restarts: int = 3,
    policy=None,
    **argv_kwargs,
) -> ServingReplicaManager:
    """Assemble and start the fleet: ``num_replicas`` replica processes
    of ``model_dir`` sharing ``serve_dir`` (discovery and journal), on
    the card unless ``device="cpu"`` is among ``argv_kwargs``.  A
    ``policy`` is bound to the manager and started."""
    os.makedirs(serve_dir, exist_ok=True)
    obs.init_journal(serve_dir)
    # The replica processes import this package wherever the supervisor
    # was started from.
    import elasticdl_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(elasticdl_tpu_torch.__file__)))
    env = dict(worker_env or {})
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH", os.environ.get("PYTHONPATH", ""))) if p)
    manager = ServingReplicaManager(
        num_replicas,
        replica_argv_fn(model_dir, serve_dir, **argv_kwargs),
        worker_env=env,
        log_dir=log_dir or os.path.join(serve_dir, "logs"),
        max_restarts=max_restarts,
    )
    obs.journal().record("serving_fleet_start", replicas=num_replicas, model_dir=model_dir,
                         serve_dir=serve_dir)
    manager.start()
    if policy is not None:
        # The manager owns the engine's and the follower's teardown (stop()).
        manager.policy = policy.bind(manager).start()
        if hasattr(policy, "note_slo_alert"):
            manager.slo_follower = SLOAlertFollower(policy).start()
    return manager


def wait_for_replicas(serve_dir: str, n: int, timeout_s: float = 120.0,
                      poll_s: float = 0.2) -> List[dict]:
    """Block until ``n`` live replicas have published their ports."""
    deadline = time.monotonic() + timeout_s
    while True:
        live = live_replicas(serve_dir)
        if len(live) >= n:
            return live
        if time.monotonic() >= deadline:
            raise TimeoutError(f"only {len(live)}/{n} serving replicas published ports "
                               f"within {timeout_s:.0f}s")
        time.sleep(poll_s)
