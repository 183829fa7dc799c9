"""Cluster-mode job orchestration: the port's copy of
``elasticdl_tpu/master/job_runner.py`` (``_capacity_oracle_from_env``
:29, ``_K8sCapacityProbe`` :48, ``_running_on_k8s`` :78,
``_build_policy_engine`` :86, ``_GatedScaleUp`` :136,
``_build_worker_manager`` :171, ``_ensure_elastic_checkpointing`` :241;
``run_allreduce_job`` :283; ``run_ps_job`` :371).  An evaluation-only job
queues its round at version 0 before the workers start; at the end the
evaluation service computes any round still open and the final metrics
are logged.

The master starts its services and a worker manager, then supervises
the worker fleet until the job completes.  With ``--image_name`` inside
a cluster (``KUBERNETES_SERVICE_HOST`` or ``ELASTICDL_K8S_HOST`` set) the
workers are pods (``master/k8s_pod_manager.py``), otherwise local
processes (``LocalProcessManager``).  Extra worker environment rides
``ELASTICDL_WORKER_ENV`` (``K=V;K2=V2``).

The elastic control plane: with ``--need_elasticity`` and
``--policy_enabled`` (both on by default) the goodput-driven policy
engine (``master/policy.py``) ticks beside the manager.  It reads the
goodput ledger and the telemetry aggregator's stragglers, gates every
regrow of a shrunk world, parks a thrashing fleet at its floor, and
evicts persistent stragglers within its kill budget.  Capacity for a
regrow is the integer in the file ``ELASTICDL_CAPACITY_FILE`` names (no
file: no regrow on one host; on Kubernetes an optimistic probe at most
every 300 s, backed off while its probe pods stay Pending).  Straggler
advisories also reach the manager and the ledger.

The SLO plane (``obs/slo.py``, JAX ``job_runner.py:104-132``): with
``--slo_enabled`` (the default) a history sampler and burn-rate
evaluator tick every ``--slo_tick_interval_s`` over the master's
registry and serve ``/slo``; ``--slo_goodput_target`` > 0 registers the
goodput SLO over ``elasticdl_goodput_ratio``, and its alert edges reach
the policy engine's ``note_slo_alert``.  The TensorBoard service's
``train/worker_restarts`` reads the manager's restart count.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common.boundary import forbidden_modules_loaded
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.master.main import start_master
from elasticdl_tpu_torch.master.pod_manager import LocalProcessManager, worker_argv_from_args
from elasticdl_tpu_torch.master.rendezvous_server import ElasticRendezvous
from elasticdl_tpu_torch.obs import goodput

logger = get_logger("master.job_runner")


def _capacity_oracle_from_env():
    """The regrow signal on one host: the file ``$ELASTICDL_CAPACITY_FILE``
    holds the count of free worker slots.  No variable: no regrow."""
    path = os.environ.get("ELASTICDL_CAPACITY_FILE", "")
    if not path:
        return None

    def check(needed: int) -> int:
        try:
            with open(path) as f:
                slots = int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0
        return max(0, min(needed, slots))

    return check


class _K8sCapacityProbe:
    """Scale-up oracle on Kubernetes: capacity is unknowable without a
    scheduler dry-run, so probe optimistically, granting a regrow attempt
    at most every ``cooldown_s``; the pod manager's probe pods then prove
    or refute it.  ``$ELASTICDL_CAPACITY_FILE`` wins when present."""

    def __init__(self, cooldown_s: float = 300.0):
        self._base_cooldown_s = cooldown_s
        self._cooldown_s = cooldown_s
        self._last_probe = time.time()

    def __call__(self, needed: int) -> int:
        explicit = _capacity_oracle_from_env()
        if explicit is not None:
            return explicit(needed)
        now = time.time()
        if now - self._last_probe < self._cooldown_s:
            return 0
        self._last_probe = now
        return needed

    def failed(self):
        """Probe pods never scheduled: exponential backoff (cap 1 h)."""
        self._cooldown_s = min(self._cooldown_s * 2, 3600.0)

    def succeeded(self):
        self._cooldown_s = self._base_cooldown_s


def _running_on_k8s(args) -> bool:
    return bool(args.image_name) and bool(
        os.environ.get("KUBERNETES_SERVICE_HOST") or os.environ.get("ELASTICDL_K8S_HOST"))


def _build_policy_engine(args, master):
    """The policy engine, when elasticity is on and ``--policy_enabled``;
    it polls the telemetry aggregator's flagged set each tick."""
    if not (args.need_elasticity and getattr(args, "policy_enabled", True)):
        return None
    from elasticdl_tpu_torch.master.policy import ElasticPolicyEngine, PolicyConfig

    return ElasticPolicyEngine(
        PolicyConfig.from_args(args),
        stragglers_fn=master.telemetry.stragglers if master.telemetry is not None else None)


def _build_slo_plane(args, master, policy_engine):
    """The master's SLO plane; None without ``--slo_enabled``.  The
    sampler always runs (it feeds /slo); the goodput SLO registers only
    when ``--slo_goodput_target`` > 0."""
    if not getattr(args, "slo_enabled", True):
        return None
    from elasticdl_tpu_torch.obs.slo import SLOPlane, goodput_slo

    specs = []
    target = float(getattr(args, "slo_goodput_target", 0.0) or 0.0)
    if target > 0:
        specs.append(goodput_slo(target, compliance_window_s=float(
            getattr(args, "slo_compliance_window_s", 3600.0))))
    plane = SLOPlane(specs=specs, tick_interval_s=float(getattr(args, "slo_tick_interval_s", 2.0)),
                     origin="master")
    if policy_engine is not None:
        plane.slos.add_alert_callback(policy_engine.note_slo_alert)
    if master.metrics_exporter is not None:
        master.metrics_exporter.set_slo_plane(plane)
    return plane


class _GatedScaleUp:
    """The policy first (amortization, cooldown, thrash: every denial
    journals a ``policy_decision``), then the capacity oracle."""

    def __init__(self, check_fn, policy_engine):
        self._check_fn = check_fn
        self._policy_engine = policy_engine

    def __call__(self, needed: int) -> int:
        return self._policy_engine.gate_scale_up(needed, self._check_fn)

    def failed(self):
        self._policy_engine.scale_up_aborted()
        if hasattr(self._check_fn, "failed"):
            self._check_fn.failed()

    def succeeded(self):
        if hasattr(self._check_fn, "succeeded"):
            self._check_fn.succeeded()


def _gated_scale_up(check_fn, policy_engine):
    if check_fn is None or policy_engine is None:
        return check_fn
    return _GatedScaleUp(check_fn, policy_engine)


def _build_worker_manager(args, master, rendezvous, worker_env, policy_engine=None):
    """Worker pods inside a cluster (``_running_on_k8s``), local
    processes otherwise."""
    common = dict(
        num_workers=args.num_workers,
        rendezvous=rendezvous,
        task_manager=master.task_manager,
        max_restarts=args.max_worker_restarts,
        job_finished_fn=master.task_manager.finished,
        liveness_timeout_s=args.worker_liveness_timeout_s,
    )
    if _running_on_k8s(args):
        from elasticdl_tpu_torch.master.k8s_client import (
            K8sClient,
            K8sConfig,
            parse_resource_spec,
        )
        from elasticdl_tpu_torch.master.k8s_pod_manager import KubernetesPodManager

        if args.tpu_slice and args.need_elasticity:
            # client/submit's refusal, for masters started without it.
            raise ValueError("--tpu_slice is incompatible with --need_elasticity "
                             "(pod slices schedule all-or-nothing; see client/submit)")
        client = K8sClient(K8sConfig.resolve(args.namespace))
        pod_ip = os.environ.get("MY_POD_IP", "") or socket.gethostbyname(socket.gethostname())
        own_name = os.environ.get("HOSTNAME", "")
        return KubernetesPodManager(
            worker_argv_fn=worker_argv_from_args(args, f"{pod_ip}:{master.port}"),
            k8s_client=client,
            job_name=args.job_name,
            image=args.image_name,
            worker_env=worker_env,
            worker_resources=parse_resource_spec(args.worker_resource_request) or None,
            priority_class=args.worker_pod_priority,
            owner_pod=client.get_pod(own_name) if own_name else None,
            volume_spec=args.volume,
            tpu_slice=args.tpu_slice,
            scale_up_check_fn=_gated_scale_up(
                _K8sCapacityProbe() if args.need_elasticity else None, policy_engine),
            **common,
        )
    return LocalProcessManager(
        worker_argv_fn=worker_argv_from_args(args, master.addr),
        worker_env=worker_env,
        log_dir=os.path.join(args.checkpoint_dir or tempfile.gettempdir(),
                             f"{args.job_name}_worker_logs"),
        scale_up_check_fn=_gated_scale_up(
            _capacity_oracle_from_env() if args.need_elasticity else None, policy_engine),
        **common,
    )


def _ensure_elastic_checkpointing(args, mode: str):
    """Churn recovery is restart-the-world + restore-latest: an elastic
    training job without a checkpoint would silently reset its weights
    on churn while the task queue keeps finished tasks finished.  So it
    gets a job-scoped directory and a save cadence by default."""
    if mode != Mode.TRAINING or not args.need_elasticity:
        return
    if not args.checkpoint_dir:
        if _running_on_k8s(args):
            # A master-pod-local directory is invisible to worker pods: a
            # re-formed world would restore nothing.
            raise ValueError(
                "Elastic training on Kubernetes requires --checkpoint_dir on storage every "
                'pod shares: mount it with --volume (e.g. --volume "claim_name=ckpt-pvc,'
                'mount_path=/ckpt" --checkpoint_dir /ckpt/myjob)')
        args.checkpoint_dir = tempfile.mkdtemp(prefix=f"{args.job_name}_ckpt_")
        logger.warning("Elastic job has no --checkpoint_dir; worker churn would silently "
                       "reset model weights while task progress survives. Defaulting to %s",
                       args.checkpoint_dir)
    if not args.checkpoint_steps:
        args.checkpoint_steps = 100
        logger.warning("Elastic job has --checkpoint_steps=0; defaulting to %d so re-formed "
                       "worlds restore recent state.", args.checkpoint_steps)


def run_allreduce_job(args, mode: str = Mode.TRAINING) -> int:
    """N worker processes form a world; churn re-forms it."""
    _ensure_elastic_checkpointing(args, mode)
    rendezvous = ElasticRendezvous()
    master = start_master(args, rendezvous_server=rendezvous)
    if mode == Mode.EVALUATION:
        if master.evaluation_service is not None:
            master.evaluation_service.trigger_evaluation(model_version=0)
        else:
            master.task_manager.create_evaluation_tasks(model_version=0)
    worker_env = {}
    for pair in os.environ.get("ELASTICDL_WORKER_ENV", "").split(";"):
        if "=" in pair:
            key, value = pair.split("=", 1)
            worker_env[key.strip()] = value
    policy_engine = _build_policy_engine(args, master)
    manager = _build_worker_manager(args, master, rendezvous, worker_env,
                                    policy_engine=policy_engine)
    master.pod_manager = manager
    if policy_engine is not None:
        policy_engine.bind(manager)
    if master.telemetry is not None:
        # Advisories to the manager and the ledger (training while a
        # worker is flagged is degraded_straggler); the policy engine
        # polls the same detector each tick instead.
        master.telemetry.add_straggler_callback(manager.note_straggler)
        master.telemetry.add_straggler_callback(
            lambda wid, flagged, _evidence: goodput.ledger().on_straggler(wid, flagged))
    if master.tensorboard_service is not None:
        master.tensorboard_service.bind(restarts_fn=lambda: manager.restarts_used)
    slo_plane = _build_slo_plane(args, master, policy_engine)
    progress_persister = master.progress_persister
    job_succeeded = False
    try:
        manager.start()
        if policy_engine is not None:
            policy_engine.start()
        if slo_plane is not None:
            slo_plane.start()
        ok = manager.wait()
        if master.evaluation_service is not None:
            master.evaluation_service.finalize()
            metrics = master.evaluation_service.latest_metrics
            if metrics:
                logger.info("Final metrics: %s", metrics)
        if not ok:
            logger.error("Job failed: %s", manager.failed_reason)
            return 1
        if not master.task_manager.finished():
            logger.error("Workers exited but tasks remain unfinished")
            return 1
        logger.info("Job complete (%d records finished, %d replayed after churn)",
                    master.task_manager.finished_record_count,
                    master.task_manager.recovered_record_count)
        job_succeeded = True
        return 0
    finally:
        if slo_plane is not None:
            slo_plane.stop()
        if policy_engine is not None:
            policy_engine.stop()
        manager.stop()
        master.stop()
        obs.journal().record("master_exit", succeeded=job_succeeded,
                             restarts_used=manager.restarts_used,
                             forbidden_modules=forbidden_modules_loaded())
        if job_succeeded and progress_persister is not None:
            # A terminal snapshot would make the next run with this
            # checkpoint_dir a silent no-op.
            progress_persister.clear()


def run_ps_job(args, mode: str = Mode.TRAINING) -> int:
    """ParameterServerStrategy: the same topology as AllReduce (the tables
    live in the workers' trainers; there are no PS processes)."""
    return run_allreduce_job(args, mode)
