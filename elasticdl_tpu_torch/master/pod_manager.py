"""Elastic worker-fleet management: the port's copy of
``elasticdl_tpu/master/pod_manager.py`` (``ElasticWorkerManager`` :50,
``LocalProcessManager`` :539, ``worker_argv_from_args`` :605).

Restart-the-world: when any member of a world dies, the survivors'
collectives cannot go on, so the manager recovers every in-flight task,
tears the old world down, declares a new one (the same size while the
restart budget lasts, one smaller after) under a fresh rendezvous id and
launches fresh worker processes, which restore the latest checkpoint.
Data progress lives in the master's ``TaskManager``, which survives.  A
worker whose heartbeat goes silent is killed, which turns a hang into
the same churn.  ``current_worker_ids`` and ``kill_worker`` are the
surface a supervisor, a drill or the policy engine drives; the churn
handler is a locked check (stopped, or the world already replaced:
return) around ``_handle_churn_serialized``, which a subclass overrides
(``serving/supervisor.py`` replaces only the dead replicas).

Elastic resizes: ``scale(n)`` drains the world and re-forms it at ``n``;
a world that shrank under churn grows back toward
``target_num_workers`` when ``scale_up_check_fn(needed)`` grants workers
(the job runner chains the capacity oracle behind the policy engine's
gate, ``master/policy.py``).  The telemetry plane's straggler
advisories land in ``note_straggler`` (advisory: the policy engine is
what evicts).  Every churn, resize and the job's end drive the goodput
ledger (``obs/goodput.py``), which prices each rescale as detection,
rendezvous and redo.

``LocalProcessManager`` runs the workers as child processes of the
master (``python -m elasticdl_tpu_torch.worker.main``), each logging to
``<log_dir>/worker_<id>.log``.  The Kubernetes substrate is not ported
(ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.obs import goodput

logger = get_logger("master.pod_manager")


def _exit_reason(code) -> str:
    """137 / -9 is SIGKILL (preemption, OOM-kill, a stale-worker kill);
    anything else nonzero is a crash."""
    return "preempted" if code in (137, -9) else "crash"


class ElasticWorkerManager:
    """Substrate-agnostic elastic supervision.

    ``worker_argv_fn(worker_id)`` builds a worker's command line; the
    rendezvous is told every new world before its launch and the task
    manager recovers a dead world's tasks.  Subclasses implement the
    substrate hooks: ``_substrate_start``, ``_substrate_launch(worker_ids)``
    (handles with ``.worker_id``), ``_substrate_poll(handle)`` (None while
    alive, else the exit code), ``_substrate_terminate(handles)``
    (blocking), ``_substrate_kill(handle, sig)`` and ``_worker_host``.
    """

    def __init__(
        self,
        num_workers: int,
        worker_argv_fn: Callable[[int], List[str]],
        rendezvous=None,
        task_manager=None,
        max_restarts: int = 3,
        job_finished_fn: Optional[Callable[[], bool]] = None,
        poll_interval_s: float = 0.2,
        liveness_timeout_s: float = 0.0,
        startup_grace_s: Optional[float] = None,
        target_num_workers: Optional[int] = None,
        scale_up_check_fn: Optional[Callable[[int], int]] = None,
    ):
        self._num_workers = num_workers
        self._worker_argv_fn = worker_argv_fn
        self._rendezvous = rendezvous
        self._task_manager = task_manager
        self._max_restarts = max_restarts
        self._job_finished_fn = job_finished_fn
        self._poll_interval_s = poll_interval_s
        self._liveness_timeout_s = liveness_timeout_s
        # Workers heartbeat only after spawn, imports and the process-group
        # barrier: a never-heartbeated worker gets a longer grace.
        self._startup_grace_s = (startup_grace_s if startup_grace_s is not None
                                 else 4 * liveness_timeout_s)
        # A world that shrank under churn grows back toward the target
        # when scale_up_check_fn grants capacity.
        self._target_num_workers = (target_num_workers if target_num_workers is not None
                                    else num_workers)
        self._scale_up_check_fn = scale_up_check_fn
        self._lock = threading.Lock()
        # Serialises the paths that replace the world (the churn repair
        # releases _lock mid-flight); always taken before _lock.
        self._resize_lock = threading.Lock()
        self._handles: List = []
        self._next_worker_id = 0
        self._restarts_used = 0
        self._stopped = False
        self._failed_reason: Optional[str] = None
        self._done_event = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        self._m_relaunches = obs.counter(
            "elasticdl_worker_relaunches_total",
            "Worker relaunches within world re-formations, by cause", labelnames=("reason",))
        self._m_hung_kills = obs.counter("elasticdl_hung_worker_kills_total",
                                         "Workers killed for silent heartbeats (hang -> churn)")
        self._m_straggler_advisories = obs.counter(
            "elasticdl_straggler_advisories_total",
            "Straggler advisories received from the telemetry plane")
        # Workers the telemetry plane flags as stragglers: advisory state.
        self._straggler_ids: set = set()
        obs.gauge("elasticdl_workers_target",
                  "Worker count the elastic manager is trying to reach").set_function(
            lambda: self._target_num_workers)
        obs.gauge("elasticdl_workers_actual", "Workers currently launched").set_function(
            lambda: len(self._handles))

    # -- substrate hooks -------------------------------------------------------

    def _substrate_start(self):
        pass

    def _substrate_launch(self, worker_ids: List[int]) -> List:
        raise NotImplementedError

    def _substrate_poll(self, handle) -> Optional[int]:
        raise NotImplementedError

    def _substrate_terminate(self, handles: List):
        raise NotImplementedError

    def _substrate_kill(self, handle, sig: int = 9):
        raise NotImplementedError

    def _worker_host(self, worker_id: int) -> str:
        return "127.0.0.1"

    def _describe(self, handle) -> str:
        return f"worker {handle.worker_id}"

    # -- lifecycle ---------------------------------------------------------------

    def start(self):
        self._substrate_start()
        self._launch_world(self._num_workers)
        self._monitor_thread = threading.Thread(target=self._monitor_loop,
                                                name="pod-manager-monitor", daemon=True)
        self._monitor_thread.start()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the fleet is done; True on success."""
        if not self._done_event.wait(timeout):
            raise TimeoutError("Worker fleet did not finish in time")
        return self._failed_reason is None

    @property
    def failed_reason(self) -> Optional[str]:
        return self._failed_reason

    @property
    def restarts_used(self) -> int:
        with self._lock:
            return self._restarts_used

    def current_worker_ids(self) -> List[int]:
        with self._lock:
            return [h.worker_id for h in self._handles]

    def kill_worker(self, worker_id: int, sig: int = 9):
        """Kill one worker (a drill, or a preemption's simulation); the
        monitor then handles its exit as churn."""
        with self._lock:
            target = next((h for h in self._handles if h.worker_id == worker_id), None)
        if target is None:
            raise ValueError(f"No live worker {worker_id}")
        self._substrate_kill(target, sig)  # outside the lock: a substrate may block

    def note_straggler(self, worker_id: int, flagged: bool, evidence=None):
        """The telemetry plane's straggler advisory.  It does not kill: a
        straggler makes progress, and killing it restarts the world and
        replays its work.  A hang still becomes churn through the
        liveness timeout, and the policy engine evicts PERSISTENT
        stragglers under its own hysteresis and kill budget."""
        with self._lock:
            if flagged:
                self._straggler_ids.add(worker_id)
            else:
                self._straggler_ids.discard(worker_id)
        if flagged:
            self._m_straggler_advisories.inc()
            logger.warning("Telemetry advisory: worker %d is straggling (%s); not killing it",
                           worker_id, evidence or {})
        else:
            logger.info("Telemetry advisory: worker %d straggler cleared", worker_id)

    def current_straggler_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._straggler_ids)

    def set_target_num_workers(self, num_workers: int):
        """The size the manager grows toward, without a rescale now: the
        monitor's ``_maybe_scale_up`` grows as ``scale_up_check_fn``
        allows (the policy engine restores a parked fleet this way)."""
        with self._lock:
            self._target_num_workers = max(1, int(num_workers))

    def target_num_workers(self) -> int:
        with self._lock:
            return self._target_num_workers

    def scale(self, num_workers: int):
        """Explicit resize: recover the in-flight tasks, tear the world
        down, relaunch it at ``num_workers`` (the target follows, so a
        shrink is not regrown at once)."""
        if num_workers < 1:
            raise ValueError(f"scale() needs >= 1 worker, got {num_workers}")
        with self._resize_lock:
            with self._lock:
                if self._stopped:
                    return
                handles = list(self._handles)
                self._handles = []
            direction = ("up" if num_workers > len(handles)
                         else "down" if num_workers < len(handles) else "flat")
            logger.info("Scaling world %d -> %d workers (%s)", len(handles), num_workers,
                        direction)
            goodput.ledger().on_rescale_detected("scale", len(handles))
            self._recover_world_tasks(handles)
            self._substrate_terminate(handles)
            goodput.ledger().on_drain_complete(num_workers)
            with self._lock:
                self._num_workers = num_workers
                self._target_num_workers = num_workers
            self._m_relaunches.inc(num_workers, reason="scale")
            obs.journal().record("scale", old_size=len(handles), new_size=num_workers,
                                 direction=direction)
            self._launch_world(num_workers)

    def stop(self):
        with self._lock:
            self._stopped = True
            handles = list(self._handles)
        self._substrate_terminate(handles)
        self._done_event.set()
        monitor = self._monitor_thread
        if monitor is not None and monitor is not threading.current_thread():
            monitor.join(timeout=10)

    # -- internals ---------------------------------------------------------------

    def _launch_world(self, n: int):
        with self._lock:
            if self._stopped:
                return
            worker_ids = list(range(self._next_worker_id, self._next_worker_id + n))
            self._next_worker_id += n
            # Advisories die with their world: ids are never reused.
            self._straggler_ids.intersection_update(worker_ids)
        if self._rendezvous is not None:
            self._rendezvous.set_worker_hosts([(wid, self._worker_host(wid))
                                               for wid in worker_ids])
        handles = self._substrate_launch(worker_ids)
        with self._lock:
            if self._stopped:
                stale, handles = handles, []  # stop() raced the launch
            else:
                self._handles = handles
                stale = []
        self._substrate_terminate(stale)

    def _recover_world_tasks(self, handles: List):
        if self._task_manager is not None:
            for h in handles:
                self._task_manager.recover_tasks(h.worker_id)

    def _job_finished(self) -> bool:
        return bool(self._job_finished_fn and self._job_finished_fn())

    def _monitor_loop(self):
        try:
            self._monitor_loop_inner()
        except Exception as exc:  # never die silently: wait() must unblock
            logger.exception("Pod-manager monitor crashed")
            with self._lock:
                self._failed_reason = f"pod-manager monitor crashed: {exc}"
                self._stopped = True
                handles = list(self._handles)
            obs.journal().record("job_failed", reason=self._failed_reason)
            goodput.ledger().finish("job_failed")
            self._substrate_terminate(handles)
            self._done_event.set()

    def _monitor_loop_inner(self):
        while True:
            time.sleep(self._poll_interval_s)
            with self._lock:
                if self._stopped:
                    return
                handles = list(self._handles)
            self._kill_stale_workers(handles)
            polled = [(h, self._substrate_poll(h)) for h in handles]
            exited = [(h, code) for h, code in polled if code is not None]
            if not exited:
                self._maybe_scale_up(handles)
                continue
            crashed = [(h, code) for h, code in exited if code != 0]
            if crashed and not self._job_finished():
                self._handle_churn(handles, crashed)
                with self._lock:
                    if self._stopped or not self._handles:
                        return
                continue
            if all(code is not None for _, code in polled):
                logger.info("All workers exited; job done")
                obs.journal().record("job_complete", restarts_used=self.restarts_used)
                goodput.ledger().finish("job_complete", restarts_used=self.restarts_used)
                self._done_event.set()
                return

    def _kill_stale_workers(self, handles: List):
        """A worker whose heartbeat went silent is killed, so the churn path
        re-forms the world."""
        if self._liveness_timeout_s <= 0 or self._rendezvous is None or self._job_finished():
            return
        stale = set(self._rendezvous.stale_workers(self._liveness_timeout_s,
                                                   self._startup_grace_s))
        for h in handles:
            if h.worker_id in stale and self._substrate_poll(h) is None:
                logger.warning("Worker %d heartbeat stale > %.0fs; killing it", h.worker_id,
                               self._liveness_timeout_s)
                self._m_hung_kills.inc()
                obs.journal().record("hung_worker_kill", worker_id=h.worker_id,
                                     silent_s=self._liveness_timeout_s)
                self._substrate_kill(h, 9)

    def _maybe_scale_up(self, handles: List) -> bool:
        """Regrow a world that shrank under churn once capacity returns:
        restart-the-world at the larger size (the new workers restore the
        latest checkpoint, the task manager replays what was in flight)."""
        current = len(handles)
        if current >= self._target_num_workers or self._scale_up_check_fn is None:
            return False
        if self._job_finished():
            return False
        with self._resize_lock:
            with self._lock:
                if self._stopped or self._handles != handles:
                    return False  # replaced since the poll; the next tick re-judges
            grant = self._scale_up_check_fn(self._target_num_workers - current)
            if grant <= 0:
                return False
            new_size = min(self._target_num_workers, current + grant)
            logger.info("Capacity returned: growing world %d -> %d workers", current, new_size)
            with self._lock:
                if self._stopped:
                    return True
                self._handles = []
                self._num_workers = new_size
            self._m_relaunches.inc(new_size, reason="scale_up")
            obs.journal().record("scale_up", old_size=current, new_size=new_size)
            goodput.ledger().on_rescale_detected("scale_up", current)
            self._recover_world_tasks(handles)
            self._substrate_terminate(handles)
            goodput.ledger().on_drain_complete(new_size)
            self._launch_world(new_size)
            return True

    def _handle_churn(self, handles: List, crashed):
        """One churn event, unless the fleet was stopped or the world was
        replaced since ``handles`` was polled (their exits are then
        expected teardown)."""
        with self._resize_lock:
            with self._lock:
                if self._stopped or self._handles != handles:
                    return
            self._handle_churn_serialized(handles, crashed)

    def _handle_churn_serialized(self, handles: List, crashed):
        """Restart the world: any worker death invalidates it."""
        for h, code in crashed:
            logger.warning("%s died (exit %s) — world re-formation", self._describe(h), code)
            self._m_relaunches.inc(reason=_exit_reason(code))
        with self._lock:
            self._handles = []
            self._restarts_used += 1
            budget_left = self._restarts_used <= self._max_restarts
            old_size = len(handles)
        obs.journal().record(
            "worker_churn", workers=[h.worker_id for h, _ in crashed],
            exit_codes=[code for _, code in crashed], old_size=old_size,
            restarts_used=self._restarts_used, budget_left=budget_left)
        # The rescale's clock starts at detection; the churn requeues
        # below land inside its record (TaskManager.recover_tasks).
        goodput.ledger().on_rescale_detected("worker_churn", old_size)
        self._recover_world_tasks(handles)
        self._substrate_terminate(handles)  # survivors die with the world
        new_size = old_size if budget_left else old_size - 1
        goodput.ledger().on_drain_complete(max(0, new_size))
        if new_size < 1:
            with self._lock:
                self._failed_reason = reason = (
                    f"restart budget exhausted ({self._restarts_used - 1} used) and no "
                    "workers left")
                self._stopped = True
            logger.error("Job failed: %s", reason)
            obs.journal().record("job_failed", reason=reason)
            goodput.ledger().finish("job_failed")
            self._done_event.set()
            return
        logger.info("Re-forming world: %d -> %d workers (restart %d/%d)", old_size,
                    new_size, self._restarts_used, self._max_restarts)
        self._launch_world(new_size)


class WorkerProcess:
    def __init__(self, worker_id: int, popen: subprocess.Popen, log_path: str):
        self.worker_id = worker_id
        self.popen = popen
        self.log_path = log_path


class LocalProcessManager(ElasticWorkerManager):
    """Workers as child processes of this one."""

    def __init__(self, num_workers: int, worker_argv_fn: Callable[[int], List[str]],
                 worker_env: Optional[Dict[str, str]] = None, log_dir: str = "", **kwargs):
        super().__init__(num_workers, worker_argv_fn, **kwargs)
        self._worker_env = dict(worker_env or {})
        self._log_dir = log_dir

    def _substrate_start(self):
        if self._log_dir:
            os.makedirs(self._log_dir, exist_ok=True)

    def _substrate_launch(self, worker_ids: List[int]) -> List[WorkerProcess]:
        procs = []
        for wid in worker_ids:
            argv = self._worker_argv_fn(wid)
            log_path = (os.path.join(self._log_dir, f"worker_{wid}.log") if self._log_dir
                        else os.devnull)
            env = {**os.environ, **self._worker_env}
            with open(log_path, "wb") as log_file:
                popen = subprocess.Popen(argv, stdout=log_file, stderr=subprocess.STDOUT,
                                         env=env)
            procs.append(WorkerProcess(wid, popen, log_path))
            logger.info("Launched worker %d (pid %d)", wid, popen.pid)
            obs.journal().record("worker_launch", worker_id=wid, pid=popen.pid,
                                 log=log_path)
        return procs

    def _substrate_poll(self, handle: WorkerProcess) -> Optional[int]:
        return handle.popen.poll()

    def _substrate_terminate(self, handles: List[WorkerProcess]):
        for wp in handles:
            if wp.popen.poll() is None:
                try:
                    wp.popen.terminate()
                except ProcessLookupError:
                    pass
        deadline = time.time() + 5
        for wp in handles:
            try:
                wp.popen.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                wp.popen.kill()
                wp.popen.wait()

    def _substrate_kill(self, handle: WorkerProcess, sig: int = 9):
        try:
            handle.popen.send_signal(sig)
        except ProcessLookupError:
            pass

    def _describe(self, handle: WorkerProcess) -> str:
        return f"Worker {handle.worker_id} (log: {handle.log_path})"


#: The job flags a worker takes from the master's command line.
WORKER_FLAGS = {
    "model_zoo", "model_def", "model_params", "dataset_fn", "loss", "optimizer",
    "eval_metrics_fn", "custom_data_reader", "callbacks", "training_data", "validation_data",
    "prediction_data", "records_per_task", "minibatch_size", "num_epochs",
    "data_reader_params", "distribution_strategy", "log_level", "checkpoint_dir",
    "checkpoint_steps", "keep_checkpoint_max", "output", "use_bf16", "tensorboard_log_dir",
    "profile_steps", "train_window_steps", "dense_sharding", "mesh_model_axis",
    "sparse_apply_every", "sparse_kernel", "pipeline", "parse_pool_workers",
    "pipeline_inflight", "dispatch_depth", "jax_compilation_cache_dir", "oov_diagnostics",
    "device",
}


def worker_argv_from_args(args, master_addr: str) -> Callable[[int], List[str]]:
    """The worker command line from the job's args (the master's flags
    forwarded, ``--device`` included)."""
    from elasticdl_tpu_torch.common.args import args_to_argv

    forwarded = args_to_argv(args, keys=WORKER_FLAGS)

    def argv_fn(worker_id: int) -> List[str]:
        return [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
                f"--worker_id={worker_id}", f"--master_addr={master_addr}", *forwarded]

    return argv_fn
