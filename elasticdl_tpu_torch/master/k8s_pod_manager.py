"""Kubernetes worker-pod substrate for the elastic manager: the port's
copy of ``elasticdl_tpu/master/k8s_pod_manager.py``.

All supervision policy (churn -> recover tasks -> restart-the-world, the
restart budget, the hung-worker kill, ``scale``, the regrow gated by the
policy engine through ``_GatedScaleUp``) is inherited from
``master/pod_manager.ElasticWorkerManager``; this class maps the five
substrate hooks onto pods:

- launch    = POST pods rendered by ``k8s_client.render_pod``
- poll      = a status cache kept by a watch thread (Succeeded -> 0,
              Failed -> the container's exit code, vanished without us
              deleting it -> 137, i.e. preempted or evicted)
- kill      = DELETE with gracePeriodSeconds=0 (preemption semantics)
- terminate = DELETE all, then wait until the API server forgets them,
              so a re-formed world never races its predecessor's pods

The watch thread consumes ``watch_pods`` and resumes from the last
``resourceVersion``; a 410 Gone falls back to a re-list.  Pod names
encode worker ids (``elasticdl-{job}-worker-{id}``) and ids are never
reused across worlds, so DELETED events of an old world are never read
as churn in the new one.  A new master sweeps the worker pods a dead
predecessor left, a create that meets a stale namesake (409) replaces
it, and every cache entry is pinned to the uid this manager created.
Growth is two-phase: probe pods for the deficit first, and the
restart-the-world regrow only once they all run.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.analysis.runtime import make_lock
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.master.k8s_client import (
    ApiError,
    K8sClient,
    WatchExpired,
    job_label_selector,
    pod_exit_code,
    pod_name,
    pod_phase,
    render_pod,
)
from elasticdl_tpu_torch.master.pod_manager import ElasticWorkerManager
from elasticdl_tpu_torch.obs import goodput

logger = get_logger("master.k8s_pod_manager")

# Exit code reported when a pod disappears without this manager deleting
# it (node preemption, eviction, kubectl delete): SIGKILL convention.
PREEMPTED_EXIT_CODE = 137


class PodHandle:
    def __init__(self, worker_id: int, name: str):
        self.worker_id = worker_id
        self.name = name


class _PodState:
    __slots__ = ("phase", "exit_code", "deleted", "pod_ip", "uid",
                 "timeout_reported")

    def __init__(self, uid: str = ""):
        self.phase = "Pending"
        self.exit_code: Optional[int] = None
        self.deleted = False
        self.pod_ip = ""
        # Pending-timeout observability fires once per pod even though
        # poll keeps returning the synthetic exit code until churn lands.
        self.timeout_reported = False
        # uid of the pod *this manager created* under the name; events
        # carrying a different uid belong to a stale namesake (409-replace,
        # predecessor sweep races) and must not clobber this state.
        self.uid = uid


class KubernetesPodManager(ElasticWorkerManager):
    """Elastic worker fleet as Kubernetes pods."""

    def __init__(
        self,
        num_workers: int,
        worker_argv_fn: Callable[[int], List[str]],
        k8s_client: K8sClient,
        job_name: str,
        image: str,
        worker_env: Optional[Dict[str, str]] = None,
        worker_resources: Optional[Dict[str, str]] = None,
        priority_class: str = "",
        owner_pod: Optional[dict] = None,
        pod_startup_timeout_s: float = 300.0,
        volume_spec: str = "",
        tpu_slice: str = "",
        **kwargs,
    ):
        super().__init__(num_workers, worker_argv_fn, **kwargs)
        self._client = k8s_client
        self._job_name = job_name
        self._image = image
        self._worker_env = dict(worker_env or {})
        self._worker_resources = dict(worker_resources or {})
        self._worker_node_selector: Dict[str, str] = {}
        if tpu_slice:
            # One worker pod per TPU VM host of the slice: the chip
            # resource + node selectors come from the shape catalog
            # (master/tpu_slice.py); submit-time validation already
            # pinned num_workers == hosts.
            from elasticdl_tpu_torch.master.tpu_slice import (
                slice_spec,
                validate_worker_count,
                worker_pod_overlay,
            )

            spec = slice_spec(tpu_slice)
            validate_worker_count(spec, num_workers)
            overlay = worker_pod_overlay(spec)
            self._worker_resources.update(overlay["resources"])
            self._worker_node_selector = overlay["node_selector"]
        self._priority_class = priority_class
        self._volume_spec = volume_spec
        self._owner_pod = owner_pod
        self._pod_startup_timeout_s = pod_startup_timeout_s

        self._selector = job_label_selector(self._job_name, "worker")
        # Inherited supervision fields this substrate also mutates keep
        # the base class's lock discipline:
        # guarded-by: _lock: _handles, _next_worker_id, _num_workers
        self._state_lock = make_lock("KubernetesPodManager._state_lock")
        self._pod_states: Dict[str, _PodState] = {}  # guarded-by: _state_lock
        self._we_deleted: set = set()  # guarded-by: _state_lock
        self._created_at: Dict[str, float] = {}  # guarded-by: _state_lock
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._m_pod_failures = obs.counter(
            "elasticdl_pod_failures_total",
            "Worker-pod failures the substrate itself observed, by cause "
            "(exit-code churn is counted by the relaunch counter)",
            labelnames=("cause",),
        )
        self._resource_version = ""  # watch thread only (single writer)
        self._probe_handles: List[PodHandle] = []  # guarded-by: _lock
        self._probe_started = 0.0  # monitor thread only (single writer)

    # ------------------------------------------------------------------
    # Watch thread: API-server events -> pod status cache
    # ------------------------------------------------------------------

    def _substrate_start(self):
        self._sweep_leftover_pods()
        self._resync()
        self._watch_thread = threading.Thread(
            target=self._watch_loop, name="k8s-pod-watch", daemon=True
        )
        self._watch_thread.start()

    def _sweep_leftover_pods(self):
        """A new master incarnation owns the job exclusively: worker pods
        left by a crashed/restarted predecessor belong to a dead world
        (their master is gone; they can make no progress) and their names
        collide with the ones this incarnation will render.  Delete them
        before launching world 1 — master-restart resume depends on it."""
        leftovers = self._client.list_pods(self._selector)
        if not leftovers:
            return
        logger.info(
            "Sweeping %d leftover worker pod(s) from a previous master "
            "incarnation: %s",
            len(leftovers),
            [p["metadata"]["name"] for p in leftovers],
        )
        for pod in leftovers:
            try:
                self._client.delete_pod(
                    pod["metadata"]["name"], grace_period_s=0
                )
            except ApiError as e:
                logger.warning(
                    "Sweeping pod %s failed: %s", pod["metadata"]["name"], e
                )
        deadline = time.time() + 30
        while time.time() < deadline:
            if not self._client.list_pods(self._selector):
                return
            time.sleep(0.2)
        raise RuntimeError(
            "Leftover worker pods from a previous master incarnation did "
            "not terminate; refusing to start a colliding world"
        )

    def stop(self):
        self._watch_stop.set()
        super().stop()  # sets _stopped first: no new probe can be adopted
        self._abort_probe()

    def _resync(self):
        """Full re-list: rebuild the status cache (watch bootstrap + 410).

        Pods we have cached but the list no longer returns were deleted
        while the watch was down — mark them deleted, or their state would
        read 'Running' forever and their churn would never surface.  The
        list's resourceVersion is the correct watch-resume point."""
        listing = self._client.list_pods_raw(self._selector)
        listed = {p["metadata"]["name"]: p for p in listing.get("items", [])}
        with self._lock:
            tracked = {h.name for h in self._handles} | {
                h.name for h in self._probe_handles
            }
        with self._state_lock:
            for name, pod in listed.items():
                # Untracked listed pods (terminating members of torn-down
                # worlds) get no cache entry — the teardown prune removed
                # them and nothing would ever prune them again.
                if name in tracked or name in self._pod_states:
                    self._apply_pod_locked(pod, authoritative=True)
            now = time.time()
            grace = max(60.0, self._pod_startup_timeout_s)
            for name in list(self._pod_states):
                if name in listed:
                    continue
                if name in tracked:
                    # Vanished while the watch was down: surfaces as churn.
                    self._pod_states[name].deleted = True
                elif now - self._created_at.get(name, 0.0) > grace:
                    # Old untracked leftovers only: a pod launched moments
                    # ago may not be in _handles/_probe_handles yet (its
                    # launch is still returning) and may predate the list
                    # snapshot — pruning it would blind polling to it
                    # forever.  Teardown prunes the normal case; this is
                    # the leak backstop.
                    self._pod_states.pop(name)
                    self._we_deleted.discard(name)
                    self._created_at.pop(name, None)
        rv = (listing.get("metadata") or {}).get("resourceVersion", "")
        if rv:
            self._resource_version = rv

    def _watch_loop(self):
        while not self._watch_stop.is_set():
            try:
                for etype, pod in self._client.watch_pods(
                    self._selector,
                    resource_version=self._resource_version,
                    timeout_s=30.0,
                ):
                    rv = (pod.get("metadata") or {}).get("resourceVersion")
                    if rv:
                        self._resource_version = rv
                    if etype == "BOOKMARK":
                        continue
                    with self._state_lock:
                        if etype == "DELETED":
                            name = pod["metadata"]["name"]
                            state = self._pod_states.get(name)
                            if state is not None and self._uid_matches(
                                state, pod
                            ):
                                state.deleted = True
                        else:
                            self._apply_pod_locked(pod)
                    if self._watch_stop.is_set():
                        return
            except WatchExpired:
                self._resource_version = ""
                try:
                    self._resync()
                except Exception:
                    logger.exception("Pod re-list after 410 failed; retrying")
            except Exception as exc:
                if self._watch_stop.is_set():
                    return
                logger.warning("Pod watch dropped (%s); reconnecting", exc)
                time.sleep(0.5)

    @staticmethod
    def _uid_matches(state: "_PodState", pod: dict) -> bool:
        event_uid = (pod.get("metadata") or {}).get("uid", "")
        return not state.uid or not event_uid or state.uid == event_uid

    def _apply_pod_locked(self, pod: dict, authoritative: bool = False):
        """Fold one pod object into the cache.  Watch events for pods we
        aren't tracking (pruned after teardown) or for a uid we did not
        create (stale namesakes) are ignored; a re-list (`authoritative`)
        reflects current cluster truth and wins."""
        name = pod["metadata"]["name"]
        state = self._pod_states.get(name)
        if state is None:
            if not authoritative:
                return
            self._pod_states[name] = state = _PodState()
        if not self._uid_matches(state, pod):
            if not authoritative:
                return
            self._pod_states[name] = state = _PodState()
        state.uid = state.uid or (pod.get("metadata") or {}).get("uid", "")
        state.phase = pod_phase(pod)
        code = pod_exit_code(pod)
        if code is not None:
            state.exit_code = code
        state.pod_ip = (pod.get("status") or {}).get("podIP", "") or state.pod_ip

    # ------------------------------------------------------------------
    # Substrate hooks
    # ------------------------------------------------------------------

    def _substrate_launch(self, worker_ids: List[int]) -> List[PodHandle]:
        handles = []
        for wid in worker_ids:
            manifest = render_pod(
                job_name=self._job_name,
                replica_type="worker",
                index=wid,
                image=self._image,
                command=self._worker_argv_fn(wid),
                namespace=self._client.namespace,
                env=self._worker_env,
                resources=self._worker_resources or None,
                priority_class=self._priority_class,
                owner=self._owner_pod,
                volume_spec=self._volume_spec,
                node_selector=self._worker_node_selector or None,
            )
            name = manifest["metadata"]["name"]
            with self._state_lock:
                self._pod_states[name] = _PodState()
                self._we_deleted.discard(name)
                self._created_at[name] = time.time()
            try:
                created = self._create_pod_replacing(manifest, name)
                self._pin_created_uid(name, created)
            except ApiError as e:
                # Leave the handle in place; poll will surface the failure
                # as churn and the budget decides what happens next.
                logger.error("Creating pod %s failed: %s", name, e)
                self._m_pod_failures.inc(cause="create_error")
                obs.journal().record(
                    "pod_create_failed", pod=name, error=str(e)
                )
                with self._state_lock:
                    state = self._pod_states.setdefault(name, _PodState())
                    state.phase = "Failed"
                    state.exit_code = 1
            handles.append(PodHandle(wid, name))
            logger.info("Created worker pod %s", name)
        return handles

    def _pin_created_uid(self, name: str, created: dict):
        """Bind the cache entry to the uid we just created.  Events may
        already have flowed into the placeholder — some for THIS uid
        (keep them: a Running may never repeat), some from a stale
        namesake whose DELETED landed while uid was unpinned.  A deleted
        flag at pin time is therefore ambiguous; resolve it against the
        API server: if the pod exists with our uid, the flag was the
        namesake's — clear it; if the pod is truly gone, keep it (churn).
        """
        uid = (created.get("metadata") or {}).get("uid", "")
        with self._state_lock:
            existing = self._pod_states.get(name)
            if existing is None or (existing.uid and existing.uid != uid):
                fresh = _PodState(uid=uid)
                fresh.phase = pod_phase(created)
                self._pod_states[name] = fresh
                return
            existing.uid = uid
            ambiguous = existing.deleted
        if not ambiguous:
            return
        try:
            current = self._client.get_pod(name)
        except ApiError:
            return  # leave deleted: worst case a spurious churn, not a hang
        if (
            current is not None
            and (current.get("metadata") or {}).get("uid", "") == uid
        ):
            with self._state_lock:
                state = self._pod_states.get(name)
                if state is not None and state.uid == uid:
                    state.deleted = False
                    self._apply_pod_locked(current, authoritative=True)

    def _create_pod_replacing(self, manifest: dict, name: str) -> dict:
        """Create, tolerating one 409 AlreadyExists by deleting the stale
        namesake first (a racing predecessor pod the sweep missed)."""
        try:
            return self._client.create_pod(manifest)
        except ApiError as e:
            if e.status != 409:
                raise
        logger.warning("Pod %s already exists; replacing it", name)
        self._client.delete_pod(name, grace_period_s=0)
        deadline = time.time() + 15
        while self._client.get_pod(name) is not None:
            if time.time() > deadline:
                raise ApiError(409, "AlreadyExists", f"{name} stuck terminating")
            time.sleep(0.1)
        return self._client.create_pod(manifest)

    def _substrate_poll(self, handle: PodHandle) -> Optional[int]:
        with self._state_lock:
            state = self._pod_states.get(handle.name)
            created = self._created_at.get(handle.name, 0.0)
            we_deleted = handle.name in self._we_deleted
        if state is None:
            return None
        if state.deleted:
            if we_deleted:
                return None  # our own teardown, not churn
            return (
                state.exit_code
                if state.exit_code is not None
                else PREEMPTED_EXIT_CODE
            )
        if state.phase == "Succeeded":
            return state.exit_code if state.exit_code is not None else 0
        if state.phase == "Failed":
            return state.exit_code if state.exit_code is not None else 1
        if (
            state.phase == "Pending"
            and self._pod_startup_timeout_s > 0
            and created
            and time.time() - created > self._pod_startup_timeout_s
        ):
            # Unschedulable pod (no capacity, bad image): count as failed so
            # the budget shrinks the world instead of hanging forever.
            logger.warning(
                "Pod %s Pending > %.0fs; treating as failed",
                handle.name,
                self._pod_startup_timeout_s,
            )
            with self._state_lock:
                report = not state.timeout_reported
                state.timeout_reported = True
            if report:
                self._m_pod_failures.inc(cause="pending_timeout")
                obs.journal().record(
                    "pod_pending_timeout",
                    pod=handle.name,
                    timeout_s=self._pod_startup_timeout_s,
                )
            return PREEMPTED_EXIT_CODE
        return None

    def _substrate_terminate(self, handles: List[PodHandle]):
        for h in handles:
            with self._state_lock:
                self._we_deleted.add(h.name)
            try:
                self._client.delete_pod(h.name, grace_period_s=0)
            except ApiError as e:
                logger.warning("Deleting pod %s failed: %s", h.name, e)
        # Block until the API server forgets them: a re-formed world must
        # never share the cluster with its predecessor's pods.
        deadline = time.time() + 30
        for h in handles:
            while time.time() < deadline:
                with self._state_lock:
                    state = self._pod_states.get(h.name)
                    gone = state is None or state.deleted
                if gone or self._client.get_pod(h.name) is None:
                    break
                time.sleep(0.1)
        # Terminated pods are never polled again (handles are discarded by
        # every caller); prune their cache entries or a churn-heavy job
        # accumulates unbounded per-pod state across world re-formations.
        with self._state_lock:
            for h in handles:
                self._pod_states.pop(h.name, None)
                self._we_deleted.discard(h.name)
                self._created_at.pop(h.name, None)

    def _substrate_kill(self, handle: PodHandle, sig: int = 9):
        # No signal vocabulary in the pods API; grace-0 delete == SIGKILL.
        # NOT recorded in _we_deleted: the death must read as churn.
        try:
            self._client.delete_pod(handle.name, grace_period_s=0)
        except ApiError as e:
            logger.warning("Killing pod %s failed: %s", handle.name, e)

    def _worker_host(self, worker_id: int) -> str:
        """Pod IPs are unknown until the kubelet schedules the pod, so the
        world is declared with deferred hosts: each worker advertises its
        real IP (MY_POD_IP) over the liveness channel, and the rendezvous
        resolves the coordinator once rank 0 has reported in."""
        return ""

    def _describe(self, handle: PodHandle) -> str:
        return f"Worker pod {handle.name}"

    # ------------------------------------------------------------------
    # Two-phase elastic scale-up
    # ------------------------------------------------------------------

    def _maybe_scale_up(self, handles: List[PodHandle]) -> bool:
        """Capacity on Kubernetes is unknowable without scheduling, so
        growth is two-phase: (1) create PROBE pods for the deficit without
        touching the healthy world; (2) only once every probe pod is
        Running — capacity proven — perform the restart-the-world regrow.
        Probe pods that sit Pending past the startup timeout are deleted
        and the oracle backs off.  Failed probes therefore cost nothing:
        no teardown, no rollback to the last checkpoint, and no restart
        budget (the teardown-first base behavior would burn all three per
        attempt in a capacity-starved cluster)."""
        with self._resize_lock:
            with self._lock:
                if self._stopped or self._handles != handles:
                    # The world was replaced (a concurrent scale() on the
                    # policy thread) since this snapshot was polled; probe
                    # decisions — and especially the commit's
                    # world-replacement — would act on a stale world.  An
                    # open probe just stays pending until the next tick
                    # re-evaluates it against the new world.
                    return False
            return self._maybe_scale_up_serialized(handles)

    def _maybe_scale_up_serialized(self, handles: List[PodHandle]) -> bool:
        current = len(handles)
        deficit = self._target_num_workers - current
        if deficit <= 0 or self._scale_up_check_fn is None:
            self._abort_probe()  # target reached by other means
            return False
        if self._job_finished():
            self._abort_probe()
            return False
        if self._probe_handles:
            return self._check_probe(handles)
        grant = self._scale_up_check_fn(deficit)
        if grant <= 0:
            return False
        with self._lock:
            if self._stopped:
                return False
            probe_ids = list(
                range(self._next_worker_id, self._next_worker_id + grant)
            )
            self._next_worker_id += grant
        logger.info(
            "Scale-up probe: scheduling %d candidate pod(s) toward target %d",
            grant,
            self._target_num_workers,
        )
        self._probe_started = time.time()
        new_probe = self._substrate_launch(probe_ids)
        with self._lock:
            if self._stopped:
                stale, new_probe = new_probe, []
            else:
                self._probe_handles = new_probe
                stale = []
        self._substrate_terminate(stale)  # stop() raced the launch
        return True

    def _check_probe(self, handles: List[PodHandle]) -> bool:
        states = []
        with self._state_lock:
            for h in self._probe_handles:
                state = self._pod_states.get(h.name)
                states.append(state.phase if state and not state.deleted else "Gone")
        if any(s in ("Failed", "Gone", "Succeeded") for s in states):
            logger.warning("Scale-up probe pod died; aborting probe")
            self._probe_failed()
            return False
        if all(s == "Running" for s in states):
            grown = len(handles) + len(self._probe_handles)
            logger.info(
                "Scale-up probe succeeded: capacity for %d worker(s) proven; "
                "re-forming world %d -> %d",
                len(self._probe_handles),
                len(handles),
                grown,
            )
            # Commit: restart-the-world at the grown size.  Probe pods are
            # replaced too — every member of a world must join the same
            # fresh rendezvous from a clean process.
            with self._lock:
                probe, self._probe_handles = self._probe_handles, []
            if hasattr(self._scale_up_check_fn, "succeeded"):
                self._scale_up_check_fn.succeeded()
            with self._lock:
                stopped = self._stopped
                if not stopped:
                    self._handles = []
                    self._num_workers = grown
            if stopped:
                # Terminate outside the lock: pod deletion blocks on the
                # API server and must not stall other lock holders.
                self._substrate_terminate(probe)
                return True
            # The base regrow's accounting: the ledger prices the rescale.
            self._m_relaunches.inc(grown, reason="scale_up")
            obs.journal().record("scale_up", old_size=len(handles), new_size=grown)
            goodput.ledger().on_rescale_detected("scale_up", len(handles))
            self._recover_world_tasks(handles)
            self._substrate_terminate(handles + probe)
            goodput.ledger().on_drain_complete(grown)
            self._launch_world(grown)
            return True
        if (
            self._pod_startup_timeout_s > 0
            and time.time() - self._probe_started > self._pod_startup_timeout_s
        ):
            logger.info(
                "Scale-up probe pods still Pending after %.0fs — no "
                "capacity; backing off",
                self._pod_startup_timeout_s,
            )
            self._probe_failed()
        return False

    def _probe_failed(self):
        self._abort_probe()
        if hasattr(self._scale_up_check_fn, "failed"):
            self._scale_up_check_fn.failed()

    def _abort_probe(self):
        with self._lock:
            probe, self._probe_handles = self._probe_handles, []
        if probe:
            self._substrate_terminate(probe)
