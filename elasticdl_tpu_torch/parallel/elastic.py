"""Worker-side elastic world membership and the lockstep task flow: the
port's copy of ``elasticdl_tpu/parallel/elastic.py`` (``join_world``
:62, ``HeartbeatReporter`` :146, ``broadcast_task`` :302,
``iter_local_batch_ranges`` :350, ``per_rank_real_counts`` :375).

A worker asks the master's rendezvous for its rank and joins the world:
a world of one forms no process group and trains on one card (or the
CPU) with no mesh; a larger world calls
``torch.distributed.init_process_group`` at the rendezvous coordinator
(``tcp://<rank 0's host>:<port>``), with NCCL on cards and gloo on the
CPU, and the worker then builds its mesh (``parallel/mesh.build_mesh``).
A member's death kills the whole world: the pod manager re-forms it in
fresh processes, which is what this module runs again.

Rank 0 pulls each task from the master and broadcasts it to every rank
as a fixed-shape int64 tensor; every rank then runs the same number of
steps per task (the lockstep invariant collectives need).

Joining a world is this process's goodput ``rendezvous`` phase
(``obs/goodput.py``).  The heartbeat carries the worker's telemetry
snapshot (``obs/telemetry.py``) and journals a ``clock_probe`` around
each carrying call; a telemetry failure sends an empty snapshot and
never stops the heartbeat.
"""

from __future__ import annotations

import datetime
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.obs import goodput

logger = get_logger("parallel.elastic")


@dataclass
class WorldInfo:
    rank: int
    world_size: int
    rendezvous_id: int
    coordinator_addr: str

    @property
    def is_leader(self) -> bool:
        return self.rank == 0


def advertised_host() -> str:
    """The address this worker tells the rendezvous (``MY_POD_IP`` or
    ``ELASTICDL_WORKER_HOST`` where set, loopback on one host)."""
    return (os.environ.get("ELASTICDL_WORKER_HOST", "")
            or os.environ.get("MY_POD_IP", "") or "127.0.0.1")


def join_world(master_client, device: str = "cuda", poll_interval_s: float = 0.5,
               timeout_s: float = 300.0, initialization_timeout_s: int = 120) -> WorldInfo:
    """Poll the rendezvous until this worker has a rank and the coordinator
    is resolved, then join the process group (none for a world of one):
    NCCL when ``device`` is ``cuda``, gloo when it is ``cpu``.  Each poll
    advertises this worker's host; it never counts as a heartbeat."""
    # Worker-side goodput: from the first rank poll to the process
    # group's barrier is rendezvous time (this process's ledger).
    with goodput.ledger().phase("rendezvous", cause="join_world"):
        return _join_world_inner(master_client, device, poll_interval_s,
                                 time.time() + timeout_s, initialization_timeout_s)


def _join_world_inner(master_client, device, poll_interval_s, deadline,
                      initialization_timeout_s) -> WorldInfo:
    host = advertised_host()
    while True:
        resp = master_client.get_comm_rank(host)
        if resp.rank_id >= 0 and resp.world_size > 0 and (
                resp.world_size == 1 or resp.coordinator_addr):
            break
        if time.time() > deadline:
            raise TimeoutError(
                f"Worker {master_client.worker_id} never received a rank (last "
                f"world_size={resp.world_size}, coordinator={resp.coordinator_addr!r})")
        time.sleep(poll_interval_s)
    info = WorldInfo(rank=resp.rank_id, world_size=resp.world_size,
                     rendezvous_id=resp.rendezvous_id, coordinator_addr=resp.coordinator_addr)
    if info.world_size > 1:
        import torch.distributed as dist

        backend = "gloo" if device == "cpu" else "nccl"
        logger.info("Joining world %d: rank %d/%d via %s (%s)", info.rendezvous_id, info.rank,
                    info.world_size, info.coordinator_addr, backend)
        with obs.span("worker.join_world", rendezvous_id=info.rendezvous_id, rank=info.rank,
                      world_size=info.world_size):
            dist.init_process_group(
                backend, init_method=f"tcp://{info.coordinator_addr}",
                world_size=info.world_size, rank=info.rank,
                timeout=datetime.timedelta(seconds=initialization_timeout_s))
    return info


class HeartbeatReporter:
    """Background liveness heartbeats to the master: the pod manager kills a
    worker whose heartbeats go silent, turning a hang into the process
    exit churn handling reacts to.  With a ``WorkerTelemetry`` each beat
    ships its bounded snapshot as ``telemetry_json``.  Intervals carry
    ±``JITTER`` of deterministic per-worker jitter, so a re-formed fleet
    does not beat in lockstep."""

    WARN_INTERVAL_S = 60.0
    JITTER = 0.2

    def __init__(self, master_client, world: WorldInfo, host: str = "",
                 interval_s: float = 5.0, telemetry=None, jitter: float = JITTER):
        self._mc = master_client
        self._telemetry = telemetry
        self._world = world
        self._host = host or advertised_host()
        self._interval_s = interval_s
        self._jitter = float(jitter)
        self._stop = threading.Event()
        #: Failed heartbeats so far.
        self.error_count = 0
        self._last_warn_monotonic: Optional[float] = None
        self._thread = threading.Thread(target=self._loop, name="worker-heartbeat", daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def jittered_interval_s(self, tick: int) -> float:
        """Uniform in [1-J, 1+J] x interval, seeded from (worker, tick)."""
        if not self._jitter:
            return self._interval_s
        u = random.Random(f"hb:{self._mc.worker_id}:{tick}").random()
        return self._interval_s * (1.0 - self._jitter + 2.0 * self._jitter * u)

    def _loop(self):
        tick = 0
        while not self._stop.wait(self.jittered_interval_s(tick)):
            tick += 1
            payload = ""
            if self._telemetry is not None:
                try:
                    payload = self._telemetry.snapshot_json()
                except Exception:
                    payload = ""  # telemetry never kills the liveness plane
            try:
                t_send = time.time()
                self._mc.report_worker_liveness(self._host, self._world.rendezvous_id,
                                                telemetry_json=payload)
                t_recv = time.time()
                probe_ts = getattr(self._telemetry, "last_snapshot_ts", 0.0) if payload else 0.0
                if probe_ts:
                    # Paired with the master's worker_telemetry record
                    # (same worker_ts) into a clock-offset estimate.
                    obs.journal().record("clock_probe", worker_id=self._mc.worker_id,
                                         probe_ts=probe_ts, t_send=round(t_send, 6),
                                         t_recv=round(t_recv, 6),
                                         rtt_s=round(t_recv - t_send, 6))
            except Exception as exc:
                # The pod manager owns the failure, but say so (rate-limited).
                self.error_count += 1
                now = time.monotonic()
                if (self._last_warn_monotonic is None
                        or now - self._last_warn_monotonic >= self.WARN_INTERVAL_S):
                    self._last_warn_monotonic = now
                    logger.warning(
                        "Liveness heartbeat to master failed (%s: %s); %d failure(s) so "
                        "far; the pod manager may kill this worker if heartbeats stay "
                        "silent", type(exc).__name__, exc, self.error_count)


# ---------------------------------------------------------------------------
# Task broadcast: rank 0 is the only rank that asks the master for tasks.
# ---------------------------------------------------------------------------

_TASK_ENC_LEN = 7  # task_id, shard_idx, start, end, type, model_version, epoch


def _encode_task(task: Optional[msg.Task], shard_names: List[str]) -> np.ndarray:
    if task is None:
        return np.full((_TASK_ENC_LEN,), -1, np.int64)
    shard_idx = shard_names.index(task.shard_name) if task.shard_name else -1
    return np.asarray([task.task_id, shard_idx, task.start, task.end, task.type,
                       task.model_version, task.epoch], np.int64)


def _decode_task(arr: np.ndarray, shard_names: List[str]) -> msg.Task:
    task_id, shard_idx, start, end, type_, version, epoch = (int(v) for v in arr)
    return msg.Task(task_id=task_id, shard_name=shard_names[shard_idx] if shard_idx >= 0 else "",
                    start=start, end=end, type=type_, model_version=version, epoch=epoch)


def broadcast_task(task: Optional[msg.Task], shard_names: List[str], world: WorldInfo,
                   anatomy=None) -> msg.Task:
    """Every rank calls this; rank 0 supplies the task and every rank
    returns it.  ``shard_names`` is the same list, in the same order, on
    every rank.  The leader keeps its own task object (the encoding drops
    the trace id).  ``anatomy`` (``obs/stepstats.StepAnatomy``) books the
    broadcast under ``data_wait`` on the other ranks, for a real task
    only: this is their task-queue wait (the leader books its own)."""
    if world.world_size == 1:
        if task is None:
            raise ValueError("a world of one broadcasts its own task: got None")
        return task
    import torch.distributed as dist

    start = time.monotonic()

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    encoded = torch.from_numpy(_encode_task(task, shard_names)).to(device)
    dist.broadcast(encoded, src=0, group=dist.group.WORLD)
    if world.is_leader and task is not None:
        return task
    decoded = _decode_task(encoded.cpu().numpy(), shard_names)
    if anatomy is not None and decoded.task_id != -1 and decoded.type != msg.WAIT:
        anatomy.note_phase_seconds("data_wait", time.monotonic() - start)
    return decoded


# ---------------------------------------------------------------------------
# Lockstep global batching.
# ---------------------------------------------------------------------------

def iter_local_batch_ranges(task_start: int, task_end: int, per_rank_batch: int,
                            world: WorldInfo) -> Iterator[Tuple[int, int, int]]:
    """Yield ``(lo, hi, global_real)`` for this rank, one per global step.
    Global batch b covers records ``[task_start + b*W*B, ...)``; rank r's
    slice is its r-th contiguous B-record chunk.  Every rank yields the
    same number of tuples (empty ``[lo, lo)`` slices at a ragged tail);
    ``global_real`` is the batch's real record count over all ranks."""
    total = task_end - task_start
    global_batch = per_rank_batch * world.world_size
    n_steps = max(1, -(-total // global_batch)) if total > 0 else 0
    for b in range(n_steps):
        g_lo = task_start + b * global_batch
        g_hi = min(g_lo + global_batch, task_end)
        lo = min(g_lo + world.rank * per_rank_batch, g_hi)
        hi = min(lo + per_rank_batch, g_hi)
        yield lo, hi, g_hi - g_lo


def per_rank_real_counts(global_real: int, per_rank_batch: int, world_size: int) -> List[int]:
    """How many real (non-pad) rows each rank contributed to a global
    batch."""
    counts = []
    remaining = global_real
    for _ in range(world_size):
        take = min(per_rank_batch, max(0, remaining))
        counts.append(take)
        remaining -= take
    return counts
