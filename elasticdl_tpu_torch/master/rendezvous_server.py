"""Elastic rendezvous: the port's copy of
``elasticdl_tpu/master/rendezvous_server.py`` (``ElasticRendezvous`` :55).

The master holds "the current world": it assigns ranks to the alive
workers in ascending worker id and bumps ``rendezvous_id`` on every
membership change; workers poll ``get_comm_rank``.  The answer carries
the coordinator address, rank 0's host and a port the master picks free
for each new world, where rank 0's ``torch.distributed`` TCP store
listens (``parallel/elastic.join_world``), so a straggler of an old
world can never join the new one.  A host may be empty (a worker not yet
scheduled); the coordinator then resolves once rank 0 advertises its
address, on a port derived from the rendezvous id.

Heartbeats (``report_liveness``) feed ``stale_workers``, which the pod
manager reads to kill a hung worker; a worker that never beat is judged
against the startup grace from the world's declaration.  A declaration
and the moment the last rank takes its rank drive the goodput ledger's
rendezvous phase and its rescale cost (``obs/goodput.py``).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.obs import goodput

logger = get_logger("master.rendezvous")


def find_free_port(host: str = "127.0.0.1") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind((host, 0))
        return sock.getsockname()[1]


def remote_coordinator_port(rendezvous_id: int) -> int:
    """The coordinator port on a remote rank-0 host: deterministic, varied
    with the rendezvous id."""
    base = int(os.environ.get("ELASTICDL_COORDINATOR_PORT", "3391"))
    return base + rendezvous_id % 1021


class ElasticRendezvous:
    """The single source of truth for the current world."""

    def __init__(self, coordinator_port_fn=find_free_port):
        self._lock = threading.Lock()
        self._coordinator_port_fn = coordinator_port_fn
        self._rendezvous_id = 0
        self._workers: List[Tuple[int, str]] = []  # sorted (worker_id, host)
        self._coordinator_addr = ""
        self._last_heartbeat: Dict[int, Optional[float]] = {}
        self._world_declared_at = time.time()
        self._world_declared_monotonic = time.monotonic()
        self._ranks_polled: set = set()
        self._formation_observed = True
        self._m_epochs = obs.counter("elasticdl_rendezvous_epochs_total",
                                     "World declarations (rendezvous id bumps)")
        self._m_world_size = obs.gauge("elasticdl_world_size",
                                       "Declared world size of the current rendezvous")
        self._m_formation = obs.histogram(
            "elasticdl_rendezvous_formation_duration_seconds",
            "World declaration -> every member has polled its rank")

    # -- master / pod-manager side -----------------------------------------

    def set_worker_hosts(self, workers: List[Tuple[int, str]]) -> int:
        """Declare the new world ``[(worker_id, host)]``; returns its
        rendezvous id."""
        with self._lock:
            workers = sorted(workers)
            self._workers = workers
            self._rendezvous_id += 1
            if workers and workers[0][1]:
                rank0_host = workers[0][1]
                self._coordinator_addr = f"{rank0_host}:{self._coordinator_port_fn(rank0_host)}"
            else:
                self._coordinator_addr = ""  # deferred (or an empty world)
            # None until a worker's first heartbeat: it is judged against
            # the startup grace (spawn, imports, the process-group barrier).
            self._world_declared_at = time.time()
            self._world_declared_monotonic = time.monotonic()
            self._last_heartbeat = {wid: None for wid, _ in workers}
            self._ranks_polled = set()
            self._formation_observed = not workers
            rendezvous_id = self._rendezvous_id
            worker_ids = [wid for wid, _ in workers]
            # Inside the lock: declarations publish in rendezvous-id order.
            self._m_epochs.inc()
            self._m_world_size.set(len(worker_ids))
            obs.journal().record("rendezvous", rendezvous_id=rendezvous_id,
                                 world_size=len(worker_ids), workers=worker_ids,
                                 coordinator=self._coordinator_addr)
            logger.info("Rendezvous %d: world_size=%d coordinator=%s workers=%s",
                        rendezvous_id, len(workers), self._coordinator_addr, worker_ids)
        # Outside the lock: the ledger journals.
        goodput.ledger().on_world_declared(rendezvous_id, len(worker_ids))
        return rendezvous_id

    @property
    def rendezvous_id(self) -> int:
        with self._lock:
            return self._rendezvous_id

    def world(self) -> List[Tuple[int, str]]:
        with self._lock:
            return list(self._workers)

    def stale_workers(self, timeout_s: float, startup_grace_s: Optional[float] = None
                      ) -> List[int]:
        """Workers whose heartbeat went silent for ``timeout_s``, or that
        never beat within ``startup_grace_s`` of the world's declaration."""
        grace = startup_grace_s if startup_grace_s is not None else timeout_s
        now = time.time()
        with self._lock:
            stale = []
            for wid, last in self._last_heartbeat.items():
                if last is None:
                    if now - self._world_declared_at > grace:
                        stale.append(wid)
                elif now - last > timeout_s:
                    stale.append(wid)
            return stale

    # -- worker side (through the servicer) ---------------------------------

    def _record_host_locked(self, worker_id: int, host: str):
        if not host:
            return
        for i, (wid, known) in enumerate(self._workers):
            if wid == worker_id and known != host:
                self._workers[i] = (wid, host)
                logger.info("Worker %d advertised host %s (rendezvous %d)", worker_id, host,
                            self._rendezvous_id)

    def _resolve_coordinator_locked(self):
        if self._coordinator_addr or not self._workers:
            return
        rank0_host = self._workers[0][1]
        if rank0_host:
            self._coordinator_addr = (
                f"{rank0_host}:{remote_coordinator_port(self._rendezvous_id)}")
            logger.info("Rendezvous %d coordinator resolved: %s", self._rendezvous_id,
                        self._coordinator_addr)

    def get_comm_rank(self, worker_id: int, host: str = "") -> msg.GetCommRankResponse:
        """``host`` is the worker's advertised address; it rides the rank
        poll, never the heartbeat, so polling is not a heartbeat."""
        formed_id = None
        with self._lock:
            self._record_host_locked(worker_id, host)
            self._resolve_coordinator_locked()
            ids = [wid for wid, _ in self._workers]
            rank = ids.index(worker_id) if worker_id in ids else -1
            if rank >= 0 and not self._formation_observed:
                self._ranks_polled.add(worker_id)
                if self._ranks_polled >= set(ids):
                    self._formation_observed = True
                    formed_id = self._rendezvous_id
                    self._m_formation.observe(time.monotonic() - self._world_declared_monotonic)
            response = msg.GetCommRankResponse(
                rank_id=rank,
                world_size=len(self._workers),
                rendezvous_id=self._rendezvous_id,
                coordinator_addr=self._coordinator_addr,
                worker_hosts=[h for _, h in self._workers],
            )
        if formed_id is not None:
            # Every member has its rank: the rescale's rendezvous part ends.
            goodput.ledger().on_world_formed(formed_id)
        return response

    def report_liveness(self, worker_id: int, host: str, rendezvous_id: int) -> bool:
        """A heartbeat; True when the worker's world is stale."""
        with self._lock:
            self._record_host_locked(worker_id, host)
            if worker_id in self._last_heartbeat:
                self._last_heartbeat[worker_id] = time.time()
            return rendezvous_id != self._rendezvous_id
