"""The port's master transport (HTTP, common/http_rpc.py) and its client
(worker/master_client.py): the JAX package's retry rules per call, held
across a master restart on the same port, with report_task_result never
retried; the backoff schedule is the JAX policy's."""

import socket
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.common import grpc_utils
from elasticdl_tpu_torch.common import faults
from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.common import retry
from elasticdl_tpu_torch.common.http_rpc import JsonRpcClient
from elasticdl_tpu_torch.master.rendezvous_server import ElasticRendezvous
from elasticdl_tpu_torch.master.servicer import MasterServicer, start_master_server
from elasticdl_tpu_torch.master.task_manager import TaskManager
from elasticdl_tpu_torch.worker.master_client import MasterClient

FAST = retry.RetryPolicy(timeout_s=5.0, max_attempts=60, base_backoff_s=0.05,
                         max_backoff_s=0.2, total_budget_s=30.0)


def _servicer(n=8):
    rdzv = ElasticRendezvous()
    rdzv.set_worker_hosts([(0, "127.0.0.1")])
    return MasterServicer(TaskManager(training_shards={"s": n}, records_per_task=4), rdzv)


def test_backoff_schedule_and_policies_are_the_jax_ones():
    for method, seed in [("get_task", "0"), ("report_version", "7")]:
        assert retry.expected_backoff_schedule(method, retry.IDEMPOTENT_POLICY, 10, seed) == \
            grpc_utils.expected_backoff_schedule(method, grpc_utils.IDEMPOTENT_POLICY, 10, seed)
    for name in ("timeout_s", "max_attempts", "base_backoff_s", "max_backoff_s", "jitter",
                 "total_budget_s"):
        assert getattr(retry.IDEMPOTENT_POLICY, name) == \
            getattr(grpc_utils.IDEMPOTENT_POLICY, name)
        assert getattr(retry.NON_IDEMPOTENT_POLICY, name) == \
            getattr(grpc_utils.NON_IDEMPOTENT_POLICY, name)


def test_every_method_over_http():
    server, port = start_master_server(_servicer())
    client = MasterClient(f"localhost:{port}", worker_id=0, retry_policy=FAST)
    try:
        rank = client.get_comm_rank("127.0.0.1")
        assert (rank.rank_id, rank.world_size, rank.rendezvous_id) == (0, 1, 1)
        task = client.get_task()
        assert (task.task_id, task.start, task.end, task.type) == (1, 0, 4, msg.TRAINING)
        assert task.trace_id.startswith("t-")
        client.report_task_result(task.task_id, "", {"batch_count": 2})
        assert client.report_worker_liveness("127.0.0.1", 1) is False
        assert client.report_worker_liveness("127.0.0.1", 0) is True  # a stale world
        client.report_version(7)
        assert '"todo"' in client.get_shard_checkpoint()
        # No evaluation service in this job: the chunk is dropped.
        client.report_evaluation_metrics(7, {"output": np.zeros(3, np.float32)},
                                         np.ones(3, np.int32), task_id=task.task_id)
        raw = JsonRpcClient(f"127.0.0.1:{port}")
        assert isinstance(raw.call("report_evaluation_metrics",
                                   msg.ReportEvaluationMetricsRequest(),
                                   retry.NON_IDEMPOTENT_POLICY),
                          msg.ReportEvaluationMetricsResponse)
        with pytest.raises(retry.RpcError) as err:
            raw._once("no_such_method", b"{}", 5.0, False)
        assert err.value.code == "UNIMPLEMENTED" and err.value.status == 501
        raw.close()
    finally:
        client.close()
        server.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_retries_ride_a_master_restart_on_the_same_port():
    port = _free_port()
    servicer = _servicer()
    server, bound = start_master_server(servicer, port=port)
    assert bound == port
    client = MasterClient(f"localhost:{port}", worker_id=3, retry_policy=FAST)
    try:
        first = client.get_task()  # a keep-alive connection to the first master
        server.stop()
        # Down: a call made once fails at once, and is never retried.
        attempts = client.retry_stats.attempts
        with pytest.raises(retry.TRANSIENT_ERRORS + (retry.RpcError,)):
            client.report_task_result(first.task_id, "")
        assert client.retry_stats.attempts == attempts + 1
        assert client.retry_stats.retries == 0

        restarted = {}

        def restart():
            time.sleep(0.6)
            restarted["server"] = start_master_server(servicer, port=port)[0]

        thread = threading.Thread(target=restart)
        thread.start()
        second = client.get_task()  # retried until the new master answers
        thread.join(timeout=30)
        assert not thread.is_alive()
        assert client.retry_stats.retries >= 1
        assert client.retry_stats.per_method_retries.get("get_task", 0) >= 1
        assert second.task_id == 2 and (second.start, second.end) == (4, 8)
        # The unreported first task is still in flight on the master;
        # its result lands now that the master is back.
        client.report_task_result(first.task_id, "")
        assert servicer._task_manager.counts()["doing"] == 1
    finally:
        client.close()
        restarted.get("server", server).stop()


def test_a_failed_attempt_is_an_injected_status_and_gives_up_on_budget():
    server, port = start_master_server(_servicer())
    sleeps = []
    policy = retry.RetryPolicy(timeout_s=2.0, max_attempts=3, base_backoff_s=0.01)
    client = MasterClient(f"127.0.0.1:{port}", worker_id=1, retry_policy=policy,
                          sleep=sleeps.append)
    faults.install("rpc.get_task:error=UNAVAILABLE@1x2,rpc.report_version:error=INTERNAL@1")
    try:
        assert client.get_task().task_id == 1  # two injected failures, then through
        assert sleeps == list(retry.expected_backoff_schedule("get_task", policy, 2, "1"))
        with pytest.raises(retry.RpcError, match="INTERNAL"):
            client.report_version(3)  # not transient: no retry
        assert client.retry_stats.give_ups == 0 and client.retry_stats.retries == 2
    finally:
        faults.clear()
        client.close()
        server.stop()


def test_best_effort_report_swallows_an_outage():
    port = _free_port()
    client = MasterClient(f"127.0.0.1:{port}", worker_id=0, retry_policy=FAST)
    assert client.report_task_result_best_effort(5, "", {"batch_count": 1}) is False
    client.close()
