"""The worker's client of the master: the port's copy of
``elasticdl_tpu/worker/master_client.py`` (``MasterClient`` :52) over
HTTP (``common/http_rpc.py``).

Every call carries an explicit deadline; the idempotent ones retry
transient failures (a refused or reset connection, a lapsed deadline, a
503) with the JAX package's policy, so a worker rides through a master
restart on the same port.  Idempotency per call, as in JAX:

- ``get_task``: retried; a popped but unacknowledged task is recovered by
  the master's timeout and churn paths (at-least-once).
- ``get_comm_rank``, ``report_worker_liveness``, ``get_shard_checkpoint``:
  retried; reads and latest-wins liveness.
- ``report_version``: retried; the master folds it with max().
- ``report_task_result``: NOT retried; a duplicate failure report would
  charge the task's retry budget twice.
- ``report_evaluation_metrics``: NOT retried, with its own deadline
  (``RPC.EVAL_REPORT_DEADLINE_S``): a duplicate chunk would count its
  rows twice.

Tracing (``obs/tracing.py``): ``get_task`` mints its span id before the
call and sends it as the ``elasticdl-span-id`` header, so the master's
``rpc.get_task`` span parents under it, and journals ``worker.get_task``
once the answer names the trace (WAIT polls journal nothing); a traced
``report_task_result`` runs in a ``worker.report_task`` span whose ids
ride the headers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np

from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.common.constants import RPC
from elasticdl_tpu_torch.common.http_rpc import JsonRpcClient, trace_metadata
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.retry import (
    IDEMPOTENT_POLICY,
    NON_IDEMPOTENT_POLICY,
    RetryPolicy,
)
from elasticdl_tpu_torch.common.tensor_utils import ndarray_to_tensor
from elasticdl_tpu_torch.obs import tracing

logger = get_logger("worker.master_client")


class MasterClient:
    def __init__(
        self,
        addr: str,
        worker_id: int,
        retry_policy: Optional[RetryPolicy] = None,
        no_retry_policy: Optional[RetryPolicy] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        # Per-worker jitter salt: deterministic per worker, decorrelated
        # across the fleet.
        self._client = JsonRpcClient(addr, sleep=sleep, seed=str(worker_id))
        self._worker_id = worker_id
        self._retry_policy = retry_policy or IDEMPOTENT_POLICY
        self._no_retry_policy = no_retry_policy or NON_IDEMPOTENT_POLICY

    @property
    def worker_id(self) -> int:
        return self._worker_id

    @property
    def retry_stats(self):
        """How often this worker had to retry (``common/retry.RetryStats``)."""
        return self._client.stats

    def get_task(self, task_type: int = msg.TRAINING) -> msg.Task:
        request = msg.GetTaskRequest(worker_id=self._worker_id, task_type=task_type)
        span_id = tracing.tracer().mint_span_id()
        start_ts = time.time()
        start = time.monotonic()
        task = self._client.call("get_task", request, self._retry_policy,
                                 metadata=trace_metadata("", span_id=span_id)).task
        if task.trace_id:
            # The root's span id is the trace id: the client parents under
            # it without having seen the root.
            tracing.tracer().record_span(
                "worker.get_task", start_ts=start_ts, duration_s=time.monotonic() - start,
                trace_id=task.trace_id, parent_id=task.trace_id, span_id=span_id,
                worker_id=self._worker_id)
        return task

    def report_task_result(self, task_id: int, err_message: str = "",
                           exec_counters: Optional[Dict[str, int]] = None, trace_id: str = ""):
        """``trace_id`` (the dispatch-minted ``Task.trace_id``) rides the
        trace header back to the master."""
        request = msg.ReportTaskResultRequest(
            task_id=task_id, err_message=err_message, worker_id=self._worker_id,
            exec_counters={k: int(v) for k, v in (exec_counters or {}).items()})
        if not trace_id:
            self._client.call("report_task_result", request, self._no_retry_policy)
            return
        # Under the task root (worker.task has closed by now); the span's
        # id rides the headers, so rpc.report_task_result nests under it.
        with tracing.tracer().span("worker.report_task", trace_id=trace_id, parent_id=trace_id,
                                   worker_id=self._worker_id, task_id=task_id) as report_span:
            self._client.call("report_task_result", request, self._no_retry_policy,
                              metadata=trace_metadata(trace_id, span_id=report_span.span_id))

    def report_task_result_best_effort(self, task_id: int, err_message: str = "",
                                       exec_counters: Optional[Dict[str, int]] = None,
                                       trace_id: str = "") -> bool:
        """A result report whose loss is data, not an error: the master
        requeues an unreported task.  True when delivered."""
        try:
            self.report_task_result(task_id, err_message, exec_counters, trace_id=trace_id)
            return True
        except Exception:
            logger.warning("Could not report task %d %s (master unreachable?); the master "
                           "will requeue the task (at-least-once)", task_id,
                           "failure" if err_message else "success")
            return False

    def report_evaluation_metrics(self, model_version: int, model_outputs, labels,
                                  task_id: int = 0):
        """``model_outputs`` is ``{name: array}``; ``labels`` an array or a
        ``{name: array}`` dict.  ``task_id`` joins the chunk to its
        EVALUATION task."""
        if not isinstance(labels, dict):
            labels = {"": np.asarray(labels)}
        request = msg.ReportEvaluationMetricsRequest(
            model_outputs=[ndarray_to_tensor(a, name) for name, a in model_outputs.items()],
            labels=[ndarray_to_tensor(a, name) for name, a in labels.items()],
            worker_id=self._worker_id, model_version=model_version, task_id=task_id)
        no_retry_policy = self._no_retry_policy
        if no_retry_policy.timeout_s != RPC.EVAL_REPORT_DEADLINE_S:
            no_retry_policy = dataclasses.replace(no_retry_policy,
                                                  timeout_s=RPC.EVAL_REPORT_DEADLINE_S)
        self._client.call("report_evaluation_metrics", request, no_retry_policy)

    def report_version(self, model_version: int):
        self._client.call("report_version", msg.ReportVersionRequest(
            model_version=model_version, worker_id=self._worker_id), self._retry_policy)

    def get_comm_rank(self, host: str = "") -> msg.GetCommRankResponse:
        return self._client.call("get_comm_rank", msg.GetCommRankRequest(
            worker_id=self._worker_id, host=host), self._retry_policy)

    def report_worker_liveness(self, host: str, rendezvous_id: int,
                               telemetry_json: str = "") -> bool:
        response = self._client.call("report_worker_liveness", msg.ReportWorkerLivenessRequest(
            worker_id=self._worker_id, host=host, rendezvous_id=rendezvous_id,
            telemetry_json=telemetry_json), self._retry_policy)
        return response.should_reset

    def get_shard_checkpoint(self) -> str:
        return self._client.call("get_shard_checkpoint", msg.ShardCheckpointRequest(),
                                 self._retry_policy).content

    def close(self):
        self._client.close()
