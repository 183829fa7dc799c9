"""The master's service: the port's copy of
``elasticdl_tpu/master/servicer.py`` (``MasterServicer`` :31, the seven
methods of the proto's ``Master`` service) over HTTP
(``common/http_rpc.py``) in place of gRPC.

``get_task`` and ``report_task_result`` drive the ``TaskManager``;
``get_comm_rank`` and ``report_worker_liveness`` the
``ElasticRendezvous`` (a world of one without one); ``report_version``
folds the workers' model versions with max and lets the
``EvaluationService`` queue a round that is due;
``report_evaluation_metrics`` hands a chunk of evaluation outputs to it
(a job without one drops them); ``get_shard_checkpoint`` returns the
task-progress JSON.  A heartbeat's ``telemetry_json`` goes to the
``TelemetryAggregator`` (``obs/telemetry.py``), which never raises.
"""

from __future__ import annotations

from elasticdl_tpu_torch.common import messages as msg
from elasticdl_tpu_torch.common.http_rpc import JsonRpcServer
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("master.servicer")


class MasterServicer:
    def __init__(self, task_manager, rendezvous_server=None, evaluation_service=None,
                 telemetry=None):
        self._task_manager = task_manager
        self._telemetry = telemetry
        self._evaluation_service = evaluation_service
        self._rendezvous_server = rendezvous_server
        self._model_version = 0
        self._zero_task_warned: set = set()

    @property
    def model_version(self) -> int:
        return self._model_version

    def get_task(self, request: msg.GetTaskRequest) -> msg.GetTaskResponse:
        return msg.GetTaskResponse(task=self._task_manager.get(request.worker_id))

    def report_task_result(self, request: msg.ReportTaskResultRequest
                           ) -> msg.ReportTaskResultResponse:
        success = not request.err_message
        self._task_manager.report(request.task_id, success, worker_id=request.worker_id,
                                  exec_counters=dict(request.exec_counters))
        if not success:
            logger.warning("Worker %d failed task %d: %s", request.worker_id,
                           request.task_id, request.err_message)
        return msg.ReportTaskResultResponse()

    def report_evaluation_metrics(self, request: msg.ReportEvaluationMetricsRequest
                                  ) -> msg.ReportEvaluationMetricsResponse:
        if self._evaluation_service is not None:
            if not request.task_id and request.model_version not in self._zero_task_warned:
                # Chunks join their round when their task completes, and
                # task ids start at 1: a report without one would stage
                # rows that nothing ever promotes.
                self._zero_task_warned.add(request.model_version)
                logger.warning("report_evaluation_metrics for version %d arrived without a "
                               "task_id (worker/master protocol mismatch?); its rows will not "
                               "join the round's metrics", request.model_version)
            self._evaluation_service.report_evaluation_metrics(
                request.model_version, list(request.model_outputs), list(request.labels),
                task_id=request.task_id)
        return msg.ReportEvaluationMetricsResponse()

    def report_version(self, request: msg.ReportVersionRequest) -> msg.ReportVersionResponse:
        self._model_version = max(self._model_version, request.model_version)
        if self._evaluation_service is not None:
            self._evaluation_service.add_evaluation_task_if_needed(self._model_version)
        return msg.ReportVersionResponse()

    def get_comm_rank(self, request: msg.GetCommRankRequest) -> msg.GetCommRankResponse:
        if self._rendezvous_server is None:
            return msg.GetCommRankResponse(rank_id=0, world_size=1, rendezvous_id=0)
        return self._rendezvous_server.get_comm_rank(request.worker_id, request.host)

    def report_worker_liveness(self, request: msg.ReportWorkerLivenessRequest
                               ) -> msg.ReportWorkerLivenessResponse:
        should_reset = False
        if self._rendezvous_server is not None:
            should_reset = self._rendezvous_server.report_liveness(
                request.worker_id, request.host, request.rendezvous_id)
        if self._telemetry is not None and request.telemetry_json:
            self._telemetry.ingest(request.worker_id, request.telemetry_json)
        return msg.ReportWorkerLivenessResponse(should_reset=should_reset)

    def get_shard_checkpoint(self, request) -> msg.ShardCheckpointResponse:
        return msg.ShardCheckpointResponse(content=self._task_manager.to_checkpoint())


def start_master_server(servicer: MasterServicer, port: int = 0):
    """Serve ``servicer`` over HTTP on ``port`` (0 picks a free one);
    returns ``(server, port)``."""
    server = JsonRpcServer(servicer, port=port, name="master")
    bound = server.start()
    logger.info("Master HTTP server listening on port %d", bound)
    return server, bound
