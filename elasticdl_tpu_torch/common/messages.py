"""The master's wire messages: the port's counterparts of the control-plane
messages of ``elasticdl_tpu/proto/elasticdl.proto`` (:19-171), as
dataclasses that travel as JSON.

Field names, defaults (proto3's: 0, "", empty) and enum numbers are the
proto's.  ``TaskType``: TRAINING 0, EVALUATION 1, PREDICTION 2, WAIT 3
(no task now; poll again), TRAIN_END_CALLBACK 4.  A task whose
``task_id`` is -1 is no task: with ``type == WAIT`` the job goes on,
otherwise it is complete.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List

TRAINING = 0
EVALUATION = 1
PREDICTION = 2
WAIT = 3
TRAIN_END_CALLBACK = 4

_TASK_TYPE_NAMES = {
    TRAINING: "TRAINING",
    EVALUATION: "EVALUATION",
    PREDICTION: "PREDICTION",
    WAIT: "WAIT",
    TRAIN_END_CALLBACK: "TRAIN_END_CALLBACK",
}


def task_type_name(task_type: int) -> str:
    """``TaskType.Name``; raises ``ValueError`` on an unknown number."""
    try:
        return _TASK_TYPE_NAMES[task_type]
    except KeyError:
        raise ValueError(f"unknown TaskType {task_type}") from None


@dataclass
class Task:
    task_id: int = 0
    shard_name: str = ""
    start: int = 0
    end: int = 0
    type: int = TRAINING
    model_version: int = 0
    epoch: int = 0
    trace_id: str = ""


@dataclass
class GetTaskRequest:
    worker_id: int = 0
    task_type: int = TRAINING


@dataclass
class GetTaskResponse:
    task: Task = field(default_factory=Task)


@dataclass
class ReportTaskResultRequest:
    task_id: int = 0
    err_message: str = ""
    worker_id: int = 0
    exec_counters: Dict[str, int] = field(default_factory=dict)


@dataclass
class ReportTaskResultResponse:
    pass


@dataclass
class ReportVersionRequest:
    model_version: int = 0
    worker_id: int = 0


@dataclass
class ReportVersionResponse:
    pass


@dataclass
class GetCommRankRequest:
    worker_id: int = 0
    host: str = ""


@dataclass
class GetCommRankResponse:
    rank_id: int = 0
    world_size: int = 0
    rendezvous_id: int = 0
    coordinator_addr: str = ""
    worker_hosts: List[str] = field(default_factory=list)


@dataclass
class ReportWorkerLivenessRequest:
    worker_id: int = 0
    host: str = ""
    rendezvous_id: int = 0
    telemetry_json: str = ""


@dataclass
class ReportWorkerLivenessResponse:
    should_reset: bool = False


@dataclass
class ShardCheckpointRequest:
    pass


@dataclass
class ShardCheckpointResponse:
    content: str = ""


@dataclass
class Tensor:
    """The proto's ``Tensor`` for JSON: ``dims`` and ``name`` as there,
    ``dtype`` a numpy dtype string (``"<f4"``) in place of the enum, and
    ``content`` the little-endian bytes in base64
    (``common/tensor_utils.py`` converts)."""

    name: str = ""
    dims: List[int] = field(default_factory=list)
    dtype: str = ""
    content: str = ""


@dataclass
class ReportEvaluationMetricsRequest:
    """A chunk of an evaluation task's outputs and labels (the JAX
    package's chunked reports: several per task, joined by ``task_id``)."""

    model_outputs: List[Tensor] = field(default_factory=list)
    labels: List[Tensor] = field(default_factory=list)
    worker_id: int = 0
    model_version: int = 0
    task_id: int = 0


@dataclass
class ReportEvaluationMetricsResponse:
    pass


#: method -> (request type, response type): the proto's ``Master`` service.
METHODS = {
    "get_task": (GetTaskRequest, GetTaskResponse),
    "report_task_result": (ReportTaskResultRequest, ReportTaskResultResponse),
    "report_evaluation_metrics": (ReportEvaluationMetricsRequest,
                                  ReportEvaluationMetricsResponse),
    "report_version": (ReportVersionRequest, ReportVersionResponse),
    "get_comm_rank": (GetCommRankRequest, GetCommRankResponse),
    "report_worker_liveness": (ReportWorkerLivenessRequest, ReportWorkerLivenessResponse),
    "get_shard_checkpoint": (ShardCheckpointRequest, ShardCheckpointResponse),
}


def to_json(message) -> dict:
    return dataclasses.asdict(message)


def from_json(cls, obj: dict):
    """A message of ``cls`` from its JSON object; a field the object lacks
    keeps its default, an unknown field raises ``TypeError``."""
    obj = dict(obj)
    if cls is GetTaskResponse and isinstance(obj.get("task"), dict):
        obj["task"] = Task(**obj["task"])
    if cls is ReportEvaluationMetricsRequest:
        for key in ("model_outputs", "labels"):
            obj[key] = [Tensor(**t) for t in obj.get(key, [])]
    return cls(**obj)
