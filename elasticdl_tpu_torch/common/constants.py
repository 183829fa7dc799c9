"""Framework-wide constants: the port's copy of
``elasticdl_tpu/common/constants.py``, names and values unchanged.

``GRPC`` keeps its numbers for the record; the port's master-worker
transport is HTTP (``master/servicer.py``), whose client retries with
``RPC``'s budget.
"""


class DistributionStrategy:
    LOCAL = "Local"
    PARAMETER_SERVER = "ParameterServerStrategy"
    ALLREDUCE = "AllreduceStrategy"


class JobType:
    TRAINING_ONLY = "training_only"
    EVALUATION_ONLY = "evaluation_only"
    PREDICTION_ONLY = "prediction_only"
    TRAINING_WITH_EVALUATION = "training_with_evaluation"


class TaskExecCounterKey:
    BATCH_COUNT = "batch_count"
    RECORD_COUNT = "record_count"
    # Out-of-vocabulary lookups seen by the task's train steps (PS mode):
    # one per (id, table) pair, so DeepFM's split layout counts an OOV id
    # once per table.
    OOV_LOOKUP_COUNT = "oov_lookup_count"


class GRPC:
    MAX_SEND_MESSAGE_LENGTH = 256 * 1024 * 1024
    MAX_RECEIVE_MESSAGE_LENGTH = 256 * 1024 * 1024
    KEEPALIVE_TIME_MS = 30000
    KEEPALIVE_TIMEOUT_MS = 10000
    INITIAL_RECONNECT_BACKOFF_MS = 200
    MIN_RECONNECT_BACKOFF_MS = 200
    MAX_RECONNECT_BACKOFF_MS = 2000


class RPC:
    # Every client call carries an explicit deadline; idempotent calls
    # retry transient failures with capped exponential backoff, a budget
    # sized to ride through a master restart.
    DEADLINE_S = 30.0
    EVAL_REPORT_DEADLINE_S = 120.0
    MAX_ATTEMPTS = 24
    BASE_BACKOFF_S = 0.1
    MAX_BACKOFF_S = 2.0
    JITTER = 0.25
    TOTAL_BUDGET_S = 120.0


class WorkerEnv:
    MASTER_ADDR = "ELASTICDL_MASTER_ADDR"
    WORKER_ID = "ELASTICDL_WORKER_ID"
    WORKER_NUM = "ELASTICDL_WORKER_NUM"


class DefaultTimeouts:
    # Seconds a task may sit in `doing` before the master recovers it
    # (0 disables).
    TASK_TIMEOUT = 0
    WORKER_HEARTBEAT_INTERVAL = 5
    WORKER_LIVENESS_TIMEOUT = 30


class Mode:
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
