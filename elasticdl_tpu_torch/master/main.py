"""The master process: the port's copy of ``elasticdl_tpu/master/main.py``
(``Master`` :30, ``build_master`` :72, ``start_master`` :240, ``main``
:303).

    python -m elasticdl_tpu_torch.master.main --distribution_strategy=ParameterServerStrategy \
        --num_workers=1 --model_zoo=model_zoo --model_def=deepfm.deepfm_functional_api \
        --model_params="vocab_size=1000000" --sparse_apply_every=1 \
        --training_data="synthetic://criteo?n=196608&vocab=1000000" --minibatch_size=8192 \
        --records_per_task=32768 --checkpoint_dir=<dir> --checkpoint_steps=12 \
        --output=<dir> [--device cpu]

builds the task queue from the training data's shards (or resumes a
``task_progress.json`` left in ``--checkpoint_dir`` by a master of either
package), serves the master's methods over HTTP, and runs the job
(``master/job_runner.py``): the rendezvous, the worker processes and
their supervision.  With ``--validation_data`` and the zoo's
``eval_metrics_fn`` the ``EvaluationService`` queues evaluation rounds
every ``--evaluation_steps`` model versions (at each epoch's end when 0)
and once the training tasks are done; ``--job_type`` ``evaluation_only``
runs one round at version 0 over the workers' restored model, and
``prediction_only`` the ``--prediction_data`` tasks.  The journal is
``<checkpoint_dir>/events.jsonl``; a master that finds one there seeds
its goodput ledger from it (``obs/goodput.py``), so the goodput ratio
keeps the job's lifetime across master restarts.  Telemetry on the
workers' heartbeats lands in a ``TelemetryAggregator`` scoped to the
current world (``obs/telemetry.py``).  The job trains on the card unless
``--device cpu`` is given, and the master refuses to start when there is
no card, except as a master pod (``--image_name`` inside a Kubernetes
cluster, ``client/submit.py``): its workers are pods that request their
own cards.  With ``--distribution_strategy=Local`` (the default) it starts
a bare master and serves until it is terminated, for a worker started by
hand (``python -m elasticdl_tpu_torch.worker.main
--distribution_strategy=Local``); ``python -m
elasticdl_tpu_torch.client.main train`` runs the master and its worker
together.

Observability as in JAX (``master/main.py:163-204,240-300``): the journal
lives in ``--tensorboard_log_dir`` when given, else in
``--checkpoint_dir``; with ``--tensorboard_log_dir`` a
``TensorBoardService`` (``master/tensorboard_service.py``) writes the
evaluation rounds and the sampled training progress as scalars; with
``--metrics_port`` the exporter serves ``/metrics``, ``/journal``,
``/slo`` and ``/debug/vars`` and writes its port to ``<journal
dir>/metrics_port``.  The master names itself ``master`` on the
assembled trace and installs the tracing plane's flight recorder.
"""

from __future__ import annotations

import os
import signal
import sys
from dataclasses import dataclass
from typing import Optional

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common.args import parse_master_args
from elasticdl_tpu_torch.common.constants import DistributionStrategy
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_utils import load_model_spec
from elasticdl_tpu_torch.data.reader import build_data_reader
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer, start_master_server
from elasticdl_tpu_torch.master.task_manager import TaskManager, TaskProgressPersister
from elasticdl_tpu_torch.obs import goodput
from elasticdl_tpu_torch.obs.telemetry import TelemetryAggregator

logger = get_logger("master.main")


@dataclass
class Master:
    args: object
    model_spec: object
    task_manager: TaskManager
    evaluation_service: Optional[EvaluationService]
    servicer: MasterServicer
    server: object = None
    port: int = 0
    rendezvous_server: object = None
    data_reader: object = None
    progress_persister: object = None
    metrics_exporter: object = None
    telemetry: object = None
    tensorboard_service: object = None

    @property
    def addr(self) -> str:
        return f"localhost:{self.port}"

    def stop(self):
        if self.metrics_exporter is not None:
            try:
                self.metrics_exporter.stop()
            except Exception:
                logger.exception("Metrics exporter stop failed")
            self.metrics_exporter = None
        if self.tensorboard_service is not None:
            try:
                self.tensorboard_service.close()
            except Exception:
                logger.exception("TensorBoard close failed")
            self.tensorboard_service = None
        if self.progress_persister is not None:
            try:
                self.progress_persister.stop()
            except Exception:
                logger.exception("Final task-progress persist failed")
            self.progress_persister = None
        if self.server is not None:
            self.server.stop()
            self.server = None


def build_master(args, model_spec=None, rendezvous_server=None) -> Master:
    journal_dir = _journal_dir(args)
    if journal_dir:
        from elasticdl_tpu_torch.obs.journal import DEFAULT_FILENAME

        resumed = os.path.exists(os.path.join(journal_dir, DEFAULT_FILENAME))
        journal_path = obs.init_journal(journal_dir)
        logger.info("Event journal -> %s", journal_path)
        if resumed:
            # A predecessor's timeline: the ratio keeps job-lifetime meaning.
            goodput.ledger().seed_from_journal(journal_path)
    model_spec = model_spec or load_model_spec(args)

    training_reader = None
    training_shards = {}
    if args.training_data:
        training_reader = build_data_reader(args, model_spec, args.training_data)
        training_shards = training_reader.create_shards()
        if not training_shards:
            raise ValueError(f"--training_data={args.training_data!r} produced no shards")
    evaluation_shards = {}
    if args.validation_data:
        evaluation_shards = build_data_reader(args, model_spec,
                                              args.validation_data).create_shards()
    prediction_shards = {}
    if args.prediction_data:
        prediction_shards = build_data_reader(args, model_spec,
                                              args.prediction_data).create_shards()

    # A predecessor's shard-progress snapshot wins over fresh task
    # creation (cluster strategies only), so a restarted master continues
    # the epoch.
    task_manager = None
    progress_path = (TaskProgressPersister.progress_path(args.checkpoint_dir)
                     if getattr(args, "checkpoint_dir", "")
                     and args.distribution_strategy != DistributionStrategy.LOCAL else "")
    if progress_path and os.path.exists(progress_path):
        try:
            with open(progress_path) as f:
                task_manager = TaskManager.from_checkpoint(f.read(),
                                                           task_timeout_s=args.task_timeout_s)
            counts = task_manager.counts()
            logger.info("Resumed task progress from %s (epoch %d, %d tasks todo, %d records "
                        "finished)", progress_path, counts["epoch"], counts["todo"],
                        task_manager.finished_record_count)
        except Exception:
            logger.exception("Unreadable task-progress snapshot %s; starting fresh",
                             progress_path)
            task_manager = None
    if task_manager is None:
        task_manager = TaskManager(training_shards=training_shards,
                                   evaluation_shards=evaluation_shards,
                                   prediction_shards=prediction_shards,
                                   records_per_task=args.records_per_task,
                                   num_epochs=args.num_epochs,
                                   task_timeout_s=args.task_timeout_s)
    tensorboard_service = None
    if getattr(args, "tensorboard_log_dir", ""):
        from elasticdl_tpu_torch.master.tensorboard_service import TensorBoardService

        tensorboard_service = TensorBoardService(args.tensorboard_log_dir,
                                                 task_manager=task_manager)
    evaluation_service = None
    if model_spec.eval_metrics_fn is not None and evaluation_shards:
        evaluation_service = EvaluationService(task_manager,
                                               eval_metrics_fn=model_spec.eval_metrics_fn,
                                               evaluation_steps=args.evaluation_steps,
                                               tensorboard_service=tensorboard_service)
    # Scoped to the current world: reports from a torn-down world neither
    # skew the aggregates nor read as stale forever.
    telemetry = TelemetryAggregator(
        current_workers_fn=((lambda: [wid for wid, _h in rendezvous_server.world()])
                            if rendezvous_server is not None else None))
    servicer = MasterServicer(task_manager=task_manager, evaluation_service=evaluation_service,
                              rendezvous_server=rendezvous_server, telemetry=telemetry)
    if tensorboard_service is not None:
        tensorboard_service.bind(model_version_fn=lambda: servicer.model_version)
        tensorboard_service.start()
    if evaluation_service is not None and training_shards:
        # A final round when the training tasks are done; at each epoch's
        # end too when no step interval is set.
        task_manager.add_tasks_done_callback(
            lambda: evaluation_service.trigger_evaluation(servicer.model_version))
        if args.evaluation_steps <= 0:
            task_manager.add_epoch_done_callback(
                lambda epoch: evaluation_service.trigger_evaluation(servicer.model_version))
    if model_spec.callbacks is not None and training_shards:
        # Queue the TRAIN_END_CALLBACK task so the zoo's callbacks run.
        task_manager.add_tasks_done_callback(task_manager.create_train_end_task)
    progress_persister = None
    if progress_path:
        progress_persister = TaskProgressPersister(task_manager, args.checkpoint_dir).start()
    return Master(args=args, model_spec=model_spec, task_manager=task_manager,
                  evaluation_service=evaluation_service, servicer=servicer,
                  rendezvous_server=rendezvous_server, data_reader=training_reader,
                  progress_persister=progress_persister, telemetry=telemetry,
                  tensorboard_service=tensorboard_service)


def _journal_dir(args) -> str:
    """The journal sits beside the TensorBoard events, else in the
    checkpoint dir."""
    return getattr(args, "tensorboard_log_dir", "") or getattr(args, "checkpoint_dir", "")


def start_master(args, model_spec=None, rendezvous_server=None) -> Master:
    from elasticdl_tpu_torch.obs import tracing

    tracing.set_process("master")
    tracing.install_flight_recorder()
    master = build_master(args, model_spec, rendezvous_server)
    master.server, master.port = start_master_server(master.servicer, port=args.master_port)
    if getattr(args, "metrics_port", None) is not None:
        from elasticdl_tpu_torch.obs.exporter import MetricsExporter

        try:
            master.metrics_exporter = MetricsExporter(port=args.metrics_port).start()
        except OSError:
            # Observability never takes the control plane down.
            logger.exception("Metrics exporter could not bind port %d; continuing without "
                             "/metrics", args.metrics_port)
        if master.metrics_exporter is not None and _journal_dir(args):
            # --metrics_port 0 binds an ephemeral port: scrapers read it here.
            master.metrics_exporter.write_port_file(_journal_dir(args))
    obs.journal().record(
        "master_start", job_name=args.job_name, port=master.port, pid=os.getpid(),
        metrics_port=master.metrics_exporter.port if master.metrics_exporter else None)
    # Phase accounting starts idle, until a dispatch or a world opens one.
    goodput.ledger().transition("idle", cause="master_start")
    return master


def main(argv=None) -> int:
    """``python -m elasticdl_tpu_torch.master.main``: runs a cluster job
    (the control plane and the worker fleet) to its end, or, with the
    Local strategy, serves a bare master until SIGTERM."""
    from elasticdl_tpu_torch.common import faults

    if faults.install_from_env():
        logger.warning("Fault injection armed from %s=%r", faults.ENV_VAR,
                       os.environ.get(faults.ENV_VAR))
    args = parse_master_args(argv)
    if args.distribution_strategy == DistributionStrategy.LOCAL:
        _refuse_without_card(args)
        return _serve_local_master(args)
    from elasticdl_tpu_torch.master.job_runner import (
        _running_on_k8s,
        run_allreduce_job,
        run_ps_job,
    )

    if not _running_on_k8s(args):
        # A master pod needs no card: its worker pods request theirs.
        _refuse_without_card(args)

    runner = (run_ps_job if args.distribution_strategy == DistributionStrategy.PARAMETER_SERVER
              else run_allreduce_job)
    return runner(args, mode_from_job_type(args.job_type))


def _refuse_without_card(args) -> None:
    if args.device != "cpu":
        from elasticdl_tpu_torch.common.device import resolve_device

        resolve_device(args.device)  # no card: refuse before any worker starts


def _serve_local_master(args) -> int:
    def terminate(signum, frame):
        raise SystemExit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, terminate)
    except ValueError:
        pass  # not the main thread (an in-process harness)
    master = start_master(args)
    logger.info("Master running on port %d", master.port)
    logger.warning("Master started standalone in Local mode; use `python -m "
                   "elasticdl_tpu_torch.client.main train` to run master and worker together.")
    try:
        master.server.wait_for_termination()
    finally:
        master.stop()
    return 0


def mode_from_job_type(job_type: str) -> str:
    from elasticdl_tpu_torch.common.constants import JobType, Mode

    return {
        JobType.TRAINING_ONLY: Mode.TRAINING,
        JobType.TRAINING_WITH_EVALUATION: Mode.TRAINING,
        JobType.EVALUATION_ONLY: Mode.EVALUATION,
        JobType.PREDICTION_ONLY: Mode.PREDICTION,
    }[job_type]


if __name__ == "__main__":
    sys.exit(main())
