"""The client's job API: the port of ``elasticdl_tpu/client/api.py``
(``train``/``evaluate``/``predict`` :24-36, ``_run_job`` :39,
``_run_local`` :58, ``save_model`` :113).

The Local strategy runs the master (``master/main.start_master``, its
HTTP server) and one ``worker.worker.Worker`` in this process, the
worker talking to the master over localhost; at the end of a training
job the model is saved to ``--output``.  The process journals (into
``--checkpoint_dir``'s ``events.jsonl`` when one is given) the master's
and the worker's events and, at the end, ``local_job_exit`` with the
steps trained, the seconds and the forbidden modules it loaded (none).  ``AllreduceStrategy`` and
``ParameterServerStrategy`` hand over to ``master/job_runner``, which
starts the worker processes.  Jobs run on the card unless ``--device
cpu`` is given; without a card they refuse to start.  ``--image_name``
with a cluster strategy submits the job to Kubernetes instead
(``client/submit.py``): the client creates the master pod and returns.
"""

from __future__ import annotations

import json
import time

import numpy as np

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common.args import format_dict_params, parse_master_args
from elasticdl_tpu_torch.common.constants import DistributionStrategy, Mode
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.model_utils import load_model_spec

logger = get_logger("client.api")


def train(argv) -> int:
    return _run_job(parse_master_args(argv), Mode.TRAINING)


def evaluate(argv) -> int:
    return _run_job(parse_master_args(argv), Mode.EVALUATION)


def predict(argv) -> int:
    return _run_job(parse_master_args(argv), Mode.PREDICTION)


def _run_job(args, mode: str) -> int:
    if args.image_name and args.distribution_strategy != DistributionStrategy.LOCAL:
        # ``--image_name`` means "run on Kubernetes": create the master
        # pod and return; the cluster runs the job.
        from elasticdl_tpu_torch.client.submit import submit_job

        return submit_job(args, mode)
    resolve_device(args.device)  # no card: refuse before anything starts
    if args.distribution_strategy == DistributionStrategy.LOCAL:
        return _run_local(args, mode)
    from elasticdl_tpu_torch.master.job_runner import run_allreduce_job, run_ps_job

    if args.distribution_strategy == DistributionStrategy.ALLREDUCE:
        return run_allreduce_job(args, mode)
    if args.distribution_strategy == DistributionStrategy.PARAMETER_SERVER:
        return run_ps_job(args, mode)
    raise ValueError(f"Unknown strategy {args.distribution_strategy}")


def _run_local(args, mode: str) -> int:
    """The master and one worker in this process."""
    from elasticdl_tpu_torch.common.boundary import forbidden_modules_loaded
    from elasticdl_tpu_torch.data.pipeline import PipelineConfig
    from elasticdl_tpu_torch.data.reader import build_data_reader
    from elasticdl_tpu_torch.master.main import start_master
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.worker import Worker

    started = time.monotonic()
    model_spec = load_model_spec(args)
    master = start_master(args, model_spec=model_spec)
    if mode == Mode.EVALUATION:  # an evaluation-only job: one round, now
        if master.evaluation_service is not None:
            master.evaluation_service.trigger_evaluation(model_version=0)
        else:
            master.task_manager.create_evaluation_tasks(model_version=0)
    data_path = {
        Mode.TRAINING: args.training_data,
        Mode.EVALUATION: args.validation_data,
        Mode.PREDICTION: args.prediction_data,
    }[mode]
    data_reader = build_data_reader(args, model_spec, data_path)
    validation_reader = (build_data_reader(args, model_spec, args.validation_data)
                         if args.validation_data and mode == Mode.TRAINING else None)
    client = MasterClient(master.addr, worker_id=0)
    worker = None
    try:
        worker = Worker(
            master_client=client,
            model_spec=model_spec,
            data_reader=data_reader,
            minibatch_size=args.minibatch_size,
            validation_data_reader=validation_reader,
            pipeline=PipelineConfig.from_args(args),
            device=args.device,
        )
        worker.run()
        if mode == Mode.TRAINING and args.output:
            save_model(worker.trainer, args.output, args)
        if master.evaluation_service is not None:
            master.evaluation_service.finalize()
            metrics = master.evaluation_service.latest_metrics
            if metrics:
                logger.info("Final metrics: %s", metrics)
        return 0
    finally:
        client.close()
        master.stop()
        summary = {"seconds": round(time.monotonic() - started, 3),
                   "steps": worker.process_steps if worker is not None else 0,
                   "eval_batches": worker.process_eval_batches if worker is not None else 0,
                   "forbidden_modules": forbidden_modules_loaded()}
        logger.info("local job exit: %s", json.dumps(summary, sort_keys=True))
        obs.journal().record("local_job_exit", **summary)


def save_model(trainer, output_path: str, args=None) -> None:
    """The trained model as a servable artifact directory
    (``serving/export.export_model``), recording the resolved model
    params (the job flags ``model_utils`` forwards included), so serving
    rebuilds the same model; a path ending in ``.npz`` gets the flat
    variables instead."""
    if trainer.state is None:
        logger.warning("No variables to save (model never initialized)")
        return
    if output_path.endswith(".npz"):
        variables = trainer.get_variables_numpy()
        np.savez(output_path, **variables)
        logger.info("Saved %d variables to %s", len(variables), output_path)
        return
    from elasticdl_tpu_torch.serving.export import export_model

    model_params = getattr(args, "model_params", "")
    if args is not None and getattr(args, "model_def", ""):
        model_params = format_dict_params(load_model_spec(args).model_params)
    export_model(trainer, output_path, model_zoo=getattr(args, "model_zoo", ""),
                 model_def=getattr(args, "model_def", ""), model_params=model_params)
