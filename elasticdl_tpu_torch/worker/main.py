"""The worker process: the port's copy of ``elasticdl_tpu/worker/main.py``
(``main`` :30, ``_build_collective_worker`` :151).

    python -m elasticdl_tpu_torch.worker.main --worker_id N --master_addr host:port \
        --distribution_strategy ParameterServerStrategy --model_def ... [--device cpu]

The pod manager launches one per worker id (``master/pod_manager.py``).
With ``--distribution_strategy=Local`` it runs the Local ``Worker``
(``worker/worker.py``, JAX ``:117-146``) against a bare master
(``python -m elasticdl_tpu_torch.master.main``, the Local strategy):
one process, no world, the single-device ``Trainer``.  Otherwise it
joins the world (``parallel/elastic.join_world``), builds the trainer
(``ShardedEmbeddingTrainer`` for ParameterServerStrategy,
``DataParallelTrainer`` for AllreduceStrategy) and the saver
(``ShardedCheckpointSaver`` for PS, ``CheckpointSaver`` for DP), restores
the latest checkpoint and runs the task loop
(``worker/collective_worker.py``).  At job end with ``--output`` every
rank runs the export (``serving/export.export_model``; a table gather
over a process mesh, rank 0 writes).  SIGTERM becomes ``SystemExit``, so
``finally`` blocks run.

With ``--validation_data`` / ``--prediction_data`` it builds their
readers for evaluation and prediction tasks.  A worker that reads record
files logs once which ETRF codec serves it (``data/recordfile.codec``:
the native host codec or the Python one) and journals it in
``data_readers``.

A collective worker builds a ``WorkerTelemetry`` with a ``StepAnatomy``
bound to it (``obs/telemetry.py``, ``obs/stepstats.py``): step times,
task progress, RPC retries and the step's phase split ride its
heartbeats to the master.  The Local worker gets the anatomy alone and
journals it per task (no heartbeat there).

The worker journals into ``<dir>/events_worker_<id>.jsonl``, where
``<dir>`` is ``--tensorboard_log_dir`` or else ``--checkpoint_dir`` (the
master's journal is ``events.jsonl`` there); at exit it logs one line,
``worker exit: {...}``, with the process's kernel launch counts, the
steps it trained and the forbidden modules it loaded (none).  Its spans
name the process ``worker_<id>`` (``obs/tracing.set_process``), and the
flight recorder flushes its open spans at exit.  ``--profile_steps``
runs a ``common/profiler.StepProfiler`` over the task loop, writing
under ``<tensorboard_log_dir>/profile/worker_<id>/``.
``--quality_drift_bins`` > 0 (forwarded by the master) enables the
process's train-side drift sketch (``obs/quality.enable_train_sketch``),
which the Local worker's train batches feed.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

from elasticdl_tpu_torch import obs
from elasticdl_tpu_torch.common.args import parse_worker_args
from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("worker.main")


def _sigterm_to_systemexit(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    started = time.monotonic()
    try:
        signal.signal(signal.SIGTERM, _sigterm_to_systemexit)
    except ValueError:
        pass  # not the main thread (an in-process harness)
    from elasticdl_tpu_torch.common import faults

    if faults.install_from_env():
        logger.warning("Fault injection armed from %s=%r", faults.ENV_VAR,
                       os.environ.get(faults.ENV_VAR))
    args = parse_worker_args(argv)
    from elasticdl_tpu_torch.obs import tracing

    tracing.set_process(f"worker_{args.worker_id}")
    tracing.install_flight_recorder()
    journal_dir = args.tensorboard_log_dir or args.checkpoint_dir
    if journal_dir:
        obs.init_journal(journal_dir, filename=f"events_worker_{args.worker_id}.jsonl")
    if args.oov_diagnostics:
        from elasticdl_tpu_torch.parallel import packed

        packed.set_oov_debug(True)
    if args.quality_drift_bins > 0:
        # Train-side skew sketch (obs/quality.py): every train batch's
        # integer feature ids fold into a process-local DriftMonitor
        # (host-side numpy, O(bins) memory).
        from elasticdl_tpu_torch.obs import quality

        quality.enable_train_sketch(quality.DriftMonitor(
            threshold=args.quality_drift_threshold, bins=args.quality_drift_bins,
            origin=f"worker_{args.worker_id}"))
    obs.journal().record("worker_start", worker_id=args.worker_id, pid=os.getpid(),
                         device=args.device)
    from elasticdl_tpu_torch.common.model_utils import load_model_spec
    from elasticdl_tpu_torch.data.reader import build_data_reader
    from elasticdl_tpu_torch.common.boundary import forbidden_modules_loaded
    from elasticdl_tpu_torch.worker.collective_worker import kernel_launches
    from elasticdl_tpu_torch.worker.master_client import MasterClient

    model_spec = load_model_spec(args)
    data_reader = build_data_reader(args, model_spec, args.training_data)
    validation_reader = (build_data_reader(args, model_spec, args.validation_data)
                         if args.validation_data else None)
    prediction_reader = (build_data_reader(args, model_spec, args.prediction_data)
                         if args.prediction_data else None)
    _note_readers(data_reader, validation_reader, prediction_reader)
    client = MasterClient(args.master_addr, worker_id=args.worker_id)
    worker = None
    try:
        if args.distribution_strategy == "Local":
            from elasticdl_tpu_torch.data.pipeline import PipelineConfig
            from elasticdl_tpu_torch.worker.worker import Worker

            worker = Worker(master_client=client, model_spec=model_spec,
                            data_reader=data_reader, minibatch_size=args.minibatch_size,
                            validation_data_reader=validation_reader,
                            prediction_data_reader=prediction_reader,
                            anatomy=_anatomy(args), profiler=_profiler(args),
                            pipeline=PipelineConfig.from_args(args), device=args.device)
        else:
            worker = _build_collective_worker(args, model_spec, data_reader, client,
                                              validation_reader, prediction_reader)
        worker.run()
        if args.output and "training" in args.job_type:
            from elasticdl_tpu_torch.serving.export import export_model
            from elasticdl_tpu_torch.common.args import format_dict_params

            start = time.monotonic()
            export_model(worker.trainer, args.output, model_zoo=args.model_zoo,
                         model_def=args.model_def,
                         model_params=format_dict_params(model_spec.model_params))
            obs.journal().record("model_exported", worker_id=args.worker_id, path=args.output,
                                 step=worker.trainer.step,
                                 seconds=round(time.monotonic() - start, 6))
        return 0
    finally:
        client.close()
        summary = {
            "worker_id": args.worker_id,
            "seconds": round(time.monotonic() - started, 3),
            "steps": worker.process_steps if worker is not None else 0,
            "kernel_launches": kernel_launches(),
            "forbidden_modules": forbidden_modules_loaded(),
        }
        logger.info("worker exit: %s", json.dumps(summary, sort_keys=True))
        obs.journal().record("worker_exit", **summary)


def _note_readers(*readers) -> None:
    """Log and journal the readers and, when one reads record files, the
    ETRF codec that serves them (built at first use)."""
    from elasticdl_tpu_torch.data import recordfile
    from elasticdl_tpu_torch.data.reader import FixedWidthEtrfReader, RecordIODataReader

    names = [type(r).__name__ if r is not None else None for r in readers]
    files = any(isinstance(r, (FixedWidthEtrfReader, RecordIODataReader)) for r in readers)
    codec = recordfile.codec() if files else None
    if files:
        logger.info("Record codec: %s", codec)
    obs.journal().record("data_readers", training=names[0], validation=names[1],
                         prediction=names[2], record_codec=codec)


def _profiler(args):
    from elasticdl_tpu_torch.common.profiler import StepProfiler

    return StepProfiler(args.tensorboard_log_dir, args.profile_steps, args.worker_id,
                        device=args.device)


def _anatomy(args):
    """The step anatomy, its FLOPs row inferred from the model's path."""
    from elasticdl_tpu_torch.obs.stepstats import StepAnatomy

    anatomy = StepAnatomy(args.worker_id)
    anatomy.set_model(args.model_def or args.model_zoo)
    return anatomy


def _build_collective_worker(args, model_spec, data_reader, client, validation_reader=None,
                             prediction_reader=None):
    """Join the world, build the trainer over its mesh, restore state."""
    from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
    from elasticdl_tpu_torch.checkpoint.sharded import ShardedCheckpointSaver
    from elasticdl_tpu_torch.common.device import resolve_device
    from elasticdl_tpu_torch.data.pipeline import PipelineConfig
    from elasticdl_tpu_torch.ops import sparse_embedding as ske
    from elasticdl_tpu_torch.parallel.elastic import join_world
    from elasticdl_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from elasticdl_tpu_torch.worker.collective_worker import CollectiveWorker

    from elasticdl_tpu_torch.obs.telemetry import WorkerTelemetry

    device = resolve_device(args.device)  # the card raises here when there is none
    world = join_world(client, device=device.type)
    telemetry = WorkerTelemetry(args.worker_id)
    telemetry.bind_retry_stats(client.retry_stats)
    telemetry.set_rendezvous(world.rendezvous_id)
    telemetry.bind_anatomy(_anatomy(args))
    # A world of one trains on one device with no mesh; a larger one over
    # the process mesh of the joined group.
    mesh = build_mesh(MeshConfig(model=args.mesh_model_axis)) if world.world_size > 1 else None
    if mesh is None and args.mesh_model_axis > 1:
        raise ValueError(f"--mesh_model_axis={args.mesh_model_axis} needs a world of at least "
                         f"{args.mesh_model_axis} workers (one rank per card)")
    ske.set_dispatch_mesh(mesh)
    if args.distribution_strategy == "ParameterServerStrategy":
        from elasticdl_tpu_torch.parallel.ps_trainer import ShardedEmbeddingTrainer

        trainer = ShardedEmbeddingTrainer(
            model=model_spec.build_model(mesh=mesh, device=device),
            loss_fn=model_spec.loss,
            optimizer=model_spec.optimizer(),
            embedding_optimizer=(model_spec.embedding_optimizer()
                                 if model_spec.embedding_optimizer is not None else None),
            sparse_apply_every=args.sparse_apply_every,
            sparse_kernel=args.sparse_kernel,
            mesh=mesh,
            device=None if mesh is not None else device,
        )
    else:
        from elasticdl_tpu_torch.parallel.dp_trainer import DataParallelTrainer

        trainer = DataParallelTrainer(
            model=model_spec.build_model(mesh=mesh, device=device),
            loss_fn=model_spec.loss,
            optimizer=model_spec.optimizer(),
            mesh=mesh,
            dense_sharding=args.dense_sharding,
            device=None if mesh is not None else device,
        )
    saver = None
    if args.checkpoint_dir:
        if args.distribution_strategy == "ParameterServerStrategy" \
                or args.dense_sharding == "fsdp":
            # Mesh-sharded state (the PS tables, FSDP's dense leaves): each
            # process writes and reads its own rows (JAX worker/main.py:239-246).
            saver = ShardedCheckpointSaver(args.checkpoint_dir, keep_max=args.keep_checkpoint_max)
        else:
            saver = CheckpointSaver(args.checkpoint_dir, keep_max=args.keep_checkpoint_max)
    return CollectiveWorker(
        master_client=client,
        model_spec=model_spec,
        data_reader=data_reader,
        minibatch_size=args.minibatch_size,
        world=world,
        trainer=trainer,
        checkpoint_saver=saver,
        checkpoint_steps=args.checkpoint_steps,
        train_window_steps=args.train_window_steps,
        pipeline=PipelineConfig.from_args(args),
        validation_data_reader=validation_reader,
        prediction_data_reader=prediction_reader,
        telemetry=telemetry,
        profiler=_profiler(args),
    )


if __name__ == "__main__":
    sys.exit(main())
