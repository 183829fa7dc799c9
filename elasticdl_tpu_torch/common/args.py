"""The flag system of the master and worker processes: the port's copy of
``elasticdl_tpu/common/args.py``.

Flat argparse with one parser assembly per role sharing flag groups; the
master forwards a worker's flags through ``args_to_argv``.  Every JAX
flag is kept with its name and default, plus ``--device`` (``cuda``, the
card, unless ``cpu`` is given, as ``serving/replica_main.py`` has it).

``--policy_enabled`` and the ``--policy_*`` numbers select the
goodput-driven policy engine (``master/policy.py``,
``PolicyConfig.from_args``).  The observability
flags select their planes: ``--tensorboard_log_dir`` the TensorBoard
scalars and the journal's directory, ``--profile_steps`` the
``torch.profiler`` window (``common/profiler.py``), ``--slo_enabled``
(on by default) and ``--slo_goodput_target`` the master's SLO plane,
``--quality_drift_bins`` > 0 the train-side drift sketch
(``obs/quality.enable_train_sketch``, at ``--quality_drift_threshold``) of
the workers: unlike JAX, whose worker parser lacks them, both flags are
the worker's too, and the master forwards them.
``--jax_compilation_cache_dir`` is accepted and selects nothing.  ``--sparse_kernel`` selects the sparse
optimizer's engine (``parallel/ps_trainer.resolve_sparse_kernel``).
``--image_name`` submits the job to a Kubernetes cluster
(``client/submit.py``), whose master runs the workers as pods
(``master/k8s_pod_manager.py``); ``--devices_per_worker`` is accepted and
selects nothing, as in the JAX package.
"""

from __future__ import annotations

import argparse
import logging

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("common.args")


def pos_int(value):
    ivalue = int(value)
    if ivalue <= 0:
        raise argparse.ArgumentTypeError(f"{value} must be a positive integer")
    return ivalue


def non_neg_int(value):
    ivalue = int(value)
    if ivalue < 0:
        raise argparse.ArgumentTypeError(f"{value} must be >= 0")
    return ivalue


def pos_int_or_auto(value):
    if value == "auto":
        return value
    return pos_int(value)


def str2bool(value):
    if isinstance(value, bool):
        return value
    if value.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if value.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Cannot parse bool from {value!r}")


def add_common_arguments(parser: argparse.ArgumentParser):
    parser.add_argument("--job_name", default="elasticdl-job", help="Job name")
    parser.add_argument(
        "--distribution_strategy", default="Local",
        choices=["Local", "ParameterServerStrategy", "AllreduceStrategy"],
        help="Local (the master and one worker in the client's process, "
        "client.main train|evaluate|predict), ParameterServerStrategy (sharded "
        "embedding tables, K2/K3 on the card) or AllreduceStrategy (dense "
        "gradients summed over the world)",
    )
    parser.add_argument("--log_level", default="INFO")
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the workers train: the CUDA card (the default; no card "
        "raises) or the CPU, where the kernels' plain versions run and a "
        "world of several workers joins over gloo",
    )


def add_model_zoo_arguments(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--model_zoo", required=True,
        help="Accepted and never imported: model_def resolves through the "
        "port's zoo (elasticdl_tpu_torch.zoo.REGISTRY)",
    )
    parser.add_argument("--model_def", required=True,
                        help="e.g. deepfm.deepfm_functional_api")
    parser.add_argument("--model_params", default="",
                        help="Comma-separated key=value pairs passed to custom_model()")
    parser.add_argument("--dataset_fn", default="dataset_fn")
    parser.add_argument("--loss", default="loss")
    parser.add_argument("--optimizer", default="optimizer")
    parser.add_argument("--eval_metrics_fn", default="eval_metrics_fn")
    parser.add_argument("--custom_data_reader", default="custom_data_reader")
    parser.add_argument("--callbacks", default="callbacks")


def add_data_arguments(parser: argparse.ArgumentParser):
    parser.add_argument("--training_data", default="", help="Training data path/pattern")
    parser.add_argument("--validation_data", default="", help="Validation data path")
    parser.add_argument("--prediction_data", default="", help="Prediction data path")
    parser.add_argument("--records_per_task", type=pos_int, default=4096)
    parser.add_argument("--minibatch_size", type=pos_int, default=64)
    parser.add_argument("--num_epochs", type=pos_int, default=1)
    parser.add_argument("--data_reader_params", default="",
                        help="Comma-separated key=value pairs passed to the data reader")


def add_train_arguments(parser: argparse.ArgumentParser):
    parser.add_argument("--evaluation_steps", type=non_neg_int, default=0)
    parser.add_argument("--checkpoint_steps", type=non_neg_int, default=0)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--keep_checkpoint_max", type=non_neg_int, default=3)
    parser.add_argument("--output", default="", help="Trained model output path")
    parser.add_argument("--tensorboard_log_dir", default="")
    parser.add_argument("--dense_sharding", default="replicated",
                        choices=["replicated", "fsdp"])
    parser.add_argument(
        "--train_window_steps", type=non_neg_int, default=0,
        help="Training batches staged per dispatch. 0 = AUTO: up to 400, "
        "bounded by the task's batch count and a 1 GiB staged-bytes cap",
    )
    parser.add_argument(
        "--sparse_apply_every", type=pos_int_or_auto, default="auto",
        help="ParameterServerStrategy only: one sparse apply per N steps "
        "(1 = strict); 'auto' is strict up to 10M table rows, 32 above",
    )
    parser.add_argument("--sparse_kernel", default="auto", choices=["xla", "fused", "auto"])
    parser.add_argument(
        "--pipeline", default="sync", choices=["sync", "async"],
        help="'async' parses and stacks batches on a background thread "
        "(and a parse pool, --parse_pool_workers) while the step loop "
        "trains; the variables are those of 'sync'",
    )
    parser.add_argument("--parse_pool_workers", type=non_neg_int, default=0)
    parser.add_argument("--pipeline_inflight", type=pos_int, default=2)
    parser.add_argument("--dispatch_depth", type=pos_int, default=2)
    parser.add_argument(
        "--oov_diagnostics", type=str2bool, nargs="?", const=True, default=False,
        help="Log per-step counts of embedding ids >= vocab_size (host-side)",
    )
    parser.add_argument("--profile_steps", default="")
    parser.add_argument("--mesh_model_axis", type=pos_int, default=1)
    parser.add_argument("--task_timeout_s", type=non_neg_int, default=900)
    parser.add_argument("--jax_compilation_cache_dir", default="",
                        help="Accepted; selects nothing (the port compiles no XLA)")
    parser.add_argument("--use_bf16", type=str2bool, nargs="?", const=True, default=True)


def add_cluster_arguments(parser: argparse.ArgumentParser):
    parser.add_argument("--num_workers", type=pos_int, default=1)
    parser.add_argument("--master_addr", default="", help="host:port of the master")
    parser.add_argument("--master_port", type=non_neg_int, default=0,
                        help="0 picks a free port")
    parser.add_argument("--worker_pod_priority", default="")
    parser.add_argument("--metrics_port", type=non_neg_int, default=None,
                        help="Serve /metrics, /healthz, /debug/vars from the master")
    parser.add_argument("--max_worker_restarts", type=non_neg_int, default=3)
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--image_name", default="")
    parser.add_argument("--need_elasticity", type=str2bool, nargs="?", const=True,
                        default=True)
    parser.add_argument("--policy_enabled", type=str2bool, nargs="?", const=True,
                        default=True)
    parser.add_argument("--policy_amortize_horizon_s", type=float, default=600.0)
    parser.add_argument("--policy_tick_interval_s", type=float, default=2.0)
    parser.add_argument("--policy_min_workers", type=pos_int, default=1)
    parser.add_argument("--policy_evict_after", type=pos_int, default=3)
    parser.add_argument("--policy_kill_budget", type=non_neg_int, default=1)
    parser.add_argument("--policy_kill_budget_window_s", type=float, default=600.0)
    parser.add_argument("--slo_enabled", type=str2bool, nargs="?", const=True, default=True)
    parser.add_argument("--slo_goodput_target", type=float, default=0.0)
    parser.add_argument("--slo_compliance_window_s", type=float, default=3600.0)
    parser.add_argument("--slo_tick_interval_s", type=float, default=2.0)
    parser.add_argument(
        "--worker_liveness_timeout_s", type=non_neg_int, default=60,
        help="Kill and relaunch a worker whose heartbeat is silent this long (0 disables)",
    )
    parser.add_argument("--devices_per_worker", type=pos_int, default=1)
    parser.add_argument("--master_resource_request", default="")
    parser.add_argument("--worker_resource_request", default="")
    parser.add_argument("--tpu_slice", default="")
    parser.add_argument("--volume", default="")


def add_quality_arguments(parser: argparse.ArgumentParser):
    """The train-side drift sketch's flags: on the master, which forwards
    them, and on the worker, which enables the sketch."""
    parser.add_argument("--quality_drift_bins", type=non_neg_int, default=0)
    parser.add_argument("--quality_drift_threshold", type=float, default=0.25)


def build_master_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="elasticdl_tpu_torch master",
                                     allow_abbrev=False)
    add_common_arguments(parser)
    add_model_zoo_arguments(parser)
    add_data_arguments(parser)
    add_train_arguments(parser)
    add_cluster_arguments(parser)
    add_quality_arguments(parser)
    parser.add_argument("--job_type", default="training_with_evaluation")
    return parser


def build_worker_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="elasticdl_tpu_torch worker",
                                     allow_abbrev=False)
    add_common_arguments(parser)
    add_model_zoo_arguments(parser)
    add_data_arguments(parser)
    add_train_arguments(parser)
    add_quality_arguments(parser)
    parser.add_argument("--worker_id", type=non_neg_int, required=True)
    parser.add_argument("--master_addr", required=True)
    parser.add_argument("--job_type", default="training_with_evaluation")
    return parser


def _apply_log_level(args):
    logging.getLogger("elasticdl_tpu_torch").setLevel(args.log_level)


def parse_master_args(argv=None):
    args, _unknown = build_master_parser().parse_known_args(argv)
    _apply_log_level(args)
    return args


def parse_worker_args(argv=None):
    args, _unknown = build_worker_parser().parse_known_args(argv)
    _apply_log_level(args)
    return args


def format_dict_params(params: dict) -> str:
    """Inverse of ``parse_dict_params``: ``{'a': 1, 'b': True}`` ->
    ``'a=1,b=true'``, sorted; records the resolved model params (job flags
    included) in a served artifact."""
    def fmt(value):
        if isinstance(value, bool):
            return "true" if value else "false"
        return str(value)

    for key, value in params.items():
        if isinstance(value, str) and "," in value:
            raise ValueError(
                f"model param {key}={value!r} cannot round-trip through the k=v,k=v format"
            )
    return ",".join(f"{k}={fmt(v)}" for k, v in sorted(params.items()))


def args_to_argv(args: argparse.Namespace, keys=None) -> list:
    """A namespace back into ``--flag value`` argv (master -> workers)."""
    argv = []
    for key, value in sorted(vars(args).items()):
        if keys is not None and key not in keys:
            continue
        if value is None or value == "":
            continue
        argv.extend([f"--{key}", str(value)])
    return argv
