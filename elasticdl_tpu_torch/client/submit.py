"""Cluster job submission, render and create the master pod: the port's
copy of ``elasticdl_tpu/client/submit.py``.

``elasticdl train --image_name=... --distribution_strategy=...`` (the
port's ``python -m elasticdl_tpu_torch.client.main``) submits a master
pod to the cluster; the master pod then creates and supervises the
worker pods (``master/k8s_pod_manager.py``).  The client's job ends at
submission.  A GPU worker asks for its card with
``--worker_resource_request=nvidia.com/gpu=1``.
"""

from __future__ import annotations

from elasticdl_tpu_torch.common.args import args_to_argv
from elasticdl_tpu_torch.common.constants import JobType, Mode
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.master.k8s_client import (
    K8sClient,
    K8sConfig,
    parse_resource_spec,
    parse_volume_spec,
    render_pod,
)

logger = get_logger("client.submit")


def validate_cluster_args(args, mode: str):
    """Pre-flight checks at submission time: anything that would make the
    master pod die on arrival (restartPolicy=Never, no second chance)
    fails here, in the operator's terminal."""
    parse_resource_spec(args.master_resource_request)
    parse_resource_spec(args.worker_resource_request)
    parse_volume_spec(args.volume)
    if getattr(args, "tpu_slice", ""):
        from elasticdl_tpu_torch.master.tpu_slice import (
            slice_spec,
            validate_worker_count,
        )

        # Unknown shape or a worker count that can't tile the slice
        # must fail in the operator's terminal, not strand a half-
        # scheduled pod slice.
        validate_worker_count(slice_spec(args.tpu_slice), args.num_workers)
        if args.need_elasticity:
            # Elastic shrink/grow changes the world size; a pod slice is
            # all-or-nothing (num_workers == hosts, forever) — a 3-host
            # world on a 4-host slice can't initialize its TPUs.  Reject
            # here rather than hang in-cluster after a preemption.
            raise ValueError(
                "--tpu_slice is incompatible with --need_elasticity: a "
                "TPU pod slice schedules all-or-nothing, so the worker "
                "count cannot shrink or grow. Run the slice at fixed "
                "size (restart-the-world recovery still replaces failed "
                "workers 1:1 within the restart budget)."
            )
    if (
        mode == Mode.TRAINING
        and args.need_elasticity
        and not args.checkpoint_dir
    ):
        # Mirrors job_runner._ensure_elastic_checkpointing's in-cluster
        # refusal: a master-pod-local default dir is invisible to workers.
        raise ValueError(
            "Elastic training on Kubernetes requires --checkpoint_dir on "
            "storage every pod shares — mount it with --volume "
            '(e.g. --volume "claim_name=ckpt-pvc,mount_path=/ckpt" '
            "--checkpoint_dir /ckpt/myjob)."
        )

# Client-side / derived flags that must not round-trip into the master pod
# command line.
_NO_FORWARD = {
    "master_addr",  # the master *is* the addressee
    "image_name",  # becomes the pod image (also forwarded: workers need it)
    "job_type",  # derived from mode below
}


def job_type_for(args, mode: str) -> str:
    if mode == Mode.EVALUATION:
        return JobType.EVALUATION_ONLY
    if mode == Mode.PREDICTION:
        return JobType.PREDICTION_ONLY
    return (
        JobType.TRAINING_WITH_EVALUATION
        if getattr(args, "validation_data", "")
        else JobType.TRAINING_ONLY
    )


def render_master_pod(args, mode: str) -> dict:
    keys = {k for k in vars(args) if k not in _NO_FORWARD}
    command = [
        "python",
        "-m",
        "elasticdl_tpu_torch.master.main",
        f"--job_type={job_type_for(args, mode)}",
        f"--image_name={args.image_name}",
        *args_to_argv(args, keys=keys),
    ]
    return render_pod(
        job_name=args.job_name,
        replica_type="master",
        index=0,
        image=args.image_name,
        command=command,
        namespace=args.namespace,
        resources=parse_resource_spec(args.master_resource_request) or None,
        priority_class=args.worker_pod_priority,
        volume_spec=args.volume,
    )


def submit_job(args, mode: str, k8s_client: K8sClient = None) -> int:
    """Create the master pod and return; the cluster runs the job."""
    validate_cluster_args(args, mode)
    client = k8s_client or K8sClient(K8sConfig.resolve(args.namespace))
    manifest = render_master_pod(args, mode)
    created = client.create_pod(manifest)
    name = created["metadata"]["name"]
    logger.info(
        "Submitted job %s: master pod %s in namespace %s",
        args.job_name,
        name,
        client.namespace,
    )
    print(f"Job {args.job_name} submitted (master pod {name})")
    return 0
