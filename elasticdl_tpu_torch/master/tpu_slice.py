"""TPU pod-slice topology for worker pod rendering: the port's copy of
``elasticdl_tpu/master/tpu_slice.py``, kept as it is so ``--tpu_slice``
renders the manifests the JAX package renders.

In the TPU deployment model one framework worker is one TPU VM host of a
pod slice, so on Kubernetes:

- each worker pod requests the host's chips through the
  ``google.com/tpu`` extended resource (the GKE TPU device plugin's
  name);
- node selectors pin the pod to nodes of the right accelerator type and
  slice topology (``cloud.google.com/gke-tpu-accelerator`` and
  ``cloud.google.com/gke-tpu-topology``);
- ``--num_workers`` must equal the slice's host count: a pod slice is
  all-or-nothing (validated at submit time, ``client/submit.py``).

Only rendering and validation live here; scheduling is the cluster's
job.  The catalog covers the v5e (v5 lite) family; entries are
(accelerator label, topology label, hosts, chips per host).  A GPU
worker needs no catalog: it requests ``nvidia.com/gpu`` through
``--worker_resource_request`` (for one card a worker,
``--worker_resource_request=nvidia.com/gpu=1``), the generic resource
dict of ``k8s_client.render_pod``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class SliceSpec:
    name: str
    accelerator: str      # cloud.google.com/gke-tpu-accelerator value
    topology: str         # cloud.google.com/gke-tpu-topology value
    hosts: int            # worker pods required (one per TPU VM host)
    chips_per_host: int   # google.com/tpu request per pod


_V5E = "tpu-v5-lite-podslice"

TPU_SLICES: Dict[str, SliceSpec] = {
    spec.name: spec
    for spec in (
        # Single-host shapes (chips_per_host < 4 exist but the 4-chip
        # host is the scheduling unit GKE exposes for podslices).
        SliceSpec("v5e-4", _V5E, "2x2", 1, 4),
        SliceSpec("v5e-8", _V5E, "2x4", 2, 4),
        SliceSpec("v5e-16", _V5E, "4x4", 4, 4),
        SliceSpec("v5e-32", _V5E, "4x8", 8, 4),
        SliceSpec("v5e-64", _V5E, "8x8", 16, 4),
        SliceSpec("v5e-128", _V5E, "8x16", 32, 4),
        SliceSpec("v5e-256", _V5E, "16x16", 64, 4),
    )
}


def slice_spec(name: str) -> SliceSpec:
    try:
        return TPU_SLICES[name]
    except KeyError:
        raise ValueError(
            f"Unknown TPU slice {name!r}; known shapes: "
            f"{', '.join(sorted(TPU_SLICES))}"
        ) from None


def worker_pod_overlay(spec: SliceSpec) -> Dict[str, Dict[str, str]]:
    """What a worker pod of this slice adds to its manifest: the chip
    resource request and the node selectors."""
    return {
        "resources": {"google.com/tpu": str(spec.chips_per_host)},
        "node_selector": {
            "cloud.google.com/gke-tpu-accelerator": spec.accelerator,
            "cloud.google.com/gke-tpu-topology": spec.topology,
        },
    }


def validate_worker_count(spec: SliceSpec, num_workers: int) -> None:
    if num_workers != spec.hosts:
        raise ValueError(
            f"TPU slice {spec.name} has {spec.hosts} host(s); "
            f"--num_workers={num_workers} must match (one worker per "
            "TPU VM host — a pod slice schedules all-or-nothing)"
        )
