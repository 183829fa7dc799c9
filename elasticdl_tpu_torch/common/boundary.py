"""What no process of the port may load: the JAX package's stack (JAX,
flax, optax), its transport (gRPC, protobuf), the JAX package itself and
its model zoo.  The card's machine has none of them.  The master, the
workers and the serving replica record ``forbidden_modules_loaded()`` in
their journals, and the tests hold it empty."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "grpc", "google.protobuf",
                     "model_zoo", "elasticdl_tpu")


def forbidden_modules_loaded() -> List[str]:
    """The forbidden modules this process has loaded (whole dotted names:
    ``elasticdl_tpu_torch`` is not ``elasticdl_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if any(m == f or m.startswith(f + ".") for f in FORBIDDEN_MODULES))
