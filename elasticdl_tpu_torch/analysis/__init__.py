"""Machine-checked invariants of the port's control plane: the port's
counterpart of ``elasticdl_tpu/analysis/``.

It holds the runtime lock-order checker (``analysis/runtime.py``), armed
by ``ELASTICDL_LOCKCHECK=1``: the services create their locks through
its ``make_lock``.  The static analyzer over the port waits for
ROADMAP.md Queue 1 item 8.

This ``__init__`` imports nothing, as the JAX package's exports its
analyzer's names lazily: a service that imports ``make_lock`` must never
load an analyzer, and a broken analyzer must never stop a master from
starting.
"""
