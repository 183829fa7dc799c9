"""``python -m elasticdl_tpu_torch.master.main`` with the policy engine's
post-rescale cooldown cut short, for ``tests/test_torch_allreduce_job.py``.

    python tests/torch_allreduce_master.py <master flags>

The engine holds every scale decision for ``max(min_cooldown_s,
cooldown_factor x the last rescale's cost)`` after a rescale: 30 s and
4x by default, longer than a CPU test job lasts.  No flag sets them (as
in the JAX package), so this wraps ``PolicyConfig.from_args`` to set
``min_cooldown_s`` to 1 s and ``cooldown_factor`` to 0.25, the way the
JAX package's ``tests/test_chaos.py`` hands its master a ``PolicyConfig``.
Everything else is the master's own ``main``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from elasticdl_tpu_torch.master import main, policy  # noqa: E402

_from_args = policy.PolicyConfig.from_args.__func__


def _short_cooldown(cls, args):
    config = _from_args(cls, args)
    config.min_cooldown_s = 1.0
    config.cooldown_factor = 0.25
    return config


policy.PolicyConfig.from_args = classmethod(_short_cooldown)

if __name__ == "__main__":
    sys.exit(main.main(sys.argv[1:]))
