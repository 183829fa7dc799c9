"""The ``elasticdl`` command line: the port of
``elasticdl_tpu/client/main.py``.

    python -m elasticdl_tpu_torch.client.main train --distribution_strategy=Local \
        --model_zoo=model_zoo --model_def=mnist.mnist_functional_api \
        --training_data=synthetic://mnist?n=4096 --output=<dir> [--device cpu]

``train``, ``evaluate`` and ``predict`` run a job (``client/api.py``);
``zoo`` (``init|build|push``) manages a user's model zoo
(``client/zoo.py``).
"""

from __future__ import annotations

import sys

USAGE = (
    "Usage: python -m elasticdl_tpu_torch.client.main <command> [flags]\n"
    "Commands:\n"
    "  train      Run a training job\n"
    "  evaluate   Run an evaluation job\n"
    "  predict    Run a prediction job\n"
    "  zoo        Manage a model zoo (init/build/push)\n"
)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    command, rest = argv[0], argv[1:]
    if command in ("train", "evaluate", "predict"):
        from elasticdl_tpu_torch.client import api

        return getattr(api, command)(rest)
    if command == "zoo":
        from elasticdl_tpu_torch.client import zoo

        return zoo.main(rest)
    print(f"Unknown command: {command!r}", file=sys.stderr)
    print(USAGE, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
