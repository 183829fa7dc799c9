"""``elasticdl zoo`` subcommands: the port of ``elasticdl_tpu/client/zoo.py``.

- ``init`` scaffolds a model directory with the port's zoo contract: a
  torch ``nn.Module`` with ``init_parameters(generator)``,
  ``custom_model(..., device=None)``, ``loss``, ``optimizer``,
  ``dataset_fn`` and ``eval_metrics_fn`` (``zoo/mnist.py`` has the same
  shape).  ``common/model_utils.load_model_spec`` loads it with
  ``--model_zoo <dir> --model_def my_model``.
- ``build`` renders a Dockerfile (base image + this package + the model
  zoo) into a build context and runs ``docker build`` when a docker CLI
  exists; with ``--dockerfile-only`` (or no docker binary) it stops
  after rendering, so the context is still there for an external image
  build (kaniko, buildah, CI).  The context vendors ``elasticdl_tpu_torch/``
  with its kernel sources (``ops/csrc/*.cu``, ``native/*.cc``), which
  build at first use, and without caches or built libraries.
- ``push`` shells out to ``docker push``.

The flags and exit codes are JAX's.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

_TEMPLATE = '''"""Model-zoo module scaffold (elasticdl_tpu_torch contract)."""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.parallel import optim
from elasticdl_tpu_torch.zoo import vision
from elasticdl_tpu_torch.zoo.transformer_lm import Dense


class Model(nn.Module):
    """Dense(64), ReLU, Dense(2), with flax's layer names and initialisers."""

    def __init__(self, input_dim: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(input_dim, 64, torch.float32, device)
        self.Dense_1 = Dense(64, 2, torch.float32, device)

    def forward(self, x, train: bool = False):
        if isinstance(x, dict):  # a serving request: {"features": [n, input_dim]}
            x = x["features"]
        x = F.relu(self.Dense_0(x.to(torch.float32)))
        return self.Dense_1(x)

    def init_parameters(self, generator: torch.Generator) -> None:
        vision.init_parameters(self, generator)


def custom_model(input_dim: int = 4, device=None):
    """The model on ``device`` (None: the CUDA card).  Its input width is
    a model parameter (``--model_params "input_dim=N"``)."""
    return Model(input_dim, device=resolve_device(device))


def loss(labels, predictions):
    return vision.softmax_cross_entropy(labels, predictions)


def optimizer(lr=0.1):
    return optim.sgd(lr)


def dataset_fn(dataset, mode, metadata):
    def parse(record):
        features, label = record
        return np.asarray(features, np.float32), np.int32(label)

    return dataset.map(parse)


def eval_metrics_fn():
    return {
        "accuracy": lambda outputs, labels: np.mean(
            np.argmax(outputs, axis=1) == labels.astype(np.int64)
        )
    }
'''

_DOCKERFILE = """\
# Rendered by `elasticdl zoo build` — job image for elasticdl_tpu_torch.
# Master and worker pods run this image (client/submit.py renders the
# pod specs; the commands are `python -m elasticdl_tpu_torch.master.main` /
# `python -m elasticdl_tpu_torch.worker.main`).  The kernels build from
# the vendored sources at first use (nvcc for ops/csrc, g++ for native).
FROM {base_image}

WORKDIR /elasticdl
# The framework itself (vendored into the build context by `zoo build`).
COPY elasticdl_tpu_torch/ /elasticdl/elasticdl_tpu_torch/
# The user's model zoo.
COPY {zoo_name}/ /elasticdl/{zoo_name}/
ENV PYTHONPATH=/elasticdl
{extra_commands}
"""

#: What the vendored package leaves out: caches and the kernels' build
#: outputs (``ops/_build/``, ``native/_build/``), rebuilt in the image.
_FRAMEWORK_IGNORE = ("__pycache__", "*.pyc", "*.so", "_build")


def render_dockerfile(base_image: str, zoo_name: str, extra_commands: str = "") -> str:
    return _DOCKERFILE.format(base_image=base_image, zoo_name=zoo_name,
                              extra_commands=extra_commands)


def prepare_build_context(zoo_path: str, context_dir: str, base_image: str) -> str:
    """Assemble a self-contained docker build context: this package, the
    model zoo and a rendered Dockerfile.  Returns the Dockerfile path."""
    import elasticdl_tpu_torch

    zoo_path = os.path.abspath(zoo_path)
    if not os.path.isdir(zoo_path):
        raise ValueError(f"Model zoo directory not found: {zoo_path}")
    zoo_name = os.path.basename(os.path.normpath(zoo_path))

    framework_src = os.path.dirname(os.path.abspath(elasticdl_tpu_torch.__file__))
    # Fresh copies: a merged context would keep files deleted from the
    # zoo or the package since the last build and bake them into the image.
    framework_dst = os.path.join(context_dir, "elasticdl_tpu_torch")
    zoo_dst = os.path.join(context_dir, zoo_name)
    for src, dst in ((framework_src, framework_dst), (zoo_path, zoo_dst)):
        # Never delete or recurse into a source: `--context .` from the
        # repo root makes dst == src (rmtree would wipe the user's code),
        # a context nested in a source makes copytree copy the
        # destination into itself, and a source inside dst would be
        # deleted by rmtree(dst).
        real_src, real_dst = os.path.realpath(src), os.path.realpath(dst)
        common = os.path.commonpath([real_dst, real_src])
        if real_dst == real_src or common in (real_src, real_dst):
            raise ValueError(
                f"Build context {context_dir!r} would overwrite or nest "
                f"with the source directory {src!r}; choose a --context "
                "outside the source trees"
            )
    os.makedirs(context_dir, exist_ok=True)  # after validation: no strays
    shutil.rmtree(framework_dst, ignore_errors=True)
    shutil.rmtree(zoo_dst, ignore_errors=True)
    shutil.copytree(framework_src, framework_dst,
                    ignore=shutil.ignore_patterns(*_FRAMEWORK_IGNORE))
    shutil.copytree(zoo_path, zoo_dst, ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    dockerfile = os.path.join(context_dir, "Dockerfile")
    with open(dockerfile, "w") as f:
        f.write(render_dockerfile(base_image, zoo_name))
    return dockerfile


def build(args) -> int:
    context_dir = args.context or os.path.join(
        os.path.dirname(os.path.abspath(args.path)) or ".", ".elasticdl_build")
    dockerfile = prepare_build_context(args.path, context_dir, args.base_image)
    print(f"Build context ready: {context_dir} (Dockerfile: {dockerfile})")
    if args.dockerfile_only:
        return 0
    docker = shutil.which("docker")
    if docker is None:
        print(
            "No docker CLI found; the rendered build context is ready for "
            "an external image build (kaniko/buildah/CI):\n"
            f"  docker build -t <image> {context_dir}",
            file=sys.stderr,
        )
        return 0 if args.allow_no_docker else 1
    image = args.image or "elasticdl:latest"
    result = subprocess.run([docker, "build", "-t", image, context_dir], check=False)
    if result.returncode == 0:
        print(f"Built image {image}")
    return result.returncode


def push(args) -> int:
    docker = shutil.which("docker")
    if docker is None:
        print("No docker CLI found; cannot push.", file=sys.stderr)
        return 1
    return subprocess.run([docker, "push", args.image], check=False).returncode


def init(path: str) -> int:
    os.makedirs(path, exist_ok=True)
    for name, content in (("__init__.py", ""), ("my_model.py", _TEMPLATE)):
        target = os.path.join(path, name)
        if not os.path.exists(target):
            with open(target, "w") as f:
                f.write(content)
    print(f"Initialized model zoo at {path}")
    return 0


def main(argv) -> int:
    parser = argparse.ArgumentParser(prog="elasticdl zoo")
    sub = parser.add_subparsers(dest="action", required=True)
    init_parser = sub.add_parser("init", help="Scaffold a model zoo directory")
    init_parser.add_argument("path", nargs="?", default="model_zoo")
    build_parser = sub.add_parser("build", help="Build a job docker image")
    build_parser.add_argument("path", nargs="?", default="model_zoo", help="Model zoo directory")
    build_parser.add_argument("--image", default="")
    build_parser.add_argument(
        "--base-image", default="pytorch/pytorch:2.5.1-cuda12.4-cudnn9-devel",
        help="Base image (needs PyTorch with CUDA and nvcc preinstalled for real jobs: "
             "the kernels build at first use)",
    )
    build_parser.add_argument("--context", default="", help="Build-context output directory")
    build_parser.add_argument(
        "--dockerfile-only", action="store_true",
        help="Render the Dockerfile + context and stop (external image builds)",
    )
    build_parser.add_argument(
        "--allow-no-docker", action="store_true",
        help="Exit 0 when docker is absent (context was still rendered)",
    )
    push_parser = sub.add_parser("push", help="Push a job docker image")
    push_parser.add_argument("image")
    args = parser.parse_args(argv)

    if args.action == "init":
        return init(args.path)
    try:
        if args.action == "build":
            return build(args)
        return push(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
