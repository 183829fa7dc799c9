"""MNIST: the port of ``model_zoo/mnist/mnist_functional_api.py`` (an
MLP, ``:19-43``) and ``model_zoo/mnist/mnist_subclass.py`` (a conv net in
flax's ``setup()`` style, ``:26-50``), one module for both ``model_def``s:
``mnist.mnist_functional_api`` is this module (``custom_model`` builds
``MnistDNN``), ``mnist.mnist_subclass`` is ``SUBCLASS``, the same
contract with ``custom_model`` building ``MnistCNN``, as the JAX
subclass module imports its sibling's contract.

Modules carry flax's names: ``Dense_0..2`` for the MLP, ``conv1``,
``conv2``, ``dense1`` and ``head`` for the conv net (SAME 3x3 convs with
bias, 2x2 average pools, the NHWC flatten).  Everything is f32.  The
contract: ``loss`` (mean softmax cross entropy), ``optimizer``
(``sgd(0.1, momentum=0.9)``), ``dataset_fn`` (uint8 -> f32 / 255,
shuffled in training), ``eval_metrics_fn`` (accuracy, loss; numpy) and
``custom_data_reader`` (``synthetic://mnist?n=&seed=``).
"""

from __future__ import annotations

import types

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data.synthetic import parse_synthetic_path, synthetic_mnist_reader
from elasticdl_tpu_torch.parallel import optim
from elasticdl_tpu_torch.zoo import vision
from elasticdl_tpu_torch.zoo.transformer_lm import Dense

F32 = torch.float32


class MnistDNN(nn.Module):
    def __init__(self, hidden_dim: int = 128, device=None):
        super().__init__()
        self.Dense_0 = Dense(28 * 28, hidden_dim, F32, device)
        self.Dense_1 = Dense(hidden_dim, hidden_dim // 2, F32, device)
        self.Dense_2 = Dense(hidden_dim // 2, 10, F32, device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(F32)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)

    def init_parameters(self, generator: torch.Generator) -> None:
        vision.init_parameters(self, generator)


class MnistCNN(nn.Module):
    def __init__(self, hidden_dim: int = 64, device=None):
        super().__init__()
        self.conv1 = vision.Conv(1, 16, (3, 3), device=device)
        self.conv2 = vision.Conv(16, 32, (3, 3), device=device)
        self.dense1 = Dense(7 * 7 * 32, hidden_dim, F32, device)
        self.head = Dense(hidden_dim, 10, F32, device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = vision.to_nchw(x.to(F32))
        x = vision.avg_pool_2x2(F.relu(self.conv1(x)))
        x = vision.avg_pool_2x2(F.relu(self.conv2(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax flattens NHWC
        return self.head(F.relu(self.dense1(x)))

    def init_parameters(self, generator: torch.Generator) -> None:
        vision.init_parameters(self, generator)


def custom_model(hidden_dim: int = 128, device=None) -> MnistDNN:
    """``mnist_functional_api.custom_model`` on ``device`` (None: the
    card); weights uninitialised."""
    return MnistDNN(hidden_dim, device=resolve_device(device))


def subclass_model(hidden_dim: int = 64, device=None) -> MnistCNN:
    """``mnist_subclass.custom_model``."""
    return MnistCNN(hidden_dim, device=resolve_device(device))


def loss(labels: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    return vision.softmax_cross_entropy(labels, predictions)


def optimizer(lr: float = 0.1) -> optim.DenseOptimizer:
    return optim.sgd(lr, momentum=0.9)


def dataset_fn(dataset, mode, metadata):
    def parse(record):
        image, label = record
        return np.asarray(image, np.float32) / 255.0, np.int32(label)

    dataset = dataset.map(parse)
    if mode == "training":
        dataset = dataset.shuffle(1024, seed=0)
    return dataset


def eval_metrics_fn():
    return vision.classification_metrics()


def custom_data_reader(data_path: str, **kwargs):
    """``synthetic://mnist?n=&seed=`` -> the JAX zoo reader's records;
    None for any other path (the standard readers take it)."""
    name, params = parse_synthetic_path(data_path)
    if name is None:
        return None
    return synthetic_mnist_reader(n=params.get("n", 4096), seed=params.get("seed", 0))


#: The ``mnist.mnist_subclass`` contract: this module's, with the conv net.
SUBCLASS = types.SimpleNamespace(
    custom_model=subclass_model, loss=loss, optimizer=optimizer, dataset_fn=dataset_fn,
    eval_metrics_fn=eval_metrics_fn, custom_data_reader=custom_data_reader)
