"""CIFAR-10 ResNet-20: the port of
``model_zoo/cifar10/cifar10_functional_api.py`` (``ResidualBlock`` and
``ResNet20``, ``:25-90``).

The classic 6n+2 CIFAR ResNet with n=3 (16/32/64 filters): SAME 3x3
convs without bias in the compute dtype (bf16 with ``use_bf16``, else
f32), flax batch norm in f32 (``zoo/vision.py``; its output is f32, so
the residual adds are f32 and each conv casts its input), a 1x1
projection where a block changes shape, the spatial mean and an f32
``Dense_0``.  Modules carry flax's names (``Conv_0``, ``BatchNorm_0``,
``ResidualBlock_0..8`` each with ``Conv_i``/``BatchNorm_i``,
``Dense_0``).  The contract: ``loss`` (f32 softmax cross entropy),
``optimizer`` (Nesterov ``sgd(0.1, momentum=0.9)``), ``dataset_fn`` (the
CIFAR-10 channel normalisation on the host, shuffled in training),
``eval_metrics_fn`` and ``custom_data_reader``
(``synthetic://cifar10?n=&seed=``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data.synthetic import parse_synthetic_path, synthetic_cifar10_reader
from elasticdl_tpu_torch.parallel import optim
from elasticdl_tpu_torch.zoo import vision
from elasticdl_tpu_torch.zoo.transformer_lm import Dense

CIFAR_MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.asarray([0.247, 0.243, 0.261], np.float32)


class ResidualBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        s = (strides, strides)
        self.Conv_0 = vision.Conv(in_features, filters, (3, 3), s, use_bias=False, dtype=dtype,
                                  device=device)
        self.BatchNorm_0 = vision.BatchNorm(filters, torch.float32, device=device)
        self.Conv_1 = vision.Conv(filters, filters, (3, 3), use_bias=False, dtype=dtype,
                                  device=device)
        self.BatchNorm_1 = vision.BatchNorm(filters, torch.float32, device=device)
        self.project = strides != 1 or in_features != filters
        if self.project:
            self.Conv_2 = vision.Conv(in_features, filters, (1, 1), s, use_bias=False,
                                      dtype=dtype, device=device)
            self.BatchNorm_2 = vision.BatchNorm(filters, torch.float32, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = self.BatchNorm_2(self.Conv_2(x), train) if self.project else x
        return F.relu(y + residual)


class ResNet20(nn.Module):
    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = vision.Conv(3, 16, (3, 3), use_bias=False, dtype=dtype, device=device)
        self.BatchNorm_0 = vision.BatchNorm(16, torch.float32, device=device)
        self.blocks = []
        features, i = 16, 0
        for filters, strides in ((16, 1), (32, 2), (64, 2)):
            for block_index in range(3):
                block = ResidualBlock(features, filters, strides if block_index == 0 else 1,
                                      dtype, device)
                setattr(self, f"ResidualBlock_{i}", block)
                self.blocks.append(block)
                features, i = filters, i + 1
        self.Dense_0 = Dense(64, num_classes, torch.float32, device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = vision.to_nchw(x).to(self.dtype)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        for block in self.blocks:
            x = block(x, train)
        return self.Dense_0(vision.spatial_mean(x))

    def init_parameters(self, generator: torch.Generator) -> None:
        vision.init_parameters(self, generator)


def custom_model(num_classes: int = 10, use_bf16: bool = True, device=None) -> ResNet20:
    """The JAX ``custom_model`` on ``device`` (None: the card, where the
    model is ``channels_last``); weights uninitialised."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    return vision.on_device(ResNet20(num_classes, dtype, device), device)


def loss(labels: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    return vision.softmax_cross_entropy(labels, predictions)


def optimizer(lr: float = 0.1) -> optim.DenseOptimizer:
    return optim.sgd(lr, momentum=0.9, nesterov=True)


def dataset_fn(dataset, mode, metadata):
    def parse(record):
        image, label = record
        image = np.asarray(image, np.float32) / 255.0
        return (image - CIFAR_MEAN) / CIFAR_STD, np.int32(label)

    dataset = dataset.map(parse)
    if mode == "training":
        dataset = dataset.shuffle(2048, seed=0)
    return dataset


def eval_metrics_fn():
    return vision.classification_metrics()


def custom_data_reader(data_path: str, **kwargs):
    name, params = parse_synthetic_path(data_path)
    if name is None:
        return None
    return synthetic_cifar10_reader(n=params.get("n", 4096), seed=params.get("seed", 0))
