"""Conv-net building blocks with flax's semantics, for the vision zoo
(``zoo/mnist.py``, ``zoo/cifar10.py``, ``zoo/resnet50.py``).

The modules take NCHW tensors; flax's are NHWC with HWIO kernels.  A
uint8 NHWC batch ``permute``d to NCHW is already ``torch.channels_last``
in memory, and on the card the zoo keeps the models in that format, so
cuDNN runs its NHWC kernels.  ``serving/convert.py`` carries a flax
``Conv`` kernel ``[kh, kw, in, out]`` to the port's ``weight [out, in,
kh, kw]`` and back.

``Conv`` (flax ``nn.Conv``): the input and the kernel are cast to the
layer's ``dtype``, the product comes out in it, and the bias (when there
is one) is added in it.  ``padding="SAME"`` is flax's rule, per spatial
dim of size ``n``, kernel ``k``, stride ``s``: ``out = ceil(n / s)``,
``total = max((out - 1) * s + k - n, 0)``, ``lo = total // 2``, ``hi =
total - lo``.  It is asymmetric where ``total`` is odd: a stride-2 3x3
conv on an even input pads ``(0, 1)``, which ``nn.Conv2d(padding=1)``
would get wrong by a pixel, so such a conv pads explicitly with
``F.pad``.  An explicit ``[(lo, hi), ...]`` padding is taken as given.

``BatchNorm`` (flax ``nn.BatchNorm`` 0.12, ``_compute_stats`` and
``_normalize``; feature axis last, so channels here):

- ``train=True``: the statistics of the batch, in f32 whatever the input
  dtype (``force_float32_reductions``): ``mean = E[x]``, ``var =
  max(0, E[x^2] - E[x]^2)`` (the "fast variance"), over every axis but
  the channels.  The running averages take these, the *biased*
  variance included (``nn.BatchNorm2d`` stores the unbiased one):
  ``ra = momentum * ra + (1 - momentum) * batch`` with flax's
  ``momentum=0.9`` (torch's ``momentum=0.1``), both constants rounded to
  f32.
- ``train=False``: ``mean`` and ``var`` are the running averages.
- Then ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32
  (the input promoted against the f32 statistics) and cast to the
  layer's ``dtype``: bf16 for ResNet-50's ``norm_dtype`` with
  ``use_bf16``, f32 for ResNet-20's.  ``eps`` is 1e-5.
- On a process mesh the data-parallel trainer sets ``stats_reduce`` on
  every layer (``parallel/dp_trainer.py``): the per-rank means ``[E[x],
  E[x^2]]`` are averaged over the ranks, so the statistics are those of
  the global batch, as in JAX's SPMD step.

``scale`` starts at ones (zeros with ``zero_scale``, ResNet-50's last
norm of a block), ``bias`` and the running mean at zeros, the running
variance at ones; conv and dense kernels are lecun-normal, biases zero
(flax's defaults).  ``batch_stats(model)`` names every running average,
``{"<module path>.mean"|".var": buffer}``: the ``model_state`` of the
trainers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.zoo.deepfm import lecun_normal_

Padding = Union[str, Sequence[Tuple[int, int]]]

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's ``SAME`` padding of one spatial dim: ``(lo, hi)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW: ``weight [out, in, kh, kw]``."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: Padding = "SAME",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((features, in_features, *kernel_size),
                                               device=device))
        self.bias = nn.Parameter(torch.empty((features,), device=device)) if use_bias else None
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.compute_dtype = dtype

    def _pads(self, x: torch.Tensor):
        if self.padding == "SAME":
            return [same_pads(n, k, s) for n, k, s in
                    zip(x.shape[2:], self.kernel_size, self.strides)]
        if self.padding == "VALID":
            return [(0, 0), (0, 0)]
        return [tuple(p) for p in self.padding]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        (hl, hh), (wl, wh) = self._pads(x)
        if hl == hh and wl == wh:
            padding = (hl, wl)
        else:
            x = F.pad(x, (wl, wh, hl, hh))
            padding = (0, 0)
        y = F.conv2d(x, self.weight.to(dt), None, self.strides, padding)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return y

    def init_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, int(np.prod(self.weight.shape[1:])), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of NCHW: ``weight`` is
    flax's ``scale``; the buffers ``mean``/``var`` its ``batch_stats``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 momentum: float = BN_MOMENTUM, eps: float = BN_EPS, zero_scale: bool = False,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((features,), device=device))
        self.bias = nn.Parameter(torch.empty((features,), device=device))
        self.register_buffer("mean", torch.zeros((features,), device=device))
        self.register_buffer("var", torch.ones((features,), device=device))
        self.compute_dtype = dtype
        self.momentum = float(np.float32(momentum))
        self.one_minus_momentum = float(np.float32(1 - momentum))
        self.eps = float(np.float32(eps))
        self.zero_scale = zero_scale
        #: ``[2, C]`` per-rank ``[E[x], E[x^2]]`` -> the global batch's
        #: (a process mesh's data-parallel trainer sets it), or None.
        self.stats_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.to(torch.float32)
        if train:
            dims = (0,) + tuple(range(2, x.ndim))
            moments = torch.stack([x32.mean(dims), (x32 * x32).mean(dims)])
            if self.stats_reduce is not None:
                moments = self.stats_reduce(moments)
            mean = moments[0]
            var = torch.clamp(moments[1] - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean
                                + self.one_minus_momentum * mean.detach())
                self.var.copy_(self.momentum * self.var
                               + self.one_minus_momentum * var.detach())
        else:
            mean, var = self.mean, self.var
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.compute_dtype)

    def init_parameters(self, generator: torch.Generator) -> None:
        (nn.init.zeros_ if self.zero_scale else nn.init.ones_)(self.weight)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2))`` of NHWC on NCHW: summed in f32 and
    cast back to ``x``'s dtype, as JAX upcasts a bf16 mean."""
    return x.to(torch.float32).mean((2, 3)).to(x.dtype)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """``nn.max_pool(x, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])``:
    the padding is -inf, as torch's is."""
    return F.max_pool2d(x, 3, 2, padding=1)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``nn.avg_pool(x, (2, 2), strides=(2, 2))`` (VALID)."""
    return F.avg_pool2d(x, 2, 2)


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every ``BatchNorm``'s running averages, ``{"<path>.mean"|".var":
    buffer}`` (the live tensors), in module order; ``{}`` for a model
    without batch norm."""
    stats = {}
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            stats[f"{name}.mean"] = module.mean
            stats[f"{name}.var"] = module.var
    return stats


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded flax-default initialisation of every layer, in module order."""
    with torch.no_grad():
        for module in model.modules():
            if module is not model and hasattr(module, "init_parameters"):
                module.init_parameters(generator)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC image batch as NCHW (a view: channels_last in memory);
    ``[B, H, W]`` gains a channel."""
    if x.ndim == 3:
        x = x[..., None]
    return x.permute(0, 3, 1, 2)



def on_device(model: nn.Module, device: torch.device) -> nn.Module:
    """The model on ``device``; on the card in ``channels_last``, so the
    convolutions take cuDNN's NHWC kernels."""
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def softmax_cross_entropy(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels(logits.astype(f32),
    labels).mean()``: ``logsumexp(logits) - logits[label]`` per row, the
    max subtracted first (as a constant), then the mean."""
    logits = logits.to(torch.float32)
    shifted = logits - logits.amax(-1, keepdim=True).detach()
    label_logits = torch.gather(shifted, -1, labels.to(torch.int64)[..., None])[..., 0]
    return (torch.log(torch.exp(shifted).sum(-1)) - label_logits).mean()


def numpy_cross_entropy(labels: np.ndarray, logits: np.ndarray) -> float:
    """``softmax_cross_entropy`` on the host, in f32 numpy (the zoo's
    evaluation metric)."""
    logits = np.asarray(logits, np.float32)
    shifted = logits - logits.max(-1, keepdims=True)
    label_logits = np.take_along_axis(
        shifted, np.asarray(labels).astype(np.int64)[..., None], -1)[..., 0]
    return float(np.mean(np.log(np.exp(shifted).sum(-1)) - label_logits))


def classification_metrics():
    """The vision zoo's ``eval_metrics_fn`` body: accuracy and the mean
    cross entropy of ``[n, classes]`` outputs against ``[n]`` labels."""
    return {
        "accuracy": lambda outputs, labels: np.mean(
            np.argmax(outputs, axis=1) == np.asarray(labels).astype(np.int64)),
        "loss": lambda outputs, labels: numpy_cross_entropy(labels, outputs),
    }
