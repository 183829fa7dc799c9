"""ResNet-50 on ImageNet: the port of
``model_zoo/resnet50/resnet50_subclass.py``.

- The model: ``BottleneckBlock`` (``:39-77``; v1.5, the stride on the
  3x3, whose SAME padding is ``(0, 1)`` on an even input; the last
  norm's scale starts at zero; a 1x1 projection where the shape
  changes) and ``ResNet50`` (``:80-125``): the uint8 input on the 0-255
  scale normalised on the card (``normalize``: the mean and std rounded to
  the compute dtype, the arithmetic in f32 and one rounding after it, as
  XLA's fusion computes it; a bf16 rounding after each op would put the
  bf16 logits about twice as far from the exact result), the
  7x7/2 stem with explicit (3, 3) padding, flax batch norm, the 3x3/2
  max pool with (1, 1) padding, ``stage_sizes`` bottleneck blocks of 64,
  128, 256 and 512 filters, the spatial mean and an f32 ``Dense_0``.
  ``custom_model`` (``:128``) computes convs and norms in bf16 with
  ``use_bf16`` (``norm_dtype`` follows the compute dtype; the statistics
  stay f32, ``zoo/vision.py``).  Modules carry flax's names
  (``BottleneckBlock_3/BatchNorm_2``).  On the card the model is
  ``channels_last``.  ``stage_sizes`` is an argument of the class, as in
  JAX; ``custom_model`` takes JAX's model params.
- Training: ``loss`` (``:137``, f32 softmax cross entropy) and
  ``optimizer`` (``:143``, Nesterov ``sgd(0.1, momentum=0.9)``).
- Data: ``dataset_fn`` (``:156``; uint8 throughout, a random crop and
  flip to 224 in training and a center crop in evaluation for square
  records stored larger, with a fresh seed per call from a counter, as
  JAX's), ``eval_metrics_fn`` (``:189``, numpy), ``columnar_dataset_fn``
  (``:206``; one permutation folded into the crop's gather for a whole
  task), ``ImageRecordReader`` (``:243``, image ETRF shards through the
  columnar surface) and ``custom_data_reader`` (``:296``;
  ``synthetic://imagenet?n=&seed=&size=&classes=``, or a ``.etrf`` file
  or a directory of them).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.data import image as image_plane
from elasticdl_tpu_torch.data import recordfile
from elasticdl_tpu_torch.data.columnar import training_permutation
from elasticdl_tpu_torch.data.reader import FixedWidthEtrfReader, is_etrf_dir
from elasticdl_tpu_torch.data.synthetic import SyntheticImagenetReader, parse_synthetic_path
from elasticdl_tpu_torch.parallel import optim
from elasticdl_tpu_torch.zoo import vision
from elasticdl_tpu_torch.zoo.transformer_lm import Dense

IMAGE_SIZE = 224
NUM_CLASSES = 1000
STAGE_SIZES = (3, 4, 6, 3)
#: ImageNet channel statistics on the 0-255 uint8 scale.
IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)
#: The stored size of ETRF image records: a training crop takes 256 -> 224.
IMAGE_STORE_SIZE = 256


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int, dtype: torch.dtype,
                 norm_dtype: torch.dtype, device=None):
        super().__init__()
        s = (strides, strides)

        def conv(cin, cout, k, stride=(1, 1)):
            return vision.Conv(cin, cout, k, stride, use_bias=False, dtype=dtype, device=device)

        def norm(features, zero_scale=False):
            return vision.BatchNorm(features, norm_dtype, zero_scale=zero_scale, device=device)

        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), s)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, (1, 1))
        self.BatchNorm_2 = norm(filters * 4, zero_scale=True)
        self.project = strides != 1 or in_features != filters * 4
        if self.project:
            self.Conv_3 = conv(in_features, filters * 4, (1, 1), s)
            self.BatchNorm_3 = norm(filters * 4)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = self.BatchNorm_3(self.Conv_3(x), train) if self.project else x
        return F.relu(y + residual)


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = NUM_CLASSES, dtype: torch.dtype = torch.bfloat16,
                 norm_dtype: torch.dtype = torch.float32,
                 stage_sizes: Sequence[int] = STAGE_SIZES, normalize: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.normalize = normalize
        self.register_buffer("image_mean", torch.tensor(IMAGENET_MEAN, device=device).to(dtype),
                             persistent=False)
        self.register_buffer("image_std", torch.tensor(IMAGENET_STD, device=device).to(dtype),
                             persistent=False)
        self.Conv_0 = vision.Conv(3, 64, (7, 7), (2, 2), padding=[(3, 3), (3, 3)],
                                  use_bias=False, dtype=dtype, device=device)
        self.BatchNorm_0 = vision.BatchNorm(64, norm_dtype, device=device)
        self.blocks = []
        features = 64
        for stage, blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** stage
            for block in range(blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                module = BottleneckBlock(features, filters, strides, dtype, norm_dtype, device)
                setattr(self, f"BottleneckBlock_{len(self.blocks)}", module)
                self.blocks.append(module)
                features = filters * 4
        self.Dense_0 = Dense(features, num_classes, torch.float32, device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """uint8 (or float) NHWC images on the 0-255 scale -> f32 logits."""
        x = vision.to_nchw(x)
        if self.normalize:
            # One rounding to the compute dtype, after the subtraction and
            # the division: XLA fuses the head and keeps f32 inside the
            # fusion (the constants themselves are rounded to the dtype).
            x = ((x.to(torch.float32) - self.image_mean.float()[:, None, None])
                 / self.image_std.float()[:, None, None])
        x = x.to(self.dtype)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        x = vision.max_pool_3x3_s2(x)
        for block in self.blocks:
            x = block(x, train)
        return self.Dense_0(vision.spatial_mean(x))

    def init_parameters(self, generator: torch.Generator) -> None:
        vision.init_parameters(self, generator)


def custom_model(num_classes: int = NUM_CLASSES, use_bf16: bool = True,
                 device=None) -> ResNet50:
    """The JAX ``custom_model`` on ``device`` (None: the card, where the
    model is ``channels_last``); weights uninitialised."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    return vision.on_device(ResNet50(num_classes, dtype, dtype, device=device), device)


def loss(labels: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    return vision.softmax_cross_entropy(labels, predictions)


def optimizer(lr: float = 0.1) -> optim.DenseOptimizer:
    return optim.sgd(lr, momentum=0.9, nesterov=True)


#: Per-call seed counter of ``dataset_fn``'s augmentation: each call (one
#: per task) draws a fresh seed, so crops vary across tasks and epochs.
_DATASET_FN_CALLS = [0]


def dataset_fn(dataset, mode, metadata):
    """uint8 records -> ``(image, int32 label)``; a square image stored
    larger than the training size gets the columnar path's crop (random
    crop and flip in training, center crop otherwise), a non-square one
    passes as it is."""
    _DATASET_FN_CALLS[0] += 1
    rng = np.random.default_rng(_DATASET_FN_CALLS[0])

    def parse(record):
        image, label = record
        image = np.ascontiguousarray(image, np.uint8)
        if image.ndim == 3 and image.shape[0] == image.shape[1]:
            crop = min(IMAGE_SIZE, image.shape[0])
            if mode == "training":
                image = image_plane.random_crop_flip(image[None], crop, rng)[0]
            elif image.shape[0] > crop:
                image = image_plane.center_crop(image[None], crop)[0]
        return image, np.int32(label)

    dataset = dataset.map(parse)
    if mode == "training":
        dataset = dataset.shuffle(1024, seed=0)
    return dataset


def eval_metrics_fn():
    return vision.classification_metrics()


def columnar_dataset_fn(columns, mode, metadata, seed: int = 0):
    """A task's ``{"image": [n, S*S*3], "label": [n, 1]}`` columns ->
    ``(images [n, crop, crop, 3] uint8, labels [n] int32)``: in training
    one permutation (``seed``, from the task and epoch) folded into the
    random crop and flip; otherwise a center crop.  Records smaller than
    224 pass at their own size."""
    flat = columns["image"]
    n = len(flat)
    size = int(round((flat.shape[1] // 3) ** 0.5))
    images = flat.reshape((n, size, size, 3))
    labels = columns["label"][:, 0].astype(np.int32)
    crop = min(IMAGE_SIZE, size)
    if mode == "training":
        perm = training_permutation(n, seed=seed)
        images = image_plane.random_crop_flip(images, crop, np.random.default_rng(seed),
                                              order=perm)
        labels = labels[perm]
    elif size != crop:
        images = image_plane.center_crop(images, crop)
    return images, labels


class ImageRecordReader(FixedWidthEtrfReader):
    """Image ETRF (one file or a directory of shards; ``data/image.py``
    records) through the columnar surface.  The image columns go straight
    into the crop's gather, so they are views (``copy_columns=False``),
    and a 1 GiB chunk budget delivers a whole task as one buffer.  The
    stored size comes from the record width (every shard must share it)."""

    copy_columns = False
    columnar_chunk_bytes = 1 << 30

    def __init__(self, path: str, size: int = 0, **kwargs):
        super().__init__(path, **kwargs)
        self._size = size or self._infer_size(self._files()[0])
        self._layout = image_plane.image_record_layout(self._size)

    @staticmethod
    def _infer_size(path: str) -> int:
        first = next(iter(recordfile.read_range(path, 0, 1)))
        size = int(round(((len(first) - 4) // 3) ** 0.5))
        if size * size * 3 + 4 != len(first):
            raise ValueError(f"{path}: {len(first)}B records are not square uint8 HWC images "
                             "+ int32 label (data/image.py layout)")
        return size

    def layout(self):
        return self._layout

    def _row(self, cols, i):
        s = self._size
        return cols["image"][i].reshape((s, s, 3)), np.int32(cols["label"][i, 0])


def custom_data_reader(data_path: str, **kwargs):
    name, params = parse_synthetic_path(data_path)
    if name is not None:
        return SyntheticImagenetReader(
            n=params.get("n", 1024), seed=params.get("seed", 0),
            image_size=params.get("size", IMAGE_SIZE),
            num_classes=params.get("classes", NUM_CLASSES))
    path = data_path.removeprefix("recordio:")
    if path.endswith(".etrf") or is_etrf_dir(path):
        return ImageRecordReader(path, **kwargs)
    return None
