"""The port's image data plane (``data/image.py``, ResNet-50's
``columnar_dataset_fn``, ``dataset_fn`` and ``ImageRecordReader``) and
its synthetic vision readers (``data/synthetic.py``) against the JAX
package's: the same ETRF bytes, each package's reader on the other's
files, the same crops and flips for the same seeds, and the same
synthetic records for the same seeds, all bit for bit."""

import types

import numpy as np
import pytest

from elasticdl_tpu.data import image as jax_image
from elasticdl_tpu_torch.data import image as port_image
from elasticdl_tpu_torch.data import synthetic as port_synthetic
from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.zoo import cifar10 as port_cifar10
from elasticdl_tpu_torch.zoo import mnist as port_mnist
from elasticdl_tpu_torch.zoo import resnet50 as port_resnet50
from model_zoo import datasets as jax_datasets
from model_zoo.resnet50 import resnet50_subclass as jax_resnet50

STORED, N = 40, 37


def _images(n=N, size=STORED, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8),
            rng.integers(0, 1000, n).astype(np.int32))


def _task(path, start, end, epoch=0):
    return types.SimpleNamespace(shard_name=path, start=start, end=end, epoch=epoch)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_etrf_bytes_and_readers_both_ways(tmp_path):
    images, labels = _images()
    port_path, jax_path = str(tmp_path / "port.etrf"), str(tmp_path / "jax.etrf")
    port_image.write_image_etrf(port_path, images, labels)
    jax_image.write_image_etrf(jax_path, images, labels)
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    assert port_image.image_record_layout(STORED).record_bytes == STORED * STORED * 3 + 4
    # each package's reader on the other's file, the columnar and the
    # per-record surfaces
    port_reader = port_resnet50.ImageRecordReader(jax_path)
    jax_reader = jax_resnet50.ImageRecordReader(port_path)
    assert port_reader.create_shards() == {jax_path: N}
    assert jax_reader.create_shards() == {port_path: N}
    task_port, task_jax = _task(jax_path, 3, 30), _task(port_path, 3, 30)
    got = list(port_reader.read_columns(task_port))
    want = list(jax_reader.read_columns(task_jax))
    assert len(got) == len(want) == 1
    for key in ("image", "label"):
        _same(got[0][key], want[0][key])
    _same(got[0]["image"].reshape(-1, STORED, STORED, 3), images[3:30])
    records = list(port_reader.read_records(task_port))
    jax_records = list(jax_reader.read_records(task_jax))
    assert len(records) == len(jax_records) == 27
    for (image, label), (jimage, jlabel) in zip(records, jax_records):
        _same(image, jimage)
        _same(label, jlabel)


def test_reader_refuses_records_that_are_not_square_images(tmp_path):
    from elasticdl_tpu_torch.data import recordfile

    path = str(tmp_path / "odd.etrf")
    recordfile.write_records(path, [b"x" * 10])
    with pytest.raises(ValueError, match="not square uint8"):
        port_resnet50.ImageRecordReader(path)


@pytest.mark.parametrize("out_size", [STORED, 32, 24])
def test_crops_match_jax(out_size):
    images, _ = _images()
    order = np.random.RandomState(3).permutation(N)
    for seed in (0, 7):
        _same(port_image.random_crop_flip(images, out_size, np.random.default_rng(seed)),
              jax_image.random_crop_flip(images, out_size, np.random.default_rng(seed)))
        _same(port_image.random_crop_flip(images, out_size, np.random.default_rng(seed),
                                          order=order, flip=False),
              jax_image.random_crop_flip(images, out_size, np.random.default_rng(seed),
                                         order=order, flip=False))
    _same(port_image.center_crop(images, out_size), jax_image.center_crop(images, out_size))
    with pytest.raises(ValueError, match="stored size"):
        port_image.center_crop(images, STORED + 1)


@pytest.mark.parametrize("size", [256, 32])
@pytest.mark.parametrize("mode", ["training", "evaluation"])
def test_columnar_dataset_fn_matches_jax(size, mode):
    """256-byte-wide records crop to 224 (a shuffle folded into the
    training crop); 32-wide ones pass at their own size."""
    images, labels = _images(n=9, size=size)
    columns = {"image": images.reshape(9, -1), "label": labels.reshape(9, 1)}
    for seed in (0, 11):
        got = port_resnet50.columnar_dataset_fn(columns, mode, None, seed=seed)
        want = jax_resnet50.columnar_dataset_fn(columns, mode, None, seed=seed)
        for a, b in zip(got, want):
            _same(a, b)
    assert got[0].shape == (9, min(224, size), min(224, size), 3)


def test_per_record_dataset_fn_matches_jax(monkeypatch):
    """Each call draws its crop seed from a per-call counter; in step,
    both packages give the same images and labels."""
    images, labels = _images(n=6, size=230)
    records = [(images[i], labels[i]) for i in range(6)]
    monkeypatch.setattr(jax_resnet50, "_DATASET_FN_CALLS", [41])
    monkeypatch.setattr(port_resnet50, "_DATASET_FN_CALLS", [41])
    from elasticdl_tpu.data.dataset import Dataset as JaxDataset

    for mode in ("training", "evaluation"):
        got = list(port_resnet50.dataset_fn(Dataset.from_iterable(records), mode, None))
        want = list(jax_resnet50.dataset_fn(JaxDataset.from_iterable(records), mode, None))
        assert len(got) == len(want) == 6
        for (image, label), (jimage, jlabel) in zip(got, want):
            assert image.shape == (224, 224, 3)
            _same(image, jimage)
            _same(label, jlabel)


@pytest.mark.parametrize("name", ["mnist", "cifar10", "imagenet"])
def test_synthetic_readers_match_jax(name):
    task = _task(None, 5, 29)
    if name == "mnist":
        port = port_mnist.custom_data_reader("synthetic://mnist?n=40&seed=3")
        jax = jax_datasets.synthetic_mnist_reader(n=40, seed=3)
    elif name == "cifar10":
        port = port_cifar10.custom_data_reader("synthetic://cifar10?n=40&seed=3")
        jax = jax_datasets.synthetic_cifar10_reader(n=40, seed=3)
    else:
        port = port_resnet50.custom_data_reader(
            "synthetic://imagenet?n=40&seed=3&size=48&classes=30")
        jax = jax_datasets.synthetic_imagenet_reader(n=40, seed=3, image_size=48,
                                                     num_classes=30)
    assert list(port.create_shards().values()) == list(jax.create_shards().values()) == [40]
    got, want = list(port.read_records(task)), list(jax.read_records(task))
    assert len(got) == len(want) == 24
    for (image, label), (jimage, jlabel) in zip(got, want):
        _same(image, jimage)
        _same(label, jlabel)
    assert port_synthetic.parse_synthetic_path("synthetic://imagenet?n=4&size=8") == (
        "imagenet", {"n": 4, "size": 8})
