"""The port's image packer (``elasticdl_tpu_torch/data/pack_images.py``)
against the JAX package's ``scripts/pack_images.py``, on the CPU.

A seeded tree of 3 classes of PNG and JPEG images of uneven sizes, made
here with Pillow (nothing is downloaded), packed by both at size 32 with
4 records a shard: the shards and ``labels.json`` are byte-identical,
the port's ``ImageRecordReader`` reads back ``decode_resize``'s arrays in
the shuffled order, the CLI writes the same files, and a tree without
class directories or without images raises ``ValueError``.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from elasticdl_tpu_torch.data import pack_images
from elasticdl_tpu_torch.zoo.resnet50 import ImageRecordReader

REPO = Path(__file__).resolve().parent.parent
SIZE, PER_SHARD = 32, 4


def _jax_packer():
    spec = importlib.util.spec_from_file_location(
        "jax_pack_images", REPO / "scripts" / "pack_images.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _image_tree(root: Path, seed: int = 7) -> Path:
    rng = np.random.default_rng(seed)
    for c, cls in enumerate(("zebra", "ant", "moth")):
        (root / cls).mkdir(parents=True)
        for i in range(3 + c):
            w, h = (int(v) for v in rng.integers(20, 90, 2))
            pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            image = Image.fromarray(pixels if i % 3 else pixels[..., 0])  # some grayscale
            name = f"img{i}.{'png' if i % 2 else 'jpg'}"
            image.save(root / cls / name)
        (root / cls / "notes.txt").write_text("not an image")
    return root


def _files(directory: Path):
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir())}


def test_shards_byte_identical_to_jax_and_read_back(tmp_path, capsys):
    tree = _image_tree(tmp_path / "tree")
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    n_jax = _jax_packer().pack(str(tree), str(jax_out), SIZE, PER_SHARD, seed=3)
    n_port = pack_images.pack(str(tree), str(port_out), SIZE, PER_SHARD, seed=3)
    assert n_jax == n_port == 12
    jax_files, port_files = _files(jax_out), _files(port_out)
    assert sorted(port_files) == ["images-00000.etrf", "images-00001.etrf",
                                  "images-00002.etrf", "labels.json"]
    assert port_files == jax_files
    assert json.loads(port_files["labels.json"]) == ["ant", "moth", "zebra"]
    assert "packed 12 images, 3 classes -> 3 shard(s)" in capsys.readouterr().out

    classes, items = pack_images.list_dataset(str(tree))
    order = np.random.default_rng(3).permutation(len(items))
    reader = ImageRecordReader(str(port_out))
    shards = reader.create_shards()
    assert list(shards.values()) == [PER_SHARD] * 3
    got = []
    for name, count in sorted(shards.items()):
        got += list(reader.read_records(SimpleNamespace(shard_name=name, start=0, end=count)))
    assert len(got) == len(items)
    for (image, label), idx in zip(got, order):
        path, want_label = items[idx]
        want = pack_images.decode_resize(path, SIZE)
        assert want.shape == (SIZE, SIZE, 3) and want.dtype == np.uint8
        np.testing.assert_array_equal(image, want)
        assert label == want_label


def test_cli_writes_the_same_shards(tmp_path):
    tree = _image_tree(tmp_path / "tree", seed=11)
    _jax_packer().pack(str(tree), str(tmp_path / "jax"), 24, 5, seed=0)
    proc = subprocess.run([sys.executable, "-m", "elasticdl_tpu_torch.data.pack_images",
                           str(tree), str(tmp_path / "port"), "--size", "24",
                           "--records-per-shard", "5"],
                          cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("layout", ["no_class_directory", "no_image"])
def test_empty_trees_raise(tmp_path, layout):
    root = tmp_path / "tree"
    root.mkdir()
    if layout == "no_class_directory":
        (root / "stray.jpg").write_bytes(b"")
        match = "no class subdirectories"
    else:
        (root / "cls").mkdir()
        (root / "cls" / "readme.md").write_text("x")
        match = "no image files"
    for packer in (pack_images, _jax_packer()):
        with pytest.raises(ValueError, match=match):
            packer.pack(str(root), str(tmp_path / "out"), SIZE, PER_SHARD)
