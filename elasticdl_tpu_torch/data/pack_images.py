"""Pack an image-classification directory tree into ETRF image shards:
the port of ``scripts/pack_images.py``.

JPEG/PNG decode and resize happen once here, offline, so training
streams fixed-width uint8 records (``data/image.py``) instead of paying
a decode every epoch.  Host tooling: it launches nothing on the card.

Input layout: the class-per-subdirectory tree (``root/<class>/<image>``,
ImageNet style); class names map to integer labels by sorted order,
written beside the shards as ``labels.json``.

Each image is resized so its shorter side equals ``--size``,
center-cropped square and stored as ``[size, size, 3]`` uint8 with its
int32 label (``image_record_layout``).  One seeded global shuffle orders
the images; they go ``--records-per-shard`` at a time into
``images-%05d.etrf`` files, each a shard of the master's dynamic
sharding, which ``zoo/resnet50.ImageRecordReader`` reads.  The bytes are
the JAX script's for the same tree, size and seed.

    python -m elasticdl_tpu_torch.data.pack_images /data/imagenet/train out_dir \
        --size 256 --records-per-shard 50000
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def list_dataset(root: str):
    """``(classes, [(path, label)])`` of a class-per-subdirectory tree."""
    classes = sorted(name for name in os.listdir(root)
                     if os.path.isdir(os.path.join(root, name)))
    if not classes:
        raise ValueError(f"no class subdirectories under {root}")
    items = []
    for label, cls in enumerate(classes):
        for name in sorted(os.listdir(os.path.join(root, cls))):
            if name.lower().endswith(IMAGE_SUFFIXES):
                items.append((os.path.join(root, cls, name), label))
    if not items:
        raise ValueError(f"no image files under {root}")
    return classes, items


def decode_resize(path: str, size: int) -> np.ndarray:
    """One image as ``[size, size, 3]`` uint8: RGB, the shorter side
    resized (bilinear) to ``size``, then the center square."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        w, h = img.size
        scale = size / min(w, h)
        img = img.resize((max(size, round(w * scale)), max(size, round(h * scale))),
                         Image.BILINEAR)
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
        img = img.crop((left, top, left + size, top + size))
        return np.asarray(img, np.uint8)


def pack(root: str, out_dir: str, size: int, records_per_shard: int, seed: int = 0) -> int:
    """Write the shards and ``labels.json``; returns the images written."""
    from elasticdl_tpu_torch.data import recordfile
    from elasticdl_tpu_torch.data.image import image_record_layout

    classes, items = list_dataset(root)
    # One global shuffle, so every shard is an unbiased sample of the classes.
    order = np.random.default_rng(seed).permutation(len(items))
    layout = image_record_layout(size)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "labels.json"), "w") as f:
        json.dump(classes, f)

    n_shards = max(1, -(-len(items) // records_per_shard))
    written = 0
    for shard in range(n_shards):
        chunk = order[shard * records_per_shard:(shard + 1) * records_per_shard]
        path = os.path.join(out_dir, f"images-{shard:05d}.etrf")
        records = (layout.pack(image=decode_resize(items[i][0], size).reshape(-1),
                               label=np.int32(items[i][1]))
                   for i in chunk)
        recordfile.write_records(path, records)
        written += len(chunk)
        print(f"{path}: {len(chunk)} records", flush=True)
    print(f"packed {written} images, {len(classes)} classes -> {n_shards} shard(s) in "
          f"{out_dir}", flush=True)
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m elasticdl_tpu_torch.data.pack_images")
    p.add_argument("input", help="class-per-subdirectory image tree")
    p.add_argument("output", help="output directory for .etrf shards")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--records-per-shard", type=int, default=50_000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    pack(args.input, args.output, args.size, args.records_per_shard, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
