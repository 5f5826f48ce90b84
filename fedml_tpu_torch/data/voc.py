"""Pascal VOC segmentation loader, FedSeg's dataset family (counterpart
of ``fedml_tpu/data/voc.py``; the same arrays for the same files and
seed).

VOC layout: ``JPEGImages/<id>.jpg``, ``SegmentationClass/<id>.png``
(class-index masks, 255 = ignore), ``ImageSets/Segmentation/{train,
val}.txt``. Shards are homogeneous, or the segmentation LDA over each
image's present classes (``core/partition.py``, ``task="segmentation"``).
Masks are decoded once as uint8; images straight into their client's
shard, so there is no pooled train copy (``train_global`` is None). PIL
is imported where a file is decoded, so the package imports on a
machine without it.
"""

from __future__ import annotations

import os

import numpy as np

from fedml_tpu_torch.core.partition import (
    homo_partition, non_iid_partition_with_dirichlet_distribution)

VOC_NUM_CLASSES = 21
IGNORE = 255


def _read_split(root, split):
    path = os.path.join(root, "ImageSets", "Segmentation", f"{split}.txt")
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _decode_image(root, image_id, image_size):
    from PIL import Image
    with Image.open(os.path.join(root, "JPEGImages",
                                 f"{image_id}.jpg")) as im:
        im = im.convert("RGB").resize((image_size, image_size))
        return np.asarray(im, np.float32) / 255.0


def _decode_mask(root, image_id, image_size):
    from PIL import Image
    with Image.open(os.path.join(root, "SegmentationClass",
                                 f"{image_id}.png")) as m:
        m = m.resize((image_size, image_size), resample=0)  # NEAREST
        return np.asarray(m, np.uint8)


def _decode_shard(root, ids, masks, idx, image_size):
    """One client's images decoded into its shard array."""
    x = np.zeros((len(idx), image_size, image_size, 3), np.float32)
    for j, i in enumerate(idx):
        x[j] = _decode_image(root, ids[i], image_size)
    return {"x": x, "y": masks[np.asarray(idx, np.int64)]}


def load_voc_federated(data_dir, client_num=4, partition="homo",
                       partition_alpha=0.5, image_size=513, seed=0):
    """The 8-tuple of a VOC tree at ``data_dir``: train shards by
    ``partition``, the val split as the global test set, 21 classes;
    a missing tree raises ``FileNotFoundError``."""
    if not os.path.isdir(os.path.join(data_dir or "", "JPEGImages")):
        raise FileNotFoundError(
            f"expected VOC layout under {data_dir} (JPEGImages/, "
            f"SegmentationClass/, ImageSets/Segmentation/); fetch VOC2012 "
            f"or use dataset=synthetic_segmentation")
    train_ids = _read_split(data_dir, "train")
    val_ids = _read_split(data_dir, "val")
    train_masks = np.stack([_decode_mask(data_dir, i, image_size)
                            for i in train_ids])
    val_masks = np.stack([_decode_mask(data_dir, i, image_size)
                          for i in val_ids])
    if partition == "homo":
        parts = homo_partition(len(train_ids), client_num, seed)
    else:
        present = [np.unique(m[(m != IGNORE)]).tolist() or [0]
                   for m in train_masks]
        parts = non_iid_partition_with_dirichlet_distribution(
            present, client_num, VOC_NUM_CLASSES, partition_alpha,
            task="segmentation", seed=seed)
    train_local = {c: _decode_shard(data_dir, train_ids, train_masks, idx,
                                    image_size)
                   for c, idx in parts.items()}
    test_global = _decode_shard(data_dir, val_ids, val_masks,
                                np.arange(len(val_ids)), image_size)
    test_local = {c: None for c in range(client_num)}
    local_num = {c: len(v["y"]) for c, v in train_local.items()}
    return [len(train_ids), len(val_ids), None, test_global,
            local_num, train_local, test_local, VOC_NUM_CLASSES]


__all__ = ["load_voc_federated", "VOC_NUM_CLASSES", "IGNORE"]
