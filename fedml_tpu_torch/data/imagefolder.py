"""Directory-tree image datasets, ImageNet (ILSVRC) and Google Landmarks
(gld23k / gld160k) (counterpart of ``fedml_tpu/data/imagefolder.py``;
the same arrays for the same files and seed).

ImageNet is an ImageFolder tree partitioned by LDA or homogeneously
over the pooled index; Landmarks a ``<split>_user_dict.csv`` that
assigns each image to its photographer's client. Images are decoded by
PIL on the host (imported where an image is decoded, so the package
imports on a machine without it) into NHWC fp32 in [0, 1] normalised by
ImageNet's statistics. ``materialize=False`` gives each client a
manifest (paths and labels) that :func:`materialize_shard` decodes when
it is needed.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from fedml_tpu_torch.core.partition import (
    homo_partition, non_iid_partition_with_dirichlet_distribution)

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _decode(path, image_size):
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB").resize((image_size, image_size))
        x = np.asarray(im, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


#: torchvision ImageFolder's extensions; other files in a class
#: directory (.DS_Store, README, checksums) are skipped
IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def _scan_imagefolder(split_dir):
    """ImageFolder layout ``<split>/<class_name>/<img>``, classes and
    files sorted: ``(paths, labels, classes)``."""
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(split_dir, cname)
        for name in sorted(os.listdir(cdir)):
            if not name.lower().endswith(IMG_EXTENSIONS):
                continue
            paths.append(os.path.join(cdir, name))
            labels.append(ci)
    return paths, np.asarray(labels, np.int64), classes


def materialize_shard(manifest, image_size=224):
    """Decode one client's manifest ``{"paths", "y"}`` into arrays."""
    if len(manifest["paths"]):
        x = np.stack([_decode(p, image_size) for p in manifest["paths"]])
    else:
        x = np.zeros((0, image_size, image_size, 3), np.float32)
    return {"x": x, "y": np.asarray(manifest["y"], np.int64)}


def load_imagenet_federated(data_dir, client_num=10, partition="hetero",
                            partition_alpha=0.5, image_size=224,
                            materialize=True, seed=0):
    """ImageNet from ``train/`` and ``val/`` ImageFolder trees: the train
    set split ``homo`` or by LDA (``partition_alpha``), the validation
    set homogeneously (seed + 1)."""
    train_dir, val_dir = (os.path.join(data_dir, s) for s in ("train", "val"))
    if not (os.path.isdir(train_dir) and os.path.isdir(val_dir)):
        raise FileNotFoundError(
            f"expected ImageFolder layout {data_dir}/{{train,val}}/<class>/; "
            "see `python -m fedml_tpu_torch.data.prepare layout imagenet`")
    paths, y, classes = _scan_imagefolder(train_dir)
    test_paths, y_test, _ = _scan_imagefolder(val_dir)
    class_num = len(classes)

    if partition == "homo":
        parts = homo_partition(len(y), client_num, seed)
    else:
        parts = non_iid_partition_with_dirichlet_distribution(
            y, client_num, class_num, partition_alpha, seed=seed)
    test_parts = homo_partition(len(y_test), client_num, seed + 1)

    def shard(idx, src_paths, src_y):
        m = {"paths": [src_paths[i] for i in idx], "y": src_y[idx]}
        return materialize_shard(m, image_size) if materialize else m

    train_local = {c: shard(parts[c], paths, y) for c in range(client_num)}
    test_local = {c: shard(test_parts[c], test_paths, y_test)
                  for c in range(client_num)}
    train_global = {"paths": paths, "y": y}
    test_global = {"paths": test_paths, "y": y_test}
    if materialize:
        train_global = materialize_shard(train_global, image_size)
        test_global = materialize_shard(test_global, image_size)
    local_num = {c: len(train_local[c]["y"]) for c in range(client_num)}
    return [len(y), len(y_test), train_global, test_global,
            local_num, train_local, test_local, class_num]


def _read_user_csv(path):
    """A Landmarks split csv (``user_id,image_id,class``) -> ``{user:
    [(image_id, class), ...]}`` in file order."""
    users = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            users.setdefault(row["user_id"], []).append(
                (row["image_id"], int(row["class"])))
    return users


def load_landmarks_federated(data_dir, split="gld23k", image_size=224,
                             materialize=True, client_num=None, seed=0):
    """Google Landmarks keyed by photographer: ``<split>_user_dict.csv``
    maps ``images/<image_id>.jpg`` to clients (users sorted, the first
    ``client_num``), classes remapped to 0..K-1. The test set is
    ``<split>_test.csv`` where it exists (its rows of known classes),
    else the last ``max(1, min shard // 5)`` images of each client, held
    out of its train shard. ``seed`` is accepted for the registry's
    signature and unused."""
    csv_path = os.path.join(data_dir, f"{split}_user_dict.csv")
    img_dir = os.path.join(data_dir, "images")
    if not os.path.isfile(csv_path):
        raise FileNotFoundError(
            f"{csv_path} not found; see `python -m "
            "fedml_tpu_torch.data.prepare layout landmarks`")
    users = _read_user_csv(csv_path)
    user_ids = sorted(users)
    if client_num is not None:
        user_ids = user_ids[:client_num]

    all_classes = sorted({cls for u in user_ids for _, cls in users[u]})
    remap = {c: i for i, c in enumerate(all_classes)}

    def shard(pairs):
        m = {"paths": [os.path.join(img_dir, f"{img}.jpg")
                       for img, _ in pairs],
             "y": np.asarray([remap[c] for _, c in pairs], np.int64)}
        return materialize_shard(m, image_size) if materialize else m

    test_csv = os.path.join(data_dir, f"{split}_test.csv")
    train_pairs = {u: users[u] for u in user_ids}
    if os.path.isfile(test_csv):
        pairs = [(img, c) for items in _read_user_csv(test_csv).values()
                 for img, c in items if c in remap]
        test_global = shard(pairs)
    else:
        k = max(1, min(len(users[u]) for u in user_ids) // 5)
        test_global = shard([p for u in user_ids for p in users[u][-k:]])
        train_pairs = {u: users[u][:-k] for u in user_ids}
    train_local = {i: shard(train_pairs[u]) for i, u in enumerate(user_ids)}
    test_local = {i: None for i in range(len(user_ids))}
    local_num = {i: len(train_local[i]["y"]) for i in range(len(user_ids))}
    # the clients carry the data: no pooled train set is decoded
    return [sum(local_num.values()), len(test_global["y"]), None,
            test_global, local_num, train_local, test_local,
            len(all_classes)]


__all__ = ["IMG_EXTENSIONS", "materialize_shard", "load_imagenet_federated",
           "load_landmarks_federated"]
