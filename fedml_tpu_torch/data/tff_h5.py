"""TFF-exported HDF5 loaders, federated EMNIST and fed CIFAR-100
(counterpart of ``fedml_tpu/data/tff_h5.py``; the same arrays for the
same files).

``fed_emnist_{train,test}.h5`` hold ``examples/<client_id>/pixels|label``
and ``fed_cifar100_{train,test}.h5`` ``examples/<client_id>/image|label``;
each h5 client group is one client. h5py is imported where a file is
opened, so the package imports on a machine without it.
"""

from __future__ import annotations

import os

import numpy as np

from fedml_tpu_torch.data.leaf import clients_to_eight_tuple

_EXAMPLE = "examples"
#: fed CIFAR-100's per-channel statistics and centre crop
CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)
CIFAR100_CROP = 24


def _open_h5(path):
    import h5py
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"TFF h5 file not found: {path}. Lay it out as `python -m "
            "fedml_tpu_torch.data.prepare layout <dataset>` shows, or use "
            "dataset='synthetic_images'.")
    return h5py.File(path, "r")


def _load_tff_pair(data_dir, train_file, test_file, x_key, y_key,
                   client_num=None, x_map=None):
    """The 8-tuple of a TFF train/test h5 pair: clients in sorted id
    order (the first ``client_num``), a client absent from the test file
    with an empty test shard, ``x_map`` applied to each client's
    images."""
    train_h5 = _open_h5(os.path.join(data_dir, train_file))
    test_h5 = _open_h5(os.path.join(data_dir, test_file))
    try:
        train_ids = sorted(train_h5[_EXAMPLE].keys())
        test_ids = set(test_h5[_EXAMPLE].keys())
        if client_num is not None:
            train_ids = train_ids[:client_num]

        clients = []
        for cid in train_ids:
            g = train_h5[_EXAMPLE][cid]
            xt = np.asarray(g[x_key][()], np.float32)
            yt = np.asarray(g[y_key][()], np.int64)
            if x_map is not None:
                xt = x_map(xt)
            if cid in test_ids:
                gt = test_h5[_EXAMPLE][cid]
                xe = np.asarray(gt[x_key][()], np.float32)
                ye = np.asarray(gt[y_key][()], np.int64)
                if x_map is not None:
                    xe = x_map(xe)
            else:
                xe, ye = xt[:0], yt[:0]
            clients.append((xt, yt, xe, ye))
    finally:
        train_h5.close()
        test_h5.close()
    return clients_to_eight_tuple(clients)


def load_fed_emnist(data_dir, client_num=None):
    """3400-client federated EMNIST (62 classes, 28x28)."""
    return _load_tff_pair(data_dir, "fed_emnist_train.h5", "fed_emnist_test.h5",
                          "pixels", "label", client_num)


def fed_cifar100_map(x, crop=CIFAR100_CROP):
    """One client's fed CIFAR-100 images ``[n, 32, 32, 3]`` (fp32) as the
    loader gives them: scaled by 1/255 when the client's maximum is above
    1.5, centre-cropped to ``crop`` and normalised per channel."""
    x = x / 255.0 if x.max() > 1.5 else x
    if crop and x.shape[1] > crop:
        off = (x.shape[1] - crop) // 2
        x = x[:, off:off + crop, off:off + crop, :]
    return ((x - CIFAR100_MEAN) / CIFAR100_STD).astype(np.float32)


def load_fed_cifar100(data_dir, client_num=None, crop=CIFAR100_CROP):
    """500-client federated CIFAR-100, each client's images through
    :func:`fed_cifar100_map`."""
    return _load_tff_pair(data_dir, "fed_cifar100_train.h5",
                          "fed_cifar100_test.h5", "image", "label",
                          client_num,
                          x_map=lambda x: fed_cifar100_map(x, crop))


__all__ = ["load_fed_emnist", "load_fed_cifar100", "fed_cifar100_map"]
