"""Non-IID data partitioners (host numpy; counterpart of
``fedml_tpu/core/partition.py``, byte-equal for the same seed).

Latent-Dirichlet partition: per class, draw Dirichlet(alpha) proportions
over clients, cap any client already holding ``N / client_num`` samples,
split the class's indices by the cumulative proportions, and retry until
every client has at least ``min_require_size`` samples.
"""

from __future__ import annotations

import numpy as np

DEFAULT_MIN_SAMPLES = 10


def partition_class_samples_with_dirichlet_distribution(
        N, alpha, client_num, idx_batch, idx_k, rng):
    """Split one class's shuffled indices among clients by Dirichlet
    proportions; clients at the fair share ``N/client_num`` get none."""
    rng.shuffle(idx_k)
    proportions = rng.dirichlet(np.repeat(alpha, client_num))
    proportions = np.array(
        [p * (len(idx_j) < N / client_num)
         for p, idx_j in zip(proportions, idx_batch)])
    total = proportions.sum()
    if total > 0:
        proportions = proportions / total
    else:
        # every client already reached the cap: uniform, not NaN cuts
        proportions = np.full(client_num, 1.0 / client_num)
    cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
    idx_batch = [idx_j + idx.tolist()
                 for idx_j, idx in zip(idx_batch, np.split(idx_k, cuts))]
    min_size = min(len(idx_j) for idx_j in idx_batch)
    return idx_batch, min_size


def non_iid_partition_with_dirichlet_distribution(
        label_list, client_num, classes, alpha, task="classification",
        seed=None, min_require_size=DEFAULT_MIN_SAMPLES):
    """LDA partition of sample indices into ``client_num`` shards.

    Returns ``{client_idx: np.ndarray of sample indices}``. Only
    ``task="classification"`` (one label per sample) is ported."""
    if task != "classification":
        raise NotImplementedError(
            "segmentation partitions wait for ROADMAP A14 (fedseg)")
    label_list = np.asarray(label_list)
    rng = np.random.default_rng(seed)
    N = len(label_list)
    if client_num * min_require_size > N:
        raise ValueError(
            f"infeasible partition: {client_num} clients x min "
            f"{min_require_size} samples > {N} total samples")
    min_size = 0
    while min_size < min_require_size:
        idx_batch = [[] for _ in range(client_num)]
        for k in range(classes):
            idx_k = np.where(label_list == k)[0]
            idx_batch, min_size = \
                partition_class_samples_with_dirichlet_distribution(
                    N, alpha, client_num, idx_batch, idx_k, rng)
    net_dataidx_map = {}
    for j in range(client_num):
        rng.shuffle(idx_batch[j])
        net_dataidx_map[j] = np.asarray(idx_batch[j], dtype=np.int64)
    return net_dataidx_map


def homo_partition(n_samples, client_num, seed=None):
    """IID partition: shuffle then equal split."""
    rng = np.random.default_rng(seed)
    idxs = rng.permutation(n_samples)
    return {i: np.sort(part).astype(np.int64)
            for i, part in enumerate(np.array_split(idxs, client_num))}


def hetero_fix_partition(label_list, client_num, seed=None):
    """Shard-by-class partition ("hetero-fix"): sort by label, cut into
    ``2 * client_num`` shards, deal each client two at random."""
    label_list = np.asarray(label_list)
    order = np.argsort(label_list, kind="stable")
    shards = np.array_split(order, client_num * 2)
    rng = np.random.default_rng(seed)
    shard_ids = rng.permutation(len(shards))
    out = {}
    for j in range(client_num):
        picked = [shards[s] for s in shard_ids[2 * j:2 * j + 2]]
        out[j] = np.sort(np.concatenate(picked)).astype(np.int64)
    return out


__all__ = ["non_iid_partition_with_dirichlet_distribution",
           "homo_partition", "hetero_fix_partition"]
