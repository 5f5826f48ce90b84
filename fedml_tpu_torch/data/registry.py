"""Dataset registry (counterpart of ``fedml_tpu/data/registry.py``): the
synthetic sets, the CIFAR family, Shakespeare (TFF h5 and LEAF JSON) and
StackOverflow (``stackoverflow_nwp``, ``stackoverflow_lr``; TFF h5) from
local files. Every other name of
the reference's registry raises, naming the ROADMAP item it waits for."""

from __future__ import annotations

#: names of the reference's registry not ported yet, with their item
_UNPORTED = {
    "synthetic_segmentation": "A14 (fedseg)", "pascal_voc": "A14 (fedseg)",
    "coco_seg": "A14 (fedseg)", "mnist": "A14 (the LEAF loaders)",
    "femnist": "A14 (the TFF h5 loaders)",
    "fed_emnist": "A14 (the TFF h5 loaders)",
    "fed_cifar100": "A14 (the TFF h5 loaders)",
    "imagenet": "A14 (the image-folder loaders)",
    "ILSVRC2012": "A14 (the image-folder loaders)",
    "gld23k": "A14 (the image-folder loaders)",
    "gld160k": "A14 (the image-folder loaders)",
}


def load_dataset(args, dataset_name):
    """The 8-tuple dataset contract of ``dataset_name`` from ``args``
    (``client_num_in_total``, ``partition_method``, ``partition_alpha``,
    ``data_dir``, ``seed``, and the synthetic sets' ``n_train``,
    ``n_test``, ``image_size`` overrides)."""
    client_num = getattr(args, "client_num_in_total", 10)
    partition = getattr(args, "partition_method", "hetero")
    alpha = getattr(args, "partition_alpha", 0.5)
    data_dir = getattr(args, "data_dir", None)
    seed = getattr(args, "seed", 0)

    from fedml_tpu_torch.data import synthetic

    size_kw = {}
    for k in ("n_train", "n_test", "image_size"):
        v = getattr(args, k, None)
        if v is not None:
            size_kw[k] = v

    if dataset_name == "synthetic":
        size_kw.pop("image_size", None)
        return synthetic.load_synthetic_federated(
            client_num=client_num, partition=partition,
            partition_alpha=alpha, seed=seed, **size_kw)
    if dataset_name == "synthetic_images":
        return synthetic.load_synthetic_images(
            client_num=client_num, partition=partition,
            partition_alpha=alpha, seed=seed, **size_kw)
    if dataset_name == "synthetic_sequences":
        size_kw.pop("image_size", None)
        return synthetic.load_synthetic_sequences(
            client_num=client_num, seed=seed, **size_kw)
    if dataset_name in ("cifar10", "cifar100", "cinic10"):
        from fedml_tpu_torch.data.cifar import load_cifar_federated
        return load_cifar_federated(
            dataset_name, data_dir, client_num=client_num,
            partition=partition, partition_alpha=alpha, seed=seed)
    if dataset_name in ("shakespeare", "fed_shakespeare"):
        from fedml_tpu_torch.data.shakespeare import load_shakespeare
        return load_shakespeare(data_dir, client_num=client_num,
                                leaf=(dataset_name == "shakespeare"))
    if dataset_name in ("stackoverflow_nwp", "stackoverflow_lr"):
        from fedml_tpu_torch.data.stackoverflow import load_stackoverflow
        return load_stackoverflow(data_dir, task=dataset_name.split("_")[1],
                                  client_num=client_num)
    if dataset_name in _UNPORTED:
        raise NotImplementedError(
            f"dataset {dataset_name!r} waits for ROADMAP "
            f"{_UNPORTED[dataset_name]}")
    raise ValueError(f"unknown dataset: {dataset_name}")


__all__ = ["load_dataset"]
