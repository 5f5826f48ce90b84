"""Dataset registry (counterpart of ``fedml_tpu/data/registry.py``): the
synthetic sets, LEAF MNIST (``mnist``), the CIFAR family, the TFF h5
sets (``femnist``/``fed_emnist``, ``fed_cifar100``), Shakespeare (TFF h5
and LEAF JSON), StackOverflow (``stackoverflow_nwp``,
``stackoverflow_lr``; TFF h5) and the image folders
(``imagenet``/``ILSVRC2012``, ``gld23k``/``gld160k``) and the
segmentation sets (``synthetic_segmentation``, and ``pascal_voc`` /
``coco_seg`` from a VOC tree) from local files, with the reference's
defaults."""

from __future__ import annotations


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
    if dataset_name == "synthetic_segmentation":
        return synthetic.load_synthetic_segmentation(
            client_num=client_num, seed=seed, **size_kw)
    if dataset_name in ("pascal_voc", "coco_seg"):
        from fedml_tpu_torch.data.voc import load_voc_federated
        return load_voc_federated(
            data_dir, client_num=client_num, partition=partition,
            partition_alpha=alpha,
            image_size=getattr(args, "image_size", None) or 513, seed=seed)
    if dataset_name == "mnist":
        from fedml_tpu_torch.data.leaf import load_leaf_mnist
        return load_leaf_mnist(data_dir, client_num=client_num, seed=seed)
    if dataset_name in ("cifar10", "cifar100", "cinic10"):
        from fedml_tpu_torch.data.cifar import load_cifar_federated
        return load_cifar_federated(
            dataset_name, data_dir, client_num=client_num,
            partition=partition, partition_alpha=alpha, seed=seed)
    if dataset_name in ("femnist", "fed_emnist"):
        from fedml_tpu_torch.data.tff_h5 import load_fed_emnist
        return load_fed_emnist(data_dir, client_num=client_num)
    if dataset_name == "fed_cifar100":
        from fedml_tpu_torch.data.tff_h5 import load_fed_cifar100
        return load_fed_cifar100(data_dir, client_num=client_num)
    if dataset_name in ("shakespeare", "fed_shakespeare"):
        from fedml_tpu_torch.data.shakespeare import load_shakespeare
        return load_shakespeare(data_dir, client_num=client_num,
                                leaf=(dataset_name == "shakespeare"))
    if dataset_name in ("stackoverflow_nwp", "stackoverflow_lr"):
        from fedml_tpu_torch.data.stackoverflow import load_stackoverflow
        return load_stackoverflow(data_dir, task=dataset_name.split("_")[1],
                                  client_num=client_num)
    if dataset_name in ("imagenet", "ILSVRC2012"):
        from fedml_tpu_torch.data.imagefolder import load_imagenet_federated
        return load_imagenet_federated(
            data_dir, client_num=client_num, partition=partition,
            partition_alpha=alpha,
            image_size=getattr(args, "image_size", None) or 224, seed=seed)
    if dataset_name in ("gld23k", "gld160k"):
        from fedml_tpu_torch.data.imagefolder import load_landmarks_federated
        return load_landmarks_federated(
            data_dir, split=dataset_name,
            image_size=getattr(args, "image_size", None) or 224,
            client_num=client_num, seed=seed)
    raise ValueError(f"unknown dataset: {dataset_name}")


__all__ = ["load_dataset"]
