"""Data prepare/verify CLI (counterpart of ``fedml_tpu/data/prepare.py``):
document, validate and fixture the on-disk layouts the file-backed
loaders expect.

Nothing is downloaded: ``layout`` prints the tree a loader expects,
``verify`` proves a directory is laid out right by running the port's
own loader on it, and ``fixture`` writes a tiny schema-valid stand-in
(the same data as the reference's ``prepare fixture`` for the same
dataset and client count) and then verifies it. ``verify`` exits 1 and
prints the layout when the loader refuses the directory. The h5 and
image sets need h5py and PIL, imported where they are used.

Usage:
    python -m fedml_tpu_torch.data.prepare layout  <dataset>
    python -m fedml_tpu_torch.data.prepare verify  <dataset> --data_dir D
    python -m fedml_tpu_torch.data.prepare fixture <dataset> --data_dir D

Datasets: fed_emnist fed_cifar100 leaf_mnist fed_shakespeare
leaf_shakespeare stackoverflow_nwp stackoverflow_lr cifar10 cifar100
cinic10 susy imagenet landmarks
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np

# ---------------------------------------------------------------------------
# layouts (the contract each loader enforces; schema citations in each
# loader module's docstring)

LAYOUTS = {
    "fed_emnist": """\
<data_dir>/
  fed_emnist_train.h5   h5: examples/<client_id>/pixels [n,28,28] f32,
  fed_emnist_test.h5        examples/<client_id>/label  [n] int
Loader: fedml_tpu_torch.data.tff_h5.load_fed_emnist (reference
FederatedEMNIST/data_loader.py:13-66).""",
    "fed_cifar100": """\
<data_dir>/
  fed_cifar100_train.h5  h5: examples/<client_id>/image [n,32,32,3] uint8,
  fed_cifar100_test.h5       examples/<client_id>/label [n] int
Loader: fedml_tpu_torch.data.tff_h5.load_fed_cifar100 (center-crop 24 +
normalize happens in the loader).""",
    "leaf_mnist": """\
<data_dir>/
  train/*.json  each: {"users": [...], "num_samples": [...],
  test/*.json    "user_data": {user: {"x": [[784 floats]...],
                                      "y": [ints]}}}
Loader: fedml_tpu_torch.data.leaf.load_leaf_mnist (reference
MNIST/data_loader.py:86-122).""",
    "fed_shakespeare": """\
<data_dir>/
  shakespeare_train.h5  h5: examples/<client_id>/snippets [n] bytes
  shakespeare_test.h5       (80+-char play snippets, utf8)
Loader: fedml_tpu_torch.data.shakespeare.load_shakespeare (char ids in-loader).""",
    "leaf_shakespeare": """\
<data_dir>/
  train/*.json  LEAF json: user_data[user]["x"] = ["80-char string", ...],
  test/*.json                user_data[user]["y"] = ["next char", ...]
Loader: fedml_tpu_torch.data.shakespeare.load_shakespeare(leaf=True).""",
    "stackoverflow_nwp": """\
<data_dir>/
  stackoverflow_train.h5   h5: examples/<client_id>/tokens|title|tags
  stackoverflow_test.h5        ([n] bytes each; space-separated words,
  stackoverflow.word_count     '|'-separated tags)
                           text: one "<word> <count>" per line, desc freq
Loader: fedml_tpu_torch.data.stackoverflow.load_stackoverflow(task='nwp').""",
    "stackoverflow_lr": """\
<data_dir>/
  stackoverflow_train.h5   (as stackoverflow_nwp, plus:)
  stackoverflow_test.h5
  stackoverflow.word_count
  stackoverflow.tag_count  text: one "<tag> <count>" per line, desc freq
Loader: fedml_tpu_torch.data.stackoverflow.load_stackoverflow(task='lr').""",
    "cifar10": """\
<data_dir>/cifar-10-batches-py/
  data_batch_1 .. data_batch_5, test_batch
  (python pickles: {b'data': [n,3072] uint8 CHW-flat, b'labels': [n]})
Loader: fedml_tpu_torch.data.cifar.load_cifar_federated('cifar10', ...).""",
    "cifar100": """\
<data_dir>/cifar-100-python/
  train, test  (pickles: {b'data': [n,3072], b'fine_labels': [n]})
Loader: fedml_tpu_torch.data.cifar.load_cifar_federated('cifar100', ...).""",
    "cinic10": """\
<data_dir>/cinic10.npz
  (np.savez: x_train [n,32,32,3] f32, y_train [n], x_test, y_test)
Loader: fedml_tpu_torch.data.cifar.load_cifar_federated('cinic10', ...).""",
    "susy": """\
<data_dir>/SUSY.csv
  (UCI format: column 0 = label, 18 float features follow; no header)
Loader: fedml_tpu_torch.data.uci.load_streaming_uci('susy', <path>, ...).""",
    "imagenet": """\
<data_dir>/
  train/<class_name>/<img>.{jpg,png,...}
  val/<class_name>/<img>.{jpg,png,...}
Loader: fedml_tpu_torch.data.imagefolder.load_imagenet_federated.""",
    "landmarks": """\
<data_dir>/
  images/<image_id>.jpg
  <split>_user_dict.csv  (csv header user_id,image_id,class)
  <split>_test.csv       (optional central test split, same columns)
Loader: fedml_tpu_torch.data.imagefolder.load_landmarks_federated
(split defaults to gld23k -> gld23k_user_dict.csv).""",
}


# ---------------------------------------------------------------------------
# verifiers: run the REAL loader (truncated client count where supported)
# and summarize. Any schema violation surfaces as the loader's own error.

def _summarize_8tuple(name, t):
    n_train, n_test = t[0], t[1]
    train_num, class_num = t[4], t[7]
    return (f"{name}: OK -- {len(train_num)} clients, {n_train} train / "
            f"{n_test} test samples, class_num={class_num}")


def _verify_fed_emnist(d, clients):
    from fedml_tpu_torch.data.tff_h5 import load_fed_emnist
    return _summarize_8tuple("fed_emnist", load_fed_emnist(d, clients))


def _verify_fed_cifar100(d, clients):
    from fedml_tpu_torch.data.tff_h5 import load_fed_cifar100
    return _summarize_8tuple("fed_cifar100", load_fed_cifar100(d, clients))


def _verify_leaf_mnist(d, clients):
    from fedml_tpu_torch.data.leaf import load_leaf_mnist
    return _summarize_8tuple("leaf_mnist", load_leaf_mnist(d, clients))


def _verify_fed_shakespeare(d, clients):
    from fedml_tpu_torch.data.shakespeare import load_shakespeare
    return _summarize_8tuple("fed_shakespeare", load_shakespeare(d, clients))


def _verify_leaf_shakespeare(d, clients):
    from fedml_tpu_torch.data.shakespeare import load_shakespeare
    return _summarize_8tuple("leaf_shakespeare",
                             load_shakespeare(d, clients, leaf=True))


def _verify_so(task):
    def fn(d, clients):
        from fedml_tpu_torch.data.stackoverflow import load_stackoverflow
        return _summarize_8tuple(f"stackoverflow_{task}",
                                 load_stackoverflow(d, task, clients))
    return fn


def _verify_cifar(name):
    def fn(d, clients):
        from fedml_tpu_torch.data.cifar import load_cifar_federated
        t = load_cifar_federated(name, d, client_num=clients or 10)
        return _summarize_8tuple(name, t)
    return fn


def _verify_susy(d, clients):
    from fedml_tpu_torch.data.uci import load_streaming_uci
    streams = load_streaming_uci("susy", os.path.join(d, "SUSY.csv"),
                                 clients or 4, sample_num_in_total=64)
    n = sum(len(s["y"]) for s in streams.values())
    return f"susy: OK -- {len(streams)} client streams, {n} samples"


def _verify_imagenet(d, clients):
    from fedml_tpu_torch.data.imagefolder import load_imagenet_federated
    t = load_imagenet_federated(d, client_num=clients or 2, image_size=8)
    return _summarize_8tuple("imagenet", t)


#: registry (train-time) dataset names accepted as aliases, so the name a
#: user verifies is the name they can train with (``data/registry.py``
#: ``load_dataset`` is the single train-time switch; this CLI only adds
#: format-variant names the registry folds into flags)
ALIASES = {"mnist": "leaf_mnist", "femnist": "fed_emnist",
           "shakespeare": "leaf_shakespeare", "ILSVRC2012": "imagenet",
           "gld23k": "landmarks", "gld160k": "landmarks"}


def _verify_landmarks(d, clients):
    from fedml_tpu_torch.data.imagefolder import load_landmarks_federated
    t = load_landmarks_federated(d, image_size=8, client_num=clients)
    return _summarize_8tuple("landmarks", t)


# ---------------------------------------------------------------------------
# fixture writers: tiny schema-valid stand-ins

def _h5():
    import h5py
    return h5py


def _fx_tff(d, file_prefix, x_key, x_shape, x_dtype, n_clients, rng):
    h5py = _h5()
    os.makedirs(d, exist_ok=True)
    for split, per in (("train", 6), ("test", 3)):
        with h5py.File(os.path.join(d, f"{file_prefix}_{split}.h5"),
                       "w") as f:
            g = f.create_group("examples")
            for c in range(n_clients):
                cg = g.create_group(f"f{c:04d}")
                if x_dtype == np.uint8:
                    x = rng.integers(0, 256, (per,) + x_shape, np.uint8)
                else:
                    x = rng.random((per,) + x_shape, np.float32)
                cg.create_dataset(x_key, data=x)
                cg.create_dataset(
                    "label", data=rng.integers(0, 10, (per,), np.int64))


def _fx_fed_emnist(d, n_clients, rng):
    _fx_tff(d, "fed_emnist", "pixels", (28, 28), np.float32, n_clients, rng)


def _fx_fed_cifar100(d, n_clients, rng):
    _fx_tff(d, "fed_cifar100", "image", (32, 32, 3), np.uint8,
            n_clients, rng)


def _fx_leaf_mnist(d, n_clients, rng):
    for split, per in (("train", 5), ("test", 2)):
        os.makedirs(os.path.join(d, split), exist_ok=True)
        users = [f"u{c:03d}" for c in range(n_clients)]
        blob = {"users": users, "num_samples": [per] * n_clients,
                "user_data": {
                    u: {"x": rng.random((per, 784)).round(4).tolist(),
                        "y": rng.integers(0, 10, per).tolist()}
                    for u in users}}
        with open(os.path.join(d, split, "all_data.json"), "w") as f:
            json.dump(blob, f)


def _fx_fed_shakespeare(d, n_clients, rng):
    h5py = _h5()
    os.makedirs(d, exist_ok=True)
    text = ("ROMEO. It is my lady, O it is my love, that thou her maid "
            "art far more fair than she be not her maid since she is "
            "envious grief strike sir hence away ")
    for split, per in (("train", 4), ("test", 2)):
        with h5py.File(os.path.join(d, f"shakespeare_{split}.h5"),
                       "w") as f:
            g = f.create_group("examples")
            for c in range(n_clients):
                cg = g.create_group(f"bard{c:03d}")
                snips = [text[i:i + 90].encode("utf8")
                         for i in rng.integers(0, len(text) - 90, per)]
                cg.create_dataset("snippets", data=snips)


def _fx_leaf_shakespeare(d, n_clients, rng):
    text = ("what light through yonder window breaks it is the east and "
            "juliet is the sun arise fair sun and kill the envious moon ")
    for split, per in (("train", 4), ("test", 2)):
        os.makedirs(os.path.join(d, split), exist_ok=True)
        users = [f"bard{c:03d}" for c in range(n_clients)]
        ud = {}
        for u in users:
            starts = rng.integers(0, len(text) - 81, per)
            ud[u] = {"x": [text[i:i + 80] for i in starts],
                     "y": [text[i + 80] for i in starts]}
        blob = {"users": users, "num_samples": [per] * n_clients,
                "user_data": ud}
        with open(os.path.join(d, split, "all_data.json"), "w") as f:
            json.dump(blob, f)


_SO_WORDS = ("the to how a i in of and is python file java with for on "
             "use get my code can data value error string not function "
             "this it if using way what have from").split()
_SO_TAGS = "python java javascript c# php android html jquery c++ css".split()


def _fx_stackoverflow(d, n_clients, rng):
    h5py = _h5()
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "stackoverflow.word_count"), "w") as f:
        for i, w in enumerate(_SO_WORDS):
            f.write(f"{w} {1000 - i}\n")
    with open(os.path.join(d, "stackoverflow.tag_count"), "w") as f:
        for i, t in enumerate(_SO_TAGS):
            f.write(f"{t} {500 - i}\n")
    for split, per in (("train", 4), ("test", 2)):
        with h5py.File(os.path.join(d, f"stackoverflow_{split}.h5"),
                       "w") as f:
            g = f.create_group("examples")
            for c in range(n_clients):
                cg = g.create_group(f"user{c:05d}")
                sents, titles, tags = [], [], []
                for _ in range(per):
                    k = rng.integers(4, 12)
                    words = rng.choice(_SO_WORDS, k)
                    sents.append(" ".join(words).encode("utf8"))
                    titles.append(" ".join(words[:3]).encode("utf8"))
                    tags.append("|".join(
                        rng.choice(_SO_TAGS, 2)).encode("utf8"))
                cg.create_dataset("tokens", data=sents)
                cg.create_dataset("title", data=titles)
                cg.create_dataset("tags", data=tags)


def _fx_cifar10(d, n_clients, rng):
    base = os.path.join(d, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    # the LDA partitioner needs >= 10 samples per client (with slack for
    # the skewed draw); _verify_cifar loads with (clients or 10) clients,
    # so size for whichever is larger
    per = max(40, 8 * max(n_clients, 10))
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        blob = {b"data": rng.integers(0, 256, (per, 3072), np.uint8),
                b"labels": rng.integers(0, 10, per).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(blob, f)


def _fx_cifar100(d, n_clients, rng):
    base = os.path.join(d, "cifar-100-python")
    os.makedirs(base, exist_ok=True)
    n_tr = max(200, 40 * max(n_clients, 10))
    for name, per in (("train", n_tr), ("test", n_tr // 5)):
        blob = {b"data": rng.integers(0, 256, (per, 3072), np.uint8),
                b"fine_labels": rng.integers(0, 100, per).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(blob, f)


def _fx_cinic10(d, n_clients, rng):
    os.makedirs(d, exist_ok=True)
    n_tr = max(160, 16 * max(n_clients, 10))
    np.savez(os.path.join(d, "cinic10.npz"),
             x_train=rng.random((n_tr, 32, 32, 3)).astype(np.float32),
             y_train=rng.integers(0, 10, n_tr),
             x_test=rng.random((n_tr // 4, 32, 32, 3)).astype(np.float32),
             y_test=rng.integers(0, 10, n_tr // 4))


def _fx_susy(d, n_clients, rng):
    os.makedirs(d, exist_ok=True)
    n = max(128, 16 * n_clients)
    rows = np.concatenate(
        [rng.integers(0, 2, (n, 1)).astype(np.float32),
         rng.random((n, 18), np.float32)], axis=1)
    np.savetxt(os.path.join(d, "SUSY.csv"), rows, delimiter=",", fmt="%.6f")


def _write_png(path, rng):
    from PIL import Image
    Image.fromarray(
        rng.integers(0, 256, (8, 8, 3), np.uint8), "RGB").save(path)


def _fx_imagenet(d, n_clients, rng):
    # >= 10 train samples per client must be feasible for the LDA
    # partitioner's min-size retry loop (core/partition.py); scale with
    # the requested client count
    per_train = max(16, 8 * n_clients)
    for split, per in (("train", per_train), ("val", per_train // 4)):
        for cls in ("n01440764", "n01443537"):
            cdir = os.path.join(d, split, cls)
            os.makedirs(cdir, exist_ok=True)
            for i in range(per):
                _write_png(os.path.join(cdir, f"img_{i}.png"), rng)


def _fx_landmarks(d, n_clients, rng):
    img_dir = os.path.join(d, "images")
    os.makedirs(img_dir, exist_ok=True)
    rows = []
    k = 0
    for u in range(n_clients):
        for _ in range(4):
            img = f"im{k:05d}"
            # landmarks images ship as .jpg; PIL picks format from suffix
            _write_png(os.path.join(img_dir, img + ".jpg"), rng)
            rows.append((f"u{u:03d}", img, int(rng.integers(0, 3))))
            k += 1
    with open(os.path.join(d, "gld23k_user_dict.csv"), "w") as f:
        f.write("user_id,image_id,class\n")
        for u, img, c in rows:
            f.write(f"{u},{img},{c}\n")


DATASETS = {
    "fed_emnist": (_verify_fed_emnist, _fx_fed_emnist),
    "fed_cifar100": (_verify_fed_cifar100, _fx_fed_cifar100),
    "leaf_mnist": (_verify_leaf_mnist, _fx_leaf_mnist),
    "fed_shakespeare": (_verify_fed_shakespeare, _fx_fed_shakespeare),
    "leaf_shakespeare": (_verify_leaf_shakespeare, _fx_leaf_shakespeare),
    "stackoverflow_nwp": (_verify_so("nwp"), _fx_stackoverflow),
    "stackoverflow_lr": (_verify_so("lr"), _fx_stackoverflow),
    "cifar10": (_verify_cifar("cifar10"), _fx_cifar10),
    "cifar100": (_verify_cifar("cifar100"), _fx_cifar100),
    "cinic10": (_verify_cifar("cinic10"), _fx_cinic10),
    "susy": (_verify_susy, _fx_susy),
    "imagenet": (_verify_imagenet, _fx_imagenet),
    "landmarks": (_verify_landmarks, _fx_landmarks),
}
assert set(DATASETS) == set(LAYOUTS)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m fedml_tpu_torch.data.prepare",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=("layout", "verify", "fixture"))
    p.add_argument("dataset", choices=sorted(DATASETS) + sorted(ALIASES))
    p.add_argument("--data_dir", default=None,
                   help="dataset root (required for verify/fixture)")
    p.add_argument("--clients", type=int, default=None,
                   help="verify: truncate to N clients (fast check); "
                        "fixture: clients to generate (default 3)")
    args = p.parse_args(argv)
    args.dataset = ALIASES.get(args.dataset, args.dataset)

    if args.command == "layout":
        print(f"# expected layout for {args.dataset}\n{LAYOUTS[args.dataset]}")
        return 0
    if args.data_dir is None:
        p.error(f"--data_dir is required for {args.command}")
    verify_fn, fixture_fn = DATASETS[args.dataset]
    if args.command == "fixture":
        rng = np.random.default_rng(0)
        fixture_fn(args.data_dir, args.clients or 3, rng)
        print(f"wrote {args.dataset} fixture under {args.data_dir}")
    # verify always runs (fixture immediately proves itself loadable);
    # loader schema errors (missing keys, infeasible partitions, bad
    # shapes) surface as INVALID + the documented layout, not a traceback
    try:
        print(verify_fn(args.data_dir, args.clients))
    except (FileNotFoundError, ValueError, KeyError, OSError) as e:
        print(f"INVALID: {type(e).__name__}: {e}", file=sys.stderr)
        print(f"expected layout:\n{LAYOUTS[args.dataset]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
