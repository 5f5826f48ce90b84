"""StackOverflow federated data (counterpart of
``fedml_tpu/data/stackoverflow.py``; numpy, byte-equal): next-word
prediction (``nwp``) and tag prediction (``lr``) from the TFF h5 export
(``stackoverflow_{train,test}.h5``, ``examples/<cid>/tokens|title|tags``)
with the word and tag vocabularies ``stackoverflow.word_count`` and
``stackoverflow.tag_count`` (most common first, one token a line).

The reference's tokenizer gives an out-of-vocabulary word the id
``V + 4`` (its oov id ``V + 3`` shifted by one like every word), one past
the model's extended vocabulary of ``V + 4`` rows (ids ``0 .. V + 3``):
the reference's model returns NaN logits there, and on the card an
out-of-range embedding row is a device-side assert that ends the CUDA
context. :func:`tokens_to_ids` keeps the reference's ids byte for byte;
:func:`check_nwp_ids` refuses such ids on the host, and
:func:`load_stackoverflow` runs it before anything reaches a device.
"""

from __future__ import annotations

import collections
import os

import numpy as np

SEQUENCE_LENGTH = 20
DEFAULT_VOCAB_SIZE = 10000
DEFAULT_TAG_SIZE = 500
PAD_ID = 0


def load_word_vocab(data_dir, vocab_size=DEFAULT_VOCAB_SIZE):
    """``{word: rank}`` of the ``vocab_size`` most common words."""
    path = os.path.join(data_dir, "stackoverflow.word_count")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"vocab file not found: {path}. Use dataset='synthetic_sequences' "
            "in this zero-egress environment.")
    words = []
    with open(path) as f:
        for line in f:
            words.append(line.split()[0])
            if len(words) >= vocab_size:
                break
    return {w: i for i, w in enumerate(words)}


def load_tag_vocab(data_dir, tag_size=DEFAULT_TAG_SIZE):
    """``{tag: rank}`` of the ``tag_size`` most common tags."""
    path = os.path.join(data_dir, "stackoverflow.tag_count")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"tag vocab file not found: {path}")
    tags = []
    with open(path) as f:
        for line in f:
            tags.append(line.split()[0])
            if len(tags) >= tag_size:
                break
    return {t: i for i, t in enumerate(tags)}


def tokens_to_ids(sentence, vocab, seq_len=SEQUENCE_LENGTH):
    """bos + word ids + eos, truncated and padded to ``seq_len + 1`` (the
    reference's ids: a word of rank r is ``r + 1``, bos ``V + 1``, eos
    ``V + 2``, an unknown word ``V + 4``)."""
    V = len(vocab)
    bos, eos, oov = V + 1, V + 2, V + 3
    ids = [bos] + [vocab.get(w, oov) + 1 for w in sentence.split()]
    ids = ids[:seq_len] + [eos]
    ids = ids[:seq_len + 1]
    ids += [PAD_ID] * (seq_len + 1 - len(ids))
    return ids


def check_nwp_ids(x, y, vocab_size):
    """Raise ``ValueError`` when a token id of ``x`` or ``y`` falls outside
    the model's extended vocabulary (``vocab_size + 4`` rows): the
    reference's out-of-vocabulary id ``vocab_size + 4``."""
    limit = vocab_size + 4
    for name, a in (("x", x), ("y", y)):
        a = np.asarray(a)
        if a.size and int(a.max()) >= limit:
            n = int((a >= limit).sum())
            raise ValueError(
                f"stackoverflow nwp: {n} token id(s) of {name} reach "
                f"{int(a.max())} >= {limit}, past the model's extended "
                f"vocabulary (ids 0..{limit - 1}). The reference's tokenizer "
                f"gives an out-of-vocabulary word the id {vocab_size} + 4 "
                "(its oov id V + 3, shifted by one), where its model "
                "returns NaN; the port refuses it on the host")


def load_stackoverflow(data_dir, task="nwp", client_num=None,
                       vocab_size=DEFAULT_VOCAB_SIZE,
                       tag_size=DEFAULT_TAG_SIZE):
    """The 8-tuple of the h5 export: ``nwp`` gives ``x [n, 20]`` int32 and
    ``y [n, 20]`` int64 next-word ids (class count ``vocab_size + 4``);
    ``lr`` gives bag-of-words counts ``x [n, V]`` over body and title and
    multi-hot tags ``y [n, tags]`` (float32; class count ``tag_size``).
    A client absent from the test split gets an empty test shard. The
    nwp ids are checked by :func:`check_nwp_ids`."""
    import h5py

    train_path = os.path.join(data_dir, "stackoverflow_train.h5")
    test_path = os.path.join(data_dir, "stackoverflow_test.h5")
    for p in (train_path, test_path):
        if not os.path.isfile(p):
            raise FileNotFoundError(
                f"stackoverflow h5 not found: {p}. Use "
                "dataset='synthetic_sequences' in this zero-egress "
                "environment.")
    vocab = load_word_vocab(data_dir, vocab_size)
    tags = load_tag_vocab(data_dir, tag_size) if task == "lr" else None

    def encode_client(h5, cid):
        g = h5["examples"][cid]
        sents = [t.decode("utf8") for t in g["tokens"][()]]
        if task == "nwp":
            seqs = np.asarray([tokens_to_ids(s, vocab) for s in sents],
                              np.int32)
            if len(seqs) == 0:
                return (np.zeros((0, SEQUENCE_LENGTH), np.int32),
                        np.zeros((0, SEQUENCE_LENGTH), np.int64))
            return seqs[:, :-1], seqs[:, 1:].astype(np.int64)
        titles = [t.decode("utf8") for t in g["title"][()]]
        tag_strs = [t.decode("utf8") for t in g["tags"][()]]
        x = np.zeros((len(sents), len(vocab)), np.float32)
        y = np.zeros((len(sents), len(tags)), np.float32)
        for i, (s, ti, tg) in enumerate(zip(sents, titles, tag_strs)):
            cnt = collections.Counter(
                w for w in (s + " " + ti).split() if w in vocab)
            for w, c in cnt.items():
                x[i, vocab[w]] = c
            for t in tg.split("|"):
                if t in tags:
                    y[i, tags[t]] = 1.0
        return x, y

    train_local, test_local, train_num = {}, {}, {}
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    with h5py.File(train_path, "r") as train_h5, \
            h5py.File(test_path, "r") as test_h5:
        train_ids = sorted(train_h5["examples"].keys())
        test_ids = set(test_h5["examples"].keys())
        if client_num is not None:
            train_ids = train_ids[:client_num]
        for i, cid in enumerate(train_ids):
            xt, yt = encode_client(train_h5, cid)
            if cid in test_ids:
                xe, ye = encode_client(test_h5, cid)
            else:
                xe, ye = xt[:0], yt[:0]
            train_local[i] = {"x": xt, "y": yt}
            test_local[i] = {"x": xe, "y": ye}
            train_num[i] = len(yt)
            xs_tr.append(xt)
            ys_tr.append(yt)
            xs_te.append(xe)
            ys_te.append(ye)
    x_train, y_train = np.concatenate(xs_tr), np.concatenate(ys_tr)
    x_test, y_test = np.concatenate(xs_te), np.concatenate(ys_te)
    if task == "nwp":
        check_nwp_ids(x_train, y_train, vocab_size)
        check_nwp_ids(x_test, y_test, vocab_size)
    class_num = (vocab_size + 4) if task == "nwp" else tag_size
    return [len(y_train), len(y_test),
            {"x": x_train, "y": y_train}, {"x": x_test, "y": y_test},
            train_num, train_local, test_local, class_num]


__all__ = ["SEQUENCE_LENGTH", "DEFAULT_VOCAB_SIZE", "DEFAULT_TAG_SIZE",
           "PAD_ID", "load_word_vocab", "load_tag_vocab", "tokens_to_ids",
           "check_nwp_ids", "load_stackoverflow"]
