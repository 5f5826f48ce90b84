"""Shakespeare next-character data (counterpart of
``fedml_tpu/data/shakespeare.py``; numpy, byte-equal).

The TFF vocabulary of 86 characters with pad 0, then bos/eos and oov:
90 ids. Sequences are padded to ``SEQUENCE_LENGTH + 1`` and split into
(input, shifted target) pairs. :func:`load_shakespeare` reads the two
file flavors into the 8-tuple: the TFF h5 export (``fed_shakespeare``:
sequence labels ``y [n, T]``) and LEAF JSON (``shakespeare``: one next
character a sample, ``y [n]``).
:func:`synthetic_shakespeare_clients` is the LEAF-shaped synthetic
population the LM flagship trains on when no data files are given
(``bench.py``'s ``_synthetic_shakespeare_clients``).
"""

from __future__ import annotations

import os

import numpy as np

SEQUENCE_LENGTH = 80  # McMahan et al. AISTATS 2017
CHAR_VOCAB = list(
    'dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#\'/37;?bfjnrvzBFJNRVZ"&*.26:\naeimquyAEIMQUY]!%)-159\r'
)
PAD_ID = 0
_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHAR_VOCAB)}
BOS_ID = len(CHAR_VOCAB) + 1
EOS_ID = len(CHAR_VOCAB) + 2
OOV_ID = len(CHAR_VOCAB) + 3
VOCAB_SIZE = len(CHAR_VOCAB) + 4  # 90


def to_ids(sentence, max_seq_len=SEQUENCE_LENGTH):
    """<bos> + char ids + <eos>, truncated/padded to ``max_seq_len + 1``."""
    ids = [BOS_ID] + [_CHAR_TO_ID.get(c, OOV_ID) for c in sentence]
    ids = ids[:max_seq_len] + [EOS_ID]
    ids = ids[:max_seq_len + 1]
    ids += [PAD_ID] * (max_seq_len + 1 - len(ids))
    return ids


def preprocess_snippets(snippets, max_seq_len=SEQUENCE_LENGTH):
    """Snippet strings -> (x [n, T] int32, y [n, T] int64) next-char pairs."""
    seqs = np.asarray([to_ids(s, max_seq_len) for s in snippets], np.int32)
    if len(seqs) == 0:
        return (np.zeros((0, max_seq_len), np.int32),
                np.zeros((0, max_seq_len), np.int64))
    return seqs[:, :-1], seqs[:, 1:].astype(np.int64)


def _eight_tuple(train_local, test_local, train_num, xs_tr, ys_tr, xs_te,
                 ys_te):
    x_train, y_train = np.concatenate(xs_tr), np.concatenate(ys_tr)
    x_test, y_test = np.concatenate(xs_te), np.concatenate(ys_te)
    return [len(y_train), len(y_test),
            {"x": x_train, "y": y_train}, {"x": x_test, "y": y_test},
            train_num, train_local, test_local, VOCAB_SIZE]


def load_shakespeare(data_dir, client_num=None, leaf=False):
    """The 8-tuple of a Shakespeare split under ``data_dir``.
    ``leaf=False`` reads the TFF h5 export (``shakespeare_{train,test}.h5``
    with ``examples/<cid>/snippets``; clients in sorted id order, a
    client absent from the test file gets an empty test shard);
    ``leaf=True`` reads LEAF JSON (``train/``, ``test/``), where x holds
    raw 80-character strings and y the next character. ``client_num``
    keeps the first N clients."""
    if leaf:
        return _load_leaf_shakespeare(data_dir, client_num)

    import h5py
    train_path = os.path.join(data_dir, "shakespeare_train.h5")
    test_path = os.path.join(data_dir, "shakespeare_test.h5")
    for p in (train_path, test_path):
        if not os.path.isfile(p):
            raise FileNotFoundError(
                f"shakespeare h5 not found: {p}. Use "
                "dataset='synthetic_sequences' when the files are absent.")
    train_h5 = h5py.File(train_path, "r")
    test_h5 = h5py.File(test_path, "r")
    try:
        train_ids = sorted(train_h5["examples"].keys())
        test_ids = set(test_h5["examples"].keys())
        if client_num is not None:
            train_ids = train_ids[:client_num]
        train_local, test_local, train_num = {}, {}, {}
        xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
        for i, cid in enumerate(train_ids):
            snips = [s.decode("utf8")
                     for s in train_h5["examples"][cid]["snippets"][()]]
            xt, yt = preprocess_snippets(snips)
            if cid in test_ids:
                snips_te = [s.decode("utf8")
                            for s in test_h5["examples"][cid]["snippets"][()]]
                xe, ye = preprocess_snippets(snips_te)
            else:
                xe, ye = xt[:0], yt[:0]
            train_local[i] = {"x": xt, "y": yt}
            test_local[i] = {"x": xe, "y": ye}
            train_num[i] = len(yt)
            for acc, a in zip((xs_tr, ys_tr, xs_te, ys_te),
                              (xt, yt, xe, ye)):
                acc.append(a)
    finally:
        train_h5.close()
        test_h5.close()
    return _eight_tuple(train_local, test_local, train_num, xs_tr, ys_tr,
                        xs_te, ys_te)


def _load_leaf_shakespeare(data_dir, client_num=None):
    """LEAF JSON Shakespeare: per user, x a list of 80-character strings
    and y the next character of each (ids by the TFF vocabulary, oov for
    anything else)."""
    from fedml_tpu_torch.data.leaf import read_leaf_dir

    train_users, train_data = read_leaf_dir(os.path.join(data_dir, "train"))
    _, test_data = read_leaf_dir(os.path.join(data_dir, "test"))
    users = train_users if client_num is None else train_users[:client_num]

    def encode(xs, ys):
        x = np.asarray([[_CHAR_TO_ID.get(c, OOV_ID) for c in s] for s in xs],
                       np.int32)
        y = np.asarray([_CHAR_TO_ID.get(c[0] if c else "", OOV_ID)
                        for c in ys], np.int64)
        return x, y

    train_local, test_local, train_num = {}, {}, {}
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for i, u in enumerate(users):
        xt, yt = encode(train_data[u]["x"], train_data[u]["y"])
        if u in test_data:
            xe, ye = encode(test_data[u]["x"], test_data[u]["y"])
        else:
            xe, ye = xt[:0], yt[:0]
        train_local[i] = {"x": xt, "y": yt}
        test_local[i] = {"x": xe, "y": ye}
        train_num[i] = len(yt)
        for acc, a in zip((xs_tr, ys_tr, xs_te, ys_te),
                          (xt, yt, xe, ye)):
            acc.append(a)
    return _eight_tuple(train_local, test_local, train_num, xs_tr, ys_tr,
                        xs_te, ys_te)


def synthetic_shakespeare_clients(clients, seq_len=SEQUENCE_LENGTH,
                                  vocab=VOCAB_SIZE, seed=0):
    """LEAF-Shakespeare-shaped synthetic population as the 8-tuple:
    lognormal client sizes (clipped to [2, 400], the role-size skew of
    the real split), x int32 ``[n, T]`` token ids in ``[1, vocab)``, y
    the shifted next-token targets (int64)."""
    rng = np.random.default_rng(seed)
    ns = np.clip(rng.lognormal(mean=2.5, sigma=1.0, size=clients),
                 2, 400).astype(np.int64)
    total = int(ns.sum())
    seqs = rng.integers(1, vocab, (total, seq_len + 1))
    x_all = seqs[:, :-1].astype(np.int32)
    y_all = seqs[:, 1:].astype(np.int64)
    local, local_num, test_local = {}, {}, {}
    off = 0
    for c in range(clients):
        n = int(ns[c])
        local[c] = {"x": x_all[off:off + n], "y": y_all[off:off + n]}
        local_num[c] = n
        test_local[c] = {"x": x_all[off:off + 1], "y": y_all[off:off + 1]}
        off += n
    n_test = min(64, total)
    test = {"x": x_all[:n_test], "y": y_all[:n_test]}
    return [total, n_test, {"x": x_all, "y": y_all}, test, local_num,
            local, test_local, vocab]


__all__ = ["SEQUENCE_LENGTH", "CHAR_VOCAB", "VOCAB_SIZE", "PAD_ID", "BOS_ID",
           "EOS_ID", "OOV_ID", "to_ids", "preprocess_snippets",
           "load_shakespeare", "synthetic_shakespeare_clients"]
