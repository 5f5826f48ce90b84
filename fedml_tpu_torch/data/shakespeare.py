"""Shakespeare next-character data (counterpart of
``fedml_tpu/data/shakespeare.py``; numpy, byte-equal).

The TFF vocabulary of 86 characters with pad 0, then bos/eos and oov:
90 ids. Sequences are padded to ``SEQUENCE_LENGTH + 1`` and split into
(input, shifted target) pairs. :func:`synthetic_shakespeare_clients` is
the LEAF-shaped synthetic population the LM flagship trains on when no
data files are given (``bench.py``'s ``_synthetic_shakespeare_clients``).
The file loaders (TFF h5, LEAF JSON) wait for data files in the repo
(ROADMAP A10).
"""

from __future__ import annotations

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
           "synthetic_shakespeare_clients"]
