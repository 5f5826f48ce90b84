"""Vertical-FL finance datasets: Lending Club loans and NUS-WIDE
(counterpart of ``fedml_tpu/data/vertical_finance.py``).

The reference's loaders read their files through pandas
(``lending_club_dataset.py:141-187``: a two- or three-party column split
over the processed loan CSV, 80/20 train split; ``nus_wide_dataset.py:
23-100``: party A the 634-d low-level image features, party B the 1k tag
vector, labels from the selected categories). The card's machine has no
pandas, so this module parses with ``csv`` and numpy and gives the arrays
pandas gives: empty fields and pandas' NA strings become NaN, a short row
is padded with NaN and a long one refused, blank lines are skipped,
whitespace-separated files split as ``str.split`` does, and
``dropna(axis=1)`` drops every column holding a NaN (such as the empty
last column of tab-separated rows ending in a tab). Columns are taken by
name where present. The feature-group column names are the reference's
schema (``lending_club_feature_group.py``); they are data, not design.
A loader whose files are absent raises :class:`MissingDataError`;
``load_synthetic_vertical`` is the always-available stand-in.
"""

from __future__ import annotations

import csv
import os

import numpy as np

# Lending-club feature groups (schema of lending_club_feature_group.py).
QUALIFICATION_FEAT = [
    "grade", "emp_length", "home_ownership", "annual_inc_comp",
    "verification_status", "total_rev_hi_lim", "tot_hi_cred_lim",
    "total_bc_limit", "total_il_high_credit_limit"]
LOAN_FEAT = ["loan_amnt", "term", "initial_list_status", "purpose",
             "application_type", "disbursement_method"]
DEBT_FEAT = [
    "int_rate", "installment", "revol_bal", "revol_util", "out_prncp",
    "recoveries", "dti", "dti_joint", "tot_coll_amt", "mths_since_rcnt_il",
    "total_bal_il", "il_util", "max_bal_bc", "all_util", "bc_util",
    "total_bal_ex_mort", "revol_bal_joint", "mo_sin_old_il_acct",
    "mo_sin_old_rev_tl_op", "mo_sin_rcnt_rev_tl_op", "mort_acc",
    "num_rev_tl_bal_gt_0", "percent_bc_gt_75"]
REPAYMENT_FEAT = [
    "num_sats", "num_bc_sats", "pct_tl_nvr_dlq", "bc_open_to_buy",
    "last_pymnt_amnt", "total_pymnt", "total_pymnt_inv", "total_rec_prncp",
    "total_rec_int", "total_rec_late_fee", "tot_cur_bal", "avg_cur_bal"]
MULTI_ACC_FEAT = [
    "num_il_tl", "num_op_rev_tl", "num_rev_accts", "num_actv_rev_tl",
    "num_tl_op_past_12m", "open_rv_12m", "open_rv_24m", "open_acc_6m",
    "open_act_il", "open_il_12m", "open_il_24m", "total_acc",
    "inq_last_6mths", "open_acc", "inq_fi", "inq_last_12m",
    "acc_open_past_24mths"]
MAL_BEHAVIOR_FEAT = [
    "num_tl_120dpd_2m", "num_tl_30dpd", "num_tl_90g_dpd_24m",
    "pub_rec_bankruptcies", "mths_since_recent_revol_delinq",
    "num_accts_ever_120_pd", "mths_since_recent_bc_dlq",
    "chargeoff_within_12_mths", "collections_12_mths_ex_med",
    "mths_since_last_major_derog", "acc_now_delinq", "pub_rec",
    "mths_since_last_delinq", "delinq_2yrs", "delinq_amnt", "tax_liens"]


#: the strings pandas' ``read_csv`` reads as NaN by default
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"})


class MissingDataError(FileNotFoundError, ValueError):
    """A finance set's files are not under the given path (the port
    fetches nothing; ``load_synthetic_vertical`` needs no files)."""


def _rows(path, sep):
    """The non-blank rows of a text table as lists of fields: ``","`` and
    ``"\t"`` through ``csv`` (quotes as pandas reads them), ``None``
    splitting on runs of whitespace."""
    with open(path, newline="") as f:
        if sep is None:
            rows = [line.split() for line in f]
        else:
            rows = list(csv.reader(f, delimiter=sep))
    return [r for r in rows if r]


def _table(rows, ncols, path, cols=None):
    """Columns ``cols`` (default all) of ``rows`` as a float64 ``[n,
    len(cols)]`` array: NA strings NaN, the fields a short row lacks NaN;
    a row with more than ``ncols`` fields is refused, as pandas' C parser
    refuses it. Only the columns taken are parsed."""
    cols = list(range(ncols)) if cols is None else list(cols)
    out = np.full((len(rows), len(cols)), np.nan)
    for i, row in enumerate(rows):
        if len(row) > ncols:
            raise ValueError(f"{path}: expected {ncols} fields in row "
                             f"{i + 1}, saw {len(row)}")
        for j, c in enumerate(cols):
            if c < len(row) and row[c] not in _NA:
                out[i, j] = float(row[c])
    return out


def _read_bare(path, sep):
    """A headerless table as float64 ``[n, cols]``, the width its first
    row's."""
    rows = _rows(path, sep)
    return _table(rows, len(rows[0]) if rows else 0, path)


def _dropna_cols(table):
    """``DataFrame.dropna(axis=1)``: the columns without a NaN."""
    return table[:, ~np.isnan(table).any(axis=0)]


def _find_processed_csv(data_dir):
    if os.path.isfile(data_dir):
        return data_dir
    if os.path.isdir(data_dir):
        for name in sorted(os.listdir(data_dir)):
            if name.endswith(".csv") and "loan" in name.lower():
                return os.path.join(data_dir, name)
    raise MissingDataError(
        f"no processed loan csv in {data_dir}; run the reference's "
        f"prepare_data pipeline or use load_synthetic_vertical()")


def _split_train_test(parts, y, train_frac=0.8):
    n_train = int(train_frac * len(y))
    train = [p[:n_train] for p in parts] + [y[:n_train]]
    test = [p[n_train:] for p in parts] + [y[n_train:]]
    return train, test


def _loan(data_dir, groups):
    """The loan csv's feature groups (the names each has in the file, in
    the group's order) as float32 blocks and ``target`` as ``y [n, 1]``,
    split 80/20."""
    path = _find_processed_csv(data_dir)
    rows = _rows(path, ",")
    header, data = rows[0], rows[1:]
    if "target" not in header:
        raise KeyError(f"{path}: no 'target' column")
    take = lambda names: _table(
        data, len(header), path,
        [header.index(c) for c in names if c in header]).astype(np.float32)
    parts = [take(g) for g in groups]
    return _split_train_test(parts, take(["target"]))


def loan_load_two_party_data(data_dir):
    """Two-party vertical split: guest A = qualification+loan features (and
    the label), host B = debt/repayment/accounts/behavior features.
    Returns ``([Xa_train, Xb_train, y_train], [Xa_test, Xb_test, y_test])``.
    """
    return _loan(data_dir, [
        QUALIFICATION_FEAT + LOAN_FEAT,
        DEBT_FEAT + REPAYMENT_FEAT + MULTI_ACC_FEAT + MAL_BEHAVIOR_FEAT])


def loan_load_three_party_data(data_dir):
    """Three-party split: A = qualification+loan (guest), B = debt+repayment,
    C = multi-account + malicious-behavior features."""
    return _loan(data_dir, [QUALIFICATION_FEAT + LOAN_FEAT,
                            DEBT_FEAT + REPAYMENT_FEAT,
                            MULTI_ACC_FEAT + MAL_BEHAVIOR_FEAT])


def nus_wide_load_two_party_data(data_dir, selected_labels, neg_label=0,
                                 n_samples=-1, dtype="Train"):
    """NUS-WIDE guest/host split: A = concatenated normalized low-level
    features (634-d), B = 1k tag vector; y in {1, neg_label} -- single-label
    rows only when multiple categories are selected (reference
    ``nus_wide_dataset.py:23-100``)."""
    label_dir = os.path.join(data_dir, "Groundtruth", "TrainTestLabels")
    if not os.path.isdir(label_dir):
        raise MissingDataError(
            f"NUS-WIDE groundtruth not found under {data_dir}; put the "
            f"archive there (reference data/NUS_WIDE/) or use "
            f"load_synthetic_vertical()")
    labels = [_read_bare(os.path.join(label_dir,
                                      f"Labels_{label}_{dtype}.txt"),
                         ",").ravel()
              for label in selected_labels]
    lab = np.stack(labels, 1)
    sel = lab.sum(1) == 1 if len(selected_labels) > 1 else np.ones(
        len(lab), bool)

    feat_dir = os.path.join(data_dir, "Low_Level_Features")
    feats = [_dropna_cols(_read_bare(os.path.join(feat_dir, name), None))
             .astype(np.float32)
             for name in sorted(os.listdir(feat_dir))
             if name.startswith(f"{dtype}_Normalized")]
    xa = np.concatenate(feats, 1)[sel]

    tag_path = os.path.join(data_dir, "NUS_WID_Tags", f"{dtype}_Tags1k.dat")
    xb = _dropna_cols(_read_bare(tag_path, "\t")).astype(np.float32)[sel]

    y = lab[sel].argmax(1).astype(np.float32) if len(selected_labels) > 1 \
        else lab[sel, 0].astype(np.float32)
    y = np.where(y > 0, 1.0, float(neg_label))[:, None]
    if n_samples != -1:
        xa, xb, y = xa[:n_samples], xb[:n_samples], y[:n_samples]
    return xa, xb, y


def load_synthetic_vertical(party_num=2, n=1000, dims=(12, 8), seed=0):
    """Synthetic vertically-partitioned binary task (zero-egress stand-in
    for the finance sets): one feature block per party, label depends on
    all blocks jointly so collaboration beats any single party."""
    rng = np.random.default_rng(seed)
    dims = tuple(dims) + tuple(8 for _ in range(party_num - len(dims)))
    dims = dims[:party_num]
    parts = [rng.normal(size=(n, d)).astype(np.float32) for d in dims]
    logits = sum(p @ rng.normal(size=p.shape[1]) for p in parts)
    y = (logits > 0).astype(np.float32)[:, None]
    return _split_train_test(parts, y)


__all__ = ["QUALIFICATION_FEAT", "LOAN_FEAT", "DEBT_FEAT", "REPAYMENT_FEAT",
           "MULTI_ACC_FEAT", "MAL_BEHAVIOR_FEAT", "MissingDataError",
           "loan_load_two_party_data", "loan_load_three_party_data",
           "nus_wide_load_two_party_data", "load_synthetic_vertical"]
