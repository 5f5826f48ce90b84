"""Compressed federated rounds (counterpart of
``fedml_tpu/compression/integration.py``).

The plain host-packed round (``parallel/engine.py make_sim_round``)
trains the cohort over a client axis and weight-averages the payloads.
The compressed round inserts, per client, the client->server half of the
wire:

    delta_k   = local_params_k - global_params
    enc_k     = compress(delta_k + residual_k)        (client-side, EF)
    recon_k   = global_params + decompress(enc_k)     (the server's view)
    residual' = (delta_k + residual_k) - decompress(enc_k)

and feeds the *reconstructed* states through the usual aggregator hooks,
so FedOpt, robust FedAvg and FedNova compose unchanged. Only ``params``
is compressed; ``batch_stats`` average at full fidelity. Residuals are
carried per client across rounds by :class:`ResidualStore`, keyed by
stable client id.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.compression.codec import tree_wire_nbytes
from fedml_tpu_torch.compression.compressors import (Compressor,
                                                     ErrorFeedback,
                                                     NoneCompressor,
                                                     tree_map)
from fedml_tpu_torch.observability.tracing import get_tracer


def ef_reconstruct(ef: ErrorFeedback, local_states, global_state,
                   residuals, seeds):
    """The wire half of K stacked clients: EF-compress each client's
    params delta plus its residual (``residuals`` leaves ``[K, ...]``,
    ``seeds [K]`` the clients' compression seeds) and return ``(recon,
    new_residuals)``, ``recon`` the local states with the server's
    reconstruction of their params. The identity's reconstruction is the
    local params plus the (zero) residual itself, so ``none`` is the
    plain round bit for bit (``g + (l - g)`` may differ from ``l`` in the
    last bit)."""
    gp = global_state["params"]
    lp = local_states["params"]
    delta = {k: lp[k] - gp[k] for k in gp}
    _, dec, new_residuals = ef.step(delta, residuals, gp, seeds)
    recon = dict(local_states)
    if isinstance(ef.compressor, NoneCompressor):
        recon["params"] = {k: lp[k] + residuals[k] for k in gp}
    else:
        recon["params"] = {k: gp[k] + dec[k] for k in gp}
    return recon, new_residuals


def make_compressed_sim_round(spec, cfg, compressor: Compressor,
                              payload_fn=None, server_fn=None):
    """The host-packed compressed round: ``fn(global_state, server_state,
    cohort_data, residuals, round_seed) -> (new_global, new_server_state,
    new_residuals, info)``, the ``make_sim_round`` contract plus the
    cohort's residual tree (leading axis the cohort) threaded through.

    Client seeds (fold 1) and the server seed (fold 2) are the plain
    round's, so ``none`` reproduces it bit for bit; the compression seeds
    are ``client_seeds_for(fold_seed(round_seed, 3), C)`` by cohort slot.
    The ``ef-compress`` span sits between the local training and the
    aggregate."""
    from fedml_tpu_torch.parallel.engine import (_default_payload,
                                                 _default_server,
                                                 _finish_round,
                                                 _weighted_sum,
                                                 client_seeds_for,
                                                 fold_seed,
                                                 make_client_update)

    update = make_client_update(spec, cfg)
    payload_fn = payload_fn or _default_payload
    server_fn = server_fn or _default_server
    ef = ErrorFeedback(compressor)

    def round_fn(global_state, server_state, cohort_data, residuals,
                 round_seed):
        C = cohort_data["mask"].shape[0]
        local, aux, metrics = update(global_state, cohort_data,
                                     client_seeds_for(round_seed, C))
        with torch.no_grad():
            with get_tracer().span("ef-compress", clients=int(C)):
                recon, new_residuals = ef_reconstruct(
                    ef, local, global_state, residuals,
                    client_seeds_for(fold_seed(round_seed, 3), C))
            payloads = payload_fn(recon, global_state, aux)
            w = aux["n"].float()
            parts = (_weighted_sum(payloads, w),
                     tree_map(lambda x: x.float().sum(dim=0), payloads),
                     w.sum())
            new_global, new_server = _finish_round(
                payload_fn, server_fn, global_state, server_state, parts, C,
                round_seed)
        return (new_global, new_server, new_residuals,
                {"aux": aux, "metrics": metrics})

    return round_fn


class ResidualStore:
    """Per-client error-feedback residuals keyed by STABLE client id,
    never by cohort slot: ``gather(ids)`` stacks the cohort's rows in
    cohort order, ``scatter(ids, updated)`` writes each row back to its
    owner (a repeated id: the last row wins).

    Two backings behind one surface: **dense** (when ``num_clients`` is
    known and ``num_clients x bytes a client <= dense_cap_gb``): one
    ``[num_clients, ...]`` tensor a leaf on the template's device, rows
    are client ids; **sparse**: a host dict ``id -> {name: CPU tensor}``
    that materialises zeros lazily on first gather, so memory scales with
    the clients touched."""

    def __init__(self, params_template, num_clients=None, dense_cap_gb=2.0,
                 dense=None):
        self._template = {k: (tuple(v.shape), v.dtype)
                          for k, v in params_template.items()}
        self.device = next(iter(params_template.values())).device
        self._bytes_per_client = sum(
            v.numel() * v.element_size() for v in params_template.values())
        if dense is None:
            dense = (num_clients is not None
                     and num_clients * self._bytes_per_client
                     <= float(dense_cap_gb) * 1e9)
        self.dense = bool(dense)
        if self.dense:
            if num_clients is None:
                raise ValueError("dense ResidualStore needs num_clients")
            self._stacked = {
                k: torch.zeros((int(num_clients),) + s, dtype=d,
                               device=self.device)
                for k, (s, d) in self._template.items()}
        else:
            self._rows = {}  # client id -> {name: CPU tensor}

    def _zeros(self, device):
        return {k: torch.zeros(s, dtype=d, device=device)
                for k, (s, d) in self._template.items()}

    def gather(self, ids):
        """The residual rows of ``ids`` stacked in that order, on the
        template's device."""
        if self.dense:
            sel = torch.as_tensor(np.asarray(ids, np.int64),
                                  device=self.device)
            return {k: v.index_select(0, sel)
                    for k, v in self._stacked.items()}
        rows = [self._rows.get(int(i)) or self._zeros("cpu") for i in ids]
        return {k: torch.stack([r[k] for r in rows]).to(self.device)
                for k in self._template}

    def scatter(self, ids, updated):
        """Write each row of ``updated`` (leaves ``[len(ids), ...]``) back
        to its owner id."""
        ids = [int(i) for i in ids]
        last = {i: row for row, i in enumerate(ids)}  # the last row wins
        if self.dense:
            rows = torch.as_tensor(list(last.values()), dtype=torch.int64,
                                   device=self.device)
            sel = torch.as_tensor(list(last.keys()), dtype=torch.int64,
                                  device=self.device)
            for k, full in self._stacked.items():
                full.index_copy_(0, sel, updated[k].index_select(0, rows))
            return
        host = {k: v.detach().cpu() for k, v in updated.items()}
        for i, row in last.items():
            self._rows[i] = {k: v[row].clone() for k, v in host.items()}

    def peek(self, client_id):
        """One client's residual as CPU tensors (zeros if never
        touched)."""
        if self.dense:
            return {k: v[int(client_id)].cpu()
                    for k, v in self._stacked.items()}
        r = self._rows.get(int(client_id))
        return self._zeros("cpu") if r is None else {
            k: v.clone() for k, v in r.items()}


def _meta(tree):
    return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                          device="meta"), tree)


def compressed_payload_nbytes(compressor: Compressor, params_template) -> int:
    """Exact on-wire bytes of one client's compressed update through
    ``codec.encode_tree``, from shapes alone: the template (a nested dict
    of tensors, or of anything with ``shape`` and a torch ``dtype``) is
    compressed as ``meta`` tensors, so nothing runs on a device."""
    tmpl = _meta(params_template)
    stacked = tree_map(lambda t: t.unsqueeze(0), tmpl)
    draws = compressor.draws(stacked, np.zeros(1, np.int64))
    enc = compressor.compress(stacked, None, draws)
    return tree_wire_nbytes(tree_map(lambda x: x[0], enc))


def raw_payload_nbytes(params_template) -> int:
    """On-wire bytes of the same update uncompressed through the binary
    codec (the ``none`` floor ``compression_ratio`` is measured
    against)."""
    return tree_wire_nbytes(params_template)


__all__ = ["make_compressed_sim_round", "ResidualStore",
           "compressed_payload_nbytes", "raw_payload_nbytes",
           "ef_reconstruct"]
