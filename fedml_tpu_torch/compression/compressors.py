"""Client-update compressors over the client axis (counterpart of
``fedml_tpu/compression/compressors.py``).

Each compressor maps a tree (nested dicts) of update deltas whose leaves
lead with the client axis ``K`` to an *encoded* tree (per-leaf dicts of
small tensors, each leading with ``K``) and back. All K clients encode
at once: topk is one ``torch.topk`` over ``|x|.view(K, -1)``, qsgd and
signsgd reduce over each client's row. The encoded form of one client
(``[k]`` of every leaf) is what rides the wire (``codec.encode_tree``).

Random draws (qsgd's uniform noise, randk's permutation) come from one
``torch.Generator`` per (client, leaf) on the leaf's device, seeded with
``fold_seed(client_seed, i)`` for the ``i``-th leaf in sorted-key order
(the reference's ``_leaf_rngs`` rule). ``encode(..., draws=)`` and
``compress(..., draws=)`` take the draws instead, so a test can hand in
another package's (JAX's) draws; :meth:`Compressor.draw` makes them.

Error feedback (:class:`ErrorFeedback`) carries the per-client residual
across rounds: compress ``delta + residual``, keep ``residual' = (delta +
residual) - decompress(encoded)``. It wraps every compressor, qsgd
included, as the reference's simulated rounds do (the wire twin runs
qsgd without it: ``wire.HostQSGD.ef``).

Only floating leaves are compressed; integer leaves ride as ``{"raw":
x}`` under every compressor. The device qsgd stores int8 codes whatever
``bits`` is.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _is_float(x) -> bool:
    return torch.is_floating_point(x)


def tree_items(tree, prefix=()):
    """``(path, leaf)`` of a nested dict in sorted-key order (the order
    of ``jax.tree.flatten`` over dicts)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_items(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_build(items):
    """Inverse of :func:`tree_items`: nested dicts from ``(path, leaf)``;
    the empty path is a bare leaf."""
    items = list(items)
    if len(items) == 1 and items[0][0] == ():
        return items[0][1]
    out = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structured nested dicts."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _enc_map(fn, template, encoded):
    """``fn(template_leaf, encoded_leaf_dict)`` walking ``template``."""
    if isinstance(template, dict):
        return {k: _enc_map(fn, template[k], encoded[k]) for k in template}
    return fn(template, encoded)


def leaf_seeds(seeds, n_leaves):
    """``[n_leaves]`` arrays of ``[K]`` int64 seeds: leaf ``i`` of client
    ``c`` draws from ``fold_seed(seeds[c], i)``."""
    from fedml_tpu_torch.parallel.engine import fold_seed
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    return [fold_seed(seeds, i) for i in range(n_leaves)]


def _generators(seeds, device):
    if seeds is None:
        raise ValueError("a random draw needs the clients' seeds (or the "
                         "draws handed in)")
    for s in np.asarray(seeds, np.int64).reshape(-1):
        yield torch.Generator(device=device).manual_seed(int(s))


def _k_for(shape, ratio):
    size = int(math.prod(shape)) if shape else 1
    return max(1, int(math.ceil(ratio * size)))


def _per_client(scale, ndim):
    """``[K]`` -> ``[K, 1, ...]`` broadcasting against ``ndim``-d rows."""
    return scale.reshape(scale.shape + (1,) * (ndim - 1))


class Compressor:
    """Per-leaf ``encode``/``decode`` over ``[K, ...]`` leaves, lifted
    over trees by :meth:`compress`/:meth:`decompress`.

    ``compress(tree, seeds, draws=None) -> encoded`` takes the K clients'
    compression seeds; ``decompress(encoded, template)`` needs the
    unstacked ``template`` tree for shapes and dtypes. Every encoded
    shape is static given the template."""

    name = "none"

    def draw(self, x, seeds):
        """The random draws of ``encode(x)`` from per-client generators
        seeded with ``seeds [K]`` (None when the encode draws nothing)."""
        return None

    def encode(self, x, seeds=None, draws=None):  # pragma: no cover
        raise NotImplementedError

    def decode(self, enc, shape, dtype):  # pragma: no cover - interface
        raise NotImplementedError

    def compress(self, tree, seeds=None, draws=None):
        """Encode every leaf of ``tree`` (leaves ``[K, ...]``); ``seeds``
        the K clients' compression seeds, ``draws`` an optional tree of
        per-leaf draws (None leaves draw from the seeds)."""
        items = tree_items(tree)
        lseeds = (leaf_seeds(seeds, len(items)) if seeds is not None
                  else [None] * len(items))
        dmap = dict(tree_items(draws)) if draws is not None else {}
        out = []
        for (path, x), s in zip(items, lseeds):
            if not _is_float(x):
                out.append((path, {"raw": x}))
                continue
            out.append((path, self.encode(x, s, dmap.get(path))))
        return tree_build(out)

    def decompress(self, encoded, template):
        """Decode every leaf against ``template`` (unstacked leaves, or
        anything with ``shape``/``dtype``): ``[K, *shape]`` leaves."""
        return _enc_map(
            lambda t, enc: (self.decode(enc, tuple(t.shape), t.dtype)
                            if _is_float(t) else enc["raw"]),
            template, encoded)

    def draws(self, tree, seeds):
        """The tree of draws :meth:`compress` would make from ``seeds``."""
        items = tree_items(tree)
        return tree_build(
            (path, self.draw(x, s) if _is_float(x) else None)
            for (path, x), s in zip(items, leaf_seeds(seeds, len(items))))

    def __repr__(self):
        return f"{type(self).__name__}()"


class NoneCompressor(Compressor):
    """Identity: no information lost; the win is the binary codec."""

    name = "none"

    def encode(self, x, seeds=None, draws=None):
        return {"values": x}

    def decode(self, enc, shape, dtype):
        v = enc["values"]
        return v.reshape((v.shape[0],) + tuple(shape)).to(dtype)


class TopKCompressor(Compressor):
    """Per-leaf magnitude top-k of each client's flattened leaf: (values,
    int32 indices), indices in descending-magnitude order as
    ``lax.top_k`` gives them."""

    name = "topk"

    def __init__(self, ratio=0.01):
        if not 0 < ratio <= 1:
            raise ValueError(f"topk ratio must be in (0, 1], got {ratio}")
        self.ratio = float(ratio)

    def encode(self, x, seeds=None, draws=None):
        flat = x.reshape(x.shape[0], -1)
        k = _k_for(x.shape[1:], self.ratio)
        _, idx = torch.topk(flat.float().abs(), k, dim=1)
        return {"values": torch.gather(flat, 1, idx),
                "indices": idx.to(torch.int32)}

    def decode(self, enc, shape, dtype):
        vals = enc["values"]
        K, size = vals.shape[0], int(math.prod(shape)) if shape else 1
        flat = torch.zeros((K, size), dtype=dtype, device=vals.device)
        flat.scatter_(1, enc["indices"].long(), vals.to(dtype))
        return flat.reshape((K,) + tuple(shape))

    def __repr__(self):
        return f"TopKCompressor(ratio={self.ratio})"


class RandKCompressor(TopKCompressor):
    """Uniform-random k of each client's leaf, rescaled by ``size / k`` so
    the encoded update is an unbiased estimator of the input. The draw is
    a permutation's first k positions, one per client: ``[K, k]``."""

    name = "randk"

    def draw(self, x, seeds):
        n = int(math.prod(x.shape[1:])) if x.dim() > 1 else 1
        k = _k_for(x.shape[1:], self.ratio)
        if x.is_meta:
            return torch.empty((x.shape[0], k), dtype=torch.int64,
                               device="meta")
        return torch.stack([torch.randperm(n, generator=g,
                                           device=x.device)[:k]
                            for g in _generators(seeds, x.device)])

    def encode(self, x, seeds=None, draws=None):
        flat = x.reshape(x.shape[0], -1)
        idx = draws if draws is not None else self.draw(x, seeds)
        idx = torch.as_tensor(idx, device=x.device).reshape(
            x.shape[0], -1).long()
        scale = torch.tensor(flat.shape[1] / idx.shape[1], dtype=flat.dtype,
                             device=x.device)
        return {"values": torch.gather(flat, 1, idx) * scale,
                "indices": idx.to(torch.int32)}

    def __repr__(self):
        return f"RandKCompressor(ratio={self.ratio})"


class QSGDCompressor(Compressor):
    """Stochastic uniform quantization to signed int8 with a per-leaf,
    per-client fp32 scale (QSGD). ``bits`` in [2, 8] sets the levels
    (``2^(bits-1) - 1``); storage is int8 either way. The draw is
    uniform ``[0, 1)`` noise of the leaf's shape, fp32."""

    name = "qsgd"

    def __init__(self, bits=8):
        if not 2 <= int(bits) <= 8:
            raise ValueError(f"qsgd bits must be in [2, 8], got {bits}")
        self.bits = int(bits)
        self.levels = 2 ** (self.bits - 1) - 1

    def draw(self, x, seeds):
        if x.is_meta:
            return torch.empty(x.shape, dtype=torch.float32, device="meta")
        return torch.stack([torch.rand(tuple(x.shape[1:]), generator=g,
                                       device=x.device)
                            for g in _generators(seeds, x.device)])

    def encode(self, x, seeds=None, draws=None):
        K = x.shape[0]
        xf = x.float().reshape(K, -1)
        scale = xf.abs().amax(dim=1)
        safe = torch.clamp(scale, min=1e-30)
        y = xf / safe[:, None] * self.levels
        noise = draws if draws is not None else self.draw(x, seeds)
        noise = torch.as_tensor(noise, device=x.device).reshape(K, -1)
        q = torch.clamp(torch.floor(y + noise), -self.levels, self.levels)
        return {"q": q.to(torch.int8).reshape(x.shape), "scale": scale}

    def decode(self, enc, shape, dtype):
        q = enc["q"]
        y = (q.float() * _per_client(enc["scale"], q.dim())
             / self.levels)
        return y.reshape((q.shape[0],) + tuple(shape)).to(dtype)

    def __repr__(self):
        return f"QSGDCompressor(bits={self.bits})"


class SignSGDCompressor(Compressor):
    """1-bit sign with a per-leaf, per-client mean-|x| magnitude (scaled
    SignSGD); the codec bit-packs the bool signs."""

    name = "signsgd"

    def encode(self, x, seeds=None, draws=None):
        xf = x.float()
        return {"sign": xf >= 0,
                "scale": xf.abs().reshape(x.shape[0], -1).mean(dim=1)}

    def decode(self, enc, shape, dtype):
        sign = enc["sign"]
        s = _per_client(enc["scale"], sign.dim())
        return torch.where(sign, s, -s).reshape(
            (sign.shape[0],) + tuple(shape)).to(dtype)


class ErrorFeedback:
    """The client-side residual accumulator that makes biased compressors
    converge; the residual tree is carried by the caller (per client,
    across rounds)."""

    def __init__(self, compressor: Compressor):
        self.compressor = compressor

    def init(self, template, K=1):
        return tree_map(lambda t: torch.zeros((K,) + tuple(t.shape),
                                              dtype=t.dtype,
                                              device=t.device), template)

    def step(self, delta, residual, template, seeds=None, draws=None):
        """Compress ``delta + residual`` (``[K, ...]`` leaves); returns
        ``(encoded, decoded, new_residual)`` with ``decoded`` what the
        server reconstructs."""
        comp_in = tree_map(torch.add, delta, residual)
        encoded = self.compressor.compress(comp_in, seeds, draws)
        decoded = self.compressor.decompress(encoded, template)
        new_residual = tree_map(torch.sub, comp_in, decoded)
        return encoded, decoded, new_residual


_REGISTRY = {
    "none": NoneCompressor,
    "topk": TopKCompressor,
    "randk": RandKCompressor,
    "qsgd": QSGDCompressor,
    "signsgd": SignSGDCompressor,
}


def get_compressor(spec):
    """Spec string -> compressor instance (None, empty, ``0``, ``off``,
    ``false`` -> None). Grammar ``name[:arg]``: ``none``, ``topk:0.01``,
    ``randk:0.1``, ``qsgd:8``, ``signsgd``. A :class:`Compressor` passes
    through."""
    if spec is None or isinstance(spec, Compressor):
        return spec
    s = str(spec).strip().lower()
    if not s or s in ("0", "off", "false"):
        return None
    name, _, arg = s.partition(":")
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r} "
                         f"(known: {sorted(_REGISTRY)})")
    cls = _REGISTRY[name]
    if not arg:
        return cls()
    if name in ("topk", "randk"):
        return cls(ratio=float(arg))
    if name == "qsgd":
        return cls(bits=int(arg))
    raise ValueError(f"compressor {name!r} takes no argument (got {arg!r})")


__all__ = ["Compressor", "NoneCompressor", "TopKCompressor",
           "RandKCompressor", "QSGDCompressor", "SignSGDCompressor",
           "ErrorFeedback", "get_compressor", "tree_items", "tree_build",
           "tree_map", "leaf_seeds"]
