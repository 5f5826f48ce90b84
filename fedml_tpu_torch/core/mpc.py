"""Secure-aggregation MPC primitives (TurboAggregate; counterpart of
``fedml_tpu/core/mpc.py``, plain numpy, the port's own copy with the same
semantics byte for byte).

Finite-field fixed-point quantization, additive secret sharing,
Shamir/BGW polynomial sharing with Lagrange reconstruction -- the
building blocks under TurboAggregate's circular aggregation topology
(reference ``mpc_function.py``: coefficients at ``:39-59``, BGW encoding
at ``:62-75``).

Field math is exact int64 modular arithmetic on the host: it is
control-plane-sized (shares of model updates) and needs modular
inverses. The quantize/dequantize boundary is where device tensors enter
and leave the field (``algorithms/turboaggregate.py`` brings each leaf
to the host in float64).
"""

from __future__ import annotations

import numpy as np

DEFAULT_PRIME = 2 ** 31 - 1  # Mersenne prime fits int64 products via Python int

#: domain-separation salt for the masking streams (distinct from the
#: codec's 0x5EED and the DP leg's 0xD1FF -- three independent derived
#: stream families over the same (rank, round, attempt) keys).
MASK_SEED_SALT = 0x3A5C


def mask_rng(*key):
    """The derived masking stream for the share/encode helpers, keyed
    per use site (e.g. ``mask_rng(rank, round_idx)``). The sharing
    functions REQUIRE an explicit rng: an unseeded default would make
    masked runs unreplayable, and a constant default (the historical
    ``default_rng(0)`` in :func:`secure_aggregate`) reuses the exact
    same masks every call -- reused masks cancel, which voids the
    secrecy the sharing exists to provide. fedcheck's privacy pass
    (FL151's derived-stream rule) keeps new call sites honest."""
    return np.random.default_rng((MASK_SEED_SALT, *map(int, key)))


def _require_rng(rng, fn_name):
    if rng is None:
        raise ValueError(
            f"{fn_name} needs an explicit rng -- derive one per use via "
            "mask_rng(rank, round_idx, ...) so masks are replayable and "
            "never silently reused across calls")
    return rng


def quantize(x, scale=2 ** 16, p=DEFAULT_PRIME):
    """Float array -> field elements (two's-complement style embedding)."""
    q = np.round(np.asarray(x, np.float64) * scale).astype(np.int64)
    return np.mod(q, p)


def dequantize(q, scale=2 ** 16, p=DEFAULT_PRIME):
    """Field elements -> float array, mapping (p/2, p) back to negatives."""
    q = np.asarray(q, np.int64)
    signed = np.where(q > p // 2, q - p, q)
    return signed.astype(np.float64) / scale


def modular_inverse(a, p=DEFAULT_PRIME):
    return pow(int(a) % p, p - 2, p)


def additive_shares(secret, n_shares, p=DEFAULT_PRIME, rng=None):
    """Split field array into n uniformly random additive shares."""
    rng = _require_rng(rng, "additive_shares")
    shares = [rng.integers(0, p, size=np.shape(secret), dtype=np.int64)
              for _ in range(n_shares - 1)]
    last = np.mod(np.asarray(secret, np.int64) - sum(np.int64(0) + s for s in shares), p)
    shares.append(last)
    return shares


def reconstruct_additive(shares, p=DEFAULT_PRIME):
    total = np.zeros_like(np.asarray(shares[0], np.int64))
    for s in shares:
        total = np.mod(total + np.asarray(s, np.int64), p)
    return total


def lagrange_coefficients(eval_points, target=0, p=DEFAULT_PRIME):
    """w_i = prod_{j != i} (target - x_j) / (x_i - x_j) mod p."""
    xs = [int(x) % p for x in eval_points]
    coeffs = []
    for i, xi in enumerate(xs):
        num, den = 1, 1
        for j, xj in enumerate(xs):
            if i == j:
                continue
            num = (num * ((target - xj) % p)) % p
            den = (den * ((xi - xj) % p)) % p
        coeffs.append((num * modular_inverse(den, p)) % p)
    return coeffs


def bgw_encode(secret, eval_points, t, p=DEFAULT_PRIME, rng=None):
    """Shamir/BGW degree-t polynomial shares of a field array: share_k =
    secret + sum_{d=1..t} r_d * x_k^d (reference BGW_encoding)."""
    rng = _require_rng(rng, "bgw_encode")
    secret = np.asarray(secret, np.int64)
    coeffs = [rng.integers(0, p, size=secret.shape, dtype=np.int64)
              for _ in range(t)]
    shares = []
    for x in eval_points:
        acc = secret.copy()
        xp = 1
        for d in range(1, t + 1):
            xp = (xp * int(x)) % p
            acc = np.mod(acc + coeffs[d - 1] * xp, p)
        shares.append(acc)
    return shares


def bgw_decode(shares, eval_points, p=DEFAULT_PRIME):
    """Reconstruct the secret (polynomial at 0) from >= t+1 shares."""
    ws = lagrange_coefficients(eval_points, 0, p)
    acc = np.zeros_like(np.asarray(shares[0], np.int64))
    for w, s in zip(ws, shares):
        acc = np.mod(acc + (np.asarray(s, np.int64).astype(object) * int(w)) % p, p)
    return acc.astype(np.int64)


def secure_aggregate(client_updates, p=DEFAULT_PRIME, scale=2 ** 16, rng=None):
    """Additive-masking secure aggregation of float arrays: each client's
    quantized update is split into shares, only share-sums are 'revealed',
    and the sum is dequantized -- the server never sees an individual update.
    Semantics of TurboAggregate's aggregation result (``TA_Aggregator.py:
    56-85`` computes the same weighted sum in the clear)."""
    rng = _require_rng(rng, "secure_aggregate")
    n = len(client_updates)
    q = [quantize(u, scale, p) for u in client_updates]
    all_shares = [additive_shares(qi, n, p, rng) for qi in q]
    # share j of every client is summed by party j (no single party holds any
    # full update); the final sum of partial sums equals the sum of updates
    partials = [reconstruct_additive([all_shares[i][j] for i in range(n)], p)
                for j in range(n)]
    total_q = reconstruct_additive(partials, p)
    return dequantize(total_q, scale, p)
