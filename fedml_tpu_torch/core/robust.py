"""Robust-aggregation defenses as tensor functions on state dicts
(counterpart of ``fedml_tpu/core/robust.py``).

- :func:`split_weights` / :func:`vectorize_weights`: the defense vector
  holds weight parameters only; the BatchNorm running statistics
  (``batch_stats``) are left out, as the reference leaves out
  ``running_mean``/``running_var``.
- :func:`norm_diff_clipping`: clip ``local - global`` to an L2 ball.
- :func:`coordinate_median`, :func:`trimmed_mean`: per-coordinate order
  statistics over a list of states.
- :func:`add_gaussian_noise`: weak-DP Gaussian noise on the weights.

A state is the port's ``{"params": {name: tensor}, "batch_stats":
{...}}``. :func:`norm_diff_clipping` also takes client-stacked local
states (every leaf with leading client axes over the global leaf): the
norm and the clip are then per client, as the reference's vmapped call
computes them.

Noise draws come from ``torch.Generator``s seeded from the integer
``rng`` (one stream per leaf, in sorted-key order); ``jax.random``'s
stream cannot be reproduced in torch, so the noise itself differs from
the reference's, draw for draw, while its distribution is the same.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.parallel.engine import _tree_map, fold_seed

# state collections left out of the defense vector (BN running stats)
NON_WEIGHT_COLLECTIONS = ("batch_stats",)


def split_weights(state):
    """``(weights, non_weights)``: the excluded collections apart."""
    if not isinstance(state, dict):
        return state, {}
    weights = {k: v for k, v in state.items()
               if k not in NON_WEIGHT_COLLECTIONS}
    rest = {k: v for k, v in state.items() if k in NON_WEIGHT_COLLECTIONS}
    return weights, rest


def _leaves(tree, prefix=()):
    """``(path, tensor)`` pairs in sorted-key order (the order of
    ``jax.tree.leaves`` over the same dict)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _merge(weights, rest):
    out = dict(weights)
    out.update(rest)
    return out


def vectorize_weights(state):
    """1-D fp32 vector of the weight parameters (BN stats excluded)."""
    weights, _ = split_weights(state)
    return torch.cat([x.float().reshape(-1) for _, x in _leaves(weights)])


def norm_diff_clipping(local_state, global_state, norm_bound):
    """Clip ``local - global`` (weights only) to L2 norm ``norm_bound``
    and add it back to ``global``: ``global + diff / max(1, ||diff|| /
    norm_bound)``. BN stats pass through unclipped. ``local_state`` may
    lead with client axes (over each global leaf's shape); the norm is
    then taken per client."""
    local_w, local_rest = split_weights(local_state)
    global_w, _ = split_weights(global_state)
    diff = _tree_map(lambda lo, g: lo - g, local_w, global_w)
    pairs = list(zip(_leaves(diff), _leaves(global_w)))
    lead = pairs[0][0][1].dim() - pairs[0][1][1].dim()
    sq = None
    for (_, d), (_, g) in pairs:
        s = (d * d).sum(dim=tuple(range(lead, d.dim()))) if d.dim() > lead \
            else d * d
        sq = s if sq is None else sq + s
    scale = 1.0 / torch.clamp(torch.sqrt(sq) / norm_bound, min=1.0)

    def clip(d, g):
        s = scale.reshape(scale.shape + (1,) * (d.dim() - scale.dim()))
        return g + d * s

    return _merge(_tree_map(clip, diff, global_w), local_rest)


def _order_stat(states, reduce):
    weights = [split_weights(s)[0] for s in states]
    _, rest = split_weights(states[0])
    out = _tree_map(
        lambda *xs: reduce(torch.sort(torch.stack(xs), dim=0).values),
        *weights)
    return _merge(out, rest) if isinstance(states[0], dict) else out


def coordinate_median(states):
    """Per-coordinate median over a list of states (the mean of the two
    middle values for an even count, as ``jnp.median``); BN stats from
    the first state."""
    m = len(states)

    def median(v):
        if m % 2:
            return v[m // 2]
        return (v[m // 2 - 1] + v[m // 2]) / 2
    return _order_stat(states, median)


def trimmed_mean(states, trim_ratio):
    """Per-coordinate mean after dropping ``floor(trim_ratio * m)``
    values at each end (at least one value kept); BN stats from the
    first state."""
    m = len(states)
    t = int(trim_ratio * m)
    if 2 * t >= m:
        t = (m - 1) // 2
    return _order_stat(states,
                       lambda v: (v[t:m - t] if t else v).mean(dim=0))


def add_gaussian_noise(state, stddev, rng):
    """Gaussian noise of ``stddev`` on the floating weight leaves; leaf
    ``i`` (sorted-key order) draws from a generator on its device seeded
    with ``fold_seed(rng, i)``."""
    weights, rest = split_weights(state)
    noised = {}
    for i, (path, x) in enumerate(_leaves(weights)):
        if x.is_floating_point():
            gen = torch.Generator(device=x.device)
            gen.manual_seed(int(fold_seed(int(rng), i)))
            x = (x.float() + stddev * torch.randn(
                x.shape, generator=gen, device=x.device,
                dtype=torch.float32)).to(x.dtype)
        node = noised
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return _merge(noised, rest)


__all__ = ["NON_WEIGHT_COLLECTIONS", "split_weights", "vectorize_weights",
           "norm_diff_clipping", "coordinate_median", "trimmed_mean",
           "add_gaussian_noise"]
