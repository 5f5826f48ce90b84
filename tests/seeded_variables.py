"""Flax variables drawn with numpy from a seed, for the port's tests.

``jax.eval_shape`` traces a model's ``init`` without compiling it, and
numpy fills each leaf: conv and dense kernels ``N(0, 1/fan_in)``, norm
scales about 1, biases and running means about 0, running variances
about 1, anything else (a search network's alphas) ``N(0, 1)``. Flax
initialises eagerly op by op, which for the DARTS and DeepLab networks
takes tens of seconds on the CPU; this takes the tracing only."""

import jax
import jax.numpy as jnp
import numpy as np


def seeded_variables(module, x, seed=0, **init_kw):
    """Numpy variables of ``module`` (``init(key, x, **init_kw)``'s tree,
    as nested dicts) drawn from ``seed``."""
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, **init_kw),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.normal(size=leaf.shape)
        if name == "kernel":
            n = n / np.sqrt(max(1, int(np.prod(leaf.shape[:-1]))))
        elif name in ("scale", "var"):
            n = 1.0 + 0.1 * (np.abs(n) if name == "var" else n)
        elif name in ("bias", "mean"):
            n = 0.1 * n
        return n.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(
        fill, jax.tree.map(lambda s: s, dict(shapes)))
