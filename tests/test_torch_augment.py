"""The port's CIFAR augmentation against the JAX package's: the
reference's own random draws (crop offsets, flip, Cutout centres, made
exactly as ``make_cifar_augment`` makes them from its key) are fed to
the port, and the two outputs must be equal (crop, flip and Cutout move
or zero values; the fill shift is one fp32 add each way)."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import jax
import numpy as np
import pytest
import torch

from fedml_tpu.data.augment import make_cifar_augment as ref_augment
from fedml_tpu_torch.data.augment import make_cifar_augment


def _reference_draws(key, B, H, W, pad):
    k_cy, k_cx, k_flip, k_cuty, k_cutx = jax.random.split(key, 5)
    return {"oy": jax.random.randint(k_cy, (B,), 0, 2 * pad + 1),
            "ox": jax.random.randint(k_cx, (B,), 0, 2 * pad + 1),
            "flip": jax.random.bernoulli(k_flip, 0.5, (B,)),
            "cy": jax.random.randint(k_cuty, (B,), 0, H),
            "cx": jax.random.randint(k_cutx, (B,), 0, W)}


@pytest.mark.parametrize("pad,cut,hflip,fill", [
    (4, 16, True, None), (2, 4, True, (0.1, -0.2, 0.3)),
    (0, 8, False, None), (4, 0, True, -1.5)])
def test_same_draws_same_output(pad, cut, hflip, fill):
    B, H, W = 16, 32, 32
    x = np.random.default_rng(0).normal(size=(B, H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = ref_augment(pad=pad, cutout_length=cut, hflip=hflip,
                       pad_fill=fill)(jax.numpy.asarray(x), key)
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in _reference_draws(key, B, H, W, max(pad, 0)).items()}
    aug = make_cifar_augment(pad=pad, cutout_length=cut, hflip=hflip,
                             pad_fill=fill)
    got = aug(torch.from_numpy(x), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_draws_are_seeded_and_in_range():
    aug = make_cifar_augment(pad=4, cutout_length=16)
    a = aug.draw(64, 32, 32, torch.Generator().manual_seed(3))
    b = aug.draw(64, 32, 32, torch.Generator().manual_seed(3))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert int(a["oy"].min()) >= 0 and int(a["oy"].max()) <= 8
    assert int(a["cx"].max()) < 32 and a["flip"].dtype == torch.bool
