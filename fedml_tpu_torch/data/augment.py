"""Train-time CIFAR augmentation on the device: random crop, horizontal
flip, Cutout (counterpart of ``fedml_tpu/data/augment.py``).

The random draws are explicit inputs: :meth:`CifarAugment.draw` makes
them with a ``torch.Generator`` on the batch's device, and
:meth:`CifarAugment.__call__` applies a given set, so tests can feed the
reference's draws to both sides.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class CifarAugment:
    """``pad`` random crop + horizontal flip + ``Cutout(cutout_length)``
    (clipped boxes) on ``[N, H, W, C]`` batches. ``pad_fill`` is the
    border value of the crop padding, per channel or scalar; None means
    0."""

    def __init__(self, pad=4, cutout_length=16, hflip=True, pad_fill=None):
        self.pad, self.cutout_length, self.hflip = pad, cutout_length, hflip
        self.pad_fill = pad_fill

    def draw(self, n, H, W, generator):
        """Draws for ``n`` images on the generator's device: crop offsets
        ``oy, ox`` in ``[0, 2*pad]``, ``flip`` (bool), Cutout centres
        ``cy`` in ``[0, H)``, ``cx`` in ``[0, W)``."""
        dev = generator.device
        ri = lambda hi: torch.randint(0, hi, (n,), generator=generator,
                                      device=dev)
        return {"oy": ri(2 * self.pad + 1), "ox": ri(2 * self.pad + 1),
                "flip": torch.rand(n, generator=generator, device=dev) < 0.5,
                "cy": ri(H), "cx": ri(W)}

    def __call__(self, x, draws):
        N, H, W, C = x.shape
        dev = x.device
        if self.pad:
            p = self.pad
            fill = (None if self.pad_fill is None else torch.as_tensor(
                self.pad_fill, dtype=x.dtype, device=dev))
            xs = x if fill is None else x - fill
            xp = F.pad(xs, (0, 0, p, p, p, p))
            if fill is not None:
                xp = xp + fill
            rows = draws["oy"][:, None] + torch.arange(H, device=dev)
            cols = draws["ox"][:, None] + torch.arange(W, device=dev)
            x = xp[torch.arange(N, device=dev)[:, None, None],
                   rows[:, :, None], cols[:, None, :]]
        if self.hflip:
            x = torch.where(draws["flip"][:, None, None, None],
                            x.flip(2), x)
        if self.cutout_length:
            half = self.cutout_length // 2
            y1 = torch.clamp(draws["cy"] - half, 0, H)[:, None, None]
            y2 = torch.clamp(draws["cy"] + half, 0, H)[:, None, None]
            x1 = torch.clamp(draws["cx"] - half, 0, W)[:, None, None]
            x2 = torch.clamp(draws["cx"] + half, 0, W)[:, None, None]
            ys = torch.arange(H, device=dev)[None, :, None]
            xs_ = torch.arange(W, device=dev)[None, None, :]
            inside = (ys >= y1) & (ys < y2) & (xs_ >= x1) & (xs_ < x2)
            x = x * (1.0 - inside[..., None].to(x.dtype))
        return x


def make_cifar_augment(pad: int = 4, cutout_length: int = 16,
                       hflip: bool = True, pad_fill=None):
    """Build the CIFAR recipe's augmentation (see :class:`CifarAugment`)."""
    return CifarAugment(pad, cutout_length, hflip, pad_fill)


__all__ = ["CifarAugment", "make_cifar_augment"]
