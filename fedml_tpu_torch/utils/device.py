"""Device selection for the port's entry points: the card unless the
caller asks for the CPU. There is no quiet CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device and raises when there is none;
    an explicit ``"cpu"`` (or any other device) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu' explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


__all__ = ["resolve_device"]
