"""Training losses of the rescaling models."""

from __future__ import annotations

import torch


def reconstruction_loss(x, target, losstype: str = "l2", eps: float = 1e-6):
    """l2 = mean squared error; l1 = charbonnier sqrt(d^2 + eps); both are
    means over every dimension."""
    d = x - target
    if losstype == "l2":
        return torch.mean(d * d)
    if losstype == "l1":
        return torch.mean(torch.sqrt(d * d + eps))
    raise ValueError(losstype)
