"""Codec-noise ablation (reference models/modules/Noise.py:17-38; the JAX
package's ``codec/noise.py``): additive noise in place of the codec. The
noise is drawn from an explicit ``torch.Generator`` on x's device."""

from __future__ import annotations

import torch


def draw_noise(shape, dtype, device, generator, magnitude: float = 1e-4, kind: str = "uniform"):
    """The noise of ``add_noise`` for a tensor of ``shape`` and ``dtype`` on
    ``device``: ``kind`` 'uniform': a random sign times a magnitude uniform
    in [magnitude/10, magnitude); 'gaussian': normal with std 2*magnitude."""
    if kind == "uniform":
        sign = (torch.rand(shape, generator=generator, device=device) < 0.5).to(dtype) * 2 - 1
        u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
        return sign * (magnitude / 10.0 + u * (magnitude - magnitude / 10.0))
    if kind == "gaussian":
        return torch.randn(shape, generator=generator, device=device, dtype=dtype) * 2.0 * magnitude
    raise ValueError(kind)


def add_noise(x, generator, magnitude: float = 1e-4, kind: str = "uniform"):
    """x plus ``draw_noise`` of its shape, drawn on its device."""
    return x + draw_noise(x.shape, x.dtype, x.device, generator, magnitude, kind)
