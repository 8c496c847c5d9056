"""Codec-noise ablation (reference models/modules/Noise.py:17-38; the JAX
package's ``codec/noise.py``): additive noise in place of the codec. The
noise is drawn from an explicit ``torch.Generator`` on x's device."""

from __future__ import annotations

import torch


def add_noise(x, generator, magnitude: float = 1e-4, kind: str = "uniform"):
    """``kind`` 'uniform': a random sign times a magnitude uniform in
    [magnitude/10, magnitude); 'gaussian': normal with std 2*magnitude."""
    if kind == "uniform":
        sign = (torch.rand(x.shape, generator=generator, device=x.device) < 0.5).to(x.dtype) * 2 - 1
        u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        noise = sign * (magnitude / 10.0 + u * (magnitude - magnitude / 10.0))
    elif kind == "gaussian":
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype) * 2.0 * magnitude
    else:
        raise ValueError(kind)
    return x + noise
