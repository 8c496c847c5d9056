"""Orthogonal 2x2 Haar wavelet transform, channels-last (the JAX package's
``ops/haar.py``).

As the JAX package has it: the /4 normalisation on the forward and none on
the inverse (so ``haar_inverse(haar_forward(x)) == x``), the subband-major
output channel order ``[LL_0..LL_C, H.., V.., D..]``, and the log-jacobian
values ``elems/4 * log(1/16)`` forward, ``* log 16`` inverse. Strided
slices and adds: no kernel (the JAX package computes it outside any Pallas
kernel too).
"""

from __future__ import annotations

import math

import torch


def haar_forward(x):
    """(..., H, W, C) -> (..., H/2, W/2, 4C); subband-major channels."""
    a = x[..., 0::2, 0::2, :]
    b = x[..., 0::2, 1::2, :]
    c = x[..., 1::2, 0::2, :]
    d = x[..., 1::2, 1::2, :]
    ll = (a + b + c + d) * 0.25
    hh = (a - b + c - d) * 0.25  # horizontal detail
    vv = (a + b - c - d) * 0.25  # vertical detail
    dd = (a - b - c + d) * 0.25  # diagonal detail
    return torch.cat([ll, hh, vv, dd], dim=-1)


def haar_inverse(y):
    """(..., h, w, 4C) -> (..., 2h, 2w, C); the exact inverse of
    ``haar_forward``."""
    C = y.shape[-1] // 4
    ll, hh, vv, dd = (y[..., i * C:(i + 1) * C] for i in range(4))
    a = ll + hh + vv + dd
    b = ll - hh + vv - dd
    c = ll + hh - vv - dd
    d = ll - hh - vv + dd
    *lead, h, w, _ = y.shape
    top = torch.stack([a, b], dim=-2).reshape(*lead, h, 2 * w, C)
    bot = torch.stack([c, d], dim=-2).reshape(*lead, h, 2 * w, C)
    return torch.stack([top, bot], dim=-3).reshape(*lead, 2 * h, 2 * w, C)


def haar_log_jacobian(x_shape, rev: bool = False) -> float:
    """elements/4 * log(1/16) (forward) or * log(16) (inverse), elements =
    C*H*W of the op's input."""
    elems = x_shape[-1] * x_shape[-2] * x_shape[-3]
    return elems / 4.0 * (math.log(16.0) if rev else math.log(1.0 / 16.0))
