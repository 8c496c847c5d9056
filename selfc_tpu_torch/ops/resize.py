"""Resampling ops, channels-last ``(..., H, W, C)``.

Integer-factor 'area' down/up and the torch-exact adaptive average pool
(GlobalAgg). Gaussian (BD) downsampling and the MATLAB bicubic resize come
with the training slice.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def area_down(x, k: int):
    """k x k average pooling == ``Upsample(scale_factor=1/k, mode='area')``."""
    *lead, H, W, C = x.shape
    x = x.reshape(*lead, H // k, k, W // k, k, C)
    return x.mean(dim=(-4, -2))


def area_up(x, k: int):
    """Integer 'area' upsample == nearest duplication of each pixel."""
    x = torch.repeat_interleave(x, k, dim=-3)
    return torch.repeat_interleave(x, k, dim=-2)


@lru_cache(maxsize=None)
def _adaptive_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) averaging matrix with the adaptive_avg_pool window rule:
    start = floor(i*in/out), end = ceil((i+1)*in/out)."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        s = (i * in_size) // out_size
        e = -((-(i + 1) * in_size) // out_size)
        m[i, s:e] = 1.0 / (e - s)
    return m


def adaptive_avg_pool2d(x, out_hw):
    """x: (..., H, W, C) -> (..., out_h, out_w, C), torch-exact windows."""
    *_, H, W, C = x.shape
    oh, ow = out_hw
    mh = torch.as_tensor(_adaptive_matrix(H, oh), dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(_adaptive_matrix(W, ow), dtype=x.dtype, device=x.device)
    y = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("pw,...owc->...opc", mw, y)
