"""Resampling ops, channels-last ``(..., H, W, C)``.

Integer-factor 'area' down/up, the torch-exact adaptive average pool
(GlobalAgg) and the DUF-style Gaussian (BD) downsampling that makes the
``distortion: sr_bd`` LR target. The MATLAB bicubic resize is ROADMAP item
A25.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def area_down(x, k: int):
    """k x k average pooling == ``Upsample(scale_factor=1/k, mode='area')``."""
    *lead, H, W, C = x.shape
    x = x.reshape(*lead, H // k, k, W // k, k, C)
    return x.mean(dim=(-4, -2))


def area_up(x, k: int):
    """Integer 'area' upsample == nearest duplication of each pixel. Written
    as a broadcast, whose backward is a plain sum: the same bits on every
    run (``repeat_interleave`` goes back through atomic adds on a GPU)."""
    *lead, H, W, C = x.shape
    x = x.reshape(*lead, H, 1, W, 1, C).expand(*lead, H, k, W, k, C)
    return x.reshape(*lead, H * k, W * k, C)


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


@lru_cache(maxsize=None)
def _gauss_kernel_1d(sigma: float, taps: int = 13) -> np.ndarray:
    """Truncated gaussian as ``scipy.ndimage.gaussian_filter`` makes it
    (truncate=4.0): zero outside radius int(4*sigma+0.5)."""
    radius = min(int(4.0 * sigma + 0.5), taps // 2)
    half = taps // 2
    w = np.zeros(taps, np.float64)
    for i in range(-radius, radius + 1):
        w[half + i] = math.exp(-0.5 * (i / sigma) ** 2)
    return (w / w.sum()).astype(np.float32)


@lru_cache(maxsize=None)
def _strided_blur_matrix(in_size: int, scale: int) -> np.ndarray:
    """(out, in) matrix: row i holds the 13 taps at offset i*scale."""
    w1d = _gauss_kernel_1d(0.4 * scale)
    out = (in_size - 13) // scale + 1
    m = np.zeros((out, in_size), np.float32)
    for i in range(out):
        m[i, i * scale:i * scale + 13] = w1d
    return m


def gaussian_downsample(x, scale: int = 4):
    """DUF-style BD degradation of (..., H, W, C): reflect pad (6 + 2*scale),
    13x13 gaussian blur (sigma = 0.4*scale) sampled at stride ``scale``, then
    2 px cropped from each side. The blur and the stride are two products
    with fixed matrices."""
    if scale not in (2, 3, 4):
        raise ValueError(f"BD scale {scale} unsupported")
    pad = 6 + scale * 2
    *lead, H, W, C = x.shape
    xf = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    xp = F.pad(xf, (pad, pad, pad, pad), mode="reflect")
    mh = torch.as_tensor(_strided_blur_matrix(xp.shape[2], scale), dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(_strided_blur_matrix(xp.shape[3], scale), dtype=x.dtype, device=x.device)
    y = torch.einsum("oh,nchw->ncow", mh, xp)
    y = torch.einsum("pw,ncow->ncop", mw, y)
    y = y[:, :, 2:-2, 2:-2].permute(0, 2, 3, 1)
    return y.reshape(*lead, y.shape[1], y.shape[2], C)
