"""Resampling ops, channels-last ``(..., H, W, C)``.

Integer-factor 'area' down/up, the torch-exact adaptive average pool
(GlobalAgg), the DUF-style Gaussian (BD) downsampling that makes the
``distortion: sr_bd`` LR target, and the MATLAB bicubic resize of
``distortion: matlab`` and the image datasets. Each resampling is a product
with a fixed matrix built in numpy (the MATLAB resize: its taps, one
elementwise pass each).
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
def adaptive_w_counts(in_size: int, out_size: int) -> np.ndarray:
    """(out,) the columns in each adaptive_avg_pool window of ``in_size``."""
    return (_adaptive_matrix(in_size, out_size) > 0).sum(axis=1).astype(np.float32)


def adaptive_pool_w_sums(x, out_hw, w0: int, W: int):
    """One W shard's share of ``adaptive_avg_pool2d`` over the whole image:
    x is columns ``[w0, w0 + w)`` of an image ``W`` wide; H is averaged as
    there, each W window is summed over the shard's columns only. The
    shards' sums added up, divided by ``adaptive_w_counts(W, out_w)``, are
    the whole image's pool."""
    *_, H, w, C = x.shape
    oh, ow = out_hw
    mh = torch.as_tensor(_adaptive_matrix(H, oh), dtype=x.dtype, device=x.device)
    member = (_adaptive_matrix(W, ow) > 0).astype(np.float32)[:, w0:w0 + w]
    mw = torch.as_tensor(member, dtype=x.dtype, device=x.device)
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


GAUSS_REACH = 6   # columns of input an output of ``gaussian_downsample`` reads on each side


def _bd_blur(x, scale: int, w_pad: tuple[int, int], w_crop: int):
    """The BD blur of (..., H, W, C): H reflect-padded by 6 + 2*scale and 2
    output rows cropped from each side, W reflect-padded by ``w_pad`` and
    ``w_crop`` output columns cropped; the blur and the stride are two
    products with fixed matrices."""
    if scale not in (2, 3, 4):
        raise ValueError(f"BD scale {scale} unsupported")
    pad = 6 + scale * 2
    *lead, H, W, C = x.shape
    xf = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    xp = F.pad(xf, (*w_pad, pad, pad), mode="reflect")
    mh = torch.as_tensor(_strided_blur_matrix(xp.shape[2], scale), dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(_strided_blur_matrix(xp.shape[3], scale), dtype=x.dtype, device=x.device)
    y = torch.einsum("oh,nchw->ncow", mh, xp)
    y = torch.einsum("pw,ncow->ncop", mw, y)
    y = y[:, :, 2:-2, w_crop:y.shape[3] - w_crop].permute(0, 2, 3, 1)
    return y.reshape(*lead, y.shape[1], y.shape[2], C)


def gaussian_downsample(x, scale: int = 4):
    """DUF-style BD degradation of (..., H, W, C): reflect pad (6 + 2*scale),
    13x13 gaussian blur (sigma = 0.4*scale) sampled at stride ``scale``, then
    2 px cropped from each side."""
    pad = 6 + scale * 2
    return _bd_blur(x, scale, (pad, pad), 2)


def gaussian_downsample_w(x, scale: int, left: int, right: int):
    """One W shard's part of ``gaussian_downsample`` of the whole image: x
    carries ``left`` / ``right`` columns of its neighbours (``GAUSS_REACH``,
    or 0 at the image's true edge, which is reflect-padded here as the whole
    image's is). Output column j of the shard reads its columns j*scale - 6
    .. j*scale + 6, as the whole image's does."""
    return _bd_blur(x, scale, (GAUSS_REACH - left, GAUSS_REACH - right), 0)


def _cubic(x):
    """The bicubic kernel (a = -0.5) of MATLAB's imresize."""
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return ((1.5 * x3 - 2.5 * x2 + 1.0) * (x <= 1)
            + (-0.5 * x3 + 2.5 * x2 - 4.0 * x + 2.0) * ((x > 1) & (x <= 2)))


@lru_cache(maxsize=None)
def _matlab_weights(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out, in) contribution matrix of MATLAB's imresize: the kernel
    widened by 1/scale when shrinking (antialiasing), each row normalised to
    1, symmetric boundary (reflection without repeating the edge)."""
    kernel_width = 4.0
    antialias = scale < 1.0
    kw = kernel_width / scale if antialias else kernel_width
    x = np.arange(1, out_size + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kw / 2)
    P = int(math.ceil(kw)) + 2
    idx = left[:, None] + np.arange(P)[None, :]  # (out, P)
    dist = u[:, None] - idx
    wts = scale * _cubic(dist * scale) if antialias else _cubic(dist)
    wts /= wts.sum(axis=1, keepdims=True)
    idx = idx - 1  # 0-based
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx > in_size - 1, 2 * in_size - 1 - idx, idx)
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        for j in range(P):
            m[i, int(idx[i, j])] += wts[i, j]
    return m


@lru_cache(maxsize=None)
def matlab_taps(in_size: int, out_size: int, scale: float) -> tuple[np.ndarray, np.ndarray]:
    """``_matlab_weights`` as taps: ``(idx, wts)``, each ``(out, P)``: row
    o's non-zero columns in increasing order and their weights; a row with
    fewer repeats its last column at weight 0."""
    m = _matlab_weights(in_size, out_size, scale)
    cols = [np.flatnonzero(row) for row in m]
    P = max(len(c) for c in cols)
    idx = np.empty((out_size, P), np.int64)
    wts = np.zeros((out_size, P), np.float32)
    for o, c in enumerate(cols):
        idx[o, :len(c)], idx[o, len(c):] = c, c[-1]
        wts[o, :len(c)] = m[o, c]
    return idx, wts


def matlab_reach(idx: np.ndarray, k: int) -> int:
    """The columns beyond its own k x k cell that an output of a 1/k
    downscale reads (``matlab_taps``' idx), on either side."""
    o = np.arange(idx.shape[0])
    return int(max((o * k - idx.min(axis=1)).max(), (idx.max(axis=1) - (o * k + k - 1)).max(), 0))


def resize_taps(x, axis: int, idx, wts):
    """``sum_j wts[o, j] * x[..., idx[o, j], ...]`` along ``axis``, the taps
    added one after another in j's order: elementwise, so every output
    element is the same sum of the same products wherever it is computed
    (a shard's columns the whole image's bits)."""
    index = torch.as_tensor(idx, device=x.device)
    w = torch.as_tensor(wts, dtype=x.dtype, device=x.device)
    shape = [1] * x.dim()
    shape[axis] = -1
    y = None
    for j in range(index.shape[1]):
        term = x.index_select(axis, index[:, j]) * w[:, j].reshape(shape)
        y = term if y is None else y + term
    return y


def imresize_matlab(x, scale: float):
    """MATLAB-compatible bicubic resize of (..., H, W, C) by ``scale``: the
    taps of ``_matlab_weights`` along H, then along W (``resize_taps``)."""
    *_, H, W, C = x.shape
    y = resize_taps(x, x.dim() - 3, *matlab_taps(H, int(H * scale), scale))
    return resize_taps(y, x.dim() - 2, *matlab_taps(W, int(W * scale), scale))
