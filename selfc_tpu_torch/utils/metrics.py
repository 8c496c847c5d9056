"""Image quality metrics on channels-last frames in [0, 1]: the JAX
package's ``utils/metrics.py`` (reference utils/util.py).

* ``psnr``: per-frame PSNR over all channels.
* ``ssim`` / ``ms_ssim``: separable 11-tap Gaussian (sigma 1.5) with valid
  padding; MS weights [0.0448, 0.2856, 0.3001, 0.2363, 0.1333], the
  reference's padding of odd sizes before each 2x average pool, and its
  quirk that ``val ** w[-1]`` sits inside the product over levels.
* ``rgb_to_ycbcr``: ITU-R BT.601 with delta 0.5. The reference's "Y
  channel" metrics feed the full 3-channel YCbCr tensor to PSNR / SSIM
  (``eval/rescaling.py``).

SSIM's variances are ``E[X^2] - mu^2``: rounded products cancel there (on a
TPU bf16-operand convolutions drove SSIM to 2.63 and -0.51), so the blur is
11 shifted fp32 multiply-adds along each axis and no convolution, whose
precision a global flag (cuDNN's ``allow_tf32``) could change.
"""

from __future__ import annotations

import numpy as np
import torch

_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def rgb_to_ycbcr(img):
    """(..., H, W, 3) RGB -> YCbCr (ITU-R BT.601, delta 0.5)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) * 0.564 + 0.5
    cr = (r - y) * 0.713 + 0.5
    return torch.stack([y, cb, cr], dim=-1)


def psnr(img1, img2):
    """Per-frame PSNR. imgs: (N, H, W, C) in [0,1]; returns (N,)."""
    img1 = torch.as_tensor(img1).float()
    img2 = torch.as_tensor(img2).float()
    mse = torch.mean((img1 - img2) ** 2, dim=(-3, -2, -1))
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def _gauss_win(size=11, sigma=1.5):
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32).tolist()


def _blur(x, win):
    """Separable valid-padding blur of (N, H, W, C) fp32, one shifted
    multiply-add a tap along H, then along W."""
    k = len(win)
    for dim in (1, 2):
        n = x.shape[dim] - k + 1
        acc = x.narrow(dim, 0, n) * win[0]
        for i in range(1, k):
            acc = acc + x.narrow(dim, i, n) * win[i]
        x = acc
    return x


def _ssim_full(X, Y, data_range=1.0, win_size=11, win_sigma=1.5):
    X = torch.as_tensor(X).float()
    Y = torch.as_tensor(Y).float()
    win = _gauss_win(win_size, win_sigma)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu1 = _blur(X, win)
    mu2 = _blur(Y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _blur(X * X, win) - mu1_sq
    s2 = _blur(Y * Y, win) - mu2_sq
    s12 = _blur(X * Y, win) - mu1_mu2
    cs_map = (2 * s12 + C2) / (s1 + s2 + C2)
    ssim_map = ((2 * mu1_mu2 + C1) / (mu1_sq + mu2_sq + C1)) * cs_map
    return ssim_map.mean(dim=(-3, -2, -1)), cs_map.mean(dim=(-3, -2, -1))


def ssim(X, Y, data_range=1.0):
    """(N,H,W,C) -> (N,) per-image SSIM."""
    val, _ = _ssim_full(X, Y, data_range)
    return val


def _pool2(x):
    """The reference's 2x average pool: pad an odd size by one on both
    sides, then pool with valid padding (the last row or column drops)."""
    ph, pw = x.shape[1] % 2, x.shape[2] % 2
    x = torch.nn.functional.pad(x, (0, 0, pw, pw, ph, ph))
    N, H, W, C = x.shape
    x = x[:, :H - H % 2, :W - W % 2]
    return x.reshape(N, H // 2, 2, W // 2, 2, C).sum(dim=(2, 4)) / 4.0


def ms_ssim(X, Y, data_range=1.0):
    """(N,H,W,C) -> (N,) MS-SSIM."""
    X = torch.as_tensor(X).float()
    Y = torch.as_tensor(Y).float()
    mcs = []
    val = None
    for level in range(len(_MS_WEIGHTS)):
        val, cs = _ssim_full(X, Y, data_range)
        mcs.append(cs)
        if level < len(_MS_WEIGHTS) - 1:
            X, Y = _pool2(X), _pool2(Y)
    weights = torch.tensor(_MS_WEIGHTS, device=val.device)
    mcs = torch.stack(mcs, dim=0)  # (levels, N)
    return torch.prod((mcs[:-1] ** weights[:-1, None]) * (val ** weights[-1]), dim=0)
