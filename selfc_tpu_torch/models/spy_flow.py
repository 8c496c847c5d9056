"""SpyNet optical flow, the post-warp refinement net and the
motion-consistency loss (the JAX package's ``models/spy_flow.py``).

Channels-last images ``(N, H, W, C)``; parameters under the flax tree's
names (``modelL{i}.conv{j}.{kernel, bias}``, kernels HWIO). ``MESpynet`` is
the 4-level coarse-to-fine flow, ``WarpNet`` the refinement U-net,
``flow_warp`` the bilinear warp with border padding (the JAX package's own
four taps and clamping, not ``grid_sample``), ``motion_flow_loss`` the LR
flow against the area-downsampled HR flow. ``load_spynet_npy`` imports DVC's
``.npy`` pyramid weights. No model path of the package calls these; they run
in plain PyTorch (library convolutions).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..ops.conv import conv2d, lecun_normal, torch_default_b, torch_default_w


def _resize_matrix(in_size, out_size, align_corners):
    """The bilinear interpolation matrix (out, in) of
    ``F.interpolate(mode='bilinear')`` along one axis."""
    m = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        if align_corners and out_size > 1:
            src = i * (in_size - 1) / (out_size - 1)
        else:
            src = (i + 0.5) * in_size / out_size - 0.5
        src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        w = src - lo
        m[i, lo] += 1 - w
        m[i, hi] += w
    return m


def resize_bilinear(x, out_hw, align_corners=False):
    """(..., H, W, C) -> (..., oh, ow, C) by the two interpolation
    matrices."""
    *_, H, W, C = x.shape
    mh = torch.from_numpy(_resize_matrix(H, out_hw[0], align_corners)).to(x)
    mw = torch.from_numpy(_resize_matrix(W, out_hw[1], align_corners)).to(x)
    y = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("pw,...owc->...opc", mw, y)


def flow_warp(img, flow):
    """Warp ``img`` (N,H,W,C) by ``flow`` (N,H,W,2) (dx, dy in pixels):
    bilinear, the sample position clamped to the image (border padding),
    with ``grid_sample``'s align_corners=False pixel mapping."""
    N, H, W, C = img.shape
    gx = torch.linspace(-1.0, 1.0, W, dtype=img.dtype, device=img.device)[None, None, :]
    gy = torch.linspace(-1.0, 1.0, H, dtype=img.dtype, device=img.device)[None, :, None]
    nx = gx + 2.0 * flow[..., 0] / (W - 1.0)
    ny = gy + 2.0 * flow[..., 1] / (H - 1.0)
    px = torch.clamp(((nx + 1.0) * W - 1.0) * 0.5, 0.0, W - 1.0)
    py = torch.clamp(((ny + 1.0) * H - 1.0) * 0.5, 0.0, H - 1.0)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]
    flat = img.reshape(N, H * W, C)

    def tap(yy, xx):
        yc = torch.clamp(yy, 0, H - 1).long()
        xc = torch.clamp(xx, 0, W - 1).long()
        idx = (yc * W + xc).reshape(N, H * W, 1).expand(N, H * W, C)
        return torch.gather(flat, 1, idx).reshape(N, H, W, C)

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


class _Conv(nn.Module):
    """A flax ``nn.Conv`` at stride 1, 'SAME': ``kernel`` (k, k, Cin, Cout)
    and ``bias``, channels-last."""

    def __init__(self, c_in, c_out, k, generator=None, torch_init=False):
        super().__init__()
        shape = (k, k, c_in, c_out)
        if torch_init:
            w, b = torch_default_w(shape, generator), torch_default_b(c_in * k * k)((c_out,), generator)
        else:
            w, b = lecun_normal(shape, generator), torch.zeros(c_out)
        self.kernel = nn.Parameter(w)
        self.bias = nn.Parameter(b)

    def forward(self, x):
        return conv2d(x, self.kernel, self.bias)


def _avg_pool2(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class MEBasic(nn.Module):
    """One pyramid level: five 7x7 convs 8 -> 32 -> 64 -> 32 -> 16 -> 2, a
    ReLU after the first four (torch's default init, as the reference's)."""

    def __init__(self, generator=None):
        super().__init__()
        c_in = 8
        for i, c in enumerate([32, 64, 32, 16, 2]):
            self.add_module(f"conv{i + 1}", _Conv(c_in, c, 7, generator, torch_init=True))
            c_in = c

    def forward(self, x):
        for i in range(5):
            x = getattr(self, f"conv{i + 1}")(x)
            if i < 4:
                x = F.relu(x)
        return x


class MESpynet(nn.Module):
    """The coarse-to-fine flow over ``levels`` pyramid levels:
    ``(im1, im2)`` (N,H,W,3) -> flow (N,H,W,2); H and W at least
    2^levels."""

    def __init__(self, levels: int = 4, device=None, generator=None):
        super().__init__()
        self.levels = levels
        for i in range(levels):
            self.add_module(f"modelL{i + 1}", MEBasic(generator))
        self.to(resolve_device(device))

    def forward(self, im1, im2):
        min_side = 2 ** self.levels
        if im1.shape[1] < min_side or im1.shape[2] < min_side:
            raise ValueError(f"MESpynet needs H,W >= {min_side} for {self.levels} pyramid levels; "
                             f"got {tuple(im1.shape[1:3])}")
        im1s, im2s = [im1], [im2]
        for _ in range(self.levels - 1):
            im1s.append(_avg_pool2(im1s[-1]))
            im2s.append(_avg_pool2(im2s[-1]))
        coarsest = im2s[-1]
        flow = im1.new_zeros((im1.shape[0], coarsest.shape[1] // 2, coarsest.shape[2] // 2, 2))
        for level in range(self.levels):
            up = resize_bilinear(flow, (flow.shape[1] * 2, flow.shape[2] * 2)) * 2.0
            a = im1s[self.levels - 1 - level]
            b = flow_warp(im2s[self.levels - 1 - level], up)
            flow = up + getattr(self, f"modelL{level + 1}")(torch.cat([a, b, up], dim=-1))
        return flow


class ResBlock(nn.Module):
    """ReLU, 3x3 conv, ReLU, 3x3 conv, plus the input (through a 1x1
    ``adapt_conv`` when the widths differ)."""

    def __init__(self, c_in, c_out, k=3, generator=None):
        super().__init__()
        self.conv1 = _Conv(c_in, c_out, k, generator)
        self.conv2 = _Conv(c_out, c_out, k, generator)
        self.adapt_conv = _Conv(c_in, c_out, 1, generator) if c_in != c_out else None

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.adapt_conv is not None:
            x = self.adapt_conv(x)
        return x + h


class WarpNet(nn.Module):
    """The post-warp refinement U-net: (N,H,W,6) -> (N,H,W,3); H and W
    multiples of 4."""

    def __init__(self, device=None, generator=None):
        super().__init__()
        cn = 64
        self.feature_ext = _Conv(6, cn, 3, generator)
        for i in range(6):
            self.add_module(f"conv{i}", ResBlock(cn, cn, generator=generator))
        self.conv6 = _Conv(cn, 3, 3, generator)
        self.to(resolve_device(device))

    def forward(self, x):
        f = F.relu(self.feature_ext(x))
        c0 = self.conv0(f)
        c1 = self.conv1(_avg_pool2(c0))
        c2 = self.conv2(_avg_pool2(c1))
        c3 = self.conv3(c2)
        c3u = c1 + resize_bilinear(c3, (c3.shape[1] * 2, c3.shape[2] * 2), True)
        c4 = self.conv4(c3u)
        c4u = c0 + resize_bilinear(c4, (c4.shape[1] * 2, c4.shape[2] * 2), True)
        return self.conv6(self.conv5(c4u))


def load_spynet_npy(models_path: str, levels: int = 4) -> dict:
    """DVC's ``modelL{i}_F-{j}-{weight,bias}.npy`` files -> the MESpynet
    tree (OIHW -> HWIO), numpy leaves."""
    params: dict = {}
    for lv in range(levels):
        level = {}
        for ci in range(1, 6):
            w = np.load(os.path.join(models_path, f"modelL{lv + 1}_F-{ci}-weight.npy"))
            b = np.load(os.path.join(models_path, f"modelL{lv + 1}_F-{ci}-bias.npy"))
            level[f"conv{ci}"] = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)), "bias": b}
        params[f"modelL{lv + 1}"] = level
    return params


def motion_flow_loss(flow_net, lr_pair, hr_pair, scale: int = 4):
    """The LR flow against the HR flow averaged over ``scale`` x ``scale``
    cells, both normalised by (size - 1) / 2 per axis: a mean squared error,
    the HR side detached. ``flow_net(a, b)`` -> flow."""
    hr1, hr2 = hr_pair
    lr1, lr2 = lr_pair
    target_mv = flow_net(hr2, hr1)
    th, tw = target_mv.shape[1] // scale, target_mv.shape[2] // scale
    target_mv = target_mv.reshape(target_mv.shape[0], th, scale, tw, scale, 2).mean(dim=(2, 4))
    lr_mv = flow_net(lr2, lr1)

    def norm(mv, h, w):
        return torch.stack([mv[..., 0] / ((w - 1.0) / 2.0), mv[..., 1] / ((h - 1.0) / 2.0)], dim=-1)

    t = norm(target_mv, th, tw)
    lv = norm(lr_mv, lr_mv.shape[1], lr_mv.shape[2])
    return torch.mean((t.detach() - lv) ** 2)
