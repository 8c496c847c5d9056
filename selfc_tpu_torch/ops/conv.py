"""Convolution primitives and initializers, channels-last.

  * images: ``(N, H, W, C)``;  videos: ``(B, T, H, W, C)``.

Weights keep the JAX package's layouts: spatial ``(3, 3, Cin, Cout)``,
temporal ``(3, Cin, Cout)``, pointwise ``(Cin, Cout)``. These are the plain
building blocks; the dense chain's hot path has its own kernel
(ops/dense_chain.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _fans(shape):
    """fan_in/fan_out of a conv kernel ``(*spatial, Cin, Cout)`` or a dense
    kernel ``(in, out)``."""
    receptive = 1
    for s in shape[:-2]:
        receptive *= s
    return shape[-2] * receptive, shape[-1] * receptive


def xavier_normal(scale: float = 1.0, gain: float = 1.0):
    """``nn.init.xavier_normal_`` followed by ``weight *= scale``."""

    def init(shape, generator=None):
        fan_in, fan_out = _fans(shape)
        std = gain * math.sqrt(2.0 / (fan_in + fan_out))
        return scale * std * torch.randn(shape, generator=generator)

    return init


def zeros_init(shape, generator=None):
    return torch.zeros(shape)


def torch_default_w(shape, generator=None):
    """Default Conv/Linear weight init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    fan_in, _ = _fans(shape)
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def torch_default_b(fan_in: int):
    """Default bias init U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def init(shape, generator=None):
        bound = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    return init


def spatial_conv_video(x, w, b=None):
    """Stride-1 SAME 3x3 conv applied to every frame of (B,T,H,W,C), or to
    every image of (N,H,W,C); w: (3,3,Cin,Cout)."""
    *lead, H, W, C = x.shape
    y = F.conv2d(
        x.reshape(-1, H, W, C).permute(0, 3, 1, 2),
        w.permute(3, 2, 0, 1), b, padding=1,
    )
    return y.permute(0, 2, 3, 1).reshape(*lead, H, W, -1)


def conv3d(x, w, b=None):
    """Stride-1 SAME 3x3x3 conv on (B,T,H,W,C), zero padded in T, H and W;
    w: (3,3,3,Cin,Cout) (kt, kh, kw). Plain PyTorch: the JAX package computes
    it outside any Pallas kernel (selfc_tpu/ops/conv.py:conv3d)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, padding=1)
    return y.permute(0, 2, 3, 4, 1)


def temporal_conv3(x, w, b=None):
    """(3,1,1) conv on (B,T,H,W,C), zero padded along T; w: (3,Cin,Cout).
    Three shifted matmuls."""
    T = x.shape[1]
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    y = (
        torch.matmul(xp[:, 0:T], w[0])
        + torch.matmul(xp[:, 1:T + 1], w[1])
        + torch.matmul(xp[:, 2:T + 2], w[2])
    )
    if b is not None:
        y = y + b
    return y


def pointwise(x, w, b=None):
    """1x1(x1) conv as a matmul on the last axis. w: (Cin, Cout)."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def leaky_relu(x, negative_slope: float = 0.2):
    return torch.where(x >= 0, x, negative_slope * x)
