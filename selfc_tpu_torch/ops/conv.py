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


def kaiming_normal(scale: float = 1.0):
    """``nn.init.kaiming_normal_(a=0, mode='fan_in')`` followed by
    ``weight *= scale``: std ``scale * sqrt(2 / fan_in)``."""

    def init(shape, generator=None):
        fan_in, _ = _fans(shape)
        return scale * math.sqrt(2.0 / fan_in) * torch.randn(shape, generator=generator)

    return init


def lecun_normal(shape, generator=None):
    """flax's default kernel init (``nn.Conv`` / ``nn.Dense``): a normal
    truncated at 2 std whose variance is 1 / fan_in."""
    fan_in, _ = _fans(shape)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std, generator=generator)


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


def conv2d(x, w, b=None):
    """Stride-1 SAME 2-D conv on (N,H,W,C); w: (kh,kw,Cin,Cout), odd kh and
    kw. Plain PyTorch: the JAX package computes it outside any Pallas kernel
    (selfc_tpu/ops/conv.py:conv2d)."""
    kh, kw = w.shape[:2]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def conv2d_same_strided(x, w, b=None, stride: int = 2):
    """Strided 2-D conv on (N,H,W,C) with flax / lax ``"SAME"`` padding; w:
    (kh,kw,Cin,Cout). Each side gets ``total = max((ceil(n/s)-1)*s + k - n, 0)``
    padded, ``total // 2`` before and the rest after: a 3x3 stride-2 conv at an
    even size pads 0 before and 1 after, so it samples other pixels than
    ``F.conv2d(padding=1)``. Plain PyTorch, as the JAX package's ``nn.Conv``."""
    pads = []
    for n, k in ((x.shape[2], w.shape[1]), (x.shape[1], w.shape[0])):   # W, then H
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pads), w.permute(3, 2, 0, 1), b, stride=stride)
    return y.permute(0, 2, 3, 1)


def conv3d(x, w, b=None):
    """Stride-1 SAME 3x3x3 conv on (B,T,H,W,C), zero padded in T, H and W;
    w: (3,3,3,Cin,Cout) (kt, kh, kw). Plain PyTorch: the JAX package computes
    it outside any Pallas kernel (selfc_tpu/ops/conv.py:conv3d)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, padding=1)
    return y.permute(0, 2, 3, 4, 1)


def temporal_conv3(x, w, b=None, dilation: int = 1):
    """(3,1,1) conv on (B,T,H,W,C) with dilation d in T, zero padded along T
    (taps t-d, t, t+d); w: (3,Cin,Cout). Three shifted matmuls. The dense
    chains and the dilation-1 convs of the block families take the kernels
    (ops/dense_chain.py, ops/temporal_conv.py); this is their plain building
    block and D2DTEnhance's dilation-2 and -3 conv, plain on both sides."""
    d = dilation
    T = x.shape[1]
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, d, d))
    y = (
        torch.matmul(xp[:, 0:T], w[0])
        + torch.matmul(xp[:, d:T + d], w[1])
        + torch.matmul(xp[:, 2 * d:T + 2 * d], w[2])
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
