"""Temporal aggregation for the STP prior and the codec's de-artifact net.

``GlobalAgg`` — non-local T x T temporal attention over pooled frame
tokens, the ``global_module: nonlocal`` of every shipped config. These are
small products, left to ``torch.matmul``/``einsum``.

``DeformConvAgg`` / ``GroupedGlobalDeformAgg`` — aggregation by the
modulated deformable conv (``ops/deform.py``, kernel B5 on the card):
``global_module: deform | grouped_global_deform`` of the STP prior, and
``GroupedGlobalDeformAgg`` inside ``SelfCNetCodec(deart_net=True)``. Their
offset and modulator convs have ``T*T`` pairs of outputs, so their parameter
shapes depend on the clip length ``frames``; the JAX package takes it from
the clip its model wrappers initialise with, the port at construction.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import deform as df
from ..ops.conv import (conv2d, leaky_relu, pointwise, torch_default_b, torch_default_w,
                        zeros_init)
from ..ops.resize import adaptive_avg_pool2d


def _deform_fn(radius):
    """The exact deformable conv (``radius`` None: the kernel on the card),
    or the windowed formulation with each tap's total displacement bounded
    by ``radius`` (plain tensor code)."""
    if radius:
        return lambda x, off, mod, w, b: df.deform_conv2d_windowed(x, off, mod, w, b, radius=radius)
    return lambda x, off, mod, w, b: df.deform_conv2d(x, off, mod, w, b)


def _pair_sum(dconv, x_frame, offs, mods, w, b):
    """sum_t dconv(x_frame, offs[t], mods[t]), each call adding the bias
    (the JAX package's ``_scan_pair_sum``: T pairs add T * b)."""
    return sum(dconv(x_frame, o, m, w, b) for o, m in zip(offs, mods))


def _check_frames(x, frames):
    if x.shape[1] != frames:
        raise ValueError(f"clip of {x.shape[1]} frames: the module was built for {frames}")


class GlobalAgg(nn.Module):
    """x: (B, T, H, W, C) -> same shape; residual temporal attention."""

    def __init__(self, c: int, generator=None):
        super().__init__()
        g = generator
        self.proj1_w = nn.Parameter(torch_default_w((c, c), g))
        self.proj1_b = nn.Parameter(torch_default_b(c)((c,), g))
        self.fc_w = nn.Parameter(torch_default_w((32 * 32, 1), g))
        self.fc_b = nn.Parameter(torch_default_b(32 * 32)((1,), g))
        self.proj2_w = nn.Parameter(torch_default_w((c, c), g))
        self.proj2_b = nn.Parameter(torch_default_b(c)((c,), g))
        self.proj3_w = nn.Parameter(torch_default_w((c, c), g))
        self.proj3_b = nn.Parameter(torch_default_b(c)((c,), g))

    def forward(self, x):
        return self.mix(x, self.attention(adaptive_avg_pool2d(x, (32, 32))))

    def attention(self, pooled):
        """The pooled map ``(B, T, 32, 32, C)`` -> the ``(B, T, T)``
        attention weights. The image width split (``parallel/spatial.py``)
        pools by shards and runs this on the whole pooled map."""
        B, T, _, _, C = pooled.shape
        dt = pooled.dtype
        tokens = (torch.einsum("btpc,po->btc", pooled.reshape(B, T, 32 * 32, C), self.fc_w.to(dt))
                  + self.fc_b.to(dt)[0])  # (B,T,C)
        q = tokens @ self.proj2_w.to(dt) + self.proj2_b.to(dt)
        k = tokens @ self.proj3_w.to(dt) + self.proj3_b.to(dt)
        # the softmax stays fp32 (T x T is tiny; exp in bf16 costs accuracy)
        logits = (q @ k.transpose(1, 2)).float() / C
        return torch.softmax(logits, dim=-1).to(dt)  # (B,T,T)

    def mix(self, x, attn):
        """out frame j = x_j + sum_i attn[i, j] * proj1(x_i); pointwise in space."""
        dt = x.dtype
        x_proj1 = pointwise(x, self.proj1_w.to(dt), self.proj1_b.to(dt))
        return x + torch.einsum("bihwc,bij->bjhwc", x_proj1, attn)


class DeformConvAgg(nn.Module):
    """Temporal aggregation by modulated deformable conv (reference
    DeformConvAgg): output frame t1 adds ``sum_t2 deform(x[t1],
    offset(t1, t2))`` through a zero-init projection. ``deform_radius``
    (``network_G.deform_radius``) takes the windowed formulation; None the
    exact one."""

    def __init__(self, c: int, frames: int = 3, deform_radius=None, generator=None):
        super().__init__()
        g, T, kk = generator, frames, 9
        self.frames, self.deform_radius = frames, deform_radius
        # creation order and inits as the JAX module's
        self.offset_w = nn.Parameter(zeros_init((3, 3, T * c, 2 * kk * T * T)))
        self.offset_b = nn.Parameter(zeros_init((2 * kk * T * T,)))
        self.modulator_w = nn.Parameter(zeros_init((3, 3, T * c, kk * T * T)))
        self.modulator_b = nn.Parameter(zeros_init((kk * T * T,)))
        self.regular_w = nn.Parameter(torch_default_w((3, 3, c, c), g))
        self.regular_b = nn.Parameter(torch_default_b(c * kk)((c,), g))
        self.proj_w = nn.Parameter(zeros_init((c, c)))

    def forward(self, x):
        _check_frames(x, self.frames)
        B, T, H, W, C = x.shape
        dt = x.dtype  # fp32 masters cast to the activation dtype
        x_stacked = x.permute(0, 2, 3, 1, 4).reshape(B, H, W, T * C)
        offset = conv2d(x_stacked, self.offset_w.to(dt), self.offset_b.to(dt))
        modulator = 2.0 * torch.sigmoid(conv2d(x_stacked, self.modulator_w.to(dt), self.modulator_b.to(dt)))
        offset = offset.reshape(B, H, W, T * T, 18)
        modulator = modulator.reshape(B, H, W, T * T, 9)
        # out[t1] = sum_t2 deform(x[t1], offset chunk t1*T + t2)
        dconv = _deform_fn(self.deform_radius)
        w, b = self.regular_w.to(dt), self.regular_b.to(dt)
        agg = torch.stack([
            _pair_sum(dconv, x[:, t1], offset[..., t1 * T:(t1 + 1) * T, :].unbind(3),
                      modulator[..., t1 * T:(t1 + 1) * T, :].unbind(3), w, b)
            for t1 in range(T)], dim=1)
        return x + pointwise(agg, self.proj_w.to(dt))


class GroupedGlobalDeformAgg(nn.Module):
    """Grouped global context reallocation, then deformable aggregation
    (reference GroupedGlobalDeformAgg): ``x_enh = x + realloc(x)`` over
    ``groups`` channel groups of the T frames, then output frame t adds
    ``sum_t_in deform(x_enh[t], offset(t, t_in))``: the source frame is
    repeated across t_in, as the reference repeats it."""

    def __init__(self, c: int, frames: int = 3, groups: int = 4, deform_radius=None,
                 generator=None):
        super().__init__()
        g, T, kk = generator, frames, 9
        self.frames, self.groups, self.deform_radius = frames, groups, deform_radius
        gcp = T * (c // groups)
        self.realloc1_w = nn.Parameter(torch_default_w((3, 3, gcp, gcp), g))
        self.realloc1_b = nn.Parameter(torch_default_b(gcp * 9)((gcp,), g))
        self.realloc2_w = nn.Parameter(zeros_init((3, 3, gcp, gcp)))
        self.realloc2_b = nn.Parameter(zeros_init((gcp,)))
        self.offset_w = nn.Parameter(zeros_init((3, 3, c, 2 * kk * T)))
        self.offset_b = nn.Parameter(zeros_init((2 * kk * T,)))
        self.modulator_w = nn.Parameter(zeros_init((3, 3, c, kk * T)))
        self.modulator_b = nn.Parameter(zeros_init((kk * T,)))
        self.regular_w = nn.Parameter(zeros_init((3, 3, c, c)))
        self.regular_b = nn.Parameter(zeros_init((c,)))

    def deform_inputs(self, x):
        """``(x_enh (B,T,H,W,C), offset (B,T,H,W,T,18), modulator
        (B,T,H,W,T,9))``: what the deformable convs of ``forward`` take,
        ``[:, t_out, ..., t_in, :]`` for the pair (t_out, t_in)."""
        _check_frames(x, self.frames)
        B, T, H, W, C = x.shape
        g = self.groups
        cg = C // g
        dt = x.dtype  # fp32 masters cast to the activation dtype
        xg = x.reshape(B, T, H, W, g, cg).permute(0, 4, 2, 3, 1, 5).reshape(B * g, H, W, T * cg)
        h = leaky_relu(conv2d(xg, self.realloc1_w.to(dt), self.realloc1_b.to(dt)), 0.2)
        h = conv2d(h, self.realloc2_w.to(dt), self.realloc2_b.to(dt))
        xe = (xg + h).reshape(B, g, H, W, T, cg).permute(0, 4, 2, 3, 1, 5)
        x_enh = xe.reshape(B, T, H, W, C)
        xf = x_enh.reshape(B * T, H, W, C)
        offset = conv2d(xf, self.offset_w.to(dt), self.offset_b.to(dt)).reshape(B, T, H, W, T, 18)
        modulator = 2.0 * torch.sigmoid(conv2d(xf, self.modulator_w.to(dt), self.modulator_b.to(dt)))
        return x_enh, offset, modulator.reshape(B, T, H, W, T, 9)

    def forward(self, x):
        x_enh, offset, modulator = self.deform_inputs(x)
        dt = x.dtype
        dconv = _deform_fn(self.deform_radius)
        w, b = self.regular_w.to(dt), self.regular_b.to(dt)
        agg = torch.stack([
            _pair_sum(dconv, x_enh[:, t], offset[:, t].unbind(3), modulator[:, t].unbind(3), w, b)
            for t in range(x.shape[1])], dim=1)
        return x_enh + agg
