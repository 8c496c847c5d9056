"""STPNet — the self-conditioned spatio-temporal prior over HF latents.

``STPNet`` is the prior of the SelfC_GMM and SelfC_GMM_Codec nets,
``STPNetSmall`` the Haar net's (``blk1`` = three stacked D2DT, 3 -> 12 ->
24 -> 48, then ``blk2``; or two FeatureCollapse blocks).

Input is the LR video ``(B, T, h, w, 3)``; output is the raw tail tensor:
``(B,T,h,w,hf_dim)`` for fh_loss='l2' or ``(B,T,h,w,hf_dim*K*3)`` for GMM.
Sampling and NLL are pure functions in ops/gmm.py.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.conv import leaky_relu, pointwise, torch_default_b, torch_default_w
from .agg import DeformConvAgg, GlobalAgg, GroupedGlobalDeformAgg
from .blocks import D2DT, FeatureCollapse


def _global_module(kind: str, c: int, generator=None, frames=3, deform_radius=None):
    if kind == "nonlocal":
        return GlobalAgg(c, generator)
    if kind == "deform":
        return DeformConvAgg(c, frames, deform_radius, generator)
    if kind == "grouped_global_deform":
        return GroupedGlobalDeformAgg(c, frames, deform_radius=deform_radius, generator=generator)
    return None


class _PW(nn.Module):
    """1x1x1 conv with the default Conv init."""

    def __init__(self, c_in, c_out, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch_default_w((c_in, c_out), generator))
        self.bias = nn.Parameter(torch_default_b(c_in)((c_out,), generator))

    def forward(self, x):
        return pointwise(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class STPNet(nn.Module):
    """``forward = tail(backbone(lr))``: D2DT chains interleaved with
    global aggregations, then the GMM-parameter MLP. ``frames`` (the clip
    length) and ``deform_radius`` reach the deformable aggregations only."""

    def __init__(self, scale=4, stp_blk_num=6, fh_loss="gmm", gmm_k=5,
                 global_module="nonlocal", hidden_c=64, gc=32, deform_radius=None,
                 frames=3, generator=None):
        super().__init__()
        self.stp_blk_num = stp_blk_num
        self.fh_loss = fh_loss
        self.hf_dim = 3 * scale * scale
        c, g = hidden_c, generator

        def agg():
            return _global_module(global_module, c, g, frames, deform_radius)

        def reg(name, mod):
            if mod is None:
                setattr(self, name, None)
            else:
                self.add_module(name, mod)

        # creation order follows the JAX package's setup()
        self.local_m1 = D2DT(3, c, gc, "plain_xavier", g)
        self.local_m2 = D2DT(c, c, gc, "plain_xavier", g)
        reg("global_m1", agg())
        reg("global_m2", agg())
        for i in range(stp_blk_num - 2):
            reg(f"other_local_{i}", D2DT(c, c, gc, "plain_xavier", g))
            reg(f"other_global_{i}", agg())
        if fh_loss == "l2":
            self.tail_0 = _PW(c, self.hf_dim, g)
        elif fh_loss == "gmm":
            self.tail_0 = _PW(c, 2 * c, g)
            self.tail_1 = _PW(2 * c, 4 * c, g)
            self.tail_2 = _PW(4 * c, self.hf_dim * gmm_k * 3, g)
        elif fh_loss == "gmm_thin":
            self.tail_0 = _PW(c, c, g)
            self.tail_1 = _PW(c, c, g)
            self.tail_2 = _PW(c, self.hf_dim * gmm_k * 3, g)
        else:
            raise ValueError(fh_loss)

    def backbone(self, lr):  # (B,T,h,w,3) -> (B,T,h,w,hidden_c)
        x = self.local_m1(lr)
        if self.global_m1 is not None:
            x = self.global_m1(x)
        x = self.local_m2(x)
        if self.global_m2 is not None:
            x = self.global_m2(x)
        for i in range(self.stp_blk_num - 2):
            x = getattr(self, f"other_local_{i}")(x)
            gm = getattr(self, f"other_global_{i}")
            if gm is not None:
                x = gm(x)
        return x

    def tail(self, x):  # (B,T,h,w,hidden_c) -> raw GMM params / l2 mean
        if self.fh_loss == "l2":
            return self.tail_0(leaky_relu(x))
        if self.fh_loss == "gmm":
            x = self.tail_0(leaky_relu(x))
            x = self.tail_1(leaky_relu(x))
            return self.tail_2(leaky_relu(x))
        x = torch.relu(self.tail_0(leaky_relu(x)))
        x = torch.relu(self.tail_1(x))
        return self.tail_2(x)

    def forward(self, lr):
        return self.tail(self.backbone(lr))


class STPNetSmall(nn.Module):
    """The Haar net's prior (``selfc_tpu/models/stp.py:STPNetSmall``).
    ``condition_func`` 'D2DTNet': ``blk1_0..2`` (D2DT 3->12->24->48) and
    ``blk2`` (D2DT 48->c); anything else: ``blk1`` (FeatureCollapse 3->12)
    and ``blk2`` (FeatureCollapse 12->c); c = ``stp_temporal_c``. Tail: 'l2'
    one pointwise conv c->hf_dim, else three (c->c->c->hf_dim*K*3), each
    after a LeakyReLU."""

    def __init__(self, stp_temporal_c=32, fh_loss="gmm", gmm_k=5, condition_func="D2DTNet",
                 hf_dim=9, generator=None):
        super().__init__()
        c, g = stp_temporal_c, generator
        self.fh_loss = fh_loss
        self.d2dt = condition_func == "D2DTNet"
        if self.d2dt:
            self.blk1_0 = D2DT(3, 12, generator=g)
            self.blk1_1 = D2DT(12, 24, generator=g)
            self.blk1_2 = D2DT(24, 48, generator=g)
            self.blk2 = D2DT(48, c, generator=g)
        else:
            self.blk1 = FeatureCollapse(3, 12, generator=g)
            self.blk2 = FeatureCollapse(12, c, generator=g)
        if fh_loss == "l2":
            self.tail_0 = _PW(c, hf_dim, g)
        else:
            self.tail_0 = _PW(c, c, g)
            self.tail_1 = _PW(c, c, g)
            self.tail_2 = _PW(c, hf_dim * gmm_k * 3, g)

    def blocks(self):
        """The conditioning blocks, in order."""
        if self.d2dt:
            return [self.blk1_0, self.blk1_1, self.blk1_2, self.blk2]
        return [self.blk1, self.blk2]

    def tail(self, x):  # (B,T,h,w,c) -> raw GMM params / l2 mean
        x = self.tail_0(leaky_relu(x))
        if self.fh_loss == "l2":
            return x
        x = self.tail_1(leaky_relu(x))
        return self.tail_2(leaky_relu(x))

    def forward(self, lr):
        x = lr
        for blk in self.blocks():
            x = blk(x)
        return self.tail(x)
