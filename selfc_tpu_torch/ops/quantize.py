"""Straight-through-estimator quantization:
``round(clip(x, 0, 1) * 255) / 255`` forward, identity backward.
"""

from __future__ import annotations

import torch


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, quant_v, is_clip):
        # the 255-level rounding runs in fp32: bf16's 8 mantissa bits would
        # move the quantization boundaries by up to half a level
        xq = x.float()
        if is_clip:
            xq = xq.clamp(0.0, 1.0)
        return (torch.round(xq * quant_v) / quant_v).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def quantize_ste(x, quant_v: float = 255.0, is_clip: bool = True):
    return _QuantizeSTE.apply(x, quant_v, is_clip)
