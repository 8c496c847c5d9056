"""Temporal aggregation for the STP prior.

``GlobalAgg`` — non-local T x T temporal attention over pooled frame
tokens, the ``global_module: nonlocal`` of every shipped config. These are
small products, left to ``torch.matmul``/``einsum``. The deformable
aggregations are ROADMAP item A24.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.conv import pointwise, torch_default_b, torch_default_w
from ..ops.resize import adaptive_avg_pool2d


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
        B, T, H, W, C = x.shape
        dt = x.dtype
        x_proj1 = pointwise(x, self.proj1_w.to(dt), self.proj1_b.to(dt))

        pooled = adaptive_avg_pool2d(x, (32, 32)).reshape(B, T, 32 * 32, C)
        tokens = (torch.einsum("btpc,po->btc", pooled, self.fc_w.to(dt))
                  + self.fc_b.to(dt)[0])  # (B,T,C)
        q = tokens @ self.proj2_w.to(dt) + self.proj2_b.to(dt)
        k = tokens @ self.proj3_w.to(dt) + self.proj3_b.to(dt)
        # the softmax stays fp32 (T x T is tiny; exp in bf16 costs accuracy)
        logits = (q @ k.transpose(1, 2)).float() / C
        attn = torch.softmax(logits, dim=-1).to(dt)  # (B,T,T)
        # out frame j = x_j + sum_i attn[i, j] * proj1(x_i)
        weighted = torch.einsum("bihwc,bij->bjhwc", x_proj1, attn)
        return x + weighted
