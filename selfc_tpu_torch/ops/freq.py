"""Frequency split: low/high frequency decomposition of each k x k block.

forward:  lf = area_down_k(x); hf = space_to_depth(x - area_up_k(lf))
          -> concat([lf, hf]) with 3 + 3*k*k channels.
inverse:  area_up_k(y[..., :3]) + depth_to_space_std(y[..., 3:])

The forward uses the block-position-major unshuffle while the inverse uses
the PixelShuffle order — deliberately asymmetric, the trained networks
absorb the fixed permutation (see ops/shuffle.py). The JAX package lowers
both to one strided convolution; this composition is exact and equal to it.
"""

from __future__ import annotations

import torch

from .resize import area_down, area_up
from .shuffle import depth_to_space_std, space_to_depth


def freq_forward(x, k: int):
    lf = area_down(x, k)
    hf = space_to_depth(x - area_up(lf, k), k)
    return torch.cat([lf, hf], dim=-1)


def freq_inverse(y, k: int, c_lf: int = 3):
    lf = y[..., :c_lf]
    hf = y[..., c_lf:]
    return area_up(lf, k) + depth_to_space_std(hf, k)
