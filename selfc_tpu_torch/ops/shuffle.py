"""Space<->depth reorderings, channels-last ``(..., H, W, C)``.

Two channel orders are kept on purpose (the coupling layers split on the
channel axis, so the order is part of the trained function):

* ``space_to_depth`` — block-position-major ``c_out = (s_h*S + s_w)*C + c``;
* ``depth_to_space_std`` — the ``nn.PixelShuffle`` order
  ``c_in = c*S*S + s_h*S + s_w``.

The frequency split pairs the first on the way in with the second on the
way out; they are NOT inverses of each other (see ops/freq.py).
"""

from __future__ import annotations


def _perm(ndim, last5):
    lead = list(range(ndim - 5))
    return lead + [ndim - 5 + i for i in last5]


def space_to_depth(x, S: int):
    """(..., H, W, C) -> (..., H/S, W/S, S*S*C), (s_h, s_w, c)-major."""
    *lead, H, W, C = x.shape
    x = x.reshape(*lead, H // S, S, W // S, S, C)
    x = x.permute(_perm(x.ndim, (0, 2, 1, 3, 4)))
    return x.reshape(*lead, H // S, W // S, S * S * C)


def depth_to_space_std(x, S: int):
    """``nn.PixelShuffle`` order: ``c_in = c*S*S + s_h*S + s_w``."""
    *lead, h, w, CSS = x.shape
    C = CSS // (S * S)
    x = x.reshape(*lead, h, w, C, S, S)
    x = x.permute(_perm(x.ndim, (0, 3, 1, 4, 2)))
    return x.reshape(*lead, h * S, w * S, C)
