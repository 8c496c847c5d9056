"""Dense convolutional building blocks (the "subnets"), channels-last on
``(B, T, H, W, C)`` videos.

Ported so far: ``D2DT`` — four growing 3x3 spatial convs with
LeakyReLU(0.2) whose outputs are concatenated onto the input, then one
(3,1,1) temporal conv over the whole concat. It is the F/G/H subnet of
every coupling block and the local block of the STP prior. The other block
families are ROADMAP item A23.

Initialization:
  * INN blocks ('inn_xavier'): conv1-4 xavier_normal x0.1, conv5 all-zero;
  * prior blocks ('plain_xavier'): xavier_normal x1 on all five;
  biases zero.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import dense_chain as _dc
from ..ops.conv import xavier_normal, zeros_init


def _w_init(mode: str, layer: str):
    if mode == "inn_xavier":
        return zeros_init if layer == "proj" else xavier_normal(0.1)
    if mode == "plain_xavier":
        return xavier_normal(1.0)
    raise ValueError(mode)


_KIND_SHAPES = {
    "s": lambda ci, co: (3, 3, ci, co),
    "t": lambda ci, co: (3, ci, co),
    "p": lambda ci, co: (ci, co),
}


class _ConvP(nn.Module):
    """One conv parameter pair: ``weight`` in the layout of its kind
    ('s' spatial (3,3,Cin,Cout), 't' temporal (3,Cin,Cout), 'p' pointwise
    (Cin,Cout)) and ``bias`` (Cout,)."""

    def __init__(self, c_in, c_out, kind="s", w_init=None, generator=None):
        super().__init__()
        wi = w_init if w_init is not None else xavier_normal(1.0)
        self.kind = kind
        self.weight = nn.Parameter(wi(_KIND_SHAPES[kind](c_in, c_out), generator))
        self.bias = nn.Parameter(torch.zeros(c_out))


class DenseChain(nn.Module):
    """The 5-conv growing-dense chain with k1='s' and k5='t'.

    ``save_feats`` (an attribute, default true): keep the chain's
    ``(B,T,H,W,128)`` features from the forward for the backward; false
    makes the backward recompute them. ``SelfCNetGMM`` sets it on all its
    chains from ``train.save_chain_feats``."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier",
                 generator=None):
        super().__init__()
        self.save_feats = True
        grow = _w_init(init_mode, "grow")
        proj = _w_init(init_mode, "proj")
        for i in range(4):
            setattr(self, f"conv{i + 1}",
                    _ConvP(c_in + i * gc, gc, "s", grow, generator))
        self.conv5 = _ConvP(c_in + 4 * gc, c_out, "t", proj, generator)

    def forward(self, x, ep=None):
        """ep: optional fused coupling epilogue ``(mode, clamp, a, m)``
        applied to the chain output (see ops.dense_chain.ep_apply)."""
        convs = [getattr(self, f"conv{i + 1}") for i in range(4)]
        mode, clamp, a, m = ep if ep is not None else ("none", 1.0, None, None)
        return _dc.dense_chain_t_ep(
            x, [c.weight for c in convs], [c.bias for c in convs],
            self.conv5.weight, self.conv5.bias, mode, clamp, a, m,
            save_feats=self.save_feats,
        )


class D2DT(nn.Module):
    """2D-spatial + 1D-temporal dense block."""

    SUPPORTS_EP = True  # InvBlockExp may pass a fused coupling epilogue

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier",
                 generator=None):
        super().__init__()
        self.chain = DenseChain(c_in, c_out, gc, init_mode, generator)

    def forward(self, x, ep=None):  # (B,T,H,W,C)
        return self.chain(x, ep=ep)


def subnet(net_structure: str, init_mode: str = "xavier"):
    """Constructor factory: ``ctor(c_in, c_out, gc=32, generator=None)``."""
    if net_structure != "D2DTNet":
        raise NotImplementedError(
            f"subnet type {net_structure!r} is not ported yet (ROADMAP A23); "
            "only 'D2DTNet' is"
        )
    if init_mode != "xavier":
        raise NotImplementedError(
            f"init {init_mode!r} is not ported yet (ROADMAP A23); only 'xavier' is"
        )

    def ctor(c_in, c_out, gc=32, generator=None):
        return D2DT(c_in, c_out, gc, "inn_xavier", generator)

    return ctor
