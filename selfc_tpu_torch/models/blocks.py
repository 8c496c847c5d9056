"""Dense convolutional building blocks (the "subnets"), channels-last on
``(B, T, H, W, C)`` videos (or ``(N, H, W, C)`` images for the 2-D blocks).

Every block is the same five-conv chain (``DenseChain``): four growing convs
with LeakyReLU(0.2) whose outputs are concatenated onto the input, then a
projection conv over the whole concat. The conv flavours are the JAX
package's: 's' spatial 3x3, 't' temporal (3,1,1), 'p' pointwise, 'f' full
3x3x3. Ported so far:

  * ``D2DT`` (k1 = kmid = 's', k5 = 't'): the F/G/H subnet of every coupling
    block and the local block of the STP prior;
  * ``DenseBlock2D`` (all 's') and ``FeatureCollapse`` (space-to-depth, a
    chain with k1 = k5 = 'f', depth-to-space): the codec surrogate's blocks.

The other block families are ROADMAP item A23.

Initialization:
  * INN blocks ('inn_xavier'): conv1-4 xavier_normal x0.1, conv5 all-zero;
  * prior / surrogate blocks ('plain_xavier'): xavier_normal x1 on all five;
  biases zero.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import dense_chain as _dc
from ..ops.conv import (conv3d, leaky_relu, pointwise, spatial_conv_video,
                        temporal_conv3, xavier_normal, zeros_init)
from ..ops.shuffle import depth_to_space_std, space_to_depth


def _w_init(mode: str, layer: str):
    if mode == "inn_xavier":
        return zeros_init if layer == "proj" else xavier_normal(0.1)
    if mode == "plain_xavier":
        return xavier_normal(1.0)
    raise ValueError(mode)


_KIND_SHAPES = {
    "s": lambda ci, co: (3, 3, ci, co),
    "f": lambda ci, co: (3, 3, 3, ci, co),
    "t": lambda ci, co: (3, ci, co),
    "p": lambda ci, co: (ci, co),
}

_KIND_CONV = {"s": spatial_conv_video, "f": conv3d, "t": temporal_conv3, "p": pointwise}


class _ConvP(nn.Module):
    """One conv parameter pair: ``weight`` in the layout of its kind
    (``_KIND_SHAPES``) and ``bias`` (Cout,)."""

    def __init__(self, c_in, c_out, kind="s", w_init=None, generator=None):
        super().__init__()
        wi = w_init if w_init is not None else xavier_normal(1.0)
        self.kind = kind
        self.weight = nn.Parameter(wi(_KIND_SHAPES[kind](c_in, c_out), generator))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        # the activations set the compute dtype: fp32 master parameters are
        # cast down when the caller runs the net in bf16
        return _KIND_CONV[self.kind](x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class DenseChain(nn.Module):
    """The shared 5-conv growing-dense chain, dispatched as the JAX
    package's (selfc_tpu/models/blocks.py:DenseChain):

      * k1 = kmid = 's', k5 = 't', gc <= 32, a video: the whole chain through
        ``dense_chain_t_ep`` (its kernel's epilogue takes ``ep``);
      * k1 = kmid = 's', gc = 32, k5 != 't': the four spatial convs through
        ``fused_dense_spatial``, conv5 over ``[x | x1..x4]`` outside;
      * anything else: the plain convs.

    The JAX gates add the TPU's layout conditions (``chain_shapes_ok``,
    ``chain_v2_shapes_ok``: W a multiple of 16, an H tile, a VMEM budget);
    the Hopper kernels take any H and W, so the port leaves those out and a
    chain takes its kernel at every shape.

    ``save_feats`` (an attribute, default true): keep the chain's features
    from the forward for the backward on the first route; false makes the
    backward recompute them. The nets set it from ``train.save_chain_feats``."""

    def __init__(self, c_in, c_out, gc=32, k1="s", k5="t", init_mode="inn_xavier",
                 is_res=False, kmid="s", generator=None):
        super().__init__()
        self.save_feats = True
        self.gc, self.is_res = gc, bool(is_res)
        self.k1, self.kmid, self.k5 = k1, kmid, k5
        grow = _w_init(init_mode, "grow")
        proj = _w_init(init_mode, "proj")
        for i in range(4):
            setattr(self, f"conv{i + 1}",
                    _ConvP(c_in + i * gc, gc, k1 if i == 0 else kmid, grow, generator))
        self.conv5 = _ConvP(c_in + 4 * gc, c_out, k5, proj, generator)

    def _convs(self):
        return [getattr(self, f"conv{i + 1}") for i in range(4)]

    def forward(self, x, ep=None):
        """ep: optional fused coupling epilogue ``(mode, clamp, a, m)``
        applied to the chain output (see ops.dense_chain.ep_apply); not with
        ``is_res``."""
        if ep is not None and self.is_res:
            raise ValueError("ep epilogue requires is_res=False")
        convs = self._convs()
        spatial = self.k1 == "s" and self.kmid == "s"
        if spatial and self.k5 == "t" and self.gc <= _dc.GC_MAX and x.dim() == 5:
            mode, clamp, a, m = ep if ep is not None else ("none", 1.0, None, None)
            y = _dc.dense_chain_t_ep(
                x, [c.weight for c in convs], [c.bias for c in convs],
                self.conv5.weight, self.conv5.bias, mode, clamp, a, m,
                save_feats=self.save_feats)
            return y + x if self.is_res else y
        if spatial and self.gc == _dc.GC_MAX and self.k5 != "t":
            x1234 = _dc.fused_dense_spatial(x, [c.weight for c in convs], [c.bias for c in convs])
            y = self.conv5(torch.cat([x, x1234], dim=-1))
        else:
            feats = x
            for c in convs:
                feats = torch.cat([feats, leaky_relu(c(feats))], dim=-1)
            y = self.conv5(feats)
        if self.is_res:
            y = y + x
        if ep is not None:
            mode, clamp, a, m = ep
            y = _dc.ep_apply(y, mode, clamp, a, m)
        return y


class D2DT(nn.Module):
    """2D-spatial + 1D-temporal dense block."""

    SUPPORTS_EP = True  # InvBlockExp may pass a fused coupling epilogue

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier",
                 generator=None):
        super().__init__()
        self.chain = DenseChain(c_in, c_out, gc, "s", "t", init_mode, generator=generator)

    def forward(self, x, ep=None):  # (B,T,H,W,C)
        return self.chain(x, ep=ep)


class DenseBlock2D(nn.Module):
    """2-D dense block (reference DenseBlock): a chain of spatial convs on
    ``(N,H,W,C)`` images or on every frame of a video."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", is_res=False,
                 generator=None):
        super().__init__()
        self.chain = DenseChain(c_in, c_out, gc, "s", "s", init_mode, is_res,
                                generator=generator)

    def forward(self, x):
        return self.chain(x)


class FeatureCollapse(nn.Module):
    """Space-to-depth -> 3-D dense chain -> depth-to-space (reference
    FeatureCalapseBlock). The way down uses the block-position-major channel
    order and the way up the PixelShuffle order, as the reference does."""

    def __init__(self, c_in, c_out, scale=4, gc=32, init_mode="inn_xavier",
                 is_res=False, generator=None):
        super().__init__()
        s = scale
        self.scale, self.is_res = s, bool(is_res)
        self.chain = DenseChain(s * s * c_in, s * s * c_out, s * gc, "f", "f", init_mode,
                                generator=generator)

    def forward(self, x):  # (B,T,H,W,C)
        s = self.scale
        y = space_to_depth(x, s) if s > 1 else x
        y = self.chain(y)
        y = depth_to_space_std(y, s) if s > 1 else y
        return y + x if self.is_res else y


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
