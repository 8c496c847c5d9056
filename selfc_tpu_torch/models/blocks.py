"""Dense convolutional building blocks (the "subnets"), channels-last on
``(B, T, H, W, C)`` videos (or ``(N, H, W, C)`` images for the 2-D blocks):
every block family of ``selfc_tpu/models/blocks.py`` and its ``subnet()``
table.

Most blocks are the same five-conv chain (``DenseChain``): four growing convs
with LeakyReLU(0.2) whose outputs are concatenated onto the input, then a
projection conv over the whole concat. The conv flavours are the JAX
package's: 's' spatial 3x3, 't' temporal (3,1,1), 'p' pointwise, 'f' full
3x3x3. The families:

  * ``D2DT`` (k1 = kmid = 's', k5 = 't'): the F/G/H subnet of every coupling
    block and the local block of the STP prior; ``ResD2DT`` adds x;
    ``D2DLT`` adds a zero-init 3x3x3 conv to x1 (``early_3d``);
  * ``D2D`` and ``DenseBlock2D`` (all 's'), ``DenseBlock3D`` (all 'f'),
    ``DenseBlock3DPartial`` (k1 = k5 = 'f');
  * ``FeatureCollapse`` and its 2D / SmallC / Fast variants: space-to-depth,
    a chain, depth-to-space;
  * ``D2DTEnhance``: four spatial convs, three temporal convs at dilations
    1, 2 and 3, a pointwise conv;
  * ``HighOrderTNet`` / ``HighOrderTNet1``: a 3- / 1-level spatial U-Net with
    D2DT blocks inside.

The kernels they reach on a CUDA tensor: a D2DT chain at growth width <= 32
the whole-chain kernel (``ops/dense_chain.py``), a spatial chain at growth 32
with a non-temporal conv5 the spatial-only one, and every other (3,1,1) conv
at dilation 1 the temporal-conv kernel (``ops/temporal_conv.py``): conv5 of
D2DLT, of FeatureCollapseFast (growth 96) and of HighOrderTNet1's inner D2DT
(growth 64), and D2DTEnhance's conv51.

Initialization:
  * INN blocks ('inn_xavier' / 'inn_kaiming'): conv1-4 xavier_normal /
    kaiming_normal x0.1, conv5 all-zero;
  * prior / surrogate blocks ('plain_xavier'): xavier_normal x1 on all five;
  biases zero.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import chain_variants as _cv
from ..ops import dense_chain as _dc
from ..ops import temporal_conv as _tc
from ..ops.conv import (conv2d_same_strided, conv3d, kaiming_normal, leaky_relu, pointwise,
                        spatial_conv_video, temporal_conv3, xavier_normal, zeros_init)
from ..ops.shuffle import depth_to_space_std, space_to_depth


def _w_init(mode: str, layer: str):
    if mode == "inn_xavier":
        return zeros_init if layer == "proj" else xavier_normal(0.1)
    if mode == "inn_kaiming":
        return zeros_init if layer == "proj" else kaiming_normal(0.1)
    if mode == "plain_xavier":
        return xavier_normal(1.0)
    raise ValueError(mode)


_KIND_SHAPES = {
    "s": lambda ci, co: (3, 3, ci, co),
    "f": lambda ci, co: (3, 3, 3, ci, co),
    "t": lambda ci, co: (3, ci, co),
    "p": lambda ci, co: (ci, co),
}

_KIND_CONV = {"s": spatial_conv_video, "f": conv3d, "p": pointwise}


class _ConvP(nn.Module):
    """One conv parameter pair: ``weight`` in the layout of its kind
    (``_KIND_SHAPES``) and ``bias`` (Cout,). A 't' conv has a dilation in T;
    at dilation 1 it is the temporal-conv kernel's."""

    def __init__(self, c_in, c_out, kind="s", w_init=None, generator=None, dilation=1):
        super().__init__()
        wi = w_init if w_init is not None else xavier_normal(1.0)
        self.kind, self.dilation = kind, dilation
        self.weight = nn.Parameter(wi(_KIND_SHAPES[kind](c_in, c_out), generator))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x, negative_slope=None):
        """The conv, then the LeakyReLU of slope ``negative_slope`` (None:
        none), fused into the temporal-conv kernel where it takes the conv."""
        # the activations set the compute dtype: fp32 master parameters are
        # cast down when the caller runs the net in bf16
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if self.kind == "t" and self.dilation == 1:
            return _tc.temporal_conv3_fused(x, w, b, negative_slope)
        if self.kind == "t":
            y = temporal_conv3(x, w, b, dilation=self.dilation)
        else:
            y = _KIND_CONV[self.kind](x, w, b)
        return y if negative_slope is None else leaky_relu(y, negative_slope)


class DenseChain(nn.Module):
    """The shared 5-conv growing-dense chain, dispatched as the JAX
    package's (selfc_tpu/models/blocks.py:DenseChain):

      * k1 = kmid = 's', k5 = 't', gc <= 32, a video, no ``early_3d``: the
        whole chain through ``dense_chain_t_ep`` (its kernel's epilogue takes
        ``ep``);
      * k1 = kmid = 's', gc = 32, k5 != 't', no ``early_3d``: the four
        spatial convs through ``fused_dense_spatial``, conv5 over
        ``[x | x1..x4]`` outside;
      * anything else: the convs one by one (conv5 at k5 = 't' through the
        temporal-conv kernel).

    ``early_3d`` (D2DLT): x1 gets a zero-init 3x3x3 conv of itself added
    (``early_3d_layer``). The JAX gates add the TPU's layout conditions
    (``chain_shapes_ok``, ``chain_v2_shapes_ok``: W a multiple of 16, an H
    tile, a VMEM budget); the Hopper kernels take any H and W, so the port
    leaves those out and a chain takes its kernel at every shape.

    ``save_feats`` (an attribute, default true): keep the chain's features
    from the forward for the backward on the first route; false makes the
    backward recompute them. The nets set it from ``train.save_chain_feats``.

    ``variants`` (an attribute, default empty): the opt-in schedules of the
    first route (``ops/chain_variants.py``), set by the nets from
    ``network_G.chain_variants``; ``chain_variants.pick`` chooses among B1,
    the ride (B9) and v3 (B8), whose chains keep no features.

    ``pack_w`` (an attribute, default true as in the JAX package): a B1
    chain packs its batch along W where ``dense_chain.pick_pack_w`` gives
    P > 1. The nets set it from ``network_G.pack_w``.

    ``forward(x, ep, stripe)``: ``stripe`` > 0 says x (and the epilogue's
    operands) arrive W-packed with images of that width; only the first
    route has the stripe masks, and any other raises."""

    def __init__(self, c_in, c_out, gc=32, k1="s", k5="t", init_mode="inn_xavier",
                 is_res=False, kmid="s", early_3d=False, generator=None):
        super().__init__()
        self.save_feats = True
        self.variants = frozenset()
        self.pack_w = True
        self.gc, self.is_res, self.early_3d = gc, bool(is_res), bool(early_3d)
        self.k1, self.kmid, self.k5 = k1, kmid, k5
        grow = _w_init(init_mode, "grow")
        proj = _w_init(init_mode, "proj")
        for i in range(4):
            setattr(self, f"conv{i + 1}",
                    _ConvP(c_in + i * gc, gc, k1 if i == 0 else kmid, grow, generator))
        self.conv5 = _ConvP(c_in + 4 * gc, c_out, k5, proj, generator)
        if self.early_3d:
            self.early_3d_layer = _ConvP(gc, gc, "f", zeros_init, generator)

    def _convs(self):
        return [getattr(self, f"conv{i + 1}") for i in range(4)]

    def weights(self):
        """``(ws, bs, w5, b5)``, the raw parameters (JAX ``ep="weights"``):
        the coupling hands an H/G pair of chains to one fused call."""
        convs = self._convs()
        return ([c.weight for c in convs], [c.bias for c in convs],
                self.conv5.weight, self.conv5.bias)

    def forward(self, x, ep=None, stripe=0):
        """ep: optional fused coupling epilogue ``(mode, clamp, a, m)``
        applied to the chain output (see ops.dense_chain.ep_apply); not with
        ``is_res``. stripe: x is W-packed with images of that width."""
        if ep is not None and self.is_res:
            raise ValueError("ep epilogue requires is_res=False")
        convs = self._convs()
        spatial = self.k1 == "s" and self.kmid == "s" and not self.early_3d
        if spatial and self.k5 == "t" and self.gc <= _dc.GC_MAX and x.dim() == 5:
            mode, clamp, a, m = ep if ep is not None else ("none", 1.0, None, None)
            ws, bs, w5, b5 = self.weights()
            P = _dc.pick_pack_w(x.shape[0], x.shape[3]) if self.pack_w else 1
            kind = _cv.pick(self.variants, mode, w5.shape[-1], stripe, P)
            if kind == "ride":
                y = _cv.dense_chain_ride(x, ws, bs, w5, b5, mode, clamp, a, m)
            elif kind == "v3":
                y = _cv.dense_chain_v3(x, ws, bs, w5, b5)
            else:
                y = _dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, clamp, a, m,
                                         save_feats=self.save_feats, stripe=stripe,
                                         pack=kind == "pack")
            return y + x if self.is_res else y
        if stripe:
            raise ValueError("a W-packed input needs the whole-chain kernel's stripe masks; "
                             "this chain takes another route")
        if spatial and self.gc == _dc.GC_MAX and self.k5 != "t":
            x1234 = _dc.fused_dense_spatial(x, [c.weight for c in convs], [c.bias for c in convs])
            y = self.conv5(torch.cat([x, x1234], dim=-1))
        else:
            feats = x
            for i, c in enumerate(convs):
                xi = c(feats, 0.2)
                if i == 0 and self.early_3d:
                    xi = xi + self.early_3d_layer(xi)
                feats = torch.cat([feats, xi], dim=-1)
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

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", generator=None):
        super().__init__()
        self.chain = DenseChain(c_in, c_out, gc, "s", "t", init_mode, generator=generator)

    def forward(self, x, ep=None, stripe=0):  # (B,T,H,W,C)
        return self.chain(x, ep=ep, stripe=stripe)

    def weights(self):
        return self.chain.weights()


class _Chain(nn.Module):
    """A block that is one ``DenseChain`` named ``chain``, without an
    epilogue (the families below)."""

    def __init__(self, *chain_args, **chain_kw):
        super().__init__()
        self.chain = DenseChain(*chain_args, **chain_kw)

    def forward(self, x):
        return self.chain(x)


class ResD2DT(_Chain):
    """D2DT with x added to its output (reference ResD2DTInput)."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", generator=None):
        super().__init__(c_in, c_out, gc, "s", "t", init_mode, True, generator=generator)


class D2DLT(_Chain):
    """D2DT with a zero-init 3x3x3 conv added to x1 (reference D2DLTInput)."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", generator=None):
        super().__init__(c_in, c_out, gc, "s", "t", init_mode, early_3d=True, generator=generator)


class DenseBlock2D(_Chain):
    """2-D dense block (reference DenseBlock): a chain of spatial convs on
    ``(N,H,W,C)`` images or on every frame of a video."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", is_res=False,
                 generator=None):
        super().__init__(c_in, c_out, gc, "s", "s", init_mode, is_res, generator=generator)


class D2D(DenseBlock2D):
    """All-spatial video dense block (reference D2DInput /
    DenseBlockVideoInput): the same chain as ``DenseBlock2D``."""


class DenseBlock3D(_Chain):
    """Full 3x3x3 dense block (reference DenseBlock3D)."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", generator=None):
        super().__init__(c_in, c_out, gc, "f", "f", init_mode, kmid="f", generator=generator)


class DenseBlock3DPartial(_Chain):
    """conv1 and conv5 full 3x3x3, conv2-4 spatial (reference
    DenseBlock3DPartial)."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", generator=None):
        super().__init__(c_in, c_out, gc, "f", "f", init_mode, generator=generator)


class FeatureCollapse(nn.Module):
    """Space-to-depth -> dense chain -> depth-to-space (reference
    FeatureCalapseBlock). The way down uses the block-position-major channel
    order and the way up the PixelShuffle order, as the reference does. The
    chain is ``(s*s*c_in) -> (s*s*c_out)`` at growth ``growth * gc``
    (``growth`` defaults to the scale) with conv1 / conv5 of kinds
    ``kinds``."""

    def __init__(self, c_in, c_out, scale=4, gc=32, init_mode="inn_xavier",
                 is_res=False, generator=None, kinds=("f", "f"), growth=None):
        super().__init__()
        s = scale
        self.scale, self.is_res = s, bool(is_res)
        self.chain = DenseChain(s * s * c_in, s * s * c_out, (growth or s) * gc, *kinds, init_mode,
                                generator=generator)

    def forward(self, x):  # (B,T,H,W,C)
        s = self.scale
        y = space_to_depth(x, s) if s > 1 else x
        y = self.chain(y)
        y = depth_to_space_std(y, s) if s > 1 else y
        return y + x if self.is_res else y


class FeatureCollapse2D(FeatureCollapse):
    """All-spatial collapse block (reference FeatureCalapseBlock2D)."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", generator=None):
        super().__init__(c_in, c_out, 4, gc, init_mode, generator=generator, kinds=("s", "s"))


class FeatureCollapseSmallC(FeatureCollapse):
    """reference FeatureCalapseBlock_SmallC: growth 2 gc."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", generator=None):
        super().__init__(c_in, c_out, 4, gc, init_mode, generator=generator, growth=2)


class FeatureCollapseFast(FeatureCollapse):
    """reference FeatureCalapseBlock_Fast: growth 3 gc, a temporal conv5."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", generator=None):
        super().__init__(c_in, c_out, 4, gc, init_mode, generator=generator, kinds=("s", "t"),
                         growth=3)


class D2DTEnhance(nn.Module):
    """Multi-dilation temporal tail (reference D2DTEnhanceInput). Its
    parameters sit at the top level (``conv1..4``, ``conv51..53``,
    ``conv6``), as in the JAX package."""

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", generator=None):
        super().__init__()
        grow = _w_init(init_mode, "grow")
        for i in range(4):
            setattr(self, f"conv{i + 1}", _ConvP(c_in + i * gc, gc, "s", grow, generator))
        cm = c_in + 4 * gc
        for d in (1, 2, 3):
            setattr(self, f"conv5{d}", _ConvP(cm, c_out, "t", grow, generator, dilation=d))
        self.conv6 = _ConvP(3 * c_out, c_out, "p", zeros_init, generator)

    def forward(self, x):
        sp = x
        for i in range(4):
            sp = torch.cat([sp, getattr(self, f"conv{i + 1}")(sp, 0.2)], dim=-1)
        tf = torch.cat([getattr(self, f"conv5{d}")(sp, 0.2) for d in (1, 2, 3)], dim=-1)
        return self.conv6(tf)


class _StridedConv(nn.Module):
    """flax ``nn.Conv(c_out, (3, 3), strides=(2, 2), padding="SAME")`` on
    every frame of ``(B,T,H,W,C)``, with its parameter names ``kernel``
    (3,3,Cin,Cout) and ``bias``."""

    def __init__(self, c_in, c_out, w_init, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(w_init((3, 3, c_in, c_out), generator))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        B, T = x.shape[:2]
        y = conv2d_same_strided(x.reshape(B * T, *x.shape[2:]), self.kernel.to(x.dtype),
                                self.bias.to(x.dtype))
        return y.reshape(B, T, *y.shape[1:])


def _upsample2(z):
    """Nearest 2x upsampling of ``(..., H, W, C)`` (a broadcast: its
    gradient is a plain sum, the same bits on every run)."""
    *lead, H, W, C = z.shape
    return z[..., :, None, :, None, :].expand(*lead, H, 2, W, 2, C).reshape(*lead, 2 * H, 2 * W, C)


class HighOrderTNet(nn.Module):
    """Spatial U-Net with D2DT blocks inside (reference HighOrderTNet):
    ``head`` (pointwise to 16 channels), at each of ``LEVELS`` levels a
    stride-2 conv ``down{i}`` doubling the channels and a D2DT
    ``inner{i}_block`` of growth ``INNER_GC``; on the way back ``up{3-i}``
    (nearest 2x, a 3x3 conv halving the channels, LeakyReLU) plus the skip;
    ``tail`` (pointwise, zero init). H and W must be multiples of
    ``2**LEVELS``."""

    LEVELS, INNER_GC, M = 3, 32, 16

    def __init__(self, c_in, c_out, gc=32, init_mode="inn_xavier", generator=None):
        super().__init__()
        xav = xavier_normal(0.1)
        M = self.M
        self.head = _ConvP(c_in, M, "p", xav, generator)
        for i in range(1, self.LEVELS + 1):
            c = M * 2 ** i
            setattr(self, f"down{i}", _StridedConv(c // 2, c, xav, generator))
            setattr(self, f"inner{i}_block", D2DT(c, c, self.INNER_GC, "inn_xavier", generator))
        for i in range(self.LEVELS, 0, -1):
            setattr(self, f"up{3 - i}", _ConvP(M * 2 ** i, M * 2 ** (i - 1), "s", xav, generator))
        self.tail = _ConvP(M, c_out, "p", zeros_init, generator)

    def forward(self, x):  # (B,T,H,W,C)
        z = self.head(x, 0.2)
        skips = [z]
        for i in range(1, self.LEVELS + 1):
            z = getattr(self, f"inner{i}_block")(getattr(self, f"down{i}")(z))
            skips.append(z)
        for i in range(self.LEVELS, 0, -1):
            z = getattr(self, f"up{3 - i}")(_upsample2(z), 0.2) + skips[i - 1]
        return self.tail(z)


class HighOrderTNet1(HighOrderTNet):
    """The 1-level variant (reference HighOrderTNet1, the surviving def):
    its inner D2DT has growth 64. Not in the ``subnet()`` table."""

    LEVELS, INNER_GC = 1, 64


# the subnet() table of the JAX package: name -> (c_in, c_out, gc, mode,
# generator) -> module; most families take growth 32 whatever gc is asked
_TABLE = {
    "DBNet": lambda ci, co, gc, mode, g: DenseBlock2D(ci, co, 32, mode, generator=g),
    "DB3DNet": lambda ci, co, gc, mode, g: DenseBlock3D(ci, co, 32, mode, g),
    "DB3DNet_P": lambda ci, co, gc, mode, g: DenseBlock3DPartial(ci, co, 32, mode, g),
    "D2DTNet": lambda ci, co, gc, mode, g: D2DT(ci, co, gc, mode, g),
    "ResD2DTInput": lambda ci, co, gc, mode, g: ResD2DT(ci, co, gc, mode, g),
    "D2DNet": lambda ci, co, gc, mode, g: D2D(ci, co, 32, mode, generator=g),
    "D2DLTInput": lambda ci, co, gc, mode, g: D2DLT(ci, co, 32, mode, g),
    "D2DTEnhanceInput": lambda ci, co, gc, mode, g: D2DTEnhance(ci, co, 32, mode, g),
    "HighOrderTNet": lambda ci, co, gc, mode, g: HighOrderTNet(ci, co, 32, mode, g),
    "FeatureCalapseBlock": lambda ci, co, gc, mode, g: FeatureCollapse(ci, co, 4, 32, mode, generator=g),
    "FeatureCalapseBlock_SmallC": lambda ci, co, gc, mode, g: FeatureCollapseSmallC(ci, co, 32, mode, g),
    "FeatureCalapseBlock_Fast": lambda ci, co, gc, mode, g: FeatureCollapseFast(ci, co, 32, mode, g),
}


def subnet(net_structure: str, init_mode: str = "xavier"):
    """Constructor factory mirroring the JAX package's ``subnet()``:
    ``ctor(c_in, c_out, gc=32, generator=None)``. ``init_mode`` 'xavier'
    gives the 'inn_xavier' init, anything else 'inn_kaiming'. An unknown
    name raises ``KeyError``."""
    if net_structure not in _TABLE:
        raise KeyError(f"unknown subnet type {net_structure!r}")
    mode = "inn_xavier" if init_mode == "xavier" else "inn_kaiming"
    make = _TABLE[net_structure]

    def ctor(c_in, c_out, gc=32, generator=None):
        return make(c_in, c_out, gc, mode, generator)

    return ctor
