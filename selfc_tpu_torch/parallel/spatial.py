"""The image width split over the cards of one mesh row: the work XLA
derives from the JAX package's ``mesh_sp`` (the HR batch sharded over W,
the convolutions' halo exchanges, the gradients' psums), written out for
the port, for the nets the JAX wrappers train: SelfC_GMM
(``WidthSplitGMM``), SelfC_GMM_Codec with its surrogate and de-artifact net
(``WidthSplitCodec``) and the Haar SelfC net (``WidthSplitHaar``), with
every subnet family of the ``subnet()`` table and every chain variant.

Every function takes a row's shards, left to right, each on its card, and
returns shards. What crosses a shard edge:

* a block of convolutions (a subnet, the surrogate's ``DenseBlock2D`` and
  ``FeatureCollapse``, ``STPNetSmall``'s blocks) reads ``block_reach``
  columns of each neighbour, derived from its convs' kinds: a spatial
  ('s') or full ('f') conv reaches 1 column at the block's resolution, a
  temporal ('t') or pointwise ('p') one none. A D2DT chain reaches 4 (four
  3x3 layers, a temporal conv5), a ``DenseBlock2D`` 5, a
  ``FeatureCollapse`` at scale 4 five cells of 4, 20 columns, and its
  shards must start on the 4-column grid; ``D2DTEnhance`` 4;
  ``HighOrderTNet`` 80 on an 8-column grid (``_unet_reach``: its strided
  convs keep their phase). The block runs on the haloed shard and is
  cropped; the image's true edges keep the block's own zero padding, so
  the crop is the unsplit block's output. The halo is exchanged before
  each block (H and G read the same input and share one). A coupling
  epilogue's operands are zero-padded instead (those columns are cropped),
  and so is the H/G pair's combine operand x2 (``chain_variants: [hg]``:
  B7 on the haloed shard). The plain coupling of the other families
  combines on the unhaloed shards;
* ``GlobalAgg``'s 32 x 32 adaptive pool: each shard sums its columns of
  every window, the sums are added on the master device and divided once,
  the ``(T x T)`` attention runs there on the whole pooled map, and each
  shard mixes its own pixels with it;
* the deformable modules (``DeformConvAgg``, ``GroupedGlobalDeformAgg``):
  their offsets reach any column, so no halo is exact; the row's shards
  are gathered on the master, the module runs whole there (B5 forward and
  backward at the whole shape) and its output is sharded back. The
  gather's adjoint is the split, so the gradient flows through (the
  adversarial branch gathers the fake HR for D and F the same way:
  ``train/gan.py``);
* the LR targets: ``gaussian_downsample`` and the MATLAB resize read
  their kernels' reach (``degrade_shards``), the same bits as the whole
  image's;
* the surrogate's Pearson term is per element over B*T: pointwise in W;
* the losses, the prior's NLL, the mimick terms and the log-jacobian: sums
  over shards, divided by the whole batch's count.

Everything else (the frequency split, the Haar steps, which are 2x2-local
on shards a multiple of the scale wide, the quantisation, the GMM sample,
the 1x1 tails, the surrogate's indicator plane) runs on each shard.
Parameters reach each card through ``mesh.Replicas``: under autograd their
gradients sum into the masters. W-packing (``pack_w``) packs the batch's
images within a haloed shard, chain by chain (``DenseChain``'s own
packing): the same function.

``width_rule`` gives the widths a net splits into; ``check_supported``
raises for a net the split does not compute (IRN: no wrapper trains it).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..codec.surrogate import H265Surrogate, pearson_map
from ..models.agg import DeformConvAgg, GlobalAgg, GroupedGlobalDeformAgg
from ..models.blocks import D2DT, D2DTEnhance, DenseChain, FeatureCollapse, HighOrderTNet, _Chain
from ..models.inv_nets import SelfCNetCodec, SelfCNetGMM, SelfCNetHaar
from ..models.stp import STPNet, STPNetSmall
from ..ops import chain_variants as _cv
from ..ops.freq import freq_forward, freq_inverse
from ..ops.gmm import gmm_log_prob, split_params
from ..ops.haar import haar_forward, haar_inverse
from ..ops.quantize import quantize_ste
from ..ops.resize import (GAUSS_REACH, adaptive_pool_w_sums, adaptive_w_counts, gaussian_downsample_w, matlab_reach,
                          matlab_taps, resize_taps)
from .mesh import W_AXIS, halo_sides, halo_w, unhalo_w

_CONV_REACH = {"s": 1, "f": 1, "t": 0, "p": 0}   # columns a conv of each kind reads on each side


def block_reach(mod) -> tuple[int, int]:
    """``(reach, grid)``: the columns of its input ``mod`` reads on each
    side of an output column, and the grid a shard's edges (and so its
    halo) must lie on (1: any column). Derived from the convs' kinds
    (``blocks._ConvP.kind``); for ``HighOrderTNet`` from its U-Net
    (``_unet_reach``)."""
    if isinstance(mod, DenseChain):
        convs = [*mod._convs(), mod.conv5] + ([mod.early_3d_layer] if mod.early_3d else [])
        return sum(_CONV_REACH[c.kind] for c in convs), 1
    if isinstance(mod, (D2DT, _Chain)):
        return block_reach(mod.chain)
    if isinstance(mod, FeatureCollapse):
        reach, _ = block_reach(mod.chain)
        return reach * mod.scale, mod.scale
    if isinstance(mod, D2DTEnhance):
        # four spatial convs, then the three dilated temporal convs side by side, then conv6
        return (sum(_CONV_REACH[getattr(mod, f"conv{i}").kind] for i in (1, 2, 3, 4))
                + max(_CONV_REACH[getattr(mod, f"conv5{d}").kind] for d in (1, 2, 3))
                + _CONV_REACH[mod.conv6.kind]), 1
    if isinstance(mod, HighOrderTNet):
        return _unet_reach(mod)
    raise NotImplementedError(f"the width split has no halo for {type(mod).__name__}")


def _unet_reach(net) -> tuple[int, int]:
    """``HighOrderTNet``'s reach, rounded up to its grid of ``2**LEVELS``
    input columns (so a haloed shard keeps the strided convs' phase), and
    that grid. The columns an output column reads, followed down the
    U-Net: a stride-2 3x3 'SAME' conv at an even size pads 0 before and 1
    after, so its output column j reads 2j .. 2j + 2; the nearest 2x
    upsample's column c reads c // 2; each D2DT block reads its reach at its
    level's resolution; the skips join the two branches' columns."""
    L = net.LEVELS

    def enc(i, lo, hi):       # input columns that the encoder's level-i columns lo..hi read
        if i == 0:
            r = _CONV_REACH[net.head.kind]
            return lo - r, hi + r
        r = block_reach(getattr(net, f"inner{i}_block"))[0]
        return enc(i - 1, 2 * (lo - r), 2 * (hi + r) + 2)

    def dec(i, lo, hi):       # ... that the decoder's level-i columns read
        if i == L:
            return enc(L, lo, hi)
        r = _CONV_REACH[getattr(net, f"up{2 - i}").kind]   # level i + 1 -> i: up{3 - (i + 1)}
        a, b = dec(i + 1, (lo - r) // 2, (hi + r) // 2), enc(i, lo, hi)
        return min(a[0], b[0]), max(a[1], b[1])

    grid, t = 2 ** L, _CONV_REACH[net.tail.kind]
    reach = max(max(x - lo, hi - x) for x in range(grid) for lo, hi in [dec(0, x - t, x + t)])
    return -(-reach // grid) * grid, grid


HALO = 4   # a D2DT chain's reach: four 3x3 layers, a temporal conv5 (``block_reach``)
_BLOCKS = (DenseChain, D2DT, _Chain, FeatureCollapse, D2DTEnhance, HighOrderTNet)


def net_blocks(module, prefix=""):
    """``(name, block)`` of every outermost block under ``module`` that the
    split halos (a block inside another, as ``HighOrderTNet``'s D2DT
    blocks, runs within its haloed shard)."""
    for name, child in module.named_children():
        if isinstance(child, _BLOCKS):
            yield prefix + name, child
        else:
            yield from net_blocks(child, f"{prefix}{name}.")


def check_supported(net) -> None:
    """Raise unless the width split computes ``net``'s function: a
    SelfC_GMM, SelfC_GMM_Codec or Haar SelfC net (any subnet family of the
    ``subnet()`` table, any chain variants)."""
    if type(net) not in (SelfCNetGMM, SelfCNetCodec, SelfCNetHaar):
        raise NotImplementedError(f"mesh_sp > 1 splits SelfC_GMM, SelfC_GMM_Codec and SelfC, "
                                  f"not {type(net).__name__}")


def width_rule(net, surrogate=None) -> tuple[int, int, str, str]:
    """``(multiple, least, grid block, halo block)``: a row's sp shards of
    an HR width W are whole and exact where W / sp is a multiple of
    ``multiple`` (the scale, times the coarsest grid a block's shard edges
    must lie on) and at least ``least`` HR columns (no shard narrower than
    a block's halo at the block's resolution); the two names say which
    block sets each. The blocks: the net's (``net_blocks``: a column of a
    Haar level l's input spans 2^(l+1) HR columns, of any other's the
    scale) and the surrogate's."""
    blocks = [(name, mod, 2 ** (int(name.split("_")[2]) + 1) if name.startswith("level_blocks_") else net.scale)
              for name, mod in net_blocks(net)]
    if surrogate is not None:
        blocks += [(f"surrogate.{n}", m, net.scale) for n, m in surrogate.suggrogate_net.named_children()]
    multiple, least, by_grid, by_halo = net.scale, 0, "the scale", "none"
    for name, mod, factor in blocks:
        reach, grid = block_reach(mod)
        m = math.lcm(multiple, factor * grid)
        if m != multiple:
            multiple, by_grid = m, name
        if reach * factor > least:
            least, by_halo = reach * factor, name
    return multiple, least, by_grid, by_halo


def check_width(W: int, sp: int, net, surrogate=None) -> None:
    """Raise ``ValueError`` unless ``width_rule`` splits W into sp shards."""
    if sp == 1:
        return
    multiple, least, by_grid, by_halo = width_rule(net, surrogate)
    if W % (sp * multiple) or W // sp < least:
        raise ValueError(
            f"mesh_sp {sp}: width {W} must split into {sp} shards of whole LR columns, each a "
            f"multiple of {multiple} HR columns (set by {by_grid}) and at least {least} wide "
            f"({least // net.scale} LR columns: the halo of {by_halo})")


def zero_pad_w(t, left: int, right: int):
    return torch.nn.functional.pad(t, (0, 0, left, right)) if left or right else t


def sum_to(parts, device):
    """The sum of every element of every part, in fp32, on ``device``."""
    return sum(p.sum(dtype=torch.float32).to(device) for p in parts)


def split_like(x, shards):
    """``x`` cut along W into pieces as wide as ``shards``, each on its
    shard's device."""
    widths = [s.shape[W_AXIS] for s in shards]
    return [p.to(s.device) for p, s in zip(x.split(widths, dim=W_AXIS), shards)]


class _WidthSplit:
    """What every net's split shares: blocks on haloed shards, the coupling
    with its fused epilogues, and the temporal aggregations. ``reps`` gives
    each card its parameters (``mesh.Replicas``); ``master`` is where the
    masters live: the attention of ``GlobalAgg``, the gathered deformable
    modules and every sum run there."""

    def __init__(self, net, reps, master):
        check_supported(net)
        self.net, self.reps, self.master = net, reps, torch.device(master)

    # -- blocks ------------------------------------------------------------
    def run(self, mod, padded, h, mode="none", clamp=1.0, a=None, m=None):
        """The block ``mod`` on shards haloed by ``h``, each cropped back;
        the epilogue's operands ``a`` / ``m`` are unhaloed shards."""
        n, out = len(padded), []
        for i, p in enumerate(padded):
            left, right = halo_sides(i, n, h)
            kw = {}
            if mode != "none":
                kw["ep"] = (mode, clamp, *(zero_pad_w(t[i], left, right) if t is not None else None
                                           for t in (a, m)))
            out.append(self.reps(p.device, mod, p, **kw))
        return unhalo_w(out, h)

    def block(self, mod, xs, mode="none", clamp=1.0, a=None, m=None):
        """``mod`` on the shards: haloed by its reach, run, cropped."""
        h, grid = block_reach(mod)
        if any(x.shape[W_AXIS] % grid for x in xs):
            raise ValueError(f"{type(mod).__name__} needs shard edges on its {grid}-column grid: "
                             f"{[x.shape[W_AXIS] for x in xs]}")
        return self.run(mod, halo_w(xs, h), h, mode, clamp, a, m)

    def coupling(self, blk, x1, x2, rev: bool):
        """One ``InvBlockExp`` on the shards of the pair: ``(y1, y2,
        log-jacobian sum)``, the sum not yet divided. As the block chooses:
        the fused epilogues (D2DT subnets), with "hg" H and G as one pair
        (B7), or the plain coupling (every other family)."""
        if not blk.use_ep:
            return self._plain_coupling(blk, x1, x2, rev)
        h = block_reach(blk.H)[0]
        if "hg" in blk.variants:
            return self._hg_coupling(blk, x1, x2, rev, h)
        if not rev:
            y1 = self.block(blk.F, x2, "add", 1.0, a=x1)
            p = halo_w(y1, h)
            s = self.run(blk.H, p, h, "sig_exp", blk.clamp)
            y2 = self.run(blk.G, p, h, "mul_add", 1.0, a=x2, m=s)
        else:
            p = halo_w(x1, h)
            s = self.run(blk.H, p, h, "sig_exp_neg", blk.clamp)
            y2 = self.run(blk.G, p, h, "sub_mul", 1.0, a=x2, m=s)
            y1 = self.block(blk.F, y2, "sub_from", 1.0, a=x1)
        return y1, y2, sum_to([torch.log(t.float()) for t in s], self.master)

    def _hg_coupling(self, blk, x1, x2, rev, h):
        """The block with "hg": F with its epilogue, haloed; H and G as one
        pair (``fused_hg_pair``, B7) on their shared haloed input, the
        combine's operand x2 zero-padded in the halo columns, y2 and exp(+-s)
        cropped."""
        def pair(m, x, x2p):
            return _cv.fused_hg_pair(x, x2p, *m.H.weights(), *m.G.weights(), m.clamp, rev)

        y1 = None if rev else self.block(blk.F, x2, "add", 1.0, a=x1)
        p, n = halo_w(x1 if rev else y1, h), len(x1)
        outs = [self.reps.apply(t.device, blk, pair, t, zero_pad_w(x2[i], *halo_sides(i, n, h)))
                for i, t in enumerate(p)]
        y2, s = unhalo_w([o[0] for o in outs], h), unhalo_w([o[1] for o in outs], h)
        if rev:
            y1 = self.block(blk.F, y2, "sub_from", 1.0, a=x1)
        return y1, y2, sum_to([torch.log(t.float()) for t in s], self.master)

    def _plain_coupling(self, blk, x1, x2, rev):
        """The coupling for subnets without the fused epilogues
        (``InvBlockExp._plain``): F haloed on its input, H and G on one
        shared halo; s and the combine on each unhaloed shard."""
        h = block_reach(blk.H)[0]
        if not rev:
            y1 = [a + f for a, f in zip(x1, self.block(blk.F, x2))]
            p = halo_w(y1, h)
        else:
            p = halo_w(x1, h)
        s = [blk.clamp * (2.0 * torch.sigmoid(t) - 1.0) for t in self.run(blk.H, p, h)]
        g = self.run(blk.G, p, h)
        if not rev:
            y2 = [a * torch.exp(e) + b for a, e, b in zip(x2, s, g)]
            return y1, y2, sum_to([e.float() for e in s], self.master)
        y2 = [(a - b) * torch.exp(-e) for a, e, b in zip(x2, s, g)]
        y1 = [a - f for a, f in zip(x1, self.block(blk.F, y2))]
        return y1, y2, -sum_to([e.float() for e in s], self.master)

    # -- temporal aggregation --------------------------------------------
    def global_agg(self, mod, xs):
        """``GlobalAgg`` on the shards: the pool summed by shards, the
        attention on the master, each shard mixed with it."""
        W = sum(x.shape[W_AXIS] for x in xs)
        sums, w0 = [], 0
        for x in xs:
            sums.append(adaptive_pool_w_sums(x, (32, 32), w0, W).to(self.master))
            w0 += x.shape[W_AXIS]
        counts = torch.as_tensor(adaptive_w_counts(W, 32), dtype=xs[0].dtype, device=self.master)
        attn = mod.attention(sum(sums) / counts[:, None])
        return [self.reps.apply(x.device, mod, GlobalAgg.mix, x, attn.to(x.device)) for x in xs]

    def gathered(self, mod, xs):
        """``mod`` on the whole image: the shards gathered on the master,
        the module run there, its output sharded back."""
        whole = torch.cat([x.to(self.master) for x in xs], dim=W_AXIS)
        return split_like(self.reps(self.master, mod, whole), xs)

    def aggregate(self, mod, xs):
        """A global module of the prior (or the de-artifact net's) on the shards."""
        if isinstance(mod, GlobalAgg):
            return self.global_agg(mod, xs)
        if isinstance(mod, (DeformConvAgg, GroupedGlobalDeformAgg)):
            return self.gathered(mod, xs)
        raise NotImplementedError(f"the width split has no route for {type(mod).__name__}")

    # -- what every prior net shares ---------------------------------------
    def decode(self, lrs, epss):
        """LR shards and the prior's noise shards (None each with fh_loss
        'l2') -> (HR shards, HF shards)."""
        lrs = self.pre_prior(lrs)
        params = self.prior_params(lrs)
        hfs = [self.net._sample_hf(p, e, None) for p, e in zip(params, epss)]
        return self.decode_with_hf(lrs, hfs)[0], hfs

    def pre_prior(self, lrs):
        """What the decode does to the LR before the prior (nothing here)."""
        return lrs

    def nll_sum(self, lrs, hfs):
        """The prior's NLL of the true HF summed over the shards (the net's
        ``nll`` is this over the count of ``hfs``' elements)."""
        params = self.prior_params(lrs)
        if self.net.fh_loss == "l2":
            return sum_to([(h - p) ** 2 for h, p in zip(hfs, params)], self.master)
        net = self.net
        return -sum_to([gmm_log_prob(split_params(p, net.hf_dim, net.gmm_k), h)
                        for h, p in zip(hfs, params)], self.master)

    def roundtrip(self, xs, epss):
        """encode -> split -> STE-quantize LR -> decode, on the shards: the
        net's ``roundtrip`` with ``loss_c`` a sum (None with the NLL off)."""
        ys, _ = self.encode(xs)
        lr_pre = [y[..., :3] for y in ys]
        loss_c = None
        if getattr(self.net, "nll_enabled", True):
            loss_c = self.nll_sum(lr_pre, [y[..., 3:] for y in ys])
        lrs = [quantize_ste(t.contiguous()) for t in lr_pre]
        hrs, _ = self.decode(lrs, epss)
        return {"lr_pre_quant": lr_pre, "lr": lrs, "hr": hrs, "loss_c": loss_c}


class WidthSplitGMM(_WidthSplit):
    """SelfC_GMM's functions on one row's shards."""

    def blocks(self, x1, x2, rev: bool):
        """The coupling blocks (reversed with ``rev``): ``(x1, x2, log-jacobian
        sum)``. Under ``network_G.remat`` each block keeps its inputs alone
        for the backward, as the unsplit net does."""
        jac = torch.zeros((), device=self.master)
        n = len(x1)
        remat = self.net.remat and torch.is_grad_enabled()
        for blk in self.net._blocks(rev):
            if remat:
                def block(*ts, blk=blk):
                    y1, y2, j = self.coupling(blk, list(ts[:n]), list(ts[n:]), rev)
                    return (*y1, *y2, j)

                out = checkpoint(block, *x1, *x2, use_reentrant=False)
                x1, x2, j = list(out[:n]), list(out[n:2 * n]), out[-1]
            else:
                x1, x2, j = self.coupling(blk, x1, x2, rev)
            jac = jac + j
        return x1, x2, jac

    def encode(self, xs):
        """HR shards -> latent shards, and the log-jacobian (divided by the
        row's frames B*T, as the net's)."""
        ys = [freq_forward(x, self.net.scale) for x in xs]
        x1, x2, jac = self.blocks([y[..., :3].contiguous() for y in ys],
                                  [y[..., 3:].contiguous() for y in ys], False)
        B, T = xs[0].shape[:2]
        return [torch.cat(p, dim=-1) for p in zip(x1, x2)], jac / (B * T)

    def decode_with_hf(self, lrs, hfs):
        x1, x2, _ = self.blocks([t.contiguous() for t in lrs], [t.contiguous() for t in hfs], True)
        ys = [torch.cat(p, dim=-1) for p in zip(x1, x2)]
        return [freq_inverse(y, self.net.scale) for y in ys], ys

    def prior_params(self, lrs):
        """The STPNet prior's raw output on the LR shards."""
        stp = self.net.stp_net
        x = self.block(stp.local_m1, [t.contiguous() for t in lrs])
        if stp.global_m1 is not None:
            x = self.aggregate(stp.global_m1, x)
        x = self.block(stp.local_m2, x)
        if stp.global_m2 is not None:
            x = self.aggregate(stp.global_m2, x)
        for i in range(stp.stp_blk_num - 2):
            x = self.block(getattr(stp, f"other_local_{i}"), x)
            gm = getattr(stp, f"other_global_{i}")
            if gm is not None:
                x = self.aggregate(gm, x)
        return [self.reps.apply(t.device, stp, STPNet.tail, t) for t in x]


class WidthSplitCodec(WidthSplitGMM):
    """SelfC_GMM_Codec's functions on one row's shards: the coupling, the
    prior and ``GlobalAgg`` as SelfC_GMM's (``freq_forward`` at k = 2); the
    de-artifact net first in the decode (``deart_0`` and ``deart_2`` haloed,
    ``deart_1`` gathered); and the codec surrogate."""

    def pre_prior(self, lrs):
        if not self.net.deart_net:
            return lrs
        x = self.block(self.net.deart_0, [t.contiguous() for t in lrs])
        x = self.gathered(self.net.deart_1, x)
        return self.block(self.net.deart_2, x)

    def surrogate(self, sur, lrs, q_value=None):
        """The surrogate's prediction on the quantised LR shards: the
        indicator plane (made on the master) joined to each shard, the net's
        blocks haloed, the residual added (``H265Surrogate``); the plain
        variant's blocks alone."""
        xs = lrs
        if isinstance(sur, H265Surrogate):
            B, T, h = lrs[0].shape[:3]
            ind = sur.indicator(T, q_value, self.master)
            xs = [torch.cat([t, ind.to(t.device).expand(B, T, h, t.shape[W_AXIS], 1)], dim=-1) for t in lrs]
        for blk in sur.suggrogate_net.children():
            xs = self.block(blk, xs)
        return [x + t for x, t in zip(xs, lrs)] if isinstance(sur, H265Surrogate) else xs


class WidthSplitHaar(_WidthSplit):
    """The Haar SelfC net's functions on one row's shards: each level's Haar
    step on each shard, its coupling blocks haloed at that level's width,
    and the ``STPNetSmall`` prior's blocks haloed (its tails pointwise)."""

    def level(self, ys, level, rev: bool):
        """The coupling blocks of ``level`` (reversed with ``rev``): (shards,
        log-jacobian sum)."""
        net = self.net
        blocks = [getattr(net, f"level_blocks_{level}_{i}") for i in range(net.block_num[level])]
        x1, x2 = [y[..., :3].contiguous() for y in ys], [y[..., 3:].contiguous() for y in ys]
        jac = torch.zeros((), device=self.master)
        for blk in (reversed(blocks) if rev else blocks):
            x1, x2, j = self.coupling(blk, x1, x2, rev)
            jac = jac + j
        return [torch.cat(p, dim=-1) for p in zip(x1, x2)], jac

    def encode(self, xs):
        """HR shards -> latent shards, and the log-jacobian (divided by the
        row's frames B*T, as each coupling block of the net divides)."""
        ys, jac = xs, torch.zeros((), device=self.master)
        for level in range(self.net.down_num):
            ys, j = self.level([haar_forward(y) for y in ys], level, False)
            jac = jac + j
        B, T = xs[0].shape[:2]
        return ys, jac / (B * T)

    def decode_with_hf(self, lrs, hfs):
        ys = [torch.cat([t, h.to(t.dtype)], dim=-1) for t, h in zip(lrs, hfs)]
        for level in reversed(range(self.net.down_num)):
            ys, _ = self.level(ys, level, True)
            if level:
                ys = [haar_inverse(y) for y in ys]
        return [haar_inverse(y) for y in ys], ys

    def prior_params(self, lrs):
        """``STPNetSmall``'s raw output on the LR shards."""
        stp = self.net.stp_net
        x = [t.contiguous() for t in lrs]
        for blk in stp.blocks():
            x = self.block(blk, x)
        return [self.reps.apply(t.device, stp, STPNetSmall.tail, t) for t in x]


def splitter(net, reps, master):
    """The width split of ``net``'s type."""
    cls = {SelfCNetGMM: WidthSplitGMM, SelfCNetCodec: WidthSplitCodec, SelfCNetHaar: WidthSplitHaar}.get(type(net))
    if cls is None:
        check_supported(net)
    return cls(net, reps, master)


def mimick_and_swap_shards(sugs, codecs, lambda_corr: float, master):
    """``surrogate.mimick_and_swap`` on shards: the MSE and the mean of the
    per-element Pearson map as sums over shards divided by the whole
    counts. Returns ``(swapped shards, loss)``."""
    n = sum(s.numel() for s in sugs)
    n_corr = n // (sugs[0].shape[0] * sugs[0].shape[1])
    mse = sum_to([(c.detach() - s) ** 2 for s, c in zip(sugs, codecs)], master) / n
    corr = sum_to([pearson_map(c.detach(), s) for s, c in zip(sugs, codecs)], master) / n_corr
    return [s + (c - s).detach() for s, c in zip(sugs, codecs)], mse - lambda_corr * corr


def mimick_plain_shards(sugs, codecs, master):
    """``surrogate.mimick_plain`` on shards: ``(sugs, the MSE as a sum over
    shards over the whole count)``."""
    n = sum(s.numel() for s in sugs)
    return sugs, sum_to([(c.detach() - s) ** 2 for s, c in zip(sugs, codecs)], master) / n


def gaussian_downsample_shards(xs, scale: int):
    """``gaussian_downsample`` of the whole image, by shards: each reads
    ``GAUSS_REACH`` columns of its neighbours."""
    padded, n = halo_w(xs, GAUSS_REACH), len(xs)
    return [gaussian_downsample_w(p, scale, *halo_sides(i, n, GAUSS_REACH)) for i, p in enumerate(padded)]


def imresize_matlab_shards(xs, scale: int):
    """``imresize_matlab(x, 1 / scale)`` of the whole image, by shards, the
    same bits: the H pass on each shard (it reads no other column), then
    each shard's LR columns are the rows of the whole image's taps
    (``matlab_taps``) read from its shard haloed by their reach. The
    symmetric reflection is the whole image's, so it happens at the true
    edges only."""
    widths = [x.shape[W_AXIS] for x in xs]
    W, n, f = sum(widths), len(xs), 1.0 / scale
    ys = [resize_taps(x, x.dim() - 3, *matlab_taps(x.shape[-3], int(x.shape[-3] * f), f)) for x in xs]
    idx, wts = matlab_taps(W, int(W * f), f)
    h = matlab_reach(idx, scale)
    out, w0 = [], 0
    for i, p in enumerate(halo_w(ys, h)):
        left, _ = halo_sides(i, n, h)
        rows = slice(w0 // scale, (w0 + widths[i]) // scale)
        local = idx[rows] - (w0 - left)
        assert local.min() >= 0 and local.max() < p.shape[W_AXIS], "a tap outside the haloed shard"
        out.append(resize_taps(p, p.dim() - 2, local, wts[rows]))
        w0 += widths[i]
    return out


def degrade_shards(distortion: str, xs, scale: int, degrade):
    """The LR target of the whole image (``make_degrade``), by shards:
    'sr_bd' and 'matlab' read a halo, 'pytorch_bicubic' (k x k cells) none."""
    if distortion == "sr_bd":
        return gaussian_downsample_shards(xs, scale)
    if distortion == "matlab":
        return imresize_matlab_shards(xs, scale)
    return [degrade(x) for x in xs]
