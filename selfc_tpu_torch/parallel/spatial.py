"""SelfC_GMM with the image width split over the cards of one mesh row: the
work XLA derives from the JAX package's ``mesh_sp`` (the HR batch sharded
over W, the convolutions' halo exchanges, the gradients' psums), written
out for the port.

Every function takes a row's shards, left to right, each on its card, and
returns shards. What crosses a shard edge:

* each D2DT chain (the coupling's F, H and G, the prior's local blocks)
  reads ``HALO`` = 4 columns of each neighbour: four 3x3 layers reach 4
  columns, conv5 is temporal and reaches none. The chain runs on the
  haloed shard and is cropped; the image's true edges keep the chain's own
  zero padding, so the crop is the unsplit chain's output. The halo is
  exchanged before each chain (H and G read the same input and share
  one), not 8 columns once a coupling block: 4 keeps every chain's extra
  work to 4 columns a side and works at every shard width the divisibility
  rule allows (an LR shard of 4 columns). An epilogue's operands are
  zero-padded instead (those columns are cropped);
* ``GlobalAgg``'s 32 x 32 adaptive pool: each shard sums its columns of
  every window, the sums are added on the master device and divided once,
  the ``(T x T)`` attention runs there on the whole pooled map, and each
  shard mixes its own pixels with it;
* the losses, the prior's NLL and the log-jacobian: sums over shards,
  divided by the whole batch's count.

Everything else (the frequency split, the quantisation, the GMM sample,
the 1x1 tails) is pointwise in W and runs on each shard. Parameters reach
each card through ``mesh.Replicas``: under autograd their gradients sum
into the masters. W-packing (``pack_w``) packs the batch's images within a
haloed shard, chain by chain (``DenseChain``'s own packing): the same
function.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..models.agg import GlobalAgg
from ..models.inv_nets import SelfCNetGMM
from ..models.stp import STPNet
from ..ops.freq import freq_forward, freq_inverse
from ..ops.gmm import gmm_log_prob, split_params
from ..ops.quantize import quantize_ste
from ..ops.resize import GAUSS_REACH, adaptive_pool_w_sums, adaptive_w_counts, gaussian_downsample_w
from .mesh import halo_sides, halo_w, unhalo_w

HALO = 4   # columns a D2DT chain reads on each side: four 3x3 layers


def check_supported(net) -> None:
    """Raise unless the width split computes ``net``'s function: a SelfC_GMM
    net of D2DT coupling chains (B1 with its fused epilogues), without the
    H/G pair ("hg") and with ``nonlocal`` (or no) global modules (a
    deformable aggregation reaches arbitrary columns)."""
    if type(net) is not SelfCNetGMM:
        raise NotImplementedError(f"mesh_sp > 1 splits SelfC_GMM only, not {type(net).__name__}")
    if net.subnet_type != "D2DTNet":
        raise NotImplementedError(f"mesh_sp > 1 needs subnet_type D2DTNet, not {net.subnet_type!r}")
    if "hg" in net.chain_variants:
        raise NotImplementedError("mesh_sp > 1 with chain_variants 'hg': the H/G pair has no halo'd route")
    mods = [m for m in net.stp_net.modules() if type(m).__name__.endswith("Agg")]
    if any(not isinstance(m, GlobalAgg) for m in mods):
        raise NotImplementedError("mesh_sp > 1 needs global_module 'nonlocal' (or none)")


def zero_pad_w(t, left: int, right: int):
    return torch.nn.functional.pad(t, (0, 0, left, right)) if left or right else t


def sum_to(parts, device):
    """The sum of every element of every part, in fp32, on ``device``."""
    return sum(p.sum(dtype=torch.float32).to(device) for p in parts)


class WidthSplitGMM:
    """``net``'s functions on one row's shards. ``reps`` gives each card its
    parameters (``mesh.Replicas``); ``master`` is where the masters live:
    the attention of ``GlobalAgg`` and every sum run there."""

    def __init__(self, net, reps, master):
        check_supported(net)
        self.net, self.reps, self.master = net, reps, torch.device(master)

    # -- chains ----------------------------------------------------------
    def run(self, mod, padded, mode="none", clamp=1.0, a=None, m=None):
        """The chain ``mod`` on haloed shards, each cropped back; the
        epilogue's operands ``a`` / ``m`` are unhaloed shards."""
        n, out = len(padded), []
        for i, p in enumerate(padded):
            left, right = halo_sides(i, n, HALO)
            ep = None
            if mode != "none":
                ep = (mode, clamp, *(zero_pad_w(t[i], left, right) if t is not None else None
                                     for t in (a, m)))
            out.append(self.reps(p.device, mod, p, ep=ep))
        return unhalo_w(out, HALO)

    def chain(self, mod, xs, mode="none", clamp=1.0, a=None, m=None):
        return self.run(mod, halo_w(xs, HALO), mode, clamp, a, m)

    def coupling(self, blk, x1, x2, rev: bool):
        """One ``InvBlockExp`` on the shards of the pair (its fused
        epilogues): ``(y1, y2, log-jacobian sum)``, the sum not yet divided."""
        if not rev:
            y1 = self.chain(blk.F, x2, "add", 1.0, a=x1)
            p = halo_w(y1, HALO)
            s = self.run(blk.H, p, "sig_exp", blk.clamp)
            y2 = self.run(blk.G, p, "mul_add", 1.0, a=x2, m=s)
        else:
            p = halo_w(x1, HALO)
            s = self.run(blk.H, p, "sig_exp_neg", blk.clamp)
            y2 = self.run(blk.G, p, "sub_mul", 1.0, a=x2, m=s)
            y1 = self.chain(blk.F, y2, "sub_from", 1.0, a=x1)
        return y1, y2, sum_to([torch.log(t.float()) for t in s], self.master)

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

    # -- the net's functions ----------------------------------------------
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

    def global_agg(self, mod, xs):
        """``GlobalAgg`` on the shards: the pool summed by shards, the
        attention on the master, each shard mixed with it."""
        W = sum(x.shape[-2] for x in xs)
        sums, w0 = [], 0
        for x in xs:
            sums.append(adaptive_pool_w_sums(x, (32, 32), w0, W).to(self.master))
            w0 += x.shape[-2]
        counts = torch.as_tensor(adaptive_w_counts(W, 32), dtype=xs[0].dtype, device=self.master)
        attn = mod.attention(sum(sums) / counts[:, None])
        return [self.reps.apply(x.device, mod, GlobalAgg.mix, x, attn.to(x.device)) for x in xs]

    def prior_params(self, lrs):
        """The STPNet prior's raw output on the LR shards."""
        stp = self.net.stp_net
        x = self.chain(stp.local_m1, lrs)
        if stp.global_m1 is not None:
            x = self.global_agg(stp.global_m1, x)
        x = self.chain(stp.local_m2, x)
        if stp.global_m2 is not None:
            x = self.global_agg(stp.global_m2, x)
        for i in range(stp.stp_blk_num - 2):
            x = self.chain(getattr(stp, f"other_local_{i}"), x)
            gm = getattr(stp, f"other_global_{i}")
            if gm is not None:
                x = self.global_agg(gm, x)
        return [self.reps.apply(t.device, stp, STPNet.tail, t) for t in x]

    def decode(self, lrs, epss):
        """LR shards and the prior's noise shards -> (HR shards, HF shards)."""
        params = self.prior_params(lrs)
        hfs = [self.net._sample_hf(p, e, None) for p, e in zip(params, epss)]
        return self.decode_with_hf(lrs, hfs)[0], hfs

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
        loss_c = self.nll_sum(lr_pre, [y[..., 3:] for y in ys]) if self.net.nll_enabled else None
        lrs = [quantize_ste(t.contiguous()) for t in lr_pre]
        hrs, _ = self.decode(lrs, epss)
        return {"lr_pre_quant": lr_pre, "lr": lrs, "hr": hrs, "loss_c": loss_c}


def gaussian_downsample_shards(xs, scale: int):
    """``gaussian_downsample`` of the whole image, by shards: each reads
    ``GAUSS_REACH`` columns of its neighbours."""
    padded, n = halo_w(xs, GAUSS_REACH), len(xs)
    return [gaussian_downsample_w(p, scale, *halo_sides(i, n, GAUSS_REACH)) for i, p in enumerate(padded)]
