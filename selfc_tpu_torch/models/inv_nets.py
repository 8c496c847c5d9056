"""Invertible rescaling / compression networks.

``SelfCNetGMM`` — the 4x rescaling net: frequency split (k=4) + 8 coupling
blocks + the STPNet (GMM) prior.
``SelfCNetCodec`` — the compression net (model type 'SelfC_GMM_Codec'):
frequency split (k=2) + 4 coupling blocks + the codec's STPNet (hidden 24,
growth 12, an l2 tail by default), and with ``deart_net`` a de-artifact net
that cleans the decoded LR first; the H.265 span between its encode and its
decode is ``codec/pipeline.py``'s.
``SelfCNetHaar`` — the small Haar-pyramid net (model type 'SelfC'): one
Haar level a factor of 2, each followed by its coupling blocks, and the
``STPNetSmall`` prior (its GMM sample with std exp(0.5 log-scale)).
``InvRescaleNet`` — the IRN baseline (model type 'IRN'): the same Haar
pyramid on images ``(B, H, W, 3)``, no prior; its decode takes uniform HF.

The video nets take channels-last video ``(B, T, H, W, C)``. Methods:

  encode(x)              -> (latent, log_jac)
  prior_params(lr)       -> raw GMM parameters of the prior
  decode_with_hf(lr, hf) -> (hr, latent)
  decode(lr, eps=None, generator=None) -> (hr, sampled_hf)
  nll(lr, hf)            -> conditional NLL of hf under the prior (GMM, Haar)
  roundtrip(x, ...)      -> encode -> STE-quantize LR -> decode
  forward(x, rev)        -> (latent, loss_c) or decode(x)   (GMM, Haar)

Randomness is explicit: ``decode`` takes the standard-normal noise ``eps``
of shape ``(B,T,h,w,hf_dim,gmm_k)``, or a ``torch.Generator`` to draw it.

W-packing (``pack_w``, on by default as in the JAX package; the config's
``network_G.pack_w``): the coupling chain of D2DT blocks of the GMM and
codec nets lays P images of the batch side by side along W once for the
whole chain of blocks (``dense_chain.pick_pack_w``: P = 4 at the 4x
training latent 36x36, 2 at the codec's 72x72), runs every block under the
stripe and unpacks at the end (JAX ``_chain_pair``); the prior's chains,
and every chain of the Haar net (which has no ``_chain_pair``), pack call by
call, as the JAX package's chain calls do.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..ops.chain_variants import parse_variants
from ..ops.dense_chain import pack_w, pick_pack_w, unpack_w
from ..ops.freq import freq_forward, freq_inverse
from ..ops.gmm import gmm_neg_log_likelihood, gmm_sample, split_params
from ..ops.haar import haar_forward, haar_inverse
from ..ops.quantize import quantize_ste
from .agg import GroupedGlobalDeformAgg
from .blocks import D2DT, DenseChain, subnet
from .coupling import InvBlockExp
from .stp import STPNet, STPNetSmall


class _ChainOptions(nn.Module):
    """The chain options every net hands to its chains and coupling blocks:
    ``save_chain_feats`` (training memory against backward time),
    ``chain_variants`` (the opt-in schedules) and ``pack_w``; see
    blocks.DenseChain. A subclass sets the first and the last, then calls
    ``set_chain_variants``."""

    def set_chain_variants(self, names):
        """Select the opt-in chain schedules (``network_G.chain_variants``,
        a list out of ``ops.chain_variants.VARIANTS``; empty: B1) on every
        chain and coupling block."""
        self.chain_variants = parse_variants(names)
        self._configure_chains()

    def set_pack_w(self, on: bool):
        """Turn W-packing (``network_G.pack_w``) on or off on a built net."""
        self.pack_w = bool(on)
        self._configure_chains()

    def _configure_chains(self):
        for mod in self.modules():
            if isinstance(mod, DenseChain):
                mod.save_feats = self.save_chain_feats
                mod.variants = self.chain_variants
                mod.pack_w = self.pack_w
            elif isinstance(mod, InvBlockExp):
                mod.variants = self.chain_variants


class _PriorNet(_ChainOptions):
    """A net whose decode samples its ``hf_dim`` HF latents from the prior
    ``stp_net`` (attributes ``fh_loss``, ``hf_dim``, ``gmm_k``; the
    subclass's ``decode_with_hf`` inverts). ``HALF_LOGVAR``: the GMM sample's
    std is exp(0.5 log-scale) (the Haar net's) instead of exp(log-scale)."""

    HALF_LOGVAR = False

    def prior_params(self, lr):
        return self.stp_net(lr.contiguous())

    def eps_shape(self, lr_shape):
        """Shape of the noise ``decode`` consumes for an LR of this shape."""
        return tuple(lr_shape[:-1]) + (self.hf_dim, self.gmm_k)

    def _sample_hf(self, params, eps, generator):
        if self.fh_loss == "l2":
            return params
        p = split_params(params, self.hf_dim, self.gmm_k)
        if eps is None:
            if generator is None:
                raise ValueError("decode needs the noise eps or a torch.Generator")
            eps = torch.randn(p.shape[:-1], generator=generator,
                              device=p.device, dtype=torch.float32)
        return gmm_sample(p, eps, half_logvar=self.HALF_LOGVAR)

    def decode(self, lr, eps=None, generator=None):
        """LR (B,T,h,w,3) -> (HR (B,T,H,W,3), hf): sampled from the prior's
        GMM, or with fh_loss 'l2' the prior's output itself."""
        params = self.prior_params(lr)
        hf = self._sample_hf(params, eps, generator)
        return self.decode_with_hf(lr, hf)[0], hf


class _CouplingNet(_PriorNet):
    """What the two nets share: the frequency split, the chain of coupling
    blocks (``inv_blocks_{i}``), the STPNet prior (``stp_net``) and the
    sampling of the HF latents from it. ``remat`` (the GMM net's
    ``network_G.remat``, JAX ``nn.remat(InvBlockExp)``): each coupling block
    keeps only its input for the backward and runs its forward again there
    (``torch.utils.checkpoint``), the same numbers with less memory."""

    remat = False

    def __init__(self, scale, block_num, subnet_type, init_mode, stp_blk_num,
                 fh_loss, gmm_k, global_module, stp_hidden_c, stp_gc,
                 save_chain_feats, device, generator, deform_radius=None, frames=3,
                 chain_variants=(), pack_w=True):
        super().__init__()
        device = resolve_device(device)
        self.scale = scale
        self.subnet_type = subnet_type
        self.block_num = tuple(block_num)
        self.fh_loss = fh_loss
        self.gmm_k = gmm_k
        self.latent_channels = 3 * (scale * scale + 1)
        self.hf_dim = 3 * scale * scale
        self.n_blocks = sum(self.block_num)
        ctor = subnet(subnet_type, init_mode)
        for i in range(self.n_blocks):
            self.add_module(
                f"inv_blocks_{i}",
                InvBlockExp(self.latent_channels, 3, ctor, generator=generator),
            )
        self.stp_net = STPNet(
            scale=scale, stp_blk_num=stp_blk_num, fh_loss=fh_loss,
            gmm_k=gmm_k, global_module=global_module, hidden_c=stp_hidden_c,
            gc=stp_gc, deform_radius=deform_radius, frames=frames, generator=generator,
        )
        self.save_chain_feats = bool(save_chain_feats)
        self.pack_w = bool(pack_w)
        self.set_chain_variants(chain_variants)
        self.to(device)

    def _blocks(self, rev: bool):
        order = range(self.n_blocks)
        return [getattr(self, f"inv_blocks_{i}")
                for i in (reversed(order) if rev else order)]

    def _chain(self, pair, rev: bool):
        """The coupling blocks on the pair, W-packed once for all of them
        where the subnets are D2DT chains, packing is on, "hg" is off and
        ``pick_pack_w`` gives P > 1 (JAX ``_chain_pair``). Every block then
        normalises its log-jacobian by the packed batch B/P, so the sum is
        divided by P."""
        x1, x2 = pair
        P = 1
        if (x1.dim() == 5 and self.subnet_type == "D2DTNet" and self.pack_w
                and "hg" not in self.chain_variants):
            P = pick_pack_w(x1.shape[0], x1.shape[3])
        stripe = x1.shape[3] if P > 1 else 0
        if P > 1:
            pair = (pack_w(x1, P), pack_w(x2, P))
        jac = 0.0
        remat = self.remat and torch.is_grad_enabled()
        for blk in self._blocks(rev):
            if remat:
                # keep only the block's input; its forward runs again in the backward
                pair, j = checkpoint(blk, pair, rev, stripe, use_reentrant=False)
            else:
                pair, j = blk(pair, rev, stripe)
            jac = jac + j
        if P > 1:
            return (unpack_w(pair[0], P), unpack_w(pair[1], P)), jac / P
        return pair, jac

    def encode(self, x):
        """HR (B,T,H,W,3) -> latent (B,T,H/s,W/s,3*(s^2+1)), log_jac."""
        y = freq_forward(x, self.scale)
        # the (LR, HF) pair is carried through the chain; the whole latent
        # is assembled once at the end, not per block
        pair, jac = self._chain(
            (y[..., :3].contiguous(), y[..., 3:].contiguous()), False)
        return torch.cat(pair, dim=-1), jac

    def decode_with_hf(self, lr, hf):
        """Invert the coupling chain with given HF latents (the exact
        inverse of encode up to the frequency split's fixed shuffle
        asymmetry)."""
        pair, _ = self._chain((lr.contiguous(), hf.contiguous()), True)
        y = torch.cat(pair, dim=-1)
        return freq_inverse(y, self.scale), y


class SelfCNetGMM(_CouplingNet):
    """Flagship rescaling net (model type 'SelfC_GMM')."""

    def __init__(self, scale: int = 4, block_num: Sequence[int] = (4, 4),
                 subnet_type: str = "D2DTNet", init_mode: str = "xavier",
                 stp_blk_num: int = 6, fh_loss: str = "gmm", gmm_k: int = 5,
                 global_module: str = "nonlocal", nll_enabled: bool = False,
                 save_chain_feats: bool = True, deform_radius=None, frames: int = 3,
                 chain_variants=(), pack_w: bool = True, remat: bool = False,
                 scan_blocks: bool = False, device=None, generator=None):
        super().__init__(scale, block_num, subnet_type, init_mode, stp_blk_num,
                         fh_loss, gmm_k, global_module, 64, 32,
                         save_chain_feats, device, generator, deform_radius, frames,
                         chain_variants, pack_w)
        # the forward conditional NLL is off by default, as in the trained
        # snapshot; set True to restore the loss_c term
        self.nll_enabled = nll_enabled
        self.remat = bool(remat)
        # the JAX package's scan_blocks runs the same blocks as one lax.scan
        # over stacked parameters: the same function, which the port computes
        # block by block; a stacked tree is unstacked on load, and the net's
        # checkpoints are written stacked (utils/jax_import.py)
        self.scan_blocks = bool(scan_blocks)

    def nll(self, lr, hf):
        """Conditional NLL of true HF latents under the prior (loss_c)."""
        params = self.prior_params(lr)
        if self.fh_loss == "l2":
            return torch.mean((hf - params) ** 2)
        return gmm_neg_log_likelihood(
            split_params(params, self.hf_dim, self.gmm_k), hf)

    def roundtrip(self, x, eps=None, generator=None):
        """encode -> split -> STE-quantize LR -> decode."""
        y, _ = self.encode(x)
        lr_pre_quant = y[..., :3]
        hf_true = y[..., 3:]
        loss_c = (self.nll(lr_pre_quant, hf_true) if self.nll_enabled
                  else torch.zeros((), device=x.device))
        lr = quantize_ste(lr_pre_quant.contiguous())
        hr, _ = self.decode(lr, eps=eps, generator=generator)
        return {"lr_pre_quant": lr_pre_quant, "lr": lr, "hr": hr,
                "loss_c": loss_c}

    def forward(self, x, rev: bool = False, eps=None, generator=None):
        if not rev:
            y, _ = self.encode(x)
            return y, torch.mean(y) * 0.0  # the forward NLL is disabled
        return self.decode(x, eps=eps, generator=generator)


class SelfCNetCodec(_CouplingNet):
    """Compression net (model type 'SelfC_GMM_Codec'); the JAX package's
    ``models/inv_nets.py:SelfCNetCodec``. ``deart_net``: the de-artifact net
    D2DT(3->32) -> GroupedGlobalDeformAgg(32) -> D2DT(32->3) (``deart_0..2``),
    which ``decode`` applies to the decoded LR before the prior and the
    inverse coupling; ``frames`` is the clip length it is built for."""

    def __init__(self, scale: int = 2, block_num: Sequence[int] = (4,),
                 subnet_type: str = "D2DTNet", init_mode: str = "xavier",
                 stp_blk_num: int = 4, fh_loss: str = "l2", gmm_k: int = 5,
                 global_module: str = "nonlocal", stp_hidden_c: int = 24,
                 stp_denseblock_innerc: int = 12, deart_net: bool = False,
                 deform_radius=None, frames: int = 3, save_chain_feats: bool = True,
                 chain_variants=(), pack_w: bool = True, device=None, generator=None):
        super().__init__(scale, block_num, subnet_type, init_mode, stp_blk_num,
                         fh_loss, gmm_k, global_module, stp_hidden_c,
                         stp_denseblock_innerc, save_chain_feats, device,
                         generator, deform_radius, frames, chain_variants, pack_w)
        self.deart_net = bool(deart_net)
        if self.deart_net:
            # created after the coupling blocks and the prior, as in the JAX setup()
            self.deart_0 = D2DT(3, 32, 32, "plain_xavier", generator)
            self.deart_1 = GroupedGlobalDeformAgg(32, frames, deform_radius=deform_radius,
                                                  generator=generator)
            self.deart_2 = D2DT(32, 3, 32, "plain_xavier", generator)
            self._configure_chains()
            self.to(next(self.parameters()).device)

    def decode(self, lr, eps=None, generator=None):
        """As ``_CouplingNet.decode``, on the LR the de-artifact net cleaned
        (with ``deart_net``): the prior and the inverse coupling both see
        it."""
        if self.deart_net:
            lr = self.deart_2(self.deart_1(self.deart_0(lr.contiguous())))
        return super().decode(lr, eps=eps, generator=generator)

    def roundtrip(self, x, eps=None, generator=None):
        """The codec-free roundtrip: encode -> STE-quantize LR -> decode
        (the codec span is inserted by ``train/codec_model.py``)."""
        y, _ = self.encode(x)
        lr = quantize_ste(y[..., :3].contiguous())
        hr, _ = self.decode(lr, eps=eps, generator=generator)
        return {"lr_pre_quant": y[..., :3], "lr": lr, "hr": hr,
                "loss_c": torch.zeros((), device=x.device)}


class _HaarPyramid(_ChainOptions):
    """What the Haar nets share: ``down_num`` levels (scale 2, 4, 8: 1, 2,
    3), each a Haar step (``ops/haar.py``) followed by ``block_num[l]``
    coupling blocks ``level_blocks_{l}_{i}`` on 3*4^(l+1) channels split
    3 | the rest. A level's blocks carry the (x1, x2) pair, split once and
    concatenated once (the JAX blocks split and concatenate each, the same
    numbers)."""

    def __init__(self, scale, block_num, subnet_type, init_mode, generator):
        super().__init__()
        self.scale, self.subnet_type = scale, subnet_type
        self.down_num = {2: 1, 4: 2, 8: 3}[scale]
        self.block_num = tuple(block_num)
        self.hf_dim = 3 * 4 ** self.down_num - 3
        ctor = subnet(subnet_type, init_mode)
        ch = 3
        for level in range(self.down_num):
            ch *= 4
            for i in range(self.block_num[level]):
                self.add_module(f"level_blocks_{level}_{i}", InvBlockExp(ch, 3, ctor, generator=generator))

    def _level(self, y, level, rev):
        """The coupling blocks of ``level`` on y, in reverse order with
        ``rev``: (y', log_jac)."""
        blocks = [getattr(self, f"level_blocks_{level}_{i}") for i in range(self.block_num[level])]
        pair, jac = (y[..., :3].contiguous(), y[..., 3:].contiguous()), 0.0
        for blk in (reversed(blocks) if rev else blocks):
            pair, j = blk(pair, rev)
            jac = jac + j
        return torch.cat(pair, dim=-1), jac

    def encode(self, x):
        """HR (..., H, W, 3) -> latent (..., H/s, W/s, 3*s^2), log_jac."""
        y, jac = x, 0.0
        for level in range(self.down_num):
            y, j = self._level(haar_forward(y), level, False)
            jac = jac + j
        return y, jac

    def decode_with_hf(self, lr, hf):
        """Invert the pyramid with given HF latents: (HR, the first level's
        latent before its inverse Haar step). The exact inverse of
        ``encode``."""
        y = torch.cat([lr, hf.to(lr.dtype)], dim=-1)
        for level in reversed(range(self.down_num)):
            y, _ = self._level(y, level, True)
            if level:
                y = haar_inverse(y)
        return haar_inverse(y), y


class SelfCNetHaar(_HaarPyramid, _PriorNet):
    """The small Haar net (model type 'SelfC' / 'SelfC_shell'; the JAX
    package's ``models/inv_nets.py:SelfCNetHaar``) on videos ``(B, T, H, W,
    3)``: the Haar pyramid and the ``STPNetSmall`` prior (``stp_net``) over
    its ``hf_dim`` = 3*4^down_num - 3 HF channels; the GMM sample takes std
    exp(0.5 log-scale). ``decode``'s noise ``eps`` has ``eps_shape``,
    ``(B,T,h,w,hf_dim,gmm_k)``. Its D2DT chains pack call by call
    (``pack_w``), never the pyramid as a whole."""

    HALF_LOGVAR = True

    def __init__(self, scale: int = 2, block_num: Sequence[int] = (4,),
                 subnet_type: str = "D2DTNet", init_mode: str = "xavier",
                 stp_temporal_c: int = 32, fh_loss: str = "gmm", gmm_mixture_num: int = 5,
                 condition_func: str = "D2DTNet", save_chain_feats: bool = True,
                 chain_variants=(), pack_w: bool = True, device=None, generator=None):
        device = resolve_device(device)
        super().__init__(scale, block_num, subnet_type, init_mode, generator)
        self.fh_loss, self.gmm_k = fh_loss, gmm_mixture_num
        self.stp_net = STPNetSmall(stp_temporal_c, fh_loss, gmm_mixture_num, condition_func,
                                   self.hf_dim, generator)
        self.save_chain_feats = bool(save_chain_feats)
        self.pack_w = bool(pack_w)
        self.set_chain_variants(chain_variants)
        self.to(device)

    nll = SelfCNetGMM.nll

    def roundtrip(self, x, eps=None, generator=None):
        """encode -> split -> STE-quantize LR -> decode; ``loss_c`` is the
        conditional NLL of the true HF under the prior (always on here)."""
        y, _ = self.encode(x)
        lr_pre_quant, hf_true = y[..., :3], y[..., 3:]
        loss_c = self.nll(lr_pre_quant, hf_true)
        lr = quantize_ste(lr_pre_quant.contiguous())
        hr, _ = self.decode(lr, eps=eps, generator=generator)
        return {"lr_pre_quant": lr_pre_quant, "lr": lr, "hr": hr, "loss_c": loss_c}

    def forward(self, x, rev: bool = False, eps=None, generator=None):
        if not rev:
            y, _ = self.encode(x)
            return y, self.nll(y[..., :3], y[..., 3:])
        return self.decode(x, eps=eps, generator=generator)


class InvRescaleNet(_HaarPyramid):
    """The IRN baseline (model type 'IRN' / 'IRN_Contra_UP'; the JAX
    package's ``models/inv_nets.py:InvRescaleNet``) on images ``(B, H, W,
    3)``: the Haar pyramid alone. ``decode`` takes the HF channels given, or
    draws them U[0,1) from a ``torch.Generator``. The JAX package builds no
    trainer for it (its ``RescaleModel`` needs a ``roundtrip``), nor does
    the port."""

    def __init__(self, scale: int = 4, block_num: Sequence[int] = (4, 4),
                 subnet_type: str = "DBNet", init_mode: str = "xavier",
                 save_chain_feats: bool = True, chain_variants=(), pack_w: bool = True,
                 device=None, generator=None):
        device = resolve_device(device)
        super().__init__(scale, block_num, subnet_type, init_mode, generator)
        self.save_chain_feats = bool(save_chain_feats)
        self.pack_w = bool(pack_w)
        self.set_chain_variants(chain_variants)
        self.to(device)

    def decode(self, lr, hf=None, generator=None):
        """LR (B,h,w,3) -> (HR (B,H,W,3), hf): ``hf`` as given, else
        U[0,1) of lr's dtype drawn from ``generator``."""
        if hf is None:
            if generator is None:
                raise ValueError("decode needs the HF channels hf or a torch.Generator")
            hf = torch.rand((*lr.shape[:-1], self.hf_dim), generator=generator,
                            device=lr.device, dtype=lr.dtype)
        return self.decode_with_hf(lr, hf)[0], hf

    def forward(self, x, rev: bool = False, hf=None, generator=None):
        """Forward: (LR, mean(HF^2)); reverse: ``decode(x)``."""
        if not rev:
            y, _ = self.encode(x)
            return y[..., :3], torch.mean(y[..., 3:] ** 2)
        return self.decode(x, hf=hf, generator=generator)
