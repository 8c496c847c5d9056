"""Invertible rescaling / compression networks.

``SelfCNetGMM`` — the 4x rescaling net: frequency split (k=4) + 8 coupling
blocks + the STPNet (GMM) prior.
``SelfCNetCodec`` — the compression net (model type 'SelfC_GMM_Codec'):
frequency split (k=2) + 4 coupling blocks + the codec's STPNet (hidden 24,
growth 12, an l2 tail by default), and with ``deart_net`` a de-artifact net
that cleans the decoded LR first; the H.265 span between its encode and its
decode is ``codec/pipeline.py``'s.

Both take channels-last video ``(B, T, H, W, C)``. Methods:

  encode(x)              -> (latent, log_jac)
  prior_params(lr)       -> raw GMM parameters of the prior
  decode_with_hf(lr, hf) -> (hr, latent)
  decode(lr, eps=None, generator=None) -> (hr, sampled_hf)
  nll(lr, hf)            -> conditional NLL of hf under the prior (GMM net)
  roundtrip(x, ...)      -> encode -> STE-quantize LR -> decode
  forward(x, rev)        -> (latent, loss_c) or decode(x)   (GMM net)

Randomness is explicit: ``decode`` takes the standard-normal noise ``eps``
of shape ``(B,T,h,w,hf_dim,gmm_k)``, or a ``torch.Generator`` to draw it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .. import resolve_device
from ..ops.freq import freq_forward, freq_inverse
from ..ops.gmm import gmm_neg_log_likelihood, gmm_sample, split_params
from ..ops.quantize import quantize_ste
from .agg import GroupedGlobalDeformAgg
from .blocks import D2DT, DenseChain, subnet
from .coupling import InvBlockExp
from .stp import STPNet


class _CouplingNet(nn.Module):
    """What the two nets share: the frequency split, the chain of coupling
    blocks (``inv_blocks_{i}``), the STPNet prior (``stp_net``) and the
    sampling of the HF latents from it."""

    def __init__(self, scale, block_num, subnet_type, init_mode, stp_blk_num,
                 fh_loss, gmm_k, global_module, stp_hidden_c, stp_gc,
                 save_chain_feats, device, generator, deform_radius=None, frames=3):
        super().__init__()
        device = resolve_device(device)
        self.scale = scale
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
        # training memory against backward time: see blocks.DenseChain
        for mod in self.modules():
            if isinstance(mod, DenseChain):
                mod.save_feats = bool(save_chain_feats)
        self.to(device)

    def _blocks(self, rev: bool):
        order = range(self.n_blocks)
        return [getattr(self, f"inv_blocks_{i}")
                for i in (reversed(order) if rev else order)]

    def _chain(self, pair, rev: bool):
        jac = 0.0
        for blk in self._blocks(rev):
            pair, j = blk(pair, rev)
            jac = jac + j
        return pair, jac

    def encode(self, x):
        """HR (B,T,H,W,3) -> latent (B,T,H/s,W/s,3*(s^2+1)), log_jac."""
        y = freq_forward(x, self.scale)
        # the (LR, HF) pair is carried through the chain; the whole latent
        # is assembled once at the end, not per block
        pair, jac = self._chain(
            (y[..., :3].contiguous(), y[..., 3:].contiguous()), False)
        return torch.cat(pair, dim=-1), jac

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
        return gmm_sample(p, eps)

    def decode(self, lr, eps=None, generator=None):
        """LR (B,T,h,w,3) -> (HR (B,T,H,W,3), hf): sampled from the prior's
        GMM, or with fh_loss 'l2' the prior's output itself."""
        params = self.prior_params(lr)
        hf = self._sample_hf(params, eps, generator)
        return self.decode_with_hf(lr, hf)[0], hf

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
                 device=None, generator=None):
        super().__init__(scale, block_num, subnet_type, init_mode, stp_blk_num,
                         fh_loss, gmm_k, global_module, 64, 32,
                         save_chain_feats, device, generator, deform_radius, frames)
        # the forward conditional NLL is off by default, as in the trained
        # snapshot; set True to restore the loss_c term
        self.nll_enabled = nll_enabled

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
                 device=None, generator=None):
        super().__init__(scale, block_num, subnet_type, init_mode, stp_blk_num,
                         fh_loss, gmm_k, global_module, stp_hidden_c,
                         stp_denseblock_innerc, save_chain_feats, device,
                         generator, deform_radius, frames)
        self.deart_net = bool(deart_net)
        if self.deart_net:
            # created after the coupling blocks and the prior, as in the JAX setup()
            self.deart_0 = D2DT(3, 32, 32, "plain_xavier", generator)
            self.deart_1 = GroupedGlobalDeformAgg(32, frames, deform_radius=deform_radius,
                                                  generator=generator)
            self.deart_2 = D2DT(32, 3, 32, "plain_xavier", generator)
            for chain in (self.deart_0.chain, self.deart_2.chain):
                chain.save_feats = bool(save_chain_feats)
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
