"""Affine coupling block (the INN workhorse).

  forward: y1 = x1 + F(x2);  s = clamp*(2*sigmoid(H(y1)) - 1)
           y2 = x2 * exp(s) + G(y1)
  reverse: s = clamp*(2*sigmoid(H(x1)) - 1)
           y2 = (x2 - G(x1)) * exp(-s);  y1 = x1 - F(y2)
  log-jac: +-sum(s) / (B*T)

The block carries the ``(x1, x2)`` pair (x1 = the 3 LR channels, x2 = the
high-frequency rest) and never concatenates it. Where the subnets are D2DT
chains (``SUPPORTS_EP``), the coupling arithmetic rides them as fused
epilogues: H emits exp(+-s) directly, the y1/y2 combines happen on conv5's
accumulator, and the log-jacobian is recovered as sum(log(exp(+-s))). With
"hg" among ``variants`` (``network_G.chain_variants``), H and G, which read
the same input, run as one pair with the y2 combine
(``ops/chain_variants.py:fused_hg_pair``, kernel B7; JAX ``use_hg``). Every
other subnet family takes the plain branch above, as in the JAX package.

``forward(pair, rev, stripe)``: with ``stripe`` > 0 the pair arrives
W-packed with images of that width (``models/inv_nets.py`` packs the chain
of blocks once), and F, G and H take the stripe to the chain kernel's
masks. The plain branch and the pair have none, and raise under a stripe, as
the JAX coupling does: an unmasked route would mix neighbouring images. The
log-jacobian is then normalised by the packed batch; the net rescales the
sum.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import chain_variants as _cv


class InvBlockExp(nn.Module):
    def __init__(self, channel_num, channel_split_num, subnet_ctor,
                 clamp: float = 1.0, generator=None):
        super().__init__()
        s1 = channel_split_num
        s2 = channel_num - s1
        self.split = (s1, s2)
        self.clamp = clamp
        # creation order F, G, H matches the JAX package's
        self.F = subnet_ctor(s2, s1, generator=generator)
        self.G = subnet_ctor(s1, s2, generator=generator)
        self.H = subnet_ctor(s1, s2, generator=generator)
        self.use_ep = getattr(type(self.F), "SUPPORTS_EP", False)
        self.variants = frozenset()  # the nets set it from network_G.chain_variants

    def forward(self, pair, rev: bool = False, stripe: int = 0):
        """pair: (x1 (B,T,H,W,s1), x2 (B,T,H,W,s2)), both contiguous, W-packed
        with images ``stripe`` wide when it is > 0. Returns ((y1, y2),
        log_jac)."""
        x1, x2 = pair
        if stripe and not self.use_ep:
            raise RuntimeError("a W-packed coupling needs the chain kernel's stripe masks: "
                               "the plain branch would mix neighbouring images")
        if stripe and "hg" in self.variants:
            raise RuntimeError("a W-packed coupling cannot take the H/G pair: it has no stripe masks")
        if not self.use_ep:
            return self._plain(x1, x2, rev)
        if "hg" in self.variants and not rev:
            y1 = self.F(x2, ep=("add", 1.0, x1, None))
            y2, s_exp = _cv.fused_hg_pair(y1, x2, *self.H.weights(), *self.G.weights(), self.clamp, False)
        elif "hg" in self.variants:
            y2, s_exp = _cv.fused_hg_pair(x1, x2, *self.H.weights(), *self.G.weights(), self.clamp, True)
            y1 = self.F(y2, ep=("sub_from", 1.0, x1, None))
        elif not rev:
            y1 = self.F(x2, ep=("add", 1.0, x1, None), stripe=stripe)
            s_exp = self.H(y1, ep=("sig_exp", self.clamp, None, None), stripe=stripe)
            y2 = self.G(y1, ep=("mul_add", 1.0, x2, s_exp), stripe=stripe)
        else:
            s_exp = self.H(x1, ep=("sig_exp_neg", self.clamp, None, None), stripe=stripe)
            y2 = self.G(x1, ep=("sub_mul", 1.0, x2, s_exp), stripe=stripe)
            y1 = self.F(y2, ep=("sub_from", 1.0, x1, None), stripe=stripe)
        jac = torch.sum(torch.log(s_exp.float())) / (x1.shape[0] * x1.shape[1])
        return (y1, y2), jac

    def _plain(self, x1, x2, rev):
        """The coupling for subnets without the fused epilogues
        (selfc_tpu/models/coupling.py, its last two branches)."""
        if not rev:
            y1 = x1 + self.F(x2)
            s = self.clamp * (2.0 * torch.sigmoid(self.H(y1)) - 1.0)
            y2 = x2 * torch.exp(s) + self.G(y1)
            jac = torch.sum(s.float())
        else:
            s = self.clamp * (2.0 * torch.sigmoid(self.H(x1)) - 1.0)
            y2 = (x2 - self.G(x1)) * torch.exp(-s)
            y1 = x1 - self.F(y2)
            jac = -torch.sum(s.float())
        return (y1, y2), jac / (x1.shape[0] * x1.shape[1])
