"""The adversarial branch of the rescaling model's training (the JAX
package's ``train/gan.py``), on when ``train.gan_weight`` is set.

``AdversarialBranch`` holds the discriminator D (``network_D``; by default
``discriminator_vgg_128`` with nf 64), its running batch statistics, its
optimizer (clip, then Adam with ``beta1_D`` / ``beta2_D`` and no weight decay,
at the rate ``lr_D`` on the G step's schedule kind), and with
``train.feature_weight`` the frozen VGG-19 feature extractor F of the
perceptual loss (``path.pretrain_model_F``: a torchvision-layout state dict,
``.pth`` or a pickle; random weights without one).

``train_step`` is one combined step, as the JAX package's:

* G: the pixel losses, plus ``feature_weight`` times the feature loss
  ``F(fake)`` against ``F(real)``, plus ``gan_weight`` times the adversarial
  loss of D in eval mode (its running statistics) on the fake frames; for
  'ragan' against D(real), also in eval mode and detached. G's update happens
  on steps where ``step % D_update_ratio == 0 and step > D_init_iters`` and
  the loss is finite; otherwise G's parameters and moments keep their bits.
* D: two train-mode calls that chain the statistics (real with the running
  statistics, then the fake with those the first call returned), the fake
  being the frames of G's forward before G's update, detached. 'wgan-gp'
  adds ``gp_weight`` times the gradient penalty at ``eps * real + (1 - eps) *
  fake`` (D in eval mode), ``eps`` of shape ``(N, 1, 1, 1)`` drawn from the
  model's generator or fed. D's update and its new statistics are kept when
  D's loss is finite.

Frames enter D and F flattened, ``(B*T, H, W, 3)``. With ``mesh_sp`` > 1
G's forward is the width split's and its fake shards are gathered whole on
the master card: D and F always see whole frames, so D's batch-norm moments
are the whole batch's, as the JAX package's are.

With more than one process each rank steps on its share of the batch, and
what the JAX package takes over its global batch is taken over every rank:
D's train-mode batch-norm moments (``models/discriminator.py``), 'ragan''s
means of D's logits and the ``D_real`` / ``D_fake`` logs (``global_mean``).
Each rank's losses stay means over its share, and ``all_reduce_grads``
averages the gradients, so the step is the one-process step on the
concatenated batch; the gates (``D_update_ratio``, ``D_init_iters``, the
non-finite guard) read only the step and ``finite_everywhere``, the same on
every rank, so every rank makes the same collectives in the same order.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..models.discriminator import define_D, define_F
from ..parallel.dist import all_reduce_grads, finite_everywhere, global_mean
from ..parallel.mesh import gather_w
from ..utils.jax_import import export_jax_params, load_jax_params
from ..utils.torch_import import import_vgg19_features
from .losses import gan_loss, gradient_penalty, reconstruction_loss
from .lr_schedule import cosine_restart, multistep_restart

logger = logging.getLogger("base")


def flat_frames(v):
    """(B, T, H, W, C) video -> (B*T, H, W, C) frame batch for D and F."""
    return v.reshape((-1,) + tuple(v.shape[2:]))


def load_vgg19_state(path: str) -> dict:
    """A torchvision-layout VGG-19 state dict from ``path``: a ``.pth`` read
    with ``weights_only``, or a pickle of numpy arrays (read by the
    training state's unpickler, which lets numpy's own names through and
    nothing else)."""
    if path.endswith(".pth"):
        return torch.load(path, map_location="cpu", weights_only=True)
    from .checkpoint import _StateUnpickler

    with open(path, "rb") as f:
        return _StateUnpickler(f).load()


class AdversarialBranch:
    """D, its statistics and optimizer, and F, for a ``RescaleModel``;
    ``train_step`` is the combined G + D step."""

    def __init__(self, model, generator=None):
        opt, to = model.opt, model.train_opt
        self.gan_type = to.get("gan_type") or "gan"
        self.gan_w = float(to["gan_weight"])
        self.fea_w = float(to.get("feature_weight") or 0.0)
        self.fea_crit = to.get("feature_criterion") or "l1"
        self.gp_w = float(to.get("gp_weight") or 10.0)
        # G updates every D_update_ratio steps once past D_init_iters; D every step
        self.d_update_ratio = int(to.get("D_update_ratio") or 1)
        self.d_init_iters = int(to.get("D_init_iters") or 0)
        if not opt.get("network_D"):
            opt["network_D"] = type(opt)({"which_model_D": "discriminator_vgg_128", "in_nc": 3, "nf": 64})
        train_set = (opt.get("datasets") or {}).get("train") or {}
        gt = train_set.get("GT_size") or 16 * model.scale
        device = model.device
        self.netD = define_D(opt, gt, device=device, generator=generator)
        self.d_stats = self.netD.init_stats()
        self.netF = None
        if self.fea_w:
            self.netF = define_F(device=device, generator=generator)
            f_path = (opt.get("path") or {}).get("pretrain_model_F")
            if f_path:
                tree = export_jax_params(self.netF)
                imported = import_vgg19_features(load_vgg19_state(f_path))
                tree.update({k: v for k, v in imported.items() if k in tree})
                load_jax_params(self.netF, tree)
            # a frozen feature extractor: no optimizer, no gradient of its own
            self.netF.requires_grad_(False)
        self.optimizer = torch.optim.Adam(
            self.netD.parameters(), lr=to.get("lr_D") or to.get("lr_G") or 1e-4,
            betas=(to.get("beta1_D") or to.get("beta1") or 0.9, to.get("beta2_D") or to.get("beta2") or 0.999),
            eps=1e-8, weight_decay=0.0)
        lr_d = to.get("lr_D") or to.get("lr_G") or 1e-4
        if (to.get("lr_scheme") or "MultiStepLR") == "MultiStepLR":
            self.lr_d_fn = multistep_restart(
                lr_d, to.get("lr_steps") or [], to.get("lr_gamma") or 0.5, to.get("restarts"),
                to.get("restart_weights"), to.get("warmup_iter") or -1)
        else:
            self.lr_d_fn = cosine_restart(
                lr_d, to.get("T_period"), to.get("eta_min") or 1e-7, to.get("restarts"),
                to.get("restart_weights"), to.get("warmup_iter") or -1)
        logger.info("Adversarial branch on: gan_type=%s gan_w=%g fea_w=%g D_update_ratio=%d D_init_iters=%d",
                    self.gan_type, self.gan_w, self.fea_w, self.d_update_ratio, self.d_init_iters)

    # ------------------------------------------------------------------
    def adv_loss(self, pred_fake, pred_real, for_g: bool):
        """G's or D's adversarial loss; 'ragan' is the relativistic average
        form, each side against the other's mean over the global batch."""
        gt = self.gan_type
        if gt == "ragan":
            rf = pred_real - global_mean(pred_fake)
            fr = pred_fake - global_mean(pred_real)
            if for_g:
                return 0.5 * (gan_loss(rf, False, "gan") + gan_loss(fr, True, "gan"))
            return 0.5 * (gan_loss(rf, True, "gan") + gan_loss(fr, False, "gan"))
        if for_g:
            return gan_loss(pred_fake, True, gt)
        return gan_loss(pred_real, True, gt) + gan_loss(pred_fake, False, gt)

    # ------------------------------------------------------------------
    def g_loss(self, model, hr, ref_l, eps):
        """G's loss and logs, and the fake frames: ``(loss, logs, fake)``.
        With ``mesh_sp`` > 1 the pixel losses come from the width split
        (``ref_l`` unused: the split makes the target by shards) and the
        fake HR shards are gathered whole on the master card, where F and D
        run; the gather's adjoint takes the fake's gradient back to the
        shards."""
        if model.mesh.sp > 1:
            loss_pix, logs, out = model._width_split_losses(hr, eps)
            fake_hr = gather_w(out["hr"], model.device)
        else:
            loss_pix, logs, out = model._pixel_losses(hr, ref_l, eps)
            fake_hr = out["hr"]
        logs = dict(logs)
        real = flat_frames(hr.float())
        fake = flat_frames(fake_hr.float())
        total = loss_pix
        if self.netF is not None:
            with torch.no_grad():
                fea_real = self.netF(real)
            l_fea = self.fea_w * reconstruction_loss(self.netF(fake), fea_real, self.fea_crit)
            total = total + l_fea
            logs["l_g_fea"] = l_fea
        pred_fake, _ = self.netD(fake, self.d_stats, False)
        pred_real = pred_fake
        if self.gan_type == "ragan":
            with torch.no_grad():
                pred_real, _ = self.netD(real, self.d_stats, False)
        l_gan = self.gan_w * self.adv_loss(pred_fake, pred_real, True)
        logs["l_g_gan"] = l_gan
        return total + l_gan, logs, fake

    def d_loss(self, real, fake, gp_eps=None, generator=None):
        """D's loss, the statistics after its two train-mode calls, and its
        logs: ``(loss, stats, logs)``."""
        pred_real, stats1 = self.netD(real, self.d_stats, True)
        pred_fake, stats2 = self.netD(fake, stats1, True)
        l_d = self.adv_loss(pred_fake, pred_real, False)
        logs = {"D_real": global_mean(pred_real.detach()), "D_fake": global_mean(pred_fake.detach())}
        if self.gan_type == "wgan-gp":
            if gp_eps is None:
                gp_eps = torch.rand((real.shape[0], 1, 1, 1), generator=generator, device=real.device)
            else:
                gp_eps = torch.as_tensor(np.array(gp_eps, np.float32), device=real.device)
            interp = gp_eps * real + (1.0 - gp_eps) * fake
            l_d = l_d + self.gp_w * gradient_penalty(lambda x: self.netD(x, self.d_stats, False)[0], interp)
        return l_d, stats2, logs

    def train_step(self, model, step: int, lr_g: float, lr_d: float, eps, gp_eps=None):
        """One combined G + D step on ``model.real_H`` with the prior's noise
        ``eps``; returns the step's logs (device scalars)."""
        from .rescale_model import clip_by_global_norm_

        hr = model.real_H
        ref_l = None
        if model.mesh.sp == 1:
            with torch.no_grad():
                ref_l = model.degrade(hr)
        clip = model.train_opt.get("gradient_clipping")

        # ---- G ----------------------------------------------------------
        model.optimizer.zero_grad(set_to_none=True)
        self.netD.requires_grad_(False)   # G's loss takes no gradient of D's parameters
        try:
            g_loss, logs, fake = self.g_loss(model, hr, ref_l, eps)
            g_finite = finite_everywhere(g_loss)
            if step % self.d_update_ratio == 0 and step > self.d_init_iters and g_finite:
                g_loss.backward()
                all_reduce_grads(model.net.parameters())
                if clip:
                    model.grad_norm = clip_by_global_norm_(list(model.net.parameters()), float(clip))
                for group in model.optimizer.param_groups:
                    group["lr"] = lr_g
                model.optimizer.step()
                model._net_cast = None
        finally:
            self.netD.requires_grad_(True)
        del g_loss   # a gated step's graph, freed before D's

        # ---- D: on the fake of G's forward before G's update ------------
        self.optimizer.zero_grad(set_to_none=True)
        real = flat_frames(hr.float())
        d_loss, stats, d_logs = self.d_loss(real, fake.detach(), gp_eps, model.generator)
        if finite_everywhere(d_loss):
            d_loss.backward()
            params = list(self.netD.parameters())
            all_reduce_grads(params)
            if clip:
                clip_by_global_norm_(params, float(clip))
            for group in self.optimizer.param_groups:
                group["lr"] = lr_d
            self.optimizer.step()
            self.d_stats = stats
        logs = {k: v.detach() for k, v in logs.items()}
        logs.update(l_d=d_loss.detach(), **d_logs)
        logs["skipped_nonfinite"] = torch.full_like(logs["loss"], 0.0 if g_finite else 1.0)
        return logs

    # ------------------------------------------------------------------
    def stats_numpy(self) -> dict:
        return {k: {n: t.detach().float().cpu().numpy() for n, t in v.items()} for k, v in self.d_stats.items()}

    def load_stats(self, tree):
        """The running statistics from a ``{bn: {mean, var}}`` tree (a
        ``.state``'s ``d_stats``)."""
        want = self.netD.init_stats()
        if set(tree) != set(want):
            raise KeyError(f"batch-stat names differ: {sorted(set(tree) ^ set(want))[:5]}")
        out = {}
        for k, v in want.items():
            out[k] = {}
            for n, t in v.items():
                a = torch.as_tensor(np.array(tree[k][n], np.float32), device=t.device)
                if a.shape != t.shape:
                    raise ValueError(f"{k}.{n}: shape {tuple(a.shape)}, expected {tuple(t.shape)}")
                out[k][n] = a
        self.d_stats = out
