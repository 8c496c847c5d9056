"""Training losses of the rescaling models."""

from __future__ import annotations

import torch


def reconstruction_error(x, target, losstype: str = "l2", eps: float = 1e-6):
    """The elementwise error: l2 = squared error; l1 = charbonnier
    sqrt(d^2 + eps)."""
    d = x - target
    if losstype == "l2":
        return d * d
    if losstype == "l1":
        return torch.sqrt(d * d + eps)
    raise ValueError(losstype)


def reconstruction_loss(x, target, losstype: str = "l2", eps: float = 1e-6):
    """The mean of ``reconstruction_error`` over every dimension."""
    return torch.mean(reconstruction_error(x, target, losstype, eps))


def gan_loss(logits, target_is_real: bool, gan_type: str = "gan",
             real_label_val: float = 1.0, fake_label_val: float = 0.0):
    """The adversarial loss of D's logits: 'gan' / 'ragan' BCE-with-logits
    in its stable form ``max(z, 0) - z t + log1p(exp(-|z|))``, 'lsgan' the
    mean squared distance to the label, 'wgan-gp' -mean (real) or +mean
    (fake)."""
    if gan_type in ("gan", "ragan"):
        target = real_label_val if target_is_real else fake_label_val
        return torch.mean(torch.clamp_min(logits, 0) - logits * target
                          + torch.log1p(torch.exp(-torch.abs(logits))))
    if gan_type == "lsgan":
        target = real_label_val if target_is_real else fake_label_val
        return torch.mean((logits - target) ** 2)
    if gan_type == "wgan-gp":
        return -torch.mean(logits) if target_is_real else torch.mean(logits)
    raise NotImplementedError(f"GAN type [{gan_type}] is not found")


def gradient_penalty(disc_fn, interp):
    """WGAN-GP's penalty ``((||dD/dx||_2 - 1)^2).mean()`` over the batch,
    the norm taken per sample with 1e-12 inside the root. The gradient is
    taken with ``create_graph`` so the penalty differentiates in D's
    parameters."""
    interp = interp.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(disc_fn(interp).sum(), interp, create_graph=True)
    g = g.reshape(g.shape[0], -1)
    norm = torch.sqrt(torch.sum(g ** 2, dim=1) + 1e-12)
    return torch.mean((norm - 1.0) ** 2)
