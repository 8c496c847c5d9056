"""Rescaling model wrapper — the JAX package's ``RescaleModel`` for the
SelfC_GMM model type: feed_data / optimize_parameters / test / downscale /
upscale / get_current_log / get_current_visuals.

All host I/O is channels-last numpy ``(B, T, H, W, 3)``.
"""

from __future__ import annotations

import copy
import logging
from collections import OrderedDict

import numpy as np
import torch

from .. import resolve_device
from ..models import define_G
from ..ops.quantize import quantize_ste
from ..ops.resize import area_down, gaussian_downsample
from ..utils.jax_import import load_jax_params
from .losses import reconstruction_loss
from .lr_schedule import cosine_restart, multistep_restart

logger = logging.getLogger("base")


def make_degrade(distortion: str, scale: int):
    """The function that makes the LR target from the HR clip."""
    if distortion == "pytorch_bicubic":
        return lambda x: area_down(x, scale)
    if distortion == "sr_bd":
        return lambda x: gaussian_downsample(x, scale)
    if distortion == "matlab":
        raise NotImplementedError(
            "distortion 'matlab' needs the MATLAB bicubic resize, which is "
            "not ported yet (ROADMAP A25)")
    raise ValueError(f"distortion {distortion!r}")


def clip_by_global_norm_(params, max_norm: float):
    """Scale the gradients in place so that their global l2 norm is at most
    ``max_norm`` (exactly ``g * max_norm / norm`` when it is larger, else
    untouched; no epsilon in the divisor). Stays on the device: no
    synchronisation. Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def build_adam(params, to):
    """Adam with the weight decay coupled into the gradient (``g + wd * p``
    before the moments), eps 1e-8 outside the root, from the ``train``
    options; the caller clips the gradients by global norm first
    (``clip_by_global_norm_``). Returns the optimizer and the steps at which
    its moments are cleared (``train.restarts`` when ``train.clear_state``
    is set)."""
    optimizer = torch.optim.Adam(
        params, lr=to.get("lr_G") or 1e-4,
        betas=(to.get("beta1") or 0.9, to.get("beta2") or 0.999),
        eps=1e-8, weight_decay=to.get("weight_decay_G") or 0.0)
    clear = (frozenset(int(r) for r in (to.get("restarts") or []))
             if to.get("clear_state") else frozenset())
    return optimizer, clear


class RescaleModel:
    """Training and eval wrapper for the SelfC_GMM model type."""

    def __init__(self, opt, device=None, rng_seed: int = 0):
        """``device=None`` means the GPU (raises without one).
        ``val.sample_seed`` overrides ``rng_seed``: it seeds both the
        parameter initialisation and the generator the GMM prior draws its
        noise from. With ``opt['is_train']`` the optimizer is built from
        ``opt['train']``."""
        if (opt.get("path") or {}).get("pretrain_model_G"):
            raise NotImplementedError(
                "path.pretrain_model_G: loading a checkpoint is not ported yet "
                "(ROADMAP A18); load parameters with load_jax_params")
        cfg_seed = (opt.get("val") or {}).get("sample_seed")
        if cfg_seed is not None:
            rng_seed = int(cfg_seed)
        self.opt = opt
        self.is_train = bool(opt.get("is_train"))
        self.train_opt = opt.get("train") or {}
        self.device = resolve_device(device)
        self.scale = opt["scale"]
        self.degrade = make_degrade(opt.get("distortion") or "sr_bd", self.scale)
        init_gen = torch.Generator().manual_seed(rng_seed)
        self.net = define_G(opt, device=self.device, generator=init_gen)
        self.net.eval()
        self._net_cast = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        self.log_dict = OrderedDict()
        self._raw_logs = None
        if self.is_train:
            if self.train_opt.get("gan_weight"):
                raise NotImplementedError(
                    "train.gan_weight: the adversarial branch is not ported "
                    "yet (ROADMAP A25)")
            self._build_optimizer()

    def _build_optimizer(self):
        """``train.fused_optimizer`` is accepted and changes nothing: it
        names the same arithmetic on one flat vector, and there is one
        optimizer here."""
        to = self.train_opt
        base_lr = to.get("lr_G") or 1e-4
        self.optimizer, self._clear_state_steps = build_adam(self.net.parameters(), to)
        scheme = to.get("lr_scheme") or "MultiStepLR"
        if scheme == "MultiStepLR":
            self.lr_fn = multistep_restart(
                base_lr, to.get("lr_steps") or [], to.get("lr_gamma") or 0.5,
                to.get("restarts"), to.get("restart_weights"),
                to.get("warmup_iter") or -1)
        elif scheme == "CosineAnnealingLR_Restart":
            self.lr_fn = cosine_restart(
                base_lr, to.get("T_period"), to.get("eta_min") or 1e-7,
                to.get("restarts"), to.get("restart_weights"),
                to.get("warmup_iter") or -1)
        else:
            raise NotImplementedError(scheme)

    # ------------------------------------------------------------------
    def load_jax_params(self, tree):
        """Parameters in the JAX package's tree (numpy leaves) -> the net."""
        load_jax_params(self.net, tree)
        self._net_cast = None

    def _eval_dtype(self):
        """val.eval_dtype: bfloat16 switches the eval roundtrip to bf16
        activations and parameters; outputs return as fp32 so the STE
        quantization and the metrics are unaffected. Default fp32."""
        name = str((self.opt.get("val") or {}).get("eval_dtype") or "float32").lower()
        if name in ("bf16", "bfloat16"):
            return torch.bfloat16
        if name in ("f32", "fp32", "float32"):
            return None
        raise ValueError(f"val.eval_dtype {name!r}")

    def _net_for(self, dt):
        if dt is None:
            return self.net
        if self._net_cast is None:
            self._net_cast = copy.deepcopy(self.net).to(dt)
        return self._net_cast

    @torch.no_grad()
    def _encode(self, x):
        dt = self._eval_dtype()
        y, _ = self._net_for(dt).encode(x if dt is None else x.to(dt))
        return y.float()

    @torch.no_grad()
    def _decode(self, lr, eps):
        dt = self._eval_dtype()
        hr, hf = self._net_for(dt).decode(lr if dt is None else lr.to(dt), eps=eps)
        return hr.float(), hf.float()

    def _draw_eps(self, lr_shape):
        return torch.randn(self.net.eps_shape(lr_shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)

    # ------------------------------------------------------------------
    def feed_data(self, data):
        """data['GT']: numpy (B, T, H, W, 3) RGB in [0,1] (or uint8). A
        clip shorter than ``datasets.train.video_len`` is padded to it with
        repeats of its last frame. Returns the clip's own length."""
        gt = np.asarray(data["GT"])
        clip_length = gt.shape[1]
        t_cfg = ((self.opt.get("datasets") or {}).get("train") or {}).get("video_len")
        if t_cfg and clip_length < t_cfg:
            pad = np.repeat(gt[:, -1:], t_cfg - clip_length, axis=1)
            gt = np.concatenate([gt, pad], axis=1)
        x = torch.from_numpy(np.ascontiguousarray(gt)).to(self.device)
        self.real_H = x.float() / 255.0 if gt.dtype == np.uint8 else x.float()
        return clip_length

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _pixel_losses(self, hr, ref_l, eps):
        """The roundtrip and its losses: ``(loss, logs, out)``. With
        ``train.mixed_precision`` the activations are bf16 and the
        parameters stay fp32 masters (each op casts its weights down); the
        losses are taken in fp32 and the 255-level quantization always
        rounds in fp32."""
        to = self.train_opt
        x_in = hr.to(torch.bfloat16) if to.get("mixed_precision") else hr
        out = self.net.roundtrip(x_in, eps=eps)
        l_forw_fit = (to.get("lambda_fit_forw") or 1.0) * reconstruction_loss(
            out["lr_pre_quant"].float(), ref_l, to.get("pixel_criterion_forw") or "l2")
        l_back_rec = (to.get("lambda_rec_back") or 1.0) * reconstruction_loss(
            out["hr"].float(), hr, to.get("pixel_criterion_back") or "l1")
        loss_c = (to.get("lambda_cond_prob") or 0.0) * out["loss_c"].float()
        # the total is scaled by the 144*144*3 values of a training crop
        loss = (l_forw_fit + l_back_rec + loss_c) * 144 * 144 * 3
        logs = {"l_forw_fit": l_forw_fit, "l_back_rec": l_back_rec,
                "loss_c": loss_c, "loss": loss}
        return loss, logs, out

    def optimize_parameters(self, step: int, eps=None):
        """One training step on the clip of ``feed_data``. ``eps`` is the
        prior's standard-normal noise (see ``SelfCNetGMM.eps_shape``); by
        default it is drawn from the model's generator. A non-finite loss
        skips the whole update, parameters and moments
        (``skipped_nonfinite`` in the log); reading that decision is the
        step's one synchronisation with the device."""
        if not self.is_train:
            raise RuntimeError("optimize_parameters needs opt['is_train']")
        lr_value = self.lr_fn(step)
        if step in self._clear_state_steps:
            self.optimizer.state.clear()
        hr = self.real_H
        with torch.no_grad():
            ref_l = self.degrade(hr)
        if eps is None:
            B, T, H, W, _ = hr.shape
            eps = self._draw_eps((B, T, H // self.scale, W // self.scale, 3))
        else:
            eps = torch.as_tensor(eps, dtype=torch.float32, device=self.device)
        self.optimizer.zero_grad(set_to_none=True)
        loss, logs, _ = self._pixel_losses(hr, ref_l, eps)
        ok = bool(torch.isfinite(loss))
        if ok:
            loss.backward()
            clip = self.train_opt.get("gradient_clipping")
            if clip:
                self.grad_norm = clip_by_global_norm_(list(self.net.parameters()), float(clip))
            for group in self.optimizer.param_groups:
                group["lr"] = lr_value
            self.optimizer.step()
            self._net_cast = None
        logs = {k: v.detach() for k, v in logs.items()}
        logs["skipped_nonfinite"] = torch.full_like(logs["loss"], 0.0 if ok else 1.0)
        self._raw_logs, self._raw_logs_lr = logs, lr_value

    def get_current_log(self):
        """The last step's losses as floats (one read from the device, made
        here and not in the step), with ``skipped_nonfinite`` and ``lr``."""
        if self._raw_logs is not None:
            keys = sorted(self._raw_logs)
            vals = torch.stack([self._raw_logs[k].float() for k in keys]).tolist()
            self.log_dict = OrderedDict(zip(keys, vals))
            self.log_dict["lr"] = float(self._raw_logs_lr)
            self._raw_logs = None
        return self.log_dict

    def test(self, gop: int = 7):
        """GOP-chunked eval roundtrip: encode -> split -> quantize ->
        decode per ``gop``-frame group, the last group padded by repeating
        the final frame.

        ``val.gop_batch: N`` folds N independent GOPs into the batch axis
        of ONE encode + ONE decode call (unset: up to 4; 1 = sequential
        calls). The trailing call is padded with repeats of its last GOP.
        One ``eps`` is drawn per real group from the model's generator, in
        the order of the sequential path, so the sample stream does not
        depend on ``gop_batch``."""
        x = self.real_H
        B, T = x.shape[:2]
        n_groups = -(-T // gop)
        n_batch = (self.opt.get("val") or {}).get("gop_batch")
        if n_batch is None:
            n_batch = max(1, min(4, n_groups))
        n_batch = int(n_batch)

        groups = []
        for start in range(0, T, gop):
            idx = list(range(start, min(start + gop, T)))
            orig = len(idx)
            idx += [T - 1] * (gop - orig)
            groups.append((torch.as_tensor(idx, device=self.device), orig))

        fake_H, forw_L, forw_Hf, sample_H = [], [], [], []
        for i in range(0, len(groups), n_batch):
            grp = groups[i:i + n_batch]
            pad_grp = grp + [grp[-1]] * (n_batch - len(grp))
            chunk = torch.cat([x[:, g[0]] for g in pad_grp], dim=0)
            y = self._encode(chunk)
            lr = quantize_ste(y[..., :3].contiguous())
            eps = [self._draw_eps((B,) + tuple(lr.shape[1:])) for _ in grp]
            eps += [eps[-1]] * (n_batch - len(grp))
            hr, hf = self._decode(lr, torch.cat(eps, dim=0))
            for j, (_, orig) in enumerate(grp):
                sl = slice(j * B, (j + 1) * B)
                fake_H.append(hr[sl, :orig])
                forw_L.append(lr[sl, :orig])
                forw_Hf.append(y[sl, :orig, ..., 3:])
                sample_H.append(hf[sl, :orig])
        self.fake_H = torch.cat(fake_H, dim=1).cpu().numpy()
        self.forw_L = torch.cat(forw_L, dim=1).cpu().numpy()
        self.forw_H = torch.cat(forw_Hf, dim=1).cpu().numpy()
        self.sample_H = torch.cat(sample_H, dim=1).cpu().numpy()

    def downscale(self, hr):
        x = torch.as_tensor(np.asarray(hr), dtype=torch.float32, device=self.device)
        y = self._encode(x)
        return quantize_ste(y[..., :3].contiguous()).cpu().numpy()

    def upscale(self, lr):
        x = torch.as_tensor(np.asarray(lr), dtype=torch.float32, device=self.device)
        hr, _ = self._decode(x, self._draw_eps(x.shape))
        return hr.cpu().numpy()

    def get_current_visuals(self):
        out = OrderedDict()
        out["SR"] = self.fake_H
        out["LR"] = self.forw_L
        with torch.no_grad():
            out["LR_ref"] = self.degrade(self.real_H).cpu().numpy()
        out["GT"] = self.real_H.cpu().numpy()
        out["forw_H"] = self.forw_H
        return out
