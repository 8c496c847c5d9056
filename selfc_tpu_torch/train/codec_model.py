"""Compression model wrapper: the JAX package's
``train/codec_model.py:CodecModel`` for the SelfC_GMM_Codec model type
(reference SelfC_Codec_model.py:21-294).

Training (``opt['is_train']``): encode -> the 255-level LR -> the host codec
-> the surrogate's value swap (or a plain straight-through swap, or additive
noise) -> decode; loss = (l_forw_fit + l_back_rec + loss_c +
lambda_mimick * mimick) * loss_multiplier (reference :137-175). The step is
split at the codec, as the JAX package's: the encode runs once under
autograd, its quantised LR goes to the host codec, and the loss's one
``backward`` pulls the encode's gradients through the graph autograd kept
(the JAX package carries the encode's VJP residuals across the same split).

Eval (``test``) is the streaming pipeline (``codec/pipeline.py``) through a
live x265 stream (or its stand-in) with segments of 3 frames and spatial
tiles: the encode and decode calls run on the device, the codec on the host,
and the host codec write of one group of segments overlaps the device's
encode of the next. One device, the reference placement.

All host I/O is channels-last numpy ``(B, T, H, W, 3)``.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch
import torch.nn as nn

from .. import resolve_device
from ..codec.h265 import rate_source
from ..codec.noise import add_noise
from ..codec.pipeline import compress_video
from ..codec.surrogate import (H265Surrogate, H265SurrogatePlain, h265_host_roundtrip,
                               mimick_and_swap, mimick_plain)
from ..models import define_G
from ..ops.quantize import quantize_ste
from ..utils.jax_import import load_jax_params
from .losses import reconstruction_loss
from .lr_schedule import multistep_restart
from .rescale_model import build_adam, clip_by_global_norm_, make_degrade


class CodecModel:
    """Wrapper for the SelfC_GMM_Codec model type. Eval: ``feed_data`` ->
    ``test`` -> ``get_current_visuals`` / ``get_current_metrics``. Training:
    ``feed_data`` -> ``optimize_parameters(step)`` -> ``get_current_log``."""

    def __init__(self, opt, device=None, rng_seed: int = 0):
        """``device=None`` means the GPU (raises without one). ``rng_seed``
        seeds the parameter initialisation, the generator a GMM prior or the
        codec-noise ablation draws from (the published codec prior, fh_loss
        'l2', draws none) and the dynamic-q stream."""
        if ((opt.get("path") or {}).get("pretrain_model_G")):
            raise NotImplementedError(
                "path.pretrain_model_G: loading a checkpoint is not ported yet "
                "(ROADMAP A18); load parameters with load_jax_params")
        self.opt = opt
        self.is_train = bool(opt.get("is_train"))
        self.train_opt = opt.get("train") or {}
        if self.is_train and self.train_opt.get("codec_pipeline"):
            raise NotImplementedError(
                "train.codec_pipeline: the one-step-stale pipelined step is not "
                "ported yet (ROADMAP A16', the pipelined step); the serial "
                "split-at-codec step is")
        self.device = resolve_device(device)
        self.net_opt = opt["network_G"]
        self.scale = opt["scale"]
        self.degrade = make_degrade(opt.get("distortion") or "sr_bd", self.scale)
        self.q = self.net_opt.get("h265_q")
        self.keyint = self.net_opt.get("h265_keyint")
        self.h265_all_default = bool(self.net_opt.get("h265_all_default"))
        val_opt = opt.get("val") or {}
        # the stand-in codec where no real x265 exists (codec/standin.py)
        self._standin_codec = val_opt.get("standin_codec") or self.train_opt.get("standin_codec")
        # the provenance of every bpp: 'x265' | 'zlib' | 'formula'
        self.rate_source = rate_source(self._standin_codec)
        # bf16 activations over fp32 masters; the 255-level rounding and the
        # host codec stay fp32, the losses are taken in fp32
        self._mp = bool(self.is_train and self.train_opt.get("mixed_precision"))
        self.noise_type = self.train_opt.get("noise_type") if self.is_train else "h265"
        self._h265_keyint = ((opt.get("datasets") or {}).get("train") or {}).get("video_len") or 3
        # network_G.h265_sug_variant: 'correlation1' (indicator plane, Pearson
        # term, value swap) or 'plain' (fixed q, MSE, no swap)
        self.surrogate_variant = self.net_opt.get("h265_sug_variant") or "correlation1"
        if self.surrogate_variant == "plain" and isinstance(self.q, list):
            raise ValueError("h265_sug_variant 'plain' supports fixed q only "
                             "(the reference plain surrogate has no q indicator)")
        if self.surrogate_variant not in ("plain", "correlation1"):
            raise ValueError(f"h265_sug_variant {self.surrogate_variant!r}")
        self.use_surrogate = bool(self.is_train and self.train_opt.get("h265_sug"))

        init_gen = torch.Generator().manual_seed(rng_seed)
        self.net = define_G(opt, device=self.device, generator=init_gen)
        self.net.eval()
        modules = {"net": self.net}
        self.surrogate = None
        if self.use_surrogate:
            self.surrogate = (H265SurrogatePlain(generator=init_gen)
                              if self.surrogate_variant == "plain"
                              else H265Surrogate(isinstance(self.q, list), init_gen)).to(self.device)
            modules["surrogate"] = self.surrogate
        # every trained parameter, under the JAX package's tree names
        # {net, surrogate}
        self.params = nn.ModuleDict(modules)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        self._q_seed = rng_seed
        self.log_dict = OrderedDict()
        self._raw_logs = None
        self.last_codec_host_seconds = 0.0
        if self.is_train:
            to = self.train_opt
            self.optimizer, self._clear_state_steps = build_adam(self.params.parameters(), to)
            self.lr_fn = multistep_restart(
                to.get("lr_G") or 1e-4, to.get("lr_steps") or [], to.get("lr_gamma") or 0.5,
                to.get("restarts"), to.get("restart_weights"), to.get("warmup_iter") or -1)

    def load_jax_params(self, tree):
        """Parameters in the JAX package's tree (numpy leaves): the
        ``{net, surrogate}`` tree of a training model or a bare net tree. A
        surrogate in the tree of a model without one is dropped, as the
        JAX package's ``load`` drops it at eval."""
        if "net" in tree:
            load_jax_params(self.params, {k: v for k, v in tree.items() if k in self.params})
        else:
            load_jax_params(self.net, tree)

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _encode(self, x):
        """HR (B,T,H,W,3) -> the latent with its LR channels quantised to
        255 levels."""
        y, _ = self.net.encode(x)
        return torch.cat([quantize_ste(y[..., :3].contiguous()), y[..., 3:]], dim=-1)

    @torch.no_grad()
    def _decode(self, lr):
        hr, _ = self.net.decode(lr, generator=self.generator)
        return hr

    def _on_device(self, a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def feed_data(self, data):
        """data['GT']: numpy (B, T, H, W, 3) RGB in [0,1] (or uint8).
        Returns the clip's length."""
        gt = np.asarray(data["GT"])
        # kept on the host: the codec pipeline works on host numpy and moves
        # each chunk to the device itself; a training step takes it from the
        # device
        self.real_H = np.ascontiguousarray(
            gt.astype(np.float32) / 255.0 if gt.dtype == np.uint8 else gt, np.float32)
        self._hr = self._on_device(self.real_H) if self.is_train else None
        return gt.shape[1]

    def test(self):
        """The streaming roundtrip through the (real or stand-in) codec.
        ``val.batch_tiles`` / ``val.overlap`` (default on) and
        ``val.seg_batch`` (default 4) shape the device calls
        (``codec/pipeline.py``). The encode call hands the host only the
        quantised LR, the part of the latent the codec takes."""
        x = self.real_H

        def encode_fn(chunk):
            return self._encode(self._on_device(chunk))[..., :3]

        def decode_fn(tile):
            return self._decode(self._on_device(tile))

        q = self.q[0] if isinstance(self.q, list) else self.q
        val_opt = self.opt.get("val") or {}
        bt, ov = val_opt.get("batch_tiles"), val_opt.get("overlap")
        lr_dec, hr, video_bpp = compress_video(
            encode_fn, decode_fn, x, q, self.keyint, self.scale, self.h265_all_default,
            batch_tiles=True if bt is None else bool(bt),
            seg_batch=int(val_opt.get("seg_batch") or 4),
            overlap=True if ov is None else bool(ov),
            stand_in=self._standin_codec,
        )
        self.forw_L = lr_dec
        self.fake_H = hr
        self.video_bpp = float(video_bpp)
        self.img_bpp = float(video_bpp)
        self.mimick_loss = 0.0
        self.video_distor_loss = 0.0

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _draw_q(self, step: int) -> int:
        """Dynamic q (reference rand 8-35 a step) keyed by (seed, step), as
        the JAX package draws it: a resumed run replays the same q."""
        return int(np.random.default_rng((self._q_seed, step)).integers(
            self.q[0], self.q[1], endpoint=True))

    def _encode_lf(self, hr):
        """The encode half the host codec depends on: HR -> LF (3 ch)."""
        if self._mp:
            hr = hr.to(torch.bfloat16)
        y, _ = self.net.encode(hr)
        return y[..., :3]

    def codec_span(self, lf, q):
        """The quantised LR through the host codec: ``(codec_out on the
        device, bpp)``. The 255-level rounding is fp32 whatever lf's type;
        without the h265 noise type the span is zeros and 0 bpp."""
        with torch.no_grad():
            lr_q = torch.round(torch.clamp(lf.float(), 0.0, 1.0) * 255.0) / 255.0
        if self.noise_type != "h265":
            return torch.zeros_like(lr_q), 0.0
        t0 = time.perf_counter()
        codec_np, bpp = h265_host_roundtrip(lr_q.cpu().numpy(), q, self._h265_keyint, self.scale,
                                            stand_in=self._standin_codec)
        # includes the device -> host read of lr_q
        self.last_codec_host_seconds = time.perf_counter() - t0
        return torch.from_numpy(codec_np).to(self.device), bpp

    def _distort_lr(self, lr_q, codec_out, q_value):
        """The quantised LR -> the codec-distorted LR and the mimick loss."""
        if self.noise_type == "h265":
            if self.use_surrogate:
                sug = self.surrogate(lr_q, q_value)
                if self.surrogate_variant == "plain":
                    return mimick_plain(sug, codec_out)
                return mimick_and_swap(sug, codec_out, self.net_opt.get("lambda_corr") or 0.0)
            # a plain straight-through swap (reference Quantization_H265)
            return lr_q + (codec_out - lr_q).detach(), torch.zeros((), device=lr_q.device)
        noisy = add_noise(lr_q, self.generator, self.train_opt.get("noise_magnitude") or 1e-4,
                          self.noise_type)
        return noisy, torch.zeros((), device=lr_q.device)

    def _loss(self, lf, hr, ref_l, codec_out, q_value):
        """``(loss, logs)`` of a step from the encode's LF output."""
        to = self.train_opt
        lr_q = quantize_ste(lf)
        lr_distorted, mimick = self._distort_lr(lr_q, codec_out, q_value)
        # the swap promotes to the host codec's fp32: the decode takes lf's type
        hr_rec, _ = self.net.decode(lr_distorted.to(lf.dtype), generator=self.generator)
        l_forw_fit = (to.get("lambda_fit_forw") or 1.0) * reconstruction_loss(
            lf.float(), ref_l, to.get("pixel_criterion_forw") or "l2")
        l_back_rec = (to.get("lambda_rec_back") or 1.0) * reconstruction_loss(
            hr_rec.float(), hr, to.get("pixel_criterion_back") or "l1")
        zero = torch.zeros((), device=hr.device)
        mimick_term = (to.get("lambda_mimick_loss") or 1.0) * mimick
        loss = (l_forw_fit + l_back_rec + zero + mimick_term) * (to.get("loss_multiplier") or 1000.0)
        # the measured codec distortion (the reference logs a hard zero)
        with torch.no_grad():
            distortion = (to.get("lambda_distor_loss") or 1.0) * torch.mean(
                (codec_out - lr_q.float()) ** 2)
        return loss, {"l_forw_fit": l_forw_fit, "l_back_rec": l_back_rec, "loss_c": zero,
                      "mimick_loss": mimick_term, "distortion_loss": distortion,
                      "distribution_loss": zero, "loss": loss}

    def optimize_parameters(self, step: int, codec_out=None):
        """One training step on the clip of ``feed_data``, split at the
        codec. ``train.codec_split``: 'residual' (the default) runs the
        encode once under autograd and keeps its graph across the host
        codec; 'reencode' runs it without a graph for the codec and again
        inside the loss (the same gradients, one more encode). ``codec_out``
        (optional, ``(B,T,h,w,3)``) stands in for the host codec's output
        (its bpp is then logged as 0). A non-finite loss skips the whole
        update (``skipped_nonfinite`` in the log)."""
        if not self.is_train:
            raise RuntimeError("optimize_parameters needs opt['is_train']")
        split = self.train_opt.get("codec_split") or "residual"
        if split not in ("residual", "reencode"):
            raise ValueError(f"train.codec_split {split!r}")
        lr_value = self.lr_fn(step)
        q = self._draw_q(step) if isinstance(self.q, list) else self.q
        if step in self._clear_state_steps:
            self.optimizer.state.clear()
        hr = self._hr
        with torch.no_grad():
            ref_l = self.degrade(hr)
        self.optimizer.zero_grad(set_to_none=True)
        with torch.set_grad_enabled(split == "residual"):
            lf = self._encode_lf(hr)
        if codec_out is None:
            codec_out, img_bpp = self.codec_span(lf, q)
        else:
            codec_out, img_bpp = torch.as_tensor(codec_out, dtype=torch.float32, device=self.device), 0.0
        if split == "reencode":
            lf = self._encode_lf(hr)
        loss, logs = self._loss(lf, hr, ref_l, codec_out, q)
        ok = bool(torch.isfinite(loss))
        if ok:
            loss.backward()
            clip = self.train_opt.get("gradient_clipping")
            if clip:
                self.grad_norm = clip_by_global_norm_(list(self.params.parameters()), float(clip))
            for group in self.optimizer.param_groups:
                group["lr"] = lr_value
            self.optimizer.step()
        logs = {k: v.detach() for k, v in logs.items()}
        logs["skipped_nonfinite"] = torch.full_like(logs["loss"], 0.0 if ok else 1.0)
        self._raw_logs, self._raw_logs_lr, self._raw_logs_bpp = logs, lr_value, img_bpp

    def get_current_log(self):
        """The last step's losses as floats (one read from the device), with
        ``skipped_nonfinite``, ``lr``, the measured ``img_bpp`` of the host
        codec span and its ``rate_source``."""
        if self._raw_logs is not None:
            keys = sorted(self._raw_logs)
            vals = torch.stack([self._raw_logs[k].float() for k in keys]).tolist()
            self.log_dict = OrderedDict(zip(keys, vals))
            self.log_dict["lr"] = float(self._raw_logs_lr)
            self.log_dict["img_bpp"] = float(self._raw_logs_bpp)
            self.log_dict["rate_source"] = self.rate_source
            self._raw_logs = None
        return self.log_dict

    def get_current_metrics(self):
        return OrderedDict(video_distor_loss=self.video_distor_loss,
                           video_bpp=self.video_bpp, mimick_loss=self.mimick_loss,
                           img_bpp=self.img_bpp)

    def get_current_visuals(self):
        out = OrderedDict()
        out["SR"] = self.fake_H
        out["LR"] = self.forw_L
        with torch.no_grad():
            out["LR_ref"] = self.degrade(self._on_device(self.real_H)).cpu().numpy()
        out["GT"] = self.real_H
        return out
