"""Compression model wrapper, the serving half: the JAX package's
``train/codec_model.py:CodecModel`` for the SelfC_GMM_Codec model type
(reference SelfC_Codec_model.py:21-294).

Eval is the streaming pipeline (``codec/pipeline.py``) through a live x265
stream (or its stand-in) with segments of 3 frames and spatial tiles: the
encode and decode calls run on the device, the codec on the host, and the
host codec write of one group of segments overlaps the device's encode of
the next. One device, the reference placement; training is a later slice.

All host I/O is channels-last numpy ``(B, T, H, W, 3)``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .. import resolve_device
from ..codec.h265 import rate_source
from ..codec.pipeline import compress_video
from ..models import define_G
from ..ops.quantize import quantize_ste
from ..utils.jax_import import load_jax_params
from .rescale_model import make_degrade


class CodecModel:
    """Eval wrapper for the SelfC_GMM_Codec model type: ``feed_data`` ->
    ``test`` -> ``get_current_visuals`` / ``get_current_metrics``."""

    def __init__(self, opt, device=None, rng_seed: int = 0):
        """``device=None`` means the GPU (raises without one). ``rng_seed``
        seeds the parameter initialisation and the generator a GMM prior
        draws its noise from (the published codec prior, fh_loss 'l2',
        draws none)."""
        if opt.get("is_train"):
            raise NotImplementedError(
                "CodecModel serves only: the codec's training (surrogate, "
                "split-at-codec step) is a later slice (ROADMAP A14, A16)")
        if ((opt.get("path") or {}).get("pretrain_model_G")):
            raise NotImplementedError(
                "path.pretrain_model_G: loading a checkpoint is not ported yet "
                "(ROADMAP A18); load parameters with load_jax_params")
        self.opt = opt
        self.is_train = False
        self.device = resolve_device(device)
        self.net_opt = opt["network_G"]
        self.scale = opt["scale"]
        self.degrade = make_degrade(opt.get("distortion") or "sr_bd", self.scale)
        self.q = self.net_opt.get("h265_q")
        self.keyint = self.net_opt.get("h265_keyint")
        self.h265_all_default = bool(self.net_opt.get("h265_all_default"))
        val_opt = opt.get("val") or {}
        # the stand-in codec where no real x265 exists (codec/standin.py)
        self._standin_codec = (val_opt.get("standin_codec")
                               or (opt.get("train") or {}).get("standin_codec"))
        # the provenance of every bpp: 'x265' | 'zlib' | 'formula'
        self.rate_source = rate_source(self._standin_codec)
        init_gen = torch.Generator().manual_seed(rng_seed)
        self.net = define_G(opt, device=self.device, generator=init_gen)
        self.net.eval()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        self.log_dict = OrderedDict()

    def load_jax_params(self, tree):
        """Parameters in the JAX package's tree (numpy leaves) -> the net."""
        load_jax_params(self.net, tree)

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

    # ------------------------------------------------------------------
    def feed_data(self, data):
        """data['GT']: numpy (B, T, H, W, 3) RGB in [0,1] (or uint8).
        Returns the clip's length."""
        gt = np.asarray(data["GT"])
        # kept on the host: the codec pipeline works on host numpy and moves
        # each chunk to the device itself
        self.real_H = np.ascontiguousarray(
            gt.astype(np.float32) / 255.0 if gt.dtype == np.uint8 else gt, np.float32)
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
