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
``train.codec_pipeline`` overlaps batch i's host codec with update i-1 on the
device, its encode-side gradients one update stale (``_optimize_pipelined``).

Eval (``test``) is the streaming pipeline (``codec/pipeline.py``) through a
live x265 stream (or its stand-in) with segments of 3 frames and spatial
tiles: the encode and decode calls run on the device, the codec on the host,
and the host codec write of one group of segments overlaps the device's
encode of the next. On a mesh (``parallel/mesh.py``; by default the
process's cards) each batched call's entries split over the dp rows, as
the JAX package's ``dp_sharding`` places them; one card is the reference
placement. The training step runs on the mesh's first row: on its one
card, or with ``mesh_sp`` > 1 the width split over its cards
(``parallel/spatial.py:WidthSplitCodec``: the encode, the surrogate, the
de-artifact net and the decode on haloed or gathered shards, the host
codec on the whole frames gathered on the host, every loss a sum over
shards divided by the whole count); data parallel training goes through
processes (``parallel/dist.py``).

All host I/O is channels-last numpy ``(B, T, H, W, 3)``.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn as nn

from .. import resolve_device
from ..codec.h265 import rate_source
from ..codec.noise import add_noise, draw_noise
from ..codec.pipeline import compress_video
from ..codec.surrogate import (H265Surrogate, H265SurrogatePlain, h265_host_roundtrip,
                               mimick_and_swap, mimick_plain)
from ..models import define_G
from ..ops.quantize import quantize_ste
from ..parallel.dist import all_reduce_grads, finite_everywhere, frames_to_device
from ..parallel.mesh import Replicas, dp_gather, dp_split, gather_w, model_mesh, shard_w
from ..parallel.spatial import (WidthSplitCodec, check_supported, check_width, degrade_shards,
                                mimick_and_swap_shards, mimick_plain_shards, split_like, sum_to)
from ..utils.jax_import import export_jax_params, load_jax_params
from . import checkpoint as ckpt
from .losses import reconstruction_error, reconstruction_loss
from .lr_schedule import multistep_restart
from .rescale_model import build_adam, clip_by_global_norm_, make_degrade, step_algorithms

logger = logging.getLogger("base")


class CodecModel:
    """Wrapper for the SelfC_GMM_Codec model type. Eval: ``feed_data`` ->
    ``test`` -> ``get_current_visuals`` / ``get_current_metrics``. Training:
    ``feed_data`` -> ``optimize_parameters(step)`` -> ``get_current_log``."""

    def __init__(self, opt, device=None, rng_seed: int = 0, mesh=None):
        """``device=None`` means the GPU (raises without one); ``mesh``
        (``parallel.mesh.make_mesh``) the devices the model runs on, the
        master parameters on its first (None: ``model_mesh(device,
        opt['mesh_sp'])``): ``test()`` splits over its dp rows, the training
        step runs on its first row, with ``mesh_sp`` > 1 the width over
        the row's cards. ``rng_seed``
        seeds the parameter initialisation, the generator a GMM prior or the
        codec-noise ablation draws from (the published codec prior, fh_loss
        'l2', draws none) and the dynamic-q stream. ``path.pretrain_model_G``
        is loaded last (``load``)."""
        self.opt = opt
        self.is_train = bool(opt.get("is_train"))
        self.train_opt = opt.get("train") or {}
        self.mesh = mesh if mesh is not None else model_mesh(resolve_device(device), opt.get("mesh_sp") or 1)
        self.device = self.mesh.master
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
        self._encoder = _EncodeLF(self.net, self._mp)
        self.log_dict = OrderedDict()
        self._raw_logs = None
        self.last_codec_host_seconds = 0.0    # the host codec's wait the step paid
        self.last_codec_total_seconds = 0.0   # the host codec's whole wall time
        self.start_iter = self.start_epoch = 0
        # the step's cuDNN algorithms: deterministic (rescale_model.step_algorithms)
        self.cudnn_deterministic = True
        # train.codec_pipeline: the batch in flight and the one thread that
        # runs the host codec beside the device (see _optimize_pipelined)
        self._pipeline = bool(self.is_train and self.train_opt.get("codec_pipeline"))
        self._pending = None
        self._codec_pool = ThreadPoolExecutor(max_workers=1) if self._pipeline else None
        if self.is_train:
            to = self.train_opt
            self.optimizer, self._clear_state_steps = build_adam(self.params.parameters(), to)
            self.lr_fn = multistep_restart(
                to.get("lr_G") or 1e-4, to.get("lr_steps") or [], to.get("lr_gamma") or 0.5,
                to.get("restarts"), to.get("restart_weights"), to.get("warmup_iter") or -1)
        if self.mesh.sp > 1:
            self._check_split()
        self.load()

    def _check_split(self):
        """Raise where the width split (``mesh_sp`` > 1) does not compute
        this model's step; log the split."""
        check_supported(self.net)
        logger.info("mesh_sp %d: SelfCNetCodec's width split over %s (parallel/spatial.py)", self.mesh.sp,
                    [str(d) for d in self.mesh.devices[0]])

    def load_jax_params(self, tree):
        """Parameters in the JAX package's tree (numpy leaves): the
        ``{net, surrogate}`` tree of a training model or a bare net tree. A
        surrogate in the tree of a model without one is dropped, as the
        JAX package's ``load`` drops it at eval."""
        if "net" in tree:
            load_jax_params(self.params, {k: v for k, v in tree.items() if k in self.params})
        else:
            load_jax_params(self.net, tree)

    def load(self):
        """Load ``path.pretrain_model_G``, if it is set. A reference
        ``.pth`` holds the net's keys alone (the surrogate's are skipped); a
        msgpack checkpoint holds the ``{net[, surrogate]}`` tree, whose
        parts this model has are merged (a surrogate in the file of a model
        without one is dropped), or a bare net tree."""
        path = (self.opt.get("path") or {}).get("pretrain_model_G")
        if not path:
            return
        logger.info("Loading model for G [%s] ...", path)
        host = export_jax_params(self.params)
        if path.endswith(".pth"):
            block_num = tuple(self.net_opt.get("block_num") or (4,))
            host["net"] = ckpt.load_network(path, host["net"], "codec", block_num)
        else:
            raw = ckpt.read_msgpack(path)
            if "net" in raw:
                host = ckpt.merge(host, {k: v for k, v in raw.items() if k in host})
            else:
                host["net"] = ckpt.merge(host["net"], raw)
        load_jax_params(self.params, host)

    def save(self, iter_label):
        self.flush_pipeline()
        return ckpt.save_network(export_jax_params(self.params), self.opt["path"]["models"], iter_label)

    def save_training_state(self, epoch, it):
        """``{it}.state``: the optimizer state as the JAX package's optax
        chain keeps it, over ``{net[, surrogate]}``."""
        self.flush_pipeline()
        to = self.train_opt
        return ckpt.save_training_state(
            self.opt["path"]["training_state"], epoch, it,
            ckpt.optax_adam_state(self.optimizer, self.params.named_parameters(), to.get("gradient_clipping"),
                                  to.get("weight_decay_G")))

    def resume_training(self, state_path: str, restore_optimizer: bool = True):
        """Epoch and iteration from a ``.state`` file, and with
        ``restore_optimizer`` Adam's moments and step (``{net[,
        surrogate]}`` names)."""
        payload = ckpt.load_training_state(state_path)
        self.start_epoch = payload["epoch"]
        self.start_iter = payload["iter"]
        if restore_optimizer and self.is_train:
            ckpt.restore_adam(self.optimizer, self.params.named_parameters(), payload["opt_state"])
        return payload

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _encode(self, x):
        """HR (B,T,H,W,3) -> the latent with its LR channels quantised to
        255 levels."""
        return self._encode_net(self.net, x)

    @staticmethod
    def _encode_net(net, x):
        y, _ = net.encode(x)
        return torch.cat([quantize_ste(y[..., :3].contiguous()), y[..., 3:]], dim=-1)

    @torch.no_grad()
    def _decode(self, lr):
        hr, _ = self.net.decode(lr, generator=self.generator)
        return hr

    def _on_device(self, a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def feed_data(self, data):
        """data['GT']: numpy (B, T, H, W, 3) RGB in [0,1] (or uint8).
        Returns the clip's length. With ``mesh_sp`` > 1, W must split into
        sp shards of whole LR columns that the widest halo fits
        (``spatial.width_rule``: with the surrogate, LR shards a multiple of
        4 columns, its FeatureCollapse grid, and at least 20, its halo)."""
        gt = np.asarray(data["GT"])
        check_width(gt.shape[3], self.mesh.sp, self.net, self.surrogate)
        # kept on the host: the codec pipeline works on host numpy and moves
        # each chunk to the device itself; a training step takes it from the
        # device (uint8 cast there)
        self.real_H = np.ascontiguousarray(
            gt.astype(np.float32) / 255.0 if gt.dtype == np.uint8 else gt, np.float32)
        self._hr = frames_to_device(gt, self.device) if self.is_train else None
        return gt.shape[1]

    def test(self):
        """The streaming roundtrip through the (real or stand-in) codec.
        ``val.batch_tiles`` / ``val.overlap`` (default on) and
        ``val.seg_batch`` (default 4) shape the device calls
        (``codec/pipeline.py``). The encode call hands the host only the
        quantised LR, the part of the latent the codec takes."""
        self.flush_pipeline()
        x = self.real_H
        cards = [row[0] for row in self.mesh.devices]
        reps = Replicas()

        def encode_fn(chunk):
            if len(cards) == 1:
                return self._encode(self._on_device(chunk))[..., :3]
            t = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))
            with torch.no_grad():
                parts = [reps.apply(c, self.net, CodecModel._encode_net, p)[..., :3]
                         for c, p in zip(cards, dp_split(t, cards))]
            return dp_gather(parts, t.shape[0], self.device)

        def decode_fn(tile):
            if len(cards) == 1:
                return self._decode(self._on_device(tile))
            t = torch.from_numpy(np.ascontiguousarray(tile, np.float32))
            # the prior's noise on the master card, drawn as the one-card call draws it
            eps = None
            if self.net.fh_loss != "l2":
                eps = torch.randn(self.net.eps_shape(t.shape), generator=self.generator, device=self.device)
            with torch.no_grad():
                parts = [reps.apply(c, self.net, lambda m, l, e: m.decode(l, eps=e)[0], p,
                                    e if e is None else e.to(c))
                         for c, p, e in zip(cards, dp_split(t, cards),
                                            dp_split(eps, cards) if eps is not None else [None] * len(cards))]
            return dp_gather(parts, t.shape[0], self.device)

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
        return self._encoder(hr)

    @staticmethod
    def _lr_q(lf):
        """The host codec's input: the 255-level rounding, in fp32 whatever
        lf's type."""
        with torch.no_grad():
            return torch.round(torch.clamp(lf.float(), 0.0, 1.0) * 255.0) / 255.0

    def _host_codec(self, lr_q, q):
        """``(codec output as a host tensor, bpp, seconds)`` of the quantised
        LR (host numpy) through the host codec."""
        t0 = time.perf_counter()
        codec_np, bpp = h265_host_roundtrip(lr_q, q, self._h265_keyint, self.scale,
                                            stand_in=self._standin_codec)
        out = torch.from_numpy(codec_np)
        if self.device.type == "cuda":
            out = out.pin_memory()   # so that the copy to the card does not block the host
        return out, bpp, time.perf_counter() - t0

    def codec_span(self, lf, q):
        """The quantised LR through the host codec: ``(codec_out on the
        device, bpp)``. Without the h265 noise type the span is zeros and 0
        bpp."""
        lr_q = self._lr_q(lf)
        if self.noise_type != "h265":
            return torch.zeros_like(lr_q), 0.0
        t0 = time.perf_counter()
        codec_out, bpp, _ = self._host_codec(lr_q.cpu().numpy(), q)
        # includes the device -> host read of lr_q
        self.last_codec_host_seconds = self.last_codec_total_seconds = time.perf_counter() - t0
        return codec_out.to(self.device), bpp

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
        # the measured codec distortion (the reference logs a hard zero)
        with torch.no_grad():
            distortion = (to.get("lambda_distor_loss") or 1.0) * torch.mean(
                (codec_out - lr_q.float()) ** 2)
        return self._total(l_forw_fit, l_back_rec, mimick, distortion)

    def _total(self, l_forw_fit, l_back_rec, mimick, distortion):
        """``(loss, logs)`` from the weighted LR fit and HR reconstruction,
        the mimick loss and the measured distortion."""
        to = self.train_opt
        zero = torch.zeros((), device=l_forw_fit.device)
        mimick_term = (to.get("lambda_mimick_loss") or 1.0) * mimick
        loss = (l_forw_fit + l_back_rec + zero + mimick_term) * (to.get("loss_multiplier") or 1000.0)
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
        update (``skipped_nonfinite`` in the log). With
        ``train.codec_pipeline`` (and the h265 noise type) the call is the
        pipelined step, ``_optimize_pipelined``. The step runs under cuDNN's
        deterministic algorithms (``step_algorithms``) and repeats bit for
        bit."""
        if not self.is_train:
            raise RuntimeError("optimize_parameters needs opt['is_train']")
        with step_algorithms(self.cudnn_deterministic):
            return self._optimize(step, codec_out)

    def _optimize(self, step, codec_out):
        split = self.train_opt.get("codec_split") or "residual"
        if split not in ("residual", "reencode"):
            raise ValueError(f"train.codec_split {split!r}")
        lr_value = self.lr_fn(step)
        q = self._draw_q(step) if isinstance(self.q, list) else self.q
        if self._pipeline and self.noise_type == "h265":
            return self._optimize_pipelined(step, lr_value, q, split, codec_out)
        if self.mesh.sp > 1:
            return self._optimize_split(step, lr_value, q, split, codec_out)
        hr = self._hr
        with torch.set_grad_enabled(split == "residual"):
            lf = self._encode_lf(hr)
        if codec_out is None:
            codec_out, img_bpp = self.codec_span(lf, q)
        else:
            codec_out, img_bpp = torch.as_tensor(codec_out, dtype=torch.float32, device=self.device), 0.0
        if split == "reencode":
            lf = self._encode_lf(hr)
        self._update(step, lr_value, img_bpp, lambda: self._loss(lf, hr, self._ref(hr), codec_out, q))

    def _ref(self, hr):
        with torch.no_grad():
            return self.degrade(hr)

    # -- mesh_sp: the width split over the mesh's first row --------------
    def _optimize_split(self, step, lr_value, q, split, codec_out):
        """``_optimize`` with the width over the mesh's first row
        (``WidthSplitCodec``). The host codec takes the quantised LR
        gathered to whole frames on the host, the unsplit ``lr_q`` bit for
        bit, and its output (or the fed ``codec_out``) is sharded back.
        Under 'reencode' the encode the codec reads runs through parameter
        copies of its own, without a graph."""
        row = self.mesh.devices[0]
        xs = shard_w(self._hr, row)
        reps = Replicas()
        with torch.set_grad_enabled(split == "residual"):
            lfs = self._encode_lf_split(WidthSplitCodec(self.net, reps if split == "residual" else Replicas(),
                                                        self.device), xs)
        img_bpp = 0.0
        if codec_out is not None:
            codec_outs = shard_w(torch.as_tensor(codec_out, dtype=torch.float32), row)
        elif self.noise_type != "h265":
            codec_outs = [torch.zeros_like(self._lr_q(lf)) for lf in lfs]
        else:
            t0 = time.perf_counter()
            lr_q = gather_w([self._lr_q(lf) for lf in lfs], "cpu").numpy()
            codec_host, img_bpp, _ = self._host_codec(lr_q, q)
            self.last_codec_host_seconds = self.last_codec_total_seconds = time.perf_counter() - t0
            codec_outs = split_like(codec_host, lfs)
        split_net = WidthSplitCodec(self.net, reps, self.device)
        if split == "reencode":
            lfs = self._encode_lf_split(split_net, xs)
        self._update(step, lr_value, img_bpp, lambda: self._split_loss(split_net, xs, lfs, codec_outs, q))

    def _encode_lf_split(self, split_net, xs):
        ys, _ = split_net.encode([x.to(torch.bfloat16) for x in xs] if self._mp else xs)
        return [y[..., :3] for y in ys]

    def _split_loss(self, split_net, xs, lfs, codec_outs, q_value):
        """``_loss`` on the shards: every mean a sum over the shards
        divided by the whole batch's count."""
        to = self.train_opt
        with torch.no_grad():
            refs = degrade_shards(self.opt.get("distortion") or "sr_bd", xs, self.scale, self.degrade)
        lr_qs = [quantize_ste(lf) for lf in lfs]
        lr_dist, mimick = self._distort_lr_split(split_net, lr_qs, codec_outs, q_value)
        eps = None
        if self.net.fh_loss != "l2":
            B, T, h, _, C = lfs[0].shape
            eps = torch.randn(self.net.eps_shape((B, T, h, sum(t.shape[3] for t in lfs), C)),
                              generator=self.generator, device=self.device)
        hrs, _ = split_net.decode([t.to(lf.dtype) for t, lf in zip(lr_dist, lfs)],
                                  shard_w(eps, [t.device for t in lfs], axis=3) if eps is not None
                                  else [None] * len(lfs))
        n_lr, n_hr = sum(t.numel() for t in lfs), sum(x.numel() for x in xs)
        l_forw_fit = (to.get("lambda_fit_forw") or 1.0) * sum_to(
            [reconstruction_error(lf.float(), r, to.get("pixel_criterion_forw") or "l2")
             for lf, r in zip(lfs, refs)], self.device) / n_lr
        l_back_rec = (to.get("lambda_rec_back") or 1.0) * sum_to(
            [reconstruction_error(h.float(), x, to.get("pixel_criterion_back") or "l1")
             for h, x in zip(hrs, xs)], self.device) / n_hr
        with torch.no_grad():
            distortion = (to.get("lambda_distor_loss") or 1.0) * sum_to(
                [(c - t.float()) ** 2 for c, t in zip(codec_outs, lr_qs)], self.device) / n_lr
        return self._total(l_forw_fit, l_back_rec, mimick, distortion)

    def _distort_lr_split(self, split_net, lr_qs, codec_outs, q_value):
        """``_distort_lr`` on the shards; the ablations' noise is drawn
        whole on the master from the model's generator and sharded, the
        unsplit stream."""
        zero = torch.zeros((), device=self.device)
        if self.noise_type == "h265":
            if self.use_surrogate:
                sugs = split_net.surrogate(self.surrogate, lr_qs, q_value)
                if self.surrogate_variant == "plain":
                    return mimick_plain_shards(sugs, codec_outs, self.device)
                return mimick_and_swap_shards(sugs, codec_outs, self.net_opt.get("lambda_corr") or 0.0,
                                              self.device)
            return [t + (c - t).detach() for t, c in zip(lr_qs, codec_outs)], zero
        B, T, h, _, C = lr_qs[0].shape
        noise = draw_noise((B, T, h, sum(t.shape[3] for t in lr_qs), C), lr_qs[0].dtype, self.device,
                           self.generator, self.train_opt.get("noise_magnitude") or 1e-4, self.noise_type)
        return [t + n for t, n in zip(lr_qs, split_like(noise, lr_qs))], zero

    def _update(self, step, lr_value, img_bpp, loss_fn, snapshot=None):
        """The loss (``loss_fn()``: ``(loss, logs)``), its backward, and clip
        + Adam. ``snapshot``: the parameter copies an encode ran through
        (``_optimize_pipelined``); their gradients are added onto the live
        parameters' before the clip. The backward, the all-reduce and the
        clip are queued before the step's one read of the device (whether
        the loss is finite on every process); a loss that is not skips
        Adam's step, the moments and the count included."""
        if step in self._clear_state_steps:
            self.optimizer.state.clear()
        self.optimizer.zero_grad(set_to_none=True)
        loss, logs = loss_fn()
        loss.backward()
        if snapshot is not None:
            live = dict(self.net.named_parameters())
            pairs = [(live[name], s.grad) for name, s in snapshot.items() if s.grad is not None]
            both = [(p.grad, g) for p, g in pairs if p.grad is not None]
            if both:
                torch._foreach_add_(*map(list, zip(*both)))
            for p, g in pairs:
                if p.grad is None:
                    p.grad = g
        params = list(self.params.parameters())
        all_reduce_grads(params)
        clip = self.train_opt.get("gradient_clipping")
        if clip:
            self.grad_norm = clip_by_global_norm_(params, float(clip))
        ok = finite_everywhere(loss)
        if ok:
            for group in self.optimizer.param_groups:
                group["lr"] = lr_value
            self.optimizer.step()
        logs = {k: v.detach() for k, v in logs.items()}
        logs["skipped_nonfinite"] = torch.full_like(logs["loss"], 0.0 if ok else 1.0)
        self._raw_logs, self._raw_logs_lr, self._raw_logs_bpp = logs, lr_value, img_bpp

    # -- train.codec_pipeline ------------------------------------------
    def _optimize_pipelined(self, step, lr_value, q, split, codec_out=None):
        """The one-step-stale pipelined step (the JAX package's
        ``_optimize_pipelined``). A call encodes this batch at the live
        parameters, reads its quantised LR (the call's one read of the
        device: it waits for this encode and for the update queued by the
        call before), hands it to the host codec thread, and then retires
        the batch before it (``_retire``): it waits for that batch's codec
        output, usually ready by then, and queues its update. That update
        runs on the device while this batch is in the host codec: a step
        takes about encode + max(host codec, update) instead of their sum.
        Logs and img_bpp lag one call; ``flush_pipeline`` retires the batch
        in flight.

        Update i takes its decode side (prior, surrogate, decode) at the
        parameters after update i-1. Its encode side: under
        ``codec_split: residual`` the gradient through batch i's encode at
        the parameters it ran at, those before update i-1 (the encode runs
        through copies taken then, since Adam changes the live tensors in
        place, which autograd refuses and detaching would get wrong); under
        ``reencode`` the encode runs again at the live parameters in the
        retire. ``codec_out`` (optional) stands in for the host codec's
        output, as in the serial step.

        With ``mesh_sp`` > 1 the encode runs on the row's shards (under
        'residual' through the copies: ``Replicas(sources=...)``), the
        quantised LR is gathered whole on the host for the codec thread, and
        the batch keeps its shards and their graph until ``_retire``."""
        hr = self._hr
        shards = shard_w(hr, self.mesh.devices[0]) if self.mesh.sp > 1 else None
        snapshot = None
        if split == "residual":
            names, params = zip(*self.net.named_parameters())
            with torch.no_grad():   # x * 1 copies every value's bits, in one multi-tensor launch
                copies = torch._foreach_mul(list(params), 1.0)
            snapshot = {k: c.requires_grad_() for k, c in zip(names, copies)}
            if shards is not None:
                live = dict(self.net.named_parameters())
                reps = Replicas(sources={id(live[k]): v for k, v in snapshot.items()})
                lf = self._encode_lf_split(WidthSplitCodec(self.net, reps, self.device), shards)
            else:
                lf = torch.func.functional_call(
                    self._encoder, {f"net.{k}": v for k, v in snapshot.items()}, (hr,))
        else:
            with torch.no_grad():
                lf = (self._encode_lf(hr) if shards is None
                      else self._encode_lf_split(WidthSplitCodec(self.net, Replicas(), self.device), shards))
        if codec_out is None:
            lr_q = self._lr_q(lf) if shards is None else gather_w([self._lr_q(t) for t in lf], "cpu")
            fut = self._codec_pool.submit(self._host_codec, lr_q.cpu().numpy(), q)
        else:
            fut = self._codec_pool.submit(lambda c=torch.as_tensor(codec_out, dtype=torch.float32): (c, 0.0, 0.0))
        prev = self._pending
        self._pending = dict(step=step, lr_value=lr_value, q=q, hr=hr, shards=shards, split=split,
                             lf=lf if split == "residual" else None, snapshot=snapshot, fut=fut)
        if prev is not None:
            self._retire(prev)

    def _retire(self, p):
        """Queue the update of the pending batch ``p`` once its host codec
        output is in. With ``mesh_sp`` > 1 its loss is the split's: the
        batch's shards (and, under 'residual', its encode's graph on them)
        were kept since its call; the decode side runs on them at the live
        parameters."""
        t0 = time.perf_counter()
        codec_host, img_bpp, codec_wall = p["fut"].result()
        # the wait this step paid against the codec's whole wall time: the
        # difference is the overlap
        self.last_codec_host_seconds = time.perf_counter() - t0
        self.last_codec_total_seconds = codec_wall
        xs = p["shards"]
        if xs is not None:
            split_net = WidthSplitCodec(self.net, Replicas(), self.device)
            lfs = p["lf"] if p["split"] == "residual" else self._encode_lf_split(split_net, xs)
            codec_outs = split_like(codec_host, lfs)
            loss_fn = lambda: self._split_loss(split_net, xs, lfs, codec_outs, p["q"])  # noqa: E731
        else:
            codec_out = codec_host.to(self.device, non_blocking=True)
            lf = p["lf"] if p["split"] == "residual" else self._encode_lf(p["hr"])
            hr = p["hr"]
            loss_fn = lambda: self._loss(lf, hr, self._ref(hr), codec_out, p["q"])  # noqa: E731
        self._update(p["step"], p["lr_value"], img_bpp, loss_fn, p["snapshot"])

    def flush_pipeline(self):
        """Retire the batch in flight, if any, so that what follows (a save,
        an eval, a read of the parameters) sees its update. Nothing to do
        without ``train.codec_pipeline``."""
        p, self._pending = self._pending, None
        if p is not None:
            with step_algorithms(self.cudnn_deterministic):
                self._retire(p)

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


class _EncodeLF(nn.Module):
    """The encode half as a module's forward (HR -> LF, bf16 activations
    under mixed precision), so that ``torch.func.functional_call`` can run
    it through other parameter tensors."""

    def __init__(self, net, mixed_precision: bool):
        super().__init__()
        self.net = net
        self.mixed_precision = mixed_precision

    def forward(self, hr):
        y, _ = self.net.encode(hr.to(torch.bfloat16) if self.mixed_precision else hr)
        return y[..., :3]
