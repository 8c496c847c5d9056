"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, then drives the three main
paths at full width: it serves a synthetic 10-frame clip at the Vid4 size
through the SelfC_GMM 4x net (``RescaleModel``: feed_data -> test(gop=7),
then downscale / upscale), it trains the same net for a few steps at the
batch of the published training config (``optimize_parameters`` on 8 clips
of 7 frames, 144 x 144), and it runs the compression eval of the published
SelfC_GMM_Codec net (``CodecModel``: feed_data -> test() on a synthetic
13-frame clip at the UVG size 1080 x 1920, through the host's x265 or the
zlib stand-in), it trains that codec net with its surrogate
(``optimize_parameters`` on the published batch of 12 clips of 3 frames,
144 x 144), and it runs the codec's eval and training step again with the
de-artifact net (``network_G.deart_net``, whose deformable conv is kernel B5).
It times the kernels beside their roofline bound. Prints one JSON line per
phase; any failure exits non-zero. There is no CPU fallback: without a CUDA
device the script fails at once.

``--phases serve,train,codec,codec_train,deart`` (the default) picks the
paths; ``--phases kernels`` only builds the kernels and checks them against
their plain versions.

Last lines of the output: a ``{"kernels": [...]}`` object, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
from collections import Counter
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from selfc_tpu_torch.codec import h265
from selfc_tpu_torch.codec.pipeline import seg_add_pad
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.kernels import build
from selfc_tpu_torch.ops import deform as df
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.ops.conv import conv2d
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.train.rescale_model import RescaleModel, clip_by_global_norm_
from selfc_tpu_torch.utils.bench import (
    CLIP_HW, CODEC_DEC_SHAPE, CODEC_ENC_SHAPE, CODEC_TRAIN_LAT, CODEC_TRAIN_SHAPE, CODEC_WIDTHS,
    DEART_C, DEART_DEC_SHAPE, DEART_TRAIN_SHAPE, PATH_WIDTHS, SERVE_SHAPE, STP_DEFORM_C,
    STP_DEFORM_SHAPE, SURROGATE_C, TRAIN_SHAPE, UVG_HW, chain_bound_ms, chain_bwd_bound_ms,
    chain_feats_bound_ms, deform_bound_ms, deform_tap_stats, make_chain, make_deform, time_cuda)
from selfc_tpu_torch.utils.metrics import psnr

CHECK_WIDTHS = ((3, 48), (48, 3), (64, 64))           # coupling F/H/G and the prior
CHECK_SHAPE = (1, 3, 40, 52)     # odd sizes on purpose
BLOCK_NUM, STP_BLK_NUM = [4, 4], 6   # the full depth of the published model
FP32_LIMIT = 1e-4                # different summation order of the same fp32 products
BF16_REL_LIMIT = 3e-2            # relative to max |ref|: bf16 keeps 8 bits of mantissa
HR_LIMIT = 1e-3                  # kernel path against plain path through 16 coupling blocks
REPLACES = "selfc_tpu/ops/pallas_chain.py:386"
REPLACES_BWD = "selfc_tpu/ops/pallas_chain.py:2012"
REPLACES_FEATS = "selfc_tpu/ops/pallas_chain.py:2106"
SOURCE = "selfc_tpu_torch/csrc/dense_chain.cu"
SOURCE_BWD = "selfc_tpu_torch/csrc/dense_chain_bwd.cu"
CHAIN_C = (3, 48, 64)            # the input widths of the net's chains: the adjoint's work depends on C only
GRAD_SHAPE = (2, 3, 20, 26)      # two clips: a conv5 tap must not cross from one into the next
# dx, dW and db are sums of up to 72,576 * 9 fp32 products taken in another
# order than the plain version's, so they are compared relative to max |ref|
BWD_FP32_REL_LIMIT = 1e-4
# bf16: both sides widen to fp32 and round once at the end (8 bits of mantissa)
BWD_BF16_REL_LIMIT = 1e-2
# one chain call under autograd, kernels against autograd through the plain chain
GRAD_REL_LIMIT = 1e-4
N_TRAIN_STEPS = 3
# first train step, kernel path against plain path, same parameters and noise:
# 54 chains forward and back, each within the limits above
TRAIN_LOSS_REL_LIMIT = 1e-4
TRAIN_GRAD_L2_LIMIT = 1e-4       # the whole gradient: |g - ref|_2 / |ref|_2
# each parameter's gradient, relative to its own max |ref|; a parameter whose
# gradient is zero by construction (the bias of the attention's key projection:
# softmax does not see it) holds rounding noise only and is left out
TRAIN_GRAD_REL_LIMIT = 2e-3
TRAIN_GRAD_ZERO = 1e-6           # "zero": max |ref| below this share of the largest gradient
# Adam's first step moves an element by at most lr, whatever its gradient
TRAIN_PARAM_LIMIT = 2.0 * 1e-4
# B1 at the codec's widths: growth 12 and 24 (the kernels pad to 16 / 32
# lanes) with no epilogue, as the prior calls them; growth 32 at the
# coupling's 12->3 and 3->12 with every epilogue
GC_CHECKS = tuple((C, c_out, gc, ("none",)) for gc in (12, 24) for C, c_out in ((3, 24), (24, 24))) + (
    (12, 3, 32, tuple(dc.EP_AUX)), (3, 12, 32, tuple(dc.EP_AUX)))
CODEC_T = 13                     # frames of the synthetic UVG clip: 5 segments, 2 groups of 4
# chain launches of one test() on that clip: 2 encode calls x 4 blocks x 3
# chains; 2 decode calls x (4 blocks x 3 + the prior's 4 at growth 12)
CODEC_LAUNCHES = {"encode": {(12, 3, 32): 8, (3, 12, 32): 16},
                  "decode": {(12, 3, 32): 8, (3, 12, 32): 16, (3, 24, 12): 2, (24, 24, 12): 6}}
# kernel path against plain path through 4 coupling blocks (+ the prior)
CODEC_LIMIT = 1e-3
REPLACES_SPATIAL = "selfc_tpu/ops/pallas_chain.py:192"
# B2 and B3 below growth 32: (C, gc) at an odd shape, and the codec prior's
# chains at the codec's training latent
GC_BWD_CHECKS = tuple((C, gc, CHECK_SHAPE) for gc in (12, 24) for C in (3, 24)) + tuple(
    (C, 12, CODEC_TRAIN_LAT) for C in (3, 24))
# the v1 spatial chain: forward within this of its plain version (abs), its
# gradient within this of max |ref| (the adjoint's limit)
SPATIAL_LIMIT = 1e-4
N_CODEC_STEPS = 3
# chain calls of one codec training step, each way: the encode's 4 blocks x 3
# coupling chains, the decode's 12 and the prior's 4 at growth 12 (one 3->24,
# three 24->24); the surrogate's 4 v1 spatial chains
CODEC_TRAIN_FWD = {(12, 3, 32): 8, (3, 12, 32): 16, (3, 24, 12): 1, (24, 24, 12): 3}
CODEC_TRAIN_SPATIAL = {(4, 32): 1, (24, 32): 3}
# B5, the modulated deformable conv
SOURCE_DEFORM = "selfc_tpu_torch/csrc/deform.cu"
REPLACES_DEFORM = "selfc_tpu/ops/deform.py:177"
# (shape, C, Cout) of the checks: odd sizes, the JAX package's kernel test,
# the de-artifact net's training and decode calls, the STP prior's
DEFORM_CHECKS = (((2, 13, 21), 5, 3), ((2, 12, 16), 8, 8), (DEART_TRAIN_SHAPE, DEART_C, DEART_C),
                 (DEART_DEC_SHAPE, DEART_C, DEART_C), (STP_DEFORM_SHAPE, STP_DEFORM_C, STP_DEFORM_C))
DEFORM_SPREAD = 7.0              # px: the checks' offsets, so that taps leave the frame
DEART_OFFSET_STD = 2.0           # px: the de-artifact net's seeded offsets are scaled to this spread
# launches of the de-artifact net: B5 9 a decode call (3 output frames x 3
# pairs), so 18 a test() and 9 each way a training step; B1 one 3->32 and one
# 32->3 chain a decode call
DEART_B5_TEST, DEART_B5_STEP = 18, 9
DEART_B1_DECODE = {(3, 32, 32): 1, (32, 3, 32): 1}
ALL_PHASES = ("serve", "train", "codec", "codec_train", "deart")


def check(ok, what):
    """Fail the run (also under ``python -O``, where asserts vanish)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


_T0 = time.time()


def emit(phase, **kw):
    """One phase's JSON line, with the script's wall seconds when it ended."""
    print(json.dumps({"phase": phase, **kw, "at_s": time.time() - _T0}), flush=True)


def library_chain(x, ws, bs, w5, b5, a=None, m=None):
    """The same chain (mul_add epilogue, or none without ``a``) through
    PyTorch's library convolutions on NCDHW tensors: the yardstick, never
    called by the port."""
    feats = x
    for w, b in zip(ws, bs):
        feats = torch.cat([feats, F.leaky_relu(F.conv3d(feats, w, b, padding=(0, 1, 1)), 0.2)], 1)
    y5 = F.conv3d(feats, w5, b5, padding=(1, 0, 0))
    return y5 if a is None else a * m + y5


def to_library_layout(x, ws, bs, w5, b5, a, m):
    ncdhw = lambda t: t.permute(0, 4, 1, 2, 3).contiguous()  # noqa: E731
    return (ncdhw(x), [w.permute(3, 2, 0, 1)[:, :, None].contiguous() for w in ws], bs,
            w5.permute(2, 1, 0)[..., None, None].contiguous(), b5,
            *(None if t is None else ncdhw(t) for t in (a, m)))


@contextlib.contextmanager
def plain_chain_on_card():
    """Route the models' kernel calls (the whole chain, the v1 spatial chain
    and the deformable conv) to the plain versions, for comparison."""
    kernels = dc.dense_chain_t_ep, dc.fused_dense_spatial, df.deform_conv2d
    dc.dense_chain_t_ep = lambda *a, save_feats=True, **kw: dc.dense_chain_t_ep_plain(*a, **kw)
    dc.fused_dense_spatial = dc.fused_dense_spatial_plain
    df.deform_conv2d = df.deform_conv2d_plain
    try:
        yield
    finally:
        dc.dense_chain_t_ep, dc.fused_dense_spatial, df.deform_conv2d = kernels


def seeded_tree(net, seed):
    """Random parameters from a numpy seed, every conv non-zero. conv5 of
    the coupling subnets is scaled down so the latents stay of order one
    through eight blocks."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in net.named_parameters():
        if p.dim() == 1:
            std = 0.05
        else:
            std = float(np.prod(p.shape[:-1])) ** -0.5
            if name.startswith("inv_blocks") and ".conv5." in name:
                std *= 0.25
        tree[name] = rng.normal(0, std, tuple(p.shape)).astype(np.float32)
    return tree


def phase_kernels(device):
    rng = np.random.default_rng(0)
    worst = {w: 0.0 for w in PATH_WIDTHS}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for C, c_out in CHECK_WIDTHS:
            for mode, n_aux in dc.EP_AUX.items():
                x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, CHECK_SHAPE, device, dtype)
                aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
                got = dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
                want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                if dtype == torch.float32:
                    ok = err <= FP32_LIMIT
                    worst[(C, c_out)] = max(worst[(C, c_out)], err)
                else:
                    ok = err <= BF16_REL_LIMIT * ref
                cases.append({"dtype": str(dtype).split(".")[-1], "C": C, "c_out": c_out,
                              "mode": mode, "max_abs_err": err, "max_abs_ref": ref, "ok": ok})
                check(ok and np.isfinite(err), f"kernel agrees with its plain version: {cases[-1]}")
    # on a CUDA tensor the wrapper launches or raises: it never takes the plain version
    x, ws, bs, w5, b5, a, m = make_chain(rng, 48, 3, CHECK_SHAPE, device)
    wide = make_chain(rng, 48, 3, CHECK_SHAPE, device, gc=48)
    before = (dc.launches, dc.launches_feats, dc.launches_bwd)
    refused = []
    for fault, error, kw in (
        ("strided a", ValueError, dict(a=torch.cat([a, a], -1)[..., :3], m=m)),
        ("float64 x", TypeError, dict(x=x.double(), a=a, m=m)),
        ("growth width 48", ValueError, dict(ws=wide[1], bs=wide[2], w5=wide[3], a=a, m=m)),
    ):
        try:
            dc.dense_chain_t_ep(kw.get("x", x), kw.get("ws", ws), kw.get("bs", bs), kw.get("w5", w5),
                                b5, "mul_add", 1.0, kw["a"], kw["m"])
        except error:
            refused.append(fault)
    # the adjoint takes the kernels' feats layout (16-lane segments at
    # growth 12), not the plain version's
    x12, ws12, bs12, *_ = make_chain(rng, 24, 24, CHECK_SHAPE, device, gc=12)
    feats12 = dc.chain_feats_plain(x12, ws12, bs12)
    try:
        dc.chain_spatial_bwd(x12, ws12, bs12, feats12, feats12)
    except ValueError:
        refused.append("adjoint given growth-12 features in the plain layout")
    check(len(refused) == 4 and (dc.launches, dc.launches_feats, dc.launches_bwd) == before,
          f"the wrappers refuse bad CUDA arguments: {refused}")
    emit("kernels", kernels=["dense_chain_t_ep"], shape=CHECK_SHAPE, n_cases=len(cases), refused=refused,
         fp32_limit=FP32_LIMIT, bf16_rel_limit=BF16_REL_LIMIT, cases=cases)
    return worst


NETWORK_G = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": BLOCK_NUM,
             "scale": 4, "init": "xavier", "global_module": "nonlocal",
             "stp_blk_num": STP_BLK_NUM, "fh_loss": "gmm", "gmm_k": 5}


def serve_options(**val):
    return dict_to_nonedict({"model": "SelfC_GMM", "scale": 4, "val": val, "network_G": NETWORK_G})


def train_options(**train):
    """The options of the published training config
    (selfc_tpu/configs/train/train_rescaling_selfc_large.yml), built here."""
    return dict_to_nonedict({
        "model": "SelfC_GMM", "scale": 4, "distortion": "sr_bd", "is_train": True,
        "datasets": {"train": {"video_len": 7, "batch_size": 8, "GT_size": 144}},
        "network_G": NETWORK_G,
        "train": {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "warmup_iter": -1,
                  "lr_scheme": "MultiStepLR", "lr_steps": [100000, 200000, 300000], "lr_gamma": 0.5,
                  "pixel_criterion_forw": "l2", "pixel_criterion_back": "l1",
                  "lambda_cond_prob": 0, "lambda_fit_forw": 1, "lambda_rec_back": 1,
                  "weight_decay_G": 1e-14, "gradient_clipping": 10, **train},
    })


def phase_roundtrip(device):
    """Full-width serve of two GOP requests, then one downscale and one
    upscale request; the launch counts of exactly these calls are kept."""
    rng = np.random.default_rng(1)
    # a smooth synthetic clip in [0,1]: low-frequency pattern plus noise
    yy, xx = np.meshgrid(np.linspace(0, 1, CLIP_HW[0]), np.linspace(0, 1, CLIP_HW[1]), indexing="ij")
    frames = [0.5 + 0.3 * np.sin(6 * xx + 0.3 * t)[..., None] * np.cos(4 * yy + 0.2 * t)[..., None]
              * np.array([1.0, 0.8, 0.6]) for t in range(10)]
    clip = np.clip(np.stack(frames)[None] + rng.normal(0, 0.02, (1, 10, *CLIP_HW, 3)), 0, 1)
    clip = clip.astype(np.float32)

    model = RescaleModel(serve_options(), device=device, rng_seed=0)
    tree = seeded_tree(model.net, 2)
    model.load_jax_params(tree)
    n_params = sum(p.numel() for p in model.net.parameters())

    # ---- the main path: counts set to 0 just before, read just after ----
    dc.reset_launch_counts()
    model.generator.manual_seed(5)
    t0 = time.time()
    check(model.feed_data({"GT": clip}) == 10, "feed_data returns the clip length")
    model.test(gop=7)
    n_test = dc.launches
    lr_k = model.downscale(clip[:, :7])
    n_down = dc.launches - n_test
    model.generator.manual_seed(6)
    hr_k = model.upscale(lr_k)
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    n_up = dc.launches - n_test - n_down
    counts = {"total": dc.launches, "by_width": dict(dc.launches_by_width)}
    # ---------------------------------------------------------------------

    vis = model.get_current_visuals()
    sr_k, lrs_k = vis["SR"], vis["LR"]
    lat = SERVE_SHAPE[2:]
    check(sr_k.shape == clip.shape, f"SR shape {sr_k.shape}")
    check(lrs_k.shape == (1, 10, *lat, 3), f"LR shape {lrs_k.shape}")
    check(vis["forw_H"].shape == (1, 10, *lat, 48), "forw_H shape")
    check(lr_k.shape == (1, 7, *lat, 3) and hr_k.shape == (1, 7, *CLIP_HW, 3),
          "downscale / upscale shapes")
    for name, arr in (("SR", sr_k), ("LR", lrs_k), ("forw_H", vis["forw_H"]),
                      ("downscale", lr_k), ("upscale", hr_k)):
        check(np.isfinite(arr).all(), f"{name} is finite")
    # two GOPs fold into one encode (3 chains a block) and one decode
    # (the prior's chains + 3 a block)
    n_enc = 3 * sum(BLOCK_NUM)
    n_dec = STP_BLK_NUM + n_enc
    check((n_test, n_down, n_up) == (n_enc + n_dec, n_enc, n_dec),
          f"chain calls of test/downscale/upscale: {(n_test, n_down, n_up)}")
    check(np.abs(lrs_k * 255 - np.round(lrs_k * 255)).max() < 1e-3, "LR lies on 255 levels")

    # the same requests through the plain version of the chain, on the card
    with plain_chain_on_card():
        before = dc.launches
        model.generator.manual_seed(5)
        model.test(gop=7)
        sr_p = model.get_current_visuals()["SR"]
        lr_p = model.downscale(clip[:, :7])
        model.generator.manual_seed(6)
        hr_p = model.upscale(lr_k)  # the same LR and the same eps as the kernel path
        check(dc.launches == before, "the plain path launches no kernel")
    lr_levels_differ = float(np.mean(np.abs(lr_k - lr_p) > 1e-6))
    lr_max = float(np.abs(lr_k - lr_p).max())
    hr_err = float(np.abs(hr_k - hr_p).max())
    # a latent within ~1e-6 of a rounding boundary may land on the other
    # level; more than that, or more than one level, is a fault
    check(lr_levels_differ < 1e-3 and lr_max < 1.01 / 255,
          f"downscale: kernel path vs plain path {(lr_levels_differ, lr_max)}")
    check(hr_err <= HR_LIMIT, f"upscale: kernel path within {HR_LIMIT} of plain path, got {hr_err}")
    flat = lambda v: torch.from_numpy(v).reshape(-1, *v.shape[2:])  # noqa: E731
    emit("roundtrip", clip=clip.shape, n_params=n_params, serve_s=serve_s,
         launches={"test": n_test, "downscale": n_down, "upscale": n_up},
         hr_max_abs_err_kernel_vs_plain=hr_err, hr_limit=HR_LIMIT,
         lr_levels_differ=lr_levels_differ,
         psnr_hr_vs_input=psnr(flat(sr_k), flat(clip)).mean().item(),
         psnr_upscale_kernel_vs_plain=psnr(flat(hr_k), flat(hr_p)).mean().item(),
         psnr_test_kernel_vs_plain=psnr(flat(sr_k), flat(sr_p)).mean().item())

    # bf16 serving mode (val.eval_dtype): runs and stays finite
    bf = RescaleModel(serve_options(eval_dtype="bfloat16"), device=device, rng_seed=0)
    bf.load_jax_params(tree)
    bf.generator.manual_seed(5)
    bf.feed_data({"GT": clip})
    bf.test(gop=7)
    sr_bf = bf.get_current_visuals()["SR"]
    check(np.isfinite(sr_bf).all(), "bf16 SR is finite")
    emit("roundtrip_bf16", psnr_bf16_vs_fp32=psnr(flat(sr_bf), flat(sr_k)).mean().item())
    return model, counts


def chain_error(args, mode):
    """Max abs difference of the kernel and its plain version on one input."""
    x, ws, bs, w5, b5, a, m = args
    n_aux = dc.EP_AUX[mode]
    aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
    got = dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
    want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
    return (got.float() - want.float()).abs().max().item()


def phase_timing(device, model, counts, worst):
    rng = np.random.default_rng(3)
    kernels, bf16, serve_cases = [], [], []
    for C, c_out in PATH_WIDTHS:
        # every epilogue at the shapes the main path calls with: one GOP
        # (downscale / upscale) and two GOPs folded into the batch (test)
        err = worst[(C, c_out)]
        for B in (2, 1):
            args = make_chain(rng, C, c_out, (B,) + SERVE_SHAPE[1:], device)
            for mode in dc.EP_AUX:
                e = chain_error(args, mode)
                serve_cases.append({"B": B, "C": C, "c_out": c_out, "mode": mode, "max_abs_err": e})
                check(e <= FP32_LIMIT, f"kernel vs plain at the serving shape: {serve_cases[-1]}")
                err = max(err, e)
        x, ws, bs, w5, b5, a, m = args   # B = 1: the shape that is timed
        lib_args = to_library_layout(*args)
        lib = library_chain(*lib_args).permute(0, 2, 3, 4, 1)
        want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "mul_add", 1.0, a, m)
        check((lib - want).abs().max().item() <= 1e-3, "library chain computes the same function")
        del want, lib
        ms = time_cuda(lambda: dc.dense_chain_t_ep(x, ws, bs, w5, b5, "mul_add", 1.0, a, m))
        plain = time_cuda(lambda: dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "mul_add", 1.0, a, m))
        library = time_cuda(lambda: library_chain(*lib_args))
        bound, by = chain_bound_ms(*SERVE_SHAPE, C, c_out, 2)
        kernels.append({
            "name": f"dense_chain_t_ep[{C}->{c_out}]", "route": "cuda",
            "source": "selfc_tpu_torch/csrc/dense_chain.cu", "replaces": REPLACES,
            "launches": counts["by_width"].get((C, c_out, 32), 0),
            "max_abs_err": err, "ms": ms["median"], "plain_ms": plain["median"],
            "bound_ms": bound, "bound_by": by, "library_ms": library["median"],
            "ms_min": ms["min"], "plain_ms_min": plain["min"], "library_ms_min": library["min"],
            "shape": list(SERVE_SHAPE) + [C], "mode": "mul_add",
        })
        hx, hws, hbs, hw5, hb5, ha, hm = [
            [t.bfloat16() for t in v] if isinstance(v, list) else v.bfloat16() for v in args]
        ms16 = time_cuda(lambda: dc.dense_chain_t_ep(hx, hws, hbs, hw5, hb5, "mul_add", 1.0, ha, hm))
        pl16 = time_cuda(lambda: dc.dense_chain_t_ep_plain(hx, hws, hbs, hw5, hb5, "mul_add", 1.0, ha, hm))
        b16, by16 = chain_bound_ms(*SERVE_SHAPE, C, c_out, 2, torch.bfloat16)
        bf16.append({"C": C, "c_out": c_out, "ms": ms16["median"], "ms_min": ms16["min"],
                     "plain_ms": pl16["median"], "plain_ms_min": pl16["min"],
                     "bound_ms": b16, "bound_by": by16})
    emit("kernels_serving_shape", shape=SERVE_SHAPE, n_cases=len(serve_cases),
         fp32_limit=FP32_LIMIT, cases=serve_cases)
    emit("timing_chain_bf16", shape=SERVE_SHAPE, chains=bf16)

    # one GOP roundtrip (encode -> quantize -> prior -> sample -> decode) on the card
    gop = torch.rand((1, 7, *CLIP_HW, 3), device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    eps = torch.randn(model.net.eps_shape(SERVE_SHAPE + (3,)), device=device,
                      generator=torch.Generator(device=device).manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        rt = time_cuda(lambda: model.net.roundtrip(gop, eps=eps), iters=10, warmup=2)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        with plain_chain_on_card():
            rt_plain = time_cuda(lambda: model.net.roundtrip(gop, eps=eps), iters=10, warmup=2)
    # chains of one GOP roundtrip by width: H and G, F, the prior's 64->64, its 3->64
    nb = sum(BLOCK_NUM)
    per_gop = (4 * nb, 2 * nb, STP_BLK_NUM - 1, 1)
    chains_ms = sum(k["ms"] * n for k, n in zip(kernels, per_gop))
    emit("timing_roundtrip", gop_roundtrip_ms=rt["median"], gop_roundtrip_ms_min=rt["min"],
         gop_roundtrip_plain_ms=rt_plain["median"], gop_roundtrip_plain_ms_min=rt_plain["min"],
         chain_launches_per_gop=sum(per_gop), chains_ms_per_gop=chains_ms,
         frames_per_s=7e3 / rt["median"], peak_device_memory_gib=peak_gib)
    return kernels


def rel_err(got, want):
    """max |got - want| relative to max |want|, in fp32."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def phase_kernels_bwd(device):
    """The spatial-only forward and the chain adjoint against their plain
    versions, at an odd shape and at the training shape."""
    rng = np.random.default_rng(10)
    cases, worst = [], {"feats": {C: 0.0 for C in CHAIN_C}, "bwd": {C: 0.0 for C in CHAIN_C}}
    for shape in (CHECK_SHAPE, TRAIN_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            fp32 = dtype == torch.float32
            for C in CHAIN_C:
                x, ws, bs, *_ = make_chain(rng, C, 3, shape, device, dtype)
                want_f = dc.chain_feats_plain(x, ws, bs)
                got_f = dc.chain_feats(x, ws, bs)
                e_f = (got_f.float() - want_f.float()).abs().max().item()
                ok = e_f <= (FP32_LIMIT if fp32 else BF16_REL_LIMIT * want_f.float().abs().max().item())
                # some saved outputs of exactly 0: they take the 0.2 slope on both sides
                feats = want_f.clone()
                feats[torch.from_numpy(rng.random(feats.shape) < 0.02).to(device)] = 0
                g = torch.from_numpy(rng.normal(0, 1, feats.shape).astype(np.float32)).to(device, dtype)
                dx0 = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32)).to(device)
                want = dc.chain_spatial_bwd_plain(x, ws, bs, feats, g, dx0)
                got = dc.chain_spatial_bwd(x, ws, bs, feats, g, dx0)
                again = dc.chain_spatial_bwd(x, ws, bs, feats, g, dx0)
                torch.cuda.synchronize()
                flat = lambda r: [r[0], *r[1], *r[2]]  # noqa: E731
                e_dx, *e_p = [rel_err(u, v) for u, v in zip(flat(got), flat(want))]
                same_bits = all(torch.equal(u, v) for u, v in zip(flat(got), flat(again)))
                limit = BWD_FP32_REL_LIMIT if fp32 else BWD_BF16_REL_LIMIT
                ok = ok and max(e_dx, *e_p) <= limit and same_bits
                if fp32:
                    worst["feats"][C] = max(worst["feats"][C], e_f)
                    worst["bwd"][C] = max(worst["bwd"][C], (got[0] - want[0]).abs().max().item())
                cases.append({"shape": shape, "dtype": str(dtype).split(".")[-1], "C": C,
                              "feats_max_abs_err": e_f, "dx_rel_err": e_dx, "dw_db_rel_err": max(e_p),
                              "same_bits_twice": same_bits, "ok": ok})
                check(ok and np.isfinite(e_f + e_dx + max(e_p)),
                      f"backward kernels agree with their plain versions: {cases[-1]}")
    emit("kernels_bwd", kernels=["chain_feats", "chain_spatial_bwd"], n_cases=len(cases),
         fp32_limit=FP32_LIMIT, bf16_rel_limit=BF16_REL_LIMIT, bwd_fp32_rel_limit=BWD_FP32_REL_LIMIT,
         bwd_bf16_rel_limit=BWD_BF16_REL_LIMIT, cases=cases)
    return worst


def phase_grad(device):
    """``dense_chain_t_ep`` under autograd on the card (kernels forward and
    backward) against autograd through the plain chain: every epilogue,
    gradients of x, the ten parameters, a and m; saved features and
    recomputed features give the same bits."""
    rng = np.random.default_rng(11)
    cases = []
    for C, c_out in CHECK_WIDTHS:
        for mode, n_aux in dc.EP_AUX.items():
            x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, GRAD_SHAPE, device)
            leaves = [x, *ws, *bs, w5, b5, *(a, m)[:n_aux]]
            for t in leaves:
                t.requires_grad_(True)
            aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
            gout = torch.from_numpy(rng.normal(0, 1, GRAD_SHAPE + (c_out,)).astype(np.float32)).to(device)
            want = torch.autograd.grad(
                dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm), leaves, gout)
            before = (dc.launches, dc.launches_bwd, dc.launches_feats)
            got = torch.autograd.grad(
                dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 0.8, aa, mm), leaves, gout)
            mid = (dc.launches, dc.launches_bwd, dc.launches_feats)
            got_nf = torch.autograd.grad(
                dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 0.8, aa, mm, save_feats=False), leaves, gout)
            after = (dc.launches, dc.launches_bwd, dc.launches_feats)
            torch.cuda.synchronize()
            errs = [rel_err(u, v) for u, v in zip(got, want)]
            same = all(torch.equal(u, v) for u, v in zip(got, got_nf))
            counted = (tuple(np.subtract(mid, before)) == (1, 1, 0)
                       and tuple(np.subtract(after, mid)) == (1, 1, 1))
            cases.append({"C": C, "c_out": c_out, "mode": mode, "max_rel_err": max(errs),
                          "saved_equals_recomputed": same, "launches_counted": counted})
            check(max(errs) <= GRAD_REL_LIMIT and same and counted,
                  f"chain gradient on the card against autograd through the plain chain: {cases[-1]}")
    emit("grad", shape=GRAD_SHAPE, n_cases=len(cases), rel_limit=GRAD_REL_LIMIT, cases=cases)


def train_batch(seed=20):
    """A smooth synthetic batch in [0,1] of the training config's shape."""
    rng = np.random.default_rng(seed)
    B, T, S = TRAIN_SHAPE[0], TRAIN_SHAPE[1], 4 * TRAIN_SHAPE[2]
    yy, xx = np.meshgrid(np.linspace(0, 1, S), np.linspace(0, 1, S), indexing="ij")
    ph = rng.uniform(0, 6, (B, 1, 1, 1, 3))
    t = np.arange(T).reshape(1, T, 1, 1, 1)
    base = 0.5 + 0.3 * np.sin(7 * xx[None, None, :, :, None] + 0.3 * t + ph) * np.cos(5 * yy[None, None, :, :, None] + ph)
    return np.clip(base + rng.normal(0, 0.02, (B, T, S, S, 3)), 0, 1).astype(np.float32)


def new_trainer(device, tree, batch, **train):
    model = RescaleModel(train_options(**train), device=device, rng_seed=0)
    model.load_jax_params(tree)
    check(model.feed_data({"GT": batch}) == TRAIN_SHAPE[1], "feed_data returns the clip length")
    return model


def grads_of(model):
    return {k: p.grad.detach().clone() for k, p in model.net.named_parameters()}


def params_of(model):
    return {k: p.detach().clone() for k, p in model.net.named_parameters()}


def phase_train(device):
    """Three training steps of the full-width net at the published batch,
    then one step with ``save_chain_feats: false``; the launch counts of
    exactly these four steps are kept."""
    batch = train_batch()
    rng = np.random.default_rng(21)
    lat = TRAIN_SHAPE + (3,)
    n_chain = 6 * sum(BLOCK_NUM) + STP_BLK_NUM   # 3 a block each way, and the prior's
    probe = RescaleModel(train_options(), device=device, rng_seed=0)
    tree = seeded_tree(probe.net, 2)
    eps = [rng.normal(0, 1, probe.net.eps_shape(lat)).astype(np.float32) for _ in range(N_TRAIN_STEPS)]
    del probe
    model = new_trainer(device, tree, batch)
    start = params_of(model)

    # ---- the main path: counts set to 0 just before, read just after ----
    dc.reset_launch_counts()
    logs, per_step, seen = [], [], (0, 0, 0)
    t0 = time.time()
    for step in range(N_TRAIN_STEPS):
        model.optimize_parameters(step, eps=eps[step])
        logs.append(dict(model.get_current_log()))
        now = (dc.launches, dc.launches_bwd, dc.launches_feats)
        per_step.append(tuple(int(v) for v in np.subtract(now, seen)))
        seen = now
        if step == 0:
            after_1, grads_1, norm_1 = params_of(model), grads_of(model), float(model.grad_norm)
    recompute = new_trainer(device, tree, batch, save_chain_feats=False)
    recompute.optimize_parameters(0, eps=eps[0])
    log_r, norm_r = dict(recompute.get_current_log()), float(recompute.grad_norm)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    now = (dc.launches, dc.launches_bwd, dc.launches_feats)
    per_step.append(tuple(int(v) for v in np.subtract(now, seen)))
    counts = {"forward": dict(dc.launches_by_width), "backward": dict(dc.launches_bwd_by_width),
              "feats": dict(dc.launches_feats_by_width)}
    # ---------------------------------------------------------------------

    check(per_step == [(n_chain, n_chain, 0)] * N_TRAIN_STEPS + [(n_chain, n_chain, n_chain)],
          f"chain launches (forward, backward, feats) of each step: {per_step}")
    for lg in logs + [log_r]:
        check(all(np.isfinite(v) for v in lg.values()) and lg["skipped_nonfinite"] == 0.0,
              f"the step's losses are finite and it was not skipped: {lg}")
    unchanged = [k for k, p in model.net.named_parameters() if torch.equal(p.detach(), start[k])]
    check(not unchanged, f"every parameter changed: {unchanged[:5]}")
    # recomputed features: the same forward, and a backward on the same bits
    check(log_r["loss"] == logs[0]["loss"] and abs(norm_r - norm_1) <= 1e-6 * norm_1,
          f"save_chain_feats false gives the same loss and gradient norm: {(log_r['loss'], logs[0]['loss'], norm_r, norm_1)}")

    # the same first step through the plain chain, on the card
    plain = new_trainer(device, tree, batch)
    with plain_chain_on_card():
        before = (dc.launches, dc.launches_bwd, dc.launches_feats)
        plain.optimize_parameters(0, eps=eps[0])
        check((dc.launches, dc.launches_bwd, dc.launches_feats) == before, "the plain path launches no kernel")
    log_p, grads_p, after_p = dict(plain.get_current_log()), grads_of(plain), params_of(plain)
    loss_rel = abs(logs[0]["loss"] - log_p["loss"]) / abs(log_p["loss"])
    top = max(g.abs().max().item() for g in grads_p.values())
    live = [k for k, g in grads_p.items() if g.abs().max().item() >= TRAIN_GRAD_ZERO * top]
    grad_rel = max(rel_err(grads_1[k], grads_p[k]) for k in live)
    grad_l2 = (sum((grads_1[k] - g).pow(2).sum().item() for k, g in grads_p.items())
               / sum(g.pow(2).sum().item() for g in grads_p.values())) ** 0.5
    param_err = max((after_1[k] - after_p[k]).abs().max().item() for k in after_p)
    moved = sum(((after_1[k] - after_p[k]).abs() > 1e-5).sum().item() for k in after_p)
    n_params = sum(p.numel() for p in after_p.values())
    check(loss_rel <= TRAIN_LOSS_REL_LIMIT, f"first step's loss, kernel path vs plain path: {loss_rel}")
    check(grad_l2 <= TRAIN_GRAD_L2_LIMIT and grad_rel <= TRAIN_GRAD_REL_LIMIT,
          f"first step's gradients, kernel path vs plain path: {(grad_l2, grad_rel)}")
    check(param_err <= TRAIN_PARAM_LIMIT, f"parameters after the first step, kernel path vs plain path: {param_err}")
    n_zero = len(grads_p) - len(live)
    del plain, grads_p

    # the first step again from the same parameters and noise: the same bits
    again = new_trainer(device, tree, batch)
    again.optimize_parameters(0, eps=eps[0])
    differ = [k for k, p in again.net.named_parameters() if not torch.equal(p.detach(), after_1[k])]
    check(not differ, f"a repeated first step gives bit-identical parameters: {differ[:5]}")

    emit("train", batch=batch.shape, n_params=n_params, steps=N_TRAIN_STEPS, train_s=train_s,
         launches_per_step=per_step, logs=logs, grad_norm_step0=norm_1,
         loss_rel_err_kernel_vs_plain=loss_rel, loss_rel_limit=TRAIN_LOSS_REL_LIMIT,
         grad_l2_rel_err_kernel_vs_plain=grad_l2, grad_l2_limit=TRAIN_GRAD_L2_LIMIT,
         grad_max_rel_err_kernel_vs_plain=grad_rel, grad_rel_limit=TRAIN_GRAD_REL_LIMIT,
         grads_compared=len(live), grads_zero_by_construction=n_zero,
         param_max_abs_err_kernel_vs_plain=param_err, param_limit=TRAIN_PARAM_LIMIT,
         params_differing_by_over_1e_5=moved, repeat_bit_identical=True,
         recompute_same_loss=True, recompute_grad_norm=norm_r)
    return model, recompute, counts, eps[0]


def library_feats(x, ws, bs):
    """[x1 | .. | x4] through PyTorch's library convolutions on NCDHW
    tensors: the yardstick, never called by the port."""
    feats = x
    for w, b in zip(ws, bs):
        feats = torch.cat([feats, F.leaky_relu(F.conv3d(feats, w, b, padding=(0, 1, 1)), 0.2)], 1)
    return feats[:, x.shape[1]:]


def phase_timing_train(device, model, recompute, counts, worst, eps):
    rng = np.random.default_rng(22)
    kernels = []
    for C, c_out in PATH_WIDTHS:   # the forward chain at the training shape
        args = make_chain(rng, C, c_out, TRAIN_SHAPE, device)
        x, ws, bs, w5, b5, a, m = args
        err = max(chain_error(args, mode) for mode in dc.EP_AUX)
        check(err <= FP32_LIMIT, f"kernel vs plain at the training shape: {(C, c_out, err)}")
        lib_args = to_library_layout(*args)
        ms = time_cuda(lambda: dc.dense_chain_t_ep(x, ws, bs, w5, b5, "mul_add", 1.0, a, m))
        plain = time_cuda(lambda: dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "mul_add", 1.0, a, m))
        library = time_cuda(lambda: library_chain(*lib_args))
        bound, by = chain_bound_ms(*TRAIN_SHAPE, C, c_out, 2)
        kernels.append({
            "name": f"dense_chain_t_ep[{C}->{c_out}]@train", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": counts["forward"].get((C, c_out, 32), 0),
            "max_abs_err": err, "ms": ms["median"], "plain_ms": plain["median"],
            "bound_ms": bound, "bound_by": by, "library_ms": library["median"],
            "ms_min": ms["min"], "plain_ms_min": plain["min"], "library_ms_min": library["min"],
            "shape": list(TRAIN_SHAPE) + [C], "mode": "mul_add"})
    for C in CHAIN_C:              # the adjoint and the spatial-only forward
        x, ws, bs, *_ = make_chain(rng, C, 3, TRAIN_SHAPE, device)
        feats = dc.chain_feats(x, ws, bs)
        g = torch.from_numpy(rng.normal(0, 1, feats.shape).astype(np.float32)).to(device)
        # the library's copies, in its layout, as leaves of a graph of their own
        leaves = [x.permute(0, 4, 1, 2, 3).contiguous(),
                  *(w.permute(3, 2, 0, 1)[:, :, None].contiguous() for w in ws), *(b.clone() for b in bs)]
        for t in leaves:
            t.requires_grad_(True)
        lx, lws, lbs = leaves[0], leaves[1:5], leaves[5:]
        lg = g.permute(0, 4, 1, 2, 3).contiguous()
        lfeats = library_feats(lx, lws, lbs)
        check((lfeats.detach().permute(0, 2, 3, 4, 1) - feats).abs().max().item() <= 1e-3,
              "library spatial chain computes the same function")
        with torch.no_grad():
            f_ms = time_cuda(lambda: dc.chain_feats(x, ws, bs))
            f_plain = time_cuda(lambda: dc.chain_feats_plain(x, ws, bs))
            f_lib = time_cuda(lambda: library_feats(lx, lws, lbs))
        f_bound, f_by = chain_feats_bound_ms(*TRAIN_SHAPE, C)
        kernels.append({
            "name": f"chain_feats[{C}]@train", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES_FEATS, "launches": counts["feats"].get((C, 32), 0),
            "max_abs_err": worst["feats"][C], "ms": f_ms["median"], "plain_ms": f_plain["median"],
            "bound_ms": f_bound, "bound_by": f_by, "library_ms": f_lib["median"],
            "ms_min": f_ms["min"], "plain_ms_min": f_plain["min"], "library_ms_min": f_lib["min"],
            "shape": list(TRAIN_SHAPE) + [C]})
        b_ms = time_cuda(lambda: dc.chain_spatial_bwd(x, ws, bs, feats, g))
        b_plain = time_cuda(lambda: dc.chain_spatial_bwd_plain(x, ws, bs, feats, g))
        b_lib = time_cuda(lambda: torch.autograd.grad(lfeats, leaves, lg, retain_graph=True))
        b_bound, b_by = chain_bwd_bound_ms(*TRAIN_SHAPE, C)
        kernels.append({
            "name": f"chain_spatial_bwd[{C}]@train", "route": "cuda", "source": SOURCE_BWD,
            "replaces": REPLACES_BWD, "launches": counts["backward"].get((C, 32), 0),
            "max_abs_err": worst["bwd"][C], "ms": b_ms["median"], "plain_ms": b_plain["median"],
            "bound_ms": b_bound, "bound_by": b_by, "library_ms": b_lib["median"],
            "ms_min": b_ms["min"], "plain_ms_min": b_plain["min"], "library_ms_min": b_lib["min"],
            "shape": list(TRAIN_SHAPE) + [C]})
        del lfeats

    # one whole step, and its three parts (forward with the losses, backward,
    # clip + Adam), each between CUDA events
    def step_of(mdl):
        return lambda: mdl.optimize_parameters(N_TRAIN_STEPS, eps=eps)

    def parts(mdl):
        hr = mdl.real_H
        eps_t = torch.as_tensor(eps, device=device)
        with torch.no_grad():
            ref_l = mdl.degrade(hr)
        held = {}

        def fwd():
            mdl.optimizer.zero_grad(set_to_none=True)
            held["loss"] = mdl._pixel_losses(hr, ref_l, eps_t)[0]

        def opt():
            from selfc_tpu_torch.train.rescale_model import clip_by_global_norm_
            clip_by_global_norm_(list(mdl.net.parameters()), 10.0)
            mdl.optimizer.step()

        out = {"forward": [], "backward": [], "optimizer": []}
        for _ in range(5):
            out["forward"].append(time_cuda(fwd, iters=1, warmup=0)["median"])
            out["backward"].append(time_cuda(lambda: held["loss"].backward(), iters=1, warmup=0)["median"])
            out["optimizer"].append(time_cuda(opt, iters=1, warmup=0)["median"])
        return {k: float(np.median(v)) for k, v in out.items()}

    torch.cuda.reset_peak_memory_stats()
    step = time_cuda(step_of(model), iters=10, warmup=1)
    peak_saved = torch.cuda.max_memory_allocated() / 2 ** 30
    split = parts(model)
    torch.cuda.reset_peak_memory_stats()
    step_r = time_cuda(step_of(recompute), iters=10, warmup=1)
    peak_recompute = torch.cuda.max_memory_allocated() / 2 ** 30
    with plain_chain_on_card():
        step_p = time_cuda(step_of(model), iters=10, warmup=1)
    by_name = {k["name"]: k for k in kernels}
    n_fwd = sum(by_name[f"dense_chain_t_ep[{C}->{co}]@train"]["ms"] * counts["forward"].get((C, co, 32), 0)
                for C, co in PATH_WIDTHS) / (N_TRAIN_STEPS + 1)
    n_bwd = sum(by_name[f"chain_spatial_bwd[{C}]@train"]["ms"] * counts["backward"].get((C, 32), 0)
                for C in CHAIN_C) / (N_TRAIN_STEPS + 1)
    emit("timing_train", shape=TRAIN_SHAPE, step_ms=step["median"], step_ms_min=step["min"],
         step_recompute_feats_ms=step_r["median"], step_recompute_feats_ms_min=step_r["min"],
         step_plain_ms=step_p["median"], step_plain_ms_min=step_p["min"],
         forward_ms=split["forward"], backward_ms=split["backward"], optimizer_ms=split["optimizer"],
         forward_chain_kernels_ms_per_step=n_fwd, backward_chain_kernels_ms_per_step=n_bwd,
         clips_per_s=TRAIN_SHAPE[0] * 1e3 / step["median"],
         peak_device_memory_gib_saved_feats=peak_saved, peak_device_memory_gib_recomputed_feats=peak_recompute)
    return kernels


def phase_kernels_gc(device):
    """B1 at the codec's widths against its plain version: growth 12 and
    24 (16- and 32-lane segments in the kernels) and the coupling's
    12->3 / 3->12 at growth 32."""
    rng = np.random.default_rng(30)
    worst, cases = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for C, c_out, gc, modes in GC_CHECKS:
            for mode in modes:
                x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, CHECK_SHAPE, device, dtype, gc)
                n_aux = dc.EP_AUX[mode]
                aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
                got = dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
                want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                if dtype == torch.float32:
                    ok = err <= FP32_LIMIT
                    worst[(C, c_out, gc)] = max(worst.get((C, c_out, gc), 0.0), err)
                else:
                    ok = err <= BF16_REL_LIMIT * ref
                cases.append({"dtype": str(dtype).split(".")[-1], "C": C, "c_out": c_out, "gc": gc,
                              "mode": mode, "max_abs_err": err, "max_abs_ref": ref, "ok": ok})
                check(ok and np.isfinite(err), f"kernel agrees with its plain version: {cases[-1]}")
    emit("kernels_gc", shape=CHECK_SHAPE, n_cases=len(cases), fp32_limit=FP32_LIMIT,
         bf16_rel_limit=BF16_REL_LIMIT, cases=cases)
    return worst


def codec_options(**network):
    """The network of the published selfc_tpu/configs/test/test_codec_uvg_bf.yml
    (random weights instead of its .pth), built here; ``network`` overrides
    its ``network_G`` (``deart_net=True``: the de-artifact net)."""
    return dict_to_nonedict({
        "model": "SelfC_GMM_Codec", "distortion": "sr_bd", "scale": 2,
        "network_G": {"which_model_G": {"subnet_type": "D2DTNet"}, "in_nc": 3, "out_nc": 3,
                      "block_num": [4], "scale": 2, "init": "xavier", "global_module": "nonlocal",
                      "stp_blk_num": 4, "h265_deart": False, "h265_q": 9, "h265_keyint": -1,
                      "h265_all_default": True, "fh_loss": "l2", "stp_hidden_c": 24,
                      "stp_denseblock_innerc": 12, **network},
    })


def uvg_clip(seed=40):
    """A synthetic (1,13,1080,1920,3) clip in [0,1]: a smooth moving pattern
    plus noise, so the codec's rate is neither trivial nor saturated."""
    rng = np.random.default_rng(seed)
    H, W = UVG_HW
    y = np.linspace(0, 1, H, dtype=np.float32)[:, None, None]
    x = np.linspace(0, 1, W, dtype=np.float32)[None, :, None]
    tint = np.array([1.0, 0.8, 0.6], np.float32)
    frames = np.empty((1, CODEC_T, H, W, 3), np.float32)
    for t in range(CODEC_T):
        frames[0, t] = 0.5 + 0.3 * np.sin(9 * x + 0.2 * t) * np.cos(5 * y + 0.1 * t) * tint
    frames += 0.02 * rng.standard_normal(frames.shape, dtype=np.float32)
    return np.clip(frames, 0, 1, out=frames)


def first_group(segments, tiles):
    """The first call's input the pipeline builds at seg_batch 4: 4 segments
    x the 2 width halves (encode) or the 2x2 tiles (decode), on the batch
    axis."""
    H, W = segments.shape[3:5]
    if tiles == 2:
        parts = [segments[:, si, :, :, i * W // 2:(i + 1) * W // 2] for si in range(4) for i in range(2)]
    else:
        parts = [segments[:, si, :, ti * H // 2:(ti + 1) * H // 2, tj * W // 2:(tj + 1) * W // 2]
                 for si in range(4) for ti in range(2) for tj in range(2)]
    return np.concatenate(parts, axis=0)


def phase_codec(device):
    """The compression eval at the UVG size through ``CodecModel.test``;
    the launch counts of exactly that call are kept, by encode and decode."""
    clip = uvg_clip()
    model = CodecModel(codec_options(), device=device, rng_seed=0)
    tree = seeded_tree(model.net, 41)
    model.load_jax_params(tree)
    n_params = sum(p.numel() for p in model.net.parameters())
    # count the chain launches of the encode and the decode calls apart,
    # and any call of the plain versions
    split = {"encode": {}, "decode": {}}
    plain_calls = [0]

    def counted(fn, part):
        def wrapped(*a, **kw):
            before = dict(dc.launches_by_width)
            out = fn(*a, **kw)
            for k, v in dc.launches_by_width.items():
                split[part][k] = split[part].get(k, 0) + v - before.get(k, 0)
            return out
        return wrapped

    def plain_counted(fn):
        def wrapped(*a, **kw):
            plain_calls[0] += 1
            return fn(*a, **kw)
        return wrapped

    plain = (dc.dense_chain_t_ep_plain, dc.chain_feats_plain, dc._conv5_ep_plain)
    model._encode, model._decode = counted(model._encode, "encode"), counted(model._decode, "decode")
    dc.dense_chain_t_ep_plain, dc.chain_feats_plain, dc._conv5_ep_plain = map(plain_counted, plain)
    try:
        torch.cuda.reset_peak_memory_stats()
        # ---- the main path: counts set to 0 just before, read just after ----
        dc.reset_launch_counts()
        t0 = time.time()
        check(model.feed_data({"GT": clip}) == CODEC_T, "feed_data returns the clip length")
        model.test()
        torch.cuda.synchronize()
        test_s = time.time() - t0
        counts = {"total": dc.launches, "by_width": dict(dc.launches_by_width)}
        # ---------------------------------------------------------------------
    finally:
        dc.dense_chain_t_ep_plain, dc.chain_feats_plain, dc._conv5_ep_plain = plain
        del model._encode, model._decode
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(split == CODEC_LAUNCHES and counts["total"] == 56 and plain_calls[0] == 0,
          f"chain launches of test(): {split}, total {counts['total']}, plain calls {plain_calls[0]}")
    n_gc12 = sum(v for (C, co, gc), v in counts["by_width"].items() if gc == 12)
    check(n_gc12 == 8, f"launches at growth 12: {n_gc12}")

    vis, met = model.get_current_visuals(), model.get_current_metrics()
    lat = (UVG_HW[0] // 2, UVG_HW[1] // 2)
    check(vis["SR"].shape == clip.shape and vis["LR"].shape == (1, CODEC_T, *lat, 3),
          f"SR / LR shapes {vis['SR'].shape} {vis['LR'].shape}")
    for name in ("SR", "LR", "LR_ref"):
        check(np.isfinite(vis[name]).all(), f"{name} is finite")
    bpp = met["video_bpp"]
    check(0.01 < bpp < 6.0, f"bpp {bpp}: neither trivial nor saturated (raw 8-bit LR is 6)")

    with torch.no_grad():
        # encode latents, kernel path against plain path, from one input
        x_enc = model._on_device(first_group(seg_add_pad(clip, 3)[0], 2))
        check(tuple(x_enc.shape[:4]) == CODEC_ENC_SHAPE[:2] + UVG_HW[:1] + (UVG_HW[1] // 2,),
              f"encode call input {tuple(x_enc.shape)}")
        y_k = model.net.encode(x_enc)[0]
        with plain_chain_on_card():
            y_p = model.net.encode(x_enc)[0]
        enc_err = (y_k - y_p).abs().max().item()
        del y_k, y_p
        # hr from ONE shared decoded LR (the codec's output), both paths
        lr_dec = model._on_device(first_group(seg_add_pad(vis["LR"], 3)[0], 4))
        check(tuple(lr_dec.shape[:4]) == CODEC_DEC_SHAPE, f"decode call input {tuple(lr_dec.shape)}")
        hr_k = model.net.decode(lr_dec)[0]
        with plain_chain_on_card():
            hr_p = model.net.decode(lr_dec)[0]
        dec_err = (hr_k - hr_p).abs().max().item()
        # the pipeline stitched these tiles into the clip's first 12 frames
        hh, ww = UVG_HW[0] // 2, UVG_HW[1] // 2
        tiles = hr_k.reshape(4, 2, 2, 3, hh, ww, 3).cpu().numpy()
        del hr_k, hr_p
    frames = np.concatenate([np.concatenate([np.concatenate(list(tiles[g, ti]), axis=2) for ti in range(2)],
                                            axis=1) for g in range(4)], axis=0)
    stitch_err = float(np.abs(frames - vis["SR"][0, :12]).max())
    del tiles, frames
    check(enc_err <= CODEC_LIMIT, f"encode latents: kernel path within {CODEC_LIMIT} of plain, got {enc_err}")
    check(dec_err <= CODEC_LIMIT, f"hr from a shared LR: kernel path within {CODEC_LIMIT} of plain, got {dec_err}")
    check(stitch_err <= 1e-6, f"test()'s frames are its decode calls' tiles: {stitch_err}")
    emit("codec", clip=clip.shape, n_params=n_params, backend=h265.codec_backend(),
         rate_source=model.rate_source, video_bpp=bpp, test_s=test_s,
         launches={p: {str(k): v for k, v in d.items()} for p, d in split.items()},
         launches_gc12=n_gc12, plain_calls=plain_calls[0],
         latent_max_abs_err_kernel_vs_plain=enc_err, hr_max_abs_err_kernel_vs_plain=dec_err,
         limit=CODEC_LIMIT, tiles_vs_test_max_abs=stitch_err, peak_device_memory_gib=peak_gib)
    return model, split, x_enc, lr_dec, test_s, peak_gib


def phase_timing_codec(device, model, split, x_enc, lr_dec, test_s, peak_gib, worst_gc):
    """One encode and one decode call, the chains at the codec's shapes,
    the host codec alone, and the whole test(). A chain is timed at the
    decode call's shape: the encode call's latent has as many pixels
    (6,220,800) and the coupling chains run alike in both, so a growth-32
    row's launches are those of encode and decode together (the kernel is
    held to its plain version at the encode shape by the latent check of
    the codec phase)."""
    rng = np.random.default_rng(42)
    gen = torch.Generator(device=device).manual_seed(42)
    kernels = []
    shape = CODEC_DEC_SHAPE
    check(np.prod(CODEC_ENC_SHAPE) == np.prod(shape), "the codec's two chain shapes hold as many pixels")
    for C, c_out, gc in CODEC_WIDTHS:
        coupling = gc == 32            # the coupling chains carry an epilogue, the prior's none
        mode = "mul_add" if coupling else "none"
        # make_chain's parameters; the activations, up to 450 M values a
        # width, drawn on the card (numpy would take tens of seconds for them)
        _, ws, bs, w5, b5, _, _ = make_chain(rng, C, c_out, (1, 1, 1, 1), device, gc=gc)
        act = lambda c: torch.randn(shape + (c,), generator=gen, device=device)  # noqa: E731
        x = act(C)
        a, m = (act(c_out), act(c_out)) if coupling else (None, None)
        args = (x, ws, bs, w5, b5, a, m)
        err = max(chain_error(args, md) for md in ((mode, "sub_mul") if coupling else (mode,)))
        check(err <= FP32_LIMIT, f"kernel vs plain at the codec shape: {(C, c_out, gc, err)}")
        err = max(err, worst_gc.get((C, c_out, gc), 0.0))
        lib_args = to_library_layout(*args)
        lib = library_chain(*lib_args).permute(0, 2, 3, 4, 1)
        want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 1.0, a, m)
        check((lib - want).abs().max().item() <= 1e-3, "library chain computes the same function")
        del lib, want
        ms = time_cuda(lambda: dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 1.0, a, m), iters=10)
        plain = time_cuda(lambda: dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 1.0, a, m), iters=10)
        library = time_cuda(lambda: library_chain(*lib_args), iters=10)
        bound, by = chain_bound_ms(*shape, C, c_out, dc.EP_AUX[mode], gc=gc)
        kernels.append({
            "name": f"dense_chain_t_ep[{C}->{c_out},gc{gc}]@codec", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": sum(split[part].get((C, c_out, gc), 0) for part in split),
            "max_abs_err": err, "ms": ms["median"], "plain_ms": plain["median"],
            "bound_ms": bound, "bound_by": by, "library_ms": library["median"],
            "ms_min": ms["min"], "plain_ms_min": plain["min"], "library_ms_min": library["min"],
            "shape": list(shape) + [C], "gc": gc, "mode": mode})
        del args, x, ws, bs, w5, b5, a, m, lib_args

    # the two device calls of the pipeline, kernel path and plain path (the
    # plain path is a yardstick: three calls, warmed by the codec phase's)
    with torch.no_grad():
        enc = time_cuda(lambda: model._encode(x_enc), iters=10, warmup=1)
        dec = time_cuda(lambda: model._decode(lr_dec), iters=10, warmup=1)
        with plain_chain_on_card():
            enc_p = time_cuda(lambda: model._encode(x_enc), iters=3, warmup=0)
            dec_p = time_cuda(lambda: model._decode(lr_dec), iters=3, warmup=0)
    # the host codec alone, on the decoded LR of the run (write, close, read back)
    lr = model.get_current_visuals()["LR"]
    t0 = time.time()
    stream = h265.make_stream(model.q, model.keyint, model.scale, model.h265_all_default)
    stream.open_writer(lr.shape[3], lr.shape[2])
    stream.write_multi_frames(lr[0])
    stream.close_writer()
    stream.open_reader()
    back = stream.read_multi_frames(lr.shape[1])
    stream.close_reader()
    codec_s = time.time() - t0
    check(back.shape == lr[0].shape, "the host codec reads back every frame")
    by_name = {k["name"]: k for k in kernels}
    chains_ms = {part: sum(by_name[f"dense_chain_t_ep[{C}->{co},gc{gc}]@codec"]["ms"] * n
                           for (C, co, gc), n in split[part].items()) / 2
                 for part in ("encode", "decode")}
    emit("timing_codec", encode_call_ms=enc["median"], encode_call_ms_min=enc["min"],
         encode_call_plain_ms=enc_p["median"], encode_call_plain_ms_min=enc_p["min"],
         decode_call_ms=dec["median"], decode_call_ms_min=dec["min"],
         decode_call_plain_ms=dec_p["median"], decode_call_plain_ms_min=dec_p["min"],
         chains_ms_per_encode_call=chains_ms["encode"], chains_ms_per_decode_call=chains_ms["decode"],
         host_codec_s=codec_s, host_codec=h265.codec_backend() or model.rate_source,
         test_s=test_s, frames_per_s=CODEC_T / test_s, peak_device_memory_gib=peak_gib)
    return kernels, {"test_s": test_s, "decode_call_ms": dec["median"], "peak_device_memory_gib": peak_gib}


def library_feats2d(x, ws, bs):
    """[x1 | .. | x4] of a (N,C,H,W) batch through PyTorch's library 2-D
    convolutions: the yardstick of the v1 spatial chain, never called by the
    port."""
    feats = x
    for w, b in zip(ws, bs):
        feats = torch.cat([feats, F.leaky_relu(F.conv2d(feats, w, b, padding=1), 0.2)], 1)
    return feats[:, x.shape[1]:]


def seeded_grads(rng, like, device, dtype=torch.float32):
    return torch.from_numpy(rng.normal(0, 1, tuple(like.shape)).astype(np.float32)).to(device, dtype)


def phase_kernels_gc_bwd(device):
    """B2 and B3 below growth 32 against their plain versions (the features
    and the gradient in the kernels' layout, the gradient's pad lanes
    holding noise that must not reach a result), fp32 and bf16, the same
    bits twice; B4 forward and gradient against its plain version at the
    surrogate's widths on the codec's training latent."""
    rng = np.random.default_rng(60)
    cases, worst = [], {"feats": {}, "bwd": {}, "spatial": {}, "spatial_bwd": {}}
    for C, gc, shape in GC_BWD_CHECKS:
        gcp = dc.padded_gc(gc)
        for dtype in (torch.float32, torch.bfloat16):
            fp32 = dtype == torch.float32
            x, ws, bs, *_ = make_chain(rng, C, 3, shape, device, dtype, gc)
            want_f = dc.padded_width(dc.chain_feats_plain(x, ws, bs), gc, gcp)
            got_f = dc.chain_feats(x, ws, bs)
            e_f = rel_err(got_f, want_f)
            feats = want_f.clone()
            real = dc.true_width(feats, gc)
            real[torch.from_numpy(rng.random(real.shape) < 0.02).to(device)] = 0
            feats = dc.padded_width(real, gc, gcp)
            g = seeded_grads(rng, feats, device, dtype)       # noise in the pad lanes too
            dx0 = seeded_grads(rng, x, device)
            want = dc.chain_spatial_bwd_plain(x, ws, bs, feats, g, dx0)
            got = dc.chain_spatial_bwd(x, ws, bs, feats, g, dx0)
            again = dc.chain_spatial_bwd(x, ws, bs, feats, g, dx0)
            torch.cuda.synchronize()
            flat = lambda r: [r[0], *r[1], *r[2]]  # noqa: E731
            e_dx, *e_p = [rel_err(u, v) for u, v in zip(flat(got), flat(want))]
            same_bits = all(torch.equal(u, v) for u, v in zip(flat(got), flat(again)))
            limit = BWD_FP32_REL_LIMIT if fp32 else BWD_BF16_REL_LIMIT
            ok = (e_f <= (BWD_FP32_REL_LIMIT if fp32 else BF16_REL_LIMIT)
                  and max(e_dx, *e_p) <= limit and same_bits)
            if fp32 and shape == CODEC_TRAIN_LAT:
                worst["feats"][(C, gc)] = (got_f.float() - want_f.float()).abs().max().item()
                worst["bwd"][(C, gc)] = (got[0] - want[0]).abs().max().item()
            cases.append({"kernel": "B2/B3", "shape": shape, "dtype": str(dtype).split(".")[-1], "C": C,
                          "gc": gc, "feats_rel_err": e_f, "dx_rel_err": e_dx, "dw_db_rel_err": max(e_p),
                          "same_bits_twice": same_bits, "ok": ok})
            check(ok and np.isfinite(e_f + e_dx + max(e_p)),
                  f"the adjoint and spatial-only forward below growth 32 agree with their plain versions: {cases[-1]}")
    for C in SURROGATE_C:
        x, ws, bs, *_ = make_chain(rng, C, 3, CODEC_TRAIN_LAT, device)
        leaves = [x, *ws, *bs]
        for t in leaves:
            t.requires_grad_(True)
        want = dc.fused_dense_spatial_plain(x, ws, bs)
        before = (dc.launches_spatial, dc.launches_spatial_bwd)
        got = dc.fused_dense_spatial(x, ws, bs)
        gout = seeded_grads(rng, want, device)
        g_got = torch.autograd.grad(got, leaves, gout)
        g_again = torch.autograd.grad(dc.fused_dense_spatial(x, ws, bs), leaves, gout)
        # the gradient's reference is the plain adjoint at the features the
        # kernel's forward saved: LeakyReLU's slope switches at 0, so where
        # the two forwards put an output within their ~1e-6 of each other on
        # the two sides of 0 (a few hundred of the 24 M outputs here), the
        # gradients of the two whole paths differ by the switch itself
        g_want = dc.chain_spatial_bwd_plain(x.detach(), [w.detach() for w in ws],
                                            [b.detach() for b in bs], got.detach(), gout)
        g_want = [g_want[0], *g_want[1], *g_want[2]]
        g_auto = torch.autograd.grad(want, leaves, gout)   # autograd through the plain forward, reported
        torch.cuda.synchronize()
        counted = (dc.launches_spatial - before[0], dc.launches_spatial_bwd - before[1]) == (2, 2)
        e_fwd = (got - want).abs().max().item()
        e_grad = max(rel_err(u, v) for u, v in zip(g_got, g_want))
        l2_auto = (sum((u - v).pow(2).sum().item() for u, v in zip(g_got, g_auto))
                   / sum(v.pow(2).sum().item() for v in g_auto)) ** 0.5
        same_bits = all(torch.equal(u, v) for u, v in zip(g_got, g_again))
        worst["spatial"][C] = e_fwd
        worst["spatial_bwd"][C] = max((u - v).abs().max().item() for u, v in zip(g_got, g_want))
        cases.append({"kernel": "B4", "shape": CODEC_TRAIN_LAT, "C": C, "forward_max_abs_err": e_fwd,
                      "grad_rel_err": e_grad, "grad_l2_rel_err_vs_autograd_of_plain": l2_auto,
                      "same_bits_twice": same_bits, "launches_counted": counted})
        check(e_fwd <= SPATIAL_LIMIT and e_grad <= SPATIAL_LIMIT and same_bits and counted,
              f"the v1 spatial chain agrees with its plain version: {cases[-1]}")
        del x, ws, bs, leaves, want, got, g_want, g_got, g_again, g_auto
    emit("kernels_gc_bwd", n_cases=len(cases), bwd_fp32_rel_limit=BWD_FP32_REL_LIMIT,
         bwd_bf16_rel_limit=BWD_BF16_REL_LIMIT, spatial_limit=SPATIAL_LIMIT, cases=cases)
    return worst


def codec_train_options(network=None, **train):
    """The options of the published selfc_tpu/configs/train/train_compression.yml,
    built here: the whole batch of 12 on one card; ``network`` overrides its
    ``network_G``."""
    return dict_to_nonedict({
        "model": "SelfC_GMM_Codec", "distortion": "sr_bd", "scale": 2, "is_train": True,
        "datasets": {"train": {"video_len": 3, "batch_size": 12, "GT_size": 144}},
        "network_G": {"which_model_G": {"subnet_type": "D2DTNet"}, "in_nc": 3, "out_nc": 3,
                      "block_num": [4], "scale": 2, "init": "xavier", "global_module": "nonlocal",
                      "stp_blk_num": 4, "fh_loss": "l2", "h265_deart": False, "h265_q": 16,
                      "lambda_corr": 1e-5, "stp_hidden_c": 24, "stp_denseblock_innerc": 12,
                      **(network or {})},
        "train": {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "niter": 1000000, "warmup_iter": -1,
                  "lr_scheme": "MultiStepLR", "lr_steps": [300000, 400000, 500000, 600000],
                  "lr_gamma": 0.5, "pixel_criterion_forw": "l2", "pixel_criterion_back": "l1",
                  "lambda_cond_prob": 0, "lambda_gaussian_reg": 0, "lambda_distor_loss": 0,
                  "noise_type": "h265", "h265_sug": True, "lambda_fit_forw": 1,
                  "lambda_rec_back": 0.1, "lambda_mimick_loss": 4, "loss_multiplier": 1000,
                  "weight_decay_G": None, "gradient_clipping": 0.5, **train},
    })


def codec_train_batch(seed=50):
    """A smooth synthetic batch in [0,1] of the codec training config's shape."""
    rng = np.random.default_rng(seed)
    B, T, S = CODEC_TRAIN_SHAPE[:3]
    yy, xx = np.meshgrid(np.linspace(0, 1, S), np.linspace(0, 1, S), indexing="ij")
    ph = rng.uniform(0, 6, (B, 1, 1, 1, 3))
    t = np.arange(T).reshape(1, T, 1, 1, 1)
    base = 0.5 + 0.3 * np.sin(7 * xx[None, None, :, :, None] + 0.3 * t + ph) * np.cos(5 * yy[None, None, :, :, None] + ph)
    return np.clip(base + rng.normal(0, 0.02, CODEC_TRAIN_SHAPE), 0, 1).astype(np.float32)


def codec_tree(model, seed):
    """Random {net, surrogate} parameters from a numpy seed."""
    return {"net": seeded_tree(model.net, seed), "surrogate": seeded_tree(model.surrogate, seed + 1)}


def new_codec_trainer(device, tree, batch, network=None, **train):
    model = CodecModel(codec_train_options(network, **train), device=device, rng_seed=0)
    model.load_jax_params(tree)
    check(model.feed_data({"GT": batch}) == CODEC_TRAIN_SHAPE[1], "feed_data returns the clip length")
    return model


def all_grads(model):
    return {k: p.grad.detach().clone() for k, p in model.params.named_parameters()}


def codec_counts():
    return {"forward": dict(dc.launches_by_width), "backward": dict(dc.launches_bwd_by_width),
            "feats": dict(dc.launches_feats_by_width), "spatial": dict(dc.launches_spatial_by_width),
            "spatial_bwd": dict(dc.launches_spatial_bwd_by_width)}


def phase_codec_train(device):
    """Three training steps of the published codec net with its surrogate
    at the published batch, through the host codec, then one step with
    ``save_chain_feats: false``; the launch counts of exactly these four
    steps are kept. Then one step's whole gradient, kernel path against
    plain path, from one shared codec output."""
    batch = codec_train_batch()
    probe = CodecModel(codec_train_options(), device=device, rng_seed=0)
    tree = codec_tree(probe, 51)
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in probe.params.items()}
    del probe
    model = new_codec_trainer(device, tree, batch)
    start = {k: p.detach().clone() for k, p in model.params.named_parameters()}

    # ---- the main path: counts set to 0 just before, read just after ----
    dc.reset_launch_counts()
    logs, per_step, codec_s = [], [], []
    t0 = time.time()
    for step in range(N_CODEC_STEPS):
        before = codec_counts()
        model.optimize_parameters(step)
        logs.append(dict(model.get_current_log()))
        codec_s.append(model.last_codec_host_seconds)
        per_step.append({k: {w: n - before[k].get(w, 0) for w, n in d.items()}
                         for k, d in codec_counts().items()})
        if step == 0:
            grads_1 = all_grads(model)
    recompute = new_codec_trainer(device, tree, batch, save_chain_feats=False)
    before = codec_counts()
    recompute.optimize_parameters(0)
    log_r = dict(recompute.get_current_log())
    torch.cuda.synchronize()
    train_s = time.time() - t0
    per_step.append({k: {w: n - before[k].get(w, 0) for w, n in d.items()} for k, d in codec_counts().items()})
    counts = codec_counts()
    # ---------------------------------------------------------------------

    # the adjoint by (C, gc): one a chain, and one a v1 spatial chain, whose
    # forward is a spatial-only forward launch (their widths do not meet)
    adjoint = dict(CODEC_TRAIN_SPATIAL)
    for (C, _, gc), n in CODEC_TRAIN_FWD.items():
        adjoint[(C, gc)] = adjoint.get((C, gc), 0) + n
    want = {"forward": CODEC_TRAIN_FWD, "backward": adjoint, "feats": CODEC_TRAIN_SPATIAL,
            "spatial": CODEC_TRAIN_SPATIAL, "spatial_bwd": CODEC_TRAIN_SPATIAL}
    # the recomputing step also runs the spatial-only forward once a chain
    want_r = dict(want, feats=adjoint)
    got = [{k: {w: n for w, n in d.items() if n} for k, d in st.items()} for st in per_step]
    check(got == [want] * N_CODEC_STEPS + [want_r],
          f"kernel launches of each codec training step: {got} (expected {want}, then {want_r})")
    n_gc12 = sum(n for (C, gc), n in got[0]["backward"].items() if gc == 12)
    check(n_gc12 == 4, f"adjoint launches at growth 12 a step: {n_gc12}")
    for lg in logs + [log_r]:
        check(all(np.isfinite(v) for k, v in lg.items() if k != "rate_source")
              and lg["skipped_nonfinite"] == 0.0, f"the step's losses are finite and it was not skipped: {lg}")
    check(log_r["loss"] == logs[0]["loss"], f"save_chain_feats false gives the same loss: {(log_r['loss'], logs[0]['loss'])}")
    top = max(g.abs().max().item() for g in grads_1.values())
    unchanged = [k for k, p in model.params.named_parameters() if torch.equal(p.detach(), start[k])]
    check(all(grads_1[k].abs().max().item() < TRAIN_GRAD_ZERO * top for k in unchanged),
          f"every parameter with a gradient changed: {unchanged[:5]}")
    del model, recompute

    # one step from one shared codec output: kernel path against plain path
    kern = new_codec_trainer(device, tree, batch)
    with torch.no_grad():
        shared, _ = kern.codec_span(kern._encode_lf(kern._hr), kern.q)
    kern.optimize_parameters(0, codec_out=shared)
    log_k, grads_k = dict(kern.get_current_log()), all_grads(kern)
    del kern
    plain = new_codec_trainer(device, tree, batch)
    with plain_chain_on_card():
        before = codec_counts()
        plain.optimize_parameters(0, codec_out=shared)
        check(codec_counts() == before, "the plain path launches no kernel")
    log_p, grads_p = dict(plain.get_current_log()), all_grads(plain)
    del plain
    loss_rel = abs(log_k["loss"] - log_p["loss"]) / abs(log_p["loss"])
    grad_l2 = (sum((grads_k[k] - g).pow(2).sum().item() for k, g in grads_p.items())
               / sum(g.pow(2).sum().item() for g in grads_p.values())) ** 0.5
    check(np.isfinite(log_k["loss"]) and loss_rel <= TRAIN_LOSS_REL_LIMIT,
          f"codec step's loss, kernel path vs plain path: {(log_k['loss'], log_p['loss'])}")
    check(grad_l2 <= TRAIN_GRAD_L2_LIMIT, f"codec step's whole gradient, kernel path vs plain path: {grad_l2}")
    emit("codec_train", batch=batch.shape, n_params=n_params, steps=N_CODEC_STEPS, train_s=train_s,
         host_codec=h265.codec_backend() or "stand-in", rate_source=logs[0]["rate_source"],
         host_codec_s_per_step=codec_s,
         launches_per_step={k: {str(w): n for w, n in d.items()} for k, d in got[0].items()},
         launches_adjoint_gc12_per_step=n_gc12, logs=logs,
         loss_rel_err_kernel_vs_plain=loss_rel, loss_rel_limit=TRAIN_LOSS_REL_LIMIT,
         grad_l2_rel_err_kernel_vs_plain=grad_l2, grad_l2_limit=TRAIN_GRAD_L2_LIMIT,
         recompute_same_loss=True)
    return tree, batch, counts


def phase_timing_codec_train(device, tree, batch, counts, worst):
    """The kernels of the codec's training at its shapes (B2 and B3 at
    growth 12, B4 forward and backward), a whole step and its parts, the
    plain path's step, and the peak memory with features saved and
    recomputed."""
    rng = np.random.default_rng(61)
    kernels = []
    shape = CODEC_TRAIN_LAT
    ncdhw = lambda t: t.permute(0, 4, 1, 2, 3).contiguous()  # noqa: E731
    for C in (3, 24):                  # the prior's chains: growth 12
        gc = 12
        x, ws, bs, *_ = make_chain(rng, C, 3, shape, device, gc=gc)
        feats = dc.chain_feats(x, ws, bs)
        g = seeded_grads(rng, feats, device)
        leaves = [ncdhw(x), *(w.permute(3, 2, 0, 1)[:, :, None].contiguous() for w in ws), *(b.clone() for b in bs)]
        for t in leaves:
            t.requires_grad_(True)
        lx, lws, lbs = leaves[0], leaves[1:5], leaves[5:]
        lfeats = library_feats(lx, lws, lbs)
        lg = ncdhw(dc.true_width(g, gc))
        check((lfeats.detach().permute(0, 2, 3, 4, 1) - dc.true_width(feats, gc)).abs().max().item() <= 1e-3,
              "library spatial chain computes the same function")
        with torch.no_grad():
            f_ms = time_cuda(lambda: dc.chain_feats(x, ws, bs), iters=10)
            f_plain = time_cuda(lambda: dc.chain_feats_plain(x, ws, bs), iters=10)
            f_lib = time_cuda(lambda: library_feats(lx, lws, lbs), iters=10)
        f_bound, f_by = chain_feats_bound_ms(*shape, C, gc=gc)
        kernels.append({
            "name": f"chain_feats[{C},gc{gc}]@codec_train", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES_FEATS, "launches": counts["feats"].get((C, gc), 0),
            "max_abs_err": worst["feats"][(C, gc)], "ms": f_ms["median"], "plain_ms": f_plain["median"],
            "bound_ms": f_bound, "bound_by": f_by, "library_ms": f_lib["median"],
            "ms_min": f_ms["min"], "plain_ms_min": f_plain["min"], "library_ms_min": f_lib["min"],
            "shape": list(shape) + [C], "gc": gc})
        b_ms = time_cuda(lambda: dc.chain_spatial_bwd(x, ws, bs, feats, g), iters=10)
        b_plain = time_cuda(lambda: dc.chain_spatial_bwd_plain(x, ws, bs, feats, g), iters=10)
        b_lib = time_cuda(lambda: torch.autograd.grad(lfeats, leaves, lg, retain_graph=True), iters=10)
        b_bound, b_by = chain_bwd_bound_ms(*shape, C, gc=gc)
        kernels.append({
            "name": f"chain_spatial_bwd[{C},gc{gc}]@codec_train", "route": "cuda", "source": SOURCE_BWD,
            "replaces": REPLACES_BWD, "launches": counts["backward"].get((C, gc), 0),
            "max_abs_err": worst["bwd"][(C, gc)], "ms": b_ms["median"], "plain_ms": b_plain["median"],
            "bound_ms": b_bound, "bound_by": b_by, "library_ms": b_lib["median"],
            "ms_min": b_ms["min"], "plain_ms_min": b_plain["min"], "library_ms_min": b_lib["min"],
            "shape": list(shape) + [C], "gc": gc})
        del x, ws, bs, feats, g, leaves, lfeats, lg
    B, T, H, W = shape
    for C in SURROGATE_C:              # the surrogate's v1 spatial chains
        x, ws, bs, *_ = make_chain(rng, C, 3, shape, device)
        for t in (x, *ws, *bs):
            t.requires_grad_(True)
        leaves = [x, *ws, *bs]
        l2 = [x.detach().reshape(B * T, H, W, C).permute(0, 3, 1, 2).contiguous(),
              *(w.detach().permute(3, 2, 0, 1).contiguous() for w in ws), *(b.detach().clone() for b in bs)]
        for t in l2:
            t.requires_grad_(True)
        out = dc.fused_dense_spatial(x, ws, bs)
        gout = seeded_grads(rng, out, device)
        lout = library_feats2d(l2[0], l2[1:5], l2[5:])
        lg = gout.reshape(B * T, H, W, -1).permute(0, 3, 1, 2).contiguous()
        check((lout.detach().permute(0, 2, 3, 1).reshape(out.shape) - out.detach()).abs().max().item() <= 1e-3,
              "library 2-d spatial chain computes the same function")
        with torch.no_grad():
            s_ms = time_cuda(lambda: dc.fused_dense_spatial(x, ws, bs), iters=10)
            s_plain = time_cuda(lambda: dc.fused_dense_spatial_plain(x, ws, bs), iters=10)
            s_lib = time_cuda(lambda: library_feats2d(l2[0], l2[1:5], l2[5:]), iters=10)
        out_p = dc.fused_dense_spatial_plain(x, ws, bs)
        sb_ms = time_cuda(lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True), iters=10)
        sb_plain = time_cuda(lambda: torch.autograd.grad(out_p, leaves, gout, retain_graph=True), iters=10)
        sb_lib = time_cuda(lambda: torch.autograd.grad(lout, l2, lg, retain_graph=True), iters=10)
        bound, by = chain_feats_bound_ms(*shape, C)
        bb, bby = chain_bwd_bound_ms(*shape, C, dx_in=False)
        common = {"route": "cuda", "replaces": REPLACES_SPATIAL, "shape": list(shape) + [C], "gc": 32}
        kernels.append({
            "name": f"fused_dense_spatial[{C}]@codec_train", "source": SOURCE,
            "launches": counts["spatial"].get((C, 32), 0), "max_abs_err": worst["spatial"][C],
            "ms": s_ms["median"], "plain_ms": s_plain["median"], "bound_ms": bound, "bound_by": by,
            "library_ms": s_lib["median"], "ms_min": s_ms["min"], "plain_ms_min": s_plain["min"],
            "library_ms_min": s_lib["min"], **common})
        kernels.append({
            "name": f"fused_dense_spatial_bwd[{C}]@codec_train", "source": SOURCE_BWD,
            "launches": counts["spatial_bwd"].get((C, 32), 0), "max_abs_err": worst["spatial_bwd"][C],
            "ms": sb_ms["median"], "plain_ms": sb_plain["median"], "bound_ms": bb, "bound_by": bby,
            "library_ms": sb_lib["median"], "ms_min": sb_ms["min"], "plain_ms_min": sb_plain["min"],
            "library_ms_min": sb_lib["min"], **common})
        del x, ws, bs, leaves, l2, out, out_p, lout, gout, lg

    # a whole step (host codec included), then its parts, each timed alone
    model = new_codec_trainer(device, tree, batch)
    step_of = lambda mdl: (lambda: mdl.optimize_parameters(N_CODEC_STEPS))  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    step = time_cuda(step_of(model), iters=6, warmup=1)
    peak_saved = torch.cuda.max_memory_allocated() / 2 ** 30
    parts = {"encode_forward": [], "host_codec": [], "loss_backward": [], "optimizer": []}
    hr = model._hr
    with torch.no_grad():
        ref_l = model.degrade(hr)
    for _ in range(5):
        model.optimizer.zero_grad(set_to_none=True)
        held = {}
        parts["encode_forward"].append(time_cuda(lambda: held.update(lf=model._encode_lf(hr)), 1, 0)["median"])
        t0 = time.time()
        codec_out, _ = model.codec_span(held["lf"], model.q)
        torch.cuda.synchronize()
        parts["host_codec"].append((time.time() - t0) * 1e3)

        def loss_backward():
            model._loss(held["lf"], hr, ref_l, codec_out, model.q)[0].backward()

        parts["loss_backward"].append(time_cuda(loss_backward, 1, 0)["median"])

        def opt():
            clip_by_global_norm_(list(model.params.parameters()), 0.5)
            model.optimizer.step()

        parts["optimizer"].append(time_cuda(opt, 1, 0)["median"])
    split = {k: float(np.median(v)) for k, v in parts.items()}
    del model
    recompute = new_codec_trainer(device, tree, batch, save_chain_feats=False)
    torch.cuda.reset_peak_memory_stats()
    step_r = time_cuda(step_of(recompute), iters=6, warmup=1)
    peak_recompute = torch.cuda.max_memory_allocated() / 2 ** 30
    del recompute
    plain = new_codec_trainer(device, tree, batch)
    with plain_chain_on_card():
        step_p = time_cuda(step_of(plain), iters=5, warmup=1)
    rate = plain.rate_source
    del plain
    emit("timing_codec_train", batch=CODEC_TRAIN_SHAPE, step_ms=step["median"], step_ms_min=step["min"],
         step_recompute_feats_ms=step_r["median"], step_plain_ms=step_p["median"],
         step_plain_ms_min=step_p["min"], encode_forward_ms=split["encode_forward"],
         host_codec_ms=split["host_codec"], loss_backward_ms=split["loss_backward"],
         optimizer_ms=split["optimizer"], clips_per_s=CODEC_TRAIN_SHAPE[0] * 1e3 / step["median"],
         peak_device_memory_gib_saved_feats=peak_saved, peak_device_memory_gib_recomputed_feats=peak_recompute,
         rate_source=rate, host_codec=h265.codec_backend() or "stand-in")
    return kernels, {"step_ms": step["median"], "step_plain_ms": step_p["median"],
                     "peak_device_memory_gib": peak_saved}


def deform_errors(got, want, fp32):
    """Errors of one deformable-conv comparison: max abs (fp32) or relative
    to max |ref| (bf16)."""
    err = (got.float() - want.float()).abs().max().item()
    return err if fp32 else err / want.float().abs().max().item()


def phase_kernels_deform(device):
    """B5 forward and backward against the composition and the closed-form
    adjoint on the card, fp32 and bf16: offsets uniform in +-7 px (taps
    leave the frame), the mask in [0, 2]; dweight the same bits twice, and
    dx's run-to-run difference (atomics) reported. Zero offsets with mask 1
    must give the port's conv2d. On a CUDA tensor the op launches or raises."""
    rng = np.random.default_rng(70)
    cases, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        for shape, C, c_out in DEFORM_CHECKS:
            x, off, mask, w, g = make_deform(rng, shape, C, c_out, device, dtype, DEFORM_SPREAD)
            corners, outside = deform_tap_stats(off)
            e_fwd = deform_errors(df.deform_conv2d(x, off, mask, w), df.deform_conv2d_plain(x, off, mask, w), fp32)
            got = df._backward_cuda(x, off, mask, w, g)
            again = df._backward_cuda(x, off, mask, w, g)
            want = df.deform_conv2d_bwd_plain(x, off, mask, w, g)
            torch.cuda.synchronize()
            e_bwd = {n: rel_err(u, v) for n, u, v in zip(("dx", "doffset", "dmask", "dweight"), got, want)}
            same_bits = torch.equal(got[3], again[3])
            dx_repeat = (got[0].float() - again[0].float()).abs().max().item()
            ok = (e_fwd <= (FP32_LIMIT if fp32 else BF16_REL_LIMIT)
                  and max(e_bwd.values()) <= (BWD_FP32_REL_LIMIT if fp32 else BWD_BF16_REL_LIMIT) and same_bits)
            if fp32:
                worst[(tuple(shape), C, c_out)] = {
                    "forward": e_fwd, "backward": max((u.float() - v.float()).abs().max().item()
                                                      for u, v in zip(got, want))}
            cases.append({"dtype": str(dtype).split(".")[-1], "shape": list(shape), "C": C, "c_out": c_out,
                          "forward_err": e_fwd, **{f"{n}_rel_err": v for n, v in e_bwd.items()},
                          "dweight_same_bits_twice": same_bits, "dx_run_to_run_max_abs": dx_repeat,
                          "corners_inside_per_tap": corners, "taps_with_a_corner_outside": outside, "ok": ok})
            check(ok and np.isfinite(e_fwd + sum(e_bwd.values())),
                  f"B5 agrees with its plain versions: {cases[-1]}")
            del x, off, mask, w, g, got, again, want
    # zero offsets, mask 1: the SAME 3x3 conv
    x, _, _, w, _ = make_deform(rng, (2, 12, 16), 8, 8, device)
    zero = df.deform_conv2d(x, torch.zeros(2, 12, 16, 18, device=device), torch.ones(2, 12, 16, 9, device=device), w)
    e_zero = (zero - conv2d(x, w)).abs().max().item()
    check(e_zero <= FP32_LIMIT, f"zero offsets and mask 1 give conv2d: {e_zero}")
    # on a CUDA tensor the op launches or raises
    x, off, mask, w, _ = make_deform(rng, (1, 5, 6), 4, 4, device)
    before, refused = (df.launches, df.launches_bwd), []
    for fault, error, args in (("bf16 offset", ValueError, (x, off.bfloat16(), mask, w)),
                               ("float64", TypeError, (x.double(), off.double(), mask.double(), w.double())),
                               ("17 offset channels", ValueError, (x, off[..., :17], mask, w))):
        try:
            df.deform_conv2d(*args)
        except error:
            refused.append(fault)
    check(len(refused) == 3 and (df.launches, df.launches_bwd) == before,
          f"the deformable conv refuses bad CUDA arguments: {refused}")
    emit("kernels_deform", kernels=["deform_conv2d", "deform_conv2d_bwd"], n_cases=len(cases),
         spread_px=DEFORM_SPREAD, fp32_limit=FP32_LIMIT, bf16_rel_limit=BF16_REL_LIMIT,
         bwd_fp32_rel_limit=BWD_FP32_REL_LIMIT, bwd_bf16_rel_limit=BWD_BF16_REL_LIMIT,
         zero_offset_vs_conv2d_max_abs=e_zero, refused=refused, cases=cases)
    return worst


def scale_deart_offsets(module, tree, lr):
    """Scale ``deart_1.offset_w`` / ``offset_b`` of the (flat) ``tree`` in
    place so that the offsets the loaded ``module`` gives on ``lr`` have a
    standard deviation of DEART_OFFSET_STD px; returns their statistics
    after the scaling (range, corners inside, share of taps with a corner
    outside the frame)."""
    with torch.no_grad():
        _, off, _ = module.deart_1.deform_inputs(module.deart_0(lr))
        f = DEART_OFFSET_STD / off.float().std().item()
        for leaf in ("offset_w", "offset_b"):
            tree[f"deart_1.{leaf}"] = tree[f"deart_1.{leaf}"] * np.float32(f)
            getattr(module.deart_1, leaf).mul_(f)
        _, off, _ = module.deart_1.deform_inputs(module.deart_0(lr))
        pairs = off.permute(0, 1, 4, 2, 3, 5).reshape(-1, *off.shape[2:4], 18)
        corners, outside = deform_tap_stats(pairs)
        return {"scale": f, "min_px": off.min().item(), "max_px": off.max().item(),
                "std_px": off.float().std().item(), "corners_inside_per_tap": corners,
                "taps_with_a_corner_outside": outside}


def phase_codec_deart(device, base):
    """The compression eval of the published codec net with
    ``deart_net: true`` through ``CodecModel.test``; the launch counts of
    exactly that call are kept. Then hr from one shared decoded LR, kernel
    path against plain path, and the decode call's time."""
    clip = uvg_clip()
    model = CodecModel(codec_options(deart_net=True), device=device, rng_seed=0)
    tree = seeded_tree(model.net, 41)
    model.load_jax_params(tree)
    lr_like = model._on_device(first_group(seg_add_pad(clip[:, :, ::2, ::2], 3)[0], 4))
    offsets = scale_deart_offsets(model.net, tree, lr_like)
    n_params = sum(p.numel() for p in model.net.parameters())
    plain_calls = [0]
    plain = df.deform_conv2d_plain

    def plain_counted(*a, **kw):
        plain_calls[0] += 1
        return plain(*a, **kw)

    df.deform_conv2d_plain = plain_counted
    try:
        torch.cuda.reset_peak_memory_stats()
        # ---- the main path: counts set to 0 just before, read just after ----
        dc.reset_launch_counts()
        df.reset_launch_counts()
        t0 = time.time()
        check(model.feed_data({"GT": clip}) == CODEC_T, "feed_data returns the clip length")
        model.test()
        torch.cuda.synchronize()
        test_s = time.time() - t0
        counts = {"b5": dict(df.launches_by_width), "b5_bwd": df.launches_bwd, "b1": dict(dc.launches_by_width)}
        # ---------------------------------------------------------------------
    finally:
        df.deform_conv2d_plain = plain
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want_b1 = dict(Counter(CODEC_LAUNCHES["encode"]) + Counter(CODEC_LAUNCHES["decode"])
                   + Counter({k: 2 * v for k, v in DEART_B1_DECODE.items()}))
    check(counts["b5"] == {(DEART_C, DEART_C): DEART_B5_TEST} and counts["b5_bwd"] == 0 and plain_calls[0] == 0,
          f"B5 launches of test(): {counts['b5']}, backward {counts['b5_bwd']}, plain calls {plain_calls[0]}")
    check(counts["b1"] == want_b1, f"B1 launches of test(): {counts['b1']} (expected {want_b1})")
    vis, met = model.get_current_visuals(), model.get_current_metrics()
    check(vis["SR"].shape == clip.shape and np.isfinite(vis["SR"]).all(), "SR: shape and finite")
    bpp = met["video_bpp"]
    check(0.01 < bpp < 6.0, f"bpp {bpp}: neither trivial nor saturated")
    with torch.no_grad():
        lr_dec = model._on_device(first_group(seg_add_pad(vis["LR"], 3)[0], 4))
        hr_k = model.net.decode(lr_dec)[0]
        with plain_chain_on_card():
            before = (df.launches, dc.launches)
            hr_p = model.net.decode(lr_dec)[0]
            check((df.launches, dc.launches) == before, "the plain path launches no kernel")
        dec_err = (hr_k - hr_p).abs().max().item()
        del hr_k, hr_p
        dec = time_cuda(lambda: model._decode(lr_dec), iters=5, warmup=1)
    check(dec_err <= CODEC_LIMIT, f"hr from a shared LR (de-artifact net): kernel path within {CODEC_LIMIT} of plain, got {dec_err}")
    emit("codec_deart", clip=clip.shape, n_params=n_params, rate_source=model.rate_source, video_bpp=bpp,
         deart_offsets=offsets, launches_b5=DEART_B5_TEST, launches_b1={str(k): v for k, v in counts["b1"].items()},
         hr_max_abs_err_kernel_vs_plain=dec_err, limit=CODEC_LIMIT,
         test_s=test_s, frames_per_s=CODEC_T / test_s, peak_device_memory_gib=peak_gib,
         decode_call_ms=dec["median"], decode_call_ms_min=dec["min"],
         without_deart=base)
    return counts


def phase_codec_deart_train(device, base):
    """Three training steps of the published codec net with
    ``deart_net: true`` and its surrogate at the published batch through the
    host codec, then one with ``save_chain_feats: false``; the B5 launch
    counts of exactly these four steps are kept. Then one step's whole
    gradient, kernel path against plain path, from one shared codec output,
    and the step's time."""
    batch = codec_train_batch()
    net_opt = {"deart_net": True}
    probe = CodecModel(codec_train_options(net_opt), device=device, rng_seed=0)
    tree = codec_tree(probe, 51)
    probe.load_jax_params(tree)
    lr_like = torch.from_numpy(np.ascontiguousarray(batch[:, :, ::2, ::2])).to(device)
    offsets = scale_deart_offsets(probe.net, tree["net"], lr_like)
    n_params = sum(p.numel() for p in probe.params.parameters())
    del probe
    model = new_codec_trainer(device, tree, batch, net_opt)

    # ---- the main path: counts set to 0 just before, read just after ----
    dc.reset_launch_counts()
    df.reset_launch_counts()
    logs, per_step = [], []
    t0 = time.time()
    for step in range(N_CODEC_STEPS):
        before = (df.launches, df.launches_bwd)
        model.optimize_parameters(step)
        logs.append(dict(model.get_current_log()))
        per_step.append((df.launches - before[0], df.launches_bwd - before[1]))
    recompute = new_codec_trainer(device, tree, batch, net_opt, save_chain_feats=False)
    before = (df.launches, df.launches_bwd)
    recompute.optimize_parameters(0)
    log_r = dict(recompute.get_current_log())
    torch.cuda.synchronize()
    train_s = time.time() - t0
    per_step.append((df.launches - before[0], df.launches_bwd - before[1]))
    counts = {"forward": dict(df.launches_by_width), "backward": dict(df.launches_bwd_by_width)}
    # ---------------------------------------------------------------------

    check(per_step == [(DEART_B5_STEP, DEART_B5_STEP)] * (N_CODEC_STEPS + 1),
          f"B5 launches (forward, backward) of each step: {per_step}")
    for lg in logs + [log_r]:
        check(all(np.isfinite(v) for k, v in lg.items() if k != "rate_source")
              and lg["skipped_nonfinite"] == 0.0, f"the step's losses are finite and it was not skipped: {lg}")
    check(log_r["loss"] == logs[0]["loss"], f"save_chain_feats false gives the same loss: {(log_r['loss'], logs[0]['loss'])}")
    del recompute

    # one step from one shared codec output: kernel path against plain path
    kern = new_codec_trainer(device, tree, batch, net_opt)
    with torch.no_grad():
        shared, _ = kern.codec_span(kern._encode_lf(kern._hr), kern.q)
    kern.optimize_parameters(0, codec_out=shared)
    log_k, grads_k = dict(kern.get_current_log()), all_grads(kern)
    del kern
    plain = new_codec_trainer(device, tree, batch, net_opt)
    with plain_chain_on_card():
        before = (df.launches, df.launches_bwd, dc.launches, dc.launches_bwd)
        plain.optimize_parameters(0, codec_out=shared)
        check((df.launches, df.launches_bwd, dc.launches, dc.launches_bwd) == before,
              "the plain path launches no kernel")
    log_p, grads_p = dict(plain.get_current_log()), all_grads(plain)
    del plain
    loss_rel = abs(log_k["loss"] - log_p["loss"]) / abs(log_p["loss"])
    grad_l2 = (sum((grads_k[k] - g).pow(2).sum().item() for k, g in grads_p.items())
               / sum(g.pow(2).sum().item() for g in grads_p.values())) ** 0.5
    deart = [k for k in grads_p if ".deart_" in k]
    grad_l2_deart = (sum((grads_k[k] - grads_p[k]).pow(2).sum().item() for k in deart)
                     / sum(grads_p[k].pow(2).sum().item() for k in deart)) ** 0.5
    check(np.isfinite(log_k["loss"]) and loss_rel <= TRAIN_LOSS_REL_LIMIT,
          f"de-artifact step's loss, kernel path vs plain path: {(log_k['loss'], log_p['loss'])}")
    check(grad_l2 <= TRAIN_GRAD_L2_LIMIT, f"de-artifact step's whole gradient, kernel path vs plain path: {grad_l2}")

    torch.cuda.reset_peak_memory_stats()
    step = time_cuda(lambda: model.optimize_parameters(N_CODEC_STEPS), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    emit("codec_deart_train", batch=batch.shape, n_params=n_params, steps=N_CODEC_STEPS, train_s=train_s,
         rate_source=logs[0]["rate_source"], deart_offsets=offsets,
         launches_b5_per_step={"forward": DEART_B5_STEP, "backward": DEART_B5_STEP}, logs=logs,
         loss_rel_err_kernel_vs_plain=loss_rel, loss_rel_limit=TRAIN_LOSS_REL_LIMIT,
         grad_l2_rel_err_kernel_vs_plain=grad_l2, grad_l2_limit=TRAIN_GRAD_L2_LIMIT,
         grad_l2_rel_err_deart_leaves=grad_l2_deart, step_ms=step["median"], step_ms_min=step["min"],
         clips_per_s=CODEC_TRAIN_SHAPE[0] * 1e3 / step["median"], peak_device_memory_gib=peak,
         without_deart=base)
    return counts


def phase_timing_deform(device, counts_test, counts_train, worst):
    """B5 forward at the decode and training shapes and its backward at the
    training shape: ms beside the bound (for this run's offsets: 3 px, the
    de-artifact net's spread) and the plain version's ms. No single PyTorch
    call computes the function (torchvision is not installed): library_ms
    is null."""
    rng = np.random.default_rng(71)
    rows = []
    for shape, backward, launches in ((DEART_DEC_SHAPE, False, counts_test["b5"].get((DEART_C, DEART_C), 0)),
                                      (DEART_TRAIN_SHAPE, False, counts_train["forward"].get((DEART_C, DEART_C), 0)),
                                      (DEART_TRAIN_SHAPE, True, counts_train["backward"].get((DEART_C, DEART_C), 0))):
        x, off, mask, w, g = make_deform(rng, shape, DEART_C, DEART_C, device, spread=3.0)
        corners, _ = deform_tap_stats(off)
        iters = 10 if shape == DEART_DEC_SHAPE else 20
        with torch.no_grad():
            if backward:
                ms = time_cuda(lambda: df._backward_cuda(x, off, mask, w, g), iters=iters)
                plain = time_cuda(lambda: df.deform_conv2d_bwd_plain(x, off, mask, w, g), iters=5, warmup=1)
            else:
                ms = time_cuda(lambda: df._forward_cuda(x, off, mask, w), iters=iters)
                plain = time_cuda(lambda: df.deform_conv2d_plain(x, off, mask, w), iters=5, warmup=1)
        bound, by = deform_bound_ms(*shape, DEART_C, DEART_C, corners=corners, backward=backward)
        err = worst[(tuple(shape), DEART_C, DEART_C)]["backward" if backward else "forward"]
        rows.append({
            "name": f"deform_conv2d{'_bwd' if backward else ''}[{DEART_C}->{DEART_C}]@"
                    f"{'codec' if shape == DEART_DEC_SHAPE else 'codec_train'}",
            "route": "cuda", "source": SOURCE_DEFORM, "replaces": REPLACES_DEFORM, "launches": launches,
            "max_abs_err": err, "ms": ms["median"], "plain_ms": plain["median"], "bound_ms": bound,
            "bound_by": by, "library_ms": None, "ms_min": ms["min"], "plain_ms_min": plain["min"],
            "shape": list(shape) + [DEART_C], "corners_inside_per_tap": corners})
        del x, off, mask, w, g
    emit("timing_deform", rows=[{k: r[k] for k in ("name", "ms", "ms_min", "plain_ms", "bound_ms", "bound_by")}
                                for r in rows])
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated: kernels (build and check only), " + ", ".join(ALL_PHASES))
    want = set(ap.parse_args().phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    # fp32 references stay fp32: no TF32 in the library's convolutions or products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.time()
    build.build()
    for name in build.kernel_names():
        build.load(name)
    ptxas = [ln.split(":", 1)[1].strip() for name in build.kernel_names()
             for ln in build.build_log(name).splitlines() if "registers" in ln]
    emit("build", seconds=time.time() - t0, libraries=build.kernel_names(), ptxas=ptxas)

    kernels = []
    with torch.no_grad():
        worst = phase_kernels(device)
        worst_gc = phase_kernels_gc(device)
        worst_bwd = phase_kernels_bwd(device)
        worst_deform = phase_kernels_deform(device)
    worst_gc_bwd = phase_kernels_gc_bwd(device)
    phase_grad(device)
    if "serve" in want:
        with torch.no_grad():
            model, counts = phase_roundtrip(device)
            kernels += phase_timing(device, model, counts, worst)
        del model
    if "train" in want:
        trainer, recompute, counts, eps = phase_train(device)
        kernels += phase_timing_train(device, trainer, recompute, counts, worst_bwd, eps)
        del trainer, recompute
    base_codec = base_train = None   # the codec's numbers without the de-artifact net
    if "codec" in want:
        codec = phase_codec(device)
        with torch.no_grad():
            rows, base_codec = phase_timing_codec(device, *codec, worst_gc)
        kernels += rows
        del codec
    if "codec_train" in want:
        tree, batch, counts = phase_codec_train(device)
        rows, base_train = phase_timing_codec_train(device, tree, batch, counts, worst_gc_bwd)
        kernels += rows
        del tree, batch
    if "deart" in want:
        counts_test = phase_codec_deart(device, base_codec)
        counts_train = phase_codec_deart_train(device, base_train)
        kernels += phase_timing_deform(device, counts_test, counts_train, worst_deform)

    for k in kernels:
        check(k["launches"] >= 1, f"the main path launched {k['name']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if want != set(ALL_PHASES):
        print(f"chip_smoke: partial run ({sorted(want)}): no result line", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
