"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, then drives the three main
paths at full width: it serves a synthetic 10-frame clip at the Vid4 size
through the SelfC_GMM 4x net (``RescaleModel``: feed_data -> test(gop=7),
then downscale / upscale), it loads the trained checkpoint of runs/400k
(iter 164,339) through the port's own msgpack reader and measures its HR
and LR Y-PSNR / SSIM on the rendered synthetic val set (``cal_metric``, fp32
and bf16, two sample seeds each; the checkpoint written back, its Adam state
resumed for one step), it trains the same net for a few steps at the
batch of the published training config (``optimize_parameters`` on 8 clips
of 7 frames, 144 x 144), and it runs the compression eval of the published
SelfC_GMM_Codec net (``CodecModel``: feed_data -> test() on a synthetic
13-frame clip at the UVG size 1080 x 1920, through the host's x265 or the
zlib stand-in), it trains that codec net with its surrogate
(``optimize_parameters`` on the published batch of 12 clips of 3 frames,
144 x 144), and it runs the codec's eval and training step again with the
de-artifact net (``network_G.deart_net``, whose deformable conv is kernel B5),
and it serves a GOP through and trains one step of the SelfC_GMM 4x net
again with each of the subnet types whose chains reach the standalone
temporal conv (kernel B6), and it serves a GOP and trains the published 4x
net once more with the opt-in chain schedules (``network_G.chain_variants:
[hg, ride, v3]``: kernels B7, B9 and B8 carry all 54 chains of a roundtrip),
and it serves a GOP through and trains the Haar-pyramid SelfC 4x net
(model type SelfC: B1 at rows of 9 and 45 channels, B3, B2, B6) and runs the
IRN x4 net on a DIV2K-size image (model type IRN: B4 on 4-D images).
Both training steps run W-packed, as by default (``network_G.pack_w``: every
chain of the 4x step as 2 rows of 4 images at stripe 36, the codec's coupling
and prior chains 2 to a row at stripe 72, B1, B3 and B2 with their stripe
masks), and once more with ``pack_w: false``, timed beside it in turns.
The codec's training step also runs pipelined (``train.codec_pipeline``),
timed in turns with the serial one. The 4x net trains once more with
``network_G.remat`` (the same bits, less memory), and with the adversarial
branch of ``train_rescaling_gan.yml`` (D and VGG-19 on seeded random weights:
'ragan' with the feature loss, 'gan', 'lsgan', 'wgan-gp'); SpyNet and the BPG
bridge run once. Every training step runs under cuDNN's deterministic
algorithms, as the models run it, and is timed beside the other algorithms.
Last, the port's entry points run as a user runs them, each a subprocess:
``python -m selfc_tpu_torch.cli.train`` resumes the 400k run of runs/400k for
200 steps on its rendered train set packed in memory, and trains the GAN
YAML for 10 steps and resumed to 20, ``cli.test_rescaling`` measures the
committed and the written checkpoint, ``cli.test_compression`` runs the codec
eval (each logs its device seconds a clip, ``gpu_test_s``). Then the profiler:
``cli.train`` resumes the 400k run for 12 steps with ``--profile-at`` (a
``torch.profiler`` trace of 3 packed steps), and ``utils/profile.py:trace``
wraps 3 GOP roundtrips in this process; each trace is split by kernel
(``tools/profile_step.py``), its kernel events held to the wrappers' calls.
The ``mesh`` phase runs the device mesh on two positions (two cards, or the
first card twice): ``test()`` over dp rows, and the image width split
(``mesh_sp``) of the 4x net's step and GOP, of the codec's training step
(with its surrogate, with the de-artifact net, through the host codec) and
of the Haar net's step and GOP, each against one position.
The ``procs`` phase trains across processes: two ranks (NCCL on two cards,
else gloo with both on the first card), each on half of the batch, take the
4x packed step, the codec's serial step and the GAN step, held against one
process's step on the whole batch.
It times the kernels beside their roofline bound.
Prints one JSON line per phase; any failure exits non-zero. There is no CPU
fallback: without a CUDA device the script fails at once.

``--phases serve,quality,train,codec,codec_train,deart,subnets,haar,variants,gan,mesh,procs,cli,profile`` (the default) picks
the paths; ``--phases kernels`` only builds the kernels and checks them
against their plain versions. ``--parent DIR`` (a checkout of another commit
whose kernels have the same C interfaces, or its ``selfc_tpu_torch/csrc``
alone under that path) builds that tree's kernels too and times the B2,
B5 and B7 rows, both training steps and the variants' roundtrip and step with
its kernels and with this tree's in turns (theirs, ours, ours, theirs); B5's
backward through the parent's own C interface.

Last lines of the output: a ``{"kernels": [...]}`` object, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import ctypes
from collections import Counter
import json
import os
from pathlib import Path
import re
import shutil
import string
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from selfc_tpu_torch.codec import bpg, h265
from selfc_tpu_torch.codec.pipeline import seg_add_pad
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.data.packed import write_packed
from selfc_tpu_torch.eval.rescaling import cal_metric
from selfc_tpu_torch.kernels import build
from selfc_tpu_torch.models import define_G
from selfc_tpu_torch.models.spy_flow import MESpynet
from selfc_tpu_torch.ops import chain_variants as cv
from selfc_tpu_torch.ops import deform as df
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.ops import temporal_conv as tc
from selfc_tpu_torch.models.agg import GlobalAgg
from selfc_tpu_torch.models.blocks import D2DT, DenseBlock2D
from selfc_tpu_torch.models.stp import _PW
from selfc_tpu_torch.ops.conv import conv2d, pointwise
from selfc_tpu_torch.ops.quantize import quantize_ste
from selfc_tpu_torch.ops.resize import adaptive_avg_pool2d
from selfc_tpu_torch.parallel import spatial
from selfc_tpu_torch.parallel.mesh import Replicas, make_mesh
from selfc_tpu_torch.tools import profile_step
from selfc_tpu_torch.tools.make_synth_data import render_clip, render_val_set, to_uint8
from selfc_tpu_torch.tools.precision_delta import quality_options
from selfc_tpu_torch.train import checkpoint
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.train import losses
from selfc_tpu_torch.train.gan import flat_frames
from selfc_tpu_torch.train.rescale_model import RescaleModel, clip_by_global_norm_, make_degrade, step_algorithms
from selfc_tpu_torch.utils.bench import (
    CLIP_HW, CODEC_DEC_SHAPE, CODEC_ENC_SHAPE, CODEC_TRAIN_LAT, CODEC_TRAIN_SHAPE, CODEC_WIDTHS,
    DEART_C, DEART_DEC_SHAPE, DEART_TRAIN_SHAPE, PATH_WIDTHS, SERVE_SHAPE, STP_DEFORM_C,
    STP_DEFORM_SHAPE, SURROGATE_C, TRAIN_SHAPE, UVG_HW, chain_bound_ms, chain_bwd_bound_ms,
    chain_feats_bound_ms, deform_all_to_one, deform_bound_fma_ms, deform_bound_ms, deform_tap_stats, hg_bound_ms,
    hg_bwd_bound_ms, make_chain, make_deform,
    make_temporal_conv, tc_peak, temporal_conv_bound_ms, time_cuda)
from selfc_tpu_torch.utils.jax_import import export_jax_params, flatten_tree, load_jax_params
from selfc_tpu_torch.utils.metrics import psnr, rgb_to_ycbcr
from selfc_tpu_torch.utils.profile import TRACE_FILE, StepTimer, launch_counts
from selfc_tpu_torch.utils.profile import trace as profile_trace

CHECK_WIDTHS = ((3, 48), (48, 3), (64, 64))           # coupling F/H/G and the prior
CHECK_SHAPE = (1, 3, 40, 52)     # odd sizes on purpose
BLOCK_NUM, STP_BLK_NUM = [4, 4], 6   # the full depth of the published model
FP32_LIMIT = 1e-4                # different summation order of the same fp32 products
BF16_REL_LIMIT = 3e-2            # relative to max |ref|: bf16 keeps 8 bits of mantissa
HR_LIMIT = 1e-3                  # kernel path against plain path through 16 coupling blocks
TC_PEAK = tc_peak(torch.float32)  # the fp32 chain kernels' products: 3xTF32 on the tensor cores
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
NAN_FEATS_GC = (12, 24, 32)       # growth widths of the NaN-prefilled feats check
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
# (shape, C, Cout) of the check whose every tap samples next to one pixel
# (utils/bench.py:deform_all_to_one): four pixels take 9 N H W contributions to dx
DEFORM_ALL_TO_ONE = ((2, 24, 32), 32, 32)
DEART_OFFSET_STD = 2.0           # px: the de-artifact net's seeded offsets are scaled to this spread
# launches of the de-artifact net: B5 9 a decode call (3 output frames x 3
# pairs), so 18 a test() and 9 each way a training step; B1 one 3->32 and one
# 32->3 chain a decode call
DEART_B5_TEST, DEART_B5_STEP = 18, 9
DEART_B1_DECODE = {(3, 32, 32): 1, (32, 3, 32): 1}
# B6, the standalone (3,1,1) temporal conv
SOURCE_TC = "selfc_tpu_torch/csrc/temporal_conv.cu"
REPLACES_TC = "selfc_tpu/ops/pallas_kernels.py:109"
# (shape, C, Co) of its checks: a ragged H*W with T 3, T 1, and the widths of
# the nets' (3,1,1) convs: D2DLT's and D2DTEnhance's conv5 / conv51 (G/H
# 131 -> 48, F 176 -> 3) and FeatureCollapseFast's (G/H 432 -> 768, F 1152 -> 48)
TC_CHECKS = (((1, 3, 5, 7), 131, 48), ((2, 1, 6, 10), 176, 3), ((1, 3, 9, 11), 432, 768),
             ((2, 3, 4, 6), 1152, 48))
# more (shape, C, Co) for the tile paths (each run unsplit and as this card's
# plan splits it): 131 -> 48 over several blocks, the narrow tile 16 wide at
# an odd bf16 width, T 130 (over the wide tile's 128 rows: runs of frames
# with the frames beside them staged) and T 300 (the narrow tile's 256)
TC_PATH_CHECKS = (((1, 7, 12, 20), 131, 48), ((1, 3, 10, 12), 41, 16), ((1, 130, 2, 3), 20, 24),
                  ((1, 300, 1, 2), 36, 3))
# the published SelfC_GMM with the subnet types whose chains reach B6
SUBNET_TYPES = ("D2DLTInput", "FeatureCalapseBlock_Fast", "D2DTEnhanceInput")
# (C, Co) of B6 in each: coupling G/H and F; and the frames' shrink (the
# collapse block's space-to-depth)
SUBNET_TC = {"D2DLTInput": (((131, 48), (176, 3)), 1),
             "FeatureCalapseBlock_Fast": (((432, 768), (1152, 48)), 4),
             "D2DTEnhanceInput": (((131, 48), (176, 3)), 1)}
# kernel path against the plain path (B1-B4 and B6 plain), relative l2
SUBNET_REL_L2_LIMIT = 1e-4
# B7-B9, the opt-in chain schedules (network_G.chain_variants)
VARIANTS = ["hg", "ride", "v3"]
SOURCE_HG = "selfc_tpu_torch/csrc/chain_hg.cu"
SOURCE_RIDE = "selfc_tpu_torch/csrc/chain_ride.cu"
SOURCE_V3 = "selfc_tpu_torch/csrc/chain_v3.cu"
REPLACES_HG = "selfc_tpu/ops/pallas_chain.py:1248"
REPLACES_RIDE = "selfc_tpu/ops/pallas_chain.py:1523"
REPLACES_V3 = "selfc_tpu/ops/pallas_chain.py:890"
# (shape, C, c_out, gc) of the checks: B7 at the serving and training latents
# of the 4x pair, ragged H and W with the codec's c_out 12 and with growth 12;
# B9 with every epilogue at c_out 3, 6, 10 and at T 1; B8 at the 4x prior's
# widths and the codec prior's growth 12
HG_CHECKS = ((SERVE_SHAPE, 3, 48, 32), (TRAIN_SHAPE, 3, 48, 32), (CHECK_SHAPE, 3, 12, 32), (CHECK_SHAPE, 3, 48, 12))
RIDE_CHECKS = ((CHECK_SHAPE, 48, 3, 32), (CHECK_SHAPE, 48, 6, 32), (CHECK_SHAPE, 48, 10, 32), ((2, 1, 20, 26), 48, 3, 32))
# B8 also at C + 3 gc over 526 (the earlier design's limit) with conv5 on the
# narrow 8-column tile, and at an odd C with conv5 16 wide
V3_CHECKS = ((CHECK_SHAPE, 3, 64, 32), (CHECK_SHAPE, 64, 64, 32), (CHECK_SHAPE, 24, 24, 12),
             (CHECK_SHAPE, 440, 8, 32), (CHECK_SHAPE, 5, 16, 20))
# calls of one GOP roundtrip of the published 4x net with all three: the pair
# 8 forward (encode) + 8 reverse (decode), F 16 times on the ride, the prior's
# 6 chains on v3, B1 none
VARIANT_LAUNCHES = {"hg": {(3, 48, 32, "forward"): 8, (3, 48, 32, "reverse"): 8},
                    "ride": {(48, 3, 32): 16}, "v3": {(3, 64, 32): 1, (64, 64, 32): 5}}
# W-packing (network_G.pack_w, on by default): the 4x training latent (8, 36
# wide) runs every chain as 2 rows of 4 images, stripe 36; the codec's (12, 72
# wide) its coupling and prior chains as 6 rows of 2, stripe 72
TRAIN_STRIPE, CODEC_STRIPE = TRAIN_SHAPE[3], CODEC_TRAIN_LAT[3]
TRAIN_P = dc.pick_pack_w(TRAIN_SHAPE[0], TRAIN_STRIPE)
CODEC_P = dc.pick_pack_w(CODEC_TRAIN_LAT[0], CODEC_STRIPE)
TRAIN_PACKED = (TRAIN_SHAPE[0] // TRAIN_P, *TRAIN_SHAPE[1:3], TRAIN_P * TRAIN_STRIPE)
CODEC_PACKED = (CODEC_TRAIN_LAT[0] // CODEC_P, *CODEC_TRAIN_LAT[1:3], CODEC_P * CODEC_STRIPE)
# (packed shape, stripe, C, c_out, gc) of the stripe checks: the 4x step's
# widths, the codec coupling's at gc 32 and its prior's at gc 12
STRIPE_CHECKS = (tuple((TRAIN_PACKED, TRAIN_STRIPE, C, c_out, 32) for C, c_out in PATH_WIDTHS)
                 + tuple((CODEC_PACKED, CODEC_STRIPE, C, c_out, gc) for C, c_out, gc in CODEC_WIDTHS))
# limits of a packed step against the unpacked one (the whole gradient,
# relative l2): the same products, the weight gradient's sums over other tiles
PACK_GRAD_L2_LIMIT = 1e-5
# the first quality number: the trained SelfC_GMM of runs/400k (iter
# 164,339) on the synthetic val set (4 clips of 7 frames, 576 x 704, seed 7)
ROOT = Path(__file__).resolve().parent
QUALITY_CKPT = "runs/400k/latest_G.msgpack"
QUALITY_STATE = "runs/400k/latest.state"
QUALITY_LEAVES = 354
QUALITY_SEEDS = (0, 1)           # val.sample_seed: the GMM prior's noise at decode
# fp32 floors, dB: a wrong load, or one that misses leaves, lands near 30;
# the JAX run's last three validations read 55.64-55.95 (runs/400k/train_loop.log)
QUALITY_HR_MIN, QUALITY_LR_MIN = 55.0, 52.0
QUALITY_PATH_LIMIT = 0.005       # dB: kernel path against plain path on clip 0, one lr and eps
# JAX on a TPU (runs/400k/precision_r05.log, tools/precision_delta.py): HR
# PSNR / SSIM, LR PSNR / SSIM. Its "float32" row ran the convs at the TPU's
# default precision, bf16 operands: a neighbour, not an oracle.
QUALITY_TPU_ROWS = {"float32": (55.9950, 0.998962, 52.9436, 0.998103),
                    "bfloat16": (55.6375, 0.998702, 51.5949, 0.997756)}
N_PIPE_STEPS = 4                 # timed steps of each turn of the pipelined codec step (after 1 warm-up)
CLI_NAME = "SelfC_large_GMM_400k"
CLI_TRAIN_YML = "selfc_tpu/configs/train/train_rescaling_400k_packed.yml"
CLI_CODEC_YML = "selfc_tpu/configs/test/test_codec_uvg_bf.yml"
CLI_TRAIN_SET = {"clips": 48, "frames": 20, "h": 208, "w": 208, "seed": 0}   # tools/train400k_loop.sh:129-130, 240 clips cut to 48
CLI_VAL_SET = {"clips": 4, "frames": 7, "h": 576, "w": 704, "seed": 7}      # tools/train400k_loop.sh:136-137
CLI_CODEC_SET = {"clips": 2, "frames": 5, "h": 256, "w": 256, "seed": 13}   # MS-SSIM needs 176 px
CLI_RESUME_ITER = 164339
CLI_STEPS = 200
CLI_PRINT_FREQ = 50
CLI_WORKERS = 6                  # loader threads (the YAML's 3; the card's machine has 8 cores)
CLI_RNG_SEED = 0                 # the items' crops and flips keyed by (seed, epoch, index): calls repeat
CLI_QUALITY = {"hr": (55.7945, 1e-3), "lr": (53.0392, 1e-4)}   # fp32 seed 0 on the card (PERF.md §2)
# the written checkpoint (iter 164,539), fp32 seed 0: seeded items repeat the
# run bit for bit (55.228582 dB in four runs on one H100, PERF.md §2); the
# bf16 training costs the fp32 eval 0.57 dB, fp32 training gains 1.1
CLI_TRAINED_HR = (55.2286, 0.1)
# 11 steps in (iter 164,350): 55.19 dB with Adam's state restored, 54.16
# without it (the fresh moments' first steps are ~lr x sign(g))
CLI_EARLY_ITER, CLI_EARLY_HR_MIN = 164350, 54.7
CLI_LOSS_RANGES = {"l_back_rec": (1.5e-3, 5e-3), "l_forw_fit": (2e-5, 1.3e-4)}
CLI_TIMEOUT = 600
# the Haar-pyramid nets: SelfC 4x (model type SelfC) with the factory's
# defaults (D2DTNet, block_num [4, 4], the STPNetSmall prior conditioned by
# D2DT chains, stp_temporal_c 32, a 5-component GMM), and IRN x4 (model type
# IRN) at the upstream IRN repo's widths (train_IRN_x4.yml: DBNet, [8, 8])
HAAR_NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [4, 4], "scale": 4, "init": "xavier",
            "stp_temporal_c": 32, "fh_loss": "gmm", "gmm_mixture_num": 5, "condition_func": "D2DTNet"}
HAAR_N_PARAMS = 2_215_699
IRN_NET = {"which_model_G": {"subnet_type": "DBNet"}, "block_num": [8, 8], "scale": 4, "init": "xavier"}
IRN_N_PARAMS = 4_355_136
IRN_IMAGE = (1, 1356, 2040, 3)   # a DIV2K validation image
# the Haar net's latents by level (1: 12 channels at half size, 2: 48 at a
# quarter, where the prior runs too) for one GOP at the Vid4 size and for the
# published training batch
HAAR_SERVE = {1: (1, 7, CLIP_HW[0] // 2, CLIP_HW[1] // 2), 2: SERVE_SHAPE}
HAAR_TRAIN = {1: (8, 7, 2 * TRAIN_SHAPE[2], 2 * TRAIN_SHAPE[3]), 2: TRAIN_SHAPE}
# (C, c_out, level) of its chains: the coupling's F and H / G at each level,
# then the prior's four
HAAR_WIDTHS = ((9, 3, 1), (3, 9, 1), (45, 3, 2), (3, 45, 2), (3, 12, 2), (12, 24, 2), (24, 48, 2), (48, 32, 2))
HAAR_BLOCKS = 4                  # coupling blocks a level
# chain calls: an encode runs three a block, a decode the prior's four and
# three a block
HAAR_ENC, HAAR_DEC = 3 * 2 * HAAR_BLOCKS, 4 + 3 * 2 * HAAR_BLOCKS
# the IRN's levels (H, W of the image's half and quarter) and its B4 calls'
# (C, level): F's input, G's and H's
IRN_LEVELS = {1: (IRN_IMAGE[1] // 2, IRN_IMAGE[2] // 2), 2: (IRN_IMAGE[1] // 4, IRN_IMAGE[2] // 4)}
IRN_WIDTHS = ((9, 1), (3, 1), (45, 2), (3, 2))
INV_LIMIT = 1e-4                 # decode with the true HF against the input, fp32
# the adversarial branch of train_rescaling_gan.yml: 'ragan' with the
# feature loss (VGG-19 to conv5_4), D discriminator_vgg_128 at nf 64; random
# weights from a numpy seed (no VGG-19 ImageNet weights in the repository)
GAN_YML = "selfc_tpu/configs/train/train_rescaling_gan.yml"
GAN_TRAIN = {"gan_type": "ragan", "gan_weight": 5e-3, "feature_weight": 1.0, "feature_criterion": "l1",
             "lr_D": 1e-4, "beta1_D": 0.9, "beta2_D": 0.999, "D_update_ratio": 1, "D_init_iters": 0}
NETWORK_D = {"which_model_D": "discriminator_vgg_128", "in_nc": 3, "nf": 64}
GAN_OTHER_TYPES = ("gan", "lsgan", "wgan-gp")    # one step each besides 'ragan''s
N_GAN_STEPS = 2                  # 'ragan' steps on the main path (steps 1 and 2: step 0 gates G)
GAN_GRAD_L2_LIMIT = 1e-4         # G's and D's whole gradient, kernel path against plain path
GAN_STATS_L2_LIMIT = 1e-4        # D's running statistics after the step, the same
GAN_CLI_STEPS, GAN_CLI_SAVE = 20, 10   # cli.train on the GAN YAML: a save at 10, resumed from it to 20
# the device mesh (parallel/mesh.py): eval split over the dp rows, the image
# width split over a row's cards (mesh_sp, parallel/spatial.py)
MESH_GOP_BATCH = 2               # 10 frames, gop 7: one call of 2 GOP groups, split 1 + 1 over dp 2
# dp 2 against dp 1, max abs of HR / LR / latents / sample: measured 7.2e-7 (HR).
# The encode is the same bits; in the decode only GlobalAgg's attention (its
# cuBLAS products, whose kernel depends on the batch: 1.5e-8..3e-8) differs
# between a GOP group decoded alone and beside another (eval_dp_batch_dependence)
MESH_DP_LIMIT = 1e-6
MESH_SP_Y_LIMIT = 1e-4           # sp 2 against sp 1: the encode's latent, max abs
MESH_SP_HR_LIMIT = HR_LIMIT      # sp 2 against sp 1: HR decoded from one lr and eps, max abs
MESH_LOSS_REL_LIMIT = 1e-5       # sp 2 against sp 1: the step's loss, relative
MESH_GRAD_L2_LIMIT = 1e-4        # ... the whole gradient, relative l2 (TRAIN_GRAD_L2_LIMIT)
MESH_GRAD_REL_LIMIT = 1e-3       # ... each parameter's gradient, relative l2 (zero-by-construction ones out)
# ... each parameter's update, relative l2: Adam's first update is ~lr * sign(g),
# so an element whose gradient is at rounding level may move the other way
MESH_UPDATE_L2_LIMIT = 1e-2
MESH_GUARD_LIMIT = 1e-4          # a wrapper on cuda:1 against its plain version there, of max |ref|
# the width split of the codec and Haar nets: the Haar step with its prior's
# NLL weighted in, so that the split's NLL sum is held too
MESH_HAAR_TRAIN = {"lambda_cond_prob": 0.01}
MESH_TIMED_STEPS = 3             # CUDA-event steps (after one warm-up) of each split and unsplit step
MESH_OPT_TIMED_STEPS = 2         # ... of the options' steps (mesh_opts)
# the subnet families of the split's plain coupling and the batch each takes:
# the published batch, 160 wide for the collapse block (its shards on a
# 16-column grid), 640 x 128 for HighOrderTNet (80 LR columns of halo a
# shard, LR rows a multiple of its 8-row grid; the batch cut to 2 clips)
MESH_FAMILIES = {"D2DLTInput": (8, 7, 144, 144, 3), "FeatureCalapseBlock_Fast": (8, 7, 144, 160, 3),
                 "D2DTEnhanceInput": (8, 7, 144, 144, 3), "HighOrderTNet": (2, 7, 128, 640, 3)}
ALL_PHASES = ("serve", "quality", "train", "codec", "codec_train", "deart", "subnets", "haar", "variants", "gan",
              "mesh", "procs", "cli", "profile")


# {library name: path} built from --parent's sources; empty: no comparison
PARENT_LIBS: dict = {}


def build_parent(parent):
    """Build every ``selfc_tpu_torch/csrc/*.cu`` of the checkout ``parent``
    (against its own headers) into ``build/parent/``, one nvcc a source,
    side by side."""
    src = Path(parent) / "selfc_tpu_torch" / "csrc"
    out = build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {cu.stem: (out / f"lib{cu.stem}.so", subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", str(out / f"lib{cu.stem}.so"), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for cu in sorted(src.glob("*.cu"))}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc for the parent's {name}.cu:\n{log}")
        check(name in build.kernel_names(), f"the parent's {name}.cu has no counterpart here")
        PARENT_LIBS[name] = lib


@contextlib.contextmanager
def parent_tree(on):
    """Inside (``on``): the parent tree's kernels in place of this tree's
    (but B5's, whose backward's C interface changed: ``ParentDeform`` calls it)."""
    names = [n for n in PARENT_LIBS if n != "deform"]
    if on:
        for name in names:
            build.use_library(name, PARENT_LIBS[name])
    try:
        yield
    finally:
        for name in names:
            build.use_library(name)


class ParentDeform:
    """The parent tree's B5 through its own C interface (the forward's is
    this tree's; its backward took an fp32 dx zeroed by the caller, into which
    it added, and one scratch of partial sums over 64-pixel tiles)."""

    def __init__(self, path):
        P, I = ctypes.c_void_p, ctypes.c_int
        self.lib = ctypes.CDLL(str(path))
        self.lib.selfc_deform_forward.argtypes = [P] * 5 + [I] * 6 + [P]
        self.lib.selfc_deform_backward.argtypes = [P] * 10 + [I] * 7 + [P]

    def forward(self, x, off, mask, w):
        N, H, W, C = x.shape
        out = torch.empty((N, H, W, w.shape[-1]), dtype=x.dtype, device=x.device)
        err = self.lib.selfc_deform_forward(x.data_ptr(), off.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
                                            N, H, W, C, w.shape[-1], dc._DTYPE_CODE[x.dtype], dc._stream(x))
        check(err == 0, f"the parent's B5 forward: error {err}")
        return out

    def backward(self, x, off, mask, w, g):
        N, H, W, C = x.shape
        c_out = w.shape[-1]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        doff, dmask, dw = (torch.empty_like(t) for t in (off, mask, w))
        groups = max(1, min(264, -(-N * H * W // 64)))   # the parent wrapper's rule
        partial = torch.empty(groups * 9 * C * c_out, dtype=torch.float32, device=x.device)
        err = self.lib.selfc_deform_backward(
            x.data_ptr(), off.data_ptr(), mask.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(), doff.data_ptr(),
            dmask.data_ptr(), dw.data_ptr(), partial.data_ptr(), groups, N, H, W, C, c_out, dc._DTYPE_CODE[x.dtype],
            dc._stream(x))
        check(err == 0, f"the parent's B5 backward: error {err}")
        return dx.to(x.dtype), doff, dmask, dw


def in_turns(this, parent, iters):
    """Median ms of two callables in turns (parent, this, this, parent)."""
    out = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        out[who].append(time_cuda(parent if who == "parent" else this, iters=iters, warmup=1)["median"])
    return out


def against_parent(fn, iters=5):
    """Median ms of ``fn()`` with the parent tree's kernels and with this
    tree's in turns (parent, this, this, parent): ``{"parent": [..],
    "this": [..]}``; None without ``--parent``."""
    if not PARENT_LIBS:
        return None
    out = {"parent": [], "this": []}
    for on in (True, False, False, True):
        with parent_tree(on):
            out["parent" if on else "this"].append(time_cuda(fn, iters=iters, warmup=1)["median"])
    return out


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
    """Route the models' kernel calls (the whole chain, the v1 spatial chain,
    the deformable conv, the temporal conv and the chain variants) to the
    plain versions, for comparison."""
    kernels = (dc.dense_chain_t_ep, dc.fused_dense_spatial, df.deform_conv2d, tc.temporal_conv3_fused,
               cv.fused_hg_pair, cv.dense_chain_ride, cv.dense_chain_v3)
    dc.dense_chain_t_ep = lambda *a, save_feats=True, launch=None, stripe=0, pack=False, **kw: (
        dc.dense_chain_t_ep_plain(*a, stripe_w=stripe, **kw))
    dc.fused_dense_spatial = dc.fused_dense_spatial_plain
    df.deform_conv2d = df.deform_conv2d_plain
    tc.temporal_conv3_fused = tc.temporal_conv3_fused_plain
    cv.fused_hg_pair = cv.fused_hg_pair_plain
    cv.dense_chain_ride = cv.dense_chain_ride_plain
    cv.dense_chain_v3 = cv.dense_chain_v3_plain
    try:
        yield
    finally:
        (dc.dense_chain_t_ep, dc.fused_dense_spatial, df.deform_conv2d, tc.temporal_conv3_fused,
         cv.fused_hg_pair, cv.dense_chain_ride, cv.dense_chain_v3) = kernels


def seeded_tree(net, seed):
    """Random parameters from a numpy seed, every leaf non-zero (conv5 and
    ``early_3d_layer`` too, which init to zero). The last conv of the
    coupling subnets (conv5, D2DTEnhance's conv6) is scaled down so the
    latents stay of order one through eight blocks."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in net.named_parameters():
        if p.dim() == 1:
            std = 0.05
        else:
            std = float(np.prod(p.shape[:-1])) ** -0.5
            if name.startswith(("inv_blocks", "level_blocks")) and (".conv5." in name or ".conv6." in name):
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


def network_g(subnet_type="D2DTNet"):
    """The published net's ``network_G`` with ``which_model_G.subnet_type``
    set to ``subnet_type``."""
    return {**NETWORK_G, "which_model_G": {"subnet_type": subnet_type}}


def serve_options(network=NETWORK_G, **val):
    return dict_to_nonedict({"model": "SelfC_GMM", "scale": 4, "val": val, "network_G": network})


def train_options(network=NETWORK_G, **train):
    """The options of the published training config
    (selfc_tpu/configs/train/train_rescaling_selfc_large.yml), built here."""
    return dict_to_nonedict({
        "model": "SelfC_GMM", "scale": 4, "distortion": "sr_bd", "is_train": True,
        "datasets": {"train": {"video_len": 7, "batch_size": 8, "GT_size": 144}},
        "network_G": network,
        "train": {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "warmup_iter": -1,
                  "lr_scheme": "MultiStepLR", "lr_steps": [100000, 200000, 300000], "lr_gamma": 0.5,
                  "pixel_criterion_forw": "l2", "pixel_criterion_back": "l1",
                  "lambda_cond_prob": 0, "lambda_fit_forw": 1, "lambda_rec_back": 1,
                  "weight_decay_G": 1e-14, "gradient_clipping": 10, **train},
    })


def serve_clip(frames=10, seed=1):
    """A smooth synthetic (1, frames, 576, 704, 3) clip in [0,1]: a
    low-frequency pattern plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, CLIP_HW[0]), np.linspace(0, 1, CLIP_HW[1]), indexing="ij")
    pattern = [0.5 + 0.3 * np.sin(6 * xx + 0.3 * t)[..., None] * np.cos(4 * yy + 0.2 * t)[..., None]
               * np.array([1.0, 0.8, 0.6]) for t in range(frames)]
    clip = np.clip(np.stack(pattern)[None] + rng.normal(0, 0.02, (1, frames, *CLIP_HW, 3)), 0, 1)
    return clip.astype(np.float32)


def phase_roundtrip(device):
    """Full-width serve of two GOP requests, then one downscale and one
    upscale request; the launch counts of exactly these calls are kept."""
    clip = serve_clip()

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


def y_psnr(a, b):
    """cal_metric's "Y" PSNR of (B, T, H, W, 3) clips: the mean over frames
    of the YCbCr PSNR."""
    flat = lambda v: torch.as_tensor(v).reshape(-1, *v.shape[2:])  # noqa: E731
    return psnr(rgb_to_ycbcr(flat(a)), rgb_to_ycbcr(flat(b))).mean().item()


def phase_quality(device):
    """The first quality numbers of the port: iter 164,339 loaded through
    the stdlib msgpack reader into ``RescaleModel``, ``cal_metric`` over the
    rendered val set in fp32 and bf16, each with two sample seeds; on clip
    0 the kernel path against the plain path from one lr and eps; the
    checkpoint written and read back; ``latest.state`` restored into a
    trainer on the card for one step."""
    out_dir = ROOT / "chiprun_out" / "quality"
    t0 = time.time()
    flat = flatten_tree(checkpoint.read_msgpack(str(ROOT / QUALITY_CKPT)))
    read_s = time.time() - t0
    check(len(flat) == QUALITY_LEAVES, f"{QUALITY_CKPT} holds {len(flat)} leaves")
    t0 = time.time()
    clips = list(render_val_set())
    render_s = time.time() - t0
    rows, models = {}, {}
    # ---- the main path: counts set to 0 just before, read just after ----
    dc.reset_launch_counts()
    for dtype in ("float32", "bfloat16"):
        for seed in QUALITY_SEEDS:
            model = RescaleModel(quality_options(str(ROOT / QUALITY_CKPT), dtype, seed), device=device)
            t0 = time.time()
            metrics = cal_metric(clips, model, str(out_dir), save_images=False)
            rows[dtype, seed] = {"s": time.time() - t0, "hr_psnr": metrics[0], "hr_ssim": metrics[1],
                                 "lr_psnr": metrics[2], "lr_ssim": metrics[3]}
            models[dtype, seed] = model
    counts = {"total": dc.launches, "by_width": {str(k): n for k, n in dc.launches_by_width.items()}}
    # ---------------------------------------------------------------------
    check(counts["total"] == len(rows) * len(clips) * (6 * sum(BLOCK_NUM) + STP_BLK_NUM),
          f"B1 calls of {len(rows)} evals of {len(clips)} one-GOP clips: {counts}")
    for (dtype, seed), model in models.items():
        check(all(np.array_equal(p.detach().cpu().numpy(), flat[k]) for k, p in model.net.named_parameters()),
              f"every parameter is the checkpoint's array bit for bit ({dtype}, seed {seed})")
    for dtype in QUALITY_TPU_ROWS:
        a, b = rows[dtype, QUALITY_SEEDS[0]], rows[dtype, QUALITY_SEEDS[1]]
        check(a["lr_psnr"] == b["lr_psnr"] and a["lr_ssim"] == b["lr_ssim"],
              f"the LR does not depend on the sample seed ({dtype}): {a} {b}")
    for seed in QUALITY_SEEDS:
        r = rows["float32", seed]
        check(r["hr_psnr"] >= QUALITY_HR_MIN and r["lr_psnr"] >= QUALITY_LR_MIN,
              f"fp32 HR >= {QUALITY_HR_MIN} dB and LR >= {QUALITY_LR_MIN} dB (seed {seed}): {r}")
    spread = {dtype: {k: max(rows[dtype, s][k] for s in QUALITY_SEEDS) - min(rows[dtype, s][k] for s in QUALITY_SEEDS)
                      for k in ("hr_psnr", "hr_ssim", "lr_psnr", "lr_ssim")} for dtype in QUALITY_TPU_ROWS}

    # clip 0: the kernel path against the plain path, one lr and one eps
    model = models["float32", QUALITY_SEEDS[0]]
    gt = clips[0]["GT"]
    with torch.no_grad():
        lr_ref = model.degrade(torch.from_numpy(gt).to(device)).cpu().numpy()
    lr_k = model.downscale(gt)
    model.generator.manual_seed(9)
    hr_k = model.upscale(lr_k)
    with plain_chain_on_card():
        before = dc.launches
        lr_p = model.downscale(gt)
        model.generator.manual_seed(9)
        hr_p = model.upscale(lr_k)
        check(dc.launches == before, "the plain path launches no kernel")
    path_rows = {"hr_psnr_kernel": y_psnr(hr_k, gt), "hr_psnr_plain": y_psnr(hr_p, gt),
                 "lr_psnr_kernel": y_psnr(lr_k, lr_ref), "lr_psnr_plain": y_psnr(lr_p, lr_ref)}
    for part in ("hr", "lr"):
        gap = abs(path_rows[f"{part}_psnr_kernel"] - path_rows[f"{part}_psnr_plain"])
        check(gap <= QUALITY_PATH_LIMIT, f"clip 0 {part.upper()} Y-PSNR: kernel path within "
              f"{QUALITY_PATH_LIMIT} dB of the plain path: {path_rows}")

    # the checkpoint written by the port and read back
    saved = checkpoint.save_network(export_jax_params(model.net), str(out_dir), "roundtrip")
    back = flatten_tree(checkpoint.load_network(saved, export_jax_params(model.net)))
    check(all(np.array_equal(back[k], v) for k, v in flat.items()), "save_network then load_network: the same bits")
    same_file = Path(saved).read_bytes() == (ROOT / QUALITY_CKPT).read_bytes()
    del models, model

    # latest.state into a trainer on the card, one step on a rendered batch
    trainer = RescaleModel(dict_to_nonedict({**train_options(), "path": {
        "pretrain_model_G": str(ROOT / QUALITY_CKPT)}}), device=device)
    payload = trainer.resume_training(str(ROOT / QUALITY_STATE))
    steps = {float(st["step"]) for st in trainer.optimizer.state.values()}
    on_card = all(st["exp_avg"].device.type == "cuda" and st["exp_avg_sq"].device.type == "cuda"
                  for st in trainer.optimizer.state.values())
    check(len(trainer.optimizer.state) == QUALITY_LEAVES and len(steps) == 1 and on_card,
          f"Adam's moments restored on the card for every parameter, one step {steps}")
    B, T, S = TRAIN_SHAPE[0], TRAIN_SHAPE[1], 4 * TRAIN_SHAPE[2]
    batch = np.concatenate([c["GT"] for c in render_val_set(clips=B, frames=T, h=S, w=S, seed=164339)])
    trainer.feed_data({"GT": batch})
    trainer.optimize_parameters(trainer.start_iter)
    log = dict(trainer.get_current_log())
    check(np.isfinite(log["loss"]) and log["skipped_nonfinite"] == 0.0, f"the resumed step's loss is finite: {log}")
    del trainer

    for dtype, tpu in QUALITY_TPU_ROWS.items():
        for seed in QUALITY_SEEDS:
            r = rows[dtype, seed]
            print(f"quality card {dtype:9s} seed {seed}  HR {r['hr_psnr']:.4f} dB / {r['hr_ssim']:.6f}   "
                  f"LR {r['lr_psnr']:.4f} dB / {r['lr_ssim']:.6f}", flush=True)
        print(f"quality tpu  {dtype:9s}         HR {tpu[0]:.4f} dB / {tpu[1]:.6f}   "
              f"LR {tpu[2]:.4f} dB / {tpu[3]:.6f}  (runs/400k/precision_r05.log)", flush=True)
    emit("quality", checkpoint=QUALITY_CKPT, leaves=len(flat), read_s=read_s, render_s=render_s,
         val_set={"clips": len(clips), "shape": list(clips[0]["GT"].shape), "seed": 7},
         card={f"{dtype} seed {seed}": r for (dtype, seed), r in rows.items()}, seed_spread=spread,
         jax_tpu_precision_r05={dtype: dict(zip(("hr_psnr", "hr_ssim", "lr_psnr", "lr_ssim"), v))
                                for dtype, v in QUALITY_TPU_ROWS.items()},
         fp32_gap_to_tpu={f"seed {seed}": {"hr_psnr": rows["float32", seed]["hr_psnr"] - QUALITY_TPU_ROWS["float32"][0],
                                           "lr_psnr": rows["float32", seed]["lr_psnr"] - QUALITY_TPU_ROWS["float32"][2]}
                          for seed in QUALITY_SEEDS},
         limits={"hr_min": QUALITY_HR_MIN, "lr_min": QUALITY_LR_MIN, "kernel_vs_plain_db": QUALITY_PATH_LIMIT},
         clip0_kernel_vs_plain=path_rows, launches=counts, roundtrip_same_bits=True,
         roundtrip_same_file_bytes=same_file,
         resume={"epoch": payload["epoch"], "iter": payload["iter"], "adam_step": steps.pop(),
                 "batch": list(batch.shape), "log": log,
                 "jax_last_logged_iter_164300": {"l_back_rec": 2.4367e-03, "l_forw_fit": 5.7226e-05}})


def chain_error(args, mode, stripe=0):
    """Max abs difference of the kernel and its plain version on one input."""
    x, ws, bs, w5, b5, a, m = args
    n_aux = dc.EP_AUX[mode]
    aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
    got = dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 0.8, aa, mm, stripe=stripe)
    want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm, stripe_w=stripe)
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
        bound, by = chain_bound_ms(*SERVE_SHAPE, C, c_out, 2, peak=TC_PEAK)
        kernels.append({
            "name": f"dense_chain_t_ep[{C}->{c_out}]", "route": "cuda",
            "source": "selfc_tpu_torch/csrc/dense_chain.cu", "replaces": REPLACES,
            "launches": counts["by_width"].get((C, c_out, 32), 0),
            "max_abs_err": err, "ms": ms["median"], "plain_ms": plain["median"],
            "bound_ms": bound, "bound_by": by, "library_ms": library["median"],
            "bound_fma_ms": chain_bound_ms(*SERVE_SHAPE, C, c_out, 2)[0],
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


def new_trainer(device, tree, batch, network=NETWORK_G, **train):
    model = RescaleModel(train_options(network, **train), device=device, rng_seed=0)
    model.load_jax_params(tree)
    check(model.feed_data({"GT": batch}) == TRAIN_SHAPE[1], "feed_data returns the clip length")
    return model


def step_peak_gib(model, eps, step=0):
    """GiB a training step allocates above what is live before it (its
    activations, gradients and moments)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.optimize_parameters(step, eps=eps)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def grads_of(model):
    return {k: p.grad.detach().clone() for k, p in model.net.named_parameters()}


def params_of(model):
    return {k: p.detach().clone() for k, p in model.net.named_parameters()}


def phase_train(device):
    """Three training steps of the full-width net at the published batch,
    then one step with ``save_chain_feats: false``, all W-packed (the
    default: every chain at stripe 36), then the first step and the
    recomputing one again with ``pack_w: false``; the launch counts of
    exactly these six steps are kept."""
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
    tc.reset_launch_counts()
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
    unpacked_net = {**NETWORK_G, "pack_w": False}
    trainers = {}
    for name, network, train in (("recompute", NETWORK_G, {"save_chain_feats": False}),
                                 ("unpacked", unpacked_net, {}),
                                 ("unpacked_recompute", unpacked_net, {"save_chain_feats": False})):
        trainers[name] = new_trainer(device, tree, batch, network, **train)
        trainers[name].optimize_parameters(0, eps=eps[0])
        now = (dc.launches, dc.launches_bwd, dc.launches_feats)
        per_step.append(tuple(int(v) for v in np.subtract(now, seen)))
        seen = now
    torch.cuda.synchronize()
    train_s = time.time() - t0
    counts = {"forward": dict(dc.launches_by_width), "backward": dict(dc.launches_bwd_by_width),
              "feats": dict(dc.launches_feats_by_width), "b6": dict(tc.launches_by_width),
              "b6_bwd": dict(tc.launches_bwd_by_width), "forward_stripe": dict(dc.launches_by_stripe),
              "backward_stripe": dict(dc.launches_bwd_by_stripe), "feats_stripe": dict(dc.launches_feats_by_stripe)}
    # ---------------------------------------------------------------------
    recompute, unpacked = trainers["recompute"], trainers["unpacked"]
    log_r, norm_r = dict(recompute.get_current_log()), float(recompute.grad_norm)
    log_u, grads_u = dict(unpacked.get_current_log()), grads_of(unpacked)
    log_ur = dict(trainers["unpacked_recompute"].get_current_log())
    del trainers, unpacked

    steps = N_TRAIN_STEPS + 3
    check(per_step == [(n_chain, n_chain, 0)] * N_TRAIN_STEPS + [(n_chain, n_chain, n_chain)]
          + [(n_chain, n_chain, 0), (n_chain, n_chain, n_chain)],
          f"chain launches (forward, backward, feats) of each step: {per_step}")
    # every chain of the four packed steps at stripe 36, of the other two unpacked
    stripes = {k: by_stripe(counts[f"{k}_stripe"]) for k in ("forward", "backward", "feats")}
    want_stripes = {"forward": {TRAIN_STRIPE: 4 * n_chain, 0: 2 * n_chain},
                    "backward": {TRAIN_STRIPE: 4 * n_chain, 0: 2 * n_chain},
                    "feats": {TRAIN_STRIPE: n_chain, 0: n_chain}}
    check(stripes == want_stripes, f"chain launches by stripe: {stripes} (expected {want_stripes})")
    # B6 recomputes conv5 of each reverse G chain (the sub_mul epilogue's dm)
    n_sub_mul = sum(BLOCK_NUM) * steps
    check(counts["b6"] == {(3 + 4 * 32, 48): n_sub_mul} and not counts["b6_bwd"],
          f"B6 launches of the four steps: {counts['b6']}, backward {counts['b6_bwd']}")
    for lg in logs + [log_r, log_u, log_ur]:
        check(all(np.isfinite(v) for v in lg.values()) and lg["skipped_nonfinite"] == 0.0,
              f"the step's losses are finite and it was not skipped: {lg}")
    unchanged = [k for k, p in model.net.named_parameters() if torch.equal(p.detach(), start[k])]
    check(not unchanged, f"every parameter changed: {unchanged[:5]}")
    # recomputed features: the same forward, and a backward on the same bits
    check(log_r["loss"] == logs[0]["loss"] and abs(norm_r - norm_1) <= 1e-6 * norm_1,
          f"save_chain_feats false gives the same loss and gradient norm: {(log_r['loss'], logs[0]['loss'], norm_r, norm_1)}")
    check(log_ur["loss"] == log_u["loss"], f"unpacked, save_chain_feats false gives the same loss: {(log_ur, log_u)}")
    # packed against unpacked: the same products; the weight gradient sums
    # over other tiles
    pack_loss_rel = abs(logs[0]["loss"] - log_u["loss"]) / abs(log_u["loss"])
    pack_grad_l2 = grads_rel_l2(grads_1, grads_u)
    check(pack_loss_rel <= TRAIN_LOSS_REL_LIMIT and pack_grad_l2 <= PACK_GRAD_L2_LIMIT,
          f"the packed step against the unpacked one, loss and whole gradient: {(pack_loss_rel, pack_grad_l2)}")
    del grads_u

    # the same first step through the plain chain, on the card
    plain = new_trainer(device, tree, batch)
    with plain_chain_on_card():
        before = (dc.launches, dc.launches_bwd, dc.launches_feats, tc.launches)
        plain.optimize_parameters(0, eps=eps[0])
        check((dc.launches, dc.launches_bwd, dc.launches_feats, tc.launches) == before,
              "the plain path launches no kernel")
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
    peak_step = step_peak_gib(again, eps[0])
    differ = [k for k, p in again.net.named_parameters() if not torch.equal(p.detach(), after_1[k])]
    check(not differ, f"a repeated first step gives bit-identical parameters: {differ[:5]}")

    # and with network_G.remat: each coupling block keeps its input alone and
    # runs its forward again in the backward; the same loss and gradient
    remat = new_trainer(device, tree, batch, {**NETWORK_G, "remat": True})
    before = (dc.launches, dc.launches_bwd)
    peak_remat = step_peak_gib(remat, eps[0])
    remat_launches = (dc.launches - before[0], dc.launches_bwd - before[1])
    log_m, grads_m = dict(remat.get_current_log()), grads_of(remat)
    remat_l2 = grads_rel_l2(grads_m, grads_1)
    remat_bits = all(torch.equal(grads_m[k], g) for k, g in grads_1.items())
    check(log_m["loss"] == logs[0]["loss"] and remat_l2 <= 1e-6,
          f"remat gives the same loss bits and gradients: {(log_m['loss'], logs[0]['loss'], remat_l2)}")
    # the coupling's 48 chains run forward twice
    check(remat_launches == (n_chain + 6 * sum(BLOCK_NUM), n_chain), f"remat step's launches: {remat_launches}")
    remat_ms = {True: [], False: []}
    for on in (False, True, True, False):
        m = remat if on else again
        remat_ms[on].append(time_cuda(lambda: m.optimize_parameters(N_TRAIN_STEPS, eps=eps[0]), iters=3,
                                      warmup=1)["median"])
    del again, remat, grads_m

    emit("train", batch=batch.shape, n_params=n_params, steps=N_TRAIN_STEPS, train_s=train_s,
         launches_per_step=per_step, launches_b6_sub_mul=n_sub_mul, logs=logs, grad_norm_step0=norm_1,
         pack_w=TRAIN_P, stripe_w=TRAIN_STRIPE, launches_by_stripe=stripes,
         launches_forward_by_width_and_stripe={str(k): v for k, v in counts["forward_stripe"].items()},
         launches_backward_by_width_and_stripe={str(k): v for k, v in counts["backward_stripe"].items()},
         loss_rel_err_packed_vs_unpacked=pack_loss_rel, grad_l2_rel_err_packed_vs_unpacked=pack_grad_l2,
         grad_l2_packed_vs_unpacked_limit=PACK_GRAD_L2_LIMIT,
         loss_rel_err_kernel_vs_plain=loss_rel, loss_rel_limit=TRAIN_LOSS_REL_LIMIT,
         grad_l2_rel_err_kernel_vs_plain=grad_l2, grad_l2_limit=TRAIN_GRAD_L2_LIMIT,
         grad_max_rel_err_kernel_vs_plain=grad_rel, grad_rel_limit=TRAIN_GRAD_REL_LIMIT,
         grads_compared=len(live), grads_zero_by_construction=n_zero,
         param_max_abs_err_kernel_vs_plain=param_err, param_limit=TRAIN_PARAM_LIMIT,
         params_differing_by_over_1e_5=moved, repeat_bit_identical=True,
         recompute_same_loss=True, recompute_grad_norm=norm_r,
         remat={"same_loss_bits": True, "grad_l2_rel_err": remat_l2, "grad_same_bits": remat_bits,
                "launches_forward_backward": remat_launches,
                "step_peak_gib_over_live": {"remat": peak_remat, "saved": peak_step},
                "step_ms_in_turns": {"remat": remat_ms[True], "saved": remat_ms[False]}})
    return model, recompute, counts, eps[0]


def library_feats(x, ws, bs):
    """[x1 | .. | x4] through PyTorch's library convolutions on NCDHW
    tensors: the yardstick, never called by the port."""
    feats = x
    for w, b in zip(ws, bs):
        feats = torch.cat([feats, F.leaky_relu(F.conv3d(feats, w, b, padding=(0, 1, 1)), 0.2)], 1)
    return feats[:, x.shape[1]:]


def phase_timing_train(device, model, recompute, counts, worst, worst_bwd, worst_stripe, eps):
    """The chain kernels at the training latent unpacked (the ``pack_w:
    false`` steps' launches) and W-packed (stripe 36, the default steps'),
    then a whole step and its parts packed and unpacked in turns, the
    recomputing step and the plain path's step."""
    widths, spatial = [(C, c_out, 32) for C, c_out in PATH_WIDTHS], [(C, 32) for C in CHAIN_C]
    worst_unpacked = {"forward": {(C, c_out, 32): worst[(C, c_out)] for C, c_out in PATH_WIDTHS},
                      "feats": {(C, 32): worst_bwd["feats"][C] for C in CHAIN_C},
                      "bwd": {(C, 32): worst_bwd["bwd"][C] for C in CHAIN_C}}
    kernels = (chain_rows(device, "train", TRAIN_SHAPE, 0, widths, spatial, counts, worst_unpacked)
               + chain_rows(device, "train_packed", TRAIN_PACKED, TRAIN_STRIPE, widths, spatial, counts,
                            worst_stripe))

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
        with step_algorithms(mdl.cudnn_deterministic):
            for _ in range(5):
                out["forward"].append(time_cuda(fwd, iters=1, warmup=0)["median"])
                out["backward"].append(time_cuda(lambda: held["loss"].backward(), iters=1, warmup=0)["median"])
                out["optimizer"].append(time_cuda(opt, iters=1, warmup=0)["median"])
        return {k: float(np.median(v)) for k, v in out.items()}

    turns = timed_in_turns(model, step_of(model), lambda: parts(model))
    step_ms, peak_saved = turns["packed"]["step_ms_median"], turns["packed"]["peak_device_memory_gib"]
    split = turns["packed"]["parts"]
    vs_parent = {}
    for packed in ((True, False) if PARENT_LIBS else ()):
        model.net.set_pack_w(packed)
        vs_parent["packed" if packed else "unpacked"] = against_parent(step_of(model))
    model.net.set_pack_w(True)
    torch.cuda.reset_peak_memory_stats()
    step_r = time_cuda(step_of(recompute), iters=10, warmup=1)
    peak_recompute = torch.cuda.max_memory_allocated() / 2 ** 30
    with plain_chain_on_card():
        step_p = time_cuda(step_of(model), iters=10, warmup=1)
    # the chain kernels' ms in one packed step: rows x launches of the four
    # packed steps / 4
    by_name = {k["name"]: k for k in kernels}
    n_fwd = sum(by_name[f"dense_chain_t_ep[{C}->{co},gc32]@train_packed"]["ms"]
                * counts["forward_stripe"].get((C, co, 32, TRAIN_STRIPE), 0) for C, co in PATH_WIDTHS) / 4
    n_bwd = sum(by_name[f"chain_spatial_bwd[{C},gc32]@train_packed"]["ms"]
                * counts["backward_stripe"].get((C, 32, TRAIN_STRIPE), 0) for C in CHAIN_C) / 4
    emit("timing_train", shape=TRAIN_SHAPE, packed_shape=TRAIN_PACKED, step_ms=step_ms,
         step_ms_unpacked=turns["unpacked"]["step_ms_median"], turns=turns, step_ms_vs_parent=vs_parent,
         step_recompute_feats_ms=step_r["median"], step_recompute_feats_ms_min=step_r["min"],
         step_plain_ms=step_p["median"], step_plain_ms_min=step_p["min"],
         forward_ms=split["forward"], backward_ms=split["backward"], optimizer_ms=split["optimizer"],
         forward_chain_kernels_ms_per_step=n_fwd, backward_chain_kernels_ms_per_step=n_bwd,
         clips_per_s=TRAIN_SHAPE[0] * 1e3 / step_ms,
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


def phase_kernels_nan_feats(device):
    """B1's and B3's feats buffers filled with NaN before the launch come
    back finite in every lane, exactly 0 in every pad lane and equal to the
    plain features in the real ones (B1's conv5 and B2 multiply the pad
    lanes by zero weights: a NaN left there would reach their outputs), at
    growth 12, 24 and 32 (16- and 32-lane segments), fp32 and bf16; B1's
    output, written over NaN, agrees with its plain version."""
    rng = np.random.default_rng(150)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for gc in NAN_FEATS_GC:
            x, ws, bs, w5, b5, a, m = make_chain(rng, 3, 12, CHECK_SHAPE, device, dtype, gc)
            gcp = dc.padded_gc(gc)
            pad = (torch.arange(4 * gcp, device=device) % gcp) >= gc
            want = dc.padded_width(dc.chain_feats_plain(x, ws, bs), gc, gcp).float()
            want_out = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "mul_add", 0.8, a, m).float()
            for entry in ("forward", "feats"):
                feats = torch.full((*x.shape[:4], 4 * gcp), float("nan"), dtype=dtype, device=device)
                out = torch.full(want_out.shape, float("nan"), dtype=dtype, device=device)
                if entry == "forward":
                    dc._launch_forward(x, ws, bs, w5, b5, "mul_add", 0.8, a, m, feats, out)
                else:
                    dc._launch_feats(x, ws, bs, feats)
                torch.cuda.synchronize()
                err = (feats.float() - want).abs().max().item()
                limit = FP32_LIMIT if dtype == torch.float32 else BF16_REL_LIMIT * want.abs().max().item()
                rec = {"dtype": str(dtype).split(".")[-1], "gc": gc, "entry": entry,
                       "finite": bool(torch.isfinite(feats).all()), "pads_zero": bool((feats[..., pad] == 0).all()),
                       "feats_max_abs_err": err}
                ok = rec["finite"] and rec["pads_zero"] and err <= limit
                if entry == "forward":
                    rec["out_max_abs_err"] = (out.float() - want_out).abs().max().item()
                    ok = ok and rec["out_max_abs_err"] <= (
                        FP32_LIMIT if dtype == torch.float32 else BF16_REL_LIMIT * want_out.abs().max().item())
                cases.append(rec)
                check(ok, f"a feats buffer that held NaN comes back clean: {rec}")
    emit("kernels_nan_feats", shape=CHECK_SHAPE, n_cases=len(cases), cases=cases)


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
        bound, by = chain_bound_ms(*shape, C, c_out, dc.EP_AUX[mode], gc=gc, peak=TC_PEAK)
        kernels.append({
            "name": f"dense_chain_t_ep[{C}->{c_out},gc{gc}]@codec", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": sum(split[part].get((C, c_out, gc), 0) for part in split),
            "max_abs_err": err, "ms": ms["median"], "plain_ms": plain["median"],
            "bound_ms": bound, "bound_by": by, "library_ms": library["median"],
            "bound_fma_ms": chain_bound_ms(*shape, C, c_out, dc.EP_AUX[mode], gc=gc)[0],
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


def stripe_counts():
    return {"forward_stripe": dict(dc.launches_by_stripe), "backward_stripe": dict(dc.launches_bwd_by_stripe),
            "feats_stripe": dict(dc.launches_feats_by_stripe)}


def phase_codec_train(device):
    """Three training steps of the published codec net with its surrogate
    at the published batch, through the host codec, then one step with
    ``save_chain_feats: false``, all W-packed (the default: the coupling and
    prior chains at stripe 72, the surrogate's unpacked), then the first
    step and the recomputing one again with ``pack_w: false``; the launch
    counts of exactly these six steps are kept. Then one step's whole
    gradient, kernel path against plain path and packed against unpacked,
    from one shared codec output."""
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
    log_more = []
    for network, train in ((None, {"save_chain_feats": False}), ({"pack_w": False}, {}),
                           ({"pack_w": False}, {"save_chain_feats": False})):
        extra = new_codec_trainer(device, tree, batch, network, **train)
        before = codec_counts()
        extra.optimize_parameters(0)
        log_more.append(dict(extra.get_current_log()))
        per_step.append({k: {w: n - before[k].get(w, 0) for w, n in d.items()} for k, d in codec_counts().items()})
        del extra
    torch.cuda.synchronize()
    train_s = time.time() - t0
    counts = {**codec_counts(), **stripe_counts()}
    # ---------------------------------------------------------------------
    log_r, log_u, log_ur = log_more

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
    check(got == [want] * N_CODEC_STEPS + [want_r, want, want_r],
          f"kernel launches of each codec training step: {got} (expected {want}, then {want_r})")
    # the coupling and prior chains of the four packed steps at stripe 72,
    # of the other two unpacked; the surrogate's (B4) unpacked in all six
    n_chain, n_b4 = sum(CODEC_TRAIN_FWD.values()), sum(CODEC_TRAIN_SPATIAL.values())
    stripes = {k: by_stripe(counts[f"{k}_stripe"]) for k in ("forward", "backward", "feats")}
    want_stripes = {"forward": {CODEC_STRIPE: 4 * n_chain, 0: 2 * n_chain},
                    "backward": {CODEC_STRIPE: 4 * n_chain, 0: 2 * n_chain + 6 * n_b4},
                    "feats": {CODEC_STRIPE: n_chain, 0: n_chain + 6 * n_b4}}
    check(stripes == want_stripes, f"codec chain launches by stripe: {stripes} (expected {want_stripes})")
    n_gc12 = sum(n for (C, gc), n in got[0]["backward"].items() if gc == 12)
    check(n_gc12 == 4, f"adjoint launches at growth 12 a step: {n_gc12}")
    for lg in logs + log_more:
        check(all(np.isfinite(v) for k, v in lg.items() if k != "rate_source")
              and lg["skipped_nonfinite"] == 0.0, f"the step's losses are finite and it was not skipped: {lg}")
    check(log_r["loss"] == logs[0]["loss"] and log_ur["loss"] == log_u["loss"],
          f"save_chain_feats false gives the same loss: {(log_r['loss'], logs[0]['loss'], log_ur['loss'], log_u['loss'])}")
    top = max(g.abs().max().item() for g in grads_1.values())
    unchanged = [k for k, p in model.params.named_parameters() if torch.equal(p.detach(), start[k])]
    check(all(grads_1[k].abs().max().item() < TRAIN_GRAD_ZERO * top for k in unchanged),
          f"every parameter with a gradient changed: {unchanged[:5]}")
    del model

    # one step from one shared codec output: kernel path against plain path
    kern = new_codec_trainer(device, tree, batch)
    with torch.no_grad():
        shared, _ = kern.codec_span(kern._encode_lf(kern._hr), kern.q)
    kern.optimize_parameters(0, codec_out=shared)
    log_k, grads_k = dict(kern.get_current_log()), all_grads(kern)
    del kern
    unpacked = new_codec_trainer(device, tree, batch, {"pack_w": False})
    unpacked.optimize_parameters(0, codec_out=shared)
    log_u, grads_u = dict(unpacked.get_current_log()), all_grads(unpacked)
    del unpacked
    pack_loss_rel = abs(log_k["loss"] - log_u["loss"]) / abs(log_u["loss"])
    pack_grad_l2 = grads_rel_l2(grads_k, grads_u)
    check(pack_loss_rel <= TRAIN_LOSS_REL_LIMIT and pack_grad_l2 <= PACK_GRAD_L2_LIMIT,
          f"the packed codec step against the unpacked one, loss and whole gradient: {(pack_loss_rel, pack_grad_l2)}")
    del grads_u
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
         launches_adjoint_gc12_per_step=n_gc12, logs=logs, pack_w=CODEC_P, stripe_w=CODEC_STRIPE,
         launches_by_stripe=stripes,
         launches_forward_by_width_and_stripe={str(k): v for k, v in counts["forward_stripe"].items()},
         loss_rel_err_packed_vs_unpacked=pack_loss_rel, grad_l2_rel_err_packed_vs_unpacked=pack_grad_l2,
         grad_l2_packed_vs_unpacked_limit=PACK_GRAD_L2_LIMIT,
         loss_rel_err_kernel_vs_plain=loss_rel, loss_rel_limit=TRAIN_LOSS_REL_LIMIT,
         grad_l2_rel_err_kernel_vs_plain=grad_l2, grad_l2_limit=TRAIN_GRAD_L2_LIMIT,
         recompute_same_loss=True)
    return tree, batch, counts


def spatial_rows(device, tag, shape, counts, worst, rng):
    """The kernels-line rows of B4 (the surrogate's v1 spatial chains,
    ``fused_dense_spatial``) forward and backward at each of its input
    widths on ``shape``, with their launches (``counts``' "spatial" /
    "spatial_bwd" by (C, 32)); ``worst``: the checks' worst fp32 errors."""
    B, T, H, W = shape
    kernels = []
    for C in SURROGATE_C:
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
        bound, by = chain_feats_bound_ms(*shape, C, peak=TC_PEAK)
        bb, bby = chain_bwd_bound_ms(*shape, C, dx_in=False, peak=TC_PEAK)
        common = {"route": "cuda", "replaces": REPLACES_SPATIAL, "shape": list(shape) + [C], "gc": 32}
        kernels.append({
            "name": f"fused_dense_spatial[{C}]@{tag}", "source": SOURCE,
            "launches": counts["spatial"].get((C, 32), 0), "max_abs_err": worst["spatial"][C],
            "ms": s_ms["median"], "plain_ms": s_plain["median"], "bound_ms": bound, "bound_by": by,
            "bound_fma_ms": chain_feats_bound_ms(*shape, C)[0],
            "library_ms": s_lib["median"], "ms_min": s_ms["min"], "plain_ms_min": s_plain["min"],
            "library_ms_min": s_lib["min"], **common})
        kernels.append({
            "name": f"fused_dense_spatial_bwd[{C}]@{tag}", "source": SOURCE_BWD,
            "launches": counts["spatial_bwd"].get((C, 32), 0), "max_abs_err": worst["spatial_bwd"][C],
            "ms": sb_ms["median"], "plain_ms": sb_plain["median"], "bound_ms": bb, "bound_by": bby,
            "bound_fma_ms": chain_bwd_bound_ms(*shape, C, dx_in=False)[0], "library_ms": sb_lib["median"],
            "ms_min": sb_ms["min"], "plain_ms_min": sb_plain["min"],
            "library_ms_min": sb_lib["min"], **common})
        del x, ws, bs, leaves, l2, out, out_p, lout, gout, lg

    return kernels


def phase_timing_codec_train(device, tree, batch, counts, worst, worst_gc, worst_stripe):
    """The kernels of the codec's training at its shapes (B1, and B3 and B2
    at growth 12, unpacked and W-packed at stripe 72; B4 forward and
    backward), a whole step and its parts packed and unpacked in turns, the
    plain path's step, and the peak memory with features saved and
    recomputed."""
    rng = np.random.default_rng(61)
    shape = CODEC_TRAIN_LAT
    spatial = [(3, 12), (24, 12)]        # the prior's chains: growth 12
    kernels = (chain_rows(device, "codec_train", shape, 0, CODEC_WIDTHS, spatial, counts,
                          {"forward": worst_gc, "feats": worst["feats"], "bwd": worst["bwd"]})
               + chain_rows(device, "codec_train_packed", CODEC_PACKED, CODEC_STRIPE, CODEC_WIDTHS, spatial, counts,
                            worst_stripe))
    kernels += spatial_rows(device, "codec_train", shape, counts, worst, rng)

    # a whole step (host codec included), then its parts, each timed alone
    model = new_codec_trainer(device, tree, batch)
    step_of = lambda mdl: (lambda: mdl.optimize_parameters(N_CODEC_STEPS))  # noqa: E731
    turns = timed_in_turns(model, step_of(model), lambda: codec_parts(model))
    step_ms, peak_saved = turns["packed"]["step_ms_median"], turns["packed"]["peak_device_memory_gib"]
    split = turns["packed"]["parts"]
    algorithms = cudnn_in_turns(model, step_of(model), iters=5)
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
    emit("timing_codec_train", batch=CODEC_TRAIN_SHAPE, packed_shape=CODEC_PACKED, step_ms=step_ms,
         step_ms_unpacked=turns["unpacked"]["step_ms_median"], turns=turns,
         step_recompute_feats_ms=step_r["median"], step_plain_ms=step_p["median"],
         step_plain_ms_min=step_p["min"], encode_forward_ms=split["encode_forward"],
         host_codec_ms=split["host_codec"], loss_backward_ms=split["loss_backward"],
         optimizer_ms=split["optimizer"], clips_per_s=CODEC_TRAIN_SHAPE[0] * 1e3 / step_ms,
         peak_device_memory_gib_saved_feats=peak_saved, peak_device_memory_gib_recomputed_feats=peak_recompute,
         step_ms_by_cudnn_algorithms=algorithms, rate_source=rate, host_codec=h265.codec_backend() or "stand-in")
    return kernels, {"step_ms": step_ms, "step_plain_ms": step_p["median"],
                     "peak_device_memory_gib": peak_saved}


def cudnn_in_turns(model, step, iters):
    """Median ms of ``step`` with the model's deterministic cuDNN algorithms
    (its default) and with ``cudnn_deterministic = False``, in turns
    (deterministic, not, not, deterministic): ``{"deterministic": [..],
    "nondeterministic": [..]}``."""
    out = {"deterministic": [], "nondeterministic": []}
    for det in (True, False, False, True):
        model.cudnn_deterministic = det
        out["deterministic" if det else "nondeterministic"].append(time_cuda(step, iters=iters, warmup=1)["median"])
    model.cudnn_deterministic = True
    return out


def codec_parts(model):
    """One codec training step's parts, each timed alone, median of 5, under
    the step's cuDNN algorithms: the encode forward, the host codec (host
    clock), the loss and backward, clip + Adam."""
    with step_algorithms(model.cudnn_deterministic):
        return _codec_parts(model)


def _codec_parts(model):
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
    return {k: float(np.median(v)) for k, v in parts.items()}




def deform_errors(got, want, fp32):
    """Errors of one deformable-conv comparison: max abs (fp32) or relative
    to max |ref| (bf16)."""
    err = (got.float() - want.float()).abs().max().item()
    return err if fp32 else err / want.float().abs().max().item()


def phase_kernels_deform(device):
    """B5 forward and backward against the composition and the closed-form
    adjoint on the card, fp32 and bf16: offsets uniform in +-7 px (taps
    leave the frame), the mask in [0, 2], and once with every tap sampling
    next to one pixel; dx and dweight (all four gradients) the same bits
    twice. Zero offsets with mask 1 must give the port's conv2d. On a CUDA
    tensor the op launches or raises."""
    rng = np.random.default_rng(70)
    cases, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        for shape, C, c_out in DEFORM_CHECKS + (DEFORM_ALL_TO_ONE,):
            all_to_one = (shape, C, c_out) == DEFORM_ALL_TO_ONE
            x, off, mask, w, g = make_deform(rng, shape, C, c_out, device, dtype, DEFORM_SPREAD)
            if all_to_one:
                off = deform_all_to_one(shape, (shape[1] // 2, shape[2] // 2)).to(device, dtype)
            corners, outside = deform_tap_stats(off)
            e_fwd = deform_errors(df.deform_conv2d(x, off, mask, w), df.deform_conv2d_plain(x, off, mask, w), fp32)
            got = df._backward_cuda(x, off, mask, w, g)
            again = df._backward_cuda(x, off, mask, w, g)
            want = df.deform_conv2d_bwd_plain(x, off, mask, w, g)
            torch.cuda.synchronize()
            e_bwd = {n: rel_err(u, v) for n, u, v in zip(("dx", "doffset", "dmask", "dweight"), got, want)}
            same_bits = {n: torch.equal(u, v) for n, u, v in zip(("dx", "doffset", "dmask", "dweight"), got, again)}
            ok = (e_fwd <= (FP32_LIMIT if fp32 else BF16_REL_LIMIT)
                  and max(e_bwd.values()) <= (BWD_FP32_REL_LIMIT if fp32 else BWD_BF16_REL_LIMIT) and all(same_bits.values()))
            if fp32 and not all_to_one:
                worst[(tuple(shape), C, c_out)] = {
                    "forward": e_fwd, "backward": max((u.float() - v.float()).abs().max().item()
                                                      for u, v in zip(got, want))}
            cases.append({"dtype": str(dtype).split(".")[-1], "shape": list(shape), "C": C, "c_out": c_out,
                          "all_to_one": all_to_one, "forward_err": e_fwd, **{f"{n}_rel_err": v for n, v in e_bwd.items()},
                          "dx_same_bits_twice": same_bits["dx"], "dweight_same_bits_twice": same_bits["dweight"],
                          "doffset_dmask_same_bits_twice": same_bits["doffset"] and same_bits["dmask"],
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
    repeats = {det: repeated_codec_step(device, tree, batch, net_opt, shared, det) for det in (True, False)}
    same_loss, differ = repeats[True]
    check(same_loss and not differ, f"a repeated de-artifact step (the model's default: cuDNN's deterministic "
                                    f"algorithms) gives the same loss and parameters bit for bit: differing {differ[:5]}")
    plain = new_codec_trainer(device, tree, batch, net_opt)
    with plain_chain_on_card():
        before = (df.launches, df.launches_bwd, dc.launches, dc.launches_bwd)
        plain.optimize_parameters(0, codec_out=shared)
        check((df.launches, df.launches_bwd, dc.launches, dc.launches_bwd) == before,
              "the plain path launches no kernel")
    log_p, grads_p = dict(plain.get_current_log()), all_grads(plain)
    del plain
    n_leaves = len(grads_p)
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
    algorithms = cudnn_in_turns(model, lambda: model.optimize_parameters(N_CODEC_STEPS), iters=5)
    emit("codec_deart_train", batch=batch.shape, n_params=n_params, steps=N_CODEC_STEPS, train_s=train_s,
         rate_source=logs[0]["rate_source"], deart_offsets=offsets,
         launches_b5_per_step={"forward": DEART_B5_STEP, "backward": DEART_B5_STEP}, logs=logs,
         loss_rel_err_kernel_vs_plain=loss_rel, loss_rel_limit=TRAIN_LOSS_REL_LIMIT,
         grad_l2_rel_err_kernel_vs_plain=grad_l2, grad_l2_limit=TRAIN_GRAD_L2_LIMIT,
         grad_l2_rel_err_deart_leaves=grad_l2_deart, repeat_bit_identical_cudnn_deterministic=True,
         repeat_default_step={"same_loss": repeats[True][0], "params_differing": len(repeats[True][1]),
                              "params": n_leaves},
         repeat_cudnn_nondeterministic={"same_loss": repeats[False][0], "params_differing": len(repeats[False][1]),
                                        "params": n_leaves},
         step_ms=step["median"], step_ms_min=step["min"], step_ms_by_cudnn_algorithms=algorithms,
         clips_per_s=CODEC_TRAIN_SHAPE[0] * 1e3 / step["median"], peak_device_memory_gib=peak,
         without_deart=base)
    return counts


def repeated_codec_step(device, tree, batch, net_opt, codec_out, deterministic):
    """The first codec training step twice from the same parameters and codec
    output, as the model runs it (cuDNN's deterministic convolution
    algorithms, ``deterministic``) or with ``cudnn_deterministic = False``
    (cuDNN's other algorithms, whose gradients do not repeat bit for bit in
    the codec step): (the same loss, the parameters that differ after the
    step)."""
    runs = []
    for _ in range(2):
        m = new_codec_trainer(device, tree, batch, net_opt)
        m.cudnn_deterministic = deterministic
        m.optimize_parameters(0, codec_out=codec_out)
        runs.append((dict(m.get_current_log())["loss"],
                     {k: p.detach().clone() for k, p in m.params.named_parameters()}))
        del m
    (l0, p0), (l1, p1) = runs
    return l0 == l1, [k for k in p0 if not torch.equal(p0[k], p1[k])]


def phase_timing_deform(device, counts_test, counts_train, worst):
    """B5 forward at the decode and training shapes and its backward at the
    training shape: ms beside the bound (for this run's offsets: 3 px, the
    de-artifact net's spread): ``bound_ms`` with the contraction at the
    tensor cores' rate and the sample at the FMA rate, ``bound_fma_ms`` all
    of it at the FMA rate; the plain version's ms; under ``--parent`` the
    parent tree's kernel in turns. Launches: a ``test()`` (decode) or a
    training step. No single PyTorch call computes the function
    (torchvision is not installed): library_ms is null."""
    rng = np.random.default_rng(71)
    parent = ParentDeform(PARENT_LIBS["deform"]) if "deform" in PARENT_LIBS else None
    per_step = lambda d: d.get((DEART_C, DEART_C), 0) // (N_CODEC_STEPS + 1)  # noqa: E731
    rows = []
    for shape, backward, launches in ((DEART_DEC_SHAPE, False, counts_test["b5"].get((DEART_C, DEART_C), 0)),
                                      (DEART_TRAIN_SHAPE, False, per_step(counts_train["forward"])),
                                      (DEART_TRAIN_SHAPE, True, per_step(counts_train["backward"]))):
        x, off, mask, w, g = make_deform(rng, shape, DEART_C, DEART_C, device, spread=3.0)
        corners, _ = deform_tap_stats(off)
        iters = 10 if shape == DEART_DEC_SHAPE else 20
        with torch.no_grad():
            if backward:
                this = lambda: df._backward_cuda(x, off, mask, w, g)  # noqa: E731
                plain = time_cuda(lambda: df.deform_conv2d_bwd_plain(x, off, mask, w, g), iters=5, warmup=1)
                theirs = parent and (lambda: parent.backward(x, off, mask, w, g))
            else:
                this = lambda: df._forward_cuda(x, off, mask, w)  # noqa: E731
                plain = time_cuda(lambda: df.deform_conv2d_plain(x, off, mask, w), iters=5, warmup=1)
                theirs = parent and (lambda: parent.forward(x, off, mask, w))
            ms = time_cuda(this, iters=iters)
            vs = in_turns(this, theirs, iters) if parent else None
        bound, by = deform_bound_ms(*shape, DEART_C, DEART_C, corners=corners, backward=backward)
        err = worst[(tuple(shape), DEART_C, DEART_C)]["backward" if backward else "forward"]
        rows.append({
            "name": f"deform_conv2d{'_bwd' if backward else ''}[{DEART_C}->{DEART_C}]@"
                    f"{'codec' if shape == DEART_DEC_SHAPE else 'codec_train'}",
            "route": "cuda", "source": SOURCE_DEFORM, "replaces": REPLACES_DEFORM, "launches": launches,
            "max_abs_err": err, "ms": ms["median"], "plain_ms": plain["median"], "bound_ms": bound,
            "bound_by": by, "library_ms": None, "ms_min": ms["min"], "plain_ms_min": plain["min"],
            "bound_fma_ms": deform_bound_fma_ms(*shape, DEART_C, DEART_C, corners=corners, backward=backward)[0],
            "launches_of": "test()" if shape == DEART_DEC_SHAPE else "step",
            "shape": list(shape) + [DEART_C], "corners_inside_per_tap": corners,
            **({"vs_parent_ms": vs} if vs else {})})
        del x, off, mask, w, g
    emit("timing_deform", rows=[{k: r.get(k) for k in ("name", "ms", "ms_min", "plain_ms", "bound_ms", "bound_by",
                                                      "bound_fma_ms", "launches", "vs_parent_ms")} for r in rows])
    return rows


def tc_adjoint_plain(x, w, b, g, slope, positive):
    """dx, dw and db of the temporal conv for the output gradient ``g``,
    plain: autograd of the plain conv (fp32) with the LeakyReLU's mask
    ``positive`` given (None: no LeakyReLU)."""
    leaves = [t.detach().float().requires_grad_(True) for t in (x, w, b)]
    dy = g.float() if slope is None else torch.where(positive, g.float(), slope * g.float())
    return torch.autograd.grad(tc.temporal_conv3_fused_plain(*leaves), leaves, dy)


def phase_kernels_temporal(device):
    """B6 against its plain version on the card, fp32 and bf16, without a
    LeakyReLU and at slopes 0.2 and 0: the forward, and the backward (dx
    through B6 with the flipped weights, dw and db as products) against
    autograd of the plain conv at the kernel's own LeakyReLU mask (where two
    forwards ~1e-6 apart straddle 0, the masks differ and so would the
    gradients, without a fault). Each twice: the same bits. On a CUDA
    tensor the wrapper launches or raises."""
    rng = np.random.default_rng(80)
    cases, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        for shape, C, co in TC_CHECKS:
            x, w, b, g = make_temporal_conv(rng, shape, C, co, device, dtype)
            for slope in (None, 0.2, 0.0):
                before = (tc.launches, tc.launches_bwd)
                leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
                out = tc.temporal_conv3_fused(*leaves, slope)
                got_g = torch.autograd.grad(out, leaves, g)
                counted = (tc.launches - before[0], tc.launches_bwd - before[1]) == (1, 1)
                again = tc.temporal_conv3_fused(*leaves, slope)
                again_g = torch.autograd.grad(again, leaves, g)
                want = tc.temporal_conv3_fused_plain(x, w, b, slope)
                positive = (None if slope is None else out >= 0 if slope > 0
                            else tc._forward_cuda(x, w, b, slope, True)[1])
                want_g = tc_adjoint_plain(x, w, b, g, slope, positive)
                torch.cuda.synchronize()
                e_fwd = deform_errors(out.detach(), want, fp32)
                e_bwd = {n: rel_err(u, v) for n, u, v in zip(("dx", "dw", "db"), got_g, want_g)}
                same_bits = torch.equal(out, again) and all(torch.equal(u, v) for u, v in zip(got_g, again_g))
                ok = (e_fwd <= (FP32_LIMIT if fp32 else BF16_REL_LIMIT) and counted and same_bits
                      and max(e_bwd.values()) <= (BWD_FP32_REL_LIMIT if fp32 else BWD_BF16_REL_LIMIT))
                if fp32:
                    worst[(C, co)] = max(worst.get((C, co), 0.0), e_fwd)
                cases.append({"dtype": str(dtype).split(".")[-1], "shape": list(shape), "C": C, "c_out": co,
                              "slope": slope, "forward_err": e_fwd, **{f"{n}_rel_err": v for n, v in e_bwd.items()},
                              "same_bits_twice": same_bits, "launches_counted": counted, "ok": ok})
                check(ok and np.isfinite(e_fwd + sum(e_bwd.values())), f"B6 agrees with its plain version: {cases[-1]}")
    # every tile path, forced through the SM count the plan is given (1: K
    # never split; this card's: these small shapes split), each twice: the
    # same bits; the wrapper's count by (path, split) shows each ran
    tc.reset_launch_counts()
    paths = []
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        for shape, C, co in TC_CHECKS + TC_PATH_CHECKS:
            x, w, b, _ = make_temporal_conv(rng, shape, C, co, device, dtype)
            want = tc.temporal_conv3_fused_plain(x, w, b, 0.2)
            for sms in (1, None):
                path = tc.plan(shape[0], shape[1], shape[2] * shape[3], C, co, x.element_size(),
                               sms or tc._sm_count(x))
                got = tc._forward_cuda(x, w, b, 0.2, False, sms)[0]
                again = tc._forward_cuda(x, w, b, 0.2, False, sms)[0]
                torch.cuda.synchronize()
                e = deform_errors(got, want, fp32)
                same_bits = torch.equal(got, again)
                ok = e <= (FP32_LIMIT if fp32 else BF16_REL_LIMIT) and same_bits
                paths.append({"dtype": str(dtype).split(".")[-1], "shape": list(shape), "C": C, "c_out": co,
                              "path": path[0], "split": path[1], "forward_err": e, "same_bits_twice": same_bits})
                check(ok and np.isfinite(e), f"B6 on a forced path agrees with its plain version: {paths[-1]}")
    by_path = {f"{p}/{s}": n for (p, s), n in sorted(tc.launches_by_path.items())}
    check({p for p, _ in tc.launches_by_path} == {"narrow", "wide"}
          and all(any(p == q and (s > 1) == split for q, s in tc.launches_by_path)
                  for p in ("narrow", "wide") for split in (False, True)),
          f"B6 ran every tile path, unsplit and split: {by_path}")
    # on a CUDA tensor the wrapper launches or raises
    x, w, b, _ = make_temporal_conv(rng, (1, 3, 4, 5), 6, 4, device)
    before, refused = (tc.launches, tc.launches_bwd), []
    for fault, error, args in (("float64", TypeError, (x.double(), w, b)),
                               ("4-d x", ValueError, (x[0], w, b)),
                               ("bias of 5", ValueError, (x, w, torch.zeros(5, device=device))),
                               ("w of 7 input channels", ValueError, (x, torch.zeros(3, 7, 4, device=device), b))):
        try:
            tc.temporal_conv3_fused(*args)
        except error:
            refused.append(fault)
    check(len(refused) == 4 and (tc.launches, tc.launches_bwd) == before,
          f"the temporal conv refuses bad CUDA arguments: {refused}")
    emit("kernels_temporal", kernels=["temporal_conv3_fused", "temporal_conv3_fused_bwd"], n_cases=len(cases),
         fp32_limit=FP32_LIMIT, bf16_rel_limit=BF16_REL_LIMIT, bwd_fp32_rel_limit=BWD_FP32_REL_LIMIT,
         bwd_bf16_rel_limit=BWD_BF16_REL_LIMIT, refused=refused, cases=cases, path_cases=paths,
         launches_by_path=by_path)
    return worst


def rel_l2(got, want):
    """|got - want|_2 / |want|_2 over matching arrays or tensors, in fp64."""
    got, want = (np.asarray(t.detach().cpu() if torch.is_tensor(t) else t, np.float64) for t in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def grads_rel_l2(grads, ref):
    return (sum((grads[k] - g).pow(2).sum().item() for k, g in ref.items())
            / sum(g.pow(2).sum().item() for g in ref.values())) ** 0.5


def b6_counts():
    return {"forward": dict(tc.launches_by_width), "backward": dict(tc.launches_bwd_by_width),
            "b1": dict(dc.launches_by_width)}


def phase_subnets(device, counts):
    """The published SelfC_GMM at full width with each subnet type of
    SUBNET_TYPES, whose coupling chains reach B6: a GOP request
    (``RescaleModel.test``) on a 7-frame Vid4-size clip, then one training
    step at the published batch; the B6 and B1 launch counts of exactly
    those calls are kept (added into ``counts``, keyed by (path, C, Co)).
    Each against the same net with the kernels swapped for their plain
    versions: hr from one shared LR and noise, and the step's loss and
    whole gradient, in relative l2."""
    rng = np.random.default_rng(90)
    clip = np.clip(rng.normal(0.5, 0.2, (1, 7, *CLIP_HW, 3)), 0, 1).astype(np.float32)
    batch = train_batch(91)
    n_blocks = sum(BLOCK_NUM)
    out = []
    for subnet_type in SUBNET_TYPES:
        widths, shrink = SUBNET_TC[subnet_type]
        network = network_g(subnet_type)
        model = RescaleModel(serve_options(network), device=device, rng_seed=0)
        tree = seeded_tree(model.net, 92)
        model.load_jax_params(tree)
        n_params = sum(p.numel() for p in model.net.parameters())

        # ---- the main path: counts set to 0 just before, read just after ----
        dc.reset_launch_counts()
        tc.reset_launch_counts()
        model.generator.manual_seed(5)
        t0 = time.time()
        with torch.no_grad():
            model.feed_data({"GT": clip})
            model.test(gop=7)
        torch.cuda.synchronize()
        serve_s = time.time() - t0
        serve = b6_counts()
        # ---------------------------------------------------------------------

        # F's width a block each way, and G's and H's
        want_b6 = {widths[1]: 2 * n_blocks, widths[0]: 4 * n_blocks}
        check(serve["forward"] == want_b6 and not serve["backward"],
              f"{subnet_type}: B6 launches of test(): {serve}")
        check(serve["b1"] == {(3, 64, 32): 1, (64, 64, 32): STP_BLK_NUM - 1},
              f"{subnet_type}: B1 launches of test() (the prior alone): {serve['b1']}")
        sr = model.get_current_visuals()["SR"]
        check(sr.shape == clip.shape and np.isfinite(sr).all(), f"{subnet_type}: SR shape and finite")
        with torch.no_grad():
            lr_k = model.downscale(clip)
            model.generator.manual_seed(6)
            hr_k = model.upscale(lr_k)
            with plain_chain_on_card():
                before = (dc.launches, tc.launches)
                lr_p = model.downscale(clip)
                model.generator.manual_seed(6)
                hr_p = model.upscale(lr_k)   # the same LR and the same noise as the kernel path
                check((dc.launches, tc.launches) == before, "the plain path launches no kernel")
        lr_differ = float(np.mean(np.abs(lr_k - lr_p) > 1e-6))
        hr_l2 = rel_l2(hr_k, hr_p)
        check(lr_differ < 1e-3 and np.abs(lr_k - lr_p).max() < 1.01 / 255,
              f"{subnet_type}: downscale, kernel path vs plain path: {lr_differ}")
        check(hr_l2 <= SUBNET_REL_L2_LIMIT, f"{subnet_type}: hr from a shared LR, kernel vs plain path: {hr_l2}")
        del model, lr_k, hr_k, lr_p, hr_p

        eps = rng.normal(0, 1, (*TRAIN_SHAPE, 48, 5)).astype(np.float32)
        trainer = new_trainer(device, tree, batch, network)
        # ---- the main path: counts set to 0 just before, read just after ----
        dc.reset_launch_counts()
        tc.reset_launch_counts()
        t0 = time.time()
        trainer.optimize_parameters(0, eps=eps)
        torch.cuda.synchronize()
        step_s = time.time() - t0
        train = b6_counts()
        # ---------------------------------------------------------------------
        log_k, grads_k = dict(trainer.get_current_log()), grads_of(trainer)
        check(train["forward"] == want_b6 and train["backward"] == want_b6,
              f"{subnet_type}: B6 launches of a step (forward, backward): {train}")
        check(all(np.isfinite(v) for v in log_k.values()) and log_k["skipped_nonfinite"] == 0.0,
              f"{subnet_type}: the step's losses are finite and it was not skipped: {log_k}")
        step = time_cuda(lambda: trainer.optimize_parameters(1, eps=eps), iters=3, warmup=1)
        del trainer
        plain = new_trainer(device, tree, batch, network)
        with plain_chain_on_card():
            before = (dc.launches, dc.launches_bwd, tc.launches, tc.launches_bwd)
            plain.optimize_parameters(0, eps=eps)
            check((dc.launches, dc.launches_bwd, tc.launches, tc.launches_bwd) == before,
                  "the plain path launches no kernel")
            log_p, grads_p = dict(plain.get_current_log()), grads_of(plain)
            step_p = time_cuda(lambda: plain.optimize_parameters(1, eps=eps), iters=3, warmup=1)
        del plain
        loss_rel = abs(log_k["loss"] - log_p["loss"]) / abs(log_p["loss"])
        grad_l2 = grads_rel_l2(grads_k, grads_p)
        check(loss_rel <= TRAIN_LOSS_REL_LIMIT and grad_l2 <= SUBNET_REL_L2_LIMIT,
              f"{subnet_type}: a step's loss and whole gradient, kernel vs plain path: {(loss_rel, grad_l2)}")
        del grads_k, grads_p

        for (C, co) in widths:
            for key, n in ((("serve", shrink, C, co, False), serve["forward"].get((C, co), 0)),
                           (("train", shrink, C, co, False), train["forward"].get((C, co), 0)),
                           (("train", shrink, C, co, True), train["backward"].get((C, co), 0))):
                counts[key] = counts.get(key, 0) + n
        out.append({"subnet_type": subnet_type, "n_params": n_params, "serve_s": serve_s,
                    "launches_b6_test": {str(k): v for k, v in serve["forward"].items()},
                    "launches_b1_test": {str(k): v for k, v in serve["b1"].items()},
                    "launches_b6_step": {"forward": {str(k): v for k, v in train["forward"].items()},
                                         "backward": {str(k): v for k, v in train["backward"].items()}},
                    "lr_levels_differ": lr_differ, "hr_rel_l2_kernel_vs_plain": hr_l2,
                    "loss": log_k["loss"], "loss_rel_err_kernel_vs_plain": loss_rel,
                    "grad_rel_l2_kernel_vs_plain": grad_l2, "first_step_s": step_s,
                    "step_ms": step["median"], "step_plain_ms": step_p["median"]})
    emit("subnets", clip=clip.shape, batch=batch.shape, rel_l2_limit=SUBNET_REL_L2_LIMIT,
         loss_rel_limit=TRAIN_LOSS_REL_LIMIT, nets=out)


def library_temporal(x, w, b):
    """The same conv through one PyTorch library call (``F.conv3d`` with a
    (3,1,1) kernel) on NCDHW tensors: the yardstick, never called by the
    port."""
    return F.conv3d(x, w, b, padding=(1, 0, 0))


def phase_timing_temporal(device, counts, worst):
    """B6 at the shapes and widths the main paths launched it with: the
    forward at the serving and training latents (the collapse block's
    space-to-depth shrinks them 4x) and the data gradient (the kernel with
    the flipped weights) at the training latent: ms beside the bound, the
    plain version's ms and one ``F.conv3d``'s."""
    rng = np.random.default_rng(93)
    rows = []
    for (path, shrink, C, co, backward), launches in sorted(counts.items()):
        if not launches:
            continue
        B, T, H, W = {"serve": SERVE_SHAPE, "train": TRAIN_SHAPE, "haar_train_1": HAAR_TRAIN[1],
                      "haar_train_2": HAAR_TRAIN[2]}[path]
        name = path + ("/4" if shrink > 1 else "")
        rows.append(temporal_row(device, rng, name, (B, T, H // shrink, W // shrink), C, co, backward, launches,
                                 worst))
    emit("timing_temporal", rows=[{k: r[k] for k in ("name", "launches", "path", "ms", "ms_min", "plain_ms",
                                                      "library_ms", "bound_ms", "bound_fma_ms", "bound_by")}
                                  for r in rows])
    return rows


def temporal_row(device, rng, tag, shape, C, co, backward, launches, worst):
    """B6's kernels-line row at ``shape`` (B, T, H, W), C -> co: the forward
    or (``backward``) the data gradient, against its plain version and one
    ``F.conv3d``."""
    T = shape[1]
    x, w, b, g = make_temporal_conv(rng, shape, C, co, device)
    if backward:   # dx = the conv of g with the flipped weights, no bias
        x, w, b = g, tc._flipped(w), None
    ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
    lw = w.permute(2, 1, 0)[..., None, None].contiguous()
    with torch.no_grad():
        got = tc._forward_cuda(x, w, b, None, False)[0]
        want = tc.temporal_conv3_fused_plain(x, w, b)
        lib = library_temporal(ncdhw, lw, b).permute(0, 2, 3, 4, 1)
        err = (got - want).abs().max().item()
        check(err <= FP32_LIMIT, f"B6 vs plain at {shape} {C}->{co}: {err}")
        check((lib - want).abs().max().item() <= 1e-3, "the library conv computes the same function")
        ms = time_cuda(lambda: tc._launch(x, w, b, None, False))
        plain = time_cuda(lambda: tc.temporal_conv3_fused_plain(x, w, b))
        library = time_cuda(lambda: library_temporal(ncdhw, lw, b))
    M = int(np.prod(shape))
    cin, cout = (co, C) if backward else (C, co)
    bound, by = temporal_conv_bound_ms(M, cin, cout, T=T, peak=tc_peak(torch.float32))
    bound_fma, _ = temporal_conv_bound_ms(M, cin, cout, T=T)
    tile, split = tc.plan(shape[0], T, shape[2] * shape[3], cin, cout, x.element_size(), tc._sm_count(x))
    return {"name": f"temporal_conv3{'_dx' if backward else ''}[{C}->{co}]@{tag}",
            "route": "cuda", "source": SOURCE_TC, "replaces": REPLACES_TC, "launches": launches,
            "max_abs_err": max(err, worst.get((C, co), 0.0)), "ms": ms["median"], "plain_ms": plain["median"],
            "bound_ms": bound, "bound_by": by, "library_ms": library["median"], "bound_fma_ms": bound_fma,
            "path": f"{tile}/{split}", "ms_min": ms["min"], "plain_ms_min": plain["min"],
            "library_ms_min": library["min"], "shape": list(shape) + [co if backward else C]}


def variant_counts():
    return {"hg": dict(cv.launches_hg_by_width), "ride": dict(cv.launches_ride_by_width),
            "v3": dict(cv.launches_v3_by_width), "b1": dc.launches, "b3": dc.launches_feats,
            "b2": dc.launches_bwd, "b6": tc.launches}


def reset_all_counts():
    dc.reset_launch_counts()
    tc.reset_launch_counts()
    cv.reset_launch_counts()


def chain_pair(rng, shape, C, c_out, gc, device, dtype=torch.float32):
    """x, x2 and the H and G chains' parameters for one pair call."""
    x, hws, hbs, hw5, hb5, x2, _ = make_chain(rng, C, c_out, shape, device, dtype, gc)
    _, gws, gbs, gw5, gb5, _, _ = make_chain(rng, C, c_out, shape, device, dtype, gc)
    return x, x2, hws, hbs, hw5, hb5, gws, gbs, gw5, gb5


def within(got, want, fp32):
    """(max abs error, ok): 1e-4 abs in fp32, 3e-2 of max |ref| in bf16."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err <= (FP32_LIMIT if fp32 else BF16_REL_LIMIT * want.float().abs().max().item())


def phase_kernels_stripe(device):
    """B1 (every epilogue), B3 and B2 under a stripe against the plain
    versions of the striped calls (unpack, run per image, pack), fp32 and
    bf16, at the packed shapes the training steps run: 1e-4 abs and 3e-2 of
    max |ref| forward, the adjoint's limits backward, dW and db the same bits
    twice. Returns the worst fp32 errors by (C, c_out, gc) and by kernel and
    (C, gc)."""
    rng = np.random.default_rng(130)
    cases, worst = [], {"forward": {}, "feats": {}, "bwd": {}}
    for shape, stripe, C, c_out, gc in STRIPE_CHECKS:
        gcp = dc.padded_gc(gc)
        for dtype in (torch.float32, torch.bfloat16):
            fp32 = dtype == torch.float32
            x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, shape, device, dtype, gc)
            errs = {}
            for mode, n_aux in dc.EP_AUX.items():
                aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
                got = dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 0.8, aa, mm, stripe=stripe)
                errs[mode], ok = within(got, dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm,
                                                                      stripe_w=stripe), fp32)
                check(ok, f"striped B1 agrees with its plain version: {(shape, stripe, C, c_out, gc, dtype, mode, errs[mode])}")
            want_f = dc.padded_width(dc.chain_feats_plain(x, ws, bs, stripe), gc, gcp)
            got_f = dc.chain_feats(x, ws, bs, stripe)
            e_f, ok_f = within(got_f, want_f, fp32)
            g = seeded_grads(rng, want_f, device, dtype)        # noise in the pad lanes too
            dx0 = seeded_grads(rng, x, device)
            want = dc.chain_spatial_bwd_plain(x, ws, bs, want_f, g, dx0, stripe)
            got = dc.chain_spatial_bwd(x, ws, bs, want_f, g, dx0, stripe)
            again = dc.chain_spatial_bwd(x, ws, bs, want_f, g, dx0, stripe)
            torch.cuda.synchronize()
            flat = lambda r: [r[0], *r[1], *r[2]]  # noqa: E731
            e_dx, *e_p = [rel_err(u, v) for u, v in zip(flat(got), flat(want))]
            same_bits = all(torch.equal(u, v) for u, v in zip(flat(got), flat(again)))
            limit = BWD_FP32_REL_LIMIT if fp32 else BWD_BF16_REL_LIMIT
            cases.append({"shape": shape, "stripe_w": stripe, "dtype": str(dtype).split(".")[-1], "C": C,
                          "c_out": c_out, "gc": gc, "forward_max_abs_err": max(errs.values()),
                          "feats_max_abs_err": e_f, "dx_rel_err": e_dx, "dw_db_rel_err": max(e_p),
                          "same_bits_twice": same_bits})
            check(ok_f and max(e_dx, *e_p) <= limit and same_bits and np.isfinite(e_f + e_dx + max(e_p)),
                  f"striped B3 and B2 agree with their plain versions: {cases[-1]}")
            if fp32:
                worst["forward"][(C, c_out, gc)] = max(errs.values())
                worst["feats"][(C, gc)] = max(worst["feats"].get((C, gc), 0.0), e_f)
                worst["bwd"][(C, gc)] = max(worst["bwd"].get((C, gc), 0.0), (got[0] - want[0]).abs().max().item())
            del x, ws, bs, w5, b5, a, m, want_f, got_f, g, dx0, want, got, again
    emit("kernels_stripe", kernels=["dense_chain_t_ep", "chain_feats", "chain_spatial_bwd"], n_cases=len(cases),
         fp32_limit=FP32_LIMIT, bf16_rel_limit=BF16_REL_LIMIT, bwd_fp32_rel_limit=BWD_FP32_REL_LIMIT,
         bwd_bf16_rel_limit=BWD_BF16_REL_LIMIT, cases=cases)
    return worst


def by_stripe(counts):
    """Calls summed by stripe (the key's last entry)."""
    out = {}
    for key, n in counts.items():
        out[key[-1]] = out.get(key[-1], 0) + n
    return out


def chain_rows(device, tag, shape, stripe, fwd_widths, spatial_widths, counts, worst):
    """The kernels-line rows of B1 (``fwd_widths``: (C, c_out, gc), timed
    with the mul_add epilogue, held to its plain version with every
    epilogue), B3 and B2 (``spatial_widths``: (C, gc)) on ``shape``, W-packed
    under ``stripe`` (0: not packed), with their launches at that stripe. A
    packed call does the unpacked call's work: its bound is the unpacked
    shape's (the pad columns it no longer computes are not counted either
    way), and the library's yardstick is one F.conv3d chain at the unpacked
    shape. ``worst``: the checks' worst fp32 errors."""
    rng = np.random.default_rng(140)
    P = shape[3] // stripe if stripe else 1
    lat = (shape[0] * P, *shape[1:3], shape[3] // P)
    ncdhw = lambda t: t.permute(0, 4, 1, 2, 3).contiguous()  # noqa: E731
    rows = []

    def row(name, source, replaces, launches, err, ms, plain, library, bound, gc, C, bound_fma=None):
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": ms["median"], "plain_ms": plain["median"], "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": library["median"], "ms_min": ms["min"],
                     "plain_ms_min": plain["min"], "library_ms_min": library["min"], "shape": list(shape) + [C],
                     "stripe_w": stripe, "gc": gc, **({} if bound_fma is None else {"bound_fma_ms": bound_fma})})

    for C, c_out, gc in fwd_widths:
        args = make_chain(rng, C, c_out, shape, device, gc=gc)
        x, ws, bs, w5, b5, a, m = args
        err = max(chain_error(args, mode, stripe) for mode in dc.EP_AUX)
        check(err <= FP32_LIMIT, f"kernel vs plain at the timed shape: {(tag, C, c_out, gc, err)}")
        lib_args = to_library_layout(dc.unpack_w(x, P), ws, bs, w5, b5, dc.unpack_w(a, P), dc.unpack_w(m, P))
        want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "mul_add", 1.0, a, m, stripe_w=stripe)
        lib = dc.pack_w(library_chain(*lib_args).permute(0, 2, 3, 4, 1), P)
        check((lib - want).abs().max().item() <= 1e-3, "library chain computes the same function")
        del want, lib
        ms = time_cuda(lambda: dc.dense_chain_t_ep(x, ws, bs, w5, b5, "mul_add", 1.0, a, m, stripe=stripe), iters=10)
        plain = time_cuda(lambda: dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "mul_add", 1.0, a, m,
                                                            stripe_w=stripe), iters=10)
        library = time_cuda(lambda: library_chain(*lib_args), iters=10)
        row(f"dense_chain_t_ep[{C}->{c_out},gc{gc}]@{tag}", SOURCE, REPLACES,
            counts["forward_stripe"].get((C, c_out, gc, stripe), 0), max(err, worst["forward"][(C, c_out, gc)]), ms, plain,
            library, chain_bound_ms(*lat, C, c_out, 2, gc=gc, peak=TC_PEAK), gc, C,
            chain_bound_ms(*lat, C, c_out, 2, gc=gc)[0])
        del args, x, ws, bs, w5, b5, a, m, lib_args
    for C, gc in spatial_widths:
        x, ws, bs, *_ = make_chain(rng, C, 3, shape, device, gc=gc)
        feats = dc.chain_feats(x, ws, bs, stripe)
        g = seeded_grads(rng, feats, device)
        leaves = [ncdhw(dc.unpack_w(x, P)), *(w.permute(3, 2, 0, 1)[:, :, None].contiguous() for w in ws),
                  *(b.clone() for b in bs)]
        for t in leaves:
            t.requires_grad_(True)
        lx, lws, lbs = leaves[0], leaves[1:5], leaves[5:]
        lfeats = library_feats(lx, lws, lbs)
        lg = ncdhw(dc.unpack_w(dc.true_width(g, gc), P))
        check((dc.pack_w(lfeats.detach().permute(0, 2, 3, 4, 1), P) - dc.true_width(feats, gc)).abs().max().item()
              <= 1e-3, "library spatial chain computes the same function")
        with torch.no_grad():
            f_ms = time_cuda(lambda: dc.chain_feats(x, ws, bs, stripe), iters=10)
            f_plain = time_cuda(lambda: dc.chain_feats_plain(x, ws, bs, stripe), iters=10)
            f_lib = time_cuda(lambda: library_feats(lx, lws, lbs), iters=10)
        row(f"chain_feats[{C},gc{gc}]@{tag}", SOURCE, REPLACES_FEATS,
            counts["feats_stripe"].get((C, gc, stripe), 0), worst["feats"][(C, gc)], f_ms, f_plain, f_lib,
            chain_feats_bound_ms(*lat, C, gc=gc, peak=TC_PEAK), gc, C, chain_feats_bound_ms(*lat, C, gc=gc)[0])
        b_ms = time_cuda(lambda: dc.chain_spatial_bwd(x, ws, bs, feats, g, None, stripe), iters=10)
        b_plain = time_cuda(lambda: dc.chain_spatial_bwd_plain(x, ws, bs, feats, g, None, stripe), iters=10)
        b_lib = time_cuda(lambda: torch.autograd.grad(lfeats, leaves, lg, retain_graph=True), iters=10)
        row(f"chain_spatial_bwd[{C},gc{gc}]@{tag}", SOURCE_BWD, REPLACES_BWD,
            counts["backward_stripe"].get((C, gc, stripe), 0), worst["bwd"][(C, gc)], b_ms, b_plain, b_lib,
            chain_bwd_bound_ms(*lat, C, gc=gc, peak=TC_PEAK), gc, C, chain_bwd_bound_ms(*lat, C, gc=gc)[0])
        vs = against_parent(lambda: dc.chain_spatial_bwd(x, ws, bs, feats, g, None, stripe), iters=10)
        if vs:
            rows[-1]["vs_parent_ms"] = vs
        del x, ws, bs, feats, g, leaves, lfeats, lg
    return rows


def timed_in_turns(model, step, parts):
    """A whole step (median of 5 after a warm-up) and its parts, W-packed and
    with ``pack_w: false`` in turns (packed, unpacked, packed, unpacked) on
    the same model; the parts once each way, the peak memory of each way's
    steps. Leaves the model packed."""
    out = {True: {"step_ms": [], "peak_device_memory_gib": 0.0}, False: {"step_ms": [], "peak_device_memory_gib": 0.0}}
    for packed in (True, False, True, False):
        model.net.set_pack_w(packed)
        torch.cuda.reset_peak_memory_stats()
        out[packed]["step_ms"].append(time_cuda(step, iters=5, warmup=1)["median"])
        out[packed]["peak_device_memory_gib"] = max(out[packed]["peak_device_memory_gib"],
                                                    torch.cuda.max_memory_allocated() / 2 ** 30)
        if "parts" not in out[packed]:
            out[packed]["parts"] = parts()
    model.net.set_pack_w(True)
    return {("packed" if k else "unpacked"): {**v, "step_ms_median": float(np.median(v["step_ms"]))}
            for k, v in out.items()}


def phase_kernels_variants(device):
    """B7, B9 and B8 against their plain versions on the card, fp32 and bf16:
    the pair's y2 and se both ways, its backward route (B3 + B2 + glue)
    against the plain adjoint at the same features, the ride with every
    epilogue, v3; then the arguments each wrapper refuses on a CUDA tensor."""
    rng = np.random.default_rng(110)
    cases, worst = [], {}

    def note(kind, C, c_out, err, fp32):
        if fp32:
            worst[(kind, C, c_out)] = max(worst.get((kind, C, c_out), 0.0), err)

    for dtype in (torch.float32, torch.bfloat16):
        fp32, name = dtype == torch.float32, str(dtype).split(".")[-1]
        for shape, C, c_out, gc in HG_CHECKS:
            args = chain_pair(rng, shape, C, c_out, gc, device, dtype)
            for rev in (False, True):
                got = cv._hg_cuda(*args, 0.8, rev)
                want = cv.fused_hg_pair_plain(*args, 0.8, rev)
                (e_y, ok_y), (e_s, ok_s) = within(got[0], want[0], fp32), within(got[1], want[1], fp32)
                rec = {"kernel": "chain_hg", "dtype": name, "shape": list(shape), "C": C, "c_out": c_out,
                       "gc": gc, "rev": rev, "y2_err": e_y, "se_err": e_s, "ok": ok_y and ok_s}
                if shape != SERVE_SHAPE:   # the backward route at the same features
                    x, x2, *params = [t for a in args for t in (a if isinstance(a, list) else [a])]
                    g = [torch.from_numpy(rng.normal(0, 1, got[0].shape).astype(np.float32)).to(device, dtype)
                         for _ in range(2)]
                    feats = [dc.chain_feats(x, args[2], args[3]), dc.chain_feats(x, args[6], args[7])]
                    k = cv.hg_adjoint(x, x2, got[1], params, *g, 0.8, rev, feats)
                    p = cv.hg_adjoint(x, x2, got[1], params, *g, 0.8, rev, feats, plain=True)
                    rec["adjoint_rel_err"] = max(rel_err(u, v) for u, v in zip(k, p))
                    rec["ok"] = rec["ok"] and rec["adjoint_rel_err"] <= (
                        BWD_FP32_REL_LIMIT if fp32 else BWD_BF16_REL_LIMIT)
                torch.cuda.synchronize()
                note("hg", C, c_out, max(e_y, e_s), fp32)
                cases.append(rec)
                check(rec["ok"] and np.isfinite(e_y + e_s), f"B7 agrees with its plain version: {rec}")
        for shape, C, c_out, gc in RIDE_CHECKS:
            x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, shape, device, dtype, gc)
            for mode, n_aux in dc.EP_AUX.items():
                aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
                err, ok = within(cv._ride_cuda(x, ws, bs, w5, b5, mode, 0.8, aa, mm),
                                 cv.dense_chain_ride_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm), fp32)
                note("ride", C, c_out, err, fp32)
                cases.append({"kernel": "chain_ride", "dtype": name, "shape": list(shape), "C": C,
                              "c_out": c_out, "mode": mode, "err": err, "ok": ok})
                check(ok and np.isfinite(err), f"B9 agrees with its plain version: {cases[-1]}")
        for shape, C, c_out, gc in V3_CHECKS:
            x, ws, bs, w5, b5, _, _ = make_chain(rng, C, c_out, shape, device, dtype, gc)
            got = cv._v3_cuda(x, ws, bs, w5, b5)
            same_bits = torch.equal(got, cv._v3_cuda(x, ws, bs, w5, b5))
            err, ok = within(got, cv.dense_chain_v3_plain(x, ws, bs, w5, b5), fp32)
            note("v3", C, c_out, err, fp32)
            cases.append({"kernel": "chain_v3", "dtype": name, "shape": list(shape), "C": C, "c_out": c_out,
                          "gc": gc, "err": err, "same_bits_twice": same_bits, "ok": ok and same_bits})
            check(ok and same_bits and np.isfinite(err), f"B8 agrees with its plain version: {cases[-1]}")
    # the pair under autograd: one forward call, features twice (B3), the
    # adjoint twice (B2), G's conv5 again on the reverse (B6)
    args = chain_pair(rng, CHECK_SHAPE, 3, 48, 32, device)
    leaves = [t for a in args for t in (a if isinstance(a, list) else [a])]
    for t in leaves:
        t.requires_grad_(True)
    reset_all_counts()
    with torch.enable_grad():
        y2, se = cv.fused_hg_pair(*args, 0.8, True)
        torch.autograd.grad((y2.square().sum() + se.log().sum()), leaves)
    c = variant_counts()
    check((sum(c["hg"].values()), c["b3"], c["b2"], c["b6"], c["b1"]) == (1, 2, 2, 1, 0),
          f"the pair's launches under autograd: {c}")
    # on a CUDA tensor the wrappers launch or raise
    x, ws, bs, w5, b5, a, m = make_chain(rng, 3, 12, CHECK_SHAPE, device)
    hg = chain_pair(rng, CHECK_SHAPE, 3, 48, 32, device)
    before = (cv.launches_hg, cv.launches_ride, cv.launches_v3)
    refused = []
    for fault, error, fn in (
        ("pair with x2 of 12 channels", ValueError, lambda: cv.fused_hg_pair(hg[0], a, *hg[2:], 1.0, False)),
        ("ride at c_out 12", ValueError, lambda: cv._ride_cuda(x, ws, bs, w5, b5, "add", 1.0, a, None)),
        ("v3 with an epilogue", ValueError, lambda: cv._v3_cuda(x, ws, bs, w5, b5, "add", 1.0, a, None)),
        ("float64 v3", TypeError, lambda: cv.dense_chain_v3(x.double(), ws, bs, w5, b5)),
    ):
        try:
            fn()
        except error:
            refused.append(fault)
    check(len(refused) == 4 and (cv.launches_hg, cv.launches_ride, cv.launches_v3) == before,
          f"the variant wrappers refuse bad CUDA arguments: {refused}")
    emit("kernels_variants", kernels=["fused_hg_pair", "dense_chain_ride", "dense_chain_v3"],
         n_cases=len(cases), refused=refused, fp32_limit=FP32_LIMIT, bf16_rel_limit=BF16_REL_LIMIT,
         bwd_fp32_rel_limit=BWD_FP32_REL_LIMIT, cases=cases)
    return worst


def phase_variants(device):
    """The published 4x SelfC_GMM with ``chain_variants: [hg, ride, v3]``: a
    GOP request (``test(gop=7)``) on 7 Vid4-size frames, whose launches are
    kept, hr from one shared LR and noise against the plain path; then 3
    training steps at the published batch, the first's loss and whole
    gradient against the plain path, and a repeat of the first step (the
    same bits); then a GOP roundtrip and a step timed with the variants and
    with B1 in turns, on the same parameters."""
    rng = np.random.default_rng(100)
    clip = np.clip(rng.normal(0.5, 0.2, (1, 7, *CLIP_HW, 3)), 0, 1).astype(np.float32)
    network = {**NETWORK_G, "chain_variants": VARIANTS}
    model = RescaleModel(serve_options(network), device=device, rng_seed=0)
    tree = seeded_tree(model.net, 2)
    model.load_jax_params(tree)

    # ---- the main path: counts set to 0 just before, read just after ----
    reset_all_counts()
    model.generator.manual_seed(5)
    t0 = time.time()
    with torch.no_grad():
        model.feed_data({"GT": clip})
        model.test(gop=7)
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    serve = variant_counts()
    # ---------------------------------------------------------------------
    check({k: serve[k] for k in VARIANT_LAUNCHES} == VARIANT_LAUNCHES and serve["b1"] == 0,
          f"launches of one GOP roundtrip with the variants: {serve}")
    sr = model.get_current_visuals()["SR"]
    check(sr.shape == clip.shape and np.isfinite(sr).all(), "SR shape and finite")
    with torch.no_grad():
        lr_k = model.downscale(clip)
        model.generator.manual_seed(6)
        hr_k = model.upscale(lr_k)
        with plain_chain_on_card():
            before = (cv.launches_hg, cv.launches_ride, cv.launches_v3, dc.launches)
            lr_p = model.downscale(clip)
            model.generator.manual_seed(6)
            hr_p = model.upscale(lr_k)   # the same LR and the same noise as the kernel path
            check((cv.launches_hg, cv.launches_ride, cv.launches_v3, dc.launches) == before,
                  "the plain path launches no kernel")
    lr_differ = float(np.mean(np.abs(lr_k - lr_p) > 1e-6))
    hr_err = float(np.abs(hr_k - hr_p).max())
    check(lr_differ < 1e-3 and np.abs(lr_k - lr_p).max() < 1.01 / 255,
          f"downscale with the variants, kernel vs plain path: {lr_differ}")
    check(hr_err <= HR_LIMIT, f"upscale with the variants within {HR_LIMIT} of the plain path, got {hr_err}")
    gop = torch.rand((1, 7, *CLIP_HW, 3), device=device, generator=torch.Generator(device=device).manual_seed(0))
    eps_gop = torch.randn(model.net.eps_shape(SERVE_SHAPE + (3,)), device=device,
                          generator=torch.Generator(device=device).manual_seed(1))
    rt = {}
    with torch.no_grad():
        for names in (VARIANTS, [], VARIANTS, []):   # in turns
            model.net.set_chain_variants(names)
            rt.setdefault(bool(names), []).append(
                time_cuda(lambda: model.net.roundtrip(gop, eps=eps_gop), iters=5, warmup=1)["median"])
        model.net.set_chain_variants(VARIANTS)
        rt_parent = against_parent(lambda: model.net.roundtrip(gop, eps=eps_gop))
    del model, lr_k, hr_k, lr_p, hr_p, gop

    batch = train_batch(101)
    eps = rng.normal(0, 1, (*TRAIN_SHAPE, 48, 5)).astype(np.float32)
    trainer = new_trainer(device, tree, batch, network)
    # ---- the main path: counts set to 0 just before, read just after ----
    reset_all_counts()
    per_step = []
    for step in range(N_TRAIN_STEPS):
        trainer.optimize_parameters(step, eps=eps)
        per_step.append(variant_counts())
        if step == 0:
            log_k, grads_k, after_1 = dict(trainer.get_current_log()), grads_of(trainer), params_of(trainer)
        reset_all_counts()
    torch.cuda.synchronize()
    # ---------------------------------------------------------------------
    n_pair, n_ride, n_v3 = 16, 16, 6
    want_step = {**VARIANT_LAUNCHES, "b1": 0, "b3": 2 * n_pair + n_ride + n_v3, "b2": 2 * n_pair + n_ride + n_v3,
                 "b6": 8}
    check(all(c == want_step for c in per_step), f"launches of each training step with the variants: {per_step}")
    check(all(np.isfinite(v) for v in log_k.values()) and log_k["skipped_nonfinite"] == 0.0,
          f"the step's losses are finite and it was not skipped: {log_k}")
    plain = new_trainer(device, tree, batch, network)
    with plain_chain_on_card():
        plain.optimize_parameters(0, eps=eps)
    log_p, grads_p = dict(plain.get_current_log()), grads_of(plain)
    del plain
    loss_rel = abs(log_k["loss"] - log_p["loss"]) / abs(log_p["loss"])
    grad_l2 = grads_rel_l2(grads_k, grads_p)
    check(loss_rel <= TRAIN_LOSS_REL_LIMIT and grad_l2 <= TRAIN_GRAD_L2_LIMIT,
          f"a step with the variants, loss and whole gradient vs the plain path: {(loss_rel, grad_l2)}")
    del grads_k, grads_p
    again = new_trainer(device, tree, batch, network)
    again.optimize_parameters(0, eps=eps)
    differ = [k for k, p in again.net.named_parameters() if not torch.equal(p.detach(), after_1[k])]
    check(not differ, f"a repeated first step with the variants gives the same bits: {differ[:5]}")
    del again, after_1
    step_ms = {}
    for names in (VARIANTS, [], VARIANTS, []):   # in turns
        trainer.net.set_chain_variants(names)
        step_ms.setdefault(bool(names), []).append(
            time_cuda(lambda: trainer.optimize_parameters(N_TRAIN_STEPS, eps=eps), iters=5, warmup=1)["median"])
    trainer.net.set_chain_variants(VARIANTS)
    step_parent = against_parent(lambda: trainer.optimize_parameters(N_TRAIN_STEPS, eps=eps))
    del trainer
    emit("variants", chain_variants=VARIANTS, clip=clip.shape, batch=batch.shape, serve_s=serve_s,
         launches_test={k: {str(w): n for w, n in serve[k].items()} for k in VARIANT_LAUNCHES},
         launches_b1_test=serve["b1"],
         launches_per_step=[{k: ({str(w): n for w, n in v.items()} if isinstance(v, dict) else v)
                             for k, v in c.items()} for c in per_step],
         lr_levels_differ=lr_differ, hr_max_abs_err_kernel_vs_plain=hr_err, hr_limit=HR_LIMIT,
         loss_rel_err_kernel_vs_plain=loss_rel, grad_l2_rel_err_kernel_vs_plain=grad_l2,
         grad_l2_limit=TRAIN_GRAD_L2_LIMIT, repeat_bit_identical=True,
         gop_roundtrip_ms=float(np.median(rt[True])), gop_roundtrip_ms_b1=float(np.median(rt[False])),
         gop_roundtrip_ms_turns={"variants": rt[True], "b1": rt[False]},
         step_ms=float(np.median(step_ms[True])), step_ms_b1=float(np.median(step_ms[False])),
         step_ms_turns={"variants": step_ms[True], "b1": step_ms[False]},
         gop_roundtrip_ms_vs_parent=rt_parent, step_ms_vs_parent=step_parent)
    return serve, per_step[0]


def library_pair(h_lib, g_lib, x2_lib, clamp=1.0):
    """The pair through PyTorch's library convolutions: H's chain, the
    scale, then G's chain with the mul_add combine."""
    se = torch.exp(clamp * (2.0 * torch.sigmoid(library_chain(*h_lib)) - 1.0))
    return library_chain(*g_lib, x2_lib, se), se


def phase_timing_variants(device, serve, step, worst):
    """B7, B9 and B8 at the shapes and widths the variants phase launched them
    with: ms beside the bound, the plain version's ms, the library chain's and
    B1's ms at the same shape and width (for the pair, B1's two epilogue
    calls it replaces)."""
    rng = np.random.default_rng(120)
    rows = []
    specs = [("hg", 3, 48), ("ride", 48, 3), ("v3", 64, 64), ("v3", 3, 64)]
    for path, shape, counts in (("serve", SERVE_SHAPE, serve), ("train", TRAIN_SHAPE, step)):
        for kind, C, c_out in specs:
            if kind == "hg":
                n = sum(v for k, v in counts["hg"].items() if k[:2] == (C, c_out))
                args = chain_pair(rng, shape, C, c_out, 32, device)
                x, x2 = args[0], args[1]
                h, g = args[2:6], args[6:10]
                got = cv._hg_cuda(*args, 1.0, False)
                want = cv.fused_hg_pair_plain(*args, 1.0, False)
                err = max((u - v).abs().max().item() for u, v in zip(got, want))
                lib_h = to_library_layout(x, *h, None, None)[:5]
                lib_g = to_library_layout(x, *g, None, None)[:5]
                x2_lib = x2.permute(0, 4, 1, 2, 3).contiguous()
                lib = [t.permute(0, 2, 3, 4, 1) for t in library_pair(lib_h, lib_g, x2_lib)]
                check(max((u - v).abs().max().item() for u, v in zip(lib, want)) <= 1e-3,
                      "the library pair computes the same function")
                fn = lambda: cv._hg_cuda(*args, 1.0, False)  # noqa: E731
                plain_fn = lambda: cv.fused_hg_pair_plain(*args, 1.0, False)  # noqa: E731
                lib_fn = lambda: library_pair(lib_h, lib_g, x2_lib)  # noqa: E731

                def b1_fn():
                    s = dc._chain_cuda(x, *h, "sig_exp", 1.0, None, None)[0]
                    return dc._chain_cuda(x, *g, "mul_add", 1.0, x2, s)[0]
                # B7 runs its products as 3xTF32, as B1 does
                bound, by = hg_bound_ms(*shape, C, c_out, peak=TC_PEAK)
                bound_fma = hg_bound_ms(*shape, C, c_out)[0]
                name, source, replaces = f"fused_hg_pair[{C}->{c_out}]@{path}", SOURCE_HG, REPLACES_HG
            else:
                key = (C, c_out, 32)
                n = counts[kind].get(key, 0)
                x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, shape, device)
                mode = "add" if kind == "ride" else "none"
                aa = a if kind == "ride" else None
                launch = cv._ride_cuda if kind == "ride" else cv._v3_cuda
                fn = lambda: launch(x, ws, bs, w5, b5, mode, 1.0, aa, None)  # noqa: E731
                plain_fn = lambda: dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 1.0, aa, None)  # noqa: E731
                err = (fn() - plain_fn()).abs().max().item()
                lib_args = to_library_layout(x, ws, bs, w5, b5, None, None)[:5]
                lib_a = aa.permute(0, 4, 1, 2, 3).contiguous() if aa is not None else None
                lib_fn = ((lambda: library_chain(*lib_args) + lib_a) if aa is not None  # noqa: E731
                          else (lambda: library_chain(*lib_args)))
                b1_fn = lambda: dc._chain_cuda(x, ws, bs, w5, b5, mode, 1.0, aa, None)  # noqa: E731
                n_aux = 1 if aa is not None else 0
                # B8 and B9 run their products as 3xTF32, as B1 does
                bound, by = chain_bound_ms(*shape, C, c_out, n_aux, peak=TC_PEAK)
                bound_fma = chain_bound_ms(*shape, C, c_out, n_aux)[0]
                name = f"dense_chain_{kind}[{C}->{c_out}]@{path}"
                source, replaces = (SOURCE_RIDE, REPLACES_RIDE) if kind == "ride" else (SOURCE_V3, REPLACES_V3)
            check(err <= FP32_LIMIT, f"{name} vs plain at the timed shape: {err}")
            ms, plain, library, b1 = (time_cuda(f) for f in (fn, plain_fn, lib_fn, b1_fn))
            vs = against_parent(fn, iters=10) if kind == "hg" else None
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": n,
                "max_abs_err": max(err, worst.get((kind, C, c_out), 0.0)), "ms": ms["median"],
                "plain_ms": plain["median"], "bound_ms": bound, "bound_by": by, "library_ms": library["median"],
                "bound_fma_ms": bound_fma, "b1_ms": b1["median"], "ms_min": ms["min"], "plain_ms_min": plain["min"],
                "library_ms_min": library["min"], "b1_ms_min": b1["min"], "shape": list(shape) + [C],
                **({"vs_parent_ms": vs} if vs else {})})
    emit("timing_variants", rows=[{k: r[k] for k in ("name", "launches", "ms", "ms_min", "b1_ms", "plain_ms",
                                                      "library_ms", "bound_ms", "bound_fma_ms", "bound_by")}
                                  for r in rows])
    return rows


def phase_codec_pipeline(device, tree, batch):
    """``train.codec_pipeline`` at the published batch. The first pipelined
    update, retired by ``flush_pipeline()``, against the serial step (both
    under cuDNN's deterministic algorithms, the models' default): the same
    logs and parameters, bit for bit. Then the serial and the pipelined step in
    turns (serial, pipelined, pipelined, serial), each turn 1 warm-up call
    and N_PIPE_STEPS timed ones (host clock, synchronised at the end; a
    pipelined turn's timed calls retire N_PIPE_STEPS updates), with each
    call's host codec wall time and the wait it cost the step."""
    serial = new_codec_trainer(device, tree, batch)
    serial.optimize_parameters(0)
    log_s = dict(serial.get_current_log())
    want = {k: p.detach().clone() for k, p in serial.params.named_parameters()}
    del serial
    pipe = new_codec_trainer(device, tree, batch, codec_pipeline=True)
    pipe.optimize_parameters(0)
    check(not pipe.get_current_log(), "the first pipelined call queues its batch and updates nothing")
    pipe.flush_pipeline()
    log_p = dict(pipe.get_current_log())
    differ = [k for k, p in pipe.params.named_parameters() if not torch.equal(p.detach(), want[k])]
    del pipe, want
    check(not differ and log_p == log_s,
          f"the first pipelined update is the serial step's bits: {len(differ)} leaves differ, logs {log_p} / {log_s}")

    out = {"zlib": pipeline_turns(device, tree, batch)}
    # what the pipelined step loses to: a host codec that holds the
    # interpreter lock (zlib's numpy work), or the pipeline itself. The same
    # turns with a stand-in that sleeps the zlib codec's median wall time
    # (the lock free; the clip comes back rounded), and with the codec's
    # output given (no host codec at all)
    nap = float(np.median([t for r in out["zlib"]["serial"]["turns"] for t in r["codec_tot_s"]]))
    out["sleep"] = pipeline_turns(device, tree, batch, host_codec=sleeping_codec(nap))
    out["sleep"]["sleep_s"] = nap
    n, t, h, w, _ = CODEC_TRAIN_SHAPE
    scale = codec_train_options()["scale"]
    fed = np.random.default_rng(27).random((n, t, h // scale, w // scale, 3), dtype=np.float32)
    out["fed"] = pipeline_turns(device, tree, batch, codec_out=fed)
    emit("codec_pipeline", batch=CODEC_TRAIN_SHAPE, first_update_same_bits=True, under="the step's deterministic cuDNN algorithms (default)",
         steps_per_turn=N_PIPE_STEPS, order="serial, pipelined, pipelined, serial",
         host_codec=h265.codec_backend() or "stand-in", **out)
    return out


def sleeping_codec(seconds):
    """A host codec that sleeps ``seconds`` (holding no interpreter lock)
    and gives the clip back rounded to 8 bits: ``CodecModel._host_codec``'s
    contract."""
    def host_codec(lr_q, q):
        t0 = time.perf_counter()
        time.sleep(seconds)
        out = torch.from_numpy(np.round(np.asarray(lr_q, np.float32) * 255.0) / 255.0).pin_memory()
        return out, 0.0, time.perf_counter() - t0
    return host_codec


def pipeline_turns(device, tree, batch, host_codec=None, codec_out=None):
    """The serial and the pipelined codec step in turns (serial, pipelined,
    pipelined, serial), each turn 1 warm-up call and N_PIPE_STEPS timed ones
    (host clock, synchronised at the end; a pipelined turn's timed calls
    retire N_PIPE_STEPS updates), with each call's host codec wall time and
    the wait it cost the step. ``host_codec`` replaces the models' host
    codec; ``codec_out`` is given to every call in place of one."""
    models = {False: new_codec_trainer(device, tree, batch),
              True: new_codec_trainer(device, tree, batch, codec_pipeline=True)}
    if host_codec is not None:
        for model in models.values():
            model._host_codec = host_codec
    turns = {False: [], True: []}
    for pipelined in (False, True, True, False):
        model = models[pipelined]
        model.optimize_parameters(1, codec_out=codec_out)
        torch.cuda.synchronize()
        tot, wait = [], []
        t0 = time.perf_counter()
        for step in range(2, 2 + N_PIPE_STEPS):
            model.optimize_parameters(step, codec_out=codec_out)
            tot.append(model.last_codec_total_seconds)
            wait.append(model.last_codec_host_seconds)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / N_PIPE_STEPS
        if pipelined:
            model.flush_pipeline()
        log = dict(model.get_current_log())
        check(np.isfinite(log["loss"]) and log["skipped_nonfinite"] == 0.0, f"the timed steps are finite: {log}")
        turns[pipelined].append({"step_ms": ms, "codec_tot_s": tot, "codec_wait_s": wait})
    del models
    out = {}
    for pipelined, rows in turns.items():
        out["pipelined" if pipelined else "serial"] = {
            "step_ms": [r["step_ms"] for r in rows],
            "step_ms_median": float(np.median([r["step_ms"] for r in rows])),
            "codec_tot_s_median": float(np.median([t for r in rows for t in r["codec_tot_s"]])),
            "codec_wait_s_median": float(np.median([t for r in rows for t in r["codec_wait_s"]])),
            "turns": rows}
    return out


# ---------------------------------------------------------------------------
# cli: the port's entry points as a user runs them
# ---------------------------------------------------------------------------

# Runs a CLI module as ``python -m`` does and writes the kernel launch
# counts of the whole process (the CLI's path: counts start at 0) at its exit.
CLI_RUNNER = """
import json, runpy, sys
from selfc_tpu_torch.ops import chain_variants as cv, deform as df, dense_chain as dc, temporal_conv as tc
module, counts_path = sys.argv[1], sys.argv[2]
sys.argv = [module] + sys.argv[3:]
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    def w(d):
        return {str(k): n for k, n in d.items()}
    with open(counts_path, "w") as f:
        json.dump({"B1": dc.launches, "B1_by_width": w(dc.launches_by_width),
                   "B1_by_stripe": w(dc.launches_by_stripe), "B3": dc.launches_feats,
                   "B2": dc.launches_bwd, "B2_by_width": w(dc.launches_bwd_by_width),
                   "B4": dc.launches_spatial, "B4_bwd": dc.launches_spatial_bwd,
                   "B5": df.launches, "B5_bwd": df.launches_bwd, "B6": tc.launches,
                   "B6_bwd": tc.launches_bwd, "B7": cv.launches_hg, "B8": cv.launches_v3,
                   "B9": cv.launches_ride}, f)
"""


def run_cli(work, module, args, device, tag=""):
    """``python -m module args --device ...`` in ``work`` (a subprocess, this
    checkout on its path): ``(launch counts, seconds)``; a failure shows the
    end of its stderr."""
    short = module.rsplit(".", 1)[1] + tag
    counts_path = work / f"{short}_counts.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", CLI_RUNNER, module, str(counts_path), *args,
                           "--device", str(device)],
                          cwd=work, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT)
    seconds = time.time() - t0
    check(proc.returncode == 0, f"{module} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(counts_path.read_text()), seconds


def render_packed(out, clips, frames, h, w, seed):
    """The synthetic set of ``tools/make_synth_data.py`` (one generator over
    the clips, frames rounded to uint8 as its PNG writer does) packed in
    memory as ``tools/pack_dataset.py`` packs the PNGs."""
    rng = np.random.default_rng(seed)
    return write_packed(str(out), ((f"clip{v:03d}", [to_uint8(f) for f in render_clip(rng, frames, h, w)])
                                   for v in range(clips)))


def format_regex(fmt):
    """A root CLI's format string as a regex, a field by its presentation type."""
    kinds = {"d": r"[ \d,]+", "e": r"-?(?:\d\.\d+e[+-]\d+|nan|inf)", "f": r"-?\d+\.\d+", "s": r"\S+ *"}
    out = ""
    for literal, field, spec, _ in string.Formatter().parse(fmt):
        out += re.escape(literal)
        if field is not None:
            out += kinds.get((spec or "")[-1:], r".*?")
    return out


def root_formats(path):
    """The string constants with a replacement field in a root source file."""
    return {n.value for n in ast.walk(ast.parse((ROOT / path).read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and "{" in n.value}


def log_messages(directory, prefix):
    (path,) = Path(directory).glob(f"{prefix}_*.log")
    return [ln.split(" - INFO: ", 1)[1] for ln in path.read_text().splitlines() if " - INFO: " in ln], path


def averaged(msgs, part):
    fmt = f"Averaged {part} results for all datasets, PSNR {{:.6f}}dB, SSIM {{:.6f}}"
    hits = [re.fullmatch(format_regex(fmt), m) for m in msgs]
    vals = [tuple(float(v) for v in re.findall(r"-?\d+\.\d+", m)) for m, h in zip(msgs, hits) if h]
    check(len(vals) == 1, f"one '{fmt}' line: {msgs[-4:]}")
    return vals[0]


def step_logs(lines):
    """``(iters, logs)`` of ``cli.train``'s step lines."""
    logs = [{k: float(v) for k, v in re.findall(r"(\w+): (\S+) ", m.split("> ", 1)[1])} for m in lines]
    iters = [int(re.search(r"iter:\s*([\d,]+),", m).group(1).replace(",", "")) for m in lines]
    return iters, logs


def cli_train_yaml(work, train_dir, val_dir, extra=None):
    """The 400k run's YAML with dataroot_GT (train and val), path.resume_state,
    logger.print_freq, n_workers and rng_seed changed, and ``extra``
    (``{"a.b": value}``); returns (path, the changes)."""
    import yaml

    opt = yaml.safe_load((ROOT / CLI_TRAIN_YML).read_text())
    changes = {"datasets.train.dataroot_GT": str(train_dir), "datasets.val1.dataroot_GT": str(val_dir),
               "path.resume_state": str(ROOT / QUALITY_STATE), "logger.print_freq": CLI_PRINT_FREQ,
               "datasets.train.n_workers": CLI_WORKERS, "datasets.train.rng_seed": CLI_RNG_SEED,
               **(extra or {})}
    for key, v in changes.items():
        *head, last = key.split(".")
        d = opt
        for k in head:
            d = d[k]
        d[last] = v
    path = work / "train_400k.yml"
    path.write_text(yaml.safe_dump(opt))
    return path, changes


def gan_cli_yaml(work, train_dir, val_dir, extra=None):
    """``train_rescaling_gan.yml`` as shipped, its datasets pointed at the
    rendered packed sets (``LQGTVID_packed``, n_workers and rng_seed as the
    400k run's), a save every GAN_CLI_SAVE steps, and ``extra``
    (``{"a.b": value}``); returns (path, the changes)."""
    import yaml

    opt = yaml.safe_load((ROOT / GAN_YML).read_text())
    changes = {"datasets.train.mode": "LQGTVID_packed", "datasets.train.dataroot_GT": str(train_dir),
               "datasets.train.n_workers": CLI_WORKERS, "datasets.train.rng_seed": CLI_RNG_SEED,
               "datasets.val1.mode": "LQGTVID_packed", "datasets.val1.dataroot_GT": str(val_dir),
               "logger.print_freq": 5, "logger.save_checkpoint_freq": GAN_CLI_SAVE, "train.niter": GAN_CLI_STEPS,
               **(extra or {})}
    for key, v in changes.items():
        *head, last = key.split(".")
        d = opt
        for k in head:
            d = d[k]
        d[last] = v
    path = work / f"train_gan{len(extra or {})}.yml"
    path.write_text(yaml.safe_dump(opt))
    return path, changes


def phase_cli_gan(work, train_dir, val_dir, device):
    """``cli.train`` on ``train_rescaling_gan.yml`` (random G, D and F at full
    width): GAN_CLI_SAVE steps and a save, then a second process resumed
    from that ``.state`` (G, D, their Adam states, D's statistics) to
    GAN_CLI_STEPS. Its losses finite, the ``_D`` files and the ``.state``
    read back."""
    import yaml

    name = yaml.safe_load((ROOT / GAN_YML).read_text())["name"]
    root = work / "experiments" / name
    yml, changes = gan_cli_yaml(work, train_dir, val_dir)
    counts, first_s = run_cli(work, "selfc_tpu_torch.cli.train", ["-opt", str(yml), "--max-iters", str(GAN_CLI_SAVE)],
                              device, "_gan")
    state = root / "training_state" / f"{GAN_CLI_SAVE}.state"
    check(state.exists() and (root / "models" / f"{GAN_CLI_SAVE}_D.msgpack").exists(),
          f"the first GAN run wrote {GAN_CLI_SAVE}_D.msgpack and {GAN_CLI_SAVE}.state")
    yml2, _ = gan_cli_yaml(work, train_dir, val_dir, {"path.resume_state": str(state)})
    counts2, second_s = run_cli(work, "selfc_tpu_torch.cli.train", ["-opt", str(yml2)], device, "_gan_resumed")
    # one log file a process
    msgs = [ln.split(" - INFO: ", 1)[1] for path in sorted(root.glob(f"train_{name}_*.log"))
            for ln in path.read_text().splitlines() if " - INFO: " in ln]
    check(any(m.startswith("Resuming training from epoch: ") and m.endswith(f"iter: {GAN_CLI_SAVE}.") for m in msgs),
          f"the second GAN run resumed iter {GAN_CLI_SAVE}")
    iters, logs = step_logs([m for m in msgs if m.startswith("<epoch:")])
    check(iters == list(range(5, GAN_CLI_STEPS + 1, 5)) and all(
        np.isfinite(v) for lg in logs for v in lg.values()) and all(
        {"l_g_gan", "l_g_fea", "l_d", "D_real", "D_fake"} <= set(lg) and lg["skipped_nonfinite"] == 0.0 for lg in logs),
        f"the GAN runs' step lines: {list(zip(iters, logs))}")
    d_files = {}
    for it in (GAN_CLI_SAVE, GAN_CLI_STEPS):
        tree = flatten_tree(checkpoint.read_msgpack(str(root / "models" / f"{it}_D.msgpack")))
        payload = checkpoint.load_training_state(str(root / "training_state" / f"{it}.state"))
        count, mu, _ = checkpoint.adam_moments(payload["extra"]["d_opt_state"])
        check(all(np.isfinite(v).all() for v in tree.values()) and count == it
              and set(flatten_tree(mu)) == set(tree) and set(payload["extra"]["d_stats"]) == {
                  k.split(".")[0] for k in tree if k.startswith("bn")},
              f"{it}_D.msgpack and {it}.state read back: D's leaves, its Adam state at count {it}, its statistics")
        d_files[it] = {"D_leaves": len(tree), "D_params": int(sum(v.size for v in tree.values())), "adam_count": count}
    check(counts["B1"] >= 1 and counts["B2"] >= 1 and counts2["B2"] >= 1, f"the GAN runs launched B1 and B2: {counts}")
    return {"yaml": GAN_YML, "yaml_changes": changes, "s": [first_s, second_s], "logs": dict(zip(iters, logs)),
            "files": d_files, "launches": [counts, counts2]}


def clip_timing(lines):
    """``test_s`` / ``gpu_test_s`` (seconds a clip) of an eval CLI's last
    timing line; the device's clock must have been read."""
    hits = [dict(re.findall(r"(\w+): (\S+) ", ln.split("clips: ", 1)[1])) for ln in lines if "Timing over " in ln]
    check(len(hits) == 1 and {"test_s", "gpu_test_s"} <= set(hits[0]), f"one timing line with gpu_test_s: {hits}")
    return {k: float(v) for k, v in hits[0].items()}


def cli_test_yaml(work, name, src, datasets, pretrain, **top):
    """A test YAML: ``src``'s model and network_G, the given datasets and
    checkpoint."""
    import yaml

    base = yaml.safe_load((ROOT / src).read_text())
    opt = {"name": name, "model": base["model"], "distortion": base["distortion"], "scale": base["scale"],
           "datasets": datasets, "network_G": base["network_G"], "path": {"pretrain_model_G": pretrain}, **top}
    path = work / f"{name}.yml"
    path.write_text(yaml.safe_dump(opt))
    return path


def cli_sets(work):
    """The rendered train, val and codec sets of the ``cli`` and ``profile``
    phases under ``work`` (rendered at the first call): ``(train_dir,
    val_dir, codec_dir, seconds spent rendering)``."""
    dirs = work / "train_packed", work / "val_packed", work / "codec_packed"
    t0 = time.time()
    if not dirs[0].exists():
        for d, spec in zip(dirs, (CLI_TRAIN_SET, CLI_VAL_SET, CLI_CODEC_SET)):
            render_packed(d, **spec)
    return (*dirs, time.time() - t0)


def phase_cli(device, work):
    """The port's entry points as a user runs them, each a subprocess in the
    working directory ``work`` (``parse`` roots experiments/ and results/
    at the cwd): the 400k run resumed at iter 164,339 by ``cli.train`` for
    CLI_STEPS steps on the rendered train set, ``cli.test_rescaling`` on the
    committed checkpoint and on the one the run wrote, ``cli.test_compression``
    on the published codec net (random weights) with the zlib stand-in. The
    run's items are seeded (``rng_seed``), so it repeats; the checkpoint it
    writes 11 steps in is measured in this process, which tells a resume
    that restored Adam's state from one that did not."""
    t_phase = time.time()
    train_dir, val_dir, codec_dir, render_s = cli_sets(work)
    models = work / "experiments" / CLI_NAME / "models"
    models.mkdir(parents=True)
    shutil.copyfile(ROOT / QUALITY_CKPT, models / f"{CLI_RESUME_ITER}_G.msgpack")
    yml, changes = cli_train_yaml(work, train_dir, val_dir, {"logger.save_checkpoint_freq": CLI_PRINT_FREQ})
    last = CLI_RESUME_ITER + CLI_STEPS

    counts_train, train_s = run_cli(work, "selfc_tpu_torch.cli.train", ["-opt", str(yml), "--max-iters", str(last)],
                                    device)
    msgs, _ = log_messages(work / "experiments" / CLI_NAME, f"train_{CLI_NAME}")
    check(any(m.startswith(f"Resuming training from epoch: ") and m.endswith(f"iter: {CLI_RESUME_ITER}.")
              for m in msgs), "the run resumed iter 164,339")
    fmts = root_formats("train.py")
    step_re = re.compile(format_regex("<epoch:{:3d}, iter:{:8,d}, lr:{:.3e}> ")
                         + "(?:" + format_regex("{:s}: {:.4e} ") + ")+$")
    lines = [m for m in msgs if m.startswith("<epoch:")]
    check({"<epoch:{:3d}, iter:{:8,d}, lr:{:.3e}> ", "{:s}: {:.4e} "} <= fmts
          and all(step_re.match(m) for m in lines), f"the step lines are train.py's: {lines[:1]}")
    iters, logs = step_logs(lines)
    want_iters = list(range(CLI_RESUME_ITER - CLI_RESUME_ITER % CLI_PRINT_FREQ + CLI_PRINT_FREQ, last + 1,
                            CLI_PRINT_FREQ))
    check(iters == want_iters, f"logged iterations {iters} (expected {want_iters})")
    check(all(np.isfinite(v) for lg in logs for v in lg.values())
          and all(lg["skipped_nonfinite"] == 0.0 for lg in logs), f"every logged value finite, none skipped: {logs}")
    means = {k: float(np.mean([lg[k] for lg in logs])) for k in CLI_LOSS_RANGES}
    for k, (lo, hi) in CLI_LOSS_RANGES.items():
        check(lo <= means[k] <= hi, f"mean logged {k} {means[k]} within [{lo}, {hi}]")
    written = models / "latest_G.msgpack"
    check(written.exists(), "the run wrote latest_G.msgpack")
    flat = flatten_tree(checkpoint.read_msgpack(str(written)))
    start = flatten_tree(checkpoint.read_msgpack(str(ROOT / QUALITY_CKPT)))
    check(len(flat) == QUALITY_LEAVES and all(np.isfinite(v).all() for v in flat.values())
          and any(not np.array_equal(v, start[k]) for k, v in flat.items()),
          "latest_G.msgpack: every leaf finite, the weights moved")

    val = {"val1": {"name": "synthval", "mode": "LQGTVID_packed", "dataroot_GT": str(val_dir), "video_len": 7}}
    quality = {}
    counts_eval = {}
    for tag, ckpt in (("committed", ROOT / QUALITY_CKPT), ("written", written)):
        name = f"test_400k_{tag}"
        tyml = cli_test_yaml(work, name, CLI_TRAIN_YML, val, str(ckpt), val={"sample_seed": 0})
        counts_eval[tag], secs = run_cli(work, "selfc_tpu_torch.cli.test_rescaling",
                                         ["-opt", str(tyml), "--no-images"], device, f"_{tag}")
        msgs, _ = log_messages(work / "results" / name, f"test_{name}")
        hr, lr = averaged(msgs, "HR"), averaged(msgs, "LR")
        quality[tag] = {"hr_psnr": hr[0], "hr_ssim": hr[1], "lr_psnr": lr[0], "lr_ssim": lr[1], "s": secs,
                        **clip_timing(msgs)}
    q = quality["committed"]
    for part in ("hr", "lr"):
        ref, tol = CLI_QUALITY[part]
        check(abs(q[f"{part}_psnr"] - ref) <= tol, f"{part.upper()} Y-PSNR of iter 164,339 through the test "
              f"CLI {q[f'{part}_psnr']} within {tol} dB of {ref}")
    ref, tol = CLI_TRAINED_HR
    check(abs(quality["written"]["hr_psnr"] - ref) <= tol,
          f"the written checkpoint's HR {quality['written']['hr_psnr']} within {tol} dB of {ref}")
    early = val_quality(models / f"{CLI_EARLY_ITER}_G.msgpack", device, work / "q")
    check(early["hr_psnr"] >= CLI_EARLY_HR_MIN,
          f"iter {CLI_EARLY_ITER}'s HR {early['hr_psnr']} >= {CLI_EARLY_HR_MIN} dB (Adam's state restored)")

    name = "test_codec_cli"
    cset = {"test_1": {"name": "synthcodec", "mode": "LQGTVID_packed", "dataroot_GT": str(codec_dir),
                       "video_len": CLI_CODEC_SET["frames"], "batch_size": 1}}
    cyml = cli_test_yaml(work, name, CLI_CODEC_YML, cset, None, val={"standin_codec": "zlib"})
    counts_codec, codec_s = run_cli(work, "selfc_tpu_torch.cli.test_compression", ["-opt", str(cyml), "--no-images"],
                                    device)
    (path,) = (work / "results" / name).glob(f"test_{name}_*.log")
    text = path.read_text()
    cfmts = root_formats("test_compression.py")
    per_clip = next(f for f in cfmts if f.startswith("{:20s} - video_distor_loss"))
    n_clip = len(re.findall(format_regex(per_clip), text))
    n_avg = {p: len(re.findall(format_regex(next(f for f in cfmts if f.startswith(p))), text))
             for p in ("----Average PSNR/SSIM results for {}", "----Average Compression results for {}")}
    rate = h265.rate_source("zlib")
    check(n_clip == CLI_CODEC_SET["clips"] and all(n == 2 for n in n_avg.values()) and f"[rate: {rate}]" in text,
          f"test_compression's lines parse: {n_clip} clip lines, {n_avg} average lines")
    avg_line = re.search(format_regex(next(f for f in cfmts if f.startswith("----Average PSNR/SSIM"))), text)
    codec_timing = clip_timing(text.splitlines())
    gan = phase_cli_gan(work, train_dir, val_dir, device)
    check(counts_train["B1"] >= 1 and counts_train["B2"] >= 1
          and all(c["B1"] >= 1 for c in (*counts_eval.values(), counts_codec)),
          f"the CLIs' paths launched B1 (the train CLI B2 too): {counts_train} {counts_eval} {counts_codec}")
    emit("cli", phase_s=time.time() - t_phase, render_s=render_s,
         train_set={**CLI_TRAIN_SET, "cut": "the first 48 of tools/train400k_loop.sh's 240 clips (one rng stream)"},
         val_set=CLI_VAL_SET, yaml=CLI_TRAIN_YML, yaml_changes=changes, max_iters=last,
         train={"s": train_s, "logs": dict(zip(iters, logs)), "mean": means, "limits": CLI_LOSS_RANGES,
                "loader_share_data_s_over_wall_s": [lg["data_s"] / lg["wall_s"] for lg in logs if "wall_s" in lg],
                "launches": counts_train},
         rescaling=quality, rescaling_reference=CLI_QUALITY, rescaling_launches=counts_eval,
         written_reference=CLI_TRAINED_HR, early={"iter": CLI_EARLY_ITER, **early, "min": CLI_EARLY_HR_MIN},
         compression={"s": codec_s, "yaml": CLI_CODEC_YML, "set": CLI_CODEC_SET, "rate_source": rate, "clip_lines": n_clip,
                      "average_lines": n_avg, "average": avg_line.group(0) if avg_line else None,
                      "launches": counts_codec, **codec_timing}, gan=gan)


# the profile phase: cli.train resumed at iter 164,339 for PROFILE_RUN steps,
# the window PROFILE_STEPS steps from its PROFILE_AT-th (164,349-164,351);
# prints at 164,340, 164,344 and 164,348: the first interval holds the
# warm-up, the next two steady steps, and none falls in the window, so the
# timer's read adds no synchronisation inside it
PROFILE_RUN, PROFILE_AT, PROFILE_STEPS, PROFILE_PRINT_FREQ = 12, 10, 3, 4
PROFILE_SERVE_GOPS = 3
# the chain's share from CUDA-event sums (PERF.md §3, the chain wrapper's row)
CHAIN_SHARE_EVENTS = {"gop_roundtrip": 0.82, "packed_step": 0.57}


def trace_split(trace_dir, counts, n, chain):
    """``profile_step.attribute`` of a window of ``n`` steps (or roundtrips)
    per step, beside the wrappers' calls ``counts`` over the same steps;
    ``chain``: the buckets that make the chain's share. Asserts each B
    bucket's kernel events equal the calls times the kernels a call makes,
    and that no kernel of this package fell outside a B bucket, unless the
    trace holds no device event at all."""
    path = Path(trace_dir) / TRACE_FILE
    check(path.exists() and not path.with_name(TRACE_FILE + ".part").exists(), f"{path} written and closed")
    split = profile_step.attribute(str(path))
    want = profile_step.expected_events(counts)
    got = {b: split["buckets"][b]["events"] for b in want}
    if split["device_events"] > 0:
        check(got == want, f"kernel events of the trace against the wrappers' calls: {got} != {want}")
        check(not split["unattributed"], f"kernels of this package in no B bucket: {split['unattributed']}")
        check(all(got[b] > 0 for b in want if want[b] > 0), f"a bucket for every kernel launched: {got}")
    busy = split["busy_ms"]
    return {"device_events": split["device_events"], "trace_bytes": path.stat().st_size,
            "buckets_ms_a_step": {b: v["ms"] / n for b, v in split["buckets"].items() if v["events"]},
            "buckets_share": {b: v["share"] for b, v in split["buckets"].items() if v["events"]},
            "busy_ms_a_step": busy / n, "window_ms_a_step": split["window_ms"] / n,
            "idle_share": split["idle_share"], "gaps": split["gaps"],
            "chain_share_of_busy": sum(split["buckets"][b]["ms"] for b in chain) / busy if busy else None,
            "events_vs_launches": {b: [got[b], want[b]] for b in want}, "launches": counts}


def phase_profile(device, work, smi):
    """``cli.train`` with ``--profile-at`` (the ``cli`` phase's YAML and
    sets: the packed 4x step at full width, resumed at iter 164,339) for
    PROFILE_RUN steps, its trace split by kernel beside the wrappers' calls
    of the window (``launches.json``) and its ``gpu_step_s`` beside the host
    ``step_s``; then ``trace`` around PROFILE_SERVE_GOPS GOP roundtrips at
    the serving shape in this process, with a ``StepTimer``."""
    t_phase = time.time()
    train_dir, val_dir, _, _ = cli_sets(work)
    run = work / "profile"
    models = run / "experiments" / CLI_NAME / "models"
    models.mkdir(parents=True)
    shutil.copyfile(ROOT / QUALITY_CKPT, models / f"{CLI_RESUME_ITER}_G.msgpack")
    yml, changes = cli_train_yaml(run, train_dir, val_dir, {"logger.print_freq": PROFILE_PRINT_FREQ,
                                                            "logger.save_checkpoint_freq": 10 ** 9})
    at = CLI_RESUME_ITER + PROFILE_AT
    prof_dir = run / "prof"
    _, train_s = run_cli(run, "selfc_tpu_torch.cli.train",
                         ["-opt", str(yml), "--max-iters", str(CLI_RESUME_ITER + PROFILE_RUN), "--profile-at", str(at),
                          "--profile-steps", str(PROFILE_STEPS), "--profile-dir", str(prof_dir)], device, "_profile")
    window = json.loads((prof_dir / "launches.json").read_text())
    check(window["first_iter"] == at and window["last_iter"] == at + PROFILE_STEPS - 1,
          f"the window's iterations: {window}")
    train = trace_split(prof_dir, window["counts"], PROFILE_STEPS, ("B1/B3", "B2"))
    msgs, _ = log_messages(run / "experiments" / CLI_NAME, f"train_{CLI_NAME}")
    iters, logs = step_logs([m for m in msgs if m.startswith("<epoch:")])
    check(len(logs) == 3 and all("gpu_step_s" in lg and lg["gpu_step_s"] > 0 for lg in logs),
          f"the step lines carry gpu_step_s: {list(zip(iters, logs))}")
    emit("profile_train", yaml=CLI_TRAIN_YML, yaml_changes=changes, run_s=train_s, window=window,
         step_lines={it: {k: lg[k] for k in ("gpu_step_s", "step_s", "data_s", "wall_s") if k in lg}
                     for it, lg in zip(iters, logs)},
         chain_share_cuda_events=CHAIN_SHARE_EVENTS["packed_step"], nvidia_smi=smi, **train)

    model = RescaleModel(serve_options(), device=device, rng_seed=0)
    model.load_jax_params(seeded_tree(model.net, 2))
    gop = torch.rand((1, 7, *CLIP_HW, 3), device=device, generator=torch.Generator(device=device).manual_seed(0))
    eps = torch.randn(model.net.eps_shape(SERVE_SHAPE + (3,)), device=device,
                      generator=torch.Generator(device=device).manual_seed(1))
    timer = StepTimer(device)
    with torch.no_grad():
        model.net.roundtrip(gop, eps=eps)   # warm
        reset_all_counts()
        df.reset_launch_counts()
        with profile_trace(str(work / "serve_prof"), device):
            for _ in range(PROFILE_SERVE_GOPS):
                timer.tic()
                out = model.net.roundtrip(gop, eps=eps)
                timer.toc()
        counts = launch_counts()
    check(torch.isfinite(out["hr"]).all().item() and out["hr"].shape == gop.shape, "the traced roundtrip's HR")
    serve = trace_split(work / "serve_prof", counts, PROFILE_SERVE_GOPS, ("B1/B3",))
    emit("profile_serve", shape=[1, 7, *CLIP_HW, 3], roundtrips=PROFILE_SERVE_GOPS,
         gpu_roundtrip_ms=timer.mean * 1e3, timer_clock=timer.clock,
         chain_share_cuda_events=CHAIN_SHARE_EVENTS["gop_roundtrip"], nvidia_smi=smi,
         phase_s=time.time() - t_phase, **serve)


# resume_study (not in the default run): what 200 resumed steps cost the
# trained net's HR PSNR. {variant: (train clips, YAML changes beyond the cli
# phase's)}: the cli phase's run, the 400k run's whole train set, Adam's
# state not restored, fp32 training
RESUME_STUDY = {"seeded_48": (48, {}), "seeded_240": (240, {}),
                "fresh_adam_48": (48, {"train.resume_optimizer": False}),
                "fp32_48": (48, {"train.mixed_precision": False})}
RESUME_STUDY_EVERY = 50          # steps between the checkpoints measured


def val_quality(ckpt, device, out_dir, dtype="float32"):
    """HR / LR Y-PSNR / SSIM (``cal_metric``, sample seed 0) of a 4x
    checkpoint over the rendered val set, in this process."""
    model = RescaleModel(quality_options(str(ckpt), dtype, 0), device=device)
    m = cal_metric(list(render_val_set()), model, str(out_dir), save_images=False)
    return {"hr_psnr": m[0], "hr_ssim": m[1], "lr_psnr": m[2], "lr_ssim": m[3]}


def phase_resume_study(device):
    """``--phases resume_study``: each variant of RESUME_STUDY resumes iter
    164,339 through ``cli.train`` for CLI_STEPS steps as the cli phase does,
    a checkpoint every RESUME_STUDY_EVERY steps; each checkpoint's HR / LR
    Y-PSNR / SSIM (sample seed 0) over the rendered val set in fp32 and in
    bf16, measured in this process (``cal_metric``, as the ``quality``
    phase)."""
    work = Path(tempfile.mkdtemp(prefix="selfc_study_"))
    try:
        val_dir = work / "val_packed"
        render_packed(val_dir, **CLI_VAL_SET)

        def quality(ckpt):
            return {dtype: val_quality(ckpt, device, work / "q", dtype) for dtype in ("float32", "bfloat16")}

        start = quality(ROOT / QUALITY_CKPT)
        emit("resume_study_start", iter=CLI_RESUME_ITER, **start)
        sets = {}
        last = CLI_RESUME_ITER + CLI_STEPS
        for name, (n_clips, extra) in RESUME_STUDY.items():
            if n_clips not in sets:
                sets[n_clips] = work / f"train_{n_clips}"
                render_packed(sets[n_clips], **dict(CLI_TRAIN_SET, clips=n_clips))
            run = work / name
            models = run / "experiments" / CLI_NAME / "models"
            models.mkdir(parents=True)
            shutil.copyfile(ROOT / QUALITY_CKPT, models / f"{CLI_RESUME_ITER}_G.msgpack")
            yml, changes = cli_train_yaml(run, sets[n_clips], val_dir,
                                          {"logger.save_checkpoint_freq": RESUME_STUDY_EVERY, **extra})
            _, secs = run_cli(run, "selfc_tpu_torch.cli.train", ["-opt", str(yml), "--max-iters", str(last)], device)
            msgs, _ = log_messages(run / "experiments" / CLI_NAME, f"train_{CLI_NAME}")
            iters, logs = step_logs([m for m in msgs if m.startswith("<epoch:")])
            ckpts = sorted((int(p.name.split("_")[0]), p) for p in models.glob("*_G.msgpack")
                           if p.name.split("_")[0].isdigit() and int(p.name.split("_")[0]) > CLI_RESUME_ITER)
            ckpts.append((last, models / "latest_G.msgpack"))
            emit("resume_study", variant=name, train_clips=n_clips, yaml_changes=changes, train_s=secs,
                 mean={k: float(np.mean([lg[k] for lg in logs])) for k in CLI_LOSS_RANGES},
                 skipped=sum(lg["skipped_nonfinite"] for lg in logs),
                 step_s=[lg["step_s"] for lg in logs],
                 quality={str(it): quality(p) for it, p in ckpts})
            shutil.rmtree(run, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_kernels_haar(device):
    """The kernels at the Haar nets' widths against their plain versions,
    fp32 and bf16, at odd sizes: B1 with every epilogue at each (C, c_out)
    of HAAR_WIDTHS (rows of 9 and 45 values: no 16-byte multiple), B3 and B2
    at each input width, B4 on 4-D images at the IRN's. Returns the worst
    fp32 errors by kernel and width."""
    rng = np.random.default_rng(150)
    worst = {"forward": {}, "feats": {}, "bwd": {}, "spatial": {}}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32
        tag = str(dtype).split(".")[-1]
        for C, c_out, _ in HAAR_WIDTHS:
            x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, CHECK_SHAPE, device, dtype)
            errs = {}
            for mode, n_aux in dc.EP_AUX.items():
                aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
                got = dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
                errs[mode], ok = within(got, dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm), fp32)
                check(ok, f"B1 agrees with its plain version at a Haar width: {(tag, C, c_out, mode, errs[mode])}")
            cases.append({"kernel": "dense_chain_t_ep", "dtype": tag, "C": C, "c_out": c_out,
                          "max_abs_err": max(errs.values())})
            if fp32:
                worst["forward"][(C, c_out, 32)] = max(errs.values())
        for C in sorted({C for C, _, _ in HAAR_WIDTHS}):
            x, ws, bs, *_ = make_chain(rng, C, 3, CHECK_SHAPE, device, dtype)
            want_f = dc.chain_feats_plain(x, ws, bs)
            e_f, ok_f = within(dc.chain_feats(x, ws, bs), want_f, fp32)
            g, dx0 = seeded_grads(rng, want_f, device, dtype), seeded_grads(rng, x, device)
            want = dc.chain_spatial_bwd_plain(x, ws, bs, want_f, g, dx0)
            got = dc.chain_spatial_bwd(x, ws, bs, want_f, g, dx0)
            again = dc.chain_spatial_bwd(x, ws, bs, want_f, g, dx0)
            torch.cuda.synchronize()
            flat = lambda r: [r[0], *r[1], *r[2]]  # noqa: E731
            e_dx, *e_p = [rel_err(u, v) for u, v in zip(flat(got), flat(want))]
            same_bits = all(torch.equal(u, v) for u, v in zip(flat(got), flat(again)))
            cases.append({"kernel": "chain_feats+chain_spatial_bwd", "dtype": tag, "C": C, "feats_max_abs_err": e_f,
                          "dx_rel_err": e_dx, "dw_db_rel_err": max(e_p), "same_bits_twice": same_bits})
            check(ok_f and max(e_dx, *e_p) <= (BWD_FP32_REL_LIMIT if fp32 else BWD_BF16_REL_LIMIT) and same_bits,
                  f"B3 and B2 agree with their plain versions at a Haar width: {cases[-1]}")
            if fp32:
                worst["feats"][(C, 32)] = e_f
                worst["bwd"][(C, 32)] = (got[0] - want[0]).abs().max().item()
        for C in sorted({C for C, _ in IRN_WIDTHS}):
            x, ws, bs, *_ = make_chain(rng, C, 3, CHECK_SHAPE, device, dtype)
            img = x.reshape(-1, *x.shape[2:])            # (N, H, W, C): 4-D, as the IRN calls it
            got = dc.fused_dense_spatial(img, ws, bs)
            err, ok = within(got, dc.fused_dense_spatial_plain(img, ws, bs), fp32)
            cases.append({"kernel": "fused_dense_spatial", "dtype": tag, "C": C, "shape": list(img.shape),
                          "max_abs_err": err})
            check(ok and got.shape == img.shape[:3] + (128,), f"B4 on a 4-D image agrees with its plain version: {cases[-1]}")
            if fp32:
                worst["spatial"][C] = err
    emit("kernels_haar", kernels=["dense_chain_t_ep", "chain_feats", "chain_spatial_bwd", "fused_dense_spatial"],
         shape=CHECK_SHAPE, n_cases=len(cases), fp32_limit=FP32_LIMIT, bf16_rel_limit=BF16_REL_LIMIT,
         bwd_fp32_rel_limit=BWD_FP32_REL_LIMIT, bwd_bf16_rel_limit=BWD_BF16_REL_LIMIT, cases=cases)
    return worst


def haar_options(**val):
    return dict_to_nonedict({"model": "SelfC", "scale": 4, "val": val, "network_G": HAAR_NET})


def new_haar_trainer(device, tree, batch, network=None, **train):
    """``RescaleModel`` training the SelfC 4x net with the published
    training config's options (``train_options``), ``network`` over
    HAAR_NET."""
    model = RescaleModel(haar_train_options(network, **train), device=device, rng_seed=0)
    model.load_jax_params(tree)
    check(model.feed_data({"GT": batch}) == TRAIN_SHAPE[1], "feed_data returns the clip length")
    return model


def haar_train_options(network=None, **train):
    """The published training config's options (``train_options``) for the
    SelfC 4x net, ``network`` over HAAR_NET."""
    opt = train_options({**HAAR_NET, **(network or {})}, **train)
    opt["model"] = "SelfC"
    return opt


def shape_counts(counts, shape):
    """``chain_rows``' counts from a snapshot of ``dc.launches_by_shape``:
    the unpacked calls at ``shape``."""
    out = {"forward_stripe": {}, "feats_stripe": {}, "backward_stripe": {}}
    names = {"forward": "forward_stripe", "feats": "feats_stripe", "bwd": "backward_stripe"}
    for (entry, *key), n in counts.items():
        if entry in names and tuple(key[:4]) == tuple(shape):
            width = (key[4], key[5], 32) if entry == "forward" else (key[4], 32)
            out[names[entry]][width + (0,)] = n
    return out


def phase_haar(device):
    """The SelfC 4x net (SelfCNetHaar, 2,215,699 parameters) at full width:
    a GOP request (``RescaleModel.test``) on a 7 x 576 x 704 clip in fp32 and
    bf16, one downscale and one upscale, then three training steps at the
    published batch unpacked (``pack_w: false``), one recomputing the chains'
    features and one W-packed (the default: each chain packed call by call);
    the launch counts of exactly these calls are kept. Then the checks: hr
    from one LR and noise against the plain path, decode with the true HF
    against the input, the first step against the plain path, the packed
    step against the unpacked one, a repeated step's bits."""
    rng = np.random.default_rng(160)
    yy, xx = np.meshgrid(np.linspace(0, 1, CLIP_HW[0]), np.linspace(0, 1, CLIP_HW[1]), indexing="ij")
    clip = np.stack([0.5 + 0.3 * np.sin(5 * xx + 0.2 * t) * np.cos(7 * yy - 0.1 * t) for t in range(7)])
    clip = np.clip(clip[None, ..., None] * np.array([1.0, 0.9, 0.7]) + rng.normal(0, 0.02, (1, 7, *CLIP_HW, 3)),
                   0, 1).astype(np.float32)
    batch = train_batch(161)
    model = RescaleModel(haar_options(), device=device, rng_seed=0)
    tree = seeded_tree(model.net, 162)
    model.load_jax_params(tree)
    n_params = sum(p.numel() for p in model.net.parameters())
    check(n_params == HAAR_N_PARAMS, f"the SelfC 4x net has {n_params} parameters")
    bf = RescaleModel(haar_options(eval_dtype="bfloat16"), device=device, rng_seed=0)
    bf.load_jax_params(tree)
    gen = torch.Generator(device=device).manual_seed(163)
    lat = TRAIN_SHAPE + (3,)
    eps = [torch.randn(model.net.eps_shape(lat), generator=gen, device=device) for _ in range(N_TRAIN_STEPS)]
    unpacked = {"pack_w": False}
    trainer = new_haar_trainer(device, tree, batch, unpacked)
    recompute = new_haar_trainer(device, tree, batch, unpacked, save_chain_feats=False)
    packed = new_haar_trainer(device, tree, batch)
    start = params_of(trainer)

    # ---- the main path: counts set to 0 just before, read just after ----
    reset_all_counts()
    model.generator.manual_seed(5)
    t0 = time.time()
    model.feed_data({"GT": clip})
    model.test(gop=7)
    per_call = [dc.launches]
    lr_k = model.downscale(clip)
    per_call.append(dc.launches)
    model.generator.manual_seed(6)
    hr_k = model.upscale(lr_k)
    per_call.append(dc.launches)
    bf.generator.manual_seed(5)
    bf.feed_data({"GT": clip})
    bf.test(gop=7)
    per_call.append(dc.launches)
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    logs, per_step, seen = [], [], (dc.launches, dc.launches_bwd, dc.launches_feats)
    t0 = time.time()
    for step, mdl in [(i, trainer) for i in range(N_TRAIN_STEPS)] + [(0, recompute)]:
        mdl.optimize_parameters(step, eps=eps[step])
        logs.append(dict(mdl.get_current_log()))
        now = (dc.launches, dc.launches_bwd, dc.launches_feats)
        per_step.append(tuple(int(v) for v in np.subtract(now, seen)))
        seen = now
        if mdl is trainer and step == 0:
            after_1, grads_1, norm_1 = params_of(trainer), grads_of(trainer), float(trainer.grad_norm)
    b6_unpacked = dict(tc.launches_by_width)
    packed.optimize_parameters(0, eps=eps[0])
    logs.append(dict(packed.get_current_log()))
    now = (dc.launches, dc.launches_bwd, dc.launches_feats)
    per_step.append(tuple(int(v) for v in np.subtract(now, seen)))
    torch.cuda.synchronize()
    train_s = time.time() - t0
    counts = {"by_shape": dict(dc.launches_by_shape), "stripe": dict(dc.launches_by_stripe),
              "b6": dict(tc.launches_by_width), "b6_bwd": dict(tc.launches_bwd_by_width),
              "b6_unpacked": b6_unpacked}
    # ---------------------------------------------------------------------

    check(np.diff([0] + per_call).tolist() == [HAAR_ENC + HAAR_DEC, HAAR_ENC, HAAR_DEC, HAAR_ENC + HAAR_DEC],
          f"chain calls of test / downscale / upscale / bf16 test: {per_call}")
    vis = model.get_current_visuals()
    check(vis["SR"].shape == clip.shape and vis["LR"].shape == (1, 7, *SERVE_SHAPE[2:], 3)
          and vis["forw_H"].shape == (1, 7, *SERVE_SHAPE[2:], 45), "SR, LR, forw_H shapes")
    sr_bf = bf.get_current_visuals()["SR"]
    for name, arr in (("SR", vis["SR"]), ("bf16 SR", sr_bf), ("downscale", lr_k), ("upscale", hr_k)):
        check(np.isfinite(arr).all(), f"{name} is finite")
    with plain_chain_on_card():
        before = (dc.launches, tc.launches)
        lr_p = model.downscale(clip)
        model.generator.manual_seed(6)
        hr_p = model.upscale(lr_k)   # the same LR and the same noise as the kernel path
        check((dc.launches, tc.launches) == before, "the plain path launches no kernel")
    lr_differ = float(np.mean(np.abs(lr_k - lr_p) > 1e-6))
    hr_err = float(np.abs(hr_k - hr_p).max())
    check(lr_differ < 1e-3 and np.abs(lr_k - lr_p).max() < 1.01 / 255,
          f"downscale, kernel path vs plain path: {lr_differ}")
    check(hr_err <= HR_LIMIT, f"upscale: kernel path within {HR_LIMIT} of plain path, got {hr_err}")
    with torch.no_grad():
        x = torch.from_numpy(clip).to(device)
        y, _ = model.net.encode(x)
        back, _ = model.net.decode_with_hf(y[..., :3], y[..., 3:])
        inv_err = (back - x).abs().max().item()
    check(inv_err <= INV_LIMIT, f"decode with the true HF gives the clip back within {INV_LIMIT}: {inv_err}")
    del x, y, back
    flat = lambda v: torch.from_numpy(v).reshape(-1, *v.shape[2:])  # noqa: E731

    # the steps: each chain once forward and once back (the prior twice: the
    # NLL of the true HF and the decode), features recomputed by B3 on the
    # fourth, every call packed on the fifth
    n_chain = HAAR_ENC + HAAR_DEC + 4
    check(per_step == [(n_chain, n_chain, 0)] * N_TRAIN_STEPS + [(n_chain, n_chain, n_chain), (n_chain, n_chain, 0)],
          f"chain launches (forward, backward, feats) of each step: {per_step}")
    want_b6 = {(3 + 4 * 32, 9): HAAR_BLOCKS, (3 + 4 * 32, 45): HAAR_BLOCKS}   # the sub_mul recompute of G's conv5
    check(counts["b6"] == {k: 5 * v for k, v in want_b6.items()} and not counts["b6_bwd"]
          and counts["b6_unpacked"] == {k: 4 * v for k, v in want_b6.items()},
          f"B6 launches of the five steps: {counts['b6']}, backward {counts['b6_bwd']}")
    # forward calls by stripe: the requests and four steps unpacked; the
    # packed step's level 1 (72 wide) two images a row, its level 2 and
    # prior (36 wide) four
    stripes = by_stripe(counts["stripe"])
    want_stripes = {0: 4 * n_chain + 3 * (HAAR_ENC + HAAR_DEC), HAAR_TRAIN[1][3]: 6 * HAAR_BLOCKS,
                    HAAR_TRAIN[2][3]: 6 * HAAR_BLOCKS + 8}
    check(stripes == want_stripes, f"chain launches by stripe: {stripes} (expected {want_stripes})")
    for lg in logs:
        check(all(np.isfinite(v) for v in lg.values()) and lg["skipped_nonfinite"] == 0.0,
              f"the step's losses are finite and it was not skipped: {lg}")
    unchanged = [k for k, p in trainer.net.named_parameters() if torch.equal(p.detach(), start[k])]
    check(not unchanged, f"every parameter changed: {unchanged[:5]}")
    check(logs[N_TRAIN_STEPS]["loss"] == logs[0]["loss"], "save_chain_feats false gives the same loss")
    pack_loss_rel = abs(logs[-1]["loss"] - logs[0]["loss"]) / abs(logs[0]["loss"])
    pack_grad_l2 = grads_rel_l2(grads_of(packed), grads_1)
    check(pack_loss_rel <= TRAIN_LOSS_REL_LIMIT and pack_grad_l2 <= PACK_GRAD_L2_LIMIT,
          f"the packed step against the unpacked one, loss and whole gradient: {(pack_loss_rel, pack_grad_l2)}")
    del recompute

    plain = new_haar_trainer(device, tree, batch, unpacked)
    with plain_chain_on_card():
        before = (dc.launches, dc.launches_bwd, dc.launches_feats, tc.launches)
        plain.optimize_parameters(0, eps=eps[0])
        check((dc.launches, dc.launches_bwd, dc.launches_feats, tc.launches) == before,
              "the plain path launches no kernel")
    log_p, grads_p = dict(plain.get_current_log()), grads_of(plain)
    loss_rel = abs(logs[0]["loss"] - log_p["loss"]) / abs(log_p["loss"])
    grad_l2 = grads_rel_l2(grads_1, grads_p)
    check(loss_rel <= TRAIN_LOSS_REL_LIMIT and grad_l2 <= TRAIN_GRAD_L2_LIMIT,
          f"first step's loss and whole gradient, kernel path vs plain path: {(loss_rel, grad_l2)}")
    del grads_p, grads_1
    again = new_haar_trainer(device, tree, batch, unpacked)
    again.optimize_parameters(0, eps=eps[0])
    differ = [k for k, p in again.net.named_parameters() if not torch.equal(p.detach(), after_1[k])]
    check(not differ, f"a repeated first step gives bit-identical parameters: {differ[:5]}")
    del again, after_1

    # times: one GOP roundtrip, a step unpacked and packed, each beside the plain path
    gop = torch.from_numpy(clip).to(device)
    eps_gop = torch.randn(model.net.eps_shape(SERVE_SHAPE + (3,)), generator=gen, device=device)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        rt = time_cuda(lambda: model.net.roundtrip(gop, eps=eps_gop), iters=10, warmup=2)
        peak_serve = torch.cuda.max_memory_allocated() / 2 ** 30
        with plain_chain_on_card():
            rt_plain = time_cuda(lambda: model.net.roundtrip(gop, eps=eps_gop), iters=5, warmup=1)
    steps = {}
    for name, mdl in (("unpacked", trainer), ("packed", packed)):
        torch.cuda.reset_peak_memory_stats()
        steps[name] = time_cuda(lambda: mdl.optimize_parameters(N_TRAIN_STEPS, eps=eps[0]), iters=5, warmup=1)
        steps[name]["peak_device_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with plain_chain_on_card():
        step_p = time_cuda(lambda: plain.optimize_parameters(1, eps=eps[0]), iters=3, warmup=1)
    emit("haar", clip=clip.shape, batch=batch.shape, n_params=n_params, serve_s=serve_s, train_s=train_s,
         launches_per_call={"test": per_call[0], "downscale": per_call[1] - per_call[0],
                            "upscale": per_call[2] - per_call[1], "test_bf16": per_call[3] - per_call[2]},
         launches_per_step=per_step, launches_by_stripe=stripes,
         launches_b6_sub_mul={str(k): v for k, v in counts["b6"].items()},
         launches_by_shape={str(k): v for k, v in sorted(counts["by_shape"].items(), key=str)},
         hr_max_abs_err_kernel_vs_plain=hr_err, hr_limit=HR_LIMIT, lr_levels_differ=lr_differ,
         inverse_max_abs_err=inv_err, inverse_limit=INV_LIMIT,
         psnr_bf16_vs_fp32=psnr(flat(sr_bf), flat(vis["SR"])).mean().item(),
         psnr_hr_vs_input=psnr(flat(vis["SR"]), flat(clip)).mean().item(), logs=logs,
         grad_norm_step0=norm_1, loss_rel_err_kernel_vs_plain=loss_rel, grad_l2_rel_err_kernel_vs_plain=grad_l2,
         loss_rel_err_packed_vs_unpacked=pack_loss_rel, grad_l2_rel_err_packed_vs_unpacked=pack_grad_l2,
         gop_roundtrip_ms=rt["median"], gop_roundtrip_ms_min=rt["min"], gop_roundtrip_plain_ms=rt_plain["median"],
         peak_device_memory_gib_serve=peak_serve, step_ms_unpacked=steps["unpacked"]["median"],
         step_ms_packed=steps["packed"]["median"], step_plain_ms=step_p["median"],
         peak_device_memory_gib_step={k: v["peak_device_memory_gib"] for k, v in steps.items()},
         clips_per_s=TRAIN_SHAPE[0] * 1e3 / steps["unpacked"]["median"])
    return counts


def phase_irn(device):
    """The IRN x4 net (InvRescaleNet, DBNet, block_num [8, 8]: 4,355,136
    parameters) at full width on one DIV2K-validation-size image: encode,
    decode with the true HF and with U[0,1) HF from a generator; the launch
    counts of exactly these calls are kept. Then the checks: decode with the
    true HF against the image, the encode against the plain path's."""
    net = define_G(dict_to_nonedict({"model": "IRN", "scale": 4, "network_G": IRN_NET}), device=device)
    tree = seeded_tree(net, 170)
    load_jax_params(net, tree)
    n_params = sum(p.numel() for p in net.parameters())
    check(n_params == IRN_N_PARAMS, f"the IRN x4 net has {n_params} parameters")
    yy, xx = torch.meshgrid(torch.linspace(0, 1, IRN_IMAGE[1], device=device),
                            torch.linspace(0, 1, IRN_IMAGE[2], device=device), indexing="ij")
    noise = torch.randn(IRN_IMAGE, generator=torch.Generator(device=device).manual_seed(171), device=device)
    img = (0.5 + 0.3 * torch.sin(9 * xx) * torch.cos(6 * yy))[None, ..., None] * torch.tensor(
        [1.0, 0.85, 0.7], device=device)
    img = (img + 0.02 * noise).clamp(0, 1).contiguous()
    gen = torch.Generator(device=device).manual_seed(172)

    # ---- the main path: counts set to 0 just before, read just after ----
    reset_all_counts()
    t0 = time.time()
    with torch.no_grad():
        y, jac = net.encode(img)
        lr, hf = y[..., :3].contiguous(), y[..., 3:].contiguous()
        back, _ = net.decode(lr, hf=hf)
        hr_u, hf_u = net.decode(lr, generator=gen)
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    counts = dict(dc.launches_by_shape)
    # ---------------------------------------------------------------------

    # a level's blocks call F (its HF width) once and G and H (3) twice, each pass
    want = {("spatial", 1, 1, *IRN_LEVELS[lvl], C): 3 * IRN_NET["block_num"][lvl - 1] * (2 if C == 3 else 1)
            for C, lvl in IRN_WIDTHS}
    got = {k: v for k, v in counts.items() if k[0] == "spatial"}
    check(got == want and dc.launches == 0, f"B4 launches of encode + two decodes: {got} (expected {want})")
    inv_err = (back - img).abs().max().item()
    check(inv_err <= INV_LIMIT, f"decode with the true HF gives the image back within {INV_LIMIT}: {inv_err}")
    check(y.shape == (1, *IRN_LEVELS[2], 48) and hr_u.shape == IRN_IMAGE and hf_u.shape == (1, *IRN_LEVELS[2], 45)
          and 0 <= hf_u.min().item() and hf_u.max().item() < 1 and torch.isfinite(hr_u).all().item()
          and torch.isfinite(jac).item(), "IRN shapes, the U[0,1) HF, finite outputs")
    with torch.no_grad(), plain_chain_on_card():
        y_p, jac_p = net.encode(img)
    enc_err = (y - y_p).abs().max().item()
    check(enc_err <= FP32_LIMIT, f"IRN encode, kernel path within {FP32_LIMIT} of the plain path: {enc_err}")
    del y_p, back, hr_u, hf_u
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        enc = time_cuda(lambda: net.encode(img), iters=5, warmup=1)
        dec = time_cuda(lambda: net.decode(lr, hf=hf), iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with plain_chain_on_card():
            enc_p = time_cuda(lambda: net.encode(img), iters=3, warmup=1)
            dec_p = time_cuda(lambda: net.decode(lr, hf=hf), iters=3, warmup=1)
    emit("irn", image=IRN_IMAGE, n_params=n_params, serve_s=serve_s,
         launches_b4={str(k): v for k, v in got.items()}, log_jac=jac.item(), log_jac_plain=jac_p.item(),
         inverse_max_abs_err=inv_err, inverse_limit=INV_LIMIT, encode_max_abs_err_kernel_vs_plain=enc_err,
         encode_ms=enc["median"], encode_ms_min=enc["min"], decode_ms=dec["median"], decode_ms_min=dec["min"],
         encode_plain_ms=enc_p["median"], decode_plain_ms=dec_p["median"], peak_device_memory_gib=peak)
    return counts


def phase_timing_haar(device, haar_counts, irn_counts, worst):
    """The rows of B1 at the Haar net's serving latents, of B1, B3 and B2 at
    its training latents (the unpacked steps' launches) and of B4 on the
    IRN's image levels, each beside its bound, its plain version and one
    PyTorch library call."""
    kernels = []
    for tag, shapes, spatial in (("haar_serve", HAAR_SERVE, False), ("haar_train", HAAR_TRAIN, True)):
        for level, shape in shapes.items():
            fwd = [(C, co, 32) for C, co, lvl in HAAR_WIDTHS if lvl == level]
            sp = sorted({(C, 32) for C, _, _ in fwd}) if spatial else []
            kernels += chain_rows(device, f"{tag}_{level}", shape, 0, fwd, sp,
                                  shape_counts(haar_counts["by_shape"], shape), worst)
    rng = np.random.default_rng(175)
    for C, level in IRN_WIDTHS:
        H, W = IRN_LEVELS[level]
        _, ws, bs, *_ = make_chain(rng, C, 3, (1, 1, 1, 1), device)
        x = torch.rand((1, H, W, C), generator=torch.Generator(device=device).manual_seed(C + level),
                       device=device)
        lx = x.permute(0, 3, 1, 2).contiguous()
        lws = [w.permute(3, 2, 0, 1).contiguous() for w in ws]
        with torch.no_grad():
            got = dc.fused_dense_spatial(x, ws, bs)
            want = dc.fused_dense_spatial_plain(x, ws, bs)
            err = (got - want).abs().max().item()
            check(err <= FP32_LIMIT, f"B4 vs plain at the IRN's level {level}, C = {C}: {err}")
            check((library_feats2d(lx, lws, bs).permute(0, 2, 3, 1) - want).abs().max().item() <= 1e-3,
                  "library 2-d spatial chain computes the same function")
            del got, want
            ms = time_cuda(lambda: dc.fused_dense_spatial(x, ws, bs), iters=10)
            plain = time_cuda(lambda: dc.fused_dense_spatial_plain(x, ws, bs), iters=10)
            library = time_cuda(lambda: library_feats2d(lx, lws, bs), iters=10)
        bound, by = chain_feats_bound_ms(1, 1, H, W, C, peak=TC_PEAK)
        kernels.append({
            "name": f"fused_dense_spatial[{C}]@irn_{level}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES_SPATIAL, "launches": irn_counts.get(("spatial", 1, 1, H, W, C), 0),
            "max_abs_err": max(err, worst["spatial"][C]), "ms": ms["median"], "plain_ms": plain["median"],
            "bound_ms": bound, "bound_by": by, "library_ms": library["median"],
            "bound_fma_ms": chain_feats_bound_ms(1, 1, H, W, C)[0], "ms_min": ms["min"],
            "plain_ms_min": plain["min"], "library_ms_min": library["min"], "shape": [1, H, W, C], "gc": 32})
        del x, lx, ws, bs, lws
    emit("timing_haar", rows=[{k: r[k] for k in ("name", "launches", "ms", "ms_min", "plain_ms", "library_ms",
                                                  "bound_ms", "bound_fma_ms", "bound_by")} for r in kernels])
    return kernels


def gan_options(**train):
    """``train_rescaling_gan.yml``'s options, built here: the published
    training options (``train_options``) with its adversarial keys and
    ``network_D``."""
    opt = train_options(**{**GAN_TRAIN, **train})
    opt["network_D"] = dict_to_nonedict(dict(NETWORK_D))
    return opt


def gan_trees(device):
    """Seeded parameters of G (as the ``train`` phase's), D (batch-norm
    scales near 1, running means near 0 and variances in [0.5, 1.5]) and F
    (He-scaled, so that activations keep their size through VGG's 16
    convs), and the nets' parameter counts."""
    probe = RescaleModel(gan_options(), device=device, rng_seed=0)
    rng = np.random.default_rng(70)
    d = {}
    for k, p in probe.gan.netD.named_parameters():
        shape = tuple(p.shape)
        if k.endswith(".scale"):
            d[k] = (1.0 + rng.normal(0, 0.05, shape)).astype(np.float32)
        elif p.dim() == 1:
            d[k] = rng.normal(0, 0.05, shape).astype(np.float32)
        else:
            d[k] = rng.normal(0, float(np.prod(shape[:-1])) ** -0.5, shape).astype(np.float32)
    f = {k: (rng.normal(0, 0.01, tuple(p.shape)) if p.dim() == 1 else
             rng.normal(0, (2.0 / float(np.prod(p.shape[:-1]))) ** 0.5, tuple(p.shape))).astype(np.float32)
         for k, p in probe.gan.netF.named_parameters()}
    stats = {k: {"mean": rng.normal(0, 0.1, tuple(v["mean"].shape)).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, tuple(v["var"].shape)).astype(np.float32)}
             for k, v in probe.gan.d_stats.items()}
    counts = {name: sum(p.numel() for p in net.parameters())
              for name, net in (("G", probe.net), ("D", probe.gan.netD), ("F", probe.gan.netF))}
    trees = (seeded_tree(probe.net, 2), d, f, stats)
    del probe
    return trees, counts


def new_gan_trainer(device, trees, batch, path=None, **train):
    g, d, f, stats = trees
    opt = gan_options(**train)
    if path:
        opt["path"] = dict_to_nonedict(path)
    model = RescaleModel(opt, device=device, rng_seed=0)
    if not (path or {}).get("pretrain_model_G"):
        model.load_jax_params(g)
    if not (path or {}).get("pretrain_model_D"):
        load_jax_params(model.gan.netD, d)
    model.gan.load_stats(stats)
    if model.gan.netF is not None:
        load_jax_params(model.gan.netF, f)
    check(model.feed_data({"GT": batch}) == TRAIN_SHAPE[1], "feed_data returns the clip length")
    return model


def gan_state(model):
    """G's and D's parameters and gradients and D's running statistics, as
    ``{name: tensor}`` copies (``G.*``, ``D.*``, ``stats.*``, ``gradG.*``,
    ``gradD.*``)."""
    out = {}
    for tag, net in (("G", model.net), ("D", model.gan.netD)):
        for k, p in net.named_parameters():
            out[f"{tag}.{k}"] = p.detach().clone()
            if p.grad is not None:
                out[f"grad{tag}.{k}"] = p.grad.detach().clone()
    for k, v in model.gan.d_stats.items():
        for n, t in v.items():
            out[f"stats.{k}.{n}"] = t.detach().clone()
    return out


def d_grad_fp64_errors(device, trees, batch, eps, grads):
    """How far D's fp32 gradient of the first step lies from the same
    gradient in float64, on each path: ``grads`` is ``{"kernel": ..,
    "plain": ..}`` (``gradD.*``, clipped by the step). For each path the
    frames of G's forward before the update are recomputed on that path, D
    runs at its start parameters and statistics in double with the same
    loss, and its gradient is clipped by global norm as the step clips.
    Returns ``({path: relative l2}, the fake frames' relative l2 between the
    paths)``."""
    _, d, _, stats = trees
    model = new_gan_trainer(device, trees, batch)
    eps_t = torch.as_tensor(eps, device=device)
    fakes = {}
    with torch.no_grad(), step_algorithms():
        ref_l = model.degrade(model.real_H)
        fakes["kernel"] = flat_frames(model._pixel_losses(model.real_H, ref_l, eps_t)[2]["hr"])
        with plain_chain_on_card():
            fakes["plain"] = flat_frames(model._pixel_losses(model.real_H, ref_l, eps_t)[2]["hr"])
    real = flat_frames(model.real_H)
    out = {path: grads_rel_l2({k: v.double() for k, v in grads[path].items()},
                              d_grad_fp64(model.gan, d, stats, real, fake))
           for path, fake in fakes.items()}
    del model
    fake_l2 = ((fakes["kernel"] - fakes["plain"]).norm() / fakes["plain"].norm()).item()
    return out, fake_l2


def d_grad_fp64(gan, d, stats, real, fake):
    """D's gradient of ``gan``'s D loss in float64, from D's parameters
    ``d`` and running statistics ``stats`` on the frames ``real`` and
    ``fake``, clipped by global norm as the step clips (10):
    ``{"gradD.<name>": tensor}``."""
    import copy

    gan64 = copy.copy(gan)
    gan64.netD = copy.deepcopy(gan.netD).double()
    load_jax_params(gan64.netD, d)
    gan64.d_stats = {k: {n: torch.as_tensor(v, dtype=torch.float64, device=real.device) for n, v in s.items()}
                     for k, s in stats.items()}
    loss, _, _ = gan64.d_loss(real.double(), fake.double())
    g64 = torch.autograd.grad(loss, list(gan64.netD.parameters()))
    scale = min(1.0, 10.0 / torch.linalg.vector_norm(torch.stack([t.norm() for t in g64])).item())
    return {f"gradD.{k}": t * scale for (k, _), t in zip(gan64.netD.named_parameters(), g64)}


def part_of(state, prefix):
    return {k: v for k, v in state.items() if k.startswith(prefix)}


def gan_parts(model, eps):
    """One GAN step's parts, each between CUDA events, median of 5, under
    the step's cuDNN algorithms: G's forward with the pixel losses, F (real
    and fake, the feature loss), D inside G's loss (eval mode, fake and
    real), G's backward, D's step (two train-mode calls, the loss, its
    backward) and both optimizers (clip + Adam each)."""
    gan, hr = model.gan, model.real_H
    eps_t = torch.as_tensor(eps, device=hr.device)
    with torch.no_grad():
        ref_l = model.degrade(hr)
    real = flat_frames(hr)
    out = {k: [] for k in ("g_forward", "f", "d_in_g_loss", "g_backward", "d_step", "optimizers")}
    with step_algorithms(model.cudnn_deterministic):
        for _ in range(5):
            held = {}
            model.optimizer.zero_grad(set_to_none=True)
            gan.optimizer.zero_grad(set_to_none=True)
            gan.netD.requires_grad_(False)

            def g_forward():
                held["pix"], _, o = model._pixel_losses(hr, ref_l, eps_t)
                held["fake"] = flat_frames(o["hr"].float())

            def f_part():
                with torch.no_grad():
                    fea_real = gan.netF(real)
                held["fea"] = gan.fea_w * losses.reconstruction_loss(gan.netF(held["fake"]), fea_real,
                                                                     gan.fea_crit)

            def d_in_g():
                pred_fake, _ = gan.netD(held["fake"], gan.d_stats, False)
                with torch.no_grad():
                    pred_real, _ = gan.netD(real, gan.d_stats, False)
                held["adv"] = gan.gan_w * gan.adv_loss(pred_fake, pred_real, True)

            for name, fn in (("g_forward", g_forward), ("f", f_part), ("d_in_g_loss", d_in_g)):
                out[name].append(time_cuda(fn, 1, 0)["median"])
            out["g_backward"].append(time_cuda(lambda: (held["pix"] + held["fea"] + held["adv"]).backward(), 1, 0)
                                     ["median"])
            gan.netD.requires_grad_(True)
            fake = held["fake"].detach()
            out["d_step"].append(time_cuda(lambda: gan.d_loss(real, fake)[0].backward(), 1, 0)["median"])

            def optimizers():
                clip_by_global_norm_(list(model.net.parameters()), 10.0)
                model.optimizer.step()
                clip_by_global_norm_(list(gan.netD.parameters()), 10.0)
                gan.optimizer.step()

            out["optimizers"].append(time_cuda(optimizers, 1, 0)["median"])
    return {k: float(np.median(v)) for k, v in out.items()}


def phase_gan(device):
    """The adversarial training step of ``train_rescaling_gan.yml`` at full
    width: SelfC_GMM 4x (W-packed, stripe 36), D (``discriminator_vgg_128``,
    nf 64) and VGG-19 to conv5_4 on seeded random weights, the published
    batch (D and F see 56 frames of 144 x 144), fp32 with TF32 off. The main
    path: two 'ragan' steps with the feature loss (a save and a ``.state``
    between them), then one step each of 'gan', 'lsgan' and 'wgan-gp'; the
    chain launches of exactly these steps are kept, a step must launch what
    the pixel step launches. Then the first step's G and D gradients and D's
    statistics against the plain path, a gated step, a repeated step, a
    resumed step, the step's time and parts with both cuDNN choices, beside
    a pixel step's, and its peak memory."""
    batch = train_batch()
    rng = np.random.default_rng(71)
    n_chain = 6 * sum(BLOCK_NUM) + STP_BLK_NUM
    trees, n_params = gan_trees(device)
    eps = [rng.normal(0, 1, TRAIN_SHAPE + (48, 5)).astype(np.float32) for _ in range(N_GAN_STEPS)]
    work = Path(tempfile.mkdtemp(prefix="selfc_gan_"))
    try:
        model = new_gan_trainer(device, trees, batch, path={"models": str(work / "models"),
                                                            "training_state": str(work / "state")})
        start = gan_state(model)
        others = {gt: new_gan_trainer(device, trees, batch, gan_type=gt) for gt in GAN_OTHER_TYPES}

        # ---- the main path: counts set to 0 just before, read just after ----
        dc.reset_launch_counts()
        tc.reset_launch_counts()
        per_step, logs, seen = [], {}, (0, 0, 0)
        t0 = time.time()
        for step in range(1, N_GAN_STEPS + 1):
            model.optimize_parameters(step, eps=eps[step - 1])
            logs[f"ragan_{step}"] = dict(model.get_current_log())
            now = (dc.launches, dc.launches_bwd, dc.launches_feats)
            per_step.append(tuple(int(v) for v in np.subtract(now, seen)))
            seen = now
            if step == 1:
                after_1 = gan_state(model)
                model.save(1)
                state_path = model.save_training_state(0, 1)
        after_2 = gan_state(model)
        for gt, other in others.items():
            other.optimize_parameters(1, eps=eps[0])
            logs[gt] = dict(other.get_current_log())
            now = (dc.launches, dc.launches_bwd, dc.launches_feats)
            per_step.append(tuple(int(v) for v in np.subtract(now, seen)))
            seen = now
        torch.cuda.synchronize()
        gan_s = time.time() - t0
        b6 = dict(tc.launches_by_width)
        stripes = {k: by_stripe(v) for k, v in (("forward", dc.launches_by_stripe),
                                                 ("backward", dc.launches_bwd_by_stripe))}
        # ---------------------------------------------------------------------
        del others
        steps = N_GAN_STEPS + len(GAN_OTHER_TYPES)
        check(per_step == [(n_chain, n_chain, 0)] * steps,
              f"chain launches (forward, backward, feats) of each GAN step, the pixel step's: {per_step}")
        check(stripes == {"forward": {TRAIN_STRIPE: steps * n_chain}, "backward": {TRAIN_STRIPE: steps * n_chain}},
              f"every chain of the GAN steps at stripe 36: {stripes}")
        check(b6 == {(3 + 4 * 32, 48): sum(BLOCK_NUM) * steps}, f"B6 launches of the GAN steps: {b6}")
        for name, lg in logs.items():
            check(all(np.isfinite(v) for v in lg.values()) and lg["skipped_nonfinite"] == 0.0
                  and {"l_g_gan", "l_d", "D_real", "D_fake", "l_g_fea"} <= set(lg),
                  f"the {name} step's losses are finite and it was not skipped: {lg}")
        moved = {tag: [k for k in part_of(start, tag + ".") if torch.equal(start[k], after_1[k])] for tag in "GD"}
        check(not moved["G"] and not moved["D"], f"every parameter of G and D moved in step 1: {moved}")

        # the first step through the plain chain, on the card
        plain = new_gan_trainer(device, trees, batch)
        with plain_chain_on_card():
            before = (dc.launches, dc.launches_bwd, dc.launches_feats, tc.launches)
            plain.optimize_parameters(1, eps=eps[0])
            check((dc.launches, dc.launches_bwd, dc.launches_feats, tc.launches) == before,
                  "the plain path launches no kernel")
        want = gan_state(plain)
        log_p = dict(plain.get_current_log())
        del plain
        errs = {tag: grads_rel_l2(part_of(after_1, tag), part_of(want, tag)) for tag in ("gradG.", "gradD.", "stats.")}
        check(errs["gradG."] <= GAN_GRAD_L2_LIMIT and errs["stats."] <= GAN_STATS_L2_LIMIT,
              f"the GAN step's G gradient and D's statistics, kernel path vs plain path: {errs}")
        # D runs no kernel, and its fp32 gradient on random weights is itself
        # ~1e-3 from its float64 value on the same frames (batch-norm
        # statistics; the real and fake terms nearly cancel), so the two
        # paths' D gradients are not held to each other: each is held to its
        # own path's float64 gradient, the kernel path's no further than twice
        # the plain path's
        d64, fake_l2 = d_grad_fp64_errors(device, trees, batch, eps[0],
                                          {"kernel": part_of(after_1, "gradD."), "plain": part_of(want, "gradD.")})
        check(d64["kernel"] <= 2.0 * d64["plain"] + GAN_GRAD_L2_LIMIT,
              f"D's gradient from float64: kernel path {d64['kernel']}, plain path {d64['plain']}")
        loss_rel = {k: abs(logs["ragan_1"][k] - log_p[k]) / max(abs(log_p[k]), 1e-12)
                    for k in ("loss", "l_g_gan", "l_g_fea", "l_d")}

        # a gated step (D_init_iters 5): G's parameters and moments keep their bits
        gated = new_gan_trainer(device, trees, batch, D_init_iters=5)
        gated.optimize_parameters(1, eps=eps[0])
        got = gan_state(gated)
        check(all(torch.equal(got[k], v) for k, v in part_of(start, "G.").items()) and not gated.optimizer.state
              and any(not torch.equal(got[k], v) for k, v in part_of(start, "D.").items()),
              "a gated step leaves G's parameters and moments as they were and moves D")
        del gated

        # the first step again: the same bits, with no flag set by the caller
        again = new_gan_trainer(device, trees, batch)
        again.optimize_parameters(1, eps=eps[0])
        got = gan_state(again)
        differ = [k for k, v in after_1.items() if not torch.equal(got[k], v)]
        check(not differ, f"a repeated GAN step gives the same bits: {differ[:5]}")
        del again

        # resumed from step 1's checkpoints and .state: step 2's bits
        resumed = new_gan_trainer(device, trees, batch, path={
            "pretrain_model_G": str(work / "models" / "1_G.msgpack"),
            "pretrain_model_D": str(work / "models" / "1_D.msgpack")})
        payload = resumed.resume_training(state_path)
        check(set(payload["extra"]) == {"d_opt_state", "d_stats"}, f"the .state's extras: {sorted(payload['extra'])}")
        resumed.optimize_parameters(2, eps=eps[1])
        got = gan_state(resumed)
        differ = [k for k, v in after_2.items() if not torch.equal(got[k], v)]
        check(not differ, f"a step resumed from the save gives the next step's bits: {differ[:5]}")
        del resumed
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the step's time with both cuDNN choices, its parts, the peak, and a
    # pixel step beside it in the same call
    step_of = lambda mdl: (lambda: mdl.optimize_parameters(3, eps=eps[0]))  # noqa: E731
    peak = step_peak_gib(model, eps[0], step=3)
    algorithms = cudnn_in_turns(model, step_of(model), iters=5)
    parts = gan_parts(model, eps[0])
    torch.cuda.reset_peak_memory_stats()
    pixel = new_trainer(device, trees[0], batch)
    pixel_peak = step_peak_gib(pixel, eps[0])
    pixel_ms = time_cuda(lambda: pixel.optimize_parameters(3, eps=eps[0]), iters=5, warmup=1)
    del pixel, model
    step_ms = float(np.median(algorithms["deterministic"]))
    emit("gan", yaml=GAN_YML, batch=batch.shape, d_and_f_frames=TRAIN_SHAPE[0] * TRAIN_SHAPE[1], n_params=n_params,
         gan_types=["ragan"] + list(GAN_OTHER_TYPES), gan_s=gan_s, logs=logs,
         launches_per_step=per_step, launches_by_stripe=stripes, launches_b6=str(b6),
         grad_l2_rel_err_kernel_vs_plain={"G": errs["gradG."], "D": errs["gradD."]},
         d_grad_rel_l2_from_float64=d64, fake_rel_l2_kernel_vs_plain=fake_l2,
         stats_l2_rel_err_kernel_vs_plain=errs["stats."], limits=[GAN_GRAD_L2_LIMIT, GAN_STATS_L2_LIMIT],
         loss_rel_err_kernel_vs_plain=loss_rel, gated_keeps_g_bits=True, repeat_bit_identical=True,
         resumed_step_bit_identical=True, gan_step_ms=step_ms, step_ms_by_cudnn_algorithms=algorithms,
         parts_ms=parts, pixel_step_ms=pixel_ms["median"], gan_over_pixel=step_ms / pixel_ms["median"],
         step_peak_gib_over_live={"gan": peak, "pixel": pixel_peak})


def phase_aux(device):
    """SpyNet and BPG, one line each: ``MESpynet`` (4 levels, seeded
    fan-in weights) on a pair of 144 x 144 frames against the same module on
    the CPU, timed; ``bpg_roundtrip`` through the backend this machine has
    (``bpg_backend()``: the HEVC-intra path where ``selfc_x265`` builds, else
    the stand-in)."""
    rng = np.random.default_rng(72)
    net = MESpynet(device=device)
    load_jax_params(net, {k: rng.normal(0, (float(np.prod(p.shape[:-1]))) ** -0.5, tuple(p.shape)).astype(np.float32)
                          for k, p in net.named_parameters()})
    a, b = (torch.from_numpy(render_clip(rng, 1, 144, 144)[0][None].astype(np.float32)).to(device) for _ in range(2))
    with torch.no_grad():
        flow = net(a, b)
        ref = MESpynet(device="cpu")
        ref.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
        want = ref(a.cpu(), b.cpu())
        ms = time_cuda(lambda: net(a, b), iters=10, warmup=2)
    err = (flow.cpu() - want).abs().max().item()
    check(flow.shape == (1, 144, 144, 2) and torch.isfinite(flow).all().item() and err <= 1e-4 * max(1.0, want.abs().max().item()),
          f"MESpynet on the card against the CPU: {err}")
    emit("spynet", shape=[1, 144, 144, 3], flow_max_abs=want.abs().max().item(), max_abs_err_vs_cpu=err,
         ms=ms["median"], ms_min=ms["min"])
    frames = np.stack(render_clip(rng, 2, 64, 64)).astype(np.float32)
    backend = bpg.bpg_backend()
    t0 = time.time()
    dec, bpp = bpg.bpg_roundtrip(frames, q=29)
    seconds = time.time() - t0
    check(dec.shape == frames.shape and np.isfinite(dec).all() and bpp > 0, "bpg_roundtrip's output")
    emit("bpg", backend=backend or "stand-in", shape=list(frames.shape), q=29, bpp=bpp,
         mse=float(((dec - frames) ** 2).mean()), s=seconds)


def launches_by_card():
    """B1, B3, B2, B4 (forward, backward) and B5 (forward, backward) calls
    by card since the last reset (a B4 call is also counted as the B3 or B2
    call it makes)."""
    out = {}
    for counts, names in ((dc.launches_by_device, {"forward": "B1", "feats": "B3", "bwd": "B2", "spatial": "B4",
                                                   "spatial_bwd": "B4_bwd"}),
                          (df.launches_by_device, {"forward": "B5", "bwd": "B5_bwd"})):
        for (entry, index), n in counts.items():
            out.setdefault(f"cuda:{index}", {})[names[entry]] = n
    return out


def wrapper_calls(device, seed=91):
    """One differentiable call of each kernel wrapper on ``device`` at the
    gradient check's shape (B1 with B3 recomputing its features and B2, B4,
    B5, B6, B7, B8, B9): ``{name: [output, gradient of every input]}``, the loss the
    sum of the outputs' squares. The wrappers are read from their modules at
    call time, so ``plain_chain_on_card`` routes the same calls to the
    plain versions."""
    rng = np.random.default_rng(seed)

    def run(fn, *inputs):
        inputs = [t.detach().requires_grad_(True) for t in inputs]
        outs = fn(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads = torch.autograd.grad(sum((o.float() ** 2).sum() for o in outs), inputs, allow_unused=True)
        return [o.detach() for o in outs] + [g for g in grads if g is not None]

    def chain(C, c_out, gc=32):
        x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, GRAD_SHAPE, device, gc=gc)
        return x, a, m, *ws, *bs, w5, b5

    out = {}
    out["B1+B3+B2 dense_chain_t_ep"] = run(
        lambda x, a, m, *p: dc.dense_chain_t_ep(x, p[:4], p[4:8], p[8], p[9], "mul_add", 1.0, a, m,
                                                save_feats=False), *chain(48, 3))
    x, _, _, *p = chain(24, 3)
    out["B4 fused_dense_spatial"] = run(lambda x, *p: dc.fused_dense_spatial(x, p[:4], p[4:8]), x, *p[:8])
    xd, off, mask, w, _ = make_deform(rng, (2, 13, 21), 5, 3, device)
    out["B5 deform_conv2d"] = run(lambda *t: df.deform_conv2d(*t), xd, off, mask, w)
    xt, wt, bt, _ = make_temporal_conv(rng, (1, 3, 5, 7), 131, 48, device)
    out["B6 temporal_conv3_fused"] = run(lambda x, w, b: tc.temporal_conv3_fused(x, w, b, 0.2), xt, wt, bt)
    h, g = chain(3, 48), chain(3, 48)
    out["B7 fused_hg_pair"] = run(
        lambda x, x2, *p: cv.fused_hg_pair(x, x2, p[:4], p[4:8], p[8], p[9], p[10:14], p[14:18], p[18], p[19],
                                           1.0, False), h[0], h[1], *h[3:], *g[3:])
    x, _, _, *p = chain(64, 64)
    out["B8 dense_chain_v3"] = run(lambda x, *p: cv.dense_chain_v3(x, p[:4], p[4:8], p[8], p[9]), x, *p)
    out["B9 dense_chain_ride"] = run(
        lambda x, a, m, *p: cv.dense_chain_ride(x, p[:4], p[4:8], p[8], p[9], "add", 1.0, a, m), *chain(48, 3))
    return out


def wrapper_counts():
    return {"B1": dc.launches, "B3": dc.launches_feats, "B2": dc.launches_bwd, "B4": dc.launches_spatial,
            "B5": df.launches + df.launches_bwd, "B6": sum(tc.launches_by_path.values()),
            "B7": cv.launches_hg, "B8": cv.launches_v3, "B9": cv.launches_ride}


def _batch_slice(v, j, n2):
    """Batch entry j of every tensor in ``v`` (nested tuples, lists, dicts)
    whose axis 0 is ``n2`` (a batch of two)."""
    if torch.is_tensor(v):
        return v[j * (n2 // 2):(j + 1) * (n2 // 2)] if v.dim() and v.shape[0] == n2 else v
    if isinstance(v, (tuple, list)):
        return type(v)(_batch_slice(u, j, n2) for u in v)
    if isinstance(v, dict):
        return {k: _batch_slice(u, j, n2) for k, u in v.items()}
    return v


def _first_tensor(v):
    while isinstance(v, (tuple, list)):
        v = v[0]
    return v


def batch_dependence(net, lr, eps):
    """Where ``net.decode`` on one card depends on the batch it runs in (what
    a dp split changes): ``lr`` / ``eps`` hold two GOP groups on axis 0. The
    decode of both is recorded call by call at every D2DT chain, GlobalAgg
    and 1x1 tail; each call is run again on each group alone, from the same
    inputs, and the two outputs compared. GlobalAgg is also taken apart:
    its pool, its attention and its mix's 1x1 product and einsum, each from
    the same inputs. Returns the calls whose output differs, in call order,
    and the whole decode's HR difference."""
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, args, kwargs, out, name=name: calls.append((name, mod, args, kwargs, _first_tensor(out))),
        with_kwargs=True) for name, m in net.named_modules() if isinstance(m, (D2DT, GlobalAgg, _PW))]
    with torch.no_grad():
        try:
            hr2 = net.decode(lr, eps=eps)[0]
        finally:
            for h in hooks:
                h.remove()
        return _batch_dependence(net, lr, eps, hr2, calls)


def _batch_dependence(net, lr, eps, hr2, calls):
    diff = lambda a, b: (a.float() - b.float()).abs().max().item()  # noqa: E731
    hr = max(diff(hr2[j:j + 1], net.decode(lr[j:j + 1], eps=eps[j:j + 1])[0]) for j in (0, 1))
    differ, agg = [], {}
    for i, (name, mod, args, kwargs, out) in enumerate(calls):
        n2 = args[0].shape[0]
        d = max(diff(_batch_slice(out, j, n2), _first_tensor(mod(*_batch_slice(args, j, n2),
                                                                  **_batch_slice(kwargs, j, n2))))
                for j in (0, 1))
        if d > 0:
            differ.append([i, name, type(mod).__name__, d])
        if isinstance(mod, GlobalAgg):
            x = args[0]
            pooled = adaptive_avg_pool2d(x, (32, 32))
            attn = mod.attention(pooled)
            proj = pointwise(x, mod.proj1_w, mod.proj1_b)
            mixed = torch.einsum("bihwc,bij->bjhwc", proj, attn)
            agg[name] = {step: max(diff(whole[j:j + 1], alone(j)) for j in (0, 1)) for step, whole, alone in (
                ("pool", pooled, lambda j: adaptive_avg_pool2d(x[j:j + 1], (32, 32))),
                ("attention", attn, lambda j: mod.attention(pooled[j:j + 1])),
                ("proj1_matmul", proj, lambda j: pointwise(x[j:j + 1], mod.proj1_w, mod.proj1_b)),
                ("mix_einsum", mixed, lambda j: torch.einsum("bihwc,bij->bjhwc", proj[j:j + 1], attn[j:j + 1])))}
    return {"hr_max_abs_diff": hr, "calls": len(calls), "differing_calls": differ, "global_agg_steps": agg}


def mesh_split_errors(st, ref):
    """A split step (``mesh_step``) against the unsplit one: the loss, the
    whole gradient, each leaf's gradient and update (relative l2), over the
    leaves whose gradient is not zero (one below TRAIN_GRAD_ZERO of the
    largest, or GlobalAgg's ``proj3_b``, whose gradient is zero by
    construction: the softmax over the keys cancels a bias added to every
    key)."""
    top = max(g.abs().max().item() for g in ref["grads"].values())
    live = [k for k, g in ref["grads"].items()
            if g.abs().max().item() >= TRAIN_GRAD_ZERO * top and not k.endswith("proj3_b")]
    upd = {k: rel_l2(st["after"][k] - st["before"][k], ref["after"][k] - ref["before"][k]) for k in live}
    leaf = {k: rel_l2(st["grads"][k], ref["grads"][k]) for k in live}
    worst = max(leaf, key=leaf.get)
    r = {"loss_rel_diff": abs(st["loss"] - ref["loss"]) / abs(ref["loss"]),
         "grad_rel_l2": grads_rel_l2({k: st["grads"][k] for k in live}, {k: ref["grads"][k] for k in live}),
         "worst_param_grad_rel_l2": leaf[worst], "worst_leaf": worst,
         "worst_param_update_rel_l2": max(upd.values()), "leaves_held": len(live), "leaves": len(ref["grads"])}
    r["within_limits"] = (r["loss_rel_diff"] <= MESH_LOSS_REL_LIMIT and r["grad_rel_l2"] <= MESH_GRAD_L2_LIMIT
                          and r["worst_param_grad_rel_l2"] <= MESH_GRAD_REL_LIMIT
                          and r["worst_param_update_rel_l2"] <= MESH_UPDATE_L2_LIMIT)
    return r


def mesh_step(model, step):
    """One training step of ``model`` (``step()``), every count set to 0
    just before and read just after: the loss, every gradient, the
    parameters before and after, and the kernels' calls by card, by stripe
    and (B4, B6) by width, B6's and B7's by card and width."""
    params = (model.params if isinstance(model, CodecModel) else model.net).named_parameters
    before = {k: p.detach().clone() for k, p in params()}
    reset_all_counts()
    df.reset_launch_counts()
    step()
    torch.cuda.synchronize()
    out = {"launches_by_card": launches_by_card(), "counts": {**stripe_counts(), **codec_counts()},
           "b6_b7_by_card": hg_card_counts(),
           "b6_by_width": {"forward": dict(tc.launches_by_width), "backward": dict(tc.launches_bwd_by_width)}}
    out.update(loss=model.get_current_log()["loss"], before=before,
               grads={k: p.grad.detach().clone() for k, p in params()},
               after={k: p.detach().clone() for k, p in params()})
    return out




def mesh_codec(c0, meshes, worst_stripe, worst_gc_bwd):
    """``train_compression.yml``'s step at full width (the surrogate with
    its correlation term), fp32, sp 2 against sp 1: from one seeded tree and
    one fed codec output, with and without ``deart_net``; then one step
    each through the host codec (the zlib stand-in here), whose input (the
    quantised LR gathered to whole frames) and bpp must be sp 1's exactly.
    Returns the ``mesh`` line's part and the kernels-line rows of B1 (the
    coupling's and the prior's chains) and B4 (the surrogate's) at the
    sp 2 haloed shard."""
    batch = codec_train_batch()
    part, rows_counts = {}, None
    for tag, net_opt in (("codec_train_sp", None), ("codec_deart_train_sp", {"deart_net": True})):
        probe = CodecModel(codec_train_options(net_opt), mesh=meshes["sp1"], rng_seed=0)
        tree = codec_tree(probe, 51)
        probe.load_jax_params(tree)
        check(probe.feed_data({"GT": batch}) == CODEC_TRAIN_SHAPE[1], "feed_data returns the clip length")
        if net_opt:
            scale_deart_offsets(probe.net, tree["net"], probe.degrade(probe._hr))
        else:
            plain_tree = tree
        with torch.no_grad():
            shared, _ = probe.codec_span(probe._encode_lf(probe._hr), probe.q)
        del probe
        steps = {}
        for name in ("sp1", "sp2"):
            model = CodecModel(codec_train_options(net_opt), mesh=meshes[name], rng_seed=0)
            model.load_jax_params(tree)
            check(model.feed_data({"GT": batch}) == CODEC_TRAIN_SHAPE[1], "feed_data returns the clip length")
            steps[name] = mesh_step(model, lambda m=model: m.optimize_parameters(0, codec_out=shared))
            steps[name]["ms"] = time_cuda(lambda m=model: m.optimize_parameters(1, codec_out=shared),
                                          iters=MESH_TIMED_STEPS, warmup=1)
            del model
        r = mesh_split_errors(steps["sp2"], steps["sp1"])
        check(r["within_limits"], f"the codec step with the width over sp 2 against sp 1 ({tag}): {r}")
        part[tag] = {**r, "step_ms": {k: st["ms"] for k, st in steps.items()},
                     "launches_by_card": {k: st["launches_by_card"] for k, st in steps.items()}}
        n_b1 = {k: sum(c.get("B1", 0) for c in st["launches_by_card"].values()) for k, st in steps.items()}
        n_b5 = {k: sum(c.get("B5", 0) + c.get("B5_bwd", 0) for c in st["launches_by_card"].values())
                for k, st in steps.items()}
        # B5 runs whole on the master card: as many calls as unsplit, all there
        b5_cards = {k for k, c in steps["sp2"]["launches_by_card"].items() if c.get("B5", 0) + c.get("B5_bwd", 0)}
        check(n_b1["sp2"] == 2 * n_b1["sp1"] and n_b5["sp2"] == n_b5["sp1"] and b5_cards <= {str(c0)},
              f"B1 / B5 calls of the codec step sp 2 / sp 1 ({tag}): {n_b1}, {n_b5} on {b5_cards}")
        if net_opt is None:
            rows_counts = steps["sp2"]["counts"]
        del steps

    # the host codec: its input gathered on the host, the same bits as sp 1's
    seen, logs = {}, {}
    for name in ("sp1", "sp2"):
        model = CodecModel(codec_train_options(), mesh=meshes[name], rng_seed=0)
        model.load_jax_params(plain_tree)
        model.feed_data({"GT": batch})
        host = model._host_codec

        def recorded(lr_q, q, name=name, host=host):
            seen[name] = lr_q.copy()
            return host(lr_q, q)

        model._host_codec = recorded
        model.optimize_parameters(0)
        logs[name] = dict(model.get_current_log())
        del model
    same = np.array_equal(seen["sp1"], seen["sp2"])
    loss_rel = abs(logs["sp2"]["loss"] - logs["sp1"]["loss"]) / abs(logs["sp1"]["loss"])
    check(same and logs["sp2"]["img_bpp"] == logs["sp1"]["img_bpp"] and loss_rel <= MESH_LOSS_REL_LIMIT,
          f"the codec step through the host codec, sp 2 against sp 1: lr_q the same bits {same}, bpp "
          f"{logs['sp2']['img_bpp']} / {logs['sp1']['img_bpp']}, loss {loss_rel}")
    part["codec_host_sp"] = {"lr_q_same_bits": same, "lr_q_shape": list(seen["sp1"].shape),
                             "img_bpp": {k: v["img_bpp"] for k, v in logs.items()},
                             "rate_source": logs["sp1"]["rate_source"], "loss_rel_diff": loss_rel}

    # the kernels at the sp 2 haloed shard: B1 (the chains pack within it), B4
    rng = np.random.default_rng(190)
    lat = CODEC_TRAIN_LAT
    w = lat[3] // 2 + spatial.HALO
    P = dc.pick_pack_w(lat[0], w)
    shard = (lat[0] // P, *lat[1:3], P * w)
    w4 = lat[3] // 2 + spatial.block_reach(DenseBlock2D(4, 24))[0]   # the surrogate's 2-D dense blocks
    rows = chain_rows(c0, "codec_train_sp2", shard, w if P > 1 else 0, CODEC_WIDTHS, [], rows_counts,
                      worst_stripe)
    rows += spatial_rows(c0, "codec_train_sp2", (*lat[:3], w4), rows_counts, worst_gc_bwd, rng)
    part["codec_train_sp"]["shard_packed"], part["codec_train_sp"]["surrogate_shard"] = list(shard), [*lat[:3], w4]
    return part, rows


def mesh_haar(c0, meshes, worst_haar):
    """The Haar SelfC 4x net at the ``haar`` phase's widths, sp 2 against
    sp 1: the fp32 packed step on the published batch from one seeded tree
    and one eps (and once recomputing the chains' features: B3), and one
    GOP through ``test()``. Returns the ``mesh`` line's part and the
    kernels-line rows of B1, B3 and B2 at the level 1 and level 2 sp 2
    haloed shards."""
    batch = train_batch(161)
    tree = seeded_tree(define_G(haar_options(), device=c0), 162)
    lat = (*TRAIN_SHAPE, 3)
    steps, eps = {}, None
    for name, mesh, extra in (("sp1", meshes["sp1"], {}), ("sp2", meshes["sp2"], {}),
                              ("sp2_recompute", meshes["sp2"], {"save_chain_feats": False})):
        model = RescaleModel(haar_train_options(**MESH_HAAR_TRAIN, **extra), mesh=mesh, rng_seed=0)
        model.load_jax_params(tree)
        check(model.feed_data({"GT": batch}) == TRAIN_SHAPE[1], "feed_data returns the clip length")
        if eps is None:
            eps = torch.randn(model.net.eps_shape(lat), generator=torch.Generator(c0).manual_seed(23), device=c0)
        steps[name] = mesh_step(model, lambda m=model: m.optimize_parameters(0, eps=eps))
        if name != "sp2_recompute":
            steps[name]["ms"] = time_cuda(lambda m=model: m.optimize_parameters(1, eps=eps),
                                          iters=MESH_TIMED_STEPS, warmup=1)
        del model
    part = {}
    r = mesh_split_errors(steps["sp2"], steps["sp1"])
    same_recompute = steps["sp2_recompute"]["loss"] == steps["sp2"]["loss"]
    check(r["within_limits"] and same_recompute,
          f"the Haar step with the width over sp 2 against sp 1: {r}; recomputing the same loss {same_recompute}")
    n_b1 = {k: sum(c.get("B1", 0) for c in st["launches_by_card"].values()) for k, st in steps.items()}
    check(n_b1["sp2"] == 2 * n_b1["sp1"], f"B1 calls of the Haar step sp 2 / sp 1: {n_b1}")
    part["haar_train_sp"] = {**r, "batch": list(batch.shape), "train": MESH_HAAR_TRAIN,
                             "recompute_same_loss": same_recompute,
                             "step_ms": {k: st["ms"] for k, st in steps.items() if "ms" in st},
                             "launches_by_card": {k: st["launches_by_card"] for k, st in steps.items()}}
    counts = dict(steps["sp2"]["counts"], feats_stripe=steps["sp2_recompute"]["counts"]["feats_stripe"])
    del steps

    # one GOP through test()
    gop = serve_clip(frames=7)
    served, scounts = {}, {}
    for name in ("sp1", "sp2"):
        model = RescaleModel(haar_options(gop_batch=1), mesh=meshes[name], rng_seed=0)
        model.load_jax_params(tree)
        model.feed_data({"GT": gop})
        model.generator.manual_seed(7)
        reset_all_counts()
        model.test(gop=7)
        torch.cuda.synchronize()
        scounts[name] = launches_by_card()
        served[name] = model
    a, b = served["sp1"], served["sp2"]
    y_err = float(np.abs(a.forw_H - b.forw_H).max())
    lr = torch.from_numpy(a.forw_L).to(c0)
    eps = torch.randn(a.net.eps_shape(lr.shape), generator=torch.Generator(c0).manual_seed(8), device=c0)
    hr_a = a._decode_on(meshes["sp1"].devices, Replicas(), lr, eps)[0]
    hr_b = b._decode_on(meshes["sp2"].devices, Replicas(), lr, eps)[0]
    hr_err = (hr_a - hr_b).abs().max().item()
    check(y_err <= MESH_SP_Y_LIMIT and hr_err <= MESH_SP_HR_LIMIT and np.isfinite(b.fake_H).all(),
          f"the Haar test() with the width over sp 2 against sp 1: latent {y_err}, HR from one lr {hr_err}")
    part["haar_eval_sp"] = {"clip": list(gop.shape), "limits": [MESH_SP_Y_LIMIT, MESH_SP_HR_LIMIT],
                            "latent_max_abs_diff": y_err, "lr_levels_differing": int((a.forw_L != b.forw_L).sum()),
                            "hr_from_one_lr_max_abs_diff": hr_err, "launches_by_card": scounts,
                            "gop_ms": {k: time_cuda(lambda m=m: m.test(gop=7), iters=MESH_TIMED_STEPS, warmup=1)
                                       for k, m in served.items()}}
    del served, a, b, hr_a, hr_b

    # B1, B3 and B2 at each level's sp 2 haloed shard, packed call by call
    rows = []
    for level, widths in ((1, ((9, 3), (3, 9))), (2, ((45, 3), (3, 45), (3, 12), (12, 24), (24, 48), (48, 32)))):
        B, T, H, W = HAAR_TRAIN[level]
        w = W // 2 + spatial.HALO
        P = dc.pick_pack_w(B, w)
        shard = (B // P, T, H, P * w)
        rows += chain_rows(c0, f"haar_train_sp2_L{level}", shard, w if P > 1 else 0,
                           [(C, c_out, 32) for C, c_out in widths],
                           [(C, 32) for C in dict.fromkeys(C for C, _ in widths)], counts, worst_haar)
        part["haar_train_sp"][f"shard_L{level}_packed"] = list(shard)
    return part, rows


def mesh_pair(meshes, make, step, extra=None):
    """``make(mesh)`` at sp 1 and sp 2, one ``mesh_step`` of ``step(model, 0)``
    each (``extra(model)`` adds to its record), then MESH_OPT_TIMED_STEPS of
    ``step(model, 1)`` after a warm-up, timed with CUDA events. Returns
    ``{"sp1": ..., "sp2": ...}``."""
    steps = {}
    for name in ("sp1", "sp2"):
        model = make(meshes[name])
        steps[name] = mesh_step(model, lambda m=model: step(m, 0))
        steps[name].update(extra(model) if extra else {})
        steps[name]["ms"] = time_cuda(lambda m=model: step(m, 1), iters=MESH_OPT_TIMED_STEPS, warmup=1)
        del model
    return steps


def hg_card_counts():
    """B7's calls (its forward kernel, and its backward route with the
    kernels) and B6's by card and width since the last reset."""
    out = {}
    for name, counts in (("B7", cv.launches_hg_by_device), ("B6", tc.launches_by_device)):
        for (entry, index, w), n in counts.items():
            out.setdefault(f"cuda:{index}", {})[f"{name}_{entry}@W{w}"] = n
    return out


def mesh_gan(c0, meshes):
    """``train_rescaling_gan.yml``'s step ('ragan' with the feature loss)
    at full width on the published batch, sp 2 against sp 1 from one set of
    seeded G, D, F weights and statistics and one eps: G's pixel losses by
    shards, the fake gathered whole on the master card for F and D."""
    trees, _ = gan_trees(c0)
    batch = train_batch(171)
    eps = torch.randn(TRAIN_SHAPE + (48, 5), generator=torch.Generator(c0).manual_seed(172), device=c0)
    g, d, f, stats = trees

    def make(mesh):
        model = RescaleModel(gan_options(), mesh=mesh, rng_seed=0)
        model.load_jax_params(g)
        load_jax_params(model.gan.netD, d)
        model.gan.load_stats(stats)
        load_jax_params(model.gan.netF, f)
        check(model.feed_data({"GT": batch}) == TRAIN_SHAPE[1], "feed_data returns the clip length")
        return model

    # step 1: past D_init_iters, so G updates
    steps = mesh_pair(meshes, make, lambda m, i: m.optimize_parameters(1 + i, eps=eps), lambda m: {
        "d_grads": {k: p.grad.detach().clone() for k, p in m.gan.netD.named_parameters()},
        "d_stats": m.gan.stats_numpy(), "logs": dict(m.get_current_log())})
    a, b = steps["sp1"], steps["sp2"]
    r = mesh_split_errors(b, a)
    r["losses_rel_diff"] = {k: abs(b["logs"][k] - a["logs"][k]) / abs(a["logs"][k])
                            for k in ("l_g_gan", "l_g_fea", "l_d")}
    r["d_grad_rel_l2"] = grads_rel_l2(b["d_grads"], a["d_grads"])
    r["d_stats_rel_l2"] = max(rel_l2(b["d_stats"][k][n], a["d_stats"][k][n]) for k in a["d_stats"] for n in ("mean", "var"))
    check(r["within_limits"] and max(r["losses_rel_diff"].values()) <= MESH_LOSS_REL_LIMIT
          and r["d_grad_rel_l2"] <= MESH_GRAD_L2_LIMIT and r["d_stats_rel_l2"] <= MESH_GRAD_L2_LIMIT,
          f"the GAN step with the width over sp 2 against sp 1: {r}")
    return {**r, "batch": list(batch.shape), "gan": GAN_TRAIN, "step_ms": {k: st["ms"] for k, st in steps.items()},
            "launches_by_card": {k: st["launches_by_card"] for k, st in steps.items()}}


def mesh_hg(c0, meshes, worst_var):
    """The published 4x net with ``chain_variants: [hg]``: its training step
    on the published batch and one GOP at 576 x 704 through ``test()``, sp 2
    against sp 1 from one set of weights and one eps; B7's calls by card
    and width (at sp 2 the haloed shard's). Returns the ``mesh`` line's
    part and the kernels-line rows of B7, forward and backward, at the
    training step's haloed shard."""
    network = {**NETWORK_G, "chain_variants": ["hg"]}
    tree = seeded_tree(define_G(serve_options(network), device=c0), 181)
    batch = train_batch(182)
    eps = torch.randn(TRAIN_SHAPE + (48, 5), generator=torch.Generator(c0).manual_seed(183), device=c0)

    def make(mesh):
        model = RescaleModel(train_options(network), mesh=mesh, rng_seed=0)
        model.load_jax_params(tree)
        check(model.feed_data({"GT": batch}) == TRAIN_SHAPE[1], "feed_data returns the clip length")
        return model

    steps = mesh_pair(meshes, make, lambda m, i: m.optimize_parameters(i, eps=eps))
    r = mesh_split_errors(steps["sp2"], steps["sp1"])
    w = TRAIN_SHAPE[3] // 2 + spatial.HALO
    b7 = {k: sum(n for c in st["b6_b7_by_card"].values() for e, n in c.items() if e.startswith("B7_forward"))
          for k, st in steps.items()}
    b7_halo = sum(n for c in steps["sp2"]["b6_b7_by_card"].values() for e, n in c.items()
                  if e == f"B7_forward@W{w}")
    b7_bwd = sum(n for c in steps["sp2"]["b6_b7_by_card"].values() for e, n in c.items() if e == f"B7_bwd@W{w}")
    # the unsplit step's calls, for B7's rows at the whole latent
    b7_bwd_sp1 = sum(n for c in steps["sp1"]["b6_b7_by_card"].values() for e, n in c.items()
                     if e == f"B7_bwd@W{TRAIN_SHAPE[3]}")
    check(r["within_limits"] and b7["sp2"] == 2 * b7["sp1"] > 0 and b7_halo == b7["sp2"] and b7_bwd == b7_halo
          and b7_bwd_sp1 == b7["sp1"],
          f"the hg step with the width over sp 2 against sp 1: {r}; B7 calls {b7}, at the haloed width {w}: "
          f"{b7_halo} forward, {b7_bwd} backward; unsplit backward {b7_bwd_sp1}")
    part = {"hg_train_sp": {**r, "batch": list(batch.shape), "haloed_w": w, "b7_calls": b7,
                            "step_ms": {k: st["ms"] for k, st in steps.items()},
                            "b6_b7_by_card": {k: st["b6_b7_by_card"] for k, st in steps.items()},
                            "launches_by_card": {k: st["launches_by_card"] for k, st in steps.items()}}}
    del steps

    # one GOP through test()
    gop = serve_clip(frames=7)
    served, counts = {}, {}
    for name in ("sp1", "sp2"):
        model = RescaleModel(serve_options(network, gop_batch=1), mesh=meshes[name], rng_seed=0)
        model.load_jax_params(tree)
        model.feed_data({"GT": gop})
        model.generator.manual_seed(7)
        reset_all_counts()
        model.test(gop=7)
        torch.cuda.synchronize()
        counts[name] = hg_card_counts()
        served[name] = model
    a, b = served["sp1"], served["sp2"]
    y_err = float(np.abs(a.forw_H - b.forw_H).max())
    lr = torch.from_numpy(a.forw_L).to(c0)
    e = torch.randn(a.net.eps_shape(lr.shape), generator=torch.Generator(c0).manual_seed(8), device=c0)
    hr_err = (a._decode_on(meshes["sp1"].devices, Replicas(), lr, e)[0]
              - b._decode_on(meshes["sp2"].devices, Replicas(), lr, e)[0]).abs().max().item()
    n_sp2 = sum(n for c in counts["sp2"].values() for k, n in c.items() if k.startswith("B7_forward"))
    check(y_err <= MESH_SP_Y_LIMIT and hr_err <= MESH_SP_HR_LIMIT and np.isfinite(b.fake_H).all() and n_sp2 > 0,
          f"the hg test() with the width over sp 2 against sp 1: latent {y_err}, HR from one lr {hr_err}, "
          f"B7 calls {counts}")
    part["hg_eval_sp"] = {"clip": list(gop.shape), "latent_max_abs_diff": y_err,
                          "lr_levels_differing": int((a.forw_L != b.forw_L).sum()),
                          "hr_from_one_lr_max_abs_diff": hr_err, "b7_by_card": counts,
                          "gop_ms": {k: time_cuda(lambda m=m: m.test(gop=7), iters=MESH_OPT_TIMED_STEPS, warmup=1)
                                     for k, m in served.items()}}
    del served, a, b

    # B7 at the haloed shard of the sp 2 step and at the unsplit step's
    # latent: forward and backward
    rows = hg_rows(c0, "train_sp2", (*TRAIN_SHAPE[:3], w), b7_halo, b7_bwd, worst_var)
    rows += hg_rows(c0, "train_sp1", TRAIN_SHAPE, b7["sp1"], b7_bwd_sp1, worst_var)
    return part, rows


def hg_rows(device, tag, shape, n_fwd, n_bwd, worst_var, C=3, c_out=48):
    """B7's kernels-line rows at ``shape``: its forward (against the plain
    pair and the library pair), and its backward route (``hg_adjoint``
    with the kernels, against the plain adjoint at the same features and
    one autograd call through the library pair)."""
    rng = np.random.default_rng(185)
    args = chain_pair(rng, shape, C, c_out, 32, device)
    x, x2 = args[0], args[1]
    h, g = args[2:6], args[6:10]
    params = [*h[0], *h[1], h[2], h[3], *g[0], *g[1], g[2], g[3]]
    got = cv._hg_cuda(*args, 1.0, False)
    want = cv.fused_hg_pair_plain(*args, 1.0, False)
    err = max((u - v).abs().max().item() for u, v in zip(got, want))
    check(err <= FP32_LIMIT, f"B7 vs plain at {shape}: {err}")
    se = got[1]
    gy, gs = seeded_grads(rng, se, device), seeded_grads(rng, se, device)
    feats = [dc.chain_feats(x, list(ws), list(bs)) for ws, bs in (h[:2], g[:2])]
    bwd = cv.hg_adjoint(x, x2, se, params, gy, gs, 1.0, False, feats=feats)
    bwd_plain = cv.hg_adjoint(x, x2, se, params, gy, gs, 1.0, False, feats=feats, plain=True)
    err_b = max((u - v).abs().max().item() for u, v in zip(bwd, bwd_plain))
    rel_b = max((u - v).abs().max().item() / max(v.abs().max().item(), 1e-30) for u, v in zip(bwd, bwd_plain))
    check(rel_b <= MESH_GUARD_LIMIT, f"B7's backward route vs the plain adjoint at {shape}: {rel_b} of max |ref|")
    leaf = lambda t: t.detach().requires_grad_(True)  # noqa: E731
    lx = leaf(to_library_layout(x, *h, None, None)[0])
    lib_h, lib_g = ([lx, [leaf(w) for w in ws], [leaf(b) for b in bs], leaf(w5), leaf(b5)]
                    for ws, bs, w5, b5 in (to_library_layout(x, *c, None, None)[1:5] for c in (h, g)))
    x2_lib = leaf(x2.permute(0, 4, 1, 2, 3).contiguous())
    lib_out = library_pair(lib_h, lib_g, x2_lib)
    leaves = [lx, *(t for c in (lib_h, lib_g) for t in (*c[1], *c[2], c[3], c[4])), x2_lib]
    lib_gy = [t.permute(0, 4, 1, 2, 3).contiguous() for t in (gy, gs)]
    with torch.no_grad():
        ms = time_cuda(lambda: cv._hg_cuda(*args, 1.0, False))
        plain = time_cuda(lambda: cv.fused_hg_pair_plain(*args, 1.0, False))
        library = time_cuda(lambda: library_pair(lib_h, lib_g, x2_lib))
    b_ms = time_cuda(lambda: cv.hg_adjoint(x, x2, se, params, gy, gs, 1.0, False))
    b_plain = time_cuda(lambda: cv.hg_adjoint(x, x2, se, params, gy, gs, 1.0, False, plain=True))
    b_lib = time_cuda(lambda: torch.autograd.grad(lib_out, leaves, lib_gy, retain_graph=True))
    common = {"route": "cuda", "source": SOURCE_HG, "replaces": REPLACES_HG, "shape": list(shape) + [C]}
    fwd_bound, by = hg_bound_ms(*shape, C, c_out, peak=TC_PEAK)
    bwd_bound, by_b = hg_bwd_bound_ms(*shape, C, c_out, peak=TC_PEAK)
    return [{"name": f"fused_hg_pair[{C}->{c_out}]@{tag}", **common, "launches": n_fwd,
             "max_abs_err": max(err, worst_var.get(("hg", C, c_out), 0.0)), "ms": ms["median"],
             "plain_ms": plain["median"], "bound_ms": fwd_bound, "bound_by": by, "library_ms": library["median"],
             "ms_min": ms["min"], "bound_fma_ms": hg_bound_ms(*shape, C, c_out)[0]},
            {"name": f"hg_adjoint[{C}->{c_out}]@{tag}", **common, "launches": n_bwd, "max_abs_err": err_b,
             "ms": b_ms["median"], "plain_ms": b_plain["median"], "bound_ms": bwd_bound, "bound_by": by_b,
             "library_ms": b_lib["median"], "ms_min": b_ms["min"],
             "bound_fma_ms": hg_bwd_bound_ms(*shape, C, c_out)[0]}]


def family_batch(seed, shape):
    """A smooth synthetic batch in [0,1] of ``shape`` (B, T, H, W, 3)."""
    rng = np.random.default_rng(seed)
    B, T, H, W, _ = shape
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    ph = rng.uniform(0, 6, (B, 1, 1, 1, 3))
    t = np.arange(T).reshape(1, T, 1, 1, 1)
    base = 0.5 + 0.3 * np.sin(7 * xx[None, None, :, :, None] + 0.3 * t + ph) * np.cos(5 * yy[None, None, :, :, None] + ph)
    return np.clip(base + rng.normal(0, 0.02, shape), 0, 1).astype(np.float32)


def mesh_families(c0, meshes, worst_tc):
    """The published 4x net with each subnet family of MESH_FAMILIES as its
    coupling subnets (the plain coupling on shards): one training step
    each, sp 2 against sp 1 from one set of weights and one eps, on a batch
    as wide as the family's ``width_rule`` needs; B6's calls by card and
    width. Returns the ``mesh`` line's part and the kernels-line rows of B6
    at the families' sp 2 haloed shards."""
    part, rows = {}, []
    for i, (family, shape) in enumerate(MESH_FAMILIES.items()):
        network = network_g(family)
        net = define_G(serve_options(network), device=c0)
        tree = seeded_tree(net, 190 + i)
        multiple, least, _, by = spatial.width_rule(net)
        check(shape[3] // 2 >= least and shape[3] % (2 * multiple) == 0,
              f"{family}: the batch {shape} splits at sp 2 ({multiple}, {least})")
        reach, grid = spatial.block_reach(net.inv_blocks_0.H)
        del net
        batch = family_batch(191 + i, shape)
        lat = (*shape[:2], shape[2] // 4, shape[3] // 4)
        eps = torch.randn(lat + (48, 5), generator=torch.Generator(c0).manual_seed(192 + i), device=c0)
        def make(mesh, network=network, tree=tree, batch=batch, shape=shape):
            model = RescaleModel(train_options(network), mesh=mesh, rng_seed=0)
            model.load_jax_params(tree)
            check(model.feed_data({"GT": batch}) == shape[1], "feed_data returns the clip length")
            return model

        steps = mesh_pair(meshes, make, lambda m, i, eps=eps: m.optimize_parameters(i, eps=eps))
        r = mesh_split_errors(steps["sp2"], steps["sp1"])
        n_b6 = {k: sum(st["b6_by_width"]["forward"].values()) for k, st in steps.items()}
        check(r["within_limits"] and n_b6["sp2"] == 2 * n_b6["sp1"],
              f"the {family} step with the width over sp 2 against sp 1: {r}; B6 forward calls {n_b6}")
        part[family] = {**r, "batch": list(shape), "width_rule": [multiple, least, by], "reach": [reach, grid],
                        "step_ms": {k: st["ms"] for k, st in steps.items()},
                        "b6_b7_by_card": {k: st["b6_b7_by_card"] for k, st in steps.items()},
                        "launches_by_card": {k: st["launches_by_card"] for k, st in steps.items()}}
        # B6 at the haloed shard's width (a collapse block's space-to-depth shrinks it 4x)
        if family in SUBNET_TC:
            widths, shrink = SUBNET_TC[family]
            w = (shape[3] // 2 // 4 + reach) // shrink
            b6_shape = (shape[0], shape[1], lat[2] // shrink, w)
            fwd, bwd = steps["sp2"]["b6_by_width"]["forward"], steps["sp2"]["b6_by_width"]["backward"]
            for C, co in widths:
                for backward, n in ((False, fwd.get((C, co), 0)), (True, bwd.get((C, co), 0))):
                    rows.append(temporal_row(c0, np.random.default_rng(193), f"{family}_sp2", b6_shape, C, co,
                                             backward, n, worst_tc))
            part[family]["b6_shard"] = list(b6_shape)
        del steps
    return part, rows


def mesh_matlab(c0, meshes):
    """The Haar SelfC 4x net's training step with ``distortion: matlab``,
    sp 2 against sp 1: the target made by shards (each shard's LR columns
    from its haloed HR columns: the same bits as the whole image's), the
    step's loss and gradients."""
    tree = seeded_tree(define_G(haar_options(), device=c0), 201)
    batch = train_batch(202)
    eps = torch.randn(define_G(haar_options(), device=c0).eps_shape((*TRAIN_SHAPE, 3)),
                      generator=torch.Generator(c0).manual_seed(203), device=c0)

    def make(mesh):
        opt = haar_train_options(**MESH_HAAR_TRAIN)
        opt["distortion"] = "matlab"
        model = RescaleModel(opt, mesh=mesh, rng_seed=0)
        model.load_jax_params(tree)
        check(model.feed_data({"GT": batch}) == TRAIN_SHAPE[1], "feed_data returns the clip length")
        return model

    steps = mesh_pair(meshes, make, lambda m, i: m.optimize_parameters(i, eps=eps))
    r = mesh_split_errors(steps["sp2"], steps["sp1"])
    hr = torch.from_numpy(batch).to(c0)
    with torch.no_grad():
        whole = make_degrade("matlab", 4)(hr)
        shards = spatial.degrade_shards("matlab", list(hr.chunk(2, dim=3)), 4, None)
        same = torch.equal(torch.cat(shards, dim=3), whole)
    check(r["within_limits"] and same, f"the matlab-target Haar step with the width over sp 2 against sp 1: {r}; "
                                       f"the target by shards the same bits {same}")
    return {**r, "batch": list(batch.shape), "target_same_bits": same,
            "step_ms": {k: st["ms"] for k, st in steps.items()},
            "launches_by_card": {k: st["launches_by_card"] for k, st in steps.items()}}


def mesh_pipeline(c0, meshes):
    """``train_compression.yml``'s pipelined step (``train.codec_pipeline``)
    through the host codec (the zlib stand-in: the card's machine has no
    x265): three calls and ``flush_pipeline`` at sp 2 beside sp 1, the sp 1
    model set to the sp 2 model's parameters and moments before each call,
    so that each retired update is held from one state: its loss, gradient
    and update (``mesh_split_errors``), and the host codec's input (the
    quantised LR gathered whole on the host) the same bits."""
    probe = CodecModel(codec_train_options(), mesh=meshes["sp1"], rng_seed=0)
    tree = codec_tree(probe, 211)
    del probe
    batches = [codec_train_batch(212 + i) for i in range(3)]
    models, seen = {}, {"sp1": [], "sp2": []}
    for name in ("sp1", "sp2"):
        models[name] = CodecModel(codec_train_options(codec_pipeline=True), mesh=meshes[name], rng_seed=0)
        models[name].load_jax_params(tree)
        host = models[name]._host_codec

        def recorded(lr_q, q, name=name, host=host):
            seen[name].append(lr_q.copy())
            return host(lr_q, q)

        models[name]._host_codec = recorded
    updates, wall = [], {"sp1": 0.0, "sp2": 0.0}
    for i in range(4):
        sync_codec(models["sp1"], models["sp2"])
        st = {}
        for name, model in models.items():
            if i < 3:
                check(model.feed_data({"GT": batches[i]}) == CODEC_TRAIN_SHAPE[1], "feed_data returns the clip length")
            t0 = time.time()
            if i == 0:   # the first call queues its batch and updates nothing
                model.optimize_parameters(0)
                check(not model.get_current_log(), "the first pipelined call logs nothing")
            else:
                st[name] = mesh_step(model, (lambda m=model, i=i: m.optimize_parameters(i)) if i < 3
                                     else model.flush_pipeline)
                st[name]["logs"] = dict(model.get_current_log())
            wall[name] += time.time() - t0
        if i:
            r = mesh_split_errors(st["sp2"], st["sp1"])
            check(r["within_limits"], f"pipelined update {i - 1} with the width over sp 2 against sp 1: {r}")
            updates.append({**r, "img_bpp": {k: v["logs"]["img_bpp"] for k, v in st.items()},
                            "launches_by_card": {k: v["launches_by_card"] for k, v in st.items()}})
    same = [bool(np.array_equal(a, b)) for a, b in zip(seen["sp1"], seen["sp2"])]
    check(len(same) == 3 and all(same), f"the host codec's input of each call, sp 2 against sp 1: {same}")
    del models
    return {"batch": list(CODEC_TRAIN_SHAPE), "calls": 3, "lr_q_same_bits": same, "updates": updates,
            "rate_source": h265.rate_source(None), "calls_s": wall}


def sync_codec(dst, src):
    """``dst``'s parameters and Adam state set to ``src``'s bits."""
    with torch.no_grad():
        for p, q in zip(dst.params.parameters(), src.params.parameters()):
            p.copy_(q)
            if q in src.optimizer.state:
                dst.optimizer.state[p] = {k: v.clone() for k, v in src.optimizer.state[q].items()}


def mesh_opts(c0, meshes, worst_var, worst_tc):
    """The options the width split once refused, each sp 2 against sp 1 at
    full width: the GAN step, ``hg`` (a step and a GOP), the subnet
    families, ``distortion: matlab`` and the pipelined codec step. Returns
    the ``mesh`` line's part and the kernels-line rows of B7 and B6."""
    part, rows = {}, []
    t0 = time.time()
    part["gan_train_sp"] = mesh_gan(c0, meshes)
    part["gan_s"] = time.time() - t0
    t0 = time.time()
    hg_part, hg = mesh_hg(c0, meshes, worst_var)
    part.update(hg_part, hg_s=time.time() - t0)
    t0 = time.time()
    part["families_train_sp"], b6 = mesh_families(c0, meshes, worst_tc)
    part["families_s"] = time.time() - t0
    t0 = time.time()
    part["matlab_train_sp"] = mesh_matlab(c0, meshes)
    part["matlab_s"] = time.time() - t0
    t0 = time.time()
    part["codec_pipeline_sp"] = mesh_pipeline(c0, meshes)
    part["pipeline_s"] = time.time() - t0
    return part, hg + b6


def phase_mesh(device, worst_stripe, worst_gc_bwd, worst_haar, worst_var, worst_tc, smi):
    """``--phases mesh``: the device mesh (``parallel/mesh.py``) on two mesh
    positions: distinct cards where the machine has two or more, else
    ``cuda:0`` twice (never the CPU).
    - eval over dp: the published 4x net on 10 x 576 x 704 with gop_batch 2
      (one call of 2 GOP groups, split 1 + 1), and the codec's ``test()`` on
      the 13 x 1080 x 1920 clip (its batched encode and decode calls split),
      dp 2 against dp 1, and which calls of the rescaling decode depend on
      the batch they run in (``batch_dependence``);
    - the width split (``mesh_sp``, ``parallel/spatial.py``): one GOP at 576
      x 704 through ``test()``, and the fp32 packed training step on
      (8,7,144,144,3) from one set of weights and one eps (and once with
      ``save_chain_feats: false``: B3), sp 2 against sp 1;
    - B1, B3 and B2 calls by card; the GOP and the step timed with CUDA
      events; the kernels-line rows of B1, B3 and B2 at the haloed,
      W-packed shard of the sp 2 step;
    - the width split of the codec and Haar nets (``mesh_codec``,
      ``mesh_haar``): the codec step (plain, with ``deart_net``, through the
      host codec) and the Haar step and GOP, sp 2 against sp 1, with B1 /
      B3 / B2 / B4 / B5 calls by card, the steps timed, and the kernels-line
      rows at their haloed shards;
    - on two or more cards, one call of each kernel wrapper on cuda:1 while
      cuda:0 is current, against its plain version there."""
    n_cards = torch.cuda.device_count()
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1 if n_cards >= 2 else 0)
    one = make_mesh(dp=1, sp=1, devices=[c0])
    meshes = {"dp2": make_mesh(dp=2, sp=1, devices=[c0, c1]), "sp2": make_mesh(dp=1, sp=2, devices=[c0, c1])}
    line = {"cards": meshes["dp2"].cards(), "device_count": n_cards, "nvidia_smi": smi,
            "meshes": {k: repr(m) for k, m in meshes.items()}}
    df.reset_launch_counts()

    # ---- eval over dp: the rescaling net ----
    clip = serve_clip()
    tree, out, counts = None, {}, {}
    for name, mesh in (("dp1", one), ("dp2", meshes["dp2"])):
        model = RescaleModel(serve_options(gop_batch=MESH_GOP_BATCH), mesh=mesh, rng_seed=0)
        tree = tree if tree is not None else seeded_tree(model.net, 2)
        model.load_jax_params(tree)
        check(model.feed_data({"GT": clip}) == 10, "feed_data returns the clip length")
        model.generator.manual_seed(5)
        dc.reset_launch_counts()
        model.test(gop=7)
        counts[name] = launches_by_card()
        out[name] = (model.fake_H, model.forw_L, model.forw_H, model.sample_H)
        line.setdefault("eval_dp_test_ms", {})[name] = time_cuda(lambda m=model: m.test(gop=7), iters=3, warmup=1)
        del model
    errs = [float(np.abs(a - b).max()) for a, b in zip(out["dp1"], out["dp2"])]
    same = all(np.array_equal(a, b) for a, b in zip(out["dp1"], out["dp2"]))
    # what differs: the decode of the call's two GOP groups together, and alone, on cuda:0
    model = RescaleModel(serve_options(), mesh=one, rng_seed=0)
    model.load_jax_params(tree)
    model.feed_data({"GT": clip})
    x = model.real_H
    chunk = torch.cat([x[:, :7], x[:, [7, 8, 9, 9, 9, 9, 9]]], dim=0)
    with torch.no_grad():
        lr = quantize_ste(model._encode(chunk)[..., :3].contiguous())
    eps = torch.randn(model.net.eps_shape(lr.shape), generator=torch.Generator(c0).manual_seed(9), device=c0)
    line["eval_dp_batch_dependence"] = batch_dependence(model.net, lr, eps)
    del model, x, chunk, lr, eps
    b1 = {k: sum(c.get("B1", 0) for c in v.values()) for k, v in counts.items()}
    check(max(errs) <= MESH_DP_LIMIT and b1["dp2"] == 2 * b1["dp1"],
          f"rescaling test() over dp 2 against dp 1: max abs {errs}, B1 calls {b1}")
    line["eval_dp"] = {"clip": list(clip.shape), "gop_batch": MESH_GOP_BATCH, "limit": MESH_DP_LIMIT,
                       "max_abs_diff_hr_lr_latent_sample": errs, "same_bits": same, "launches_by_card": counts}
    del out, clip

    # ---- eval over dp: the codec ----
    cclip, ctree, cout, ccounts = uvg_clip(), None, {}, {}
    for name, mesh in (("dp1", one), ("dp2", meshes["dp2"])):
        model = CodecModel(codec_options(), mesh=mesh, rng_seed=0)
        ctree = ctree if ctree is not None else seeded_tree(model.net, 41)
        model.load_jax_params(ctree)
        model.feed_data({"GT": cclip})
        dc.reset_launch_counts()
        t0 = time.time()
        model.test()
        torch.cuda.synchronize()
        cout[name] = (model.fake_H, np.asarray(model.forw_L), model.video_bpp, time.time() - t0)
        ccounts[name] = launches_by_card()
        del model
    cerrs = [float(np.abs(a - b).max()) for a, b in zip(cout["dp1"][:2], cout["dp2"][:2])]
    csame = all(np.array_equal(a, b) for a, b in zip(cout["dp1"][:2], cout["dp2"][:2]))
    check(max(cerrs) <= MESH_DP_LIMIT and cout["dp1"][2] == cout["dp2"][2],
          f"codec test() over dp 2 against dp 1: max abs {cerrs}, bpp {cout['dp1'][2]} / {cout['dp2'][2]}")
    line["codec_dp"] = {"clip": list(cclip.shape), "limit": MESH_DP_LIMIT, "max_abs_diff_hr_lr": cerrs,
                        "same_bits": csame, "video_bpp": cout["dp1"][2], "rate_source": h265.rate_source(None),
                        "test_s": {k: v[3] for k, v in cout.items()}, "launches_by_card": ccounts}
    del cout, cclip

    # ---- the width split: one GOP through test() ----
    gop = serve_clip(frames=7)
    served, scounts = {}, {}
    for name, mesh in (("sp1", one), ("sp2", meshes["sp2"])):
        model = RescaleModel(serve_options(gop_batch=1), mesh=mesh, rng_seed=0)
        model.load_jax_params(tree)
        model.feed_data({"GT": gop})
        model.generator.manual_seed(7)
        dc.reset_launch_counts()
        model.test(gop=7)
        scounts[name] = launches_by_card()
        served[name] = model
    a, b = served["sp1"], served["sp2"]
    y_err = float(np.abs(a.forw_H - b.forw_H).max())
    lr_flips = int((a.forw_L != b.forw_L).sum())
    # HR from one lr and one eps (a level that flipped would compare two decodes)
    lr = torch.from_numpy(a.forw_L).to(c0)
    eps = torch.randn(a.net.eps_shape(lr.shape), generator=torch.Generator(c0).manual_seed(8), device=c0)
    hr_a = a._decode_on(one.devices, Replicas(), lr, eps)[0]
    hr_b = b._decode_on(meshes["sp2"].devices, Replicas(), lr, eps)[0]
    hr_err = (hr_a - hr_b).abs().max().item()
    check(y_err <= MESH_SP_Y_LIMIT and hr_err <= MESH_SP_HR_LIMIT and np.isfinite(b.fake_H).all(),
          f"test() with the width over sp 2 against sp 1: latent {y_err}, HR from one lr {hr_err}")
    line["eval_sp"] = {"clip": list(gop.shape), "limits": [MESH_SP_Y_LIMIT, MESH_SP_HR_LIMIT],
                       "latent_max_abs_diff": y_err, "lr_levels_differing": lr_flips,
                       "hr_from_one_lr_max_abs_diff": hr_err,
                       "test_hr_max_abs_diff": float(np.abs(a.fake_H - b.fake_H).max()),
                       "launches_by_card": scounts,
                       "gop_ms": {k: time_cuda(lambda m=m: m.test(gop=7), iters=5, warmup=1)
                                  for k, m in served.items()}}
    del served, a, b, hr_a, hr_b, gop

    # ---- the width split: the training step ----
    batch = train_batch()
    lat = (TRAIN_SHAPE[0], TRAIN_SHAPE[1], TRAIN_SHAPE[2], TRAIN_SHAPE[3], 3)
    steps, eps = {}, None
    for name, mesh, extra in (("sp1", one, {}), ("sp2", meshes["sp2"], {}),
                              ("sp2_recompute", meshes["sp2"], {"save_chain_feats": False})):
        model = RescaleModel(train_options(**extra), mesh=mesh, rng_seed=0)
        model.load_jax_params(tree)
        check(model.feed_data({"GT": batch}) == TRAIN_SHAPE[1], "feed_data returns the clip length")
        if eps is None:
            eps = torch.randn(model.net.eps_shape(lat), generator=torch.Generator(c0).manual_seed(21), device=c0)
        steps[name] = mesh_step(model, lambda m=model: m.optimize_parameters(0, eps=eps))
        steps[name]["ms"] = time_cuda(lambda m=model: m.optimize_parameters(1, eps=eps), iters=5, warmup=1)
        del model
    ref = steps["sp1"]
    rows = {}
    for name in ("sp2", "sp2_recompute"):
        st = steps[name]
        rows[name] = r = {**mesh_split_errors(st, ref), "launches_by_card": st["launches_by_card"],
                          "step_ms": st["ms"]}
        check(r["within_limits"], f"the training step with the width over sp 2 against sp 1 ({name}): {r}")
    n_b1 = lambda st: sum(c.get("B1", 0) for c in st["launches_by_card"].values())  # noqa: E731
    n_b3 = sum(c.get("B3", 0) for c in steps["sp2_recompute"]["launches_by_card"].values())
    check(n_b1(steps["sp2"]) == 2 * n_b1(ref) and n_b3 == n_b1(steps["sp2_recompute"]),
          f"B1 calls a step sp 2 / sp 1: {n_b1(steps['sp2'])} / {n_b1(ref)}, B3 recomputing {n_b3}")
    w = TRAIN_SHAPE[3] // 2 + spatial.HALO     # an LR shard of the sp 2 step with its halo
    P = dc.pick_pack_w(TRAIN_SHAPE[0], w)
    shard = (TRAIN_SHAPE[0] // P, *TRAIN_SHAPE[1:3], P * w)
    line["train_sp"] = {"batch": list(batch.shape), "limits": [MESH_LOSS_REL_LIMIT, MESH_GRAD_L2_LIMIT,
                                                               MESH_GRAD_REL_LIMIT, MESH_UPDATE_L2_LIMIT],
                        "sp1_step_ms": ref["ms"], "sp1_launches_by_card": ref["launches_by_card"],
                        "shard_packed": list(shard), "stripe_w": w if P > 1 else 0, **rows}

    # ---- the kernels at the haloed shard of the sp 2 step ----
    counts = dict(steps["sp2"]["counts"], feats_stripe=steps["sp2_recompute"]["counts"]["feats_stripe"])
    del steps, ref, batch
    kernels = chain_rows(device, "train_sp2", shard, w if P > 1 else 0, [(C, c_out, 32) for C, c_out in PATH_WIDTHS],
                         [(C, 32) for C in CHAIN_C], counts, worst_stripe)

    # ---- the width split of the codec and Haar nets ----
    nets = {"sp1": one, "sp2": meshes["sp2"]}
    t0 = time.time()
    part, rows = mesh_codec(c0, nets, worst_stripe, worst_gc_bwd)
    line.update(part)
    kernels += rows
    part, rows = mesh_haar(c0, nets, worst_haar)
    line.update(part)
    kernels += rows
    line["nets_s"] = time.time() - t0

    # ---- the options the split once refused ----
    t0 = time.time()
    part, rows = mesh_opts(c0, nets, worst_var, worst_tc)
    line.update(part)
    kernels += rows
    line["opts_s"] = time.time() - t0

    # ---- every wrapper on cuda:1 while cuda:0 is current ----
    if n_cards >= 2:
        with torch.cuda.device(c0):
            before = wrapper_counts()
            got = wrapper_calls(c1)
            torch.cuda.synchronize(c1)
            launched = {k: v - before[k] for k, v in wrapper_counts().items()}
            with plain_chain_on_card():
                want = wrapper_calls(c1)
        guard = {}
        for name in got:
            on = {str(t.device) for t in got[name]}
            guard[name] = {"device": sorted(on), "rel_err": max(
                (u.float() - v.float()).abs().max().item() / max(v.float().abs().max().item(), 1e-30)
                for u, v in zip(got[name], want[name]))}
            check(on == {str(c1)} and guard[name]["rel_err"] <= MESH_GUARD_LIMIT,
                  f"{name} on cuda:1 while cuda:0 is current: {guard[name]}")
        check(all(n > 0 for n in launched.values()), f"every wrapper launched its kernel on cuda:1: {launched}")
        line["device_guard"] = {"limit": MESH_GUARD_LIMIT, "launches": launched, "calls": guard}
    else:
        line["device_guard"] = "not measured: one card"
    emit("mesh", **line)
    return kernels


# ---------------------------------------------------------------------------
# procs: the training steps over two processes
# ---------------------------------------------------------------------------

PROCS_RANKS = 2
PROCS_CASES = ("train", "codec", "gan")
PROCS_TIMED_STEPS = 3            # CUDA-event steps after the checked one, each rank and one process (median)
PROCS_GRAD_LIMIT = 1e-5          # the two-process step's averaged gradient against one process's, relative l2
PROCS_STATS_LIMIT = 1e-6         # D's running statistics against one process's, relative l2 (the worst leaf)
PROCS_LOG_LIMIT = 1e-6           # the losses and logs (the ranks' mean) against one process's, relative
PROCS_JOIN_S = 900


def procs_case(name, device):
    """A ``procs`` case on ``device``: the model with its seeded weights, the
    whole batch, the step and the per-clip step inputs (``eps``), and D's
    start (parameters and statistics) for the GAN. (a) ``train``: the packed
    SelfC_GMM 4x step of ``train_rescaling_selfc_large.yml``; (b) ``codec``:
    the serial codec step of ``train_compression.yml`` with its surrogate,
    through the host codec (the zlib stand-in); (c) ``gan``: the 'ragan' step
    of ``train_rescaling_gan.yml`` with the feature loss (D nf 64, VGG-19 F).
    """
    if name == "codec":
        model = CodecModel(codec_train_options(), device=device, rng_seed=0)
        model.load_jax_params(codec_tree(model, 202))
        return model, codec_train_batch(203), 0, {}, None
    eps = np.random.default_rng(201).normal(0, 1, TRAIN_SHAPE + (48, 5)).astype(np.float32)
    if name == "train":
        model = RescaleModel(train_options(), device=device, rng_seed=0)
        model.load_jax_params(seeded_tree(model.net, 204))
        return model, train_batch(205), 0, {"eps": eps}, None
    trees, _ = gan_trees(device)
    batch = train_batch(206)
    return new_gan_trainer(device, trees, batch), batch, 1, {"eps": eps}, trees


def procs_nets(model):
    """``[(tag, net, optimizer)]`` of a ``procs`` model: G (the codec's
    ``params``: its net and surrogate), and D with the adversarial branch."""
    if isinstance(model, CodecModel):
        return [("G", model.params, model.optimizer)]
    nets = [("G", model.net, model.optimizer)]
    if model.gan is not None:
        nets.append(("D", model.gan.netD, model.gan.optimizer))
    return nets


def procs_counts():
    """The chain kernels' calls since the last reset, by width (B1, B2, B3,
    B4 and its adjoint, B6) and by stripe."""
    counts = {**codec_counts(), **stripe_counts(), "b6": dict(tc.launches_by_width),
              "b6_bwd": dict(tc.launches_bwd_by_width)}
    return {k: {str(w): n for w, n in v.items()} for k, v in counts.items()}


def procs_step(model, batch, step, kw, part):
    """Feed ``part`` of the batch (a slice of clips; None: all of it), then
    one step with every count set to 0 just before and read just after:
    ``(counts, logs, peak GiB above what was live)``."""
    sl = slice(None) if part is None else part
    model.feed_data({"GT": batch[sl]})
    kw = {k: v[sl] for k, v in kw.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    model.optimize_parameters(step, **kw)
    torch.cuda.synchronize()
    counts = procs_counts()
    logs = {k: v for k, v in model.get_current_log().items() if not isinstance(v, str)}
    return counts, logs, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def procs_timed(model, step, kw, sl):
    """PROCS_TIMED_STEPS more steps (``step + 1``, ...) on the fed batch,
    each between CUDA events: their median, min and mean ms."""
    kw = {k: v[sl] for k, v in kw.items()}
    steps = iter(range(step + 1, step + 1 + PROCS_TIMED_STEPS))
    return time_cuda(lambda: model.optimize_parameters(next(steps), **kw), iters=PROCS_TIMED_STEPS, warmup=0)


def procs_grads(model):
    """Every gradient on the host, ``{"G.<name>" | "D.<name>": tensor}``."""
    return {f"{tag}.{k}": p.grad.detach().cpu() for tag, net, _ in procs_nets(model)
            for k, p in net.named_parameters() if p.grad is not None}


def procs_stats(model):
    return {f"{k}.{n}": t.detach().cpu() for k, v in model.gan.d_stats.items() for n, t in v.items()}


def procs_digests(model):
    """sha256 of the bytes of the parameters, the gradients, the Adam
    moments and counts, and D's running statistics: ``{part: hex}``."""
    import hashlib

    parts = {"params": hashlib.sha256(), "grads": hashlib.sha256(), "moments": hashlib.sha256()}
    for _, net, opt in procs_nets(model):
        for _, p in net.named_parameters():
            parts["params"].update(p.detach().cpu().numpy().tobytes())
            if p.grad is not None:
                parts["grads"].update(p.grad.detach().cpu().numpy().tobytes())
            for key in ("step", "exp_avg", "exp_avg_sq"):
                if key in opt.state.get(p, {}):
                    parts["moments"].update(opt.state[p][key].detach().cpu().numpy().tobytes())
    if getattr(model, "gan", None) is not None:
        parts["d_stats"] = hashlib.sha256()
        for t in procs_stats(model).values():
            parts["d_stats"].update(t.numpy().tobytes())
    return {k: h.hexdigest() for k, h in parts.items()}


def procs_rank(rank, port, out, go, nccl, device_type="cuda"):
    """One of the two ranks. With two cards or more it joins through
    ``init_distributed`` (NCCL, the rank's own card); with one card it first
    joins a gloo group itself (NCCL refuses two ranks on one device) and
    ``init_distributed`` keeps it, both ranks on ``cuda:0``. It builds no
    kernel (the parent built them); after ``go`` it runs each case on its
    half of the batch: the checked step, then the timed ones. It writes
    ``rank{r}.json`` (counts, logs, digests, ms, peak), and rank 0 the
    gradients and D's statistics (``rank0.pt``)."""
    import torch.distributed as dist

    from selfc_tpu_torch.parallel.dist import init_distributed

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(PROCS_RANKS),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), SELFC_TPU_DISABLE_X265="1")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not nccl:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=PROCS_RANKS, rank=rank)
    check(init_distributed(device_type) == (rank, PROCS_RANKS), f"rank {rank}: init_distributed")
    device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device(device_type)
    for name in build.kernel_names():
        check(build.library_path(name).exists(), f"rank {rank}: the parent built {name}")
    check(go.wait(PROCS_JOIN_S), f"rank {rank}: the parent's go")
    result, tensors = {"backend": dist.get_backend(), "device": str(device)}, {}
    for name in PROCS_CASES:
        model, batch, step, kw, _ = procs_case(name, device)
        n = batch.shape[0] // PROCS_RANKS
        part = slice(rank * n, (rank + 1) * n)
        counts, logs, peak = procs_step(model, batch, step, kw, part)
        result[name] = {"counts": counts, "logs": logs, "peak_gib": peak, "digests": procs_digests(model),
                        "clips": n}
        if rank == 0:
            tensors[name] = {"grads": procs_grads(model), "stats": procs_stats(model) if name == "gan" else {}}
        result[name]["ms"] = procs_timed(model, step, kw, part)
        del model
        torch.cuda.empty_cache()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    if rank == 0:
        torch.save(tensors, os.path.join(out, "rank0.pt"))
    dist.destroy_process_group()


def procs_reference(name, device):
    """The one-process run of a case on the whole batch: the checked step
    (counts, logs, gradients, D's statistics, peak; for the GAN D's
    gradient in float64 from the same start and fake), the timed steps,
    then one step on a rank's half for its counts."""
    model, batch, step, kw, trees = procs_case(name, device)
    ref = {}
    if trees is not None:
        eps = torch.as_tensor(kw["eps"], device=device)
        model.feed_data({"GT": batch})
        with torch.no_grad(), step_algorithms():
            hr = model.real_H
            fake = flat_frames(model._pixel_losses(hr, model.degrade(hr), eps)[2]["hr"])
        ref["d_grads_fp64"] = {k: v.cpu() for k, v in d_grad_fp64(model.gan, trees[1], trees[3], flat_frames(hr),
                                                                    fake).items()}
        del fake
    _, ref["logs"], ref["peak_gib"] = procs_step(model, batch, step, kw, None)
    ref["grads"] = procs_grads(model)
    ref["stats"] = procs_stats(model) if trees is not None else {}
    ref["ms"] = procs_timed(model, step, kw, slice(None))
    n = batch.shape[0] // PROCS_RANKS
    ref["counts"] = procs_step(model, batch, step + 1 + PROCS_TIMED_STEPS, kw, slice(0, n))[0]
    del model
    torch.cuda.empty_cache()
    return ref


def procs_grad_errors(grads, ref):
    """Each net's whole gradient (relative l2) and its worst leaf, over the
    leaves that are not zero (as ``mesh_split_errors``)."""
    out = {}
    for tag in ("G", "D"):
        want = {k: g.double() for k, g in ref.items() if k.startswith(tag + ".")}
        if not want:
            continue
        top = max(g.abs().max().item() for g in want.values())
        live = [k for k, g in want.items() if g.abs().max().item() >= TRAIN_GRAD_ZERO * top
                and not k.endswith("proj3_b")]
        leaf = {k: rel_l2(grads[k], want[k]) for k in live}
        worst = max(leaf, key=leaf.get)
        out[tag] = {"grad_rel_l2": grads_rel_l2({k: grads[k].double() for k in live}, {k: want[k] for k in live}),
                    "worst_leaf": worst, "worst_leaf_rel_l2": leaf[worst], "leaves_held": len(live)}
    return out


def phase_procs(device):
    """Every trained step over two processes, each rank on half of the
    batch, against the one-process step on the whole batch from the same
    weights: the SelfC_GMM 4x packed step, the serial codec step and the
    'ragan' GAN step, at full width. Two ranks are spawned once (NCCL on two
    cards when the machine has them, else gloo with both ranks on
    ``cuda:0``); the one-process references run first, in this process,
    while the ranks start. Checks: the ranks hold the same bits (parameters,
    gradients, Adam moments, D's statistics); the averaged gradient within
    PROCS_GRAD_LIMIT of one process's (D's: that, or no further from its
    float64 value than twice one process's fp32 distance, D's real and fake
    terms nearly cancelling); D's statistics PROCS_STATS_LIMIT; the losses
    and logs PROCS_LOG_LIMIT; each rank's chain calls those of one process
    on a rank's half of the batch. Times: each step's median of
    PROCS_TIMED_STEPS (CUDA events; rank 0's) beside one process's."""
    import multiprocessing as mp
    import socket

    t_phase = time.time()
    cards = torch.cuda.device_count()
    nccl = cards >= PROCS_RANKS
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    work = Path(tempfile.mkdtemp(prefix="selfc_procs_"))
    ctx = mp.get_context("spawn")
    go = ctx.Event()
    procs = [ctx.Process(target=procs_rank, args=(r, port, str(work), go, nccl, device.type))
             for r in range(PROCS_RANKS)]
    saved = os.environ.get("SELFC_TPU_DISABLE_X265")
    os.environ["SELFC_TPU_DISABLE_X265"] = "1"   # the zlib stand-in, here and in the ranks
    try:
        for p in procs:
            p.start()
        refs = {name: procs_reference(name, device) for name in PROCS_CASES}
        ref_s = time.time() - t_phase
        go.set()
        t0 = time.time()
        for p in procs:
            p.join(PROCS_JOIN_S)
        ranks_s = time.time() - t0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if saved is None:
            os.environ.pop("SELFC_TPU_DISABLE_X265")
        else:
            os.environ["SELFC_TPU_DISABLE_X265"] = saved
    try:
        check(all(p.exitcode == 0 for p in procs), f"the ranks' exit codes: {[p.exitcode for p in procs]}")
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(PROCS_RANKS)]
        tensors = torch.load(work / "rank0.pt")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"backend": ranks[0]["backend"], "cards": cards, "rank_devices": [r["device"] for r in ranks]}
    for name in PROCS_CASES:
        a, b, ref = ranks[0][name], ranks[1][name], refs[name]
        same = {k: a["digests"][k] == b["digests"][k] for k in a["digests"]}
        errs = procs_grad_errors(tensors[name]["grads"], ref["grads"])
        logs = {k: (a["logs"][k] + b["logs"][k]) / 2 for k in ref["logs"]}
        scale = {k: max(abs(v), 1.0) if k in ("D_real", "D_fake") else abs(v) for k, v in ref["logs"].items()}
        log_err = {k: abs(logs[k] - v) / scale[k] for k, v in ref["logs"].items()
                   if k not in ("lr", "skipped_nonfinite") and scale[k] > 0}
        r = {"same_bits": same, "grads": errs, "logs_rel_diff": log_err,
             "two_process_ms": a["ms"], "rank1_ms": b["ms"]["median"], "one_process_ms": ref["ms"],
             "peak_gib": {"rank0": a["peak_gib"], "rank1": b["peak_gib"], "one_process": ref["peak_gib"]},
             "clips_a_rank": a["clips"], "counts": a["counts"]}
        ok = (all(same.values()) and errs["G"]["grad_rel_l2"] <= PROCS_GRAD_LIMIT
              and max(log_err.values()) <= PROCS_LOG_LIMIT
              and a["logs"]["skipped_nonfinite"] == b["logs"]["skipped_nonfinite"] == 0.0
              and a["counts"] == b["counts"] == ref["counts"]
              and a["counts"]["forward"] and a["counts"]["backward"])
        if name == "gan":
            fp64 = ref["d_grads_fp64"]
            d_two = {k[len("D."):]: v for k, v in tensors[name]["grads"].items() if k.startswith("D.")}
            d_one = {k[len("D."):]: v for k, v in ref["grads"].items() if k.startswith("D.")}
            r["d_grad_fp64_rel_l2"] = {who: grads_rel_l2({f"gradD.{k}": v.double() for k, v in g.items()}, fp64)
                                       for who, g in (("two_process", d_two), ("one_process", d_one))}
            r["d_stats_rel_l2"] = max(rel_l2(tensors[name]["stats"][k], v) for k, v in ref["stats"].items())
            ok = ok and r["d_stats_rel_l2"] <= PROCS_STATS_LIMIT and (
                errs["D"]["grad_rel_l2"] <= PROCS_GRAD_LIMIT
                or r["d_grad_fp64_rel_l2"]["two_process"] <= 2 * r["d_grad_fp64_rel_l2"]["one_process"])
        check(ok, f"the {name} step over {PROCS_RANKS} processes ({out['backend']}, {cards} card(s)) against one "
                  f"process: {r}; one process's counts at the half batch {ref['counts']}")
        out[name] = r
    emit("procs", **out, reference_s=ref_s, ranks_s=ranks_s, phase_s=time.time() - t_phase)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated: kernels (build and check only), " + ", ".join(ALL_PHASES)
                    + "; resume_study (a study of the resumed run, not in the default run)")
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit: time against its kernels in turns")
    args = ap.parse_args()
    want = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    # every phase but mesh runs on the first card alone (an unindexed "cuda"
    # would put a model's test() over every card the machine has)
    device = torch.device("cuda", 0)
    # fp32 references stay fp32: no TF32 in the library's convolutions or products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, numpy=np.__version__)

    t0 = time.time()
    build.build()
    for name in build.kernel_names():
        build.load(name)
    ptxas = [ln.split(":", 1)[1].strip() for name in build.kernel_names()
             for ln in build.build_log(name).splitlines() if "registers" in ln]
    emit("build", seconds=time.time() - t0, libraries=build.kernel_names(), ptxas=ptxas)
    if args.parent:
        t0 = time.time()
        build_parent(args.parent)
        emit("build_parent", seconds=time.time() - t0, parent=args.parent, libraries=sorted(PARENT_LIBS))

    kernels = []
    with torch.no_grad():
        worst = phase_kernels(device)
        worst_gc = phase_kernels_gc(device)
        phase_kernels_nan_feats(device)
        worst_bwd = phase_kernels_bwd(device)
        worst_deform = phase_kernels_deform(device)
    worst_gc_bwd = phase_kernels_gc_bwd(device)
    phase_grad(device)
    worst_tc = phase_kernels_temporal(device)
    with torch.no_grad():
        worst_var = phase_kernels_variants(device)
        worst_stripe = phase_kernels_stripe(device)
        worst_haar = phase_kernels_haar(device)
    tc_counts = {}   # B6 launches of the main paths by (path, shrink, C, Co, backward)
    if "serve" in want:
        with torch.no_grad():
            model, counts = phase_roundtrip(device)
            kernels += phase_timing(device, model, counts, worst)
        del model
    if "quality" in want:
        phase_quality(device)
    if "train" in want:
        trainer, recompute, counts, eps = phase_train(device)
        kernels += phase_timing_train(device, trainer, recompute, counts, worst, worst_bwd, worst_stripe, eps)
        del trainer, recompute
        for (C, co), n in counts["b6"].items():
            tc_counts[("train", 1, C, co, False)] = n
    base_codec = base_train = None   # the codec's numbers without the de-artifact net
    if "codec" in want:
        codec = phase_codec(device)
        with torch.no_grad():
            rows, base_codec = phase_timing_codec(device, *codec, worst_gc)
        kernels += rows
        del codec
    if "codec_train" in want:
        tree, batch, counts = phase_codec_train(device)
        rows, base_train = phase_timing_codec_train(device, tree, batch, counts, worst_gc_bwd, worst_gc, worst_stripe)
        kernels += rows
        phase_codec_pipeline(device, tree, batch)
        del tree, batch
    if "deart" in want:
        counts_test = phase_codec_deart(device, base_codec)
        counts_train = phase_codec_deart_train(device, base_train)
        kernels += phase_timing_deform(device, counts_test, counts_train, worst_deform)
    if "subnets" in want:
        phase_subnets(device, tc_counts)
    if "haar" in want:
        haar_counts = phase_haar(device)
        irn_counts = phase_irn(device)
        # B6: the sub_mul recompute of G's conv5 at each level's training latent
        for (C, co), n in haar_counts["b6_unpacked"].items():
            tc_counts[(f"haar_train_{1 if co == 9 else 2}", 1, C, co, False)] = n
        kernels += phase_timing_haar(device, haar_counts, irn_counts, worst_haar)
        del haar_counts, irn_counts
    if tc_counts:
        kernels += phase_timing_temporal(device, tc_counts, worst_tc)
    if "variants" in want:
        serve_var, step_var = phase_variants(device)
        with torch.no_grad():
            kernels += phase_timing_variants(device, serve_var, step_var, worst_var)

    if "gan" in want:
        phase_gan(device)
        phase_aux(device)
    if "mesh" in want:
        kernels += phase_mesh(device, worst_stripe, worst_gc_bwd, worst_haar, worst_var, worst_tc, smi)
    if "procs" in want:
        phase_procs(device)

    if want & {"cli", "profile"}:
        work = Path(tempfile.mkdtemp(prefix="selfc_cli_"))
        try:
            if "cli" in want:
                phase_cli(device, work)
            if "profile" in want:
                phase_profile(device, work, smi)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if "resume_study" in want:
        phase_resume_study(device)

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
