"""Measuring helpers for the GPU: CUDA-event timing, seeded dense-chain and
deformable-conv inputs at the serving, training and codec shapes, and the
cost models of the kernels (operations and bytes from shapes, at the chain's
true growth width; the chain variants B8 and B9 compute B1's function and take
its bound, B7 two chains and the combine) with the card's published peaks, for a roofline bound.

A W-packed call (``ops/dense_chain.py``: P images side by side along W under
``stripe_w``) does the work of the unpacked call on the same images: its cost
is the unpacked shape's, ``(B, T, H, W)`` with W the stripe, whatever columns
the kernels' tiles pad to. The taps a stripe mask drops are the taps the
unpacked call's zero padding drops, so the ``(3H-2)(3W-2)`` count below holds
per image either way."""

from __future__ import annotations

import statistics

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense rates: fp32 outside the tensor cores
# (FMA), bf16 and TF32 on them
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12
# an fp32 product as three TF32 products (the 3xTF32 split of csrc/tc_mma.cuh:
# B6 and B8): the tensor cores' TF32 rate over 3
PEAK_3XTF32 = PEAK_TF32 / 3
PEAK_BYTES_PER_S = 3.35e12


def tc_peak(dtype):
    """The peak of the tensor-core kernels (B1, B3, B6, B8, B9) for
    ``dtype``: 3xTF32 for fp32, bf16's rate for bf16."""
    return PEAK_3XTF32 if dtype == torch.float32 else PEAK_FLOPS[dtype]

# every (C, c_out) the SelfC_GMM 4x net launches: coupling H/G, coupling F,
# the prior's body, the prior's head
PATH_WIDTHS = ((3, 48), (48, 3), (64, 64), (3, 64))
CLIP_HW = (576, 704)                                     # the Vid4 frame size
SERVE_SHAPE = (1, 7, CLIP_HW[0] // 4, CLIP_HW[1] // 4)   # one GOP of its latent
# the latent of one batch of the published training config: 8 clips of 7
# frames, 144 x 144 crops
TRAIN_SHAPE = (8, 7, 36, 36)

# the SelfC_GMM_Codec eval at the UVG frame size 1080 x 1920 (scale 2, Seg_Len
# 3, val.seg_batch 4 with batch_tiles): one encode call takes 4 segments x 2
# width halves of the HR clip, (8,3,1080,960), latent (8,3,540,480); one
# decode call takes 4 segments x 2x2 tiles of the 540 x 960 LR, (16,3,270,480)
UVG_HW = (1080, 1920)
CODEC_ENC_SHAPE = (8, 3, 540, 480)
CODEC_DEC_SHAPE = (16, 3, 270, 480)
# (C, c_out, gc) of the codec's chains: coupling F, H/G (12 = 3 * 2^2 HF
# channels); the prior's head and body (hidden 24, gc 12)
CODEC_WIDTHS = ((12, 3, 32), (3, 12, 32), (3, 24, 12), (24, 24, 12))
# the codec's training batch (selfc_tpu/configs/train/train_compression.yml:
# 12 clips of 3 frames, 144 x 144 crops) and its latent at scale 2
CODEC_TRAIN_SHAPE = (12, 3, 144, 144, 3)
CODEC_TRAIN_LAT = (12, 3, 72, 72)
# the input widths of the surrogate's four DenseBlock2D chains (growth 32):
# net_0 takes the LR and its indicator plane, net_1, net_4 and net_5 the
# hidden 24
SURROGATE_C = (4, 24)
# the codec's de-artifact net (network_G.deart_net) runs its deformable conv
# on one frame of each of the call's B clips, 32 -> 32 channels, 9 times a
# decode call (3 output frames x 3 offset pairs): (N,H,W) of one such call in
# an eval decode call (16 tiles of 270 x 480) and in a training step's decode
# (12 clips at the 72 x 72 latent)
DEART_DEC_SHAPE = (16, 270, 480)
DEART_TRAIN_SHAPE = (12, 72, 72)
DEART_C = 32
# the STP prior's deformable aggregation at the serving latent, hidden 64
STP_DEFORM_SHAPE = (1, 144, 176)
STP_DEFORM_C = 64


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> dict:
    """Milliseconds of ``fn()`` on the current CUDA stream: ``iters`` calls
    after ``warmup`` calls, each between its own pair of events. Returns
    their ``median``, ``min`` and ``mean``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    ms = [t0.elapsed_time(t1) for t0, t1 in pairs]
    return {"median": statistics.median(ms), "min": min(ms),
            "mean": statistics.fmean(ms)}


def make_chain(rng, C, c_out, shape, device, dtype=torch.float32, gc=32):
    """Seeded chain parameters, input and epilogue operands for a
    ``shape = (B,T,H,W)`` clip at growth width ``gc``: every conv non-zero,
    fan-in scaled so activations stay of order one. Returns
    (x, ws, bs, w5, b5, a, m)."""
    def mk(s, std=1.0):
        t = torch.from_numpy(rng.normal(0, std, s).astype(np.float32))
        return t.to(device=device, dtype=dtype)

    ws = [mk((3, 3, C + gc * k, gc), (9 * (C + gc * k)) ** -0.5) for k in range(4)]
    bs = [mk((gc,), 0.1) for _ in range(4)]
    w5 = mk((3, C + 4 * gc, c_out), (3 * (C + 4 * gc)) ** -0.5)
    b5 = mk((c_out,), 0.1)
    return (mk(shape + (C,)), ws, bs, w5, b5,
            mk(shape + (c_out,)), mk(shape + (c_out,)))


def make_deform(rng, shape, C, c_out, device, dtype=torch.float32, spread=7.0):
    """Seeded deformable-conv operands for ``shape = (N,H,W)``: x and the
    output gradient g standard normal, offsets uniform in +-``spread`` px
    (taps leave the frame), the mask uniform in [0, 2] (the range of
    ``2 sigmoid``), the weight fan-in scaled. Returns (x, offset, mask,
    weight, g)."""
    def mk(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    return (mk(rng.normal(0, 1, shape + (C,))), mk(rng.uniform(-spread, spread, shape + (18,))),
            mk(rng.uniform(0, 2, shape + (9,))), mk(rng.normal(0, (9 * C) ** -0.5, (3, 3, C, c_out))),
            mk(rng.normal(0, 1, shape + (c_out,))))


def deform_all_to_one(shape, target, frac=0.25):
    """Offsets ``(N,H,W,18)`` for ``shape = (N,H,W)`` under which every tap
    of every pixel samples at ``target + (frac, frac)``: each of the four
    pixels around it takes 9 N H W contributions to dx."""
    N, H, W = shape
    k = np.arange(9)
    dy = target[0] + frac - (np.arange(H)[:, None, None] + k // 3 - 1)
    dx = target[1] + frac - (np.arange(W)[None, :, None] + k % 3 - 1)
    off = np.empty((N, H, W, 18), np.float32)
    off[..., 0::2] = np.broadcast_to(dy, (H, W, 9))
    off[..., 1::2] = np.broadcast_to(dx, (H, W, 9))
    return torch.from_numpy(off)


def deform_tap_stats(offset):
    """``(corners, outside)`` of the offsets ``(N,H,W,18)`` of one
    deformable-conv call: the mean number of bilinear corners a tap finds
    inside the frame, and the share of taps with a corner outside it."""
    N, H, W, _ = offset.shape
    dev = offset.device
    k = torch.arange(9, device=dev)
    py = (torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1, 1) + (k // 3 - 1)
          + offset[..., 0::2].float())
    px = (torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W, 1) + (k % 3 - 1)
          + offset[..., 1::2].float())
    y0, x0 = torch.floor(py), torch.floor(px)
    inside = 0
    for sy in (0, 1):
        iy = (y0 + sy >= 0) & (y0 + sy <= H - 1)
        for sx in (0, 1):
            inside = inside + (iy & (x0 + sx >= 0) & (x0 + sx <= W - 1)).to(torch.int32)
    return inside.float().mean().item(), (inside < 4).float().mean().item()


def deform_cost(N, H, W, C, c_out, itemsize, corners=4.0, backward=False):
    """(contraction, sample, bytes) of one deformable-conv call: the
    operations of the products and of the rest apart. ``corners``: the mean
    number of bilinear corners a tap finds inside the frame for this call's
    offsets (the kernels skip the others). Forward, a pixel and tap: the
    contraction 2 C c_out, the sample 2 C a corner and C for the mask.
    Backward: the two contractions (dval and dW) 4 C c_out; the rest 8 per
    channel and corner (the sample for dW, the sample and its two
    derivatives for dmask and doffset, the scatter to dx) and 4 more. Bytes:
    every input read once and every output written once, at ``itemsize``."""
    px = N * H * W
    if backward:
        contraction = px * 9 * 4.0 * C * c_out
        sample = px * 9 * C * (8.0 * corners + 4.0)
        nbytes = itemsize * (px * (2 * C + 2 * 27 + c_out) + 2 * 9 * C * c_out)
    else:
        contraction = px * 9 * 2.0 * C * c_out
        sample = px * 9 * C * (2.0 * corners + 1.0)
        nbytes = itemsize * (px * (C + 27 + c_out) + 9 * C * c_out)
    return contraction, sample, float(nbytes)


def deform_bound_ms(N, H, W, C, c_out, dtype=torch.float32, corners=4.0, backward=False):
    """(bound_ms, 'operations' | 'bytes') of B5 on the tensor cores: the
    contraction at ``tc_peak(dtype)`` plus the sample at the fp32 FMA rate
    (the sample is FMA work in both dtypes), against the bytes."""
    contraction, sample, nbytes = deform_cost(N, H, W, C, c_out, _itemsize(dtype), corners, backward)
    t_ops = (contraction / tc_peak(dtype) + sample / PEAK_FLOPS[torch.float32]) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def deform_bound_fma_ms(N, H, W, C, c_out, dtype=torch.float32, corners=4.0, backward=False):
    """The bound with every operation at the FMA rate of ``dtype`` (the
    bound B5's rows gave before its products moved to the tensor cores)."""
    contraction, sample, nbytes = deform_cost(N, H, W, C, c_out, _itemsize(dtype), corners, backward)
    return bound_ms(contraction + sample, nbytes, dtype)


def chain_cost(B, T, H, W, C, c_out, n_aux, itemsize, gc=32):
    """(operations, bytes) one dense-chain call needs. Operations: two for
    each multiply-add whose tap falls inside the clip; the taps that meet
    the zero padding are not counted: (3H-2)(3W-2) of 9HW for the four
    spatial convs, 3T-2 of 3T for conv5. Bytes: x, the parameters and the
    epilogue operands read once, the output written once. A W-packed call:
    pass the unpacked shape (the masked taps are the padding's)."""
    px = B * T * H * W
    inside_t = (3 * T - 2) / (3 * T)
    conv5 = px * 3 * (C + 4 * gc) * c_out * inside_t
    ops = 2.0 * (_spatial_macs(B, T, H, W, C, gc) + conv5)
    nbytes = itemsize * (px * (C + (1 + n_aux) * c_out) + _chain_params(C, c_out, gc))
    return ops, float(nbytes)


def _chain_params(C, c_out, gc=32):
    return sum(9 * (C + gc * k) * gc + gc for k in range(4)) + 3 * (C + 4 * gc) * c_out + c_out


def hg_cost(B, T, H, W, C, c_out, itemsize, gc=32):
    """(operations, bytes) of one H/G pair call (B7): the two chains'
    products as ``chain_cost`` counts them, and the combine at 8 operations
    an output element (the sigmoid's exp, add and divide, the scale, the
    exp, the product and the sum, the subtraction or the second product).
    Bytes: x and x2 read once, both chains' parameters read once, y2 and se
    written once."""
    px = B * T * H * W
    ops = 2.0 * chain_cost(B, T, H, W, C, c_out, 0, itemsize, gc)[0] + 8.0 * px * c_out
    nbytes = itemsize * (px * (C + 3 * c_out) + 2 * _chain_params(C, c_out, gc))
    return ops, float(nbytes)


def hg_bound_ms(B, T, H, W, C, c_out, dtype=torch.float32, gc=32, peak=None):
    """``peak``: as ``bound_ms`` (B7 runs at ``tc_peak(dtype)``)."""
    return bound_ms(*hg_cost(B, T, H, W, C, c_out, _itemsize(dtype), gc), dtype, peak)


def hg_bwd_cost(B, T, H, W, C, c_out, itemsize, gc=32):
    """(operations, bytes) of the pair's gradient (``hg_adjoint``) from x,
    x2, exp(+-s) and the two output gradients: each chain's features (not
    an input: recomputed), its conv5 adjoint (the products of dfeats and
    dW5, each conv5's forward count) and its spatial adjoint
    (``chain_bwd_cost``); the combine's adjoint elementwise is left out.
    Bytes: x, x2, se and both gradients read once, both chains' parameters
    read once, dx, dx2 and both chains' parameter gradients written once."""
    px = B * T * H * W
    conv5 = px * 3 * (C + 4 * gc) * c_out * (3 * T - 2) / (3 * T)
    ops = 2.0 * (chain_feats_cost(B, T, H, W, C, itemsize, gc)[0] + 4.0 * conv5
                 + chain_bwd_cost(B, T, H, W, C, itemsize, gc)[0])
    nbytes = itemsize * (px * (2 * C + 4 * c_out) + 4 * _chain_params(C, c_out, gc))
    return ops, float(nbytes)


def hg_bwd_bound_ms(B, T, H, W, C, c_out, dtype=torch.float32, gc=32, peak=None):
    """``peak``: as ``bound_ms`` (the route's B3, B2 and products run at
    ``tc_peak(dtype)``)."""
    return bound_ms(*hg_bwd_cost(B, T, H, W, C, c_out, _itemsize(dtype), gc), dtype, peak)


def _spatial_macs(B, T, H, W, C, gc=32):
    """Multiply-adds of the four spatial convs whose tap falls inside the
    image."""
    inside_hw = (3 * H - 2) * (3 * W - 2) / (9 * H * W)
    return B * T * H * W * sum(9 * (C + gc * k) * gc for k in range(4)) * inside_hw


def chain_feats_cost(B, T, H, W, C, itemsize, gc=32):
    """(operations, bytes) of the spatial-only forward: x and the spatial
    parameters read once, the four feature slots written once."""
    n_params = sum(9 * (C + gc * k) * gc + gc for k in range(4))
    nbytes = itemsize * (B * T * H * W * (C + 4 * gc) + n_params)
    return 2.0 * _spatial_macs(B, T, H, W, C, gc), float(nbytes)


def chain_bwd_cost(B, T, H, W, C, itemsize, gc=32, dx_in=True):
    """(operations, bytes) of the chain adjoint at the true growth width.
    Operations: the data gradient and the weight gradient of a layer each
    repeat the layer's forward products, with the same taps inside the
    image. Bytes: x, the saved features and the weights read once
    (``itemsize`` each), the fp32 gradients that reach features and (with
    ``dx_in``; the v1 spatial chain has none) x read once, the fp32
    gradient of x written once, the weight and bias gradients written
    once."""
    px = B * T * H * W
    n_params = sum(9 * (C + gc * k) * gc + gc for k in range(4))
    nbytes = (itemsize * (px * (C + 4 * gc) + 2 * n_params)
              + 4 * px * (4 * gc + (2 if dx_in else 1) * C))
    return 4.0 * _spatial_macs(B, T, H, W, C, gc), float(nbytes)


def temporal_conv_cost(M, C, Co, itemsize, T=None):
    """(operations, bytes) of one (3,1,1) temporal conv over ``M = B*T*H*W``
    rows, C -> Co channels. Operations: two a multiply-add, 3C of them a row
    and output channel; with ``T`` given, the taps that meet the zero padding
    in T (2 of 3T a clip column) are not counted. Bytes: x read once, the
    output written once, the weights and bias read once, at ``itemsize``."""
    inside_t = 1.0 if T is None else (3 * T - 2) / (3 * T)
    ops = 2.0 * M * 3 * C * Co * inside_t
    nbytes = itemsize * (M * (C + Co) + 3 * C * Co + Co)
    return ops, float(nbytes)


def temporal_conv_bound_ms(M, C, Co, dtype=torch.float32, T=None, peak=None):
    """``peak``: the operations' rate (default the FMA rate of ``dtype``;
    B6 runs at ``tc_peak(dtype)``)."""
    return bound_ms(*temporal_conv_cost(M, C, Co, _itemsize(dtype), T), dtype, peak)


def make_temporal_conv(rng, shape, C, c_out, device, dtype=torch.float32):
    """Seeded temporal-conv operands for ``shape = (B,T,H,W)``: x and the
    output gradient g standard normal, the weight fan-in scaled, the bias
    N(0, 0.1). Returns (x, w, b, g)."""
    def mk(s, std=1.0):
        return torch.from_numpy(rng.normal(0, std, s).astype(np.float32)).to(device=device, dtype=dtype)

    return mk(shape + (C,)), mk((3, C, c_out), (3 * C) ** -0.5), mk((c_out,), 0.1), mk(shape + (c_out,))


def bound_ms(ops, nbytes, dtype=torch.float32, peak=None):
    """(bound_ms, 'operations' | 'bytes'): the least time the card could
    take for this work, the operations at ``peak`` FLOP/s (default the
    data sheet's rate for ``dtype``: fp32 outside the tensor cores)."""
    t_ops = ops / (peak or PEAK_FLOPS[dtype]) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def chain_bound_ms(B, T, H, W, C, c_out, n_aux, dtype=torch.float32, gc=32, peak=None):
    """The bound at the chain's true growth width: the kernels' pad lanes
    are work the function does not need. ``peak``: as ``bound_ms`` (B1, B8
    and B9 run at ``tc_peak(dtype)``)."""
    return bound_ms(*chain_cost(B, T, H, W, C, c_out, n_aux, _itemsize(dtype), gc), dtype, peak)


def chain_feats_bound_ms(B, T, H, W, C, dtype=torch.float32, gc=32, peak=None):
    """Also the bound of the v1 spatial chain's forward (gc 32). ``peak``:
    as ``bound_ms`` (B3 runs at ``tc_peak(dtype)``)."""
    return bound_ms(*chain_feats_cost(B, T, H, W, C, _itemsize(dtype), gc), dtype, peak)


def chain_bwd_bound_ms(B, T, H, W, C, dtype=torch.float32, gc=32, dx_in=True, peak=None):
    """``dx_in=False``: the v1 spatial chain's backward. ``peak``: as
    ``bound_ms`` (B2 runs at ``tc_peak(dtype)``)."""
    return bound_ms(*chain_bwd_cost(B, T, H, W, C, _itemsize(dtype), gc, dx_in), dtype, peak)
