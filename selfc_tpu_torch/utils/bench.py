"""Measuring helpers for the GPU: CUDA-event timing, seeded dense-chain
inputs at the serving, training and codec shapes, and the cost models of the
dense chain's kernels (operations and bytes from shapes, at the chain's true
growth width) with the card's published peaks, for a roofline bound."""

from __future__ import annotations

import statistics

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense rates
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES_PER_S = 3.35e12

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


def chain_cost(B, T, H, W, C, c_out, n_aux, itemsize, gc=32):
    """(operations, bytes) one dense-chain call needs. Operations: two for
    each multiply-add whose tap falls inside the clip; the taps that meet
    the zero padding are not counted: (3H-2)(3W-2) of 9HW for the four
    spatial convs, 3T-2 of 3T for conv5. Bytes: x, the parameters and the
    epilogue operands read once, the output written once."""
    px = B * T * H * W
    inside_t = (3 * T - 2) / (3 * T)
    conv5 = px * 3 * (C + 4 * gc) * c_out * inside_t
    ops = 2.0 * (_spatial_macs(B, T, H, W, C, gc) + conv5)
    n_params = (sum(9 * (C + gc * k) * gc + gc for k in range(4))
                + 3 * (C + 4 * gc) * c_out + c_out)
    nbytes = itemsize * (px * (C + (1 + n_aux) * c_out) + n_params)
    return ops, float(nbytes)


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


def bound_ms(ops, nbytes, dtype=torch.float32):
    """(bound_ms, 'operations' | 'bytes'): the least time the card could
    take for this work."""
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def chain_bound_ms(B, T, H, W, C, c_out, n_aux, dtype=torch.float32, gc=32):
    """The bound at the chain's true growth width: the kernels' pad lanes
    are work the function does not need."""
    return bound_ms(*chain_cost(B, T, H, W, C, c_out, n_aux, _itemsize(dtype), gc), dtype)


def chain_feats_bound_ms(B, T, H, W, C, dtype=torch.float32, gc=32):
    """Also the bound of the v1 spatial chain's forward (gc 32)."""
    return bound_ms(*chain_feats_cost(B, T, H, W, C, _itemsize(dtype), gc), dtype)


def chain_bwd_bound_ms(B, T, H, W, C, dtype=torch.float32, gc=32, dx_in=True):
    """``dx_in=False``: the v1 spatial chain's backward."""
    return bound_ms(*chain_bwd_cost(B, T, H, W, C, _itemsize(dtype), gc, dx_in), dtype)
