"""The plain reference of the codec eval's streaming roundtrip: the clip in
segments of ``seg_len`` frames, each segment's HR encoded as ``split_w``
slices of its width (the configuration's ``val.divide_width_num``), the 255-level LR through the host codec (the frozen
zlib copy, frames in stream order), each segment's decoded LR decoded as
``split_h x split_w`` tiles. Every tile is computed on its own: the zero
padding of the convolutions meets its edges, as in the eval it stands
for. Videos are ``(T, H, W, 3)`` tensors; a clip's length must be a
multiple of ``seg_len``."""

from __future__ import annotations

import torch

from . import zlib_codec
from .selfc_plain import quantize


def _segments(T, seg_len):
    if T % seg_len:
        raise ValueError(f"{T} frames: not a whole number of {seg_len}-frame segments")
    return [slice(s, s + seg_len) for s in range(0, T, seg_len)]


def encode_lr(net, video, seg_len, split_w):
    """The LR before its rounding, ``(T, H/k, W/k, 3)``."""
    T, H, W, _ = video.shape
    k, wd = net.k, W // split_w
    out = video.new_empty((T, H // k, W // k, 3))
    for seg in _segments(T, seg_len):
        for i in range(split_w):
            y = net.encode(video[seg, :, i * wd:(i + 1) * wd][None])[0]
            out[seg, :, i * wd // k:(i + 1) * wd // k] = y[..., :3]
    return out


def decode_hr(net, lr, seg_len, split_h, split_w):
    """The HR ``(T, H, W, 3)`` of the LR ``(T, h, w, 3)``, tile by tile."""
    T, h, w, _ = lr.shape
    k, hd, wd = net.k, h // split_h, w // split_w
    out = lr.new_empty((T, h * k, w * k, 3))
    for seg in _segments(T, seg_len):
        for i in range(split_h):
            for j in range(split_w):
                tile = lr[seg, i * hd:(i + 1) * hd, j * wd:(j + 1) * wd][None]
                out[seg, i * hd * k:(i + 1) * hd * k, j * wd * k:(j + 1) * wd * k] = net.decode(tile)[0]
    return out


def roundtrip(net, video, cfg):
    """The whole eval of one clip under the configuration ``cfg`` (its
    ``val`` tiling, its ``network_G.h265_q`` and ``h265_keyint``):
    ``(decoded LR, HR, bpp)``."""
    ev, codec = cfg["val"], cfg["network_G"]
    lr = quantize(encode_lr(net, video, ev["seg_len"], ev["divide_width_num"]))
    lr_dec, bpp = zlib_codec.roundtrip(lr.cpu().numpy(), codec["h265_q"], codec["h265_keyint"], net.k)
    lr_dec = torch.from_numpy(lr_dec).to(video.device)
    return lr_dec, decode_hr(net, lr_dec, ev["seg_len"], ev["divide_height_num"], ev["divide_width_num"]), bpp
