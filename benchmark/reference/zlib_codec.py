"""A frozen copy of the host codec the benchmark's codec cell runs through
where the machine has no x265: uniform requantisation (the step doubles
every 6 q), an intra frame every ``keyint`` frames (only the first where
``keyint`` <= 0) and mod-256 deltas otherwise, a zlib coder (level 6) over
the payloads. The bpp is the bitstream's bytes * 8 over the HR pixels of
the frames written. Numpy and zlib alone."""

from __future__ import annotations

import zlib

import numpy as np


def q_to_step(q) -> int:
    return max(1, int(round(2.0 ** ((float(q) - 4.0) / 6.0))))


def requantize(u8: np.ndarray, step: int) -> np.ndarray:
    if step == 1:
        return u8
    return np.minimum((u8 // step) * step + step // 2, 255).astype(np.uint8)


def levels_of(decoded_u8: np.ndarray, step: int):
    """``(lo, hi)``: the least and the largest 8-bit level that
    ``requantize`` maps onto each decoded level."""
    lv = np.arange(256)
    dec = requantize(lv.astype(np.uint8), step).astype(np.int64)
    lo = np.full(256, 256, np.int64)
    hi = np.full(256, -1, np.int64)
    np.minimum.at(lo, dec, lv)
    np.maximum.at(hi, dec, lv)
    return lo[decoded_u8], hi[decoded_u8]


def roundtrip(frames: np.ndarray, q, keyint, scale: int):
    """frames: (N,h,w,3) float LR in [0,1], in stream order. Returns the
    decoded frames (float32, level / 255) and the bpp."""
    step = q_to_step(q)
    keyint = int(keyint) if keyint else 0
    u8 = (np.clip(frames, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    comp = zlib.compressobj(6)
    chunks, prev, recs = [], None, []
    for i, f in enumerate(u8):
        rec = requantize(f, step)
        intra = prev is None or (keyint > 0 and i % keyint == 0)
        payload = rec if intra else (rec.astype(np.int16) - prev.astype(np.int16)) % 256
        chunks.append(comp.compress(payload.astype(np.uint8).tobytes()))
        prev = rec
        recs.append(rec)
    chunks.append(comp.flush())
    n, h, w = u8.shape[:3]
    bpp = len(b"".join(chunks)) * 8.0 / (h * w * scale ** 2 * n)
    return np.stack(recs).astype(np.float32) / 255.0, bpp
