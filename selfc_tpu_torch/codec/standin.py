"""Measured-rate stand-in codec for machines without a real x265 backend.

The reference's rate numbers come from a real libx265 bitstream
(Quantization_h265_rgb_stream.py:109-135: bpp = file_bytes*8 /
(h*w*scale^2*frames)). ``ZlibCodec`` is an actual codec with that
interface: uniform requantization (the step is derived from the crf-style q
and doubles every 6 q, the law H.265's QP follows) + keyint-cadenced
temporal delta coding (an intra frame every ``keyint`` frames, a mod-256
residual otherwise) + a zlib entropy coder over the residual stream. The bpp
is the byte count of the real bitstream the decoder then reads back:
content- and q-dependent, monotone in both. It is not x265 (no motion
compensation, no transform), so its rates are upper bounds and are not
comparable with x265's.

Pure numpy and zlib, the same as the JAX package's ``codec/standin.py``:
the same frames give the same bytes, the same bpp and the same decoded
frames on both stacks.
"""

from __future__ import annotations

import zlib

import numpy as np


def q_to_step(q) -> int:
    """crf-style q -> uniform quantizer step (doubles every 6 q)."""
    return max(1, int(round(2.0 ** ((float(q) - 4.0) / 6.0))))


class ZlibCodec:
    """Streaming writer/reader with the ``H265Stream`` interface, producing
    a real entropy-coded bitstream and a measured bpp."""

    bpp_source = "zlib"

    def __init__(self, q=17, keyint=12, scale_times=2,
                 h265_all_default=False, workdir=None):
        self.q = q
        self.keyint = int(keyint) if keyint else 0
        self.scale_times = scale_times
        self.w = self.h = None
        self.video_frame_num = 0
        self._step = q_to_step(q)
        self._bitstream = b""

    # -- writer ---------------------------------------------------------
    def open_writer(self, w: int, h: int):
        self.w, self.h = w, h
        self.video_frame_num = 0
        self._comp = zlib.compressobj(6)
        self._chunks = []
        self._prev = None  # the previous RECONSTRUCTED frame (what the decoder has)

    def _quantize(self, u8: np.ndarray) -> np.ndarray:
        s = self._step
        if s == 1:
            return u8
        return np.minimum((u8 // s) * s + s // 2, np.uint8(255)).astype(np.uint8)

    def write_multi_frames(self, frames: np.ndarray):
        """frames: (N, H, W, 3) float [0,1] RGB, rounded to uint8 as the
        reference does (:97-107), then requantized and delta + entropy
        coded."""
        u8 = (np.clip(frames, 0.0, 1.0) * 255.0).round().astype(np.uint8)
        for f in u8:
            rec = self._quantize(f)
            intra = self._prev is None or (
                self.keyint > 0 and self.video_frame_num % self.keyint == 0)
            if intra:
                payload = rec
            else:
                payload = (rec.astype(np.int16) - self._prev.astype(np.int16)) % 256
            self._chunks.append(self._comp.compress(payload.astype(np.uint8).tobytes()))
            self._prev = rec
            self.video_frame_num += 1

    def close_writer(self) -> float:
        self._chunks.append(self._comp.flush())
        self._bitstream = b"".join(self._chunks)
        self._chunks = []
        return (len(self._bitstream) * 8.0
                / (self.h * self.w * self.scale_times ** 2 * self.video_frame_num))

    # -- reader ---------------------------------------------------------
    def open_reader(self):
        raw = zlib.decompress(self._bitstream)
        n = self.video_frame_num
        fsize = self.h * self.w * 3
        if len(raw) != n * fsize:
            raise RuntimeError(f"zlib stand-in: {len(raw)} bytes decoded, expected {n} x {fsize}")
        payloads = np.frombuffer(raw, np.uint8).reshape(n, self.h, self.w, 3)
        frames = np.empty_like(payloads)
        prev = None
        for i in range(n):
            intra = prev is None or (self.keyint > 0 and i % self.keyint == 0)
            if intra:
                frames[i] = payloads[i]
            else:
                frames[i] = (prev.astype(np.int16) + payloads[i].astype(np.int16)) % 256
            prev = frames[i]
        self._decoded = frames
        self._pos = 0

    def read_multi_frames(self, num: int) -> np.ndarray:
        out = self._decoded[self._pos:self._pos + num]
        self._pos += num
        return out.astype(np.float32) / 255.0

    def close_reader(self):
        pass


def zlib_encode_decode_clip(frames: np.ndarray, q, keyint, scale_times,
                            h265_all_default=False):
    """One-shot clip roundtrip (the ``ZlibCodec`` counterpart of
    ``h265.encode_decode_clip``). frames: (N,H,W,3) in [0,1]. Returns
    (decoded, measured_bpp)."""
    n, h, w, _ = frames.shape
    c = ZlibCodec(q, keyint, scale_times, h265_all_default)
    c.open_writer(w, h)
    c.write_multi_frames(frames)
    bpp = c.close_writer()
    c.open_reader()
    out = c.read_multi_frames(n)
    c.close_reader()
    return out, bpp
