"""The BPG (HEVC-intra) image codec bridge (the JAX package's
``codec/bpg.py``): each frame encoded with ``bpgenc -q q`` and decoded with
``bpgdec``, its bits per pixel measured from the file. Host-side, as the H.265
span is.

``bpg_backend()`` resolves, in this order:
  1. ``'bpg'``: the ``bpgenc`` / ``bpgdec`` binaries, when installed;
  2. ``'hevc-intra'``: each frame as its own single-frame all-intra x265
     stream (``keyint=1``) through the H.265 bridge (``codec/h265.py``: the
     ffmpeg CLI, or the port's own ``selfc_x265`` tool). BPG is HEVC's
     intra still-picture coding in a thin container, so the rate is the
     measured stream's and the distortion HEVC's intra loop;
  3. ``None``: an 8-bit quantisation stand-in with a formula rate.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np


def bpg_available() -> bool:
    return shutil.which("bpgenc") is not None and shutil.which("bpgdec") is not None


def bpg_backend() -> str | None:
    """'bpg' | 'hevc-intra' | None (the stand-in)."""
    if bpg_available():
        return "bpg"
    from .h265 import codec_backend

    if codec_backend() is not None:
        return "hevc-intra"
    return None


def _roundtrip_bpgenc(frames: np.ndarray, q: int):
    from PIL import Image

    n, h, w, _ = frames.shape
    total_bits = 0
    outs = []
    with tempfile.TemporaryDirectory(prefix="selfc_bpg_") as d:
        for i in range(n):
            png = os.path.join(d, f"f{i}.png")
            bpg = os.path.join(d, f"f{i}.bpg")
            out = os.path.join(d, f"f{i}_dec.png")
            u8 = (np.clip(frames[i], 0, 1) * 255.0).round().astype(np.uint8)
            Image.fromarray(u8).save(png)
            subprocess.run(["bpgenc", "-q", str(q), "-o", bpg, png], check=True)
            total_bits += os.path.getsize(bpg) * 8
            subprocess.run(["bpgdec", "-o", out, bpg], check=True)
            outs.append(np.asarray(Image.open(out), np.float32)[..., :3] / 255.0)
    return np.stack(outs, axis=0), total_bits / (n * h * w)


def _roundtrip_hevc_intra(frames: np.ndarray, q: int):
    """Each frame as its own single-frame all-intra x265 stream; the rate
    from the stream's file size."""
    from .h265 import H265Stream

    n, h, w, _ = frames.shape
    total_bits = 0
    outs = []
    for i in range(n):
        s = H265Stream(q=q, keyint=1, scale_times=1, h265_all_default=False)
        try:
            s.open_writer(w, h)
            s.write_multi_frames(frames[i:i + 1])
            s.close_writer()
            total_bits += os.path.getsize(s.video_name) * 8
            s.open_reader()
            dec = s.read_multi_frames(1)
            s.close_reader()
        finally:
            shutil.rmtree(s.workdir, ignore_errors=True)
        outs.append(np.asarray(dec[0], np.float32))
    return np.stack(outs, axis=0), total_bits / (n * h * w)


def bpg_roundtrip(frames: np.ndarray, q: int = 29):
    """frames (N,H,W,3) float in [0,1] -> (decoded, bits per coded pixel).
    The caller scales the rate to HR pixels (the reference divides by
    h * w * scale^2)."""
    backend = bpg_backend()
    if backend == "bpg":
        return _roundtrip_bpgenc(frames, q)
    if backend == "hevc-intra":
        return _roundtrip_hevc_intra(frames, q)
    dec = (np.clip(frames, 0, 1) * 255.0).round() / 255.0
    return dec.astype(np.float32), 8.0 / max(1.0, q / 4.0)
