"""Host-side H.265 codec bridge (libx265 over pipes).

The compression eval runs the codec on the host, between the device's encode
and decode calls (``codec/pipeline.py``): the reference shells out to FFmpeg
through skvideo pipes (Quantization_h265_rgb_stream.py:37-162,
Quantization_video_compression.py:9-91), and so does this module. Nothing of
it runs on the GPU.

Two interchangeable real-x265 backends, tried in this order:
  * the ``ffmpeg`` CLI, when installed (the reference's invocation), or
  * ``selfc_x265``, the port's native tool (``native/selfc_x265.cpp``)
    linked against the system libavcodec/libswscale/libx265, built at first
    use into ``selfc_tpu_torch/build/``: the same conversion path (swscale
    rgb24 <-> yuv444p), the same encoder, the same Matroska container, so
    the file-size bpp accounting matches the reference's.

x265 parameter strings match the reference exactly:
  * streaming mode: ``-pix_fmt yuv444p -c:v libx265 -preset veryfast
    -tune zerolatency -x265-params crf=Q:keyint=K:no-info=1``
  * ``h265_all_default``: no preset / tune (B-frame default mode)
  (reference :72-96). bpp = file_bytes*8 / (h*w*scale^2*frames) (:128-131).

When neither exists, ``make_stream`` takes the measured-rate ``ZlibCodec``
stand-in (``codec/standin.py``); the formula-rate ``NullCodec`` needs an
explicit opt-in. Every stream carries ``bpp_source`` so a rate can be
stamped with its provenance. The environment names are the JAX package's:
``SELFC_TPU_DISABLE_X265=1`` forces the stand-in even where x265 exists,
``SELFC_TPU_STANDIN_CODEC`` (``zlib`` | ``null``) picks the stand-in.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_NATIVE_SRC = Path(__file__).resolve().parent.parent / "native"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build"


def _native_binary() -> str | None:
    """The port's selfc_x265 tool, built on first use (into a directory of
    its own, then moved into place, so concurrent first uses do not race)
    when the source, ``make`` and the libraries are there; None otherwise."""
    binpath = _BUILD_DIR / "selfc_x265"
    if binpath.exists():
        return str(binpath)
    if not (_NATIVE_SRC / "selfc_x265.cpp").exists() or shutil.which("make") is None:
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        try:
            subprocess.run(["make", "-C", str(_NATIVE_SRC), f"BIN={tmp}"],
                           capture_output=True, timeout=120, check=True)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
            return None
        os.replace(Path(tmp) / "selfc_x265", binpath)
    return str(binpath)


# the backend found on this host, resolved once a process
_BACKEND_CACHE: list = []


def codec_backend() -> str | None:
    """'ffmpeg' | 'native' | None: the real-x265 backend in use.

    ``SELFC_TPU_DISABLE_X265=1`` forces None, so that a comparison can pin
    the stand-in on both stacks even where a real backend exists."""
    if os.environ.get("SELFC_TPU_DISABLE_X265"):
        return None
    if not _BACKEND_CACHE:
        if shutil.which("ffmpeg"):
            _BACKEND_CACHE.append("ffmpeg")
        else:
            binpath = _native_binary()
            ok = False
            if binpath:
                try:
                    ok = subprocess.run([binpath, "probe"], capture_output=True,
                                        timeout=30).returncode == 0
                except (subprocess.TimeoutExpired, OSError):
                    ok = False
            _BACKEND_CACHE.append("native" if ok else None)
    return _BACKEND_CACHE[0]


def ffmpeg_available() -> bool:
    """True when a real x265 encode/decode path exists (the ffmpeg CLI or
    the native tool); the name is the JAX package's."""
    return codec_backend() is not None


def _x265_params(q, keyint) -> str:
    if keyint and keyint > 0:
        return f"crf={q}:keyint={keyint}:no-info=1"
    return f"crf={q}:no-info=1"


class H265Stream:
    """Streaming writer/reader mirroring the reference's
    Quantization_H265_Stream. The bitstream lives in a temporary directory
    of its own, removed by ``close_reader``."""

    bpp_source = "x265"

    def __init__(self, q=17, keyint=12, scale_times=2, h265_all_default=False,
                 workdir=None):
        self.q = q
        self.keyint = keyint
        self.scale_times = scale_times
        self.h265_all_default = h265_all_default
        self._own_workdir = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(prefix="selfc_h265_")
        self.video_name = os.path.join(self.workdir, "stream.mkv")
        self.video_frame_num = 0
        self._writer = None
        self._reader = None
        self.w = self.h = None

    # -- writer ---------------------------------------------------------
    def open_writer(self, w: int, h: int):
        backend = codec_backend()
        if backend is None:
            raise RuntimeError("no real x265 backend (ffmpeg CLI or selfc_x265)")
        self.w, self.h = w, h
        self.video_frame_num = 0
        if backend == "ffmpeg":
            cmd = ["ffmpeg", "-y", "-loglevel", "error",
                   "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{w}x{h}",
                   "-i", "pipe:0", "-pix_fmt", "yuv444p", "-c:v", "libx265"]
            if not self.h265_all_default:
                cmd += ["-preset", "veryfast", "-tune", "zerolatency"]
            cmd += ["-x265-params", _x265_params(self.q, self.keyint), self.video_name]
        else:
            cmd = [_native_binary(), "encode", "--size", f"{w}x{h}",
                   "--x265-params", _x265_params(self.q, self.keyint)]
            if self.h265_all_default:
                cmd += ["--all-default"]
            else:
                cmd += ["--preset", "veryfast", "--tune", "zerolatency"]
            cmd += ["-o", self.video_name]
        self._writer = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                        stderr=subprocess.DEVNULL)

    def write_multi_frames(self, frames: np.ndarray):
        """frames: (N, H, W, 3) float [0,1] RGB, rounded to uint8 as the
        reference does (:97-107)."""
        u8 = (np.clip(frames, 0.0, 1.0) * 255.0).round().astype(np.uint8)
        self._writer.stdin.write(u8.tobytes())
        self.video_frame_num += len(u8)

    def close_writer(self) -> float:
        self._writer.stdin.close()
        rc = self._writer.wait()
        if rc != 0 or not os.path.exists(self.video_name):
            raise RuntimeError(
                f"x265 encoder failed (rc={rc}) for {self.w}x{self.h}; x265 "
                "needs frames of at least 16x16: tiny-shape pipeline runs set "
                "SELFC_TPU_DISABLE_X265=1 and use a stand-in codec")
        file_size = os.path.getsize(self.video_name)
        return file_size * 8.0 / (self.h * self.w * self.scale_times ** 2 * self.video_frame_num)

    # -- reader ---------------------------------------------------------
    def open_reader(self):
        if codec_backend() == "ffmpeg":
            cmd = ["ffmpeg", "-loglevel", "error", "-i", self.video_name,
                   "-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:1"]
        else:
            cmd = [_native_binary(), "decode", "-i", self.video_name]
        self._reader = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.DEVNULL)

    def read_multi_frames(self, num: int) -> np.ndarray:
        nbytes = self.h * self.w * 3
        frames = []
        for _ in range(num):
            buf = self._reader.stdout.read(nbytes)
            if not buf or len(buf) < nbytes:
                break
            a = np.frombuffer(buf, np.uint8).reshape(self.h, self.w, 3)
            frames.append(a.astype(np.float32) / 255.0)
        if not frames:
            return np.zeros((0, self.h, self.w, 3), np.float32)
        return np.stack(frames, axis=0)

    def close_reader(self):
        if self._reader is not None:
            self._reader.stdout.close()
            self._reader.wait()
            self._reader = None
        if self._own_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)


def encode_decode_clip(frames: np.ndarray, q, keyint, scale_times,
                       h265_all_default=False):
    """One-shot clip encode + decode (the reference's train-time
    Quantization_H265, Quantization_video_compression.py:9-91).
    frames: (N,H,W,3) in [0,1]. Returns (decoded, bpp)."""
    n, h, w, _ = frames.shape
    s = H265Stream(q, keyint, scale_times, h265_all_default)
    s.open_writer(w, h)
    s.write_multi_frames(frames)
    bpp = s.close_writer()
    s.open_reader()
    out = s.read_multi_frames(n)
    s.close_reader()
    return out, bpp


class NullCodec:
    """Stand-in codec of last resort: 8-bit quantization and a content-
    INDEPENDENT formula bpp. Only on explicit opt-in (``stand_in='null'``);
    its rates are stamped ``bpp_source='formula'``."""

    bpp_source = "formula"

    def __init__(self, q=17, keyint=12, scale_times=2, h265_all_default=False,
                 workdir=None):
        self.q = q
        self.scale_times = scale_times
        self._frames = []
        self.w = self.h = None
        self.video_frame_num = 0

    def open_writer(self, w, h):
        self.w, self.h = w, h
        self._frames = []
        self.video_frame_num = 0

    def write_multi_frames(self, frames):
        u8 = (np.clip(frames, 0, 1) * 255.0).round().astype(np.uint8)
        self._frames.append(u8)
        self.video_frame_num += len(u8)

    def close_writer(self):
        # a crude rate proxy: higher q -> fewer bits
        return 8.0 / (self.scale_times ** 2) / max(1.0, self.q / 4.0)

    def open_reader(self):
        self._all = np.concatenate(self._frames, axis=0)
        self._pos = 0

    def read_multi_frames(self, num):
        out = self._all[self._pos:self._pos + num]
        self._pos += num
        return out.astype(np.float32) / 255.0

    def close_reader(self):
        pass


def _stand_in(stand_in):
    if stand_in is None:
        stand_in = os.environ.get("SELFC_TPU_STANDIN_CODEC", "zlib")
    return str(stand_in).lower()


def rate_source(stand_in: str | None = None) -> str:
    """Provenance of a bpp under the current codec resolution: 'x265' (a
    real backend), 'zlib' (the stand-in's measured bitstream) or 'formula'
    (NullCodec's content-independent number)."""
    if ffmpeg_available():
        return "x265"
    return "formula" if _stand_in(stand_in) == "null" else "zlib"


def make_stream(q, keyint, scale_times, h265_all_default=False,
                stand_in: str | None = None):
    """A real x265 stream when a backend exists; otherwise the stand-in
    (``zlib`` by default, ``null`` on request; ``stand_in`` defaults from
    ``$SELFC_TPU_STANDIN_CODEC``)."""
    if ffmpeg_available():
        return H265Stream(q, keyint, scale_times, h265_all_default)
    if _stand_in(stand_in) == "null":
        return NullCodec(q, keyint, scale_times, h265_all_default)
    from .standin import ZlibCodec

    return ZlibCodec(q, keyint, scale_times, h265_all_default)
