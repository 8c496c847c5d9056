"""The port's eval against the JAX package on the CPU: the metrics
(``rgb_to_ycbcr``, ``psnr``, ``ssim`` at 96 x 96, ``ms_ssim`` at 192 x 192,
on numpy-seeded pairs: rtol 1e-4, atol 1e-5, as the JAX package's own
metric tests), ``tensor2img``, ``cal_metric`` / ``run_eval`` driven by one
stub model that returns fixed visuals (the same four numbers within 1e-5 dB
/ 1e-6, the same log lines with their numbers within those limits, the same
frame dumps and ``meta_info.pkl``), and the synthetic val set against
``tools/make_synth_data.py`` bit for bit.

The two stacks' fp32 sums differ in order: the port's PSNR is the float64
value rounded to fp32 on these inputs, the JAX package's up to 8e-6 dB from
it, so the sixth decimal of a logged number may differ. On a 2 x 2 SSIM map
(a 12 x 12 LR) each stack's SSIM lies up to 5e-6 from float64's; the eval's
LR is 144 x 176, and the stub's 24 x 24 (a 14 x 14 map) averages enough
values for 1e-6.
"""

import importlib.util
import logging
import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch

from selfc_tpu.eval import rescaling as jeval
from selfc_tpu.utils import logger as jlogger
from selfc_tpu.utils import metrics as jm
from selfc_tpu_torch.eval import rescaling as teval
from selfc_tpu_torch.tools import make_synth_data as tsynth
from selfc_tpu_torch.utils import logger as tlogger
from selfc_tpu_torch.utils import metrics as tm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side: a thread
    pool as wide as the machine in each worker only makes them wait for
    one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(n=2, h=96, w=96, seed=0):
    """A frame and a noisy copy of it, in [0, 1]."""
    rng = np.random.default_rng(seed)
    a = rng.random((n, h, w, 3), dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name,n,h,w", [("rgb_to_ycbcr", 1, 8, 8), ("psnr", 2, 96, 96),
                                        ("ssim", 2, 96, 96), ("ssim", 1, 37, 51),
                                        ("ms_ssim", 1, 192, 192), ("ms_ssim", 1, 197, 203)])
def test_metric_matches_jax(name, n, h, w):
    """Odd sizes too: ``ms_ssim`` pads them before each pool."""
    a, b = _pair(n, h, w, seed=h)
    args = (a,) if name == "rgb_to_ycbcr" else (a, b)
    want = np.asarray(jax.jit(getattr(jm, name))(*args))
    got = getattr(tm, name)(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_tensor2img_matches_jax():
    a, _ = _pair(1, 9, 7)
    a = a[0] * 1.2 - 0.1   # values outside [0, 1] clip
    for mm in ((0, 1), (-0.1, 1.1)):
        np.testing.assert_array_equal(tlogger.tensor2img(a, mm), jlogger.tensor2img(a, mm))


class StubModel:
    """Fixed visuals from the fed clip: SR and LR the ground truth with
    seeded noise, LR_ref its 4x box downsample. The JAX and the port's
    ``cal_metric`` both drive it."""

    device = torch.device("cpu")

    def feed_data(self, data):
        self.gt = np.asarray(data["GT"], np.float32)

    def test(self):
        pass

    def get_current_visuals(self):
        gt = self.gt
        B, T, H, W, C = gt.shape
        rng = np.random.default_rng(int(gt.sum() * 1000) % 2 ** 32)
        ref = gt.reshape(B, T, H // 4, 4, W // 4, 4, C).mean(axis=(3, 5))
        sr = np.clip(gt + rng.normal(0, 0.02, gt.shape), 0, 1).astype(np.float32)
        lr = np.round(np.clip(ref + rng.normal(0, 0.01, ref.shape), 0, 1) * 255) / 255
        return {"SR": sr, "LR": lr.astype(np.float32), "LR_ref": ref.astype(np.float32), "GT": gt}


def _loader(seed, shapes):
    rng = np.random.default_rng(seed)
    return [{"GT": rng.random(s, dtype=np.float32),
             "LQ_path": [f"set/clip{seed}{j}{i}/im1.png" for i in range(s[0])]}
            for j, s in enumerate(shapes)]


def _logged(caplog, fn):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="base"):
        out = fn()
    return out, [r.getMessage() for r in caplog.records if r.name == "base"]


NUMBER = re.compile(r"\d+\.\d{6}")


def _same_lines(got, want):
    """The same lines, each number printed with six decimals and within
    1e-5 of the other's (PSNR's limit; SSIM's 1e-6 shows at the sixth
    decimal only as a last-digit step)."""
    assert [NUMBER.sub("#", g) for g in got] == [NUMBER.sub("#", w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([float(v) for v in NUMBER.findall(g)],
                                   [float(v) for v in NUMBER.findall(w)], rtol=0, atol=1.01e-5)


def test_cal_metric_and_run_eval_match_jax(tmp_path, caplog):
    """Two sets (clips of batch 1 and 2, 96 x 96 frames: LR 24 x 24),
    frames dumped: the four numbers of each set, the log lines,
    ``meta_info.pkl`` and the jpg bytes of both stacks."""
    sets = [("setA", _loader(1, [(1, 4, 96, 96, 3), (2, 2, 96, 96, 3)])), ("setB", _loader(2, [(1, 4, 96, 96, 3)]))]
    out = {}
    for tag, mod in (("jax", jeval), ("port", teval)):
        opt = {"path": {"results_root": str(tmp_path / tag)}}
        out[tag] = _logged(caplog, lambda: mod.run_eval(opt, sets, StubModel(), save_images=True))
    (want, want_log), (got, got_log) = out["jax"], out["port"]
    for key, tol in (("psnr_y", 1e-5), ("psnr_y_lr", 1e-5), ("ssim_y", 1e-6), ("ssim_y_lr", 1e-6)):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol)
    assert len(got_log) == 6
    _same_lines(got_log, want_log)
    for name, _ in sets:
        with open(tmp_path / "jax" / name / "meta_info.pkl", "rb") as f:
            meta_j = pickle.load(f)
        with open(tmp_path / "port" / name / "meta_info.pkl", "rb") as f:
            meta_t = pickle.load(f)
        rel = lambda m, tag: {os.path.relpath(k, tmp_path / tag): v for k, v in m.items()}  # noqa: E731
        meta_j, meta_t = rel(meta_j, "jax"), rel(meta_t, "port")
        assert sorted(meta_t) == sorted(meta_j)
        np.testing.assert_allclose([meta_t[k] for k in sorted(meta_t)], [meta_j[k] for k in sorted(meta_j)],
                                   rtol=0, atol=1e-5)
        jpgs = sorted(f for f in os.listdir(tmp_path / "jax" / name) if f.endswith(".jpg"))
        assert len(jpgs) == 4 * (4 + 2 * 2 if name == "setA" else 4)
        for f in jpgs:
            assert (tmp_path / "port" / name / f).read_bytes() == (tmp_path / "jax" / name / f).read_bytes()


def test_cal_metric_computes_on_the_model_device(tmp_path):
    """The metrics run on ``model.device``: a device the tensors cannot go
    to fails there, not silently on the CPU."""
    stub = StubModel()
    stub.device = torch.device("meta")
    with pytest.raises((NotImplementedError, RuntimeError)):
        teval.cal_metric(_loader(3, [(1, 1, 96, 96, 3)]), stub, str(tmp_path), save_images=False)


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_make_synth_data", os.path.join(ROOT, "tools", "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_val_set_is_the_jax_tools_frames_bit_for_bit():
    """2 clips x 3 frames x 48 x 64 at seed 7: ``render_clip``'s float
    frames, the writer's uint8 rounding and the loader's ``/ 255``, with
    one generator across the clips, as ``write_dataset`` draws them."""
    tool = _jax_tool()
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        for fj, ft in zip(tool.render_clip(rng_j, 3, 48, 64), tsynth.render_clip(rng_t, 3, 48, 64), strict=True):
            assert fj.dtype == ft.dtype and np.array_equal(fj, ft)
    rng_j = np.random.default_rng(7)
    clips = list(tsynth.render_val_set(clips=2, frames=3, h=48, w=64, seed=7))
    assert [c["LQ_path"] for c in clips] == [["clip000/im1.png"], ["clip001/im1.png"]]
    for clip in clips:
        u8 = np.stack([(fr * 255 + 0.5).astype(np.uint8) for fr in tool.render_clip(rng_j, 3, 48, 64)])
        want = u8.astype(np.float32) / 255.0
        assert clip["GT"].shape == (1, 3, 48, 64, 3) and clip["GT"].dtype == np.float32
        assert np.array_equal(clip["GT"][0], want)
