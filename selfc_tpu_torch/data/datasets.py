"""Video clip datasets (host-side numpy): the JAX package's
``data/datasets.py``.

``LQGTVIDDataset`` mirrors the reference LQGTVID_dataset.py:13-232, the
dataset of every shipped config: per-video frame lists, one shared (crop,
flip, rot) augmentation per clip, temporal sampling rules keyed on
video_len, output clip ``GT`` as channels-last float32 RGB ``(T, H, W, 3)``.
Its random draws come from ``self.rng`` (an unseeded ``random.Random``, as
in the JAX package): two datasets whose ``rng`` is seeded alike give the
same items. ``rng_seed`` (an option of the port's alone) gives each item a
generator of its own instead, keyed by (seed, the loader's epoch, index):
the items repeat from run to run whichever loader thread or process makes
them.

Every mode here reads PNG frames, so each needs cv2: the constructor
raises an ``ImportError`` naming the mode without it.
"""

from __future__ import annotations

import math
import random

import numpy as np

from . import util


class LQGTVIDDataset:
    def __init__(self, opt):
        self.opt = opt
        self.is_train = opt["phase"] == "train"
        util.require_cv2(f"dataset mode {opt['mode'] or 'LQGTVID'!r}")
        self.paths_GT = util.get_vid_paths(opt["dataroot_GT"], opt["dataroot_list"])
        if not self.is_train and opt["sample_num"] and opt["sample_num"] > 0:
            self.paths_GT = self.paths_GT[: opt["sample_num"]]
        self.video_len = opt["video_len"]
        self.rng = random.Random()
        self.epoch = 0   # set by the loader a pass

    def __len__(self):
        return len(self.paths_GT) * epoch_ratio(self.opt, self.is_train)

    def _item_rng(self, index):
        """The generator of item ``index``'s draws: ``self.rng``, or with
        ``rng_seed`` one keyed by (seed, epoch, index)."""
        seed = self.opt["rng_seed"]
        if seed is None:
            return self.rng
        return random.Random(f"{seed}/{self.epoch}/{index}")

    # -- temporal sampling (reference :184-214) --------------------------
    def _select_frames(self, frames, rng):
        n = len(frames)
        vl = self.video_len
        if vl == 5 and n > 5 and self.is_train:
            idx = []
            lo = 0
            for k in range(5):
                hi = n - (5 - k)
                i = rng.randint(lo, hi)
                idx.append(i)
                lo = i + 1
            return [frames[i] for i in idx]
        if vl == 3 and n > 3:
            i1 = rng.randint(0, n - 3)
            i2 = rng.randint(i1 + 1, n - 2)
            i3 = rng.randint(i2 + 1, n - 1)
            return [frames[i1], frames[i2], frames[i3]]
        if vl:
            return frames[:vl]
        return frames

    def _gen_aug(self, H, W, gt_size, rng):
        return {
            "hflip": bool(self.opt["use_flip"]) and rng.random() < 0.5,
            "vflip": bool(self.opt["use_rot"]) and rng.random() < 0.5,
            "rot90": bool(self.opt["use_rot"]) and rng.random() < 0.5,
            "rnd_h": rng.randint(0, max(0, H - gt_size)),
            "rnd_w": rng.randint(0, max(0, W - gt_size)),
        }

    def _read_frame(self, path, aug, gt_size):
        import cv2

        img = util.read_img(path)  # BGR [0,1]
        if self.is_train:
            H, W, _ = img.shape
            if H < gt_size or W < gt_size:
                img = cv2.resize(img, (gt_size, gt_size), interpolation=cv2.INTER_LINEAR)
            img = img[aug["rnd_h"] : aug["rnd_h"] + gt_size, aug["rnd_w"] : aug["rnd_w"] + gt_size]
            img = util.augment(img, aug["hflip"], aug["vflip"], aug["rot90"])
        elif self.opt["use_multi_scale"]:
            # test-time 0.5x multi-scale mode (reference LQGTVID_dataset.py:135-146)
            H, W, _ = img.shape
            img = cv2.resize(img, (W // 2, H // 2), interpolation=cv2.INTER_LINEAR)
        return np.ascontiguousarray(util.bgr2rgb(img))

    def __getitem__(self, index):
        frames = self.paths_GT[index % len(self.paths_GT)]
        gt_size = self.opt["GT_size"]
        rng = self._item_rng(index)
        sel = self._select_frames(frames, rng)
        if self.is_train:
            first = util.read_img(sel[0])
            aug = self._gen_aug(first.shape[0], first.shape[1], gt_size, rng)
        else:
            aug = None
        clip = np.stack([self._read_frame(p, aug, gt_size) for p in sel], axis=0)
        return {"GT": clip, "LQ_path": frames[0], "GT_path": frames[0]}


def epoch_ratio(opt, is_train: bool) -> int:
    """``datasets.train.epoch_ratio`` inflates a training epoch so that the
    loader's producer restarts rarely (the reference's dataset_ratio=200,
    train.py:171-182, applied at the dataset): items index modulo the real
    length, and the augmentation and temporal sampling are drawn per call,
    so repeats are fresh samples. 1 outside training."""
    ratio = (opt["epoch_ratio"] or 1) if is_train else 1
    return max(1, int(ratio))


def _elastic_deform_np(img: np.ndarray, rng: np.random.Generator,
                       sigma: float = 12.0, points: int = 3) -> np.ndarray:
    """Random-grid elastic deformation of one (H, W, C) frame, the numpy /
    scipy equivalent of elasticdeform.deform_random_grid(axis=(0,1),
    sigma=12, points=3) of the reference Aug dataset
    (LQGTVID_Aug_dataset.py:115-116): a points x points displacement grid
    drawn N(0, sigma) per axis, spline-upsampled to full resolution, then
    cubic resampling of the image at the displaced coordinates."""
    from scipy.interpolate import RectBivariateSpline
    from scipy.ndimage import map_coordinates

    H, W, C = img.shape
    disp = rng.normal(0.0, sigma, (2, points, points))
    k = min(3, points - 1)
    grid = np.arange(points, dtype=np.float64)
    gy = np.linspace(0, points - 1, H)
    gx = np.linspace(0, points - 1, W)
    dy = RectBivariateSpline(grid, grid, disp[0], kx=k, ky=k)(gy, gx)
    dx = RectBivariateSpline(grid, grid, disp[1], kx=k, ky=k)(gy, gx)
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                         indexing="ij")
    coords = np.stack([yy + dy, xx + dx])
    out = np.stack([map_coordinates(img[..., c], coords, order=3, mode="reflect")
                    for c in range(C)], axis=-1)
    # cubic spline resampling overshoots at sharp edges; frames are [0,1]
    np.clip(out, 0.0, 1.0, out=out)
    return out.astype(img.dtype, copy=False)


class LQGTVIDAugDataset(LQGTVIDDataset):
    """The augmentation-heavy variant (reference LQGTVID_Aug_dataset.py):
    an optional per-clip elastic deformation (``use_elastic_deform``, a fresh
    random grid per frame from ``np_rng``); ``use_multi_scale`` draws the
    reference's random scale, which it never applies (a dead value there,
    so here too); temporal rules: test all frames, train T=5 a random
    monotone 5 of the first 7, train T=7 all frames."""

    def __init__(self, opt):
        super().__init__(opt)
        self.np_rng = np.random.default_rng(self.rng.randint(0, 2**31 - 1))

    def _select_frames(self, frames, rng):
        if not self.is_train:
            return frames
        n = len(frames)
        if self.video_len == 5 and n >= 7:
            bounds = [(0, 2), (None, 3), (None, 4), (None, 5), (None, 6)]
            idx = []
            lo = 0
            for lo_fixed, hi in bounds:
                lo = lo_fixed if lo_fixed is not None else lo
                i = rng.randint(lo, hi)
                idx.append(i)
                lo = i + 1
            return [frames[i] for i in idx]
        if self.video_len == 7:
            return frames
        return super()._select_frames(frames, rng)

    def _gen_aug(self, H, W, gt_size, rng):
        aug = super()._gen_aug(H, W, gt_size, rng)
        aug["elastic"] = bool(self.opt["use_elastic_deform"]) and rng.random() < 0.5
        if self.opt["use_multi_scale"]:
            aug["random_scale"] = rng.choice([0.6, 0.8, 1, 1.2, 1.4, 1.6, 1.8, 2])
        # the grids of a seeded item come from its own generator
        aug["np_rng"] = self.np_rng if rng is self.rng else np.random.default_rng(rng.randint(0, 2**31 - 1))
        return aug

    def _read_frame(self, path, aug, gt_size):
        img = super()._read_frame(path, aug, gt_size)
        if self.is_train and aug.get("elastic"):
            img = _elastic_deform_np(img, aug["np_rng"])
        return img


class LQGTVIDConsecutiveDataset(LQGTVIDDataset):
    """reference LQGTVID_Conseutive_dataset.py: test all frames; train T=5
    the fixed frames 1..5."""

    def _select_frames(self, frames, rng):
        if not self.is_train:
            return frames
        if self.video_len == 5 and len(frames) > 5:
            return frames[1:6]
        return super()._select_frames(frames, rng)


def _bd_downsample_np(img: np.ndarray, scale: int) -> np.ndarray:
    """Host-side DUF/BD gaussian downsample of one frame (H,W,C), the numpy
    twin of ``ops/resize.gaussian_downsample`` for loader-side LQ clips
    (reference LQGTVID_SR_dataset.py:161 + models/Guassian.py)."""
    import cv2

    sigma = 0.4 * scale
    radius = min(int(4.0 * sigma + 0.5), 6)
    w = np.zeros(13)
    for i in range(-radius, radius + 1):
        w[6 + i] = math.exp(-0.5 * (i / sigma) ** 2)
    w /= w.sum()
    k2d = np.outer(w, w).astype(np.float32)
    pad = 6 + 2 * scale
    x = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
    blurred = cv2.filter2D(x, -1, k2d, borderType=cv2.BORDER_CONSTANT)
    # sample the 13x13 correlation centres at stride `scale`
    c = 6
    y = blurred[c : x.shape[0] - c : scale, c : x.shape[1] - c : scale]
    return np.ascontiguousarray(y[2:-2, 2:-2])


class LQGTVIDSRDataset(LQGTVIDDataset):
    """Adds an on-the-fly BD-downsampled LQ clip (reference LQGTVID_SR_dataset.py)."""

    def __getitem__(self, index):
        item = super().__getitem__(index)
        scale = self.opt["scale"] or 4
        item["LQ"] = np.stack([_bd_downsample_np(f, scale) for f in item["GT"]], axis=0)
        return item


class LQGTVIDBicubicDataset(LQGTVIDDataset):
    """Adds a bicubic LQ clip (reference LQGTVID_bicubic_dataset.py)."""

    def __getitem__(self, index):
        import cv2

        item = super().__getitem__(index)
        scale = self.opt["scale"] or 4
        item["LQ"] = np.stack([
            cv2.resize(f, (f.shape[1] // scale, f.shape[0] // scale), interpolation=cv2.INTER_CUBIC)
            for f in item["GT"]], axis=0)
        return item


def pad_clip_to_length(clip: np.ndarray, t_len: int) -> np.ndarray:
    """Repeat the last frame so the clip reaches t_len
    (reference SelfC_model.feed_data, SelfC_model.py:102-109)."""
    t = clip.shape[0]
    if t >= t_len:
        return clip
    pad = np.repeat(clip[-1:], t_len - t, axis=0)
    return np.concatenate([clip, pad], axis=0)
