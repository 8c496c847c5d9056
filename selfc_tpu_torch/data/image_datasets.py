"""Single-image datasets (host-side numpy): the JAX package's
``data/image_datasets.py``, the BasicSR-style image paths of the IRN
baseline and the GAN variants.

* ``LQDataset``        — an LQ-only folder (inference).
* ``LQGTDataset``      — paired GT (+ optional LQ) folders or lmdbs; at
  training a crop / flip / rot augmentation, with the LQ made on the fly by
  the BD downsampling when no LQ root is given.
* ``LRHRSegBGDataset`` — HR images with their segmentation maps and a pool
  of background scenes (the SFTGAN-style path): the LR made on the fly by
  the MATLAB bicubic after a random rescale.

Items are channels-last float32 RGB in [0,1]. The random draws come from
``self.rng`` (an unseeded ``random.Random``, as in the JAX package): two
datasets whose ``rng`` is seeded alike give the same items. Decoding an image
needs cv2, imported where an image is read or resized (``util.require_cv2``).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from ..ops.resize import _matlab_weights
from . import util
from .datasets import _bd_downsample_np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".JPG", ".PNG")


def _list_images(root):
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.endswith(IMG_EXTS):
                out.append(os.path.join(dirpath, f))
    if not out:
        raise FileNotFoundError(f"{root} has no images")
    return out


def _augment_crop(opt, rng, scale, lq, gt, gt_size, *more):
    """A random LQ crop of ``gt_size // scale`` and the GT crop of
    ``gt_size`` (and ``more``, each the GT's size) under it, then one shared
    flip / flip / transpose draw."""
    lq_size = gt_size // scale
    H, W, _ = lq.shape
    rh = rng.randint(0, max(0, H - lq_size))
    rw = rng.randint(0, max(0, W - lq_size))
    lq = lq[rh:rh + lq_size, rw:rw + lq_size]
    big = [t[rh * scale:rh * scale + gt_size, rw * scale:rw * scale + gt_size] for t in (gt, *more)]
    hflip = bool(opt["use_flip"]) and rng.random() < 0.5
    vflip = bool(opt["use_rot"]) and rng.random() < 0.5
    rot90 = bool(opt["use_rot"]) and rng.random() < 0.5
    return [util.augment(t, hflip, vflip, rot90) for t in (lq, *big)]


class LQDataset:
    def __init__(self, opt):
        self.opt = opt
        self.paths = _list_images(opt["dataroot_LQ"])

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        img = util.bgr2rgb(util.read_img(self.paths[i]))
        return {"LQ": np.ascontiguousarray(img), "LQ_path": self.paths[i]}


class LQGTDataset:
    """GT images (``dataroot_GT``), and LQ images (``dataroot_LQ``) or the
    GT's BD downsampling; ``data_type: lmdb`` reads both from lmdbs (keys
    and sizes from their ``meta_info.pkl``, the environments opened at the
    first read)."""

    def __init__(self, opt):
        self.opt = opt
        self.is_train = opt["phase"] == "train"
        self.is_lmdb = opt["data_type"] == "lmdb"
        self.paths_LQ = self.sizes_GT = self.sizes_LQ = None
        if self.is_lmdb:
            self.paths_GT, self.sizes_GT = util.get_paths_from_lmdb(opt["dataroot_GT"])
            if opt["dataroot_LQ"]:
                self.paths_LQ, self.sizes_LQ = util.get_paths_from_lmdb(opt["dataroot_LQ"])
            self._envs = {}
        else:
            self.paths_GT = _list_images(opt["dataroot_GT"])
            if opt["dataroot_LQ"]:
                self.paths_LQ = _list_images(opt["dataroot_LQ"])
        self.rng = random.Random()

    def __len__(self):
        return len(self.paths_GT)

    def _read(self, root_key, paths, sizes, i):
        if not self.is_lmdb:
            return util.read_img(paths[i])
        if root_key not in self._envs:
            self._envs[root_key] = util.open_lmdb(self.opt[root_key])
        size = sizes[i]
        return util.read_img_lmdb(self._envs[root_key], paths[i],
                                  [int(s) for s in size.split("_")] if isinstance(size, str) else size)

    def __getitem__(self, i):
        scale = self.opt["scale"] or 4
        gt = self._read("dataroot_GT", self.paths_GT, self.sizes_GT, i)  # BGR
        if self.paths_LQ:
            lq = self._read("dataroot_LQ", self.paths_LQ, self.sizes_LQ, i)
        else:
            lq = _bd_downsample_np(gt, scale)
        if self.is_train:
            lq, gt = _augment_crop(self.opt, self.rng, scale, lq, gt, self.opt["GT_size"] or 128)
        return {
            "GT": np.ascontiguousarray(util.bgr2rgb(gt)),
            "LQ": np.ascontiguousarray(util.bgr2rgb(lq)),
            "GT_path": self.paths_GT[i],
            "LQ_path": self.paths_LQ[i] if self.paths_LQ else self.paths_GT[i],
        }


def imresize_matlab_np(img: np.ndarray, scale: float) -> np.ndarray:
    """MATLAB bicubic resize of one (H, W, C) image on the host: the
    contribution matrices of ``ops/resize.py:imresize_matlab`` applied with
    numpy (no device involved: safe inside loader workers)."""
    H, W = img.shape[:2]
    oh, ow = int(H * scale), int(W * scale)
    y = np.einsum("oh,hwc->owc", _matlab_weights(H, oh, scale), img.astype(np.float32))
    return np.einsum("pw,owc->opc", _matlab_weights(W, ow, scale), y)


# path substring -> SFTGAN category id (1-based; 0 is the background)
_SEG_CATEGORIES = ("building", "plant", "mountain", "water", "sky", "grass", "animal")


class LRHRSegBGDataset:
    """HR image + 8-channel segmentation probability map + background scene
    pool.

    * every ``ratio``-th training item (a 1-in-10 draw) comes from
      ``dataroot_GT_bg`` with an all-background map;
    * the LR is made on the fly with the MATLAB bicubic, at training after a
      random rescale from {1, .9, .8, .7, .6, .5};
    * the maps lie beside the images under ``/img/ -> /bicseg/``, as
      ``.npy`` or ``.pth`` (a tensor, read with ``weights_only``); without
      either the map is all background.
    """

    def __init__(self, opt):
        self.opt = opt
        self.is_train = opt["phase"] == "train"
        self.paths_HR = _list_images(opt["dataroot_GT"])
        self.paths_LR = _list_images(opt["dataroot_LR"]) if opt["dataroot_LR"] else None
        self.paths_HR_bg = _list_images(opt["dataroot_GT_bg"]) if opt["dataroot_GT_bg"] else None
        self.random_scale_list = [1, 0.9, 0.8, 0.7, 0.6, 0.5]
        self.ratio = 10
        self.rng = random.Random()

    def __len__(self):
        return len(self.paths_HR)

    def _load_seg(self, hr_path, shape):
        base = os.path.splitext(hr_path.replace("/img/", "/bicseg/"))[0]
        if os.path.exists(base + ".npy"):
            seg = np.load(base + ".npy")
        elif os.path.exists(base + ".pth"):
            seg = torch.load(base + ".pth", map_location="cpu", weights_only=True).numpy()
        else:
            return _background(shape)
        return np.transpose(seg, (1, 2, 0)).astype(np.float32)

    def __getitem__(self, index):
        scale = self.opt["scale"] or 4
        hr_size = self.opt["HR_size"] or self.opt["GT_size"] or 128
        lr_path = None
        if self.is_train and self.paths_HR_bg and self.rng.randrange(self.ratio) == 0:
            hr_path = self.rng.choice(self.paths_HR_bg)
            img_hr = util.read_img(hr_path)
            seg, category = _background(img_hr.shape), 0
        else:
            hr_path = self.paths_HR[index]
            img_hr = util.read_img(hr_path)
            seg = self._load_seg(hr_path, img_hr.shape)
            category = next((ci + 1 for ci, name in enumerate(_SEG_CATEGORIES) if name in hr_path), 0)
        if not self.is_train:
            img_hr = util.modcrop(img_hr, 8)
            seg = seg[:img_hr.shape[0], :img_hr.shape[1]]
            category = -1

        if self.paths_LR:
            lr_path = self.paths_LR[index]
            img_lr = util.read_img(lr_path)
        else:
            if self.is_train:
                cv2 = util.require_cv2("dataset mode 'LRHR_seg_bg'")
                rs = self.rng.choice(self.random_scale_list)

                def _mod(n):
                    r = (int(n * rs) // scale) * scale
                    return hr_size if r < hr_size else r

                hs, ws = _mod(seg.shape[0]), _mod(seg.shape[1])
                img_hr = cv2.resize(img_hr, (ws, hs), interpolation=cv2.INTER_LINEAR)
                seg = cv2.resize(seg, (ws, hs), interpolation=cv2.INTER_NEAREST)
            img_lr = imresize_matlab_np(img_hr, 1.0 / scale)

        if self.is_train:
            img_lr, img_hr, seg = _augment_crop(self.opt, self.rng, scale, img_lr, img_hr, hr_size, seg)
        return {
            "LR": np.ascontiguousarray(util.bgr2rgb(img_lr)),
            "HR": np.ascontiguousarray(util.bgr2rgb(img_hr)),
            "seg": np.ascontiguousarray(seg),
            "category": category,
            "LR_path": lr_path or hr_path,
            "HR_path": hr_path,
        }


def _background(shape):
    """An all-background map (channel 0) of an image's height and width."""
    seg = np.zeros((shape[0], shape[1], 8), np.float32)
    seg[..., 0] = 1.0
    return seg
