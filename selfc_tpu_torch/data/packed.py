"""The packed video dataset: the JAX package's ``data/packed.py``.

``data.u8`` holds every frame as raw uint8 RGB HWC, clip-contiguous;
``index.json`` the clips (name, frame count, H, W, byte offset). A frame
read is a slice of a memory map: no decode, no cv2.

* ``write_packed`` writes the pair from frames already in memory (uint8
  RGB), ``pack_lqgtvid`` from an LQGTVID PNG tree (cv2 decodes it); both
  write the same bytes for the same frames.
* ``LQGTVIDPackedDataset`` mirrors ``LQGTVIDDataset`` (temporal sampling,
  one shared (crop, flip, rot) augmentation a clip, float32 RGB out) over
  the map. ``output_uint8: true`` keeps the host path in uint8 (crop, flip
  and rot are numpy views, the collate's stack the one copy) and the
  ``/255`` cast happens on the device (``parallel/dist.py:frames_to_device``).
  Only the resize paths (a frame smaller than GT_size, ``use_multi_scale``)
  need cv2.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from . import util
from .datasets import LQGTVIDDataset

INDEX_NAME = "index.json"
DATA_NAME = "data.u8"


def write_packed(out_dir: str, clips, verbose: bool = False) -> dict:
    """Write ``out_dir/data.u8`` + ``out_dir/index.json`` from ``clips``,
    an iterable of ``(name, frames)`` with ``frames`` an iterable of
    (H, W, 3) uint8 RGB arrays of one size. Returns the index dict."""
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    offset = 0
    with open(os.path.join(out_dir, DATA_NAME), "wb") as f:
        for name, frames in clips:
            h = w = None
            n = 0
            for rgb in frames:
                rgb = np.ascontiguousarray(rgb, np.uint8)
                if rgb.ndim != 3 or rgb.shape[2] != 3:
                    raise ValueError(f"clip {name!r}: a frame is {rgb.shape}, expected (H, W, 3)")
                if h is None:
                    h, w = rgb.shape[:2]
                elif rgb.shape[:2] != (h, w):
                    raise ValueError(f"clip {name!r}: frame {n + 1} is {rgb.shape[:2]}, expected "
                                     f"{(h, w)}: packed clips must be constant-resolution")
                f.write(rgb.tobytes())
                n += 1
            entries.append({"name": name, "n_frames": n, "h": h, "w": w, "offset": offset})
            offset += n * h * w * 3
            if verbose:
                print(f"packed {name}: {n} frames {h}x{w}")
    index = {"format": "selfc_tpu_packed_v1", "layout": "THWC-RGB-uint8",
             "clips": entries, "total_bytes": offset}
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump(index, f)
    return index


def pack_lqgtvid(dataroot: str, data_list: str, out_dir: str, verbose: bool = False) -> dict:
    """Decode an LQGTVID PNG tree once into ``out_dir`` (``write_packed``).
    Needs cv2."""
    cv2 = util.require_cv2("packing a PNG tree")

    def frames_of(paths):
        for p in paths:
            bgr = cv2.imread(p, cv2.IMREAD_COLOR)
            if bgr is None:
                raise FileNotFoundError(p)
            yield bgr[:, :, ::-1]

    paths = util.get_vid_paths(dataroot, data_list)
    return write_packed(out_dir, ((os.path.basename(os.path.dirname(fr[0])), frames_of(fr))
                                  for fr in paths), verbose)


class LQGTVIDPackedDataset(LQGTVIDDataset):
    """``LQGTVIDDataset`` over a packed map instead of a PNG tree.
    ``dataroot_GT`` is the packed directory; every other LQGTVID option
    behaves the same. The map is opened lazily in each process and dropped
    when the dataset is pickled, so it crosses into spawned loader workers
    cleanly. ``output_uint8`` needs every clip >= GT_size (no resize in
    uint8)."""

    def __init__(self, opt):
        self.opt = opt
        self.is_train = opt["phase"] == "train"
        root = opt["dataroot_GT"]
        with open(os.path.join(root, INDEX_NAME)) as f:
            self._index = json.load(f)
        self._data_path = os.path.join(root, DATA_NAME)
        clips = sorted(self._index["clips"], key=lambda c: c["name"])
        if not self.is_train and opt["sample_num"] and opt["sample_num"] > 0:
            clips = clips[: opt["sample_num"]]
        self._clips = clips
        # frame "paths" are (clip_idx, frame_idx) tokens so the base
        # class's temporal sampling rules apply unchanged
        self.paths_GT = [[(ci, t) for t in range(c["n_frames"])] for ci, c in enumerate(clips)]
        self.video_len = opt["video_len"]
        self.rng = random.Random()
        self.epoch = 0
        self._mm = None
        self._u8_out = bool(opt["output_uint8"])
        if self._u8_out and self.is_train:
            gt = opt["GT_size"] or 0
            small = [c["name"] for c in clips if c["h"] < gt or c["w"] < gt]
            if small:
                raise ValueError("output_uint8 needs every clip >= GT_size (the uint8 "
                                 f"path has no resize); too small: {small[:5]}")

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_mm"] = None
        return state

    def _frame_u8(self, token):
        """One (H, W, 3) uint8 RGB view into the map: no decode, no copy."""
        if self._mm is None:
            self._mm = np.memmap(self._data_path, dtype=np.uint8, mode="r")
        ci, t = token
        c = self._clips[ci]
        h, w = c["h"], c["w"]
        start = c["offset"] + t * h * w * 3
        return self._mm[start : start + h * w * 3].reshape(h, w, 3)

    def _frame_name(self, token):
        ci, t = token
        return f"{self._clips[ci]['name']}/im{t + 1}.png"

    def _resize(self, u8, size, why):
        cv2 = util.require_cv2(f"dataset mode 'LQGTVID_packed' with {why}")
        return cv2.resize(u8.astype(np.float32) / 255.0, size, interpolation=cv2.INTER_LINEAR)

    def _read_frame(self, token, aug, gt_size):
        u8 = self._frame_u8(token)
        H, W, _ = u8.shape
        if self._u8_out and self.is_train:
            crop = u8[aug["rnd_h"] : aug["rnd_h"] + gt_size, aug["rnd_w"] : aug["rnd_w"] + gt_size]
            # views only; the collate stack is the single copy
            return util.augment(crop, aug["hflip"], aug["vflip"], aug["rot90"])
        if self.is_train:
            if H < gt_size or W < gt_size:
                # the PNG route's float resize
                img = self._resize(u8, (gt_size, gt_size), "frames smaller than GT_size")
            else:
                # crop on uint8 (copies only the crop's bytes off the map)
                img = u8[aug["rnd_h"] : aug["rnd_h"] + gt_size,
                         aug["rnd_w"] : aug["rnd_w"] + gt_size].astype(np.float32) / 255.0
            img = util.augment(img, aug["hflip"], aug["vflip"], aug["rot90"])
        elif self.opt["use_multi_scale"]:
            img = self._resize(u8, (W // 2, H // 2), "use_multi_scale")
        elif self._u8_out:
            return u8
        else:
            img = u8.astype(np.float32) / 255.0
        return np.ascontiguousarray(img)

    def __getitem__(self, index):
        frames = self.paths_GT[index % len(self.paths_GT)]
        gt_size = self.opt["GT_size"]
        rng = self._item_rng(index)
        sel = self._select_frames(frames, rng)
        if self.is_train:
            c = self._clips[sel[0][0]]
            aug = self._gen_aug(c["h"], c["w"], gt_size, rng)
        else:
            aug = None
        clip = np.stack([self._read_frame(t, aug, gt_size) for t in sel], axis=0)
        name = self._frame_name(frames[0])
        return {"GT": clip, "LQ_path": name, "GT_path": name}
