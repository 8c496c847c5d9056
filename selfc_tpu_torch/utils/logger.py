"""Logging and frame dumps: the JAX package's ``utils/logger.py``
``setup_logger``, ``tensor2img``, ``save_img``, ``ProgressBar`` and
``tensor2heatmap`` (reference utils/util.py). cv2 is imported by
``save_img`` and ``tensor2heatmap`` alone, when they are called: the module
loads without it."""

from __future__ import annotations

import logging
import os
import sys
import time
from datetime import datetime

import numpy as np


def setup_logger(name, root, phase, level=logging.INFO, screen=False, tofile=False):
    """The logger ``name`` with the JAX format (``%y-%m-%d %H:%M:%S.mmm -
    LEVEL: message``), to ``{root}/{phase}_{yymmdd-HHMMSS}.log`` with
    ``tofile`` and to stderr with ``screen``. Earlier handlers are
    replaced."""
    lg = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                            datefmt="%y-%m-%d %H:%M:%S")
    lg.setLevel(level)
    for h in lg.handlers:
        h.close()
    lg.handlers = []
    if tofile:
        os.makedirs(root, exist_ok=True)
        stamp = datetime.now().strftime("%y%m%d-%H%M%S")
        fh = logging.FileHandler(os.path.join(root, f"{phase}_{stamp}.log"), mode="w")
        fh.setFormatter(fmt)
        lg.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        lg.addHandler(sh)
    return lg


def tensor2img(img, min_max=(0, 1)):
    """(H, W, 3) float RGB in [0,1] -> uint8 BGR for cv2."""
    a = np.asarray(img, np.float32)
    a = np.clip((a - min_max[0]) / (min_max[1] - min_max[0]), 0, 1)
    a = (a * 255.0).round().astype(np.uint8)
    if a.ndim == 3 and a.shape[2] == 3:
        a = a[:, :, ::-1]  # RGB -> BGR
    return a


def save_img(img_bgr_u8, path):
    """Write a uint8 BGR frame (raises ImportError without cv2)."""
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, img_bgr_u8)


class ProgressBar:
    """Terminal progress reporter (reference utils/util.py:278-325), to
    stdout: a bar with the rate and ETA when ``task_num`` is known, else a
    count."""

    def __init__(self, task_num: int = 0, bar_width: int = 40, start=True):
        self.task_num = task_num
        self.bar_width = bar_width
        self.completed = 0
        if start:
            self.start()

    def start(self):
        if self.task_num > 0:
            sys.stdout.write(f"[{' ' * self.bar_width}] 0/{self.task_num}, elapsed: 0s\n")
        sys.stdout.flush()
        self.start_time = time.time()

    def update(self, msg: str = "In progress..."):
        self.completed += 1
        elapsed = max(time.time() - self.start_time, 1e-9)
        fps = self.completed / elapsed
        if self.task_num > 0:
            pct = self.completed / float(self.task_num)
            eta = int(elapsed * (1 - pct) / max(pct, 1e-9) + 0.5)
            marks = int(self.bar_width * pct)
            bar = ">" * marks + "-" * (self.bar_width - marks)
            sys.stdout.write(f"\r[{bar}] {self.completed}/{self.task_num}, {fps:.1f} task/s, "
                             f"elapsed: {int(elapsed + .5)}s, ETA: {eta:5d}s  {msg}")
        else:
            sys.stdout.write(f"\rcompleted: {self.completed}, elapsed: {int(elapsed + .5)}s, {fps:.1f} tasks/s")
        sys.stdout.flush()


def tensor2heatmap(x, min_max=None):
    """A single-channel map (H, W) (or (H, W, C), averaged over C) -> BGR
    uint8 jet heatmap through cv2 (raises ImportError without it); scaled
    to [0, 1] by its own range unless ``min_max`` is given."""
    import cv2

    a = np.asarray(x, np.float32)
    if a.ndim == 3:
        a = a.mean(axis=-1)
    lo, hi = (float(a.min()), float(a.max())) if min_max is None else min_max
    a = (a - lo) / max(hi - lo, 1e-12)
    u8 = (np.clip(a, 0, 1) * 255).astype(np.uint8)
    return cv2.applyColorMap(u8, cv2.COLORMAP_JET)
