"""Logging and frame dumps: the JAX package's ``utils/logger.py``
``setup_logger``, ``tensor2img`` and ``save_img`` (reference utils/util.py).
cv2 is imported by ``save_img`` alone, when it is called: the module loads
without it."""

from __future__ import annotations

import logging
import os
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
