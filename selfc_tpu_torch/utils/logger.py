"""Frame dumps for the eval: the JAX package's ``utils/logger.py``
``tensor2img`` and ``save_img`` (reference utils/util.py). cv2 is imported
by ``save_img`` alone, when it is called: the module loads without it."""

from __future__ import annotations

import os

import numpy as np


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
