"""Host-side data utilities (numpy; cv2 where a frame is decoded or
resized): the JAX package's ``data/util.py`` (reference data/util.py).

cv2 is imported by the functions that need it, never when the module is
imported: the packed uint8 path runs on numpy alone, and a dataset mode
that needs cv2 raises an ``ImportError`` naming the mode
(``require_cv2``). The JAX copy's decoded-frame cache is left out.
"""

from __future__ import annotations

import os

import numpy as np


def require_cv2(what: str):
    """The cv2 module, or an ``ImportError`` that names what needed it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (the cv2 module), which is not installed; "
                          "the packed uint8 dataset (mode LQGTVID_packed) runs without it") from e
    return cv2


def get_vid_paths(dataroot: str, data_list: str):
    """Per-video frame path lists: each line of ``data_list`` is a clip dir
    under ``dataroot`` holding frames im1.png..imN.png
    (reference data/util.py:59-87)."""
    videos = []
    with open(data_list) as f:
        for line in f:
            sub = line.strip()
            if not sub:
                continue
            d = os.path.join(dataroot, sub)
            n = len(os.listdir(d))
            videos.append([os.path.join(d, f"im{i}.png") for i in range(1, n + 1)])
    return sorted(videos)


def read_img(path: str) -> np.ndarray:
    """BGR float32 HWC in [0,1] (reference read_img1, data/util.py:103-115)."""
    cv2 = require_cv2("reading a PNG frame")
    u8 = cv2.imread(path, cv2.IMREAD_COLOR)
    if u8 is None:
        raise FileNotFoundError(path)
    img = u8.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img


def get_paths_from_lmdb(dataroot: str):
    """Keys + resolutions from the lmdb's meta_info.pkl
    (reference _get_paths_from_lmdb, data/util.py:34-41)."""
    import pickle

    with open(os.path.join(dataroot, "meta_info.pkl"), "rb") as f:
        meta = pickle.load(f)
    paths = meta["keys"]
    sizes = meta["resolution"]
    if len(sizes) == 1:
        sizes = sizes * len(paths)
    return paths, sizes


def open_lmdb(dataroot: str):
    """Read-only lmdb environment (the lmdb module is imported here)."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError("data_type 'lmdb' requires the lmdb module, which is not "
                          "installed in this environment; use data_type 'img'") from e
    return lmdb.open(dataroot, readonly=True, lock=False, readahead=False, meminit=False)


def read_img_lmdb(env, key: str, size) -> np.ndarray:
    """Decode one (C,H,W)-sized uint8 image blob from lmdb to BGR float32
    HWC in [0,1] (reference _read_img_lmdb, data/util.py:91-99)."""
    with env.begin(write=False) as txn:
        buf = txn.get(key.encode("ascii"))
    c, h, w = size
    img = np.frombuffer(buf, dtype=np.uint8).reshape(h, w, c)
    out = img.astype(np.float32) / 255.0
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def augment(img: np.ndarray, hflip: bool, vflip: bool, rot90: bool):
    """(H,W,C); the flips and transpose of reference data/util.py:150-165."""
    if hflip:
        img = img[:, ::-1, :]
    if vflip:
        img = img[::-1, :, :]
    if rot90:
        img = img.transpose(1, 0, 2)
    return img


def bgr2rgb(img: np.ndarray) -> np.ndarray:
    return img[:, :, [2, 1, 0]] if img.shape[2] == 3 else img


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale]
