"""DVC-style UVG GOP dataset: the JAX package's ``data/uvg_dataset.py``
(reference data/UVG_dataset.py:14-103, which is broken as shipped: hard-coded
roots, undefined CalcuPSNR/ms_ssim imports). 12-frame GOPs with an
H.265-intra reference frame and its bpp from a per-sequence table,
configurable roots, channels-last output, and the I-frame PSNR / MS-SSIM on
the port's metrics (on the CPU). Reads PNGs: needs cv2.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.metrics import ms_ssim, psnr
from . import util

# bpp table for the crf=20 intra folder (reference UVG_dataset.py:64)
H265_INTRA_BPP = {
    "H265L20": [
        1.213396484375, 0.6849548339843748, 0.8600716145833333,
        0.6581201985677083, 0.6985362955729166, 0.7548777669270834,
        0.6584032389322916,
    ],
}


class UVGDataset:
    """opt keys: dataroot_GT (images root), dataroot_list (sequence list),
    ref_dir (e.g. 'H265L20'), gop (12), testfull (bool), intra_bpp
    (optional explicit list)."""

    def __init__(self, opt):
        self.opt = opt
        util.require_cv2("dataset mode 'UVG'")
        root = opt["dataroot_GT"]
        refdir = opt["ref_dir"] or "H265L20"
        gop = opt["gop"] or 12
        testfull = opt["testfull"] if opt["testfull"] is not None else True
        ibpps = opt["intra_bpp"] or H265_INTRA_BPP.get(refdir)
        if not ibpps:
            raise ValueError(f"no intra bpp table for {refdir}; set intra_bpp in the config")
        with open(opt["dataroot_list"]) as f:
            folders = [line.strip() for line in f if line.strip()]
        self.ref, self.refbpp, self.input = [], [], []
        self.gop = gop
        for ii, seq in enumerate(folders):
            seq_dir = os.path.join(root, seq)
            cnt = sum(1 for im in os.listdir(seq_dir) if im.endswith(".png"))
            framerange = cnt // gop if testfull else 1
            for i in range(framerange):
                self.ref.append(os.path.join(seq_dir, refdir, "im" + str(i * gop + 1).zfill(4) + ".png"))
                self.refbpp.append(ibpps[ii % len(ibpps)])
                self.input.append([os.path.join(seq_dir, "im" + str(i * gop + j + 1).zfill(3) + ".png")
                                   for j in range(gop)])

    def __len__(self):
        return len(self.ref)

    def __getitem__(self, index):
        ref = util.bgr2rgb(util.read_img(self.ref[index]))
        h = (ref.shape[0] // 64) * 64
        w = (ref.shape[1] // 64) * 64
        ref = np.ascontiguousarray(ref[:h, :w])
        frames = []
        ref_psnr = ref_msssim = None
        for j, path in enumerate(self.input[index]):
            img = util.bgr2rgb(util.read_img(path))[:h, :w]
            if j == 0:
                a = torch.from_numpy(np.ascontiguousarray(img))[None]
                b = torch.from_numpy(ref)[None]
                ref_psnr = float(psnr(a, b)[0])
                ref_msssim = float(ms_ssim(a, b)[0])
            else:
                frames.append(img)
        return {
            "GT": np.stack(frames, axis=0),  # (gop-1, H, W, 3)
            "ref": ref,
            "ref_bpp": self.refbpp[index],
            "ref_psnr": ref_psnr,
            "ref_msssim": ref_msssim,
            "GT_path": self.input[index][0],
            "LQ_path": self.input[index][0],
        }
