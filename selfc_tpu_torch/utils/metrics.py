"""Image quality metrics on channels-last frames in [0, 1]. PSNR only so
far; SSIM and MS-SSIM are ROADMAP item A19."""

from __future__ import annotations

import torch


def psnr(img1, img2):
    """Per-frame PSNR. imgs: (N, H, W, C) in [0,1]; returns (N,)."""
    img1 = torch.as_tensor(img1).float()
    img2 = torch.as_tensor(img2).float()
    mse = torch.mean((img1 - img2) ** 2, dim=(-3, -2, -1))
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
