"""The rescaling eval: the JAX package's ``eval/rescaling.py`` (reference
test_rescaling.py).

Per clip: feed -> the GOP-chunked roundtrip (``model.test()``) -> "Y
channel" PSNR / SSIM of HR and LR (as the reference, the full 3-channel
YCbCr tensor goes to the metrics), computed on the model's device; frame
dumps, a ``meta_info.pkl`` of per-frame PSNRs, and the log lines the JAX
package writes, character for character.
"""

from __future__ import annotations

import logging
import os
import pickle

import torch

from ..utils.logger import save_img, tensor2img
from ..utils.metrics import psnr, rgb_to_ycbcr, ssim

logger = logging.getLogger("base")


def _avg(lst):
    return sum(lst) / len(lst) if lst else 0


def cal_metric(val_loader, model, dataset_dir, save_images=True, timer=None):
    """The clips of ``val_loader`` (dicts with ``GT`` (B,T,H,W,3) and
    ``LQ_path``, a list of B names) through ``model``: the mean over clips
    of HR PSNR, HR SSIM, LR PSNR and LR SSIM; ``timer``, a
    ``utils/profile.py:EvalTimer``, times each clip."""
    device = getattr(model, "device", torch.device("cpu"))
    avg_psnr_y, avg_ssim_y = [], []
    avg_lr_psnr_y, avg_lr_ssim_y = [], []
    meta = {}
    for val_data in val_loader:
        model.feed_data(val_data)
        if timer:
            timer.start()
        model.test()
        if timer:
            timer.tested()
        vis = model.get_current_visuals()
        if timer:
            timer.copied()
        sr, gt = vis["SR"], vis["GT"]
        lr, lrgt = vis["LR"], vis["LR_ref"]
        B, T = sr.shape[:2]

        def frames(a):
            return torch.as_tensor(a.reshape(-1, *a.shape[2:])).to(device)

        sr_y, gt_y = rgb_to_ycbcr(frames(sr)), rgb_to_ycbcr(frames(gt))
        lr_y, lrgt_y = rgb_to_ycbcr(frames(lr)), rgb_to_ycbcr(frames(lrgt))
        b_sr_psnr = psnr(sr_y, gt_y).tolist()
        b_lr_psnr = psnr(lr_y, lrgt_y).tolist()
        avg_psnr_y.append(_avg(b_sr_psnr))
        avg_ssim_y.append(float(ssim(sr_y, gt_y).mean()))
        avg_lr_psnr_y.append(_avg(b_lr_psnr))
        avg_lr_ssim_y.append(float(ssim(lr_y, lrgt_y).mean()))

        names = val_data.get("LQ_path", ["clip"] * B)
        for b_i in range(B):
            vid = os.path.splitext("_".join(str(names[b_i]).split("/")[-3:]))[0]
            for t_i in range(T):
                fp = os.path.join(dataset_dir, f"{vid}_{t_i}th")
                if save_images:
                    save_img(tensor2img(sr[b_i, t_i]), fp + "_sr.jpg")
                    save_img(tensor2img(gt[b_i, t_i]), fp + "_gt.jpg")
                    save_img(tensor2img(lr[b_i, t_i]), fp + "_lr.jpg")
                    save_img(tensor2img(lrgt[b_i, t_i]), fp + "_lrgt.jpg")
                meta[fp] = [b_sr_psnr[b_i * T + t_i], b_lr_psnr[b_i * T + t_i]]
    os.makedirs(dataset_dir, exist_ok=True)
    with open(os.path.join(dataset_dir, "meta_info.pkl"), "wb") as f:
        pickle.dump(meta, f)
    return _avg(avg_psnr_y), _avg(avg_ssim_y), _avg(avg_lr_psnr_y), _avg(avg_lr_ssim_y)


def run_eval(opt, test_loaders, model, save_images=True, timer=None):
    """``cal_metric`` over ``(name, loader)`` pairs, each into
    ``path.results_root/name``, logged per set and averaged (``timer`` as
    ``cal_metric``'s, over every set)."""
    results = {"psnr_y": [], "ssim_y": [], "psnr_y_lr": [], "ssim_y_lr": []}
    for name, loader in test_loaders:
        dataset_dir = os.path.join(opt["path"]["results_root"] or ".", name)
        os.makedirs(dataset_dir, exist_ok=True)
        p, s, plr, slr = cal_metric(loader, model, dataset_dir, save_images, timer)
        logger.info(" HR results for {}, PSNR {:.6f}dB, SSIM {:.6f}".format(name, p, s))
        logger.info(" LR results for {}, PSNR {:.6f}dB, SSIM {:.6f}".format(name, plr, slr))
        results["psnr_y"].append(p)
        results["ssim_y"].append(s)
        results["psnr_y_lr"].append(plr)
        results["ssim_y_lr"].append(slr)
    logger.info("Averaged HR results for all datasets, PSNR {:.6f}dB, SSIM {:.6f}".format(
        _avg(results["psnr_y"]), _avg(results["ssim_y"])))
    logger.info("Averaged LR results for all datasets, PSNR {:.6f}dB, SSIM {:.6f}".format(
        _avg(results["psnr_y_lr"]), _avg(results["ssim_y_lr"])))
    return results
