"""The port's compression eval CLI, the counterpart of the root
``test_compression.py``::

    python -m selfc_tpu_torch.cli.test_compression -opt <test yml> [--no-images] [--device cuda|cpu]

Per clip: the streaming roundtrip through the real or stand-in H.265 codec
(``CodecModel.test``), then HR PSNR and MS-SSIM, LR PSNR / SSIM and the bpp,
in the root CLI's log formats (those of the reference's golden logs), each
line with the rate's source (``[rate: x265|zlib|formula]``). Logs go to
``results/<name>/``; frame dumps (cv2) unless ``--no-images``.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from .. import config as option
from ..codec.h265 import codec_backend, rate_source
from ..parallel.mesh import model_mesh
from ..train.codec_model import CodecModel
from ..utils.logger import save_img, setup_logger, tensor2img
from ..utils.metrics import ms_ssim, psnr, ssim
from ..utils.profile import EvalTimer
from .test_rescaling import eval_loaders, full_fp32


def _avg(v):
    return sum(v) / len(v) if v else 0.0


def _rate_line(title, vd, vbpp, idl, ibpp, source):
    return ("----Average Compression results for {}----\n\t "
            "ave_video_distor_loss: {:.6f}; ave_video_bpp: {:.6f}dB. "
            "ave_img_distor_loss: {:.6f}; ave_img_bpp: {:.6f}dB. "
            "[rate: {}]\n".format(title, vd, vbpp, idl, ibpp, source))


def _quality_line(title, p, s, plr, slr):
    return ("----Average PSNR/SSIM results for {}----\n\tpsnr: {:.6f} db; "
            "ssim: {:.6f}. LR psnr: {:.6f} db; ssim: {:.6f}.\n".format(title, p, s, plr, slr))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Compression eval with the PyTorch port.")
    parser.add_argument("-opt", type=str, required=True)
    parser.add_argument("--no-images", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    full_fp32()
    opt = option.parse(args.opt, is_train=False)
    os.makedirs(opt["path"]["results_root"] or ".", exist_ok=True)
    setup_logger("base", opt["path"]["log"], "test_" + opt["name"], level=logging.INFO,
                 screen=True, tofile=True)
    logger = logging.getLogger("base")

    src = rate_source((opt["val"] or {}).get("standin_codec"))
    if src == "x265":
        logger.info("rate source: REAL x265 (backend: %s)", codec_backend())
    elif src == "zlib":
        logger.warning("no x265 backend — using the ZlibCodec stand-in: bpp IS a measured "
                       "bitstream rate (codec/standin.py) but is an upper bound vs x265; "
                       "numbers are NOT comparable to the golden logs.")
    else:
        logger.warning("no x265 backend and val.standin_codec: null — bpp is a "
                       "content-independent FORMULA (not a measured rate) and numbers are "
                       "NOT comparable to the golden logs.")

    loaders = eval_loaders(opt, logger)
    mesh = model_mesh(args.device, opt["mesh_sp"] or 1)
    logger.info("mesh: %s", mesh)
    model = CodecModel(opt, mesh=mesh)
    dev = model.device
    timer = EvalTimer(dev)

    def frames(a):
        return torch.as_tensor(a.reshape(-1, *a.shape[2:])).to(dev)

    totals = {k: [] for k in ("psnr", "ssim", "psnr_lr", "ssim_lr",
                              "video_distor_loss", "video_bpp", "mimick_loss", "img_bpp")}
    try:
        for name, loader in loaders:
            dataset_dir = os.path.join(opt["path"]["results_root"] or ".", name)
            os.makedirs(dataset_dir, exist_ok=True)
            rs = {"psnr": [], "ssim": [], "psnr_lr": [], "ssim_lr": []}
            ms = {"video_distor_loss": [], "video_bpp": [], "mimick_loss": [], "img_bpp": []}
            for data in loader:
                model.feed_data(data)
                img_name = "_".join(str(data["GT_path"][0]).split("/")[-3:])
                timer.start()
                model.test()
                timer.tested()
                vis = model.get_current_visuals()
                met = model.get_current_metrics()
                timer.copied()
                for k in ms:
                    ms[k].append(float(met[k]))
                logger.info(
                    "{:20s} - video_distor_loss: {:.6f}; video_bpp: {:.6f} dB; "
                    "mimick_loss: {:.6f}; img_bpp: {:.6f} dB. [rate: {}]".format(
                        img_name, met["video_distor_loss"], met["video_bpp"],
                        met["mimick_loss"], met["img_bpp"], model.rate_source))
                sr, gt, lr, lrgt = vis["SR"], vis["GT"], vis["LR"], vis["LR_ref"]
                rs["psnr"] += psnr(frames(sr), frames(gt)).tolist()
                rs["ssim"] += [float(ms_ssim(frames(sr), frames(gt)).mean())]
                rs["psnr_lr"] += psnr(frames(lr), frames(lrgt)).tolist()
                rs["ssim_lr"] += ssim(frames(lr), frames(lrgt)).tolist()
                if not args.no_images:
                    for suffix, a in (("", sr), ("_GT", gt), ("_LR", lr), ("_LR_ref", lrgt)):
                        save_img(tensor2img(a[0, 0]), os.path.join(dataset_dir, img_name + suffix + ".jpg"))
            ave = {k: _avg(v) for k, v in rs.items()}
            logger.info(_quality_line(name, ave["psnr"], ave["ssim"], ave["psnr_lr"], ave["ssim_lr"]))
            mave = {k: _avg(v) for k, v in ms.items()}
            logger.info(_rate_line(name, mave["video_distor_loss"], mave["video_bpp"],
                                   mave["mimick_loss"], mave["img_bpp"], model.rate_source))
            for k, v in {**ave, **mave}.items():
                totals[k].append(v)
    finally:
        for _, loader in loaders:
            loader.close()
    t = {k: _avg(v) for k, v in totals.items()}
    logger.info(_quality_line("All dataset", t["psnr"], t["ssim"], t["psnr_lr"], t["ssim_lr"]))
    logger.info(_rate_line("All dataset", t["video_distor_loss"], t["video_bpp"],
                           t["mimick_loss"], t["img_bpp"], model.rate_source))
    logger.info(timer.line())
    return t


if __name__ == "__main__":
    main()
