"""The port's rescaling eval CLI, the counterpart of the root
``test_rescaling.py``::

    python -m selfc_tpu_torch.cli.test_rescaling -opt <test yml> [--no-images] [--device cuda|cpu]

Every dataset of the YAML through ``RescaleModel`` (``path.pretrain_model_G``
loaded) and ``eval/rescaling.py:run_eval``: HR and LR Y-PSNR / SSIM a set
and averaged, logged to ``results/<name>/test_<name>_*.log`` under the
working directory; frame dumps there unless ``--no-images`` (they need
cv2). The library's convolutions and products run in full fp32 (no TF32),
as the root CLI's ``--fp32``. A last line gives the mean seconds a clip:
``test_s`` on the host's clock (``test()`` and the copy of its visuals
back), and on the card ``gpu_test_s``, ``test()``'s device time (CUDA
events).
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from .. import config as option
from ..data import create_dataloader, create_dataset
from ..eval.rescaling import run_eval
from ..parallel.mesh import model_mesh
from ..train.rescale_model import RescaleModel
from ..utils.logger import setup_logger
from ..utils.profile import EvalTimer


def full_fp32() -> None:
    """No TF32 in the library's convolutions and matrix products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def eval_loaders(opt, logger):
    """``(name, loader)`` of every dataset of the YAML, in key order."""
    loaders = []
    for _, dataset_opt in sorted((opt["datasets"] or {}).items()):
        test_set = create_dataset(dataset_opt)
        loaders.append((dataset_opt["name"], create_dataloader(test_set, dataset_opt)))
        logger.info("Number of test images in [%s]: %d", dataset_opt["name"], len(test_set))
    return loaders


def main(argv=None):
    parser = argparse.ArgumentParser(description="Rescaling eval with the PyTorch port.")
    parser.add_argument("-opt", type=str, required=True, help="Path to options YAML file.")
    parser.add_argument("--no-images", action="store_true", help="skip frame dumps")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    full_fp32()
    opt = option.parse(args.opt, is_train=False)
    os.makedirs(opt["path"]["results_root"] or ".", exist_ok=True)
    setup_logger("base", opt["path"]["log"], "test_" + opt["name"], level=logging.INFO,
                 screen=True, tofile=True)
    logger = logging.getLogger("base")
    loaders = eval_loaders(opt, logger)
    mesh = model_mesh(args.device, opt["mesh_sp"] or 1)
    logger.info("mesh: %s", mesh)
    model = RescaleModel(opt, mesh=mesh)
    timer = EvalTimer(model.device)
    try:
        results = run_eval(opt, loaders, model, save_images=not args.no_images, timer=timer)
        logger.info(timer.line())
        return results
    finally:
        for _, loader in loaders:
            loader.close()


if __name__ == "__main__":
    main()
