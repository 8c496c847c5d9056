"""The metric cost of bf16 eval on a trained checkpoint, the port's copy of
the JAX package's ``tools/precision_delta.py``: the same clips through the
same roundtrip at fp32 and at bf16 (``val.eval_dtype``), HR and LR Y-PSNR /
SSIM (``eval/rescaling.py:cal_metric``). The clips are the synthetic val
set rendered in memory (``tools/make_synth_data.py:render_val_set``: 4
clips of 7 frames at 576 x 704, seed 7), not read from disk.

    python -m selfc_tpu_torch.tools.precision_delta [--ckpt runs/400k/latest_G.msgpack]
        [--seed 0] [--device cpu]

It prints each clip's numbers and their mean (``cal_metric``'s result) for
each dtype. Without ``--device`` it runs on the GPU and fails without one.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from ..config import dict_to_nonedict
from ..eval.rescaling import cal_metric
from ..train.rescale_model import RescaleModel
from .make_synth_data import render_val_set

CKPT = os.path.join("runs", "400k", "latest_G.msgpack")


def quality_options(ckpt: str, eval_dtype: str, seed: int):
    """The JAX tool's options: the published 4x SelfC_GMM (block_num [4, 4],
    STP-6, GMM-5) with ``ckpt``, eval at ``eval_dtype`` with
    ``val.sample_seed``."""
    return dict_to_nonedict({
        "is_train": False, "model": "SelfC_GMM", "distortion": "sr_bd", "scale": 4,
        "datasets": {"train": {"video_len": 7, "GT_size": 144}},
        "network_G": {
            "which_model_G": {"subnet_type": "D2DTNet"},
            "in_nc": 3, "out_nc": 3, "block_num": [4, 4], "scale": 4,
            "init": "xavier", "global_module": "nonlocal",
            "stp_blk_num": 6, "fh_loss": "gmm", "gmm_k": 5,
        },
        "path": {"pretrain_model_G": ckpt},
        "val": {"eval_dtype": eval_dtype, "sample_seed": seed},
    })


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    clips = list(render_val_set())
    rows = {}
    with tempfile.TemporaryDirectory() as out:
        for dt in ("float32", "bfloat16"):
            model = RescaleModel(quality_options(args.ckpt, dt, args.seed), device=args.device)
            # cal_metric's result is the mean over clips of each clip's numbers
            per_clip = [cal_metric([clip], model, out, save_images=False) for clip in clips]
            for i, (p, s, plr, slr) in enumerate(per_clip):
                print(f"{dt:9s}  clip {i}  HR {p:.4f} dB / {s:.6f}   LR {plr:.4f} dB / {slr:.6f}")
            p, s, plr, slr = rows[dt] = tuple(sum(v) / len(v) for v in zip(*per_clip))
            print(f"{dt:9s}  HR {p:.4f} dB / {s:.6f}   LR {plr:.4f} dB / {slr:.6f}")
    dp = rows["float32"][0] - rows["bfloat16"][0]
    dssim = rows["float32"][1] - rows["bfloat16"][1]
    print(f"bf16 eval cost: {dp:+.4f} dB Y-PSNR, {dssim:+.6f} SSIM "
          f"(ckpt {os.path.basename(args.ckpt)}, device {model.device})")


if __name__ == "__main__":
    main()
