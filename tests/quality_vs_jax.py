"""The trained checkpoint's quality through the port and through the JAX
package, both on the CPU in fp32 (JAX at matmul precision ``highest``),
clip by clip on the rendered val set: the full-size oracle for the
``quality`` phase of ``chip_smoke.py``. Not a pytest file (a clip takes
~20 s through the port and ~40-60 s through JAX on 8 cores); run it by hand:

    python tests/quality_vs_jax.py [clip ...]      # default: all four

Each line: the clip, then HR PSNR / SSIM and LR PSNR / SSIM of each stack.
The two stacks draw the GMM prior's noise from their own generators, so HR
differs by the sample's spread; LR does not depend on it.
"""

import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

from selfc_tpu.config import dict_to_nonedict as jax_options  # noqa: E402
from selfc_tpu.eval.rescaling import cal_metric as jax_cal_metric  # noqa: E402
from selfc_tpu.train.rescale_model import RescaleModel as JaxRescaleModel  # noqa: E402
from selfc_tpu_torch.eval.rescaling import cal_metric  # noqa: E402
from selfc_tpu_torch.tools.make_synth_data import render_val_set  # noqa: E402
from selfc_tpu_torch.tools.precision_delta import CKPT, quality_options  # noqa: E402
from selfc_tpu_torch.train.rescale_model import RescaleModel  # noqa: E402


def main():
    which = [int(a) for a in sys.argv[1:]] or [0, 1, 2, 3]
    clips = [c for i, c in enumerate(render_val_set()) if i in which]
    opt = quality_options(CKPT, "float32", 0)
    port = RescaleModel(opt, device="cpu")
    ref = JaxRescaleModel(jax_options(dict(opt)), rng_seed=0)
    fmt = "HR {:.4f} dB / {:.6f}  LR {:.4f} dB / {:.6f}"
    with tempfile.TemporaryDirectory() as out:
        for i, clip in zip(which, clips):
            got = cal_metric([clip], port, out, save_images=False)
            want = jax_cal_metric([clip], ref, out, save_images=False)
            print(f"clip {i}  port {fmt.format(*got)}  jax {fmt.format(*want)}", flush=True)


if __name__ == "__main__":
    main()
