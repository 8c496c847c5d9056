"""Where a dense-chain call spends its time: staging or arithmetic.

The machine with the GPU has no kernel profiler, so this script builds
variants of ``csrc/dense_chain.cu`` by text substitution — the spatial
layers' staging switched off after the first slab (``nostage``), or their
FMA loop switched off (``nocompute``) — and times each at the serving
shapes beside the unchanged source (``base``). The variants compute wrong
values on purpose; only their times mean anything. conv5 is unchanged in
all three.

Run from the repo root on a machine with an NVIDIA Hopper GPU:

    python3 -m selfc_tpu_torch.tools.chain_attribution
"""

from __future__ import annotations

import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from selfc_tpu_torch.kernels import build
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.utils.bench import PATH_WIDTHS, SERVE_SHAPE, make_chain, time_cuda

STAGE_IN = "      if (vec) {  //"
STAGE_W = "      for (int idx = tid; idx < 9 * KC * (GCP / 4); idx += NT) {"
COMPUTE = ("      for (int dy = 0; dy < 3; ++dy) {\n"
           "        for (int c4 = 0; c4 < kc4; ++c4) {\n          float in[10][4];")


def variants(src: str) -> dict[str, str]:
    for pattern in (STAGE_IN, STAGE_W, COMPUTE):
        if src.count(pattern) != 1:
            raise SystemExit(f"the source no longer holds exactly one {pattern!r}")
    first_slab = "      if (c0 == 0 && src == 0)\n"
    return {
        "base": src,
        "nostage": src.replace(
            STAGE_IN, "      if (c0 != 0 || src != 0) {} else if (vec) {  //"
        ).replace(STAGE_W, first_slab + STAGE_W),
        "nocompute": src.replace(COMPUTE, "      if (H < 0)\n" + COMPUTE),
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    src = (build.CSRC_DIR / "dense_chain.cu").read_text()
    nvcc = build.find_nvcc()
    with tempfile.TemporaryDirectory(dir=build.PKG_DIR) as tmp, torch.no_grad():
        procs = {}
        for name, text in variants(src).items():
            cu = Path(tmp) / f"{name}.cu"
            cu.write_text(text)
            procs[name] = subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed for {name}:\n{log}")
        rng = np.random.default_rng(0)
        try:
            for C, c_out in PATH_WIDTHS:
                x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, SERVE_SHAPE, torch.device("cuda"))
                for name in procs:
                    build.use_library("dense_chain", Path(tmp) / f"{name}.so")
                    ms = time_cuda(lambda: dc.dense_chain_t_ep(x, ws, bs, w5, b5, "mul_add", 1.0, a, m))
                    print(json.dumps({"C": C, "c_out": c_out, "variant": name,
                                      "ms": ms["median"], "ms_min": ms["min"]}), flush=True)
        finally:
            build.use_library("dense_chain")


if __name__ == "__main__":
    main()
