"""Where a tensor-core kernel (B6, B8) spends its time: the mma products or
the rest (staging, the ring's barriers, fragment loads and splits, the
epilogue).

The machine with the GPU has no kernel profiler, so this script builds
variants of ``csrc/temporal_conv.cu`` and ``csrc/chain_v3.cu`` against text
substitutions of their shared header ``csrc/tc_mma.cuh``, and times each at
the rows ``chip_smoke.py`` times, beside the unchanged sources (``base``):

  - ``no_mma``: every slab's products skipped (staging, ring, epilogue);
  - ``no_mma_keep_frags``: the fragments still loaded and split, the mma
    instruction replaced by an empty one that keeps its operands alive;
  - ``one_pass``: one TF32 product per tile instead of the three of 3xTF32.

The variants compute wrong values on purpose; only their times mean
anything. Run from the repo root on a machine with an NVIDIA Hopper GPU:

    python3 -m selfc_tpu_torch.tools.tc_attribution
"""

from __future__ import annotations

import json
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from selfc_tpu_torch.kernels import build
from selfc_tpu_torch.ops import chain_variants as cv
from selfc_tpu_torch.ops import temporal_conv as tc
from selfc_tpu_torch.utils.bench import SERVE_SHAPE, TRAIN_SHAPE, make_chain, make_temporal_conv, time_cuda

SLAB_BODY = "  constexpr int KS = Elem<T>::BK / Elem<T>::KSTEP;\n"
MMA_TF32 = ('''      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, '''
            '''{%0,%1,%2,%3};\\n"\n''')
SMALL_TERMS = ("    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], al[m], bh[n]);",
               "    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ah[m], bl[n]);")

# (path, (B,T,H,W), C, Co, dx) of chip_smoke.py's B6 rows: the serving and
# training latents, FeatureCollapseFast's 4x smaller ones, forward and dx
B6_ROWS = [("serve", SERVE_SHAPE, 131, 48, False), ("serve", SERVE_SHAPE, 176, 3, False),
           ("serve/4", (1, 7, 36, 44), 432, 768, False), ("serve/4", (1, 7, 36, 44), 1152, 48, False),
           ("train", TRAIN_SHAPE, 131, 48, False), ("train", TRAIN_SHAPE, 131, 48, True),
           ("train", TRAIN_SHAPE, 176, 3, False), ("train", TRAIN_SHAPE, 176, 3, True),
           ("train/4", (8, 7, 9, 9), 432, 768, False), ("train/4", (8, 7, 9, 9), 432, 768, True),
           ("train/4", (8, 7, 9, 9), 1152, 48, False), ("train/4", (8, 7, 9, 9), 1152, 48, True)]
B8_ROWS = [("serve", SERVE_SHAPE, 64, 64), ("serve", SERVE_SHAPE, 3, 64),
           ("train", TRAIN_SHAPE, 64, 64), ("train", TRAIN_SHAPE, 3, 64)]


def variants(header: str) -> dict[str, str]:
    for pattern in (SLAB_BODY, MMA_TF32, *SMALL_TERMS):
        if header.count(pattern) != 1:
            raise SystemExit(f"the header no longer holds exactly one {pattern!r}")
    start = header.index(SLAB_BODY)
    end = header.index("\n}\n", start)
    return {
        "base": header,
        "no_mma": header[:start] + "  (void)acc, (void)as, (void)a0, (void)a1, (void)bs, (void)n0w, (void)g, (void)t;"
        + header[end:],
        "no_mma_keep_frags": header.replace(MMA_TF32, '      ""\n'),
        "one_pass": header.replace(SMALL_TERMS[0], "    for (int n = 0; n < NT; ++n) {}")
        .replace(SMALL_TERMS[1], "    for (int n = 0; n < NT; ++n) {}"),
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    nvcc = build.find_nvcc()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(dir=build.PKG_DIR) as tmp, torch.no_grad():
        procs = {}
        for name, text in variants((build.CSRC_DIR / "tc_mma.cuh").read_text()).items():
            d = Path(tmp) / name
            d.mkdir()
            (d / "tc_mma.cuh").write_text(text)
            for src in ("temporal_conv", "chain_v3"):
                shutil.copy(build.CSRC_DIR / f"{src}.cu", d)
                procs[(name, src)] = subprocess.Popen(
                    [nvcc, *build.NVCC_FLAGS, "-o", str(d / f"lib{src}.so"), str(d / f"{src}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed for {key}:\n{log}")
        names = sorted({n for n, _ in procs})
        rng = np.random.default_rng(0)
        try:
            for path, shape, C, co, dx in B6_ROWS:
                x, w, b, g = make_temporal_conv(rng, shape, C, co, dev)
                if dx:   # the data gradient: the conv of g with the flipped weights
                    x, w, b = g, tc._flipped(w), None
                row = {"kernel": "B6", "row": f"{path} {C}->{co}{' dx' if dx else ''}"}
                for name in names:
                    build.use_library("temporal_conv", Path(tmp) / name / "libtemporal_conv.so")
                    row[name] = time_cuda(lambda: tc._launch(x, w, b, None, False))["median"]
                print(json.dumps(row), flush=True)
            for path, shape, C, c_out in B8_ROWS:
                x, ws, bs, w5, b5, _, _ = make_chain(rng, C, c_out, shape, dev)
                row = {"kernel": "B8", "row": f"{path} {C}->{c_out}"}
                for name in names:
                    build.use_library("chain_v3", Path(tmp) / name / "libchain_v3.so")
                    row[name] = time_cuda(lambda: cv._v3_cuda(x, ws, bs, w5, b5))["median"]
                print(json.dumps(row), flush=True)
        finally:
            build.use_library("temporal_conv")
            build.use_library("chain_v3")


if __name__ == "__main__":
    main()
