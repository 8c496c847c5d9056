"""Where a tensor-core kernel (B1, B2, B3, B4, B5, B6, B7, B8, B9) spends its
time: the mma products or the rest (staging, the ring's barriers, fragment
loads and splits, the epilogue); and what another tile would cost the
spatial layers of B1, B3 and B9.

The machine with the GPU has no kernel profiler, so this script builds
variants of ``csrc/temporal_conv.cu``, ``csrc/chain_v3.cu``,
``csrc/dense_chain.cu``, ``csrc/chain_ride.cu``, ``csrc/chain_hg.cu``,
``csrc/dense_chain_bwd.cu`` and ``csrc/deform.cu`` against text
substitutions of their shared
headers ``csrc/tc_mma.cuh`` and ``csrc/tc_chain.cuh``, and times each at the
rows ``chip_smoke.py`` times, beside the unchanged sources (``base``):

  - ``no_mma``: every slab's products skipped (staging, ring, epilogue; B2's
    fragments, loaded outside ``slab_mma``, fall away with its products);
  - ``no_mma_keep_frags``: the fragments still loaded and split, the mma
    instruction replaced by an empty one that keeps its operands alive;
  - ``one_pass``: one TF32 product per tile instead of the three of 3xTF32;
  - ``tile_12x8`` (B1, B3, B4, B9): the chain layer on a tile of 12 x 8
    pixels and 3 warps instead of its 8 x 16 and 4;
  - B2's design choices undone, one at a time (``csrc/dense_chain_bwd.cu``):
    ``rna_split`` (the rounded 3xTF32 split of the other kernels in place of
    ``split_tf32_fast``), ``wg_one_block`` (the weight gradient bound to one
    block an SM, no spill), ``dg_one_frame`` (a data-gradient block a frame,
    the weights staged for each), ``wg_all_groups`` (every chunk of a layer
    with all the weight gradient's groups, as many partial sums).

  - B5 (``csrc/deform.cu``): ``no_mma`` and ``one_pass`` as above, and
    ``mma_xor``: each mma replaced by an xor of its operands into the
    accumulator (with ``no_mma`` the compiler drops B5's gather, which only
    the products read; here the gather stays and only the tensor cores'
    work goes); B5's design choices undone: ``no_window`` (the forward
    reads every corner from x, its staged window unread), ``halo3`` (a
    3-pixel window), ``no_dx`` (dx's fixed-point atomics left out: what
    they cost).

B7's rows also list the base build's five launches one by one
(``torch.profiler``): layer 0 is the one where a block could form both
chains' products from one staged x. B5's backward row lists its four
launches (the maxima, the pass over (tile, tap) blocks, the reduction of
dW, dx's conversion).

The mma variants compute wrong values on purpose; only their times mean
anything. Run from the repo root on a machine with an NVIDIA Hopper GPU
(naming kernels times only their rows and builds only their sources):

    python3 -m selfc_tpu_torch.tools.tc_attribution [B1 B2 ... B9]
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from selfc_tpu_torch.kernels import build
from selfc_tpu_torch.ops import chain_variants as cv
from selfc_tpu_torch.ops import deform as df
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.ops import temporal_conv as tc
from selfc_tpu_torch.utils.bench import (CODEC_DEC_SHAPE, CODEC_TRAIN_LAT, CODEC_WIDTHS, DEART_C, DEART_DEC_SHAPE,
                                         DEART_TRAIN_SHAPE, PATH_WIDTHS, SERVE_SHAPE, SURROGATE_C, TRAIN_SHAPE, make_chain,
                                         make_deform, make_temporal_conv, time_cuda)

SLAB_BODY = "  constexpr int KS = Elem<T>::BK / Elem<T>::KSTEP;\n"
MMA_TF32 = ('''      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, '''
            '''{%0,%1,%2,%3};\\n"\n''')
SMALL_TERMS = ("    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], al[m], bh[n]);",
               "    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ah[m], bl[n]);")
LARGE_TERM = "    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ah[m], bh[n]);"
TILE = "using SpatialTile = ChainTile<8, 16, 4>;"

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


def _packed(shape):
    """A training latent W-packed as the nets pack it: (shape, stripe)."""
    P = dc.pick_pack_w(shape[0], shape[3])
    return (shape[0] // P, shape[1], shape[2], P * shape[3]), shape[3]


TRAIN_PACKED, CODEC_PACKED = _packed(TRAIN_SHAPE), _packed(CODEC_TRAIN_LAT)
# (path, shape, stripe, C, c_out, gc) of chip_smoke.py's B1 rows
B1_ROWS = ([("serve", SERVE_SHAPE, 0, C, c_out, 32) for C, c_out in PATH_WIDTHS]
           + [(tag, *sh, C, c_out, 32) for tag, sh in (("train", (TRAIN_SHAPE, 0)), ("train_packed", TRAIN_PACKED))
              for C, c_out in PATH_WIDTHS]
           + [("codec", CODEC_DEC_SHAPE, 0, *w) for w in CODEC_WIDTHS]
           + [(tag, *sh, *w) for tag, sh in (("codec_train", (CODEC_TRAIN_LAT, 0)), ("codec_train_packed", CODEC_PACKED))
              for w in CODEC_WIDTHS])
# (path, shape, stripe, C, gc) of the B3 rows, then B4's forward (B3's entry, gc 32)
B3_ROWS = ([(tag, *sh, C, 32) for tag, sh in (("train", (TRAIN_SHAPE, 0)), ("train_packed", TRAIN_PACKED))
            for C in (3, 48, 64)]
           + [(tag, *sh, C, 12) for tag, sh in (("codec_train", (CODEC_TRAIN_LAT, 0)),
                                                ("codec_train_packed", CODEC_PACKED)) for C in (3, 24)]
           + [("codec_train B4", CODEC_TRAIN_LAT, 0, C, 32) for C in SURROGATE_C])
B9_ROWS = [("serve", SERVE_SHAPE, 48, 3), ("train", TRAIN_SHAPE, 48, 3)]
# (path, shape, stripe, C, gc) of the B2 rows (the adjoint of the B3 rows'
# chains), then B4's backward (gc 32, no gradient reaching x directly)
B2_ROWS = B3_ROWS
B7_ROWS = [("serve", SERVE_SHAPE, 3, 48), ("train", TRAIN_SHAPE, 3, 48)]
MMA_VARIANTS = ("base", "no_mma", "no_mma_keep_frags", "one_pass")
# B5: each mma replaced by an xor of its operands into the accumulator
MMA_XOR = ('      "{ .reg .b32 t; xor.b32 t, %4, %5; xor.b32 t, t, %6; xor.b32 t, t, %7; xor.b32 t, t, %8; '
           'xor.b32 t, t, %9; and.b32 t, t, 0x80000000; mov.b32 %0, t; }\\n"\n')
MMA_BF16 = ('''      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, '''
            '''{%0,%1,%2,%3};\\n"\n''')
# (path, shape, backward) of chip_smoke.py's B5 rows (C = Cout = 32, offsets +-3 px)
B5_ROWS = [("codec", DEART_DEC_SHAPE, False), ("codec_train", DEART_TRAIN_SHAPE, False),
           ("codec_train", DEART_TRAIN_SHAPE, True)]
DX_ATOMIC = ("atomicAdd(p.dx_fixed + (size_t)tgt * C + c, "
             "(unsigned long long)__float2ll_rn(s_cw[tp * 4 + s] * d * scale));")
# B5's variants: (pattern, replacement) pairs in csrc/deform.cu
B5_VARIANTS = {
    "no_window": [("return (unsigned)a < (unsigned)WIN_H && (unsigned)b < (unsigned)WIN_W ? a * WIN_W + b : -1;",
                   "return -1 + 0 * (a + b);")],
    "halo3": [("constexpr int HALO = 4;", "constexpr int HALO = 3;")],
    "no_dx": [(DX_ATOMIC, "(void)0;")],
}
TILE_VARIANTS = ("tile_12x8",)
# B2's variants: (pattern, replacement) in csrc/dense_chain_bwd.cu
B2_VARIANTS = {
    "rna_split": ("split_tf32_fast(", "split_tf32("),
    "wg_one_block": ("__launch_bounds__(WG_WARPS * 32, 2)", "__launch_bounds__(WG_WARPS * 32, 1)"),
    "dg_one_frame": ("const int fg = max(1, min(p.frames, (3 * groups + tiles * chunks - 1) / (tiles * chunks)));",
                     "const int fg = p.frames;"),
    "wg_all_groups": ("const int wg = max(1, groups / (x_chunks + layer));", "const int wg = groups;"),
}


def variants(header: str, chain_header: str) -> dict[str, dict[str, str]]:
    """{variant: {file name: text}}: the headers, and the source of a B2 variant."""
    for pattern in (SLAB_BODY, MMA_TF32, *SMALL_TERMS, LARGE_TERM):
        if header.count(pattern) != 1:
            raise SystemExit(f"tc_mma.cuh no longer holds exactly one {pattern!r}")
    if chain_header.count(TILE) != 1:
        raise SystemExit(f"tc_chain.cuh no longer holds exactly one {TILE!r}")
    start = header.index(SLAB_BODY)
    end = header.index("\n}\n", start)
    mma = {
        "base": header,
        "no_mma": (header[:start] + "  (void)acc, (void)as, (void)a0, (void)a1, (void)bs, (void)n0w, (void)g, (void)t;"
                   + header[end:]).replace(SMALL_TERMS[0], "    for (int n = 0; n < NT; ++n) {}")
        .replace(SMALL_TERMS[1], "    for (int n = 0; n < NT; ++n) {}").replace(LARGE_TERM, "    for (int n = 0; n < NT; ++n) {}"),
        "no_mma_keep_frags": header.replace(MMA_TF32, '      ""\n'),
        "one_pass": header.replace(SMALL_TERMS[0], "    for (int n = 0; n < NT; ++n) {}")
        .replace(SMALL_TERMS[1], "    for (int n = 0; n < NT; ++n) {}"),
    }
    out = {name: {"tc_mma.cuh": text, "tc_chain.cuh": chain_header} for name, text in mma.items()}
    out["tile_12x8"] = {"tc_mma.cuh": header,
                        "tc_chain.cuh": chain_header.replace(TILE, "using SpatialTile = ChainTile<12, 8, 3>;")}
    bwd = (build.CSRC_DIR / "dense_chain_bwd.cu").read_text()
    for name in B2_VARIANTS:
        out[name] = {"tc_mma.cuh": header, "tc_chain.cuh": chain_header, "dense_chain_bwd.cu": b2_variant(bwd, name)}
    if header.count(MMA_BF16) != 1:
        raise SystemExit(f"tc_mma.cuh no longer holds exactly one {MMA_BF16!r}")
    out["mma_xor"] = {"tc_mma.cuh": header.replace(MMA_TF32, MMA_XOR).replace(MMA_BF16, MMA_XOR),
                      "tc_chain.cuh": chain_header}
    deform = (build.CSRC_DIR / "deform.cu").read_text()
    for name, subs in B5_VARIANTS.items():
        text = deform
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"deform.cu no longer holds exactly one {old!r}")
            text = text.replace(old, new)
        out[name] = {"tc_mma.cuh": header, "tc_chain.cuh": chain_header, "deform.cu": text}
    return out


def b2_variant(source: str, name: str) -> str:
    """csrc/dense_chain_bwd.cu with one of its design choices undone."""
    old, new = B2_VARIANTS[name]
    if old not in source:
        raise SystemExit(f"dense_chain_bwd.cu no longer holds {old!r}")
    return source.replace(old, new)


def _sources(name):
    if name in B2_VARIANTS:
        return ("dense_chain_bwd",)
    if name in B5_VARIANTS or name == "mma_xor":
        return ("deform",)
    return ("dense_chain", "chain_ride") if name in TILE_VARIANTS else ("temporal_conv", "chain_v3", "dense_chain",
                                                                         "chain_ride", "chain_hg", "dense_chain_bwd",
                                                                         "deform")


def launch_ms(fn):
    """Device ms of each kernel launch of one ``fn()`` call, in order."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = [getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0) for e in prof.events()]
    return [t / 1e3 for t in times if t > 0]


def _time(row, fn, lib_name, tmp, names):
    """Print ``row`` with fn's median ms on each variant's build of lib_name."""
    for name in names:
        build.use_library(lib_name, Path(tmp) / name / f"lib{lib_name}.so")
        row[name] = time_cuda(fn)["median"]
    print(json.dumps(row), flush=True)


# the sources each kernel's rows run
KERNEL_SOURCES = {"B1": "dense_chain", "B2": "dense_chain_bwd", "B3": "dense_chain", "B4": "dense_chain_bwd",
                  "B5": "deform", "B6": "temporal_conv", "B7": "chain_hg", "B8": "chain_v3", "B9": "chain_ride"}


def main(kernels=tuple(KERNEL_SOURCES)):
    unknown = set(kernels) - set(KERNEL_SOURCES)
    if unknown:
        raise SystemExit(f"unknown kernels {sorted(unknown)}: expected some of {sorted(KERNEL_SOURCES)}")
    wanted = {KERNEL_SOURCES[k] for k in kernels} | ({"dense_chain"} if {"B2", "B4"} & set(kernels) else set())
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    nvcc = build.find_nvcc()
    dev = torch.device("cuda")
    libs = ("temporal_conv", "chain_v3", "dense_chain", "chain_ride", "chain_hg", "dense_chain_bwd", "deform")
    with tempfile.TemporaryDirectory(dir=build.PKG_DIR) as tmp, torch.no_grad():
        procs = {}
        for name, headers in variants((build.CSRC_DIR / "tc_mma.cuh").read_text(),
                                      (build.CSRC_DIR / "tc_chain.cuh").read_text()).items():
            d = Path(tmp) / name
            d.mkdir()
            for h, text in headers.items():
                (d / h).write_text(text)
            for src in _sources(name):
                if src not in wanted:
                    continue
                if not (d / f"{src}.cu").exists():
                    shutil.copy(build.CSRC_DIR / f"{src}.cu", d)
                procs[(name, src)] = subprocess.Popen(
                    [nvcc, *build.NVCC_FLAGS, "-o", str(d / f"lib{src}.so"), str(d / f"{src}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed for {key}:\n{log}")
        rng = np.random.default_rng(0)
        chain_names = MMA_VARIANTS + TILE_VARIANTS
        try:
            for path, shape, C, co, dx in B6_ROWS if "B6" in kernels else ():
                x, w, b, g = make_temporal_conv(rng, shape, C, co, dev)
                if dx:   # the data gradient: the conv of g with the flipped weights
                    x, w, b = g, tc._flipped(w), None
                _time({"kernel": "B6", "row": f"{path} {C}->{co}{' dx' if dx else ''}"},
                      lambda: tc._launch(x, w, b, None, False), "temporal_conv", tmp, MMA_VARIANTS)
            for path, shape, C, c_out in B8_ROWS if "B8" in kernels else ():
                x, ws, bs, w5, b5, _, _ = make_chain(rng, C, c_out, shape, dev)
                _time({"kernel": "B8", "row": f"{path} {C}->{c_out}"}, lambda: cv._v3_cuda(x, ws, bs, w5, b5),
                      "chain_v3", tmp, MMA_VARIANTS)
            for path, shape, stripe, C, c_out, gc in B1_ROWS if "B1" in kernels else ():
                x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, shape, dev, gc=gc)
                _time({"kernel": "B1", "row": f"{path} {C}->{c_out} gc{gc}"},
                      lambda: dc._chain_cuda(x, ws, bs, w5, b5, "mul_add", 1.0, a, m, stripe), "dense_chain", tmp,
                      chain_names)
            for path, shape, stripe, C, gc in B3_ROWS if "B3" in kernels or "B4" in kernels else ():
                x, ws, bs, *_ = make_chain(rng, C, 3, shape, dev, gc=gc)
                _time({"kernel": "B3", "row": f"{path} {C} gc{gc}"},
                      lambda: dc._feats_cuda(x, ws, bs, stripe), "dense_chain", tmp, chain_names)
            for path, shape, C, c_out in B9_ROWS if "B9" in kernels else ():
                x, ws, bs, w5, b5, a, _ = make_chain(rng, C, c_out, shape, dev)
                _time({"kernel": "B9", "row": f"{path} {C}->{c_out}"},
                      lambda: cv._ride_cuda(x, ws, bs, w5, b5, "add", 1.0, a, None), "chain_ride", tmp, chain_names)
            for path, shape, stripe, C, gc in B2_ROWS if "B2" in kernels or "B4" in kernels else ():
                x, ws, bs, *_ = make_chain(rng, C, 3, shape, dev, gc=gc)
                feats = dc._feats_cuda(x, ws, bs, stripe)
                g = torch.from_numpy(rng.normal(0, 1, feats.shape).astype(np.float32)).to(dev)
                _time({"kernel": "B2", "row": f"{path} {C} gc{gc}"},
                      lambda: dc.chain_spatial_bwd(x, ws, bs, feats, g, None, stripe), "dense_chain_bwd", tmp,
                      MMA_VARIANTS + tuple(B2_VARIANTS))
            for path, shape, C, c_out in B7_ROWS if "B7" in kernels else ():
                x, hws, hbs, hw5, hb5, x2, _ = make_chain(rng, C, c_out, shape, dev)
                _, gws, gbs, gw5, gb5, _, _ = make_chain(rng, C, c_out, shape, dev)
                fn = lambda: cv._hg_cuda(x, x2, hws, hbs, hw5, hb5, gws, gbs, gw5, gb5, 1.0, False)  # noqa: E731
                _time({"kernel": "B7", "row": f"{path} {C}->{c_out}"}, fn, "chain_hg", tmp, MMA_VARIANTS)
                build.use_library("chain_hg", Path(tmp) / "base" / "libchain_hg.so")
                print(json.dumps({"kernel": "B7", "row": f"{path} {C}->{c_out}", "base_launches_ms": launch_ms(fn)}),
                      flush=True)
            for path, shape, backward in B5_ROWS if "B5" in kernels else ():
                x, off, mask, w, g = make_deform(rng, shape, DEART_C, DEART_C, dev, spread=3.0)
                fn = ((lambda: df._backward_cuda(x, off, mask, w, g)) if backward  # noqa: E731
                      else (lambda: df._forward_cuda(x, off, mask, w)))
                row = f"{path} {DEART_C}->{DEART_C}{' backward' if backward else ''}"
                _time({"kernel": "B5", "row": row}, fn, "deform", tmp, MMA_VARIANTS + ("mma_xor",) + tuple(B5_VARIANTS))
                if backward:
                    build.use_library("deform", Path(tmp) / "base" / "libdeform.so")
                    print(json.dumps({"kernel": "B5", "row": row, "base_launches_ms": launch_ms(fn)}), flush=True)
                del x, off, mask, w, g
        finally:
            for name in libs:
                build.use_library(name)


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or tuple(KERNEL_SOURCES))
