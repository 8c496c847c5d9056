"""Run the CUDA sources of ``csrc/`` on the CPU, to rehearse their indexing
where there is no GPU and no ``nvcc``.

Each ``csrc/<name>.cu`` is compiled as plain C++ by ``g++`` against two small
stand-in headers (``cuda_runtime.h``, ``cuda_bf16.h``): ``__global__`` and
``__device__`` are empty, ``__shared__`` is ``static`` (blocks run one after
another, so a static array is a block's shared memory), the threads of a block
are ``std::thread``s (one set a launch, walking over the blocks in order) with
thread-local ``threadIdx`` / ``blockIdx``,
``__syncthreads`` is a ``std::barrier``, and every
``kernel<T><<<grid, block, smem, stream>>>(args);`` is rewritten into a call of
a launcher. The resulting library has the same C interface, so the port's own
wrappers drive it on CPU tensors (``cpu_kernels()`` below) and their results
can be held against the plain PyTorch versions.

This proves arithmetic, indexing, edge masks and barrier placement. It proves
nothing of what only the GPU's compiler and hardware decide: registers, shared
memory size, alignment faults, launch limits, speed.

    python3 -m selfc_tpu_torch.tools.cpu_rehearsal      # needs g++ with C++20
"""

from __future__ import annotations

import contextlib
import json
import re
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
from selfc_tpu_torch.utils.bench import make_chain, make_deform

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(8) uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
using std::min;
using std::max;
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "cpu stand-in"; }
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline float atomicAdd(float* p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
inline thread_local dim3 threadIdx, blockIdx, gridDim;
inline thread_local std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
template <typename F>
void cpu_launch(dim3 grid, dim3 block, F body) {
  // one set of threads walks over the blocks in order; every block has a
  // barrier of its own, which a thread leaves for good when its body returns
  // (so a thread that returned early does not hold the others), and a second
  // barrier keeps any thread from starting the next block, whose "shared"
  // arrays are the same static storage, before all have left this one
  const int nt = block.x * block.y * block.z;
  const size_t n_blocks = (size_t)grid.x * grid.y * grid.z;
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  for (size_t b = 0; b < n_blocks; ++b) bars.push_back(std::make_unique<std::barrier<>>(nt));
  std::barrier<> block_done(nt);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t, 0, 0);
      gridDim = grid;
      for (size_t b = 0; b < n_blocks; ++b) {
        blockIdx = dim3(b % grid.x, (b / grid.x) % grid.y, b / ((size_t)grid.x * grid.y));
        block_barrier = bars[b].get();
        body();
        bars[b]->arrive_and_drop();
        block_done.arrive_and_wait();
      }
    });
  for (auto& th : threads) th.join();
}
"""

CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t v; };
inline float __bfloat162float(__nv_bfloat16 b) { unsigned u = (unsigned)b.v << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  unsigned u; std::memcpy(&u, &f, 4);
  return __nv_bfloat16{(uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
"""

_LAUNCH = re.compile(r"(\w+<[^<>;]*>)<<<(.*?)>>>\((.*?)\);", re.S)
# a kernel's dynamic shared memory: static storage of 128 KB (blocks run one
# after another, as for __shared__)
_DYN_SMEM = re.compile(r"extern __shared__ (__align__\(\d+\) )?float (\w+)\[\];")


def _split_top(text: str) -> list[str]:
    """Split at the commas that are outside every bracket."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(<["
        depth -= ch in ")>]"
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def rewrite_launches(source: str) -> tuple[str, int]:
    """``k<T><<<grid, block, ...>>>(args);`` -> ``cpu_launch(grid, block, [=] { k<T>(args); });``"""
    def repl(m):
        grid, block = _split_top(m.group(2))[:2]
        return f"cpu_launch(dim3({grid}), dim3({block}), [=] {{ {m.group(1)}({m.group(3)}); }});"
    source = _DYN_SMEM.sub(r"static \1float \2[1 << 15];", source)
    return _LAUNCH.subn(repl, source)


def build_cpu_library(name: str, out_dir: Path) -> Path:
    """Compile ``csrc/<name>.cu`` for the CPU into ``out_dir``."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the CUDA sources cannot be rehearsed on the CPU")
    out_dir = Path(out_dir)
    (out_dir / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out_dir / "cuda_bf16.h").write_text(CUDA_BF16_H)
    text, n = rewrite_launches((build.CSRC_DIR / f"{name}.cu").read_text())
    if n == 0:
        raise RuntimeError(f"{name}.cu: no kernel launch found to rewrite")
    cpp, lib = out_dir / f"{name}.cpp", out_dir / f"lib{name}_cpu.so"
    cpp.write_text(text)
    res = subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", f"-I{out_dir}",
                          f"-I{build.CSRC_DIR}", "-o", str(lib),
                          str(cpp), "-lpthread"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}:\n{res.stderr}")
    return lib


@contextlib.contextmanager
def cpu_kernels(out_dir: Path):
    """Inside, the launch functions of ``ops.dense_chain`` (``_chain_cuda``,
    ``_feats_cuda``, ``_bwd_cuda``), ``ops.deform`` (``_forward_cuda``,
    ``_backward_cuda``), ``ops.temporal_conv`` (``_forward_cuda``,
    ``_data_grad_cuda``) and ``ops.chain_variants`` (``_hg_cuda``,
    ``_ride_cuda``, ``_v3_cuda``) run the CPU builds of the CUDA sources on CPU
    tensors. The public wrappers still take their plain versions for a CPU
    tensor: call the launch functions directly."""
    names = build.kernel_names()
    libs = {n: build_cpu_library(n, out_dir) for n in names}
    streams = dc._stream, tc._stream, cv._stream
    dc._stream = tc._stream = cv._stream = lambda x: None
    try:
        for n, lib in libs.items():
            build.use_library(n, lib)
        yield
    finally:
        dc._stream, tc._stream, cv._stream = streams
        for n in names:
            build.use_library(n)


def rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# (C, c_out, gc): the 4x net's chains, then the codec's coupling at gc 32 and
# its prior at gc 12, and gc 24 (padded to 32 in the kernels)
WIDTHS = ((3, 48, 32), (48, 3, 32), (64, 64, 32), (12, 3, 32), (3, 12, 32),
          (3, 24, 12), (24, 24, 12), (3, 24, 24), (24, 24, 24))


def rehearse(shape=(2, 2, 9, 21), widths=WIDTHS,
             dtypes=(torch.float32, torch.bfloat16), modes=tuple(dc.EP_AUX), seed=0,
             stripe_w=0) -> list[dict]:
    """Every kernel against its plain version at an odd shape with two
    clips; call inside ``cpu_kernels()``. ``widths``: (C, c_out) or
    (C, c_out, gc). Returns one record a case: the errors relative to max
    |plain|. The kernels' feats buffers are held to the plain features laid
    out as theirs (zero pad lanes at gc < 32); the adjoint gets the plain
    features in that layout and a gradient whose pad lanes hold noise,
    which must not reach any result. ``stripe_w``: the shape is a W-packed
    batch of images that wide, and B1, B3 and B2 take the stripe masks
    (held to the plain versions of the striped calls)."""
    rng = np.random.default_rng(seed)
    sw = {"stripe_w": stripe_w}
    out = []
    for dtype in dtypes:
        for C, c_out, *gcs in widths:
            gc = gcs[0] if gcs else 32
            x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, shape, "cpu", dtype, gc)
            rec = {"dtype": str(dtype).split(".")[-1], "C": C, "c_out": c_out, "gc": gc,
                   "stripe_w": stripe_w}
            for mode in modes:
                n_aux = dc.EP_AUX[mode]
                aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
                got, got_feats = dc._chain_cuda(x, ws, bs, w5, b5, mode, 0.8, aa, mm, **sw)
                want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm, **sw)
                rec[f"forward_{mode}"] = rel_err(got, want)
            feats = dc.padded_width(dc.chain_feats_plain(x, ws, bs, **sw), gc, dc.padded_gc(gc))
            rec["forward_feats"] = rel_err(got_feats, feats)
            rec["feats"] = rel_err(dc._feats_cuda(x, ws, bs, **sw), feats)
            g = torch.from_numpy(rng.normal(0, 1, feats.shape).astype(np.float32))
            dx0 = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
            want = dc.chain_spatial_bwd_plain(x, ws, bs, feats, g.to(dtype), dx0, **sw)
            for need_dx in (False, True):
                # copies: the kernels update both in place
                dfeats = g.to(dtype).to(torch.float32, copy=True)
                dx = dx0.clone() if need_dx else None
                dws, dbs = dc._bwd_cuda(x, ws, bs, feats, dfeats, dx, **sw)
                rec[f"dw_db_need_dx_{need_dx}"] = max(
                    rel_err(u, v) for u, v in zip(dws + dbs, want[1] + want[2]))
            rec["dx"] = rel_err(dx, want[0])
            out.append(rec)
    return out


# (N, H, W, C, Cout) of the deformable conv: odd sizes, the JAX package's
# kernel test shape, the de-artifact width, and C / Cout over one 32-channel slab
DEFORM_CASES = ((2, 13, 21, 5, 3), (2, 12, 16, 8, 8), (1, 9, 11, 32, 32), (1, 7, 6, 40, 36))


def rehearse_deform(cases=DEFORM_CASES, dtypes=(torch.float32, torch.bfloat16), seed=0) -> list[dict]:
    """The deformable conv's kernels against its plain versions (offsets
    uniform in +-7 px, so taps leave the frame; the mask in [0, 2]); call
    inside ``cpu_kernels()``. One record a case: the errors relative to max
    |plain| of the forward and of each gradient, and whether dweight is the
    same bits twice."""
    rng = np.random.default_rng(seed)
    out = []
    for dtype in dtypes:
        for N, H, W, C, c_out in cases:
            x, off, mask, w, g = make_deform(rng, (N, H, W), C, c_out, "cpu", dtype)
            rec = {"kernel": "deform", "dtype": str(dtype).split(".")[-1], "shape": [N, H, W], "C": C, "c_out": c_out}
            rec["forward"] = rel_err(df._forward_cuda(x, off, mask, w), df.deform_conv2d_plain(x, off, mask, w))
            got = df._backward_cuda(x, off, mask, w, g)
            want = df.deform_conv2d_bwd_plain(x, off, mask, w, g)
            for name, u, v in zip(("dx", "doffset", "dmask", "dweight"), got, want):
                rec[name] = rel_err(u, v)
            rec["dweight_same_bits"] = torch.equal(got[3], df._backward_cuda(x, off, mask, w, g)[3])
            out.append(rec)
    return out


# (B, T, H, W, C, Co) of the temporal conv: a ragged H*W (35) and T 3, T 1
# (both neighbour taps in the padding), C and Co not multiples of the 16-channel
# slab or the 64-column tile, over one tile each, and Co 3
TEMPORAL_CASES = ((1, 3, 5, 7, 9, 5), (2, 1, 4, 3, 6, 3), (1, 4, 3, 23, 37, 70), (2, 3, 2, 9, 19, 3))


def rehearse_temporal_conv(cases=TEMPORAL_CASES, dtypes=(torch.float32, torch.bfloat16),
                           slopes=(None, 0.2, 0.0), seed=0) -> list[dict]:
    """The temporal conv's kernel against its plain version, forward at each
    slope (with the mask it writes at slope 0) and the data-gradient launch
    (the kernel with the flipped weights, no bias); call inside
    ``cpu_kernels()``. One record a case: the errors relative to max
    |plain|, and whether the mask is the plain one."""
    rng = np.random.default_rng(seed)
    out = []
    for dtype in dtypes:
        for B, T, H, W, C, co in cases:
            mk = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dtype)  # noqa: E731
            x, w, b, dy = mk(B, T, H, W, C), mk(3, C, co) * (3 * C) ** -0.5, mk(co) * 0.1, mk(B, T, H, W, co)
            rec = {"kernel": "temporal_conv", "dtype": str(dtype).split(".")[-1], "shape": [B, T, H, W],
                   "C": C, "c_out": co}
            for ns in slopes:
                got, mask = tc._forward_cuda(x, w, b, ns, ns is not None and ns <= 0)
                want, want_mask = tc._plain(x, w, b, ns)
                rec[f"forward_slope_{ns}"] = rel_err(got, want)
                if mask is not None:
                    # a mask bit may differ only where the two sums straddle 0
                    rec["mask_same"] = bool(torch.equal(mask, want_mask) or
                                            (want[mask != want_mask].float().abs().max() < 1e-5).item())
            rec["dx"] = rel_err(tc._data_grad_cuda(dy, w), tc.temporal_conv3_fused_plain(dy, tc._flipped(w)))
            out.append(rec)
    return out


# (C, c_out, gc) of the variants: the 4x net's H/G pair and its F chain, the
# codec's pair (c_out 12) and F chain, its prior at gc 12; c_out 6 and 10 (the
# widest ride), odd widths
HG_WIDTHS = ((3, 48, 32), (3, 12, 32), (5, 7, 13), (4, 12, 20))
RIDE_WIDTHS = ((48, 3, 32), (12, 3, 32), (6, 6, 16), (5, 10, 13), (9, 3, 24))
V3_WIDTHS = ((3, 64, 32), (64, 64, 32), (24, 24, 12), (3, 24, 12), (32, 3, 32), (5, 7, 20))


def rehearse_variants(shape=(2, 2, 9, 21), dtypes=(torch.float32, torch.bfloat16), hg_widths=HG_WIDTHS,
                      ride_widths=RIDE_WIDTHS, v3_widths=V3_WIDTHS, modes=tuple(dc.EP_AUX),
                      seed=0) -> list[dict]:
    """B7 (both combines), B9 (every epilogue) and B8 against their plain
    versions; call inside ``cpu_kernels()``. One record a kernel, dtype and
    width: the errors relative to max |plain|."""
    rng = np.random.default_rng(seed)
    out = []
    for dtype in dtypes:
        name = str(dtype).split(".")[-1]
        for C, c_out, gc in hg_widths:
            x, hws, hbs, hw5, hb5, x2, _ = make_chain(rng, C, c_out, shape, "cpu", dtype, gc)
            _, gws, gbs, gw5, gb5, _, _ = make_chain(rng, C, c_out, shape, "cpu", dtype, gc)
            rec = {"kernel": "chain_hg", "dtype": name, "C": C, "c_out": c_out, "gc": gc}
            for rev in (False, True):
                args = (x, x2, hws, hbs, hw5, hb5, gws, gbs, gw5, gb5, 0.8, rev)
                got, want = cv._hg_cuda(*args), cv.fused_hg_pair_plain(*args)
                rec[f"y2_rev_{rev}"], rec[f"se_rev_{rev}"] = (rel_err(u, v) for u, v in zip(got, want))
            out.append(rec)
        for C, c_out, gc in ride_widths:
            x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, shape, "cpu", dtype, gc)
            rec = {"kernel": "chain_ride", "dtype": name, "C": C, "c_out": c_out, "gc": gc}
            for mode in modes:
                n_aux = dc.EP_AUX[mode]
                aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
                rec[f"forward_{mode}"] = rel_err(cv._ride_cuda(x, ws, bs, w5, b5, mode, 0.8, aa, mm),
                                                 cv.dense_chain_ride_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm))
            out.append(rec)
        for C, c_out, gc in v3_widths:
            x, ws, bs, w5, b5, _, _ = make_chain(rng, C, c_out, shape, "cpu", dtype, gc)
            out.append({"kernel": "chain_v3", "dtype": name, "C": C, "c_out": c_out, "gc": gc,
                        "forward": rel_err(cv._v3_cuda(x, ws, bs, w5, b5),
                                           cv.dense_chain_v3_plain(x, ws, bs, w5, b5))})
    return out


# W-packed batches: (packed shape, stripe_w). Four images of 9 columns a row
# put stripe edges inside the 16-column tiles and inside a thread's 8
# columns (9, 18, 27); two of 18 at the other side of a thread's block
STRIPE_CASES = (((1, 2, 9, 36), 9), ((2, 1, 7, 36), 18))
# (C, c_out, gc) under a stripe: the 4x training step's, the codec's
STRIPE_WIDTHS = ((3, 48, 32), (48, 3, 32), (64, 64, 32), (3, 64, 32), (12, 3, 32), (3, 12, 32),
                 (3, 24, 12), (24, 24, 12))


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp, cpu_kernels(Path(tmp)), torch.no_grad():
        records = rehearse() + rehearse_deform() + rehearse_temporal_conv() + rehearse_variants()
        for shape, stripe_w in STRIPE_CASES:
            records += rehearse(shape, STRIPE_WIDTHS, stripe_w=stripe_w)
    for rec in records:
        print(json.dumps(rec), flush=True)
        limit = 1e-5 if rec["dtype"] == "float32" else 3e-2
        bad = {k: v for k, v in rec.items() if isinstance(v, float) and not v <= limit}
        for flag in ("dweight_same_bits", "mask_same"):
            if rec.get(flag) is False:
                bad[flag] = False
        if bad:
            print(f"cpu_rehearsal: FAILED {rec}: {bad}", file=sys.stderr)
            return 1
    print(json.dumps({"ok": True, "cases": len(records), "device": "cpu (CUDA sources compiled by g++)"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
