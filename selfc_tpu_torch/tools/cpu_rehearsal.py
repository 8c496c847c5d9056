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
from selfc_tpu_torch.ops import deform as df
from selfc_tpu_torch.ops import dense_chain as dc
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
    res = subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", f"-I{out_dir}", "-o", str(lib),
                          str(cpp), "-lpthread"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}:\n{res.stderr}")
    return lib


@contextlib.contextmanager
def cpu_kernels(out_dir: Path):
    """Inside, the launch functions of ``ops.dense_chain`` (``_chain_cuda``,
    ``_feats_cuda``, ``_bwd_cuda``) and ``ops.deform`` (``_forward_cuda``,
    ``_backward_cuda``) run the CPU builds of the CUDA sources on CPU
    tensors. The public wrappers still take their plain versions for a CPU
    tensor: call the launch functions directly."""
    names = build.kernel_names()
    libs = {n: build_cpu_library(n, out_dir) for n in names}
    stream = dc._stream
    dc._stream = lambda x: None
    try:
        for n, lib in libs.items():
            build.use_library(n, lib)
        yield
    finally:
        dc._stream = stream
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
             dtypes=(torch.float32, torch.bfloat16), modes=tuple(dc.EP_AUX), seed=0) -> list[dict]:
    """Every kernel against its plain version at an odd shape with two
    clips; call inside ``cpu_kernels()``. ``widths``: (C, c_out) or
    (C, c_out, gc). Returns one record a case: the errors relative to max
    |plain|. The kernels' feats buffers are held to the plain features laid
    out as theirs (zero pad lanes at gc < 32); the adjoint gets the plain
    features in that layout and a gradient whose pad lanes hold noise,
    which must not reach any result."""
    rng = np.random.default_rng(seed)
    out = []
    for dtype in dtypes:
        for C, c_out, *gcs in widths:
            gc = gcs[0] if gcs else 32
            x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, shape, "cpu", dtype, gc)
            rec = {"dtype": str(dtype).split(".")[-1], "C": C, "c_out": c_out, "gc": gc}
            for mode in modes:
                n_aux = dc.EP_AUX[mode]
                aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
                got, got_feats = dc._chain_cuda(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
                want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
                rec[f"forward_{mode}"] = rel_err(got, want)
            feats = dc.padded_width(dc.chain_feats_plain(x, ws, bs), gc, dc.padded_gc(gc))
            rec["forward_feats"] = rel_err(got_feats, feats)
            rec["feats"] = rel_err(dc._feats_cuda(x, ws, bs), feats)
            g = torch.from_numpy(rng.normal(0, 1, feats.shape).astype(np.float32))
            dx0 = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
            want = dc.chain_spatial_bwd_plain(x, ws, bs, feats, g.to(dtype), dx0)
            for need_dx in (False, True):
                # copies: the kernels update both in place
                dfeats = g.to(dtype).to(torch.float32, copy=True)
                dx = dx0.clone() if need_dx else None
                dws, dbs = dc._bwd_cuda(x, ws, bs, feats, dfeats, dx)
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


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp, cpu_kernels(Path(tmp)), torch.no_grad():
        records = rehearse() + rehearse_deform()
    for rec in records:
        print(json.dumps(rec), flush=True)
        limit = 1e-5 if rec["dtype"] == "float32" else 3e-2
        bad = {k: v for k, v in rec.items() if isinstance(v, float) and not v <= limit}
        if rec.get("dweight_same_bits") is False:
            bad["dweight_same_bits"] = False
        if bad:
            print(f"cpu_rehearsal: FAILED {rec}: {bad}", file=sys.stderr)
            return 1
    print(json.dumps({"ok": True, "cases": len(records), "device": "cpu (CUDA sources compiled by g++)"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
