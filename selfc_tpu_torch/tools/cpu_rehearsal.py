"""Run the CUDA sources of ``csrc/`` on the CPU, to rehearse their indexing
where there is no GPU and no ``nvcc``.

Each ``csrc/<name>.cu`` is compiled as plain C++ by ``g++`` against two small
stand-in headers (``cuda_runtime.h``, ``cuda_bf16.h``): ``__global__`` and
``__device__`` are empty, ``__shared__`` is ``static`` (blocks run one after
another, so a static array is a block's shared memory), the threads of a block
are ``std::thread``s (one set a launch, walking over the blocks in order) with
thread-local ``threadIdx`` / ``blockIdx``,
``__syncthreads`` is a barrier (its waiters yield a few times, then sleep),
and every ``kernel<T><<<grid, block, smem, stream>>>(args);`` (in a source or
in a header of ``csrc/``) is rewritten into a call of a launcher. Each warp's
32 threads also share a barrier of their own, through which
``csrc/tc_mma.cuh``'s warp-collective tensor-core products are executed from
the lanes' fragments; its ``cvt.rna.tf32`` is emulated and ``cp.async`` is a
plain copy. The resulting library has the same C interface, so the port's
own wrappers drive it on CPU tensors (``cpu_kernels()`` below) and their
results can be held against the plain PyTorch versions.

This proves arithmetic, indexing, edge masks and barrier placement. It proves
nothing of what only the GPU's compiler and hardware decide: registers, shared
memory size, alignment faults, launch limits, speed, and the mma fragment
layouts (the stand-in takes them from the PTX ISA, as the kernels do).

    python3 -m selfc_tpu_torch.tools.cpu_rehearsal      # needs g++ with C++20
"""

from __future__ import annotations

import contextlib
import ctypes
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
from selfc_tpu_torch.utils.bench import deform_all_to_one, make_chain, make_deform

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
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
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
inline float2 make_float2(float a, float b) { return float2{a, b}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return uint2{a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return uint4{a, b, c, d}; }
using std::min;
using std::max;
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
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
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned cur = a.load();
  while (cur < v && !a.compare_exchange_weak(cur, v)) {}
  return cur;
}
inline long long __float2ll_rn(float v) { return std::llrint(v); }   // to nearest, ties to even
inline float __ll2float_rn(long long v) { return (float)v; }         // to nearest
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { std::memset(p, v, n); return 0; }
constexpr int cudaDevAttrMultiProcessorCount = 16;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 132; return 0; }   // an H100's SMs
// the order cpu_launch walks a grid's blocks in: 1 = last block first (set
// through ctypes: a result that depends on it depends on the blocks' order)
inline int cpu_blocks_reversed = 0;
extern "C" __attribute__((visibility("default"))) void selfc_cpu_reverse_blocks(int on) { cpu_blocks_reversed = on; }
// a barrier whose waiters first yield the core a few times (a round that
// ends soon costs no futex sleep and wake-up) and then sleep, so that a
// block's threads, which far outnumber the cores, do not keep them busy
// while other processes wait for them. arrive_and_drop: the thread leaves
// for good (it counts as arrived in this round and is no longer expected in
// the next ones).
class SpinBarrier {
 public:
  explicit SpinBarrier(int n) : expected_(n) {}
  void arrive_and_wait() {
    const unsigned g = gen_.load(std::memory_order_acquire);
    if (arrive(false)) return;
    for (int i = 0; i < 16 && gen_.load(std::memory_order_acquire) == g; ++i) std::this_thread::yield();
    for (unsigned now = gen_.load(std::memory_order_acquire); now == g; now = gen_.load(std::memory_order_acquire))
      gen_.wait(now, std::memory_order_acquire);
  }
  void arrive_and_drop() { arrive(true); }
 private:
  bool arrive(bool drop) {   // true where this arrival ends the round
    std::lock_guard<std::mutex> lock(mu_);
    if (drop) --expected_;
    else ++arrived_;
    if (arrived_ < expected_ || expected_ == 0) return false;
    arrived_ = 0;
    gen_.fetch_add(1, std::memory_order_release);
    gen_.notify_all();
    return true;
  }
  std::mutex mu_;
  int expected_, arrived_ = 0;
  std::atomic<unsigned> gen_{0};
};
inline thread_local dim3 threadIdx, blockIdx, gridDim;
inline thread_local SpinBarrier* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// a warp: its lanes meet at a barrier of their own, and exchange fragments
// through two buffers used in turns (a lane can refill one only after every
// lane has passed the barrier of the exchange that read the other)
struct WarpExchange { uint32_t a[2][32][32]; uint32_t b[2][32][16]; };
inline thread_local SpinBarrier* warp_barrier;
inline thread_local WarpExchange* warp_x;
inline thread_local int warp_turn;
template <typename F>
void cpu_launch(dim3 grid, dim3 block, F body) {
  // one set of threads walks over the blocks in order (or, with
  // cpu_blocks_reversed, in reverse order); every block has a
  // barrier of its own (and one a warp), which a thread leaves for good when
  // its body returns (so a thread that returned early does not hold the
  // others), and a second barrier keeps any thread from starting the next
  // block, whose "shared" arrays are the same static storage, before all
  // have left this one
  const int nt = block.x * block.y * block.z;
  const int nw = (nt + 31) / 32;
  const size_t n_blocks = (size_t)grid.x * grid.y * grid.z;
  std::vector<std::unique_ptr<SpinBarrier>> bars, wbars;
  for (size_t b = 0; b < n_blocks; ++b) {
    bars.push_back(std::make_unique<SpinBarrier>(nt));
    for (int w = 0; w < nw; ++w) wbars.push_back(std::make_unique<SpinBarrier>(std::min(32, nt - 32 * w)));
  }
  std::vector<WarpExchange> xs(nw);
  SpinBarrier block_done(nt);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t, 0, 0);
      gridDim = grid;
      warp_x = &xs[t / 32];
      for (size_t i = 0; i < n_blocks; ++i) {
        const size_t b = cpu_blocks_reversed ? n_blocks - 1 - i : i;
        blockIdx = dim3(b % grid.x, (b / grid.x) % grid.y, b / ((size_t)grid.x * grid.y));
        block_barrier = bars[b].get();
        warp_barrier = wbars[b * nw + t / 32].get();
        warp_turn = 0;
        body();
        bars[b]->arrive_and_drop();
        warp_barrier->arrive_and_drop();
        block_done.arrive_and_wait();
      }
    });
  for (auto& th : threads) th.join();
}
// csrc/tc_mma.cuh's primitives: tensor-core products executed
// warp-collectively from the 32 lanes' fragments (the PTX ISA's m16n8k8 tf32
// and m16n8k16 bf16 layouts; a TF32 operand is read as its 19 high bits, as
// the hardware reads it, so an unsplit fp32 product keeps ~3 digits),
// cvt.rna.tf32 by rounding the mantissa to 10 bits, ties away from zero, and
// cp.async as a plain copy (commit and wait: no-ops)
#define SELFC_CPU_STANDIN 1
namespace tc {
inline uint32_t tf32_rna(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & ~0x1fffu;   // inf and nan as they are
  return u;
}
inline float tf32_bits(uint32_t u) { u &= ~0x1fffu; float f; std::memcpy(&f, &u, 4); return f; }
inline float bf16_bits(uint32_t u) { u <<= 16; float f; std::memcpy(&f, &u, 4); return f; }
// this lane's four outputs (rows g, g+8; columns 2t, 2t+1) of each m16 x n8
// tile, after every lane has put its fragments in the exchange: a[m][h][k]
// holds row g + 8h of A, b[n][k][c] column 2t + c of B
template <int MT, int NT, int K>
void warp_product(float (&acc)[MT][NT][4], const float (&a)[MT][2][K], const float (&b)[NT][K][2]) {
  for (int m = 0; m < MT; ++m)
    for (int n = 0; n < NT; ++n)
      for (int i = 0; i < 4; ++i) {
        float s = acc[m][n][i];
        for (int k = 0; k < K; ++k) s += a[m][i / 2][k] * b[n][k][i % 2];
        acc[m][n][i] = s;
      }
}
template <int MT, int NT>
void warp_mma_3xtf32(float (&acc)[MT][NT][4], const uint32_t (&ah)[MT][4], const uint32_t (&al)[MT][4], const uint32_t (&bh)[NT][2],
                     const uint32_t (&bl)[NT][2]) {
  static_assert(8 * MT <= 32 && 4 * NT <= 16, "the exchange buffers");
  const int lane = threadIdx.x % 32, turn = warp_turn, g = lane >> 2, t = lane & 3;
  warp_turn ^= 1;
  uint32_t* A = warp_x->a[turn][lane];
  uint32_t* B = warp_x->b[turn][lane];
  for (int m = 0; m < MT; ++m)
    for (int i = 0; i < 4; ++i) A[8 * m + i] = ah[m][i], A[8 * m + 4 + i] = al[m][i];
  for (int n = 0; n < NT; ++n)
    for (int i = 0; i < 2; ++i) B[4 * n + i] = bh[n][i], B[4 * n + 2 + i] = bl[n][i];
  warp_barrier->arrive_and_wait();
  const auto& XA = warp_x->a[turn];
  const auto& XB = warp_x->b[turn];
  // A (16 x 8): element (r, k) in lane (r % 8) * 4 + k % 4, register r / 8 + 2 (k / 4);
  // B (8 x 8): element (k, c) in lane 4c + k % 4, register k / 4; [0] hi, [1] lo
  float a[2][MT][2][8], b[2][NT][8][2];
  for (int p = 0; p < 2; ++p) {
    for (int m = 0; m < MT; ++m)
      for (int h = 0; h < 2; ++h)
        for (int k = 0; k < 8; ++k) a[p][m][h][k] = tf32_bits(XA[g * 4 + k % 4][8 * m + 4 * p + h + 2 * (k / 4)]);
    for (int n = 0; n < NT; ++n)
      for (int k = 0; k < 8; ++k)
        for (int c = 0; c < 2; ++c) b[p][n][k][c] = tf32_bits(XB[4 * (2 * t + c) + k % 4][4 * n + 2 * p + k / 4]);
  }
  // lo*hi, hi*lo, hi*hi, as on the card
  warp_product<MT, NT, 8>(acc, a[1], b[0]);
  warp_product<MT, NT, 8>(acc, a[0], b[1]);
  warp_product<MT, NT, 8>(acc, a[0], b[0]);
}
template <int MT, int NT>
void warp_mma_bf16(float (&acc)[MT][NT][4], const uint32_t (&a)[MT][4], const uint32_t (&b)[NT][2]) {
  static_assert(4 * MT <= 32 && 2 * NT <= 16, "the exchange buffers");
  const int lane = threadIdx.x % 32, turn = warp_turn, g = lane >> 2, t = lane & 3;
  warp_turn ^= 1;
  uint32_t* A = warp_x->a[turn][lane];
  uint32_t* B = warp_x->b[turn][lane];
  for (int m = 0; m < MT; ++m)
    for (int i = 0; i < 4; ++i) A[4 * m + i] = a[m][i];
  for (int n = 0; n < NT; ++n)
    for (int i = 0; i < 2; ++i) B[2 * n + i] = b[n][i];
  warp_barrier->arrive_and_wait();
  const auto& XA = warp_x->a[turn];
  const auto& XB = warp_x->b[turn];
  // A (16 x 16): element (r, k) in lane (r % 8) * 4 + (k % 8) / 2, register
  // r / 8 + 2 (k / 8), half k % 2; B (16 x 8): element (k, c) in lane
  // 4c + (k % 8) / 2, register k / 8, half k % 2
  auto half = [](uint32_t u, int k) { return bf16_bits(k % 2 ? u >> 16 : u & 0xffffu); };
  float fa[MT][2][16], fb[NT][16][2];
  for (int m = 0; m < MT; ++m)
    for (int h = 0; h < 2; ++h)
      for (int k = 0; k < 16; ++k) fa[m][h][k] = half(XA[g * 4 + (k % 8) / 2][4 * m + h + 2 * (k / 8)], k);
  for (int n = 0; n < NT; ++n)
    for (int k = 0; k < 16; ++k)
      for (int c = 0; c < 2; ++c) fb[n][k][c] = half(XB[4 * (2 * t + c) + (k % 8) / 2][2 * n + k / 8], k);
  warp_product<MT, NT, 16>(acc, fa, fb);
}
template <int BYTES>
inline void cp_async(void* dst, const void* src, int src_bytes) {
  std::memcpy(dst, src, src_bytes);
  std::memset(static_cast<char*>(dst) + src_bytes, 0, BYTES - src_bytes);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
}  // namespace tc
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


def build_cpu_libraries(names, out_dir: Path, csrc_dir: Path = build.CSRC_DIR) -> dict[str, Path]:
    """Compile ``<csrc_dir>/<name>.cu`` for the CPU into ``out_dir``, one
    ``g++`` a source, side by side; the headers ``<csrc_dir>/*.cuh`` are
    rewritten beside them (a header may launch a kernel too). Returns {name:
    library}."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the CUDA sources cannot be rehearsed on the CPU")
    out_dir, csrc_dir = Path(out_dir), Path(csrc_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out_dir / "cuda_bf16.h").write_text(CUDA_BF16_H)
    for header in csrc_dir.glob("*.cuh"):
        (out_dir / header.name).write_text(rewrite_launches(header.read_text())[0])
    procs = {}
    for name in names:
        text, n = rewrite_launches((csrc_dir / f"{name}.cu").read_text())
        if n == 0:
            raise RuntimeError(f"{name}.cu: no kernel launch found to rewrite")
        cpp, lib = out_dir / f"{name}.cpp", out_dir / f"lib{name}_cpu.so"
        cpp.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-fPIC", "-shared", f"-I{out_dir}", "-o", str(lib),
             str(cpp), "-lpthread"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures = []
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"g++ failed for {name}:\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: lib for name, (lib, _) in procs.items()}


@contextlib.contextmanager
def cpu_kernels(out_dir: Path, csrc_dir: Path = build.CSRC_DIR, names=None):
    """Inside, the launch functions of ``ops.dense_chain`` (``_chain_cuda``,
    ``_feats_cuda``, ``_bwd_cuda``), ``ops.deform`` (``_forward_cuda``,
    ``_backward_cuda``), ``ops.temporal_conv`` (``_forward_cuda``,
    ``_data_grad_cuda``) and ``ops.chain_variants`` (``_hg_cuda``,
    ``_ride_cuda``, ``_v3_cuda``) run the CPU builds of the CUDA sources on CPU
    tensors. The public wrappers still take their plain versions for a CPU
    tensor: call the launch functions directly. ``csrc_dir``: the sources
    to build (a mutated copy of ``csrc/``); ``names``: which of them
    (default all). On leaving, each library in use before is put back."""
    names = build.kernel_names() if names is None else list(names)
    libs = build_cpu_libraries(names, out_dir, csrc_dir)
    streams = dc._stream, tc._stream, cv._stream
    before = {n: build.in_use(n) for n in names}
    dc._stream = tc._stream = cv._stream = lambda x: None
    try:
        for n, lib in libs.items():
            build.use_library(n, lib)
        yield
    finally:
        dc._stream, tc._stream, cv._stream = streams
        for n, lib in before.items():
            build.use_library(n, lib)


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


def rehearse_bwd(shape, widths, dtypes=(torch.float32, torch.bfloat16), stripe_w=0, seed=0) -> list[dict]:
    """B2 alone against the plain adjoint, fed the plain features in the
    kernels' layout and a gradient whose pad lanes hold noise; call inside
    ``cpu_kernels()``. ``widths``: (C, gc). One record a case: the errors
    relative to max |plain| of dx, dW and db, and whether a second run gives
    the same bits."""
    rng = np.random.default_rng(seed)
    sw = {"stripe_w": stripe_w}
    out = []
    for dtype in dtypes:
        for C, gc in widths:
            x, ws, bs, *_ = make_chain(rng, C, 3, shape, "cpu", dtype, gc)
            feats = dc.padded_width(dc.chain_feats_plain(x, ws, bs, **sw), gc, dc.padded_gc(gc))
            g = torch.from_numpy(rng.normal(0, 1, feats.shape).astype(np.float32))
            dx0 = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
            want = dc.chain_spatial_bwd_plain(x, ws, bs, feats, g.to(dtype), dx0, **sw)
            runs = []
            for _ in range(2):
                dx = dx0.clone()
                dws, dbs = dc._bwd_cuda(x, ws, bs, feats, g.to(dtype).to(torch.float32, copy=True), dx, **sw)
                runs.append([dx, *dws, *dbs])
            rec = {"kernel": "chain_bwd", "dtype": str(dtype).split(".")[-1], "C": C, "gc": gc, "stripe_w": stripe_w,
                   "dx": rel_err(runs[0][0], want[0]),
                   "dw": max(rel_err(u, v) for u, v in zip(runs[0][1:5], want[1])),
                   "db": max(rel_err(u, v) for u, v in zip(runs[0][5:], want[2])),
                   "same_bits": all(torch.equal(u, v) for u, v in zip(*runs))}
            out.append(rec)
    return out


@contextlib.contextmanager
def blocks_reversed(name):
    """Inside, the CPU build of ``csrc/<name>.cu`` (in use: call inside
    ``cpu_kernels()``) walks every grid's blocks last first."""
    fn = build.load(name).selfc_cpu_reverse_blocks
    fn.argtypes = [ctypes.c_int]
    fn(1)
    try:
        yield
    finally:
        fn(0)


# (N, H, W, C, Cout) of the deformable conv: odd sizes, the JAX package's
# kernel test shape, the de-artifact width, C / Cout over one 32-channel slab,
# C not a multiple of the mma's K step (8 in fp32, 16 in bf16), the STP prior's 64
DEFORM_CASES = ((2, 13, 21, 5, 3), (2, 12, 16, 8, 8), (1, 9, 11, 32, 32), (1, 7, 6, 40, 36), (1, 5, 9, 12, 7),
                (1, 5, 6, 64, 64))


def rehearse_deform(cases=DEFORM_CASES, dtypes=(torch.float32, torch.bfloat16), seed=0,
                    all_to_one=False, g_scale=1.0) -> list[dict]:
    """The deformable conv's kernels against its plain versions (offsets
    uniform in +-7 px, so taps leave the frame; the mask in [0, 2]); call
    inside ``cpu_kernels()``. ``all_to_one``: every tap of every pixel
    samples next to one pixel (``deform_all_to_one``), whose dx takes
    9 N H W contributions. ``g_scale`` scales the output gradient. One
    record a case: the errors relative to max |plain| of the forward and of
    each gradient, whether dweight is the same bits twice and whether all
    four gradients are when the second run walks the blocks in reverse order."""
    rng = np.random.default_rng(seed)
    out = []
    for dtype in dtypes:
        for N, H, W, C, c_out in cases:
            x, off, mask, w, g = make_deform(rng, (N, H, W), C, c_out, "cpu", dtype)
            if all_to_one:
                off = deform_all_to_one((N, H, W), (H // 2, W // 2)).to(dtype)
            g = (g.float() * g_scale).to(dtype)
            rec = {"kernel": "deform", "dtype": str(dtype).split(".")[-1], "shape": [N, H, W], "C": C, "c_out": c_out,
                   "all_to_one": all_to_one}
            rec["forward"] = rel_err(df._forward_cuda(x, off, mask, w), df.deform_conv2d_plain(x, off, mask, w))
            got = df._backward_cuda(x, off, mask, w, g)
            want = df.deform_conv2d_bwd_plain(x, off, mask, w, g)
            for name, u, v in zip(("dx", "doffset", "dmask", "dweight"), got, want):
                rec[name] = rel_err(u, v)
            with blocks_reversed("deform"):
                again = df._backward_cuda(x, off, mask, w, g)
            rec["dweight_same_bits"] = torch.equal(got[3], again[3])
            rec["same_bits_blocks_reversed"] = all(torch.equal(u, v) for u, v in zip(got, again))
            out.append(rec)
    return out


# (B, T, H, W, C, Co) of the temporal conv: a ragged H*W (35) and T 3, T 1
# (both neighbour taps in the padding), C and Co not multiples of the 16-channel
# slab or the 64-column tile, over one tile each, and Co 3
TEMPORAL_CASES = ((1, 3, 5, 7, 9, 5), (2, 1, 4, 3, 6, 3), (1, 4, 3, 23, 37, 70), (2, 3, 2, 9, 19, 3))
# the tile paths, each forced through the SM count the plan is given (a count
# above the tiles splits K): (B, T, H, W, C, Co, sm_count). Narrow at Co 3 and
# 16, wide at 70, unsplit and split; an odd C (131, the D2DLT families'
# conv5: 4-byte fp32 copies, 2-byte bf16); a ragged M (pixels that fill no
# tile, T 7); T over the wide tile's 128 rows and over the narrow tile's 256
# (runs of frames, with the frames beside them staged)
TEMPORAL_PATH_CASES = {
    "narrow": (1, 3, 5, 7, 40, 3, 1), "narrow16": (1, 3, 4, 7, 40, 16, 1), "wide": (1, 3, 5, 7, 40, 70, 1),
    "narrow_split": (1, 3, 5, 7, 70, 3, 10**6), "wide_split": (2, 3, 4, 5, 70, 70, 10**6),
    "odd_c": (1, 3, 3, 5, 131, 48, 10**6), "ragged_m": (1, 7, 5, 5, 19, 20, 1),
    "t_over_wide_tile": (1, 131, 1, 2, 12, 20, 1), "t_over_narrow_tile": (1, 260, 1, 2, 12, 3, 1)}


def rehearse_temporal_conv(cases=TEMPORAL_CASES, dtypes=(torch.float32, torch.bfloat16),
                           slopes=(None, 0.2, 0.0), seed=0) -> list[dict]:
    """The temporal conv's kernel against its plain version, forward at each
    slope (with the mask it writes at slope 0) and the data-gradient launch
    (the kernel with the flipped weights, no bias); call inside
    ``cpu_kernels()``. A case may end in the SM count the launches plan for
    (default an H100's). One record a case: the errors relative to max
    |plain|, whether the mask is the plain one, the forward's (path, split)
    and whether it gives the same bits twice."""
    rng = np.random.default_rng(seed)
    out = []
    for dtype in dtypes:
        for B, T, H, W, C, co, *sms in cases:
            sm = sms[0] if sms else None
            mk = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dtype)  # noqa: E731
            x, w, b, dy = mk(B, T, H, W, C), mk(3, C, co) * (3 * C) ** -0.5, mk(co) * 0.1, mk(B, T, H, W, co)
            rec = {"kernel": "temporal_conv", "dtype": str(dtype).split(".")[-1], "shape": [B, T, H, W],
                   "C": C, "c_out": co,
                   "path": list(tc.plan(B, T, H * W, C, co, x.element_size(), sm or tc.H100_SMS))}
            for ns in slopes:
                got, mask = tc._forward_cuda(x, w, b, ns, ns is not None and ns <= 0, sm)
                want, want_mask = tc._plain(x, w, b, ns)
                rec[f"forward_slope_{ns}"] = rel_err(got, want)
                if mask is not None:
                    # a mask bit may differ only where the two sums straddle 0
                    rec["mask_same"] = bool(torch.equal(mask, want_mask) or
                                            (want[mask != want_mask].float().abs().max() < 1e-5).item())
            rec["same_bits"] = torch.equal(got, tc._forward_cuda(x, w, b, ns, False, sm)[0])
            rec["dx"] = rel_err(tc._data_grad_cuda(dy, w, sm), tc.temporal_conv3_fused_plain(dy, tc._flipped(w)))
            out.append(rec)
    return out


# (C, c_out, gc) of the variants: the 4x net's H/G pair and its F chain, the
# codec's pair (c_out 12) and F chain, its prior at gc 12; c_out 6 and 10 (the
# widest ride), odd widths
HG_WIDTHS = ((3, 48, 32), (3, 12, 32), (5, 7, 13), (4, 12, 20))
RIDE_WIDTHS = ((48, 3, 32), (12, 3, 32), (6, 6, 16), (5, 10, 13), (9, 3, 24))
V3_WIDTHS = ((3, 64, 32), (64, 64, 32), (24, 24, 12), (3, 24, 12), (32, 3, 32), (5, 7, 20))
# B8 where the earlier design refused (C + 3 gc > 526: its halo tile held every
# input channel), at conv5's narrow 16-column tile
V3_WIDE_C = ((440, 16, 32),)


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


# B2 alone: (packed shape, stripe_w) with image edges where a fragment's
# 8-pixel halves start (stripe 8: columns 0 and 8 of a 16-wide tile; stripe
# 24: column 8) and (C, gc) at growth 32, 12 and 13 (16-lane segments; 13
# stages its weight rows element by element)
BWD_STRIPE_CASES = (((1, 2, 7, 48), 8), ((1, 2, 9, 48), 24))
BWD_WIDTHS = ((3, 32), (24, 12), (5, 13))


# the low part of the 3xTF32 splits (split_tf32, split_tf32_fast);
# one_tf32_pass_sources() zeroes both
SPLIT_LO = ("  lo = tf32_rna(v - __uint_as_float(hi));\n", "  lo = __float_as_uint(v - __uint_as_float(hi));\n")


def one_tf32_pass_sources(dst: Path) -> Path:
    """A copy of ``csrc/`` in ``dst`` whose products keep one TF32 pass of
    the three (each operand's low part zeroed in ``split_tf32`` and
    ``split_tf32_fast``): the precision the fp32 kernels would have without
    the split."""
    dst = Path(dst)
    shutil.copytree(build.CSRC_DIR, dst, dirs_exist_ok=True)
    header = (dst / "tc_mma.cuh").read_text()
    for lo in SPLIT_LO:
        if header.count(lo) != 1:
            raise RuntimeError(f"tc_mma.cuh no longer holds exactly one {lo!r}")
        header = header.replace(lo, "  lo = 0u;\n")
    (dst / "tc_mma.cuh").write_text(header)
    return dst


TF32_SPLIT_CPP = r"""
#include <cstring>
#include "cuda_runtime.h"
#include "tc_mma.cuh"
extern "C" void tf32_split(const float* a, float* hi, float* lo, int n) {
  for (int i = 0; i < n; ++i) {
    uint32_t h, l;
    tc::split_tf32(a[i], h, l);
    std::memcpy(&hi[i], &h, 4);
    std::memcpy(&lo[i], &l, 4);
  }
}
"""


def tf32_split(values, out_dir: Path):
    """``(hi, lo)``: the 3xTF32 split of ``csrc/tc_mma.cuh`` (``split_tf32``)
    of a float32 array, compiled by g++ with the stand-in ``cvt.rna.tf32``
    into ``out_dir``."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the split cannot be compiled for the CPU")
    out_dir = Path(out_dir)
    (out_dir / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out_dir / "cuda_bf16.h").write_text(CUDA_BF16_H)
    (out_dir / "tf32_split.cpp").write_text(TF32_SPLIT_CPP)
    lib = out_dir / "libtf32_split.so"
    res = subprocess.run([gxx, "-std=c++20", "-O2", "-fPIC", "-shared", f"-I{out_dir}", f"-I{build.CSRC_DIR}",
                          "-o", str(lib), str(out_dir / "tf32_split.cpp"), "-lpthread"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for the split:\n{res.stderr}")
    fn = ctypes.CDLL(str(lib)).tf32_split
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    a = np.ascontiguousarray(values, np.float32)
    hi, lo = np.empty_like(a), np.empty_like(a)
    fn(a.ctypes.data, hi.ctypes.data, lo.ctypes.data, a.size)
    return hi, lo


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp, cpu_kernels(Path(tmp)), torch.no_grad():
        records = (rehearse() + rehearse_deform() + rehearse_deform(((2, 6, 7, 5, 3),), all_to_one=True)
                   + rehearse_deform(((1, 6, 7, 8, 8),), (torch.float32,), g_scale=1e20) + rehearse_temporal_conv()
                   + rehearse_temporal_conv(tuple(TEMPORAL_PATH_CASES.values()))
                   + rehearse_variants() + rehearse_variants((1, 2, 9, 16), hg_widths=(), ride_widths=(),
                                                             v3_widths=V3_WIDE_C))
        for shape, stripe_w in STRIPE_CASES:
            records += rehearse(shape, STRIPE_WIDTHS, stripe_w=stripe_w)
        for shape, stripe_w in BWD_STRIPE_CASES:
            records += rehearse_bwd(shape, BWD_WIDTHS, stripe_w=stripe_w)
    for rec in records:
        print(json.dumps(rec), flush=True)
        limit = 1e-5 if rec["dtype"] == "float32" else 3e-2
        bad = {k: v for k, v in rec.items() if isinstance(v, float) and not v <= limit}
        for flag in ("dweight_same_bits", "same_bits_blocks_reversed", "mask_same", "same_bits"):
            if rec.get(flag) is False:
                bad[flag] = False
        if bad:
            print(f"cpu_rehearsal: FAILED {rec}: {bad}", file=sys.stderr)
            return 1
    print(json.dumps({"ok": True, "cases": len(records), "device": "cpu (CUDA sources compiled by g++)"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
