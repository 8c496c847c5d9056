// The standalone (3,1,1) temporal convolution for Hopper (sm_90a), with its
// bias and an optional LeakyReLU fused into the epilogue.
//
// Replaces selfc_tpu/ops/pallas_kernels.py:_kernel (reached there through
// _tc3_impl and temporal_conv3_pallas). The function, channels-last, zero
// padding in T:
//
//   out[b][t][s][n] = act( bias[n] + sum_{k=0..2} sum_c x[b][t+k-1][s][c] * w[k][c][n] )
//
// x (B,T,S,C) with S = H*W, w (3,C,Co) read as one (3C, Co) matrix, bias (Co)
// or none, out (B,T,S,Co); act is LeakyReLU(negative_slope) or the identity.
// As a product: M = B*T*S rows, N = Co, K = 3C. The data gradient is this
// function again: dx = temporal_conv3(dy, [w2^T, w1^T, w0^T]) with no bias
// (the wrapper passes the flipped, transposed weights).
//
// What bounds it on this card: operations at the widths the nets give it (C
// 131..1152, Co 48..768: 2 * 3C * Co operations a row against (C + Co) * 4
// bytes; at 3xTF32's 495 / 3 TFLOP/s, bytes at 131 -> 48 too), bytes at
// Co = 3 (reading x once: 0.038 ms at the serving latent's 176 channels,
// NVIDIA H100 80GB HBM3). Measured (tools/tc_attribution.py), the mma.sync
// issue sets the pace at the wide rows; at Co = 3 the staging does.
//
// The design before this one (plain fp32 FMAs from 4 x 4 register
// tiles, one 64 x 64 output tile for every width, scalar staging transposed
// into shared memory, nothing overlapped) took, on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py's timing_temporal rows): serve 131->48 0.416 ms, 176->3
// 0.494, serve/4 432->768 0.933, 1152->48 0.383; train 131->48 0.197 (dx
// 0.209), 176->3 0.232 (dx 0.090), train/4 432->768 0.415 (dx 0.446),
// 1152->48 0.250 (dx 0.088). At Co = 3, 61 of 64 columns did idle FMAs.
//
// This design (csrc/tc_mma.cuh, tc::tconv_block): tensor-core products
// (3xTF32 for fp32, bf16 mma for bf16) fed by a 3-stage cp.async ring. A
// block owns P pixels x all T frames of a clip, frames fastest, so the three
// taps are shifts of one staged tile by a row and x is read from device
// memory once; the taps beyond the clip read a zero row. The tile is chosen
// from Co and M at launch (the wrapper's plan):
//  - narrow, Co <= 16: 256 rows x one or two n8 columns, 8 warps, so every
//    staged byte of x feeds all of N;
//  - wide, Co > 16: 128 rows x 64 columns (or 48, where that pads Co less),
//    8 warps of 32 x 32 (32 x 24);
//  - split-K where the tiles do not fill the SMs: the K slabs are cut in
//    `split` parts over blockIdx.y, each writes fp32 partial sums, and a
//    second pass adds them in a fixed order and applies the epilogue (no
//    atomics: a step repeats bit for bit).
// Rows of x that are not 16-byte aligned (C % 4 != 0 in fp32, C % 8 != 0 in
// bf16) are copied one element at a time, 4 bytes (cp.async) or 2 (a plain
// load and store: cp.async copies 4, 8 or 16), a template flag; every B, T,
// S, C and Co is taken.
//
// The epilogue adds the bias and applies the LeakyReLU on the fp32
// accumulator; with a non-null mask it also writes mask = (acc >= 0), which
// the backward needs at a slope <= 0 (the output cannot tell it there).
//
// fp32 and bf16 in and out (x, w, bias and out in one type), fp32
// accumulation. Plain C interface (loaded with ctypes); the caller owns every
// buffer, the split-K scratch included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace {

template <typename T, class Tile, int VA>
__global__ void __launch_bounds__(Tile::THREADS, 2) temporal_conv3_kernel(tc::TconvArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  tc::tconv_block<T, Tile, VA>(p, reinterpret_cast<unsigned char*>(dyn_smem));
}

// out = act(bias + sum over the split's parts of partial), in a fixed order
template <typename T>
__global__ void __launch_bounds__(256) split_reduce_kernel(const float* partial, const T* bias, T* out, uint8_t* mask, long long n, int Co,
                                                           int split, int act, float slope) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < split; ++s) v += partial[s * n + i];
  if (bias) v += tc::to_f(bias[i % Co]);
  if (mask) mask[i] = v >= 0.f ? 1 : 0;
  if (act && !(v >= 0.f)) v *= slope;
  tc::from_f(v, out + i);
}

template <typename T, class Tile, int VA>
int launch_tile(tc::TconvArgs<T> p, cudaStream_t stream) {
  tc::tconv_tiling(p.Tlen, Tile::BM, p.TT, p.P, p.halo);
  p.tiles_n = (p.Co + Tile::BN - 1) / Tile::BN;
  p.tiles_s = (p.S + p.P - 1) / p.P;
  p.tiles_t = (p.Tlen + p.TT - 1) / p.TT;
  const long long blocks = (long long)p.B * p.tiles_t * p.tiles_s * p.tiles_n;
  if (blocks > 0x7fffffffLL || p.split > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(temporal_conv3_kernel<T, Tile, VA>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, (unsigned)p.split);
  temporal_conv3_kernel<T, Tile, VA><<<grid, Tile::THREADS, Tile::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int VA>
int launch_path(const tc::TconvArgs<T>& p, int path, cudaStream_t stream) {
  if (path == 1) return tc::wide48(p.Co) ? launch_tile<T, tc::TileWide48, VA>(p, stream) : launch_tile<T, tc::TileWide, VA>(p, stream);
  if (p.Co <= 8) return launch_tile<T, tc::TileNarrow8, VA>(p, stream);
  return launch_tile<T, tc::TileNarrow16, VA>(p, stream);
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, void* mask, void* scratch, int B, int T_len, int S, int C, int Co,
           int act, float slope, int path, int split, cudaStream_t stream) {
  tc::TconvArgs<T> p{};
  p.src[0] = (const T*)x;
  p.src[1] = (const T*)x;
  p.ch[0] = C;
  p.ch[1] = 0;
  p.w = (const T*)w;
  p.bias = (const T*)bias;
  p.out = (T*)out;
  p.mask = split > 1 ? nullptr : (uint8_t*)mask;
  p.partial = split > 1 ? (float*)scratch : nullptr;
  p.B = B, p.Tlen = T_len, p.S = S, p.Co = Co;
  p.split = split;
  p.act = split > 1 ? 0 : act;
  p.slope = slope;
  p.w_vec = tc::rows_aligned16(w, (size_t)Co * sizeof(T));
  // 16-byte copies where every row allows them, else one element a copy
  const int err = tc::rows_aligned16(x, (size_t)C * sizeof(T)) ? launch_path<T, 16>(p, path, stream)
                                                                : launch_path<T, (int)sizeof(T)>(p, path, stream);
  if (err != 0 || split == 1) return err;
  const long long n = (long long)B * T_len * S * Co;
  split_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>((const float*)scratch, (const T*)bias, (T*)out, (uint8_t*)mask, n,
                                                                          Co, split, act, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of x, w, bias and out. Shapes:
// x (B,T,S,C), w (3,C,Co), bias (Co) or null, out (B,T,S,Co), mask (B,T,S,Co)
// bytes or null. act: 0 = none, 1 = LeakyReLU with negative slope ``slope``.
// path: 0 = narrow (Co <= 16), 1 = wide; split: parts of K (>= 1, at most
// the ceil(C / slab) slabs), scratch (split, B*T*S, Co) fp32 when split > 1.
extern "C" int selfc_temporal_conv3(const void* x, const void* w, const void* bias, void* out, void* mask, void* scratch, int B, int T,
                                    int S, int C, int Co, int act, float slope, int dtype, int path, int split, void* stream) {
  const long long M = (long long)B * T * S;
  const int bk = dtype == 1 ? tc::Elem<__nv_bfloat16>::BK : tc::Elem<float>::BK;
  if (M < 1 || T < 1 || S < 1 || C < 1 || Co < 1 || (path != 0 && path != 1) || (path == 0 && Co > 16) || split < 1 ||
      split > (C + bk - 1) / bk || (split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, bias, out, mask, scratch, B, T, S, C, Co, act, slope, path, split, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, bias, out, mask, scratch, B, T, S, C, Co, act, slope, path, split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* selfc_temporal_conv3_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
