// The dense chain with conv5 riding the spatial layers, for Hopper (sm_90a):
// the D2DT chain with any of the seven coupling epilogues, for c_out <= 10.
//
// Replaces selfc_tpu/ops/pallas_chain.py:_chain_kernel_v2r (reached through
// _pallas_impl_v2r, with _prep_weight_ride and _prep_w5_x4). It computes what
// csrc/dense_chain.cu (B1) computes:
//
//   x_k = lrelu(conv3x3([x | x_1 .. x_{k-1}]) + b_k),  k = 1..4
//   y5  = temporal_conv3([x | x_1..x_4], w5) + b5       (zero pad in T)
//   out = the epilogue applied to y5 in fp32
//
// What the TPU kernel does: conv5's output (3 of 128 lanes for the coupling's
// F chain) rides the spatial convs, each feature's temporal-tap products
// added as it is produced, so there is no conv5 pass over the [x | x1..x4]
// concat and x4 is never stored. Here: spatial launch k computes x_k on the
// tensor cores as B1 does (csrc/tc_chain.cuh), then forms the three taps of
// x_k's products with w5 by a second mma product, [tile pixels x GCP] @
// [GCP x 3*c_out] (N padded to 16 or 32), from a copy of the tile's x_k in
// shared memory (launch 1 also adds x's products, from the center-tap
// fragments of each x slab it stages anyway), and adds them into an fp32
// partial buffer of three planes (3, frames, H*W, c_out): plane k holds each
// source frame's product with w5[k]. A pixel at frame t contributes to
// out(t-1), out(t) and out(t+1), which blocks of neighbouring frames also
// produce; one plane a tap makes every entry the work of one lane a launch, so
// no atomics are needed and a step repeats bit for bit. A short last launch
// sums out(t) = b5 + P0(t-1) + P1(t) + P2(t+1) and applies the epilogue. x4
// is never written (the feats buffer holds x1..x3).
//
// Bound: operations, as B1. 3xTF32 mma for fp32, bf16 mma for bf16 (the ride
// product takes x_k as it is stored). Any B, T, H, W, C; growth width 1..32;
// c_out 1..10.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include "tc_chain.cuh"

namespace {

using namespace tc;

constexpr int NFIN = 256;  // threads of a finishing block

// out(f, p, co) = ep(b5 + sum_k plane_k(f + k - 1, p, co)), the planes at
// frames outside the clip taken as zero; one thread an output element.
template <typename T>
__global__ void __launch_bounds__(NFIN) ride_finish_kernel(const float* partial, const T* b5, const T* a, const T* m, T* out, int frames, int Tn, int HW, int c_out, int mode, float clamp) {
  const size_t n = (size_t)frames * HW * c_out;
  const size_t plane = n;  // one plane's elements
  const size_t per_frame = (size_t)HW * c_out;
  for (size_t i = (size_t)blockIdx.x * NFIN + threadIdx.x; i < n; i += (size_t)gridDim.x * NFIN) {
    const int f = (int)(i / per_frame);
    const int t = f % Tn;
    const int co = (int)(i % c_out);
    float y = to_f(b5[co]);
    if (t > 0) y += partial[i - per_frame];
    y += partial[plane + i];
    if (t < Tn - 1) y += partial[2 * plane + i + per_frame];
    const float av = a != nullptr ? to_f(a[i]) : 0.f;
    const float mv = m != nullptr ? to_f(m[i]) : 0.f;
    from_f(ep_apply(y, mode, clamp, av, mv), out + i);
  }
}

template <typename T, int GCP, int NR>
int ride_layers(ChainLayerArgs<T> s, const void* const* ws, const void* const* bs, int frames, cudaStream_t stream) {
  for (int layer = 0; layer < 4; ++layer) {
    s.layer = layer;
    s.w = (const T*)ws[layer];
    s.b = (const T*)bs[layer];
    s.w_vec = rows_aligned16(ws[layer], (size_t)s.gc * sizeof(T));
    s.write_feats = layer < 3;  // x4 only rides
    const int err = launch_chain_layer<T, GCP, false, NR>(s, frames, stream);
    if (err != 0) return err;
  }
  return 0;
}

template <typename T>
int ride_forward(const void* x, const void* const* ws, const void* const* bs, const void* w5, const void* b5, const void* a, const void* m, void* feats, float* partial, void* out, int frames, int Tn, int H, int W, int C, int gc, int c_out, int mode, float clamp, cudaStream_t stream) {
  if (gc < 1 || gc > GC_MAX || c_out < 1 || c_out > RIDE_MAX || frames < 1 || Tn < 1 || frames % Tn != 0 || H < 1 || W < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  const int gcp = padded_gc(gc);
  ChainLayerArgs<T> s{};
  s.x = (const T*)x;
  s.feats = (T*)feats;
  s.H = H;
  s.W = W;
  s.C = C;
  s.gc = gc;
  s.fc = 3 * gcp;
  s.f_vec = 1;   // 3*GCP lanes: every feats row is 16-byte aligned
  s.x_vec = rows_aligned16(x, (size_t)C * sizeof(T));
  s.w5 = (const T*)w5;
  s.partial = partial;
  s.c_out = c_out;
  s.ctot = C + 4 * gc;
  s.frames = frames;
  // the three taps of c_out columns, padded to 16 or 32
  int err;
  if (3 * c_out <= 16)
    err = gcp == 16 ? ride_layers<T, 16, 16>(s, ws, bs, frames, stream) : ride_layers<T, GC_MAX, 16>(s, ws, bs, frames, stream);
  else
    err = gcp == 16 ? ride_layers<T, 16, 32>(s, ws, bs, frames, stream) : ride_layers<T, GC_MAX, 32>(s, ws, bs, frames, stream);
  if (err != 0) return err;
  const size_t n = (size_t)frames * H * W * c_out;
  size_t blocks = (n + NFIN - 1) / NFIN;
  if (blocks > 65535u * 8u) blocks = 65535u * 8u;
  ride_finish_kernel<T><<<(unsigned)blocks, NFIN, 0, stream>>>(partial, (const T*)b5, (const T*)a, (const T*)m, (T*)out, frames, Tn, H * W, c_out, mode, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor but partial of one call has
// the same type); every pointer aligned to 16 bytes. x (frames,H,W,C);
// w1..w4 (3,3,C+gc*k,gc); b1..b4 (gc); w5 (3,C+4*gc,c_out); b5 (c_out);
// a, m (frames,H,W,c_out) or null; feats (frames,H,W,3*GCP) scratch (GCP =
// 16 for gc <= 16, else 32); partial (3,frames,H*W,c_out) fp32 scratch; out
// (frames,H,W,c_out). frames = B*T with T = frames_per_clip; 1 <= gc <= 32;
// 1 <= c_out <= 10. Returns the first cudaError_t a launch reports, 0 when
// all five were accepted.
extern "C" int selfc_chain_ride_forward(const void* x, const void* w1, const void* w2, const void* w3, const void* w4, const void* b1, const void* b2, const void* b3, const void* b4, const void* w5, const void* b5, const void* a, const void* m, void* feats, void* partial, void* out, int frames, int frames_per_clip, int H, int W, int C, int gc, int c_out, int mode, float clamp, int dtype, void* stream) {
  const void* ws[4] = {w1, w2, w3, w4};
  const void* bs[4] = {b1, b2, b3, b4};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return ride_forward<float>(x, ws, bs, w5, b5, a, m, feats, (float*)partial, out, frames, frames_per_clip, H, W, C, gc, c_out, mode, clamp, s);
  if (dtype == 1) return ride_forward<__nv_bfloat16>(x, ws, bs, w5, b5, a, m, feats, (float*)partial, out, frames, frames_per_clip, H, W, C, gc, c_out, mode, clamp, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int selfc_chain_ride_padded_gc(int gc) { return tc::padded_gc(gc); }

extern "C" int selfc_chain_ride_max_c_out() { return tc::RIDE_MAX; }

extern "C" const char* selfc_ride_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
