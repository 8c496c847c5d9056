// The dense chain with the taps folded into the contraction, for Hopper
// (sm_90a): the D2DT chain without an epilogue (the STP prior's chains, the
// de-artifact net's, a ResD2DT block's).
//
// Replaces selfc_tpu/ops/pallas_chain.py:_chain_kernel_v3 (reached through
// _pallas_impl_v3, with _prep_weight_packed and _pick_pack_depth). It
// computes what csrc/dense_chain.cu (B1) computes with the epilogue "none":
//
//   x_k = lrelu(conv3x3([x | x_1 .. x_{k-1}]) + b_k),  k = 1..4
//   y5  = temporal_conv3([x | x_1..x_4], w5) + b5       (zero pad in T)
//
// What the TPU kernel does: it folds the three kernel rows of the early
// convs into the contraction, one dot with K = 3*K_i where v2 makes three.
// The Hopper counterpart: every layer is one implicit GEMM whose contraction
// walks all nine taps and every input channel, K = 9 * Cin_k, in the order
// of the weight's own layout ((3,3,Cin,gc) flattened is the (9*Cin, gc) B
// operand, read in contiguous 16-row chunks). Its A operand is one halo tile
// of all Cin_k channels, staged once in (dynamic) shared memory; B1 instead
// walks the taps in an inner loop around 16-channel slabs it stages one
// after the other. conv5 is the same walk over K = 3 * (C + 4 gc) (the taps
// in T, each of w5's (3, C+4gc, c_out) rows a K row), skipping the taps that
// lie outside the clip. The feats buffer holds the four growth segments at
// their true width, (frames, H, W, 4*gc): the staging gathers the real
// channels only, so no weight row is remapped.
//
// Bound: arithmetic, as B1. The contraction runs as plain fp32 FMAs from an
// 8 pixel x 8 channel register tile; filling that K with tensor cores
// (mma.sync / wgmma) is the next step. bf16 is widened on staging and
// rounded once on store. Any B, T, H, W, C with C + 3 gc <= 526 (the halo
// tile of one row must fit: selfc_chain_v3_tile_rows); growth width 1..32.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int GC_MAX = 32;
constexpr int KC = 16;            // K rows of B staged per step
constexpr int TW = 16;            // spatial tile: 16 columns ...
constexpr int HW_ = TW + 2;       // ... and its halo width
constexpr int SMEM_BUDGET = 113 * 1024;  // two blocks an SM
constexpr int NT5 = 128;          // threads of a conv5 block
constexpr int CO5 = 64;           // conv5: most output channels a block handles
constexpr float SLOPE = 0.2f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

// Rows of the spatial tile (16, 8, 4, 2 or 1) for Cin input channels: the
// most whose halo tile and weight chunk fit the budget; 0 if none does.
inline int tile_rows(int cin) {
  for (int th = 16; th >= 1; th /= 2)
    if ((size_t)cin * (th + 2) * HW_ * 4 + KC * GC_MAX * 4 <= (size_t)SMEM_BUDGET) return th;
  return 0;
}

// One spatial layer: feats[..., gc*layer : gc*(layer+1)] =
//   lrelu(sum_{tap, c} tile(c, shifted by tap) * w[tap][c] + b).
// grid = (ceil(W/16), ceil(H/th), frames), block = th*2*(GCP/8) threads.
// Thread (pg, cg): tile row pg/2, columns 8*(pg%2) .. +7, output channels
// 8*cg .. +7 (lanes >= gc meet zero weights and are not stored).
// Shared memory: in_s [cin][th+2][18] fp32 (the halo tile, zero outside the
// image), then w_s [KC][GCP].
template <typename T, int GCP>
__global__ void __launch_bounds__(2 * 16 * GCP / 8) v3_spatial_kernel(const T* x, T* feats, const T* w, const T* b, int H, int W, int C, int gc, int layer, int th) {
  extern __shared__ __align__(16) float dyn_smem[];
  constexpr int NCG = GCP / 8;
  const int nt = th * 2 * NCG;
  const int cin = C + gc * layer;
  const int fc = 4 * gc;
  float* in_s = dyn_smem;
  float* w_s = dyn_smem + (size_t)cin * (th + 2) * HW_;

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int row = pg >> 1;
  const int cb = (pg & 1) * 8;
  const int tx0 = blockIdx.x * TW;
  const int ty0 = blockIdx.y * th;
  const size_t frame = blockIdx.z;
  const T* xf = x + frame * H * W * C;
  T* ff = feats + frame * H * W * fc;

  // the halo tile of every input channel, once: consecutive threads take
  // consecutive channels of a pixel
  const int npix = (th + 2) * HW_;
  for (int idx = tid; idx < npix * cin; idx += nt) {
    const int c = idx % cin;
    const int pix = idx / cin;
    const int iy = ty0 - 1 + pix / HW_;
    const int ix = tx0 - 1 + pix % HW_;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      const size_t p = (size_t)iy * W + ix;
      v = c < C ? to_f(xf[p * C + c]) : to_f(ff[p * fc + (c - C)]);
    }
    in_s[(size_t)c * npix + pix] = v;
  }

  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int co = cg * 8 + q;
    const float bias = co < gc ? to_f(b[co]) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][q] = bias;
  }

  const int K = 9 * cin;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();  // the tile is staged; the previous chunk is consumed
    for (int idx = tid; idx < KC * GCP; idx += nt) {
      const int co = idx % GCP;
      const int kk = idx / GCP;
      w_s[idx] = kk < kc && co < gc ? to_f(w[(size_t)(k0 + kk) * gc + co]) : 0.f;
    }
    __syncthreads();
    int tap = k0 / cin;
    int c = k0 - tap * cin;
    for (int kk = 0; kk < kc; ++kk) {
      const int dy = tap / 3, dx = tap - 3 * (tap / 3);
      const float* ip = in_s + (size_t)c * npix + (row + dy) * HW_ + cb + dx;
      float in[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) in[j] = ip[j];
      const float4 wa = *reinterpret_cast<const float4*>(&w_s[kk * GCP + cg * 8]);
      const float4 wb = *reinterpret_cast<const float4*>(&w_s[kk * GCP + cg * 8 + 4]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = in[j];
        acc[j][0] = fmaf(v, wa.x, acc[j][0]);
        acc[j][1] = fmaf(v, wa.y, acc[j][1]);
        acc[j][2] = fmaf(v, wa.z, acc[j][2]);
        acc[j][3] = fmaf(v, wa.w, acc[j][3]);
        acc[j][4] = fmaf(v, wb.x, acc[j][4]);
        acc[j][5] = fmaf(v, wb.y, acc[j][5]);
        acc[j][6] = fmaf(v, wb.z, acc[j][6]);
        acc[j][7] = fmaf(v, wb.w, acc[j][7]);
      }
      if (++c == cin) {
        c = 0;
        ++tap;
      }
    }
  }

  const int oy = ty0 + row;
  if (oy >= H) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ox = tx0 + cb + j;
    if (ox < W) {
      T* o = ff + ((size_t)oy * W + ox) * fc + gc * layer;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int co = cg * 8 + q;
        const float v = acc[j][q];
        if (co < gc) from_f(v >= 0.f ? v : SLOPE * v, o + co);
      }
    }
  }
}

// conv5: out(t) = b5 + sum over K rows k = dt * ctot + c of
// [x | feats](t + dt - 1, c) * w5[k], the rows of taps outside the clip
// skipped. grid = (ceil(HW / (4*npg)), ceil(c_out / 64), frames), block =
// npg*ng threads; thread (pg, cg): pixels pg + j*npg (j < 4), output
// channels co_base + 8*cg .. +7. A_s [KC][4*npg] and B_s [KC][64] are
// staged a chunk of K at a time.
template <typename T>
__global__ void __launch_bounds__(NT5) v3_conv5_kernel(const T* x, const T* feats, const T* w5, const T* b5, T* out, int Tn, int HW, int C, int gc, int c_out, int ng, int npg) {
  constexpr int P = 4;
  __shared__ float a_s[KC][NT5 * P];
  __shared__ __align__(16) float b_s[KC][CO5];

  const int tid = threadIdx.x;
  const int nthreads = ng * npg;
  const int cg = tid % ng;
  const int pg = tid / ng;
  const int mt = npg * P;
  const int pix0 = blockIdx.x * mt;
  const int co_base = blockIdx.y * CO5;
  const int nco = ng * 8;
  const size_t frame = blockIdx.z;
  const int t = (int)(frame % Tn);
  const int fc = 4 * gc;
  const int ctot = C + fc;
  const int kbeg = t == 0 ? ctot : 0;
  const int kend = t == Tn - 1 ? 2 * ctot : 3 * ctot;

  float acc[P][8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int co = co_base + cg * 8 + q;
    const float bias = co < c_out ? to_f(b5[co]) : 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) acc[j][q] = bias;
  }

  for (int k0 = kbeg; k0 < kend; k0 += KC) {
    const int kc = min(KC, kend - k0);
    __syncthreads();
    for (int idx = tid; idx < KC * mt; idx += nthreads) {
      const int kk = idx % KC;
      const int lp = idx / KC;
      const int k = k0 + kk;
      const int gp = pix0 + lp;
      float v = 0.f;
      if (kk < kc && gp < HW) {
        const int dt = k / ctot;
        const int c = k - dt * ctot;
        const size_t p = (frame + dt - 1) * HW + gp;
        v = c < C ? to_f(x[p * C + c]) : to_f(feats[p * fc + (c - C)]);
      }
      a_s[kk][lp] = v;
    }
    for (int idx = tid; idx < KC * nco; idx += nthreads) {
      const int col = idx % nco;
      const int kk = idx / nco;
      const int co = co_base + col;
      b_s[kk][col] = kk < kc && co < c_out ? to_f(w5[(size_t)(k0 + kk) * c_out + co]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const float4 wa = *reinterpret_cast<const float4*>(&b_s[kk][cg * 8]);
      const float4 wb = *reinterpret_cast<const float4*>(&b_s[kk][cg * 8 + 4]);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float v = a_s[kk][pg + j * npg];
        acc[j][0] = fmaf(v, wa.x, acc[j][0]);
        acc[j][1] = fmaf(v, wa.y, acc[j][1]);
        acc[j][2] = fmaf(v, wa.z, acc[j][2]);
        acc[j][3] = fmaf(v, wa.w, acc[j][3]);
        acc[j][4] = fmaf(v, wb.x, acc[j][4]);
        acc[j][5] = fmaf(v, wb.y, acc[j][5]);
        acc[j][6] = fmaf(v, wb.z, acc[j][6]);
        acc[j][7] = fmaf(v, wb.w, acc[j][7]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int gp = pix0 + pg + j * npg;
    if (gp < HW) {
      const size_t o = (frame * HW + gp) * c_out;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int co = co_base + cg * 8 + q;
        if (co < c_out) from_f(acc[j][q], out + o + co);
      }
    }
  }
}

template <typename T, int GCP>
int spatial_at(const void* x, void* feats, const void* w, const void* b, int frames, int H, int W, int C, int gc, int layer, cudaStream_t stream) {
  const int cin = C + gc * layer;
  const int th = tile_rows(cin);
  if (th == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)cin * (th + 2) * HW_ + KC * GCP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(v3_spatial_kernel<T, GCP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + th - 1) / th, frames);
  v3_spatial_kernel<T, GCP><<<grid, th * 2 * (GCP / 8), smem, stream>>>((const T*)x, (T*)feats, (const T*)w, (const T*)b, H, W, C, gc, layer, th);
  return (int)cudaGetLastError();
}

template <typename T>
int v3_forward(const void* x, const void* const* ws, const void* const* bs, const void* w5, const void* b5, void* feats, void* out, int frames, int Tn, int H, int W, int C, int gc, int c_out, cudaStream_t stream) {
  if (gc < 1 || gc > GC_MAX) return (int)cudaErrorInvalidValue;
  for (int layer = 0; layer < 4; ++layer) {
    const int err = gc <= 16 ? spatial_at<T, 16>(x, feats, ws[layer], bs[layer], frames, H, W, C, gc, layer, stream)
                             : spatial_at<T, GC_MAX>(x, feats, ws[layer], bs[layer], frames, H, W, C, gc, layer, stream);
    if (err != 0) return err;
  }
  const int co_blk = c_out < CO5 ? c_out : CO5;
  const int ng = (co_blk + 7) / 8;
  int npg = NT5 / ng;
  const int HW = H * W;
  const dim3 grid5((HW + npg * 4 - 1) / (npg * 4), (c_out + CO5 - 1) / CO5, frames);
  v3_conv5_kernel<T><<<grid5, ng * npg, 0, stream>>>((const T*)x, (const T*)feats, (const T*)w5, (const T*)b5, (T*)out, Tn, HW, C, gc, c_out, ng, npg);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor of one call has the same
// type). x (frames,H,W,C); w1..w4 (3,3,C+gc*k,gc); b1..b4 (gc); w5
// (3,C+4*gc,c_out); b5 (c_out); feats (frames,H,W,4*gc) scratch, written (the
// true width: no pad lanes); out (frames,H,W,c_out). frames = B*T with T =
// frames_per_clip; 1 <= gc <= 32; selfc_chain_v3_tile_rows(C + 3*gc) > 0.
// Returns the first cudaError_t a launch reports, 0 when all five were
// accepted.
extern "C" int selfc_chain_v3_forward(const void* x, const void* w1, const void* w2, const void* w3, const void* w4, const void* b1, const void* b2, const void* b3, const void* b4, const void* w5, const void* b5, void* feats, void* out, int frames, int frames_per_clip, int H, int W, int C, int gc, int c_out, int dtype, void* stream) {
  const void* ws[4] = {w1, w2, w3, w4};
  const void* bs[4] = {b1, b2, b3, b4};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return v3_forward<float>(x, ws, bs, w5, b5, feats, out, frames, frames_per_clip, H, W, C, gc, c_out, s);
  if (dtype == 1) return v3_forward<__nv_bfloat16>(x, ws, bs, w5, b5, feats, out, frames, frames_per_clip, H, W, C, gc, c_out, s);
  return (int)cudaErrorInvalidValue;
}

// Rows of the spatial tile for a layer of cin input channels (0: too wide).
extern "C" int selfc_chain_v3_tile_rows(int cin) { return tile_rows(cin); }

extern "C" const char* selfc_v3_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
