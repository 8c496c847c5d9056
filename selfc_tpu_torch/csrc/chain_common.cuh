// The H/G pair's spatial layer (csrc/chain_hg.cu, B7): a 16 x 16 tile of
// 8 x 8 fp32 register tiles fed from 16-channel slabs, for two chains over
// one input a launch, with the staging helpers and the feats layout's weight
// remap of B7's conv5. (B1, B3 and B9 run csrc/tc_chain.cuh's tensor-core
// layer.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace chain {

constexpr int GC_MAX = 32;      // widest growth the kernels take
constexpr int KC = 16;          // input channels staged per step (divides GCP)
constexpr int TILE = 16;        // TILE x TILE output pixels a spatial block
constexpr int HALO = TILE + 2;  // staged input tile edge
constexpr float SLOPE = 0.2f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u), __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

// The padded growth width of a feats buffer: gc rounded up to 16 or 32.
inline int padded_gc(int gc) { return gc <= 16 ? 16 : GC_MAX; }

// Staged channels c0 .. c0+kc-1 of x (feats = false) or of a feats buffer
// in the padded layout meet weight rows row0 .. row0+nreal-1; the channels
// from nreal on are pad lanes and meet zeros.
struct SlabRows {
  int row0, nreal;
};
__device__ __forceinline__ SlabRows slab_rows(bool feats, int c0, int kc, int C, int gc, int gcp) {
  if (!feats) return {c0, kc};
  const int lane0 = c0 % gcp;
  return {C + gc * (c0 / gcp) + lane0, min(kc, gc - lane0)};
}

// Four consecutive output channels co..co+3 of weight row `row` (n a row),
// zero from n on.
template <typename T>
__device__ __forceinline__ float4 weight4(const T* w, size_t row, int n, int co) {
  const T* p = w + row * n + co;
  if ((n & 3) == 0) return co < n ? load4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(co < n ? to_f(p[0]) : 0.f, co + 1 < n ? to_f(p[1]) : 0.f, co + 2 < n ? to_f(p[2]) : 0.f, co + 3 < n ? to_f(p[3]) : 0.f);
}

// One spatial layer of up to two chains that read the same x.
template <typename T>
struct SpatialArgs {
  const T* x;          // (frames, H, W, C)
  T* feats[2];         // a chain's (frames, H, W, fc) buffer, segment j at lanes GCP*j
  const T* w[2];       // a chain's w_layer (3, 3, C + gc*layer, gc)
  const T* b[2];       // a chain's b_layer (gc)
  int H, W, C, gc, layer;
  int write_feats;     // store x_{layer+1} into feats
};

// Thread (pg, cg) of a block of 4*GCP threads: output row pg % 16 of the
// tile, columns 8*(pg/16) .. +7, output channels 8*cg .. +7. grid =
// (ceil(W/16), ceil(H/16), frames * NCH), blockIdx.z = frame * NCH + chain.
// A pixel of feats holds 4*GCP channels. The layer reads feats lanes below
// GCP*layer and writes the GCP above them, so one buffer is race free. The
// widths and the chain count are compile-time constants: as run-time values
// they made the layers slower.
template <typename T, int GCP, bool FULL, int NCH>
__global__ void __launch_bounds__(4 * GCP, 96 / GCP) spatial_layer_kernel(SpatialArgs<T> p) {
  const int gc = FULL ? GCP : p.gc;
  constexpr int FC = 4 * GCP;
  constexpr int NT = 4 * GCP;
  constexpr int NCG = GCP / 8;
  __shared__ float4 in_s[KC / 4][HALO * HALO];
  __shared__ __align__(16) float w_s[9][KC][GCP];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int row = pg & 15;
  const int cb = (pg >> 4) * 8;
  const int tx0 = blockIdx.x * TILE;
  const int ty0 = blockIdx.y * TILE;
  const int chain = blockIdx.z % NCH;
  const size_t frame = blockIdx.z / NCH;
  const int H = p.H, W = p.W, C = p.C, layer = p.layer;
  // a select, not p.w[chain]: a dynamic index into the parameter struct puts
  // the whole struct in local memory, where every field read then goes
  const T* w = chain ? p.w[1] : p.w[0];
  const T* bias_p = chain ? p.b[1] : p.b[0];
  const T* xf = p.x + frame * H * W * C;
  T* ff = (chain ? p.feats[1] : p.feats[0]) + frame * H * W * FC;
  const int cin = C + gc * layer;

  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int co = cg * 8 + q;
    const float bias = co < gc ? to_f(bias_p[co]) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][q] = bias;
  }

  for (int src = 0; src < 2; ++src) {
    const int nsrc = src == 0 ? C : GCP * layer;
    const T* base = src == 0 ? xf : ff;
    const int stride = src == 0 ? C : FC;
    const bool vec = (stride & 3) == 0;
    for (int c0 = 0; c0 < nsrc; c0 += KC) {
      const int kc = min(KC, nsrc - c0);
      const int kc4 = (kc + 3) >> 2;
      __syncthreads();
      if (vec) {
        for (int idx = tid; idx < HALO * HALO * (KC / 4); idx += NT) {
          const int c4 = idx & (KC / 4 - 1);
          const int pix = idx / (KC / 4);
          if (c4 >= kc4) continue;
          const int iy = ty0 - 1 + pix / HALO;
          const int ix = tx0 - 1 + pix % HALO;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (iy >= 0 && iy < H && ix >= 0 && ix < W) v = load4(base + ((size_t)iy * W + ix) * stride + c0 + c4 * 4);
          in_s[c4][pix] = v;
        }
      } else {
        for (int idx = tid; idx < HALO * HALO * KC; idx += NT) {
          const int c = idx & (KC - 1);
          const int pix = idx / KC;
          if (c >= kc4 * 4) continue;
          const int iy = ty0 - 1 + pix / HALO;
          const int ix = tx0 - 1 + pix % HALO;
          float v = 0.f;
          if (c < kc && iy >= 0 && iy < H && ix >= 0 && ix < W) v = to_f(base[((size_t)iy * W + ix) * stride + c0 + c]);
          reinterpret_cast<float*>(&in_s[c >> 2][pix])[c & 3] = v;
        }
      }
      const SlabRows sr = slab_rows(src == 1, c0, kc, C, gc, GCP);
      for (int idx = tid; idx < 9 * KC * (GCP / 4); idx += NT) {
        const int co4 = idx % (GCP / 4);
        const int c = (idx / (GCP / 4)) % KC;
        const int tap = idx / (GCP / 4 * KC);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < sr.nreal) v = weight4(w, (size_t)tap * cin + sr.row0 + c, gc, co4 * 4);
        *reinterpret_cast<float4*>(&w_s[tap][c][co4 * 4]) = v;
      }
      __syncthreads();

      for (int dy = 0; dy < 3; ++dy) {
        for (int c4 = 0; c4 < kc4; ++c4) {
          float in[10][4];
          const float4* rowp = &in_s[c4][(row + dy) * HALO + cb];
#pragma unroll
          for (int j = 0; j < 10; ++j) {
            const float4 t = rowp[j];
            in[j][0] = t.x;
            in[j][1] = t.y;
            in[j][2] = t.z;
            in[j][3] = t.w;
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const float* wr = &w_s[dy * 3 + dx][c4 * 4 + cc][cg * 8];
              const float4 wa = *reinterpret_cast<const float4*>(wr);
              const float4 wb = *reinterpret_cast<const float4*>(wr + 4);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float v = in[j + dx][cc];
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
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[j][q] = acc[j][q] >= 0.f ? acc[j][q] : SLOPE * acc[j][q];

  const int oy = ty0 + row;
  if (p.write_feats && oy < H) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ox = tx0 + cb + j;
      if (ox < W) {
        T* o = ff + ((size_t)oy * W + ox) * FC + GCP * layer + cg * 8;
#pragma unroll
        for (int q = 0; q < 8; ++q) from_f(acc[j][q], o + q);
      }
    }
  }
}

}  // namespace chain
