// What the dense-chain forwards share: csrc/dense_chain.cu (B1, B3),
// csrc/chain_hg.cu (B7) and csrc/chain_ride.cu (B9). Element conversion,
// 16-byte staging, the feats layout's weight remap, the coupling epilogue,
// and the spatial layer: B1's 16 x 16 tile of 8 x 8 fp32 register tiles fed
// from 16-channel slabs, here for one or two chains over one input a launch
// (the pair) and able to carry conv5 along (the ride). So the variants differ
// from B1 only in what a launch covers, not in how a layer is computed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace chain {

constexpr int GC_MAX = 32;      // widest growth the kernels take
constexpr int KC = 16;          // input channels staged per step (divides GCP)
constexpr int TILE = 16;        // TILE x TILE output pixels a spatial block
constexpr int HALO = TILE + 2;  // staged input tile edge
constexpr int MAX_RIDE = 10;    // widest conv5 output that rides the spatial layers
constexpr float SLOPE = 0.2f;

enum EpMode { EP_NONE = 0, EP_ADD = 1, EP_SUB_FROM = 2, EP_SIG_EXP = 3, EP_SIG_EXP_NEG = 4, EP_MUL_ADD = 5, EP_SUB_MUL = 6 };

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

__device__ __forceinline__ float ep_apply(float y, int mode, float clamp, float a, float m) {
  switch (mode) {
    case EP_ADD:
      return a + y;
    case EP_SUB_FROM:
      return a - y;
    case EP_SIG_EXP:
      return expf(clamp * (2.f / (1.f + expf(-y)) - 1.f));
    case EP_SIG_EXP_NEG:
      return expf(-clamp * (2.f / (1.f + expf(-y)) - 1.f));
    case EP_MUL_ADD:
      return a * m + y;
    case EP_SUB_MUL:
      return (a - y) * m;
    default:
      return y;
  }
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
  int stripe_w;        // with STRIPE: the width of one image of a W-packed batch
  // ride (one chain): conv5's taps of x_{layer+1} (and of x at layer 0) are
  // added into partial (3, frames, H*W, c_out), fp32, plane k holding the
  // source frame's product with w5[k]; written at layer 0, added to after
  const T* w5;         // (3, ctot, c_out)
  float* partial;
  int c_out, ctot, frames;
};

// Thread (pg, cg) of a block of 4*GCP threads: output row pg % 16 of the
// tile, columns 8*(pg/16) .. +7, output channels 8*cg .. +7. grid =
// (ceil(W/16), ceil(H/16), frames * NCH), blockIdx.z = frame * NCH + chain.
// A pixel of feats holds 4*GCP channels, 3*GCP with the ride (x4 is not
// stored). The layer reads feats lanes below GCP*layer and writes the GCP
// above them, so one buffer is race free. The widths and the chain count are
// compile-time constants: as run-time values they made B1's layers slower.
//
// STRIPE (B1 and B3 on a W-packed batch, JAX's stripe_w): the W axis holds
// images of p.stripe_w columns side by side, and no 3x3 tap may reach across
// from one into the next. The staging zeroes only the edges of the whole
// row, and a 16-wide tile and a thread's 8 columns straddle stripe edges
// (36, 72, 108 at stripe 36), so the mask belongs to the output column: a
// column ox with ox % WS == 0 takes no dx = 0 tap, one with ox % WS == WS - 1
// no dx = 2 tap. Without STRIPE the kernel compiles to the same code as
// before the flag.
template <typename T, int GCP, bool FULL, bool RIDE, int NCH, bool STRIPE = false>
__global__ void __launch_bounds__(4 * GCP, 96 / GCP) spatial_layer_kernel(SpatialArgs<T> p) {
  const int gc = FULL ? GCP : p.gc;
  constexpr int FC = (RIDE ? 3 : 4) * GCP;
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

  // bit j: output column tx0 + cb + j takes no dx = 0 tap (lmask) / no
  // dx = 2 tap (rmask)
  unsigned lmask = 0, rmask = 0;
  if (STRIPE) {
    const int ws = p.stripe_w;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = (tx0 + cb + j) % ws;
      lmask |= (r == 0 ? 1u : 0u) << j;
      rmask |= (r == ws - 1 ? 1u : 0u) << j;
    }
  }

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
                float v = in[j + dx][cc];
                if (STRIPE && dx != 1 && (((dx == 0 ? lmask : rmask) >> j) & 1u)) v = 0.f;
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
  if (!RIDE) return;

  // ---- the ride: conv5's three taps of this feature, a pixel at a time ----
  // The tile's x_{layer+1} goes through the staging memory (in_s, free once
  // the layer is done) half a tile at a time: rows 8h .. 8h+7 in pass h.
  float* out_s = reinterpret_cast<float*>(&in_s[0][0]);  // [TILE/2 * TILE][GCP]
  static_assert(TILE / 2 * TILE * GCP <= KC * HALO * HALO, "half a tile fits the staging memory");
  const int c_out = p.c_out;
  const size_t HW = (size_t)H * W;
  const size_t tap_stride = (size_t)p.ctot * c_out;  // one tap of w5
  for (int half = 0; half < 2; ++half) {
    __syncthreads();  // the staging memory (or the last half) is consumed
    if ((row >> 3) == half) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q) out_s[((row & 7) * TILE + cb + j) * GCP + cg * 8 + q] = acc[j][q];
    }
    __syncthreads();
    for (int lp = tid; lp < TILE / 2 * TILE; lp += NT) {
      const int py = ty0 + half * (TILE / 2) + lp / TILE;
      const int px = tx0 + lp % TILE;
      if (py >= H || px >= W) continue;
      const size_t pix = (size_t)py * W + px;
      float r[3][MAX_RIDE];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int co = 0; co < MAX_RIDE; ++co) r[k][co] = 0.f;
      // x rides the first layer (w5 rows 0 .. C-1), in the same order as the
      // feature: channel by channel
      const int n_x = layer == 0 ? C : 0;
      for (int c = 0; c < n_x + gc; ++c) {
        const bool is_x = c < n_x;
        const float v = is_x ? to_f(xf[pix * C + c]) : out_s[lp * GCP + (c - n_x)];
        const T* wr = p.w5 + (size_t)(is_x ? c : C + gc * layer + (c - n_x)) * c_out;
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int co = 0; co < MAX_RIDE; ++co)
            if (co < c_out) r[k][co] = fmaf(v, to_f(wr[k * tap_stride + co]), r[k][co]);
      }
      // each entry of a plane is this thread's alone in this launch
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float* dst = p.partial + (((size_t)k * p.frames + frame) * HW + pix) * c_out;
#pragma unroll
        for (int co = 0; co < MAX_RIDE; ++co)
          if (co < c_out) dst[co] = layer == 0 ? r[k][co] : dst[co] + r[k][co];
      }
    }
  }
}

}  // namespace chain
