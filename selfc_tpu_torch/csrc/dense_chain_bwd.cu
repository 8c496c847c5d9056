// Adjoint of the dense chain's four spatial convs for Hopper (sm_90a).
//
// Replaces selfc_tpu/ops/pallas_chain.py:_chain_bwd_kernel (reached there
// through _pallas_bwd), with its stripe_w: on a W-packed batch the products
// whose tap crosses an image's edge are dropped, the adjoint of the forward's
// masks (pallas_chain.py's dp0 / dp2). The function, for the chain of dense_chain.cu
//
//   x_k = lrelu_0.2(conv3x3_SAME([x | x_1 .. x_{k-1}], w_k) + b_k),  k = 1..4
//
// given x, the saved [x_1 | .. | x_4] ("feats") and the gradient of a loss
// with respect to x (what reaches x directly) and to feats (what reaches
// x_1..x_4 directly), both as fp32 buffers "dx" and "dfeats":
//
//   for k = 4 .. 1:
//     dacc  = dfeats[slot k] * (x_k > 0 ? 1 : 0.2)     // sign of the saved output
//     db_k  = sum over pixels of dacc
//     dW_k[dy,dx,ci,co] = sum_p [x | feats](p + (dy-1,dx-1))[ci] * dacc(p)[co]
//     [dx | dfeats[slots < k]](q)[ci] += sum_{dy,dx,co} dacc(q - (dy-1,dx-1))[co] * w_k[dy,dx,ci,co]
//
// with zero outside the image on both sides. dx and dfeats are updated in
// place; at the end dx holds the whole gradient with respect to x.
//
// Growth width gc in 1..32 (32 in the coupling and the 4x prior, 12 in the
// codec's prior; the TPU kernel pads the weights to 32 lanes a segment in
// selfc_tpu/ops/pallas_chain.py:pad_gc_params). feats and dfeats have the
// forward's layout: (frames,H,W,4*GCP), GCP = 16 for gc <= 16 and 32 above,
// slot j in channels GCP*j .. GCP*j+gc-1 and pad lanes above. The weights are
// read in their own layout (w_k (3,3,C+gc(k-1),gc)) and remapped while they
// are staged, as in the forward: buffer lane GCP*j + l is weight row
// C + gc*j + l for l < gc, and a pad lane meets zeros. dW and db are written
// in that layout at the true gc. The input concat is cut into chunks of GCP
// channels: x in runs of GCP (the last one may be short), feats one slot a
// chunk; a pad lane of dfeats is never written and never read into a result.
// FULL (gc == GCP == 32) fixes gc at compile time, so the remap folds away
// and gc 32 runs the code of a kernel written for that one width.
//
// What bounds it: arithmetic. The two contractions of a layer each cost what
// the layer's forward costs (twice the forward in all), on plain fp32 FMAs,
// while every tensor is moved a few times at most.
//
// The design follows the forward's memory layout instead of fusing the sweep
// into one tile: the running gradient lives in device memory as fp32 (dx and
// dfeats, split where the forward splits its two sources, so the 4*GCP feature
// channels of a pixel are 16-byte aligned whatever C is) and the sweep is a
// sequence of launches. Launch order gives the dependency: slot k of dfeats
// is complete before layer k reads it, and layer k only adds to slots below k.
//
//   * data gradient, one launch a layer, gather form: a block owns 16x16
//     pixels and GCP channels of dx or of one dfeats slot and sums over the 3x3
//     neighbours of dacc with the weights transposed and flipped on the way
//     into shared memory. Blocks write disjoint elements: no atomics, no
//     halos, no overlap-add. Same register tiling as the forward (8 pixels x
//     8 channels a thread, 16-channel slabs).
//   * weight gradient, one launch a layer: the sum runs over every pixel of
//     every frame, so a block walks over a strided share of 8x16 pixel tiles
//     with 9 x 2 x 4 accumulators a thread (all taps, two input channels,
//     four output channels; one 16-byte and three 8-byte shared loads per 72
//     FMAs) and writes its partial sums to scratch. A second small launch
//     adds the partials in a fixed order, so the result is the same bits on
//     every run: no atomicAdd anywhere.
//
// All products are plain fp32 FMAs: no tensor cores, no TF32. bf16 tensors
// are widened on load; dW and db are rounded once, by the reduction.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int GC_MAX = 32;          // widest growth the kernels take
constexpr int KC = 16;              // data gradient: dacc channels staged per step (divides GCP)
constexpr int TILE = 16;            // data gradient: TILE x TILE pixels a block
constexpr int HALO = TILE + 2;
constexpr int WG_TH = 8;            // weight gradient: rows of a pixel tile
constexpr int WG_TW = 16;           // weight gradient: columns of a pixel tile
constexpr int WG_HH = WG_TH + 2;
constexpr int WG_HW = WG_TW + 2;
constexpr int RED_THREADS = 256;
constexpr float SLOPE = 0.2f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

// Four consecutive elements as fp32; p is aligned to the four elements.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);  // bf16 -> fp32 is a 16-bit shift
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u), __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

// dacc of four consecutive channels: the gradient reaching a layer's output
// times the LeakyReLU slope, chosen by the sign of the saved output (an
// output of exactly 0 takes the 0.2 branch).
template <typename T>
__device__ __forceinline__ float4 dacc4(const float* dout, const T* out) {
  float4 d = load4(dout);
  const float4 f = load4(out);
  d.x = f.x > 0.f ? d.x : SLOPE * d.x;
  d.y = f.y > 0.f ? d.y : SLOPE * d.y;
  d.z = f.z > 0.f ? d.z : SLOPE * d.z;
  d.w = f.w > 0.f ? d.w : SLOPE * d.w;
  return d;
}

// Four consecutive output channels co..co+3 of weight row `row` (n of them a
// row), zero from n on; 16-byte loads when the rows allow them.
template <typename T>
__device__ __forceinline__ float4 weight4(const T* w, size_t row, int n, int co) {
  const T* p = w + row * n + co;
  if ((n & 3) == 0) return co < n ? load4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(co < n ? to_f(p[0]) : 0.f, co + 1 < n ? to_f(p[1]) : 0.f,
                     co + 2 < n ? to_f(p[2]) : 0.f, co + 3 < n ? to_f(p[3]) : 0.f);
}

// The chunk of [x | feats[slots < layer]] a block works on, GCP buffer
// channels wide: chunks below x_chunks lie in x (the last one may be short),
// the others are whole slots of feats, of which the first gc lanes are real.
struct Chunk {
  bool in_x;    // the chunk lies in x (else in feats)
  int c0;       // first channel inside its tensor
  int n;        // real channels of the chunk, <= GCP
  int row0;     // first row on the weights' Cin axis
  int stride;   // channels of a pixel in its tensor
};

template <int GCP>
__device__ __forceinline__ Chunk chunk_of(int chunk, int x_chunks, int C, int gc) {
  Chunk k;
  k.in_x = chunk < x_chunks;
  if (k.in_x) {
    k.c0 = chunk * GCP;
    k.n = min(GCP, C - k.c0);
    k.row0 = k.c0;
    k.stride = C;
  } else {
    const int slot = chunk - x_chunks;
    k.c0 = slot * GCP;
    k.n = gc;
    k.row0 = C + slot * gc;
    k.stride = 4 * GCP;
  }
  return k;
}

// Data gradient of one layer:
//   dst(q)[ci] += sum_{tap,co} dacc(q + tap' - 1)[co] * w[8 - tap'][ci][co]
// (the forward's tap (dy,dx) seen from the input pixel is tap' = (2-dy,2-dx),
// whose flat index is 8 - tap). dst is dx for a chunk of x, dfeats for a
// chunk of feats. grid = (tiles_x * tiles_y, chunks, frames), block = 4*GCP.
// Thread (pg, cg) as in the forward: row pg%16 of the tile, columns
// 8*(pg/16) .. +7, channels 8*cg .. +7 of the chunk (cg < GCP/8). The sum
// runs over the layer's GCP output lanes; those >= gc meet zero weights.
// STRIPE: the adjoint of the forward's stripe masks (chain_common.cuh). Seen
// from the input pixel q, the staged column dx_ holds dacc(q + dx_ - 1)
// through the forward's tap 2 - dx_, and that pair was masked where the
// output column q + dx_ - 1 lies in the next or the last stripe: the same
// rule as the forward's, no dx_ = 0 term where q % WS == 0 and no dx_ = 2 term
// where q % WS == WS - 1.
template <typename T, int GCP, bool FULL, bool STRIPE>
__global__ void __launch_bounds__(4 * GCP, 96 / GCP) data_grad_kernel(const T* feats, const T* w, float* dfeats, float* dx, int H, int W, int C, int gc_arg, int layer, int x_chunks, int stripe_w) {
  const int gc = FULL ? GCP : gc_arg;
  constexpr int NT = 4 * GCP;
  constexpr int NCG = GCP / 8;
  constexpr int FC = 4 * GCP;
  __shared__ float4 in_s[KC / 4][HALO * HALO];
  __shared__ __align__(16) float w_s[9][KC][GCP];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int row = pg & 15;
  const int cb = (pg >> 4) * 8;
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tx0 = (blockIdx.x % tiles_x) * TILE;
  const int ty0 = (blockIdx.x / tiles_x) * TILE;
  const size_t frame = blockIdx.z;
  const Chunk ch = chunk_of<GCP>(blockIdx.y, x_chunks, C, gc);
  const int cin = C + gc * layer;
  const T* ff = feats + frame * H * W * FC + GCP * layer;       // the layer's saved output
  const float* df = dfeats + frame * H * W * FC + GCP * layer;  // the gradient reaching it
  float* dst = ch.in_x ? dx + frame * H * W * C : dfeats + frame * H * W * FC;
  unsigned lmask = 0, rmask = 0;  // bit p: column tx0 + cb + p takes no dx_ = 0 / dx_ = 2 term
  if (STRIPE) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int r = (tx0 + cb + p) % stripe_w;
      lmask |= (r == 0 ? 1u : 0u) << p;
      rmask |= (r == stripe_w - 1 ? 1u : 0u) << p;
    }
  }

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  }

  for (int c0 = 0; c0 < GCP; c0 += KC) {
    __syncthreads();  // the previous slab is consumed before it is overwritten
    for (int idx = tid; idx < HALO * HALO * (KC / 4); idx += NT) {
      const int c4 = idx & (KC / 4 - 1);
      const int pix = idx / (KC / 4);
      const int iy = ty0 - 1 + pix / HALO;
      const int ix = tx0 - 1 + pix % HALO;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        const size_t off = ((size_t)iy * W + ix) * FC + c0 + c4 * 4;
        v = dacc4(df + off, ff + off);
      }
      in_s[c4][pix] = v;
    }
    // weights, transposed on the way in: w_s[tap'][co][ci]. Neighbouring
    // threads take neighbouring ci, so the four stores of a thread meet no
    // bank conflict. Rows of pad lanes (ci >= n) and columns co >= gc stage
    // as zeros.
    for (int idx = tid; idx < 9 * GCP * (KC / 4); idx += NT) {
      const int ci = idx % GCP;
      const int co4 = (idx / GCP) % (KC / 4);
      const int tap = idx / (GCP * (KC / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      const size_t wrow = (size_t)(8 - tap) * cin + ch.row0 + ci;
      if (ci < ch.n) v = FULL ? load4(w + wrow * GCP + c0 + co4 * 4) : weight4(w, wrow, gc, c0 + co4 * 4);
      w_s[tap][co4 * 4 + 0][ci] = v.x;
      w_s[tap][co4 * 4 + 1][ci] = v.y;
      w_s[tap][co4 * 4 + 2][ci] = v.z;
      w_s[tap][co4 * 4 + 3][ci] = v.w;
    }
    __syncthreads();

    for (int dy = 0; dy < 3; ++dy) {
      for (int c4 = 0; c4 < KC / 4; ++c4) {
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
        for (int dx_ = 0; dx_ < 3; ++dx_) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 wa = *reinterpret_cast<const float4*>(&w_s[dy * 3 + dx_][c4 * 4 + cc][cg * 8]);
            const float4 wb = *reinterpret_cast<const float4*>(&w_s[dy * 3 + dx_][c4 * 4 + cc][cg * 8 + 4]);
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              float v = in[p + dx_][cc];
              if (STRIPE && dx_ != 1 && (((dx_ == 0 ? lmask : rmask) >> p) & 1u)) v = 0.f;
              acc[p][0] = fmaf(v, wa.x, acc[p][0]);
              acc[p][1] = fmaf(v, wa.y, acc[p][1]);
              acc[p][2] = fmaf(v, wa.z, acc[p][2]);
              acc[p][3] = fmaf(v, wa.w, acc[p][3]);
              acc[p][4] = fmaf(v, wb.x, acc[p][4]);
              acc[p][5] = fmaf(v, wb.y, acc[p][5]);
              acc[p][6] = fmaf(v, wb.z, acc[p][6]);
              acc[p][7] = fmaf(v, wb.w, acc[p][7]);
            }
          }
        }
      }
    }
  }

  const int oy = ty0 + row;
  if (oy >= H) return;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int ox = tx0 + cb + p;
    if (ox < W) {
      float* o = dst + ((size_t)oy * W + ox) * ch.stride + ch.c0 + cg * 8;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (cg * 8 + q < ch.n) o[q] += acc[p][q];
      }
    }
  }
}

// Weight and bias gradient of one layer, partial sums of one block, in the
// weights' own layout at the true gc:
//   partial[g][(tap * cin + row0 + ci) * gc + co] = sum over the block's pixels p of
//       [x | feats](p + tap - 1)[ci] * dacc(p)[co]
//   partial[g][9 * cin * gc + co]  = sum over the block's pixels of dacc(p)[co]
// for ci < n and co < gc (pad lanes are computed and dropped).
// grid = (groups, chunks), block = GCP*GCP/8 (128 at GCP 32, 32 at 16). Block
// (g, chunk) walks over the pixel tiles g, g + groups, ... of all frames.
// Thread (cp, cq): input channels 2*cp, 2*cp + 1 of the chunk, output
// channels 4*cq .. +3, all nine taps. Every thread of a block visits the same
// pixels, so a tile that hangs over the edge of the image simply has fewer.
// STRIPE: a product whose tap crosses a stripe edge is dropped (the forward
// masked it): window column 0 where the pixel's column p % WS == 0, column 2
// where p % WS == WS - 1. The order of the sums does not change.
template <typename T, int GCP, bool FULL, bool STRIPE>
__global__ void __launch_bounds__(GCP * GCP / 8, 96 / GCP) weight_grad_kernel(const T* x, const T* feats, const float* dfeats, float* partial, int frames, int H, int W, int C, int gc_arg, int layer, int x_chunks, int stripe_w) {
  const int gc = FULL ? GCP : gc_arg;
  constexpr int NT = GCP * GCP / 8;
  constexpr int FC = 4 * GCP;
  __shared__ __align__(16) float in_s[WG_HH * WG_HW][GCP];  // [pixel with halo][ci]
  __shared__ __align__(16) float da_s[WG_TH * WG_TW][GCP];  // [pixel][co]

  const int tid = threadIdx.x;
  const int cq = tid % (GCP / 4);
  const int cp = tid / (GCP / 4);
  const Chunk ch = chunk_of<GCP>(blockIdx.y, x_chunks, C, gc);
  const int cin = C + gc * layer;
  const int tiles_x = (W + WG_TW - 1) / WG_TW;
  const int tiles_y = (H + WG_TH - 1) / WG_TH;
  const int n_tiles = tiles_x * tiles_y * frames;
  const bool vec = (ch.stride & 3) == 0;  // every pixel's channels start on a 4-element boundary

  float acc[9][2][4];
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][0][i] = acc[t][1][i] = 0.f;
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t frame = tile / (tiles_x * tiles_y);
    const int rem = tile % (tiles_x * tiles_y);
    const int ty0 = (rem / tiles_x) * WG_TH;
    const int tx0 = (rem % tiles_x) * WG_TW;
    const int th = min(WG_TH, H - ty0);
    const int tw = min(WG_TW, W - tx0);
    const T* src = ch.in_x ? x + frame * H * W * C : feats + frame * H * W * FC;
    const size_t foff = frame * H * W * FC + GCP * layer;

    __syncthreads();  // the previous tile is consumed before it is overwritten
    if (vec) {
      for (int idx = tid; idx < WG_HH * WG_HW * (GCP / 4); idx += NT) {
        const int c4 = idx % (GCP / 4);
        const int pix = idx / (GCP / 4);
        const int iy = ty0 - 1 + pix / WG_HW;
        const int ix = tx0 - 1 + pix % WG_HW;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c4 * 4 < ch.n && iy >= 0 && iy < H && ix >= 0 && ix < W) v = load4(src + ((size_t)iy * W + ix) * ch.stride + ch.c0 + c4 * 4);
        *reinterpret_cast<float4*>(&in_s[pix][c4 * 4]) = v;
      }
    } else {
      for (int idx = tid; idx < WG_HH * WG_HW * GCP; idx += NT) {
        const int c = idx % GCP;
        const int pix = idx / GCP;
        const int iy = ty0 - 1 + pix / WG_HW;
        const int ix = tx0 - 1 + pix % WG_HW;
        float v = 0.f;
        if (c < ch.n && iy >= 0 && iy < H && ix >= 0 && ix < W) v = to_f(src[((size_t)iy * W + ix) * ch.stride + ch.c0 + c]);
        in_s[pix][c] = v;
      }
    }
    for (int idx = tid; idx < WG_TH * WG_TW * (GCP / 4); idx += NT) {
      const int c4 = idx % (GCP / 4);
      const int pix = idx / (GCP / 4);
      const int iy = ty0 + pix / WG_TW;
      const int ix = tx0 + pix % WG_TW;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (iy < H && ix < W) {
        const size_t off = foff + ((size_t)iy * W + ix) * FC + c4 * 4;
        v = dacc4(dfeats + off, feats + off);
      }
      *reinterpret_cast<float4*>(&da_s[pix][c4 * 4]) = v;
    }
    __syncthreads();

    for (int py = 0; py < th; ++py) {
      // the 3x3 window of the two input channels slides along the row
      float2 win[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        win[r][1] = *reinterpret_cast<const float2*>(&in_s[(py + r) * WG_HW + 0][cp * 2]);
        win[r][2] = *reinterpret_cast<const float2*>(&in_s[(py + r) * WG_HW + 1][cp * 2]);
      }
      int sc = STRIPE ? tx0 % stripe_w : 0;  // the pixel's column in its stripe
      for (int px = 0; px < tw; ++px) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          win[r][0] = win[r][1];
          win[r][1] = win[r][2];
          win[r][2] = *reinterpret_cast<const float2*>(&in_s[(py + r) * WG_HW + px + 2][cp * 2]);
        }
        const float4 d = *reinterpret_cast<const float4*>(&da_s[py * WG_TW + px][cq * 4]);
        bsum[0] += d.x;
        bsum[1] += d.y;
        bsum[2] += d.z;
        bsum[3] += d.w;
        // masked: the pixel is at a stripe edge (every thread of the block
        // visits the same pixel, so the branch does not diverge)
        auto taps = [&](auto masked) {
#pragma unroll
          for (int r = 0; r < 3; ++r) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              float2 v = win[r][c];
              if (decltype(masked)::value && ((c == 0 && sc == 0) || (c == 2 && sc == stripe_w - 1))) v.x = v.y = 0.f;
              float* a0 = acc[r * 3 + c][0];
              float* a1 = acc[r * 3 + c][1];
              a0[0] = fmaf(v.x, d.x, a0[0]);
              a0[1] = fmaf(v.x, d.y, a0[1]);
              a0[2] = fmaf(v.x, d.z, a0[2]);
              a0[3] = fmaf(v.x, d.w, a0[3]);
              a1[0] = fmaf(v.y, d.x, a1[0]);
              a1[1] = fmaf(v.y, d.y, a1[1]);
              a1[2] = fmaf(v.y, d.z, a1[2]);
              a1[3] = fmaf(v.y, d.w, a1[3]);
            }
          }
        };
        if (STRIPE && (sc == 0 || sc == stripe_w - 1)) {
          taps(std::true_type{});
        } else {
          taps(std::false_type{});
        }
        if (STRIPE) sc = sc + 1 == stripe_w ? 0 : sc + 1;
      }
    }
  }

  const size_t n_w = (size_t)9 * cin * gc;
  float* out = partial + (size_t)blockIdx.x * (n_w + gc);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ci = cp * 2 + j;
      if (ci >= ch.n) continue;
      float* o = out + ((size_t)t * cin + ch.row0 + ci) * gc + cq * 4;
      if (FULL) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[t][j][0], acc[t][j][1], acc[t][j][2], acc[t][j][3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (cq * 4 + i < gc) o[i] = acc[t][j][i];
        }
      }
    }
  }
  if (blockIdx.y == 0 && cp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (cq * 4 + i < gc) out[n_w + cq * 4 + i] = bsum[i];
    }
  }
}

// dw[e] = sum_g partial[g][e] for e < n_w, db[e - n_w] for the gc after them,
// added in the order of g and rounded once.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS) reduce_partials_kernel(const float* partial, int groups, int n_w, int gc, T* dw, T* db) {
  const int e = blockIdx.x * RED_THREADS + threadIdx.x;
  const int n = n_w + gc;
  if (e >= n) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += partial[(size_t)g * n + e];
  if (e < n_w) {
    from_f(s, dw + e);
  } else {
    from_f(s, db + (e - n_w));
  }
}

template <typename T, int GCP, bool FULL, bool STRIPE>
int chain_backward_at(const void* x, const void* feats, const void* const* ws, void* dfeats, void* dx, void* const* dws, void* const* dbs, void* partial, int groups, int frames, int H, int W, int C, int gc, int need_dx, int stripe_w, cudaStream_t stream) {
  const int x_chunks = (C + GCP - 1) / GCP;
  const int dx_chunks = need_dx ? x_chunks : 0;
  const int tiles = ((W + TILE - 1) / TILE) * ((H + TILE - 1) / TILE);
  for (int layer = 3; layer >= 0; --layer) {
    const int n_w = 9 * (C + gc * layer) * gc;
    weight_grad_kernel<T, GCP, FULL, STRIPE><<<dim3(groups, x_chunks + layer), GCP * GCP / 8, 0, stream>>>((const T*)x, (const T*)feats, (const float*)dfeats, (float*)partial, frames, H, W, C, gc, layer, x_chunks, stripe_w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_partials_kernel<T><<<(n_w + gc + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0, stream>>>((const float*)partial, groups, n_w, gc, (T*)dws[layer], (T*)dbs[layer]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (dx_chunks + layer == 0) continue;  // nothing below the first layer but x
    data_grad_kernel<T, GCP, FULL, STRIPE><<<dim3(tiles, dx_chunks + layer, frames), 4 * GCP, 0, stream>>>((const T*)feats, (const T*)ws[layer], (float*)dfeats, (float*)dx, H, W, C, gc, layer, dx_chunks, stripe_w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The padded growth width of the feats buffer: the forward's rule
// (dense_chain.cu:padded_gc), which the wrapper checks the two libraries share.
inline int padded_gc(int gc) { return gc <= 16 ? 16 : GC_MAX; }

template <typename T, bool STRIPE>
int chain_backward_striped(const void* x, const void* feats, const void* const* ws, void* dfeats, void* dx, void* const* dws, void* const* dbs, void* partial, int groups, int frames, int H, int W, int C, int gc, int need_dx, int stripe_w, cudaStream_t stream) {
  if (gc == GC_MAX) return chain_backward_at<T, GC_MAX, true, STRIPE>(x, feats, ws, dfeats, dx, dws, dbs, partial, groups, frames, H, W, C, gc, need_dx, stripe_w, stream);
  if (padded_gc(gc) == 16) return chain_backward_at<T, 16, false, STRIPE>(x, feats, ws, dfeats, dx, dws, dbs, partial, groups, frames, H, W, C, gc, need_dx, stripe_w, stream);
  return chain_backward_at<T, GC_MAX, false, STRIPE>(x, feats, ws, dfeats, dx, dws, dbs, partial, groups, frames, H, W, C, gc, need_dx, stripe_w, stream);
}

template <typename T>
int chain_backward(const void* x, const void* feats, const void* const* ws, void* dfeats, void* dx, void* const* dws, void* const* dbs, void* partial, int groups, int frames, int H, int W, int C, int gc, int need_dx, int stripe_w, cudaStream_t stream) {
  if (gc < 1 || gc > GC_MAX) return (int)cudaErrorInvalidValue;
  if (stripe_w < 0 || (stripe_w > 0 && W % stripe_w != 0)) return (int)cudaErrorInvalidValue;
  if (stripe_w > 0) return chain_backward_striped<T, true>(x, feats, ws, dfeats, dx, dws, dbs, partial, groups, frames, H, W, C, gc, need_dx, stripe_w, stream);
  return chain_backward_striped<T, false>(x, feats, ws, dfeats, dx, dws, dbs, partial, groups, frames, H, W, C, gc, need_dx, 0, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16: the type of x, feats, w1..w4, dw1..dw4 and
// db1..db4. dfeats, dx and partial are float32 whatever dtype is. Every
// pointer is aligned to 16 bytes.
// x (frames,H,W,C); feats (frames,H,W,4*GCP), the saved x1..x4 in the
//   forward's layout (GCP = selfc_dense_chain_bwd_padded_gc(gc)); w_k (3,3,C+gc(k-1),gc);
// dfeats (frames,H,W,4*GCP): on entry the gradient that reaches x1..x4 directly,
//   overwritten with the running gradient (pad lanes are neither read into a
//   result nor written);
// dx (frames,H,W,C): on entry the gradient that reaches x directly, on return
//   the whole gradient (untouched, and may be null, when need_dx is 0);
// dw_k, db_k: written, shaped as w_k and (gc);
// partial: scratch of groups * (9 * (C + 3 * gc) * gc + gc) floats, groups >= 1.
// 1 <= gc <= 32. stripe_w: 0, or the width of one image of a W-packed batch
// (W a multiple of it), whose forward masked the taps across stripe edges.
// Returns the first cudaError_t a launch reports, 0 when all were accepted.
extern "C" int selfc_dense_chain_spatial_backward(const void* x, const void* feats, const void* w1, const void* w2, const void* w3, const void* w4, void* dfeats, void* dx, void* dw1, void* dw2, void* dw3, void* dw4, void* db1, void* db2, void* db3, void* db4, void* partial, int groups, int frames, int H, int W, int C, int gc, int need_dx, int stripe_w, int dtype, void* stream) {
  const void* ws[4] = {w1, w2, w3, w4};
  void* dws[4] = {dw1, dw2, dw3, dw4};
  void* dbs[4] = {db1, db2, db3, db4};
  cudaStream_t s = (cudaStream_t)stream;
  if (groups < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return chain_backward<float>(x, feats, ws, dfeats, dx, dws, dbs, partial, groups, frames, H, W, C, gc, need_dx, stripe_w, s);
  if (dtype == 1) return chain_backward<__nv_bfloat16>(x, feats, ws, dfeats, dx, dws, dbs, partial, groups, frames, H, W, C, gc, need_dx, stripe_w, s);
  return (int)cudaErrorInvalidValue;
}

// The per-segment width of the feats / dfeats buffers this library reads for
// growth width gc.
extern "C" int selfc_dense_chain_bwd_padded_gc(int gc) { return padded_gc(gc); }

extern "C" const char* selfc_bwd_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
