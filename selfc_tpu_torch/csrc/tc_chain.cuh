// The dense chain's spatial layer on the tensor cores: csrc/dense_chain.cu
// (B1, and B3, its spatial-only entry), csrc/chain_ride.cu (B9, with
// conv5's taps riding the layer) and csrc/chain_hg.cu (B7, two chains a
// launch) in B1's padded feats layout, and csrc/chain_v3.cu (B8) at the true
// width. One layer is
//
//   x_{k+1} = lrelu(conv3x3([x | x_1 .. x_k], w_{k+1}) + b_{k+1}, 0.2)
//
// an implicit GEMM: M = the frame's pixels, N = gc (padded to GCP = 16 or
// 32), K = 9 taps x (C + gc*k) input channels:
//
//  - Products: mma.sync (csrc/tc_mma.cuh), 3xTF32 for fp32, bf16 mma for
//    bf16. K is walked as (slab of 16 fp32 / 32 bf16 input channels) x (9
//    taps); each slab's 144 (288) products go into a zeroed part that an
//    fp32 add carries into the sum (one accumulator over all of K drifts).
//  - Staging: a 2-stage cp.async ring; a stage holds the slab's halo tile
//    ([pixel][channel], 80-byte rows, so a fragment's 8 rows meet 32 banks)
//    and the slab's 9 x BK weight rows of the (3,3,Cin,gc) layout as they
//    lie. A tap's A fragment is the halo tile shifted by (dy, dx): mma.sync
//    reads A through registers, so each lane addresses its own two pixels.
//  - The feats layout: B1's and B9's (frames, H, W, NSEG*GCP) buffer holds
//    x_{j+1} in lanes GCP*j .. GCP*j+gc-1 and zeros in the pad lanes above
//    them (B2 reads it unchanged): the layer writes all GCP lanes of its
//    segment (pads as 0, so a buffer that held NaN comes back clean), and
//    the staged weight row of buffer lane GCP*j + l is C + gc*j + l for
//    l < gc, a zero row otherwise, remapped row by row (a bf16 slab of 32
//    lanes spans two segments when GCP = 16). B8's buffer is at the true
//    width (TRUE_WIDTH: segment j at lanes gc*j, lane L meets row C + L).
//  - STRIPE (a W-packed batch, JAX's stripe_w): an output column ox with
//    ox % stripe_w == 0 takes no dx = 0 tap, one with ox % stripe_w ==
//    stripe_w - 1 no dx = 2 tap. The mask belongs to the lane's own output
//    column; a masked tap points the lane's A row at the stage's zero row (a
//    select on an int a tap and fragment row, no branch in the mma loop), so
//    it adds an exact 0 as the zero edge of the image does.
//  - The pair (PAIR, B7): the H and G chains of a coupling block read one x;
//    a launch runs layer k of both, blockIdx.z = 2 * frame + chain, the
//    chain's weights, bias and feats buffer chosen by selects on that bit
//    (a run-time index into the parameter struct puts it in a stack frame).
//    The two blocks of a tile are neighbours in the grid, so the second
//    reads x's rows from L2.
//  - The ride (NR > 0, B9): after bias and LeakyReLU the tile's x_{k+1} goes
//    into the ring's memory (free once the last slab is done) and a second
//    product [tile pixels x GCP] @ [GCP x 3*c_out], N padded to NR = 16 or
//    32, forms its three temporal taps with w5, which are added into three
//    fp32 planes (3, frames, H*W, c_out); at layer 0 the center-tap fragments
//    of each staged x slab meet w5's x rows too, so x is read once. Every
//    plane entry is one lane's work in a launch: no atomics, a step repeats
//    bit for bit.
//  - The tile: 8 x 16 pixels of one frame, 4 warps of two m16 fragments,
//    a fragment one tile row, so a fragment's 8-row half is 8 consecutive
//    pixels and the fragment loads meet 32 banks. It computes 1.48x the
//    pixels needed at 36 x 36 (the unpacked training latent) and 1.11x at
//    36 x 144 and 72 x 72. A 12 x 8 tile of 3 warps computes 1.11x and 1.0x
//    there, yet took as long or longer on every row of B1, B3 and B9
//    (1.00-1.52x) on an NVIDIA H100 80GB HBM3 at 700 W
//    (tools/tc_attribution.py, variant tile_12x8; PERF.md): a block of 96
//    pixels stages more halo and weight rows a pixel and keeps fewer warps
//    in flight.
//
// What bounds a layer on this card: operations, at the rate of the products
// that run them (3xTF32: 495 / 3 TFLOP/s dense). B8's layer measured bound
// by the mma.sync issue (tools/tc_attribution.py).

#pragma once

#include "tc_mma.cuh"

namespace tc {

constexpr int GC_MAX = 32;       // widest growth the chain kernels take
constexpr int RIDE_MAX = 10;     // widest conv5 output that rides the spatial layers
constexpr float CHAIN_SLOPE = 0.2f;

// The padded growth width of a feats buffer: gc rounded up to 16 or 32.
inline int padded_gc(int gc) { return gc <= 16 ? 16 : GC_MAX; }

// TH x TW output pixels of one frame, WARPS warps; fragment f covers the
// tile's pixels 16f .. 16f+15 in row-major order.
template <int TH_, int TW_, int WARPS_>
struct ChainTile {
  static constexpr int TH = TH_, TW = TW_, WARPS = WARPS_, THREADS = 32 * WARPS;
  static constexpr int MT = TH * TW / 16 / WARPS;                // m16 fragments a warp
  static constexpr int HWD = TW + 2, NPIX = (TH + 2) * HWD;      // the staged halo tile
  static constexpr int A_BYTES = (NPIX + 1) * ROW_STRIDE;        // staged pixel NPIX stays zero
  static_assert(TW % 8 == 0 && MT * 16 * WARPS == TH * TW, "a fragment half is 8 pixels of one tile row");
};
using SpatialTile = ChainTile<8, 16, 4>;   // the tile the layers run

template <typename T>
struct ChainLayerArgs {
  const T* x;          // (frames, H, W, C)
  T* feats;            // (frames, H, W, fc): segment j at lanes GCP*j (TRUE_WIDTH: gc*j)
  const T* w;          // w_{layer+1} (3, 3, C + gc*layer, gc)
  const T* b;          // (gc)
  // PAIR: the second chain's feats buffer, w_{layer+1} and bias (G of B7)
  T* feats_g;
  const T* w_g;
  const T* b_g;
  int H, W, C, gc, layer, fc;
  int write_feats;     // store x_{layer+1} into feats
  int stripe_w;        // STRIPE: the width of one image of a W-packed batch
  int x_vec, f_vec, w_vec;   // x's / feats' / the weight rows allow 16-byte copies
  int stage_bytes;     // bytes of one ring stage
  // the ride: w5 (3, ctot, c_out); partial (3, frames, H*W, c_out) fp32,
  // plane k holding each source frame's product with w5[k]
  const T* w5;
  float* partial;
  int c_out, ctot, frames;
};

template <typename T, class Tile, int GCP, int NR>
struct ChainSmem {
  static constexpr int BK = Elem<T>::BK, ES = (int)sizeof(T);
  static constexpr int SN = b_stride(GCP), SNR = b_stride(NR > 0 ? NR : 8);
  static constexpr int B_BYTES = 9 * BK * SN * ES;
  static constexpr int B5_BYTES = NR > 0 ? BK * SNR * ES : 0;   // w5's rows of an x slab (ride, layer 0)
  // after the K loop (ride): the tile's x_{k+1} as slabs of BK lanes,
  // [pixel][ROW_STRIDE], and w5's rows of it, [slab lane][SNR]
  static constexpr int XS_SLABS = (GCP + BK - 1) / BK;
  static constexpr int XS_SLAB_BYTES = Tile::TH * Tile::TW * ROW_STRIDE;
  static constexpr int XS_BYTES = XS_SLABS * XS_SLAB_BYTES;
  static constexpr int W5F_BYTES = XS_SLABS * BK * SNR * ES;
  static constexpr int stage(bool ride_x) { return (Tile::A_BYTES + B_BYTES + (ride_x ? B5_BYTES : 0) + 127) / 128 * 128; }
  static constexpr int smem(bool ride_x) {
    return NR > 0 && XS_BYTES + W5F_BYTES > 2 * stage(ride_x) ? XS_BYTES + W5F_BYTES : 2 * stage(ride_x);
  }
};

// Copy the halo tile of channels c0 .. c0+BK-1 of src (rows of `stride`
// elements, ch real channels) into stage memory as, VB bytes a copy, zero
// outside the frame and beyond ch. Each copy's address is computed afresh:
// carried from copy to copy, it made a serial chain and the layers slower.
template <int VB, class Tile, typename T>
__device__ __forceinline__ void stage_halo(unsigned char* as, const T* src, int ch, int stride, int c0, int tx0, int ty0, int H,
                                           int W, int tid) {
  constexpr int ES = (int)sizeof(T), CPR = ROW_BYTES / VB;
  for (int i = tid; i < Tile::NPIX * CPR; i += Tile::THREADS) {
    const int pix = i / CPR, ci = i % CPR;
    const int iy = ty0 - 1 + pix / Tile::HWD, ix = tx0 - 1 + pix % Tile::HWD;
    const int cc = c0 + ci * (VB / ES);
    const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const int vb = inside ? max(0, min(VB, (ch - cc) * ES)) : 0;
    const T* gp = src + ((size_t)max(iy, 0) * W + max(ix, 0)) * stride + cc;
    stage_copy<VB>(as + pix * ROW_STRIDE + ci * VB, vb ? (const void*)gp : (const void*)src, vb);
  }
}

// One spatial layer: grid = (ceil(W/TW), ceil(H/TH), frames). The layer
// reads the feats segments below `layer` and writes segment `layer`, so one
// buffer is race free.
// Three blocks an SM where the ride is off (their shared memory leaves room
// for three): without the bound, the stripe masks' per-tap offsets, kept in
// registers across the slab loop, took 186 registers and left room for two.
// PAIR: two chains over one x, grid.z = 2 * frames (see the pair above).
template <typename T, class Tile, int GCP, bool STRIPE, int NR, bool TRUE_WIDTH, bool PAIR>
__global__ void __launch_bounds__(Tile::THREADS, NR > 0 ? 1 : 3) chain_layer_kernel(ChainLayerArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(dyn_smem);
  using SM = ChainSmem<T, Tile, GCP, NR>;
  constexpr bool RIDE = NR > 0;
  constexpr int BK = Elem<T>::BK, ES = (int)sizeof(T), MT = Tile::MT, NT = GCP / 8, NTR = RIDE ? NR / 8 : 1;
  constexpr int SN = SM::SN, SNR = SM::SNR, TW = Tile::TW, HWD = Tile::HWD, THREADS = Tile::THREADS;
  constexpr int ZROW = Tile::NPIX * ROW_WORDS;   // the stage's zero row, in words
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int H = p.H, W = p.W, C = p.C, gc = p.gc, layer = p.layer, fc = p.fc;
  const int seg = TRUE_WIDTH ? gc : GCP;   // lanes a feats segment
  const int cf = seg * layer;              // the feats lanes this layer reads
  const int cin = C + gc * layer;    // rows of one tap of w
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * Tile::TH;
  const bool second = PAIR && (blockIdx.z & 1);   // G's block of a pair
  const size_t frame = PAIR ? blockIdx.z >> 1 : blockIdx.z;
  const T* wp = second ? p.w_g : p.w;
  const T* bp = second ? p.b_g : p.b;
  const T* xf = p.x + frame * H * W * C;
  T* ff = (second ? p.feats_g : p.feats) + frame * H * W * fc;
  const int ns0 = (C + BK - 1) / BK;
  const int nslab = ns0 + (cf + BK - 1) / BK;
  const int sb = p.stage_bytes;
  const bool ride_x = RIDE && layer == 0;   // x's products with w5 ride this layer's slabs

  auto stage = [&](int slab, int st) {
    unsigned char* as = smem + st * sb;
    unsigned char* bs = as + Tile::A_BYTES;
    const bool fs = slab >= ns0;
    const int c0 = (fs ? slab - ns0 : slab) * BK;
    const int ch = fs ? cf : C;
    const T* src = fs ? (const T*)ff : xf;
    if (fs ? p.f_vec : p.x_vec)
      stage_halo<16, Tile>(as, src, ch, fs ? fc : C, c0, tx0, ty0, H, W, tid);
    else
      stage_halo<ES, Tile>(as, src, ch, fs ? fc : C, c0, tx0, ty0, H, W, tid);
    // the weight row of staged lane c0 + kk: x's row, or feats lane L's
    // C + gc*(L/GCP) + L%GCP (TRUE_WIDTH: C + L); -1 for a pad lane or
    // beyond the source
    auto wrow = [&](int kk) {
      const int c = c0 + kk;
      if (c >= ch) return -1;
      if (!fs) return c;
      if (TRUE_WIDTH) return C + c;
      const int l = c % GCP;
      return l < gc ? C + gc * (c / GCP) + l : -1;
    };
    // a thread keeps its (row, columns) pair over the nine taps, so the
    // remap runs once a pair and a slab; the taps' rows lie cin * gc apart
    const size_t tap_stride = (size_t)cin * gc;
    if (p.w_vec) {
      constexpr int CPB = GCP * ES / 16;   // 16-byte copies a staged weight row
      for (int i = tid; i < BK * CPB; i += THREADS) {
        const int kk = i / CPB, n = (i % CPB) * (16 / ES), r = wrow(kk);
        const int vb = r >= 0 ? max(0, min(16, (gc - n) * ES)) : 0;
        const T* gp = vb ? wp + (size_t)r * gc + n : wp;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          cp_async<16>(bs + ((tap * BK + kk) * SN + n) * ES, vb ? (const void*)(gp + tap * tap_stride) : (const void*)wp, vb);
      }
    } else {
      for (int i = tid; i < BK * GCP; i += THREADS) {
        const int kk = i / GCP, n = i % GCP, r = wrow(kk);
        const int vb = r >= 0 && n < gc ? ES : 0;
        const T* gp = vb ? wp + (size_t)r * gc + n : wp;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          stage_copy<ES>(bs + ((tap * BK + kk) * SN + n) * ES, vb ? (const void*)(gp + tap * tap_stride) : (const void*)wp, vb);
      }
    }
    if constexpr (RIDE) {
      if (ride_x) {   // w5's rows of this x slab, column n = tap * c_out + co
        const int c_out = p.c_out;
        for (int i = tid; i < BK * NR; i += THREADS) {
          const int kk = i / NR, n = i % NR;
          const int tap = n / c_out, co = n - tap * c_out;
          const bool ok = c0 + kk < C && n < 3 * c_out;
          const T* gp = p.w5 + ((size_t)min(tap, 2) * p.ctot + c0 + kk) * c_out + co;
          stage_copy<ES>(bs + SM::B_BYTES + (kk * SNR + n) * ES, ok ? (const void*)gp : (const void*)p.w5, ok ? ES : 0);
        }
      }
    }
  };

  // rows g and g+8 of fragment m: tile pixel r = (warp*MT + m)*16 + g (+8),
  // at (r / TW, r % TW); a0 / a1 the staged word offset of its window's corner
  int a0[MT], a1[MT];
  bool lmask[MT][2], rmask[MT][2];   // STRIPE: the pixel's column takes no dx = 0 / dx = 2 tap
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp * MT + m) * 16 + g + 8 * h;
      const int off = ((r / TW) * HWD + r % TW) * ROW_WORDS;
      if (h) a1[m] = off;
      else a0[m] = off;
      if (STRIPE) {
        const int col = (tx0 + r % TW) % p.stripe_w;
        lmask[m][h] = col == 0;
        rmask[m][h] = col == p.stripe_w - 1;
      }
    }

  // the zero row of both stages
  for (int i = tid; i < 2 * (ROW_BYTES / 4); i += THREADS)
    reinterpret_cast<uint32_t*>(smem + (i / (ROW_BYTES / 4)) * sb + Tile::NPIX * ROW_STRIDE)[i % (ROW_BYTES / 4)] = 0u;

  float acc[MT][NT][4], part[MT][NT][4];
  float racc[MT][NTR][4];   // the ride's three taps of this layer's products
  zero(acc);
  if constexpr (RIDE) zero(racc);

  stage(0, 0);
  cp_async_commit();
  for (int slab = 0; slab < nslab; ++slab) {
    cp_async_wait<0>();
    __syncthreads();   // this slab landed; every warp is done with the stage refilled below
    if (slab + 1 < nslab) stage(slab + 1, (slab + 1) & 1);
    cp_async_commit();
    const unsigned char* as = smem + (slab & 1) * sb;
    const T* bs = reinterpret_cast<const T*>(as + Tile::A_BYTES);
    const uint32_t* aw = reinterpret_cast<const uint32_t*>(as);
    zero(part);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dx = tap % 3;
      const int shift = ((tap / 3) * HWD + dx) * ROW_WORDS;
      int b0[MT], b1[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        b0[m] = a0[m];
        b1[m] = a1[m];
        if (STRIPE && dx != 1) {
          if (dx == 0 ? lmask[m][0] : rmask[m][0]) b0[m] = ZROW - shift;
          if (dx == 0 ? lmask[m][1] : rmask[m][1]) b1[m] = ZROW - shift;
        }
      }
      slab_mma<T, MT, NT, SN>(part, aw + shift, b0, b1, bs + tap * BK * SN, 0, g, t);
    }
    add_into(acc, part);
    if constexpr (RIDE) {
      if (ride_x)   // the center tap: x at the output pixel, against w5's x rows
        slab_mma<T, MT, NTR, SNR>(racc, aw + (HWD + 1) * ROW_WORDS, a0, a1, bs + SM::B_BYTES / ES, 0, g, t);
    }
  }

  // bias and LeakyReLU on the accumulators; pad lanes (co >= gc) hold 0
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = 8 * n + 2 * t + e;
      const float bias = co < gc ? to_f(bp[co]) : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = acc[m][n][2 * h + e] + bias;
          acc[m][n][2 * h + e] = co < gc ? (v >= 0.f ? v : CHAIN_SLOPE * v) : 0.f;
        }
    }

  if (p.write_feats) {
    const bool vec = ((fc | cf) & 1) == 0;   // a pair of lanes stays 8- (bf16: 4-) byte aligned
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp * MT + m) * 16 + g + 8 * h;
        const int oy = ty0 + r / TW, ox = tx0 + r % TW;
        if (oy >= H || ox >= W) continue;
        T* o = ff + ((size_t)oy * W + ox) * fc + cf;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int co = 8 * n + 2 * t;
          if (co >= seg) continue;
          const float v[2] = {acc[m][n][2 * h], acc[m][n][2 * h + 1]};
          store_pair(o + co, v, co + 1 < seg, vec ? 2 : 1);
        }
      }
  }

  if constexpr (RIDE) {
    __syncthreads();   // every warp is done with the ring (no copy is in flight)
    unsigned char* xs = smem;
    T* w5f = reinterpret_cast<T*>(smem + SM::XS_BYTES);
    // the tile's x_{k+1} in the working type, lanes GCP .. XS_SLABS*BK-1 zero
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp * MT + m) * 16 + g + 8 * h;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = 8 * n + 2 * t + e;
            T* d = reinterpret_cast<T*>(xs + (co / BK) * SM::XS_SLAB_BYTES + r * ROW_STRIDE) + co % BK;
            from_f(acc[m][n][2 * h + e], d);
            if (SM::XS_SLABS * BK > GCP) from_f(0.f, d + GCP);
          }
      }
    // w5's rows of x_{k+1}: lane l < gc is row C + gc*layer + l, column n =
    // tap * c_out + co; zero elsewhere
    const int c_out = p.c_out, row0 = C + gc * layer;
    for (int i = tid; i < SM::XS_SLABS * BK * NR; i += THREADS) {
      const int l = i / NR, n = i % NR;
      const int tap = n / c_out, co = n - tap * c_out;
      const bool ok = l < gc && n < 3 * c_out;
      from_f(ok ? to_f(p.w5[((size_t)tap * p.ctot + row0 + l) * c_out + co]) : 0.f, w5f + l * SNR + n);
    }
    __syncthreads();
    int q0[MT], q1[MT];   // rows g and g+8 of fragment m: tile pixels, in words
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      q0[m] = ((warp * MT + m) * 16 + g) * ROW_WORDS;
      q1[m] = q0[m] + 8 * ROW_WORDS;
    }
#pragma unroll
    for (int s = 0; s < SM::XS_SLABS; ++s)
      slab_mma<T, MT, NTR, SNR>(racc, reinterpret_cast<const uint32_t*>(xs + s * SM::XS_SLAB_BYTES), q0, q1, w5f + s * BK * SNR,
                                0, g, t);
    // each plane entry is this lane's alone in this launch
    const size_t HW = (size_t)H * W;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp * MT + m) * 16 + g + 8 * h;
        const int oy = ty0 + r / TW, ox = tx0 + r % TW;
        if (oy >= H || ox >= W) continue;
        const size_t pix = (size_t)oy * W + ox;
#pragma unroll
        for (int n = 0; n < NTR; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * t + e;
            if (col >= 3 * c_out) continue;
            const int tap = col / c_out, co = col - tap * c_out;
            float* d = p.partial + (((size_t)tap * p.frames + frame) * HW + pix) * c_out + co;
            const float v = racc[m][n][2 * h + e];
            *d = layer == 0 ? v : *d + v;
          }
      }
  }
}

// One spatial layer: a launch of chain_layer_kernel on SpatialTile (PAIR:
// of both chains of a pair, 2 * frames blocks along z).
template <typename T, int GCP, bool STRIPE, int NR, bool TRUE_WIDTH = false, bool PAIR = false>
int launch_chain_layer(ChainLayerArgs<T> p, int frames, cudaStream_t stream) {
  using Tile = SpatialTile;
  using SM = ChainSmem<T, Tile, GCP, NR>;
  const bool ride_x = NR > 0 && p.layer == 0;
  p.stage_bytes = SM::stage(ride_x);
  cudaError_t err =
      cudaFuncSetAttribute(chain_layer_kernel<T, Tile, GCP, STRIPE, NR, TRUE_WIDTH, PAIR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SM::smem(NR > 0));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + Tile::TW - 1) / Tile::TW, (p.H + Tile::TH - 1) / Tile::TH, frames * (PAIR ? 2 : 1));
  chain_layer_kernel<T, Tile, GCP, STRIPE, NR, TRUE_WIDTH, PAIR><<<grid, Tile::THREADS, SM::smem(ride_x), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tc
