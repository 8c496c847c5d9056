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
// are staged: buffer lane GCP*j + l is weight row C + gc*j + l for l < gc,
// and a pad lane meets zeros. dW and db are written in that layout at the
// true gc. The input concat is cut into chunks of GCP channels: x in runs of
// GCP (the last one may be short), feats one slot a chunk.
//
// What bounds it: operations. The two contractions of a layer each cost what
// the layer's forward costs (twice the forward in all), while every tensor is
// moved a few times at most. Every product runs on the tensor cores
// (csrc/tc_mma.cuh): mma.sync m16n8k8 TF32 with the 3xTF32 split, fp32 sums.
// The fragment loads split every operand value again, so the split is
// tc::split_tf32_fast (a mask and a subtraction, no conversion; ~2^-20 of a
// value kept where the rounded split keeps ~2^-22). dacc is fp32 in both
// dtypes; bf16 x, feats and weights are widened to fp32 as they are staged
// (exact in TF32), so a bf16 call computes what the fp32 products of its bf16
// values give.
//
// The running gradient lives in device memory as fp32 (dx and dfeats, split
// where the forward splits its two sources, so the 4*GCP feature channels of
// a pixel are 16-byte aligned whatever C is) and the sweep is a sequence of
// launches. Launch order gives the dependency: slot k of dfeats is complete
// before layer k reads it, and layer k only adds to slots below k. Slot k is
// turned into dacc in place once it is complete (slot 4 by a short first
// launch, slot k < 4 by layer k+1's data gradient, its last writer), pad
// lanes written as 0; from then on both contractions stage dacc with
// cp.async as it lies.
//
//   * data gradient, one launch a layer, an implicit GEMM as the forward's
//     layer (csrc/tc_chain.cuh): a block owns an 8 x 16-pixel tile and one
//     chunk over a group of frames; M = the tile's pixels, N = the chunk's
//     channels (8 or 16 for a short x chunk, else GCP), K = 9 taps x the GCP
//     lanes of dacc. B holds w_k's rows of the chunk for the flipped tap,
//     [tap][ci][16 co lanes] as they lie, staged once a block and read
//     transposed by the fragment loads; A is dacc's halo tile (80-byte rows:
//     a fragment's 8 rows meet 32 banks), shifted by the tap, one (frame,
//     slab) after another through a 2-stage ring. The stripe masks point a
//     lane's A row at the stage's zero row. Results are added into fp32 dx /
//     dfeats in place: blocks write disjoint elements, no atomics.
//   * weight gradient, one launch a layer: per tap a product with K = the
//     pixels, dW_tap = in(shifted)^T . dacc. A block has one warp a tap (9
//     warps): M = the chunk's channels (16 for a short x chunk, else GCP), N
//     = GCP output lanes; it walks a strided share of 8 x 16 pixel tiles of
//     every frame through a 2-stage cp.async ring ([pixel][channel] rows GCP
//     + 8 words apart: a fragment's loads, read along pixels, meet 32 banks),
//     each tile's products in a zeroed part added in fp32 (one accumulator
//     over all of a step's 72,576 pixels would drift), and writes its partial
//     sums to scratch. The chunks of a layer share the blocks, so a block
//     walks more tiles and leaves fewer partials. A second small launch adds
//     the partials in a fixed order, so dW and db are the same bits on every
//     run: no atomicAdd anywhere. The stripe masks zero a lane's dacc operand
//     for a pixel at an image edge where the warp's tap crosses it.
//
// tools/tc_attribution.py times B2 with each of these choices undone
// (rna_split, wg_one_block, dg_one_frame, wg_all_groups).
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include "tc_chain.cuh"

namespace {

using namespace tc;

constexpr int RED_THREADS = 256;
constexpr int DACC_THREADS = 256;
constexpr int WG_WARPS = 9;   // weight gradient: a warp a tap

// The chunk of [x | feats[slots < layer]] a block works on, GCP buffer
// channels wide: chunks below x_chunks lie in x (the last one may be short),
// the others are whole slots of feats, of which the first gc lanes are real.
struct Chunk {
  bool in_x;    // the chunk lies in x (else in feats)
  int c0;       // first channel inside its tensor
  int n;        // real channels of the chunk, <= GCP
  int row0;     // first row on the weights' Cin axis
  int stride;   // channels of a pixel in its tensor
  int slot;     // the feats slot (-1: x)
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
    k.slot = -1;
  } else {
    k.slot = chunk - x_chunks;
    k.c0 = k.slot * GCP;
    k.n = gc;
    k.row0 = C + k.slot * gc;
    k.stride = 4 * GCP;
  }
  return k;
}

__device__ __forceinline__ float lrelu_grad(float d, float out) { return out > 0.f ? d : CHAIN_SLOPE * d; }

// Rows of LANES elements into shared fp32 rows `sstride` words apart: row i
// from row(i) (null: a zero row), lanes from n on zero. fp32 by cp.async (16
// bytes a copy where vec, else 4); bf16 widened by plain loads and stores.
// `any` is a valid address for the copies that read nothing.
template <typename T, int LANES, int THREADS, class Row>
__device__ __forceinline__ void stage_rows(float* s, int sstride, int nrows, Row row, int n, bool vec, const void* any, int tid) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      constexpr int CPR = LANES / 4;
      for (int i = tid; i < nrows * CPR; i += THREADS) {
        const int r = i / CPR, j = 4 * (i % CPR);
        const T* src = row(r);
        const int vb = src ? max(0, min(16, (n - j) * 4)) : 0;
        cp_async<16>(s + r * sstride + j, vb ? (const void*)(src + j) : any, vb);
      }
    } else {
      for (int i = tid; i < nrows * LANES; i += THREADS) {
        const int r = i / LANES, j = i % LANES;
        const T* src = row(r);
        const int vb = src && j < n ? 4 : 0;
        cp_async<4>(s + r * sstride + j, vb ? (const void*)(src + j) : any, vb);
      }
    }
  } else {
    for (int i = tid; i < nrows * LANES; i += THREADS) {
      const int r = i / LANES, j = i % LANES;
      const T* src = row(r);
      s[r * sstride + j] = src && j < n ? to_f(src[j]) : 0.f;
    }
  }
}

// Slot `slot` of dfeats turned into that layer's dacc in place, pad lanes 0
// (the top slot: the others are turned by the data gradient that completes them).
template <typename T, int GCP>
__global__ void __launch_bounds__(DACC_THREADS) dacc_kernel(const T* feats, float* dfeats, size_t pixels, int slot, int gc) {
  constexpr int FC = 4 * GCP;
  const size_t n = pixels * GCP;
  for (size_t i = (size_t)blockIdx.x * DACC_THREADS + threadIdx.x; i < n; i += (size_t)gridDim.x * DACC_THREADS) {
    const int l = (int)(i % GCP);
    const size_t o = (i / GCP) * FC + GCP * slot + l;
    dfeats[o] = l < gc ? lrelu_grad(dfeats[o], to_f(feats[o])) : 0.f;
  }
}

template <typename T>
struct BwdArgs {
  const T* x;        // (frames, H, W, C)
  const T* feats;    // (frames, H, W, 4*GCP)
  const T* w;        // w_{layer+1} (3, 3, C + gc*layer, gc)
  float* dfeats;     // (frames, H, W, 4*GCP)
  float* dx;         // (frames, H, W, C)
  float* partial;    // weight gradient: (groups, 9*(C + gc*layer)*gc + gc)
  int frames, H, W, C, gc, layer, x_chunks, stripe_w;
  int w_vec, x_vec;  // fp32 weight rows / x rows allow 16-byte copies
};

// ---------------------------------------------------------------------------
// data gradient:
//   dst(q)[ci] += sum_{tap,co} dacc(q + tap - 1)[co] * w[8 - tap][ci][co]
// (the forward's tap (dy,dx) seen from the input pixel is (2-dy,2-dx), whose
// flat index is 8 - tap). dst is dx for a chunk of x, dfeats for a chunk of
// feats. grid = (tiles_x * tiles_y, chunks, frame groups), block =
// SpatialTile: a block stages the weight rows of its chunk once, then walks
// the (frame, slab) pairs of the frames blockIdx.z, blockIdx.z + gridDim.z,
// ... through a 2-stage ring of dacc's halo tiles, the next pair's tile in
// flight while the products of this one run.
// STRIPE: seen from the input pixel q, the staged column dx holds dacc(q + dx
// - 1) through the forward's tap 2 - dx, and that pair was masked where the
// output column q + dx - 1 lies in the next or the last stripe: no dx = 0
// term where q % WS == 0 and no dx = 2 term where q % WS == WS - 1, the
// forward's rule by the lane's own column.
// ---------------------------------------------------------------------------

template <int GCP>
struct DataGradSmem {
  static constexpr int SLABS = GCP / 16;                       // K slabs of 16 dacc lanes
  static constexpr int B_BYTES = 9 * GCP * ROW_STRIDE;         // a slab's [tap][ci][16 co lanes]
  static constexpr int A_BYTES = (SpatialTile::A_BYTES + 127) / 128 * 128;   // a slab's halo tile
  // the weights of every slab, then the ring's two halo tiles
  static constexpr int SMEM = SLABS * B_BYTES + 2 * A_BYTES;
  static constexpr int A0 = SLABS * B_BYTES;
};

// A data-gradient block's walk, with NTC n8 fragments of the chunk's
// channels (a short x chunk takes fewer than GCP/8); the weights' copies are
// in flight on entry.
template <typename T, int GCP, bool STRIPE, int NTC>
__device__ __forceinline__ void data_grad_walk(const BwdArgs<T>& p, const Chunk& ch, unsigned char* smem, int tx0, int ty0) {
  using Tile = SpatialTile;
  using SM = DataGradSmem<GCP>;
  constexpr int MT = Tile::MT, TW = Tile::TW, HWD = Tile::HWD, FC = 4 * GCP;
  constexpr int ZROW = Tile::NPIX * ROW_WORDS;   // the stage's zero row, in words
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int H = p.H, W = p.W, gc = p.gc;

  // rows g and g+8 of fragment m: tile pixel r = (warp*MT + m)*16 + g (+8);
  // STRIPE: bit 2m+h of lm / rm: that pixel's column takes no dx = 0 / dx = 2 term
  int a0[MT], a1[MT];
  unsigned lm = 0, rm = 0;
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
        lm |= (col == 0 ? 1u : 0u) << (2 * m + h);
        rm |= (col == p.stripe_w - 1 ? 1u : 0u) << (2 * m + h);
      }
    }

  // the (frame, slab) pairs of this block: pair u is slab u % SLABS of frame
  // blockIdx.z + (u / SLABS) * gridDim.z
  const int nu = ((p.frames - 1 - (int)blockIdx.z) / (int)gridDim.z + 1) * SM::SLABS;
  auto frame_of = [&](int u) { return (size_t)blockIdx.z + (size_t)(u / SM::SLABS) * gridDim.z; };
  auto stage = [&](int u, int st) {
    const float* da = p.dfeats + frame_of(u) * H * W * FC + GCP * p.layer;
    stage_halo<16, Tile>(smem + SM::A0 + st * SM::A_BYTES, da, GCP, FC, 16 * (u % SM::SLABS), tx0, ty0, H, W, tid);
  };

  float acc[MT][NTC][4], part[MT][NTC][4];
  stage(0, 0);
  cp_async_commit();
  for (int u = 0; u < nu; ++u) {
    cp_async_wait<0>();
    __syncthreads();   // pair u landed; every warp is done with the stage refilled below
    if (u + 1 < nu) stage(u + 1, (u + 1) & 1);
    cp_async_commit();
    const int s = u % SM::SLABS;
    const float* af = reinterpret_cast<const float*>(smem + SM::A0 + (u & 1) * SM::A_BYTES);
    const float* bsm = reinterpret_cast<const float*>(smem + s * SM::B_BYTES);
    if (s == 0) zero(acc);
    zero(part);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dx = tap % 3;
      const int shift = ((tap / 3) * HWD + dx) * ROW_WORDS;
      const unsigned mask = STRIPE ? (dx == 0 ? lm : (dx == 2 ? rm : 0u)) : 0u;
      int b0[MT], b1[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        b0[m] = (mask >> (2 * m)) & 1u ? ZROW : shift + a0[m];
        b1[m] = (mask >> (2 * m + 1)) & 1u ? ZROW : shift + a1[m];
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t ah[MT][4], al[MT][4], bh[NTC][2], bl[NTC][2];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* r0 = af + b0[m] + 8 * ks;
          const float* r1 = af + b1[m] + 8 * ks;
          split_tf32_fast(r0[t], ah[m][0], al[m][0]);
          split_tf32_fast(r1[t], ah[m][1], al[m][1]);
          split_tf32_fast(r0[t + 4], ah[m][2], al[m][2]);
          split_tf32_fast(r1[t + 4], ah[m][3], al[m][3]);
        }
#pragma unroll
        for (int n = 0; n < NTC; ++n) {   // B (k = co, n = ci): row ci of the tap, read along co
          const float* rn = bsm + (tap * GCP + 8 * n + g) * ROW_WORDS + 8 * ks;
          split_tf32_fast(rn[t], bh[n][0], bl[n][0]);
          split_tf32_fast(rn[t + 4], bh[n][1], bl[n][1]);
        }
        warp_mma_3xtf32<MT, NTC>(part, ah, al, bh, bl);
      }
    }
    add_into(acc, part);
    if (s < SM::SLABS - 1) continue;

    // dst += acc; the slot this launch completes (layer - 1) becomes dacc of
    // the layer below, pad lanes 0
    const size_t fpix = frame_of(u) * H * W;
    const bool last = !ch.in_x && ch.slot == p.layer - 1;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp * MT + m) * 16 + g + 8 * h;
        const int oy = ty0 + r / TW, ox = tx0 + r % TW;
        if (oy >= H || ox >= W) continue;
        const size_t pix = fpix + (size_t)oy * W + ox;
#pragma unroll
        for (int n = 0; n < NTC; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ci = 8 * n + 2 * t + e;
            const float v = acc[m][n][2 * h + e];
            if (ch.in_x) {
              if (ci < ch.n) p.dx[pix * p.C + ch.c0 + ci] += v;
            } else {
              float* d = p.dfeats + pix * FC + ch.c0 + ci;
              if (last)
                *d = ci < gc ? lrelu_grad(*d + v, to_f(p.feats[pix * FC + ch.c0 + ci])) : 0.f;
              else if (ci < gc)
                *d += v;
            }
          }
      }
  }
}

// Three blocks an SM: their shared memory leaves room for three, and the
// bound keeps the stripe masks' per-tap offsets from taking 255 registers.
template <typename T, int GCP, bool STRIPE>
__global__ void __launch_bounds__(SpatialTile::THREADS, 3) data_grad_kernel(BwdArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(dyn_smem);
  using Tile = SpatialTile;
  using SM = DataGradSmem<GCP>;
  constexpr int TW = Tile::TW, THREADS = Tile::THREADS;
  constexpr int ZROW = Tile::NPIX * ROW_WORDS;
  const int tid = threadIdx.x;
  const int gc = p.gc;
  const int tiles_x = (p.W + TW - 1) / TW;
  const int tx0 = (blockIdx.x % tiles_x) * TW, ty0 = (blockIdx.x / tiles_x) * Tile::TH;
  const Chunk ch = chunk_of<GCP>(blockIdx.y, p.x_chunks, p.C, gc);
  const int cin = p.C + gc * p.layer;
  // the chunk's channels the products read: a short x chunk's 8 or 16
  const int nrow = !ch.in_x ? GCP : ch.n <= 8 ? 8 : (ch.n <= 16 ? 16 : GCP);

  // the weight rows (tap, ci) = w[8 - tap][row0 + ci][16s ..], ci < nrow, of every slab
#pragma unroll
  for (int s = 0; s < SM::SLABS; ++s) {
    float* bs = reinterpret_cast<float*>(smem + s * SM::B_BYTES);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const T* w = p.w + ((size_t)(8 - tap) * cin + ch.row0) * gc + 16 * s;
      stage_rows<T, 16, THREADS>(bs + tap * GCP * ROW_WORDS, ROW_WORDS, nrow, [&](int ci) { return ci < ch.n ? w + (size_t)ci * gc : nullptr; },
                                 gc - 16 * s, p.w_vec, p.w, tid);
    }
  }
  for (int i = tid; i < 2 * ROW_WORDS; i += THREADS)
    reinterpret_cast<uint32_t*>(smem + SM::A0 + (i / ROW_WORDS) * SM::A_BYTES)[ZROW + i % ROW_WORDS] = 0u;

  if (ch.in_x && ch.n <= 8)
    data_grad_walk<T, GCP, STRIPE, 1>(p, ch, smem, tx0, ty0);
  else if (GCP > 16 && ch.in_x && ch.n <= 16)
    data_grad_walk<T, GCP, STRIPE, 2>(p, ch, smem, tx0, ty0);
  else
    data_grad_walk<T, GCP, STRIPE, GCP / 8>(p, ch, smem, tx0, ty0);
}

// ---------------------------------------------------------------------------
// weight and bias gradient of one layer, partial sums of one block, in the
// weights' own layout at the true gc:
//   partial[g][(tap * cin + row0 + ci) * gc + co] = sum over the block's pixels p of
//       [x | feats](p + tap - 1)[ci] * dacc(p)[co]
//   partial[g][9 * cin * gc + co]  = sum over the block's pixels of dacc(p)[co]
// for ci < n and co < gc. grid = (groups, chunks), 9 warps: warp k computes
// tap k. Block (g, chunk) walks over the pixel tiles g, g + groups, ... of all
// frames. STRIPE: a product whose tap crosses a stripe edge is dropped (the
// forward masked it): window column 0 where the pixel's column p % WS == 0,
// column 2 where p % WS == WS - 1.
// ---------------------------------------------------------------------------

template <int GCP>
struct WeightGradSmem {
  using Tile = SpatialTile;
  static constexpr int SW = b_stride(GCP);   // words between staged rows (GCP + 8)
  static constexpr int IN_FLOATS = Tile::NPIX * SW;                // [halo pixel][ci]
  static constexpr int DA_FLOATS = Tile::TH * Tile::TW * SW;       // [tile pixel][co]
  static constexpr int STAGE = ((IN_FLOATS + DA_FLOATS) * 4 + 127) / 128 * 128;
  static constexpr int SMEM = 2 * STAGE;
};

// The weight gradient's block with MT m16 fragments of the chunk's
// channels (a short x chunk takes one where GCP is 32).
template <typename T, int GCP, bool STRIPE, int MT>
__device__ __forceinline__ void weight_grad_block(const BwdArgs<T>& p, const Chunk& ch, unsigned char* smem) {
  using Tile = SpatialTile;
  using SM = WeightGradSmem<GCP>;
  constexpr int NT = GCP / 8, SW = SM::SW, TW = Tile::TW, HWD = Tile::HWD, FC = 4 * GCP;
  constexpr int THREADS = WG_WARPS * 32;
  const int tid = threadIdx.x, lane = tid & 31, tap = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int dy = tap / 3, dx = tap % 3;
  const int H = p.H, W = p.W, gc = p.gc, layer = p.layer;
  const int cin = p.C + gc * layer;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + Tile::TH - 1) / Tile::TH;
  const int n_tiles = tiles_x * tiles_y * p.frames;
  const bool vec = sizeof(T) == 4 && (ch.in_x ? p.x_vec : 1);
  const bool bias = blockIdx.y == 0 && tid < GCP;   // this thread sums db's lane tid

  auto stage = [&](int tile, int st) {
    float* in_s = reinterpret_cast<float*>(smem + st * SM::STAGE);
    float* da_s = in_s + SM::IN_FLOATS;
    const size_t frame = tile / (tiles_x * tiles_y);
    const int rem = tile % (tiles_x * tiles_y);
    const int ty0 = (rem / tiles_x) * Tile::TH, tx0 = (rem % tiles_x) * TW;
    const T* src = (ch.in_x ? p.x : p.feats) + frame * H * W * ch.stride + ch.c0;
    auto in_row = [&](int i) -> const T* {
      const int iy = ty0 - 1 + i / HWD, ix = tx0 - 1 + i % HWD;
      return iy >= 0 && iy < H && ix >= 0 && ix < W ? src + ((size_t)iy * W + ix) * ch.stride : nullptr;
    };
    stage_rows<T, 16 * MT, THREADS>(in_s, SW, Tile::NPIX, in_row, ch.n, vec, src, tid);
    const float* da = p.dfeats + frame * H * W * FC + GCP * layer;
    auto da_row = [&](int i) -> const float* {
      const int iy = ty0 + i / TW, ix = tx0 + i % TW;
      return iy < H && ix < W ? da + ((size_t)iy * W + ix) * FC : nullptr;
    };
    stage_rows<float, GCP, THREADS>(da_s, SW, Tile::TH * TW, da_row, GCP, true, da, tid);
  };

  float acc[MT][NT][4], part[MT][NT][4];
  float bsum = 0.f;
  zero(acc);
  int tile = blockIdx.x;
  if (tile < n_tiles) stage(tile, 0);
  cp_async_commit();
  for (int i = 0; tile < n_tiles; ++i, tile += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();   // tile i landed; every warp is done with the stage refilled below
    if (tile + (int)gridDim.x < n_tiles) stage(tile + gridDim.x, (i + 1) & 1);
    cp_async_commit();
    const float* in_s = reinterpret_cast<const float*>(smem + (i & 1) * SM::STAGE);
    const float* da_s = in_s + SM::IN_FLOATS;
    // STRIPE: bit 2*hh + j of the mask: pixel column 8*hh + t + 4*j of the
    // tile is at the stripe edge this warp's tap crosses
    unsigned mask = 0;
    if (STRIPE && dx != 1) {
      const int tx0 = (tile % (tiles_x * tiles_y)) % tiles_x * TW;
      const int edge = dx == 0 ? 0 : p.stripe_w - 1;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 2; ++j) mask |= ((tx0 + 8 * hh + t + 4 * j) % p.stripe_w == edge ? 1u : 0u) << (2 * hh + j);
    }
    zero(part);
#pragma unroll 2
    for (int ks = 0; ks < Tile::TH * 2; ++ks) {   // 8 pixels a k-step: tile row ks / 2, columns 8 * (ks % 2) ..
      const int r = ks >> 1, hh = ks & 1;
      const float* ap = in_s + ((r + dy) * HWD + 8 * hh + dx) * SW;   // A (m = ci, k = pixel)
      const float* bp = da_s + (r * TW + 8 * hh) * SW;               // B (k = pixel, n = co)
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        split_tf32_fast(ap[t * SW + 16 * m + g], ah[m][0], al[m][0]);
        split_tf32_fast(ap[t * SW + 16 * m + g + 8], ah[m][1], al[m][1]);
        split_tf32_fast(ap[(t + 4) * SW + 16 * m + g], ah[m][2], al[m][2]);
        split_tf32_fast(ap[(t + 4) * SW + 16 * m + g + 8], ah[m][3], al[m][3]);
      }
      const bool m0 = STRIPE && ((mask >> (2 * hh)) & 1u), m1 = STRIPE && ((mask >> (2 * hh + 1)) & 1u);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float v0 = bp[t * SW + 8 * n + g], v1 = bp[(t + 4) * SW + 8 * n + g];
        split_tf32_fast(m0 ? 0.f : v0, bh[n][0], bl[n][0]);
        split_tf32_fast(m1 ? 0.f : v1, bh[n][1], bl[n][1]);
      }
      warp_mma_3xtf32<MT, NT>(part, ah, al, bh, bl);
    }
    add_into(acc, part);
    if (bias) {   // four sums in a fixed order: a short dependency chain
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int q = 0; q < Tile::TH * TW; ++q) s4[q & 3] += da_s[q * SW + tid];
      bsum += (s4[0] + s4[1]) + (s4[2] + s4[3]);
    }
  }

  const size_t n_w = (size_t)9 * cin * gc;
  float* out = p.partial + (size_t)blockIdx.x * (n_w + gc);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = 16 * m + g + 8 * (i >> 1), co = 8 * n + 2 * t + (i & 1);
        if (ci < ch.n && co < gc) out[((size_t)tap * cin + ch.row0 + ci) * gc + co] = acc[m][n][i];
      }
  if (bias && tid < gc) out[n_w + tid] = bsum;
}

// Two blocks an SM: a few bytes of the accumulators spill, yet it ran faster
// than one block an SM without a spill (tools/tc_attribution.py's
// wg_one_block).
template <typename T, int GCP, bool STRIPE>
__global__ void __launch_bounds__(WG_WARPS * 32, 2) weight_grad_kernel(BwdArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(dyn_smem);
  const Chunk ch = chunk_of<GCP>(blockIdx.y, p.x_chunks, p.C, p.gc);
  if (GCP > 16 && ch.in_x && ch.n <= 16)
    weight_grad_block<T, GCP, STRIPE, 1>(p, ch, smem);
  else
    weight_grad_block<T, GCP, STRIPE, GCP / 16>(p, ch, smem);
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

template <typename T, int GCP, bool STRIPE>
int chain_backward_at(BwdArgs<T> p, const void* const* ws, void* const* dws, void* const* dbs, int groups, int need_dx, cudaStream_t stream) {
  const int x_chunks = (p.C + GCP - 1) / GCP;
  const int dx_chunks = need_dx ? x_chunks : 0;
  const int tiles = ((p.W + SpatialTile::TW - 1) / SpatialTile::TW) * ((p.H + SpatialTile::TH - 1) / SpatialTile::TH);
  const size_t pixels = (size_t)p.frames * p.H * p.W;
  cudaError_t err = cudaFuncSetAttribute(weight_grad_kernel<T, GCP, STRIPE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WeightGradSmem<GCP>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(data_grad_kernel<T, GCP, STRIPE>, cudaFuncAttributeMaxDynamicSharedMemorySize, DataGradSmem<GCP>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long dacc_blocks = ((long long)pixels * GCP + DACC_THREADS - 1) / DACC_THREADS;
  dacc_kernel<T, GCP><<<(unsigned)min(dacc_blocks, 65535LL * 8), DACC_THREADS, 0, stream>>>(p.feats, p.dfeats, pixels, 3, p.gc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int layer = 3; layer >= 0; --layer) {
    const int n_w = 9 * (p.C + p.gc * layer) * p.gc;
    p.layer = layer;
    p.w = (const T*)ws[layer];
    p.w_vec = sizeof(T) == 4 && p.gc % 4 == 0 && rows_aligned16(ws[layer], 16);
    p.x_chunks = x_chunks;
    // the weight gradient's blocks share `groups` among the chunks (one wave
    // of two blocks an SM where groups is twice the SM count), each block a
    // longer walk through the tiles and fewer partial sums to add
    const int wg = max(1, groups / (x_chunks + layer));
    weight_grad_kernel<T, GCP, STRIPE><<<dim3(wg, x_chunks + layer), WG_WARPS * 32, WeightGradSmem<GCP>::SMEM, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_partials_kernel<T><<<(n_w + p.gc + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0, stream>>>(p.partial, wg, n_w, p.gc, (T*)dws[layer], (T*)dbs[layer]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int chunks = dx_chunks + layer;
    if (chunks == 0) continue;  // nothing below the first layer but x
    p.x_chunks = dx_chunks;
    // frame groups: about two waves of three blocks an SM where groups is
    // twice the SM count
    const int fg = max(1, min(p.frames, (3 * groups + tiles * chunks - 1) / (tiles * chunks)));
    data_grad_kernel<T, GCP, STRIPE><<<dim3(tiles, chunks, fg), SpatialTile::THREADS, DataGradSmem<GCP>::SMEM, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, bool STRIPE>
int chain_backward_striped(BwdArgs<T> p, const void* const* ws, void* const* dws, void* const* dbs, int groups, int need_dx, cudaStream_t stream) {
  if (padded_gc(p.gc) == 16) return chain_backward_at<T, 16, STRIPE>(p, ws, dws, dbs, groups, need_dx, stream);
  return chain_backward_at<T, GC_MAX, STRIPE>(p, ws, dws, dbs, groups, need_dx, stream);
}

template <typename T>
int chain_backward(const void* x, const void* feats, const void* const* ws, void* dfeats, void* dx, void* const* dws, void* const* dbs, void* partial, int groups, int frames, int H, int W, int C, int gc, int need_dx, int stripe_w, cudaStream_t stream) {
  if (gc < 1 || gc > GC_MAX || frames < 1 || frames > 65535 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (stripe_w < 0 || (stripe_w > 0 && W % stripe_w != 0)) return (int)cudaErrorInvalidValue;
  BwdArgs<T> p{};
  p.x = (const T*)x;
  p.feats = (const T*)feats;
  p.dfeats = (float*)dfeats;
  p.dx = (float*)dx;
  p.partial = (float*)partial;
  p.frames = frames, p.H = H, p.W = W, p.C = C, p.gc = gc, p.stripe_w = stripe_w;
  p.x_vec = C % 4 == 0 && rows_aligned16(x, 16);
  if (stripe_w > 0) return chain_backward_striped<T, true>(p, ws, dws, dbs, groups, need_dx, stream);
  return chain_backward_striped<T, false>(p, ws, dws, dbs, groups, need_dx, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16: the type of x, feats, w1..w4, dw1..dw4 and
// db1..db4. dfeats, dx and partial are float32 whatever dtype is. Every
// pointer is aligned to 16 bytes.
// x (frames,H,W,C); feats (frames,H,W,4*GCP), the saved x1..x4 in the
//   forward's layout (GCP = selfc_dense_chain_bwd_padded_gc(gc)); w_k (3,3,C+gc(k-1),gc);
// dfeats (frames,H,W,4*GCP): on entry the gradient that reaches x1..x4 directly
//   (pad lanes must be finite), overwritten: each slot ends as its layer's
//   dacc, pad lanes 0;
// dx (frames,H,W,C): on entry the gradient that reaches x directly, on return
//   the whole gradient (untouched, and may be null, when need_dx is 0);
// dw_k, db_k: written, shaped as w_k and (gc);
// partial: scratch of groups * (9 * (C + 3 * gc) * gc + gc) floats, groups >= 1.
// 1 <= gc <= 32, frames <= 65535. stripe_w: 0, or the width of one image of a
// W-packed batch (W a multiple of it), whose forward masked the taps across
// stripe edges. Returns the first cudaError_t a launch reports, 0 when all
// were accepted.
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
// growth width gc (the forward's rule, tc::padded_gc).
extern "C" int selfc_dense_chain_bwd_padded_gc(int gc) { return tc::padded_gc(gc); }

extern "C" const char* selfc_bwd_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
