// Modulated deformable 3x3 convolution for Hopper (sm_90a): forward and
// backward on the tensor cores.
//
// Replaces selfc_tpu/ops/deform.py:_deform_tile_kernel (reached there through
// _deform_pallas_impl). The JAX package has no backward kernel: its custom VJP
// takes the gather composition's VJP. The backward here is written by hand.
// The function, channels-last, stride 1, padding 1:
//
//   for each output pixel p = (n, h, w) and tap k = 3i + j:
//     py = (h + i - 1) + offset[p][2k],   px = (w + j - 1) + offset[p][2k+1]
//     y0 = floor(py), x0 = floor(px), wy = py - y0, wx = px - x0
//     bil_k(p)[c] = sum over the four corners (y0 + sy, x0 + sx) inside the
//                   frame of w_corner(wy, wx) * x[n][y0 + sy][x0 + sx][c]
//   out[p][co] = sum_k sum_c S_k(p)[c] * weight[k][c][co],  S_k = mask[p][k] * bil_k(p)
//
// x (N,H,W,C), offset (N,H,W,18) with (dy, dx) of tap k at channels 2k and
// 2k+1 (torchvision's order), mask (N,H,W,9), weight (3,3,C,Cout) read as
// (9,C,Cout). The integer part of py is formed exactly and the offset added
// with one rounding, as the plain version forms it, so both floor the same
// float. The bias stays outside, as in the JAX package's Pallas path.
//
// Backward, for the output gradient g (N,H,W,Cout), with dval_k = g @ W_k^T:
//   dW_k     = sum_p S_k^T g
//   dmask_k  = <dval_k, bil_k>
//   doffset  = mask_k * <dval_k, d bil_k / d(wy, wx)>  (floor has no gradient;
//              a corner outside the frame contributes nothing)
//   dx       = scatter of mask_k * w_corner * dval_k to the four corners
//
// What bounds it on this card. The contraction is 2 C Cout operations a
// pixel and tap (3xTF32 at 495 / 3 TFLOP/s, or bf16), the sample 2 C a corner
// plus C (fp32 FMAs at 67); a pixel's x, offset, mask and out are read or
// written once: at the decode call's (16,270,480), C = Cout = 32, 38 GFLOP
// of contraction (0.23 ms), 5.4 of sample (0.08 ms) against 0.75 GB (0.23
// ms). On chip the gather moves far more: 4 corners x 9 taps x C channels a
// pixel, ~9.6 GB of L1 / shared-memory reads a decode call, ~36 reads of
// every x element (neighbouring pixels share most corners). Measured
// (tools/tc_attribution.py and the variants behind it, NVIDIA H100 80GB
// HBM3, PERF.md): the forward is held by the latency of each tap's chain
// (offsets -> corners -> products) more than by any one unit, the mma.sync
// products a third of it at the decode shape; the backward's dx, 72 M integer
// atomics at the training shape, ~35 % of it.
//
// Forward: an implicit GEMM, M = output pixels, N = Cout (a 32-column slab
// a blockIdx.y), K = 9 taps x C.
//   * A block owns an 8 x 16-pixel tile at a time (blocks walk the tiles,
//     two an SM) and stages W_k of every tap for its column slab and one
//     32-channel slab of C once a block where C <= 32, in the mma's
//     fragment order (a lane's B fragments of a k-step are 8-byte loads,
//     split hi / lo as loaded).
//   * For each tile it stages with cp.async the input window (the tile and
//     4 pixels around it, rows padded so that the 16-byte loads of two
//     neighbouring pixels meet other banks) and the tile's offsets and masks.
//     A corner inside the window is read from shared memory, one beyond it
//     from x (offsets are unbounded: every sample stays exact).
//   * A warp owns two rows of 16 pixels (two m16 fragments). Each lane forms
//     the masked bilinear samples of its fragment rows for the mma's K order
//     permuted so that lane t holds channels 8t .. 8t+7 of the slab: a
//     corner's contribution is two 16-byte loads (one in bf16). The samples
//     go from the loads straight into the fragments, each split into its TF32
//     hi / lo once, as it is formed (split_tf32_fast), or rounded to bf16
//     once (the JAX kernel's val.astype(img.dtype)). A tap's products go into
//     a zeroed part added in fp32 (the tensor cores' accumulator truncates).
//
// Backward: one block a (tile, tap), grid (tiles, 9), so that the blocks are
// short, independent and many (4,860 at the training shape), three an SM.
//   * dval = g W_k^T on the tensor cores (M = pixels, N = a 32-channel slab,
//     K = Cout), a warp its two rows; the tile's g staged with cp.async and
//     read by both products; W_k^T staged in fragment order, its N permuted
//     so that lane t holds channels 8j + 4e + t.
//   * each lane reads the four corners at those channels from x, forms bil
//     and its two derivatives, sums its terms of dmask and doffset (a
//     pixel's four lanes' sums are added by one thread in a fixed order:
//     the block owns the pixel's tap, so dmask and doffset are written, not
//     added), and stages S = mask * bil and dval.
//   * dx: mask * w_corner * dval at each corner, in 64-bit fixed point with
//     integer atomics (a corner has no fixed owner: offsets are unbounded).
//     Integer addition is associative, so dx is the same bits whatever order
//     the blocks run in, and no float atomic is left. A warp adds one
//     corner's 32 channels an instruction (lane = channel: two cache lines,
//     where the product's layout would touch eight: 8 pixels x 4 channels).
//   * dW_k of the tile = S^T g on the tensor cores (M = the slab's channels,
//     N = Cout, K = the tile's 128 pixels), a warp a 16 x 16 part in two
//     chains of k-steps, written to the tile's own slice of `partial`; a
//     launch adds the tiles' slices in a fixed order (32 outputs a block, 8
//     threads an output, each an eighth of the tiles, then the eight sums in
//     order), so dW is the same bits on every run.
//   The fixed point: dx_fixed holds round(v * 2^e) summed as two's complement
//   int64. e is chosen per call from order-independent maxima (a first
//   launch: max |mask|, max over pixels of sum_co |g|, max |w|) so that
//   36 N H W contributions (9 taps x 4 corners of every pixel), each at most
//   max|mask| * max_p |g_p|_1 * max|w|, sum to less than 2^61 in magnitude:
//   no sum can overflow (2 bits of headroom cover the fp32 rounding of a
//   contribution and of the bound). The resolution is 2^-e: at the
//   de-artifact training step's shape (62,208 pixels) a contribution bound
//   of 1 gives e = 35, 3e-11 absolute, far below an fp32 dx's own rounding.
//   A last launch converts the sums to x's dtype (one rounding).
//
// fp32 and bf16 in and out (every operand in one type). bf16 forward: bf16
// mma on the samples rounded to bf16. bf16 backward: the operands widened
// to fp32 as they are read (exact in TF32) and the fp32 path's 3xTF32 products,
// as csrc/dense_chain_bwd.cu does. Plain C interface (loaded with ctypes); the
// caller owns every buffer, the scratch included.

#include <algorithm>

#include "tc_mma.cuh"

namespace {

using namespace tc;

constexpr int KK = 9;           // taps of the 3x3 kernel
constexpr int SLAB = 32;        // channels a slab, in and out
constexpr int TW = 16;          // columns of a tile; a warp owns two of its rows
constexpr int WARPS = 4;        // a block: an 8 x 16-pixel tile
constexpr int THREADS = WARPS * 32;
constexpr int TILE_PIX = 2 * WARPS * TW;
constexpr int HALO = 4;         // the forward's staged input window: the tile and 4 pixels around it
constexpr int WIN_H = 2 * WARPS + 2 * HALO, WIN_W = TW + 2 * HALO, WIN_PIX = WIN_H * WIN_W;
constexpr int BLOCKS_PER_SM = 2;       // forward
constexpr int BWD_BLOCKS_PER_SM = 3;
constexpr int S_STRIDE = SLAB + 8;   // words between the staged sample's rows: lanes (g, t) reading row t, column g meet 32 banks
constexpr int AUX_THREADS = 256;
static_assert(TILE_PIX == THREADS, "one thread a tile pixel for the dmask / doffset sums");

// Bytes between the staged rows of a 32-channel slab (16-byte multiples;
// fp32 rows 4 words over 32, so the 8 lanes of a 16-byte load that read
// neighbouring pixels meet different banks)
template <typename T>
struct Row {
  static constexpr int BYTES = sizeof(T) == 4 ? SLAB * 4 + 16 : SLAB * 2;
};

// a tap's weights in fragment order, {b0, b1} of each lane: fp32 4 k-steps x
// 4 n8 fragments x 32 lanes (split as they are loaded), bf16 2 x 4 x 32
template <typename T>
struct WStage {
  static constexpr int BYTES = (sizeof(T) == 4 ? 4 : 2) * 4 * 32 * 8;
};

template <typename T>
struct DeformArgs {
  const T* x;            // (N,H,W,C)
  const T* offset;       // (N,H,W,18)
  const T* mask;         // (N,H,W,9)
  const T* w;            // (9,C,Cout)
  const T* g;            // (N,H,W,Cout), backward
  T* out;                // (N,H,W,Cout), forward
  T* dx;                 // (N,H,W,C)
  T* doffset;            // (N,H,W,18)
  T* dmask;              // (N,H,W,9)
  T* dw;                 // (9,C,Cout)
  unsigned long long* dx_fixed;   // (N*H*W*C) int64 sums of dx at scale 2^e
  float* partial;        // (tiles, 9*C*Cout) each tile's dW
  unsigned* bound;       // 3 maxima (as float bits): |mask|, sum_co |g|, |w|
  int N, H, W, C, Cout;
  int tiles_x, tiles_y;  // 8 x 16-pixel tiles of a frame
  int vec_x, vec_g;      // x's / g's rows allow 16-byte copies and loads
};

// Tap k of one pixel: corner (0,0) at row cy, column cx and flat pixel p00
// (meaningful where `valid` has a bit), bit s of `valid`: corner (s >> 1,
// s & 1) lies inside the frame; the fractional parts and the mask. A pixel
// beyond the frame has no corner.
struct Tap {
  int cy, cx, p00;
  unsigned valid;
  float wy, wx, m;
};

// The tile's offsets and masks, staged: TapRows<T>::OFF (TILE_PIX x 18) then
// MSK (TILE_PIX x 9), elements of T.
template <typename T>
struct TapRows {
  static constexpr int OFF = 0, MSK = TILE_PIX * 2 * KK * (int)sizeof(T);
  static constexpr int BYTES = (MSK + TILE_PIX * KK * (int)sizeof(T) + 15) / 16 * 16;
};

// Stage the offsets and masks of tile (n, ty0, tx0) (pixels beyond the frame
// are not written: no tap of theirs is formed).
template <typename T>
__device__ __forceinline__ void stage_taps(const DeformArgs<T>& p, unsigned char* dst, int n, int ty0, int tx0, int tid) {
  constexpr int ES = sizeof(T);
  T* so = reinterpret_cast<T*>(dst + TapRows<T>::OFF);
  T* sm = reinterpret_cast<T*>(dst + TapRows<T>::MSK);
  for (int i = tid; i < TILE_PIX * 3 * KK; i += THREADS) {
    const int r = i / (3 * KK), e = i % (3 * KK);
    const int y = ty0 + r / TW, x = tx0 + r % TW;
    if (y >= p.H || x >= p.W) continue;
    const size_t pix = ((size_t)n * p.H + y) * p.W + x;
    if (e < 2 * KK)
      stage_copy<ES>(so + r * 2 * KK + e, p.offset + pix * 2 * KK + e, ES);
    else
      stage_copy<ES>(sm + r * KK + e - 2 * KK, p.mask + pix * KK + e - 2 * KK, ES);
  }
}

// Tap k of the pixel (n, y, x) whose 18 offsets and 9 masks lie at so and sm
// (staged or in device memory); a pixel beyond the frame has no corner.
template <typename T>
__device__ __forceinline__ Tap tap_of(const DeformArgs<T>& p, const T* so, const T* sm, int n, int y, int x, int k) {
  Tap q{0, 0, 0, 0u, 0.f, 0.f, 0.f};
  if (y >= p.H || x >= p.W) return q;
  const float py = (float)(y + k / 3 - 1) + to_f(so[2 * k]);
  const float px = (float)(x + k % 3 - 1) + to_f(so[2 * k + 1]);
  const float y0 = floorf(py), x0 = floorf(px);
  q.wy = py - y0;
  q.wx = px - x0;
  q.m = to_f(sm[k]);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float yy = y0 + (float)(s >> 1), xx = x0 + (float)(s & 1);
    // compared as floats: an offset far outside never reaches an int conversion
    const bool inside = yy >= 0.f && yy <= (float)(p.H - 1) && xx >= 0.f && xx <= (float)(p.W - 1);
    q.valid |= (inside ? 1u : 0u) << s;
  }
  if (q.valid) {
    q.cy = (int)y0, q.cx = (int)x0;
    q.p00 = (n * p.H + q.cy) * p.W + q.cx;
  }
  return q;
}

__device__ __forceinline__ float corner_weight(int s, float wy, float wx) {
  return ((s >> 1) ? wy : 1.f - wy) * ((s & 1) ? wx : 1.f - wx);
}

__device__ __forceinline__ int corner_pixel(const Tap& q, int s, int W) { return q.p00 + (s >> 1) * W + (s & 1); }

// Corner s's row in the staged window whose pixel (0,0) is (wy0, wx0), or -1
// where it lies outside the window.
__device__ __forceinline__ int window_row(const Tap& q, int s, int wy0, int wx0) {
  const int a = q.cy + (s >> 1) - wy0, b = q.cx + (s & 1) - wx0;
  return (unsigned)a < (unsigned)WIN_H && (unsigned)b < (unsigned)WIN_W ? a * WIN_W + b : -1;
}

// Channels 0..7 of `row` as fp32, zero from channel n on (n <= 8); vec: the
// eight lie 16-byte aligned (two 16-byte loads in fp32, one in bf16).
template <typename T>
__device__ __forceinline__ void load8(const T* row, int n, bool vec, float (&v)[8]) {
  if (vec && n >= 8) {
    if constexpr (sizeof(T) == 4) {
      const float4 a = *reinterpret_cast<const float4*>(row);
      const float4 b = *reinterpret_cast<const float4*>(row + 4);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(row);
      const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w4[i] << 16);
        v[2 * i + 1] = __uint_as_float(w4[i] & 0xffff0000u);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < n ? to_f(row[i]) : 0.f;
}

// The 32-channel slab from channel c0 of the pixels pix(r), r < nrows (-1:
// skipped), of a source with ch channels a pixel, into shared rows
// Row<T>::BYTES apart; channels beyond ch are zero. vec: 16-byte copies
// (cp.async), else one element a copy.
template <typename T, class Pix>
__device__ __forceinline__ void stage_slab(unsigned char* dst, int nrows, Pix pix, const T* src, int ch, int c0, bool vec, int tid) {
  constexpr int ES = sizeof(T), EPC = 16 / ES, ROW = Row<T>::BYTES;
  if (vec) {
    for (int i = tid; i < nrows * (SLAB / EPC); i += THREADS) {
      const int r = i / (SLAB / EPC), c = c0 + (i % (SLAB / EPC)) * EPC;
      const int pp = pix(r);
      if (pp < 0) continue;
      const int vb = max(0, min(16, (ch - c) * ES));
      cp_async<16>(dst + r * ROW + (c - c0) * ES, vb ? (const void*)(src + (size_t)pp * ch + c) : (const void*)src, vb);
    }
  } else {
    for (int i = tid; i < nrows * SLAB; i += THREADS) {
      const int r = i / SLAB, c = c0 + i % SLAB;
      const int pp = pix(r);
      if (pp < 0) continue;
      const int vb = c < ch ? ES : 0;
      stage_copy<ES>(dst + r * ROW + (c - c0) * ES, vb ? (const void*)(src + (size_t)pp * ch + c) : (const void*)src, vb);
    }
  }
}

// The input window of a tile (rows ty0 - HALO .., columns tx0 - HALO ..) at
// C slab cs; its pixels outside the frame are not written (no corner reads them).
template <typename T>
__device__ __forceinline__ void stage_window(const DeformArgs<T>& p, unsigned char* win, int n, int ty0, int tx0, int cs, int tid) {
  const int wy0 = ty0 - HALO, wx0 = tx0 - HALO;
  stage_slab<T>(win, WIN_PIX, [&](int r) {
    const int y = wy0 + r / WIN_W, x = wx0 + r % WIN_W;
    return y >= 0 && y < p.H && x >= 0 && x < p.W ? (n * p.H + y) * p.W + x : -1;
  }, p.x, p.C, cs * SLAB, p.vec_x != 0, tid);
}

// The masked sample of one tap at the lane's channels c0 .. c0+7 of the
// slab (nc of them real; t: c0 is the slab's channel 8t), each corner from
// the window where it lies inside it, else from x.
template <typename T>
__device__ __forceinline__ void sample8(const DeformArgs<T>& p, const Tap& q, const unsigned char* win, int wy0, int wx0, int t, int c0,
                                        int nc, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (!((q.valid >> s) & 1u)) continue;
    const float cw = q.m * corner_weight(s, q.wy, q.wx);
    const int r = window_row(q, s, wy0, wx0);
    float v8[8];
    if (r >= 0)
      load8(reinterpret_cast<const T*>(win + r * Row<T>::BYTES) + 8 * t, 8, true, v8);
    else
      load8(p.x + (size_t)corner_pixel(q, s, p.W) * p.C + c0, nc, p.vec_x != 0, v8);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += cw * v8[i];
  }
}

template <typename T>
__device__ __forceinline__ float w_at(const DeformArgs<T>& p, int k, int c, int co) {
  return c < p.C && co < p.Cout ? to_f(p.w[((size_t)k * p.C + c) * p.Cout + co]) : 0.f;
}

template <typename T>
__device__ __forceinline__ uint32_t w_bits(const DeformArgs<T>& p, int k, int c, int co) {
  if (c >= p.C || co >= p.Cout) return 0u;
  uint16_t u;
  memcpy(&u, p.w + ((size_t)k * p.C + c) * p.Cout + co, 2);
  return u;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat16 a = __float2bfloat16(lo), b = __float2bfloat16(hi);
  uint16_t ua, ub;
  memcpy(&ua, &a, 2);
  memcpy(&ub, &b, 2);
  return (uint32_t)ua | ((uint32_t)ub << 16);
}

__device__ __forceinline__ void tile_of(int tile, int tiles_x, int tiles_y, int& n, int& ty0, int& tx0) {
  tx0 = (tile % tiles_x) * TW;
  ty0 = ((tile / tiles_x) % tiles_y) * (2 * WARPS);
  n = tile / (tiles_x * tiles_y);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Tap k's weights for the forward's product (B: k = c, n = co) of C slab cs
// and Cout slab qs into `dst` in fragment order. The K order matches the
// samples': fp32 k-step ks, rows t / t+4 <- channels 8t + 2ks / +1; bf16
// k-step ks, rows 2t, 2t+1 / 2t+8, 2t+9 <- channels 8t + 4ks + 0, 1 / 2, 3.
template <typename T>
__device__ __forceinline__ void stage_w_fwd(const DeformArgs<T>& p, unsigned char* dst, int k, int cs, int qs, int tid) {
  if constexpr (sizeof(T) == 4) {
    float2* s = reinterpret_cast<float2*>(dst);
    for (int e = tid; e < 4 * 4 * 32; e += THREADS) {
      const int lane = e & 31, j = (e >> 5) & 3, ks = e >> 7;
      const int c = cs * SLAB + 8 * (lane & 3) + 2 * ks, co = qs * SLAB + 8 * j + (lane >> 2);
      s[e] = make_float2(w_at(p, k, c, co), w_at(p, k, c + 1, co));
    }
  } else {
    uint2* s = reinterpret_cast<uint2*>(dst);
    for (int e = tid; e < 2 * 4 * 32; e += THREADS) {
      const int lane = e & 31, j = (e >> 5) & 3, ks = e >> 7;
      const int c = cs * SLAB + 8 * (lane & 3) + 4 * ks, co = qs * SLAB + 8 * j + (lane >> 2);
      s[e] = make_uint2(w_bits(p, k, c, co) | (w_bits(p, k, c + 1, co) << 16),
                        w_bits(p, k, c + 2, co) | (w_bits(p, k, c + 3, co) << 16));
    }
  }
}

// One tap's products of a warp: 2 m16 fragments (v[m][h]: row g + 8h) x 4 n8.
template <typename T>
__device__ __forceinline__ void fwd_mma(float (&part)[2][4][4], const float (&v)[2][2][8], const unsigned char* ws, int lane) {
  if constexpr (sizeof(T) == 4) {
    const float2* s = reinterpret_cast<const float2*>(ws);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        split_tf32_fast(v[m][0][2 * ks], ah[m][0], al[m][0]);
        split_tf32_fast(v[m][1][2 * ks], ah[m][1], al[m][1]);
        split_tf32_fast(v[m][0][2 * ks + 1], ah[m][2], al[m][2]);
        split_tf32_fast(v[m][1][2 * ks + 1], ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 b = s[(ks * 4 + j) * 32 + lane];
        split_tf32_fast(b.x, bh[j][0], bl[j][0]);
        split_tf32_fast(b.y, bh[j][1], bl[j][1]);
      }
      warp_mma_3xtf32<2, 4>(part, ah, al, bh, bl);
    }
  } else {
    const uint2* s = reinterpret_cast<const uint2*>(ws);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        a[m][0] = bf16_pair(v[m][0][4 * ks], v[m][0][4 * ks + 1]);
        a[m][1] = bf16_pair(v[m][1][4 * ks], v[m][1][4 * ks + 1]);
        a[m][2] = bf16_pair(v[m][0][4 * ks + 2], v[m][0][4 * ks + 3]);
        a[m][3] = bf16_pair(v[m][1][4 * ks + 2], v[m][1][4 * ks + 3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint2 u = s[(ks * 4 + j) * 32 + lane];
        b[j][0] = u.x, b[j][1] = u.y;
      }
      warp_mma_bf16<2, 4>(part, a, b);
    }
  }
}

template <typename T>
struct FwdSmem {
  static constexpr int W_BYTES = KK * WStage<T>::BYTES;      // every tap's weights of a (C, Cout) slab pair
  static constexpr int WIN = W_BYTES, TAPS = WIN + WIN_PIX * Row<T>::BYTES;
  static constexpr int BYTES = TAPS + TapRows<T>::BYTES;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) deform_forward_kernel(DeformArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  unsigned char* ws = reinterpret_cast<unsigned char*>(dyn_smem);
  unsigned char* win = ws + FwdSmem<T>::WIN;
  unsigned char* taps = ws + FwdSmem<T>::TAPS;
  constexpr int WB = WStage<T>::BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qs = blockIdx.y;
  const int ncs = (p.C + SLAB - 1) / SLAB;
  const int tiles = p.tiles_x * p.tiles_y * p.N;
  int staged = -1;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int n, ty0, tx0;
    tile_of(tile, p.tiles_x, p.tiles_y, n, ty0, tx0);
    const int y0 = ty0 + 2 * warp, wy0 = ty0 - HALO, wx0 = tx0 - HALO;
    float acc[2][4][4];
    zero(acc);
    for (int cs = 0; cs < ncs; ++cs) {
      __syncthreads();   // every warp is done with the window (and the weights, where they change)
      if (cs != staged) {   // uniform over the block: once a block where C <= 32
#pragma unroll 1
        for (int k = 0; k < KK; ++k) stage_w_fwd(p, ws + k * WB, k, cs, qs, tid);
        staged = cs;
      }
      stage_window(p, win, n, ty0, tx0, cs, tid);
      if (cs == 0) stage_taps(p, taps, n, ty0, tx0, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const int c0 = cs * SLAB + 8 * t, nc = min(8, p.C - c0);
#pragma unroll 1
      for (int k = 0; k < KK; ++k) {
        float v[2][2][8];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tp = 32 * warp + 16 * m + g + 8 * h;   // the tile pixel of fragment m's row g + 8h
            const Tap q = tap_of(p, reinterpret_cast<const T*>(taps + TapRows<T>::OFF) + tp * 2 * KK,
                                 reinterpret_cast<const T*>(taps + TapRows<T>::MSK) + tp * KK, n, y0 + m, tx0 + g + 8 * h, k);
            sample8(p, q, win, wy0, wx0, t, c0, nc, v[m][h]);
          }
        float part[2][4][4];
        zero(part);
        fwd_mma<T>(part, v, ws + k * WB, lane);
        add_into(acc, part);
      }
    }
    // fragment (m, j): rows g / g+8 of the warp's row m, columns qs*32 + 8j + 2t, +1
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = y0 + m, x = tx0 + g + 8 * h;
        if (y >= p.H || x >= p.W) continue;
        const size_t pix = ((size_t)n * p.H + y) * p.W + x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = qs * SLAB + 8 * j + 2 * t;
          if (col >= p.Cout) continue;
          const float o[2] = {acc[m][j][2 * h], acc[m][j][2 * h + 1]};
          store_pair(p.out + pix * p.Cout + col, o, col + 1 < p.Cout, p.Cout);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdSmem {
  static constexpr int S = 0;                                // the tile's masked sample of a C slab
  static constexpr int DV = S + TILE_PIX * S_STRIDE * 4;    // the tile's dval of a C slab, [pixel][channel]
  static constexpr int CW = DV + TILE_PIX * SLAB * 4;       // each pixel's corner weights (x mask), 0 where outside
  static constexpr int TGT = CW + TILE_PIX * 4 * 4;         // each pixel's corner pixels, -1 where outside
  static constexpr int W0 = TGT + TILE_PIX * 4 * 4;         // W_k^T of a (C, Cout) slab pair in fragment order
  static constexpr int GT = W0 + 4 * 4 * 32 * 8;            // the tile's g of a Cout slab, rows Row<T>::BYTES apart
  template <typename T>
  static constexpr int bytes() { return GT + TILE_PIX * Row<T>::BYTES; }
};

// Tap k's W^T for dval (B: k = co, n = c) of C slab cs and Cout slab qs, in
// fragment order: k-step ks, rows t / t+4 <- co 8t + 2ks / +1 (g's K order);
// column g of n8 fragment j <- channel 8j + 4 (g & 1) + (g >> 1), so that the
// accumulator's columns 2t, 2t+1 hold channels 8j + t, 8j + 4 + t.
template <typename T>
__device__ __forceinline__ void stage_wt(const DeformArgs<T>& p, unsigned char* dst, int k, int cs, int qs, int tid) {
  float2* s = reinterpret_cast<float2*>(dst);
  for (int e = tid; e < 4 * 4 * 32; e += THREADS) {
    const int lane = e & 31, j = (e >> 5) & 3, ks = e >> 7;
    const int gg = lane >> 2, tt = lane & 3;
    const int co = qs * SLAB + 8 * tt + 2 * ks, c = cs * SLAB + 8 * j + 4 * (gg & 1) + (gg >> 1);
    s[e] = make_float2(w_at(p, k, c, co), w_at(p, k, c, co + 1));
  }
}

// 2^e of the fixed point: the order-independent maxima in `bound` put every
// sum of 36 * npix contributions below 2^61 in magnitude.
__device__ __forceinline__ int fixed_point_exponent(const unsigned* bound, size_t npix) {
  const double top = (double)__uint_as_float(bound[0]) * (double)__uint_as_float(bound[1]) *
                     (double)__uint_as_float(bound[2]) * 36.0 * (double)npix;
  if (!(top > 0.0 && top < 1e300)) return 0;   // nothing to add (or a non-finite input: no scale helps)
  int ex;
  frexp(top, &ex);                 // top < 2^ex
  return max(-120, min(120, 61 - ex));
}

// One block a (tile, tap): grid (tiles, 9).
template <typename T>
__global__ void __launch_bounds__(THREADS, BWD_BLOCKS_PER_SM) deform_backward_kernel(DeformArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(dyn_smem);
  T* s_g = reinterpret_cast<T*>(smem + BwdSmem::GT);
  float* s_tile = reinterpret_cast<float*>(smem + BwdSmem::S);
  float* s_dv = reinterpret_cast<float*>(smem + BwdSmem::DV);
  float* s_cw = reinterpret_cast<float*>(smem + BwdSmem::CW);
  int* s_tgt = reinterpret_cast<int*>(smem + BwdSmem::TGT);
  const float2* ws = reinterpret_cast<const float2*>(smem + BwdSmem::W0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int C = p.C, Cout = p.Cout, W = p.W;
  const int ncs = (C + SLAB - 1) / SLAB, nqs = (Cout + SLAB - 1) / SLAB;
  const int tile = blockIdx.x, k = blockIdx.y;
  int n, ty0, tx0;
  tile_of(tile, p.tiles_x, p.tiles_y, n, ty0, tx0);
  const int y0 = ty0 + 2 * warp;
  const float scale = ldexpf(1.f, fixed_point_exponent(p.bound, (size_t)p.N * p.H * W));
  const size_t n_w = (size_t)KK * C * Cout;
  float* part_w = p.partial + (size_t)tile * n_w;   // this tile's dW, written once

  Tap q[2][2];   // tap k of fragment m's row g + 8h
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = y0 + m, x = tx0 + g + 8 * h;
      const size_t pix = ((size_t)n * p.H + min(y, p.H - 1)) * W + min(x, W - 1);   // tap_of reads nothing beyond the frame
      q[m][h] = tap_of(p, p.offset + pix * 2 * KK, p.mask + pix * KK, n, y, x, k);
    }
  float sums[2][2][3];   // this lane's channels' terms of dmask, d/dwy, d/dwx
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) sums[m][h][0] = sums[m][h][1] = sums[m][h][2] = 0.f;
  const bool one_slab = ncs == 1 && nqs == 1;   // W_k^T staged once, its loads beside the taps' and g's
  if (one_slab) stage_wt(p, smem + BwdSmem::W0, k, 0, 0, tid);
  // the tile's g of Cout slab qs (rows of pixels beyond the frame zero),
  // copies in flight until the next barrier; restaged where Cout > 32
  int g_slab = 0;
  auto stage_g = [&](int qs) {
    stage_slab<T>(smem + BwdSmem::GT, TILE_PIX, [&](int r) {
      const int y = ty0 + r / TW, x = tx0 + r % TW;
      return y < p.H && x < W ? (n * p.H + y) * W + x : -1;
    }, p.g, Cout, qs * SLAB, p.vec_g != 0, tid);
    cp_async_commit();
    if (ty0 + tid / TW >= p.H || tx0 + tid % TW >= W)
      for (int e = 0; e < SLAB; ++e) from_f(0.f, s_g + tid * (Row<T>::BYTES / (int)sizeof(T)) + e);
  };
  auto use_g = [&](int qs) {   // uniform over the block
    if (qs == g_slab) return;
    __syncthreads();
    stage_g(qs);
    cp_async_wait<0>();
    __syncthreads();
    g_slab = qs;
  };
  stage_g(0);

#pragma unroll 1
  for (int cs = 0; cs < ncs; ++cs) {
    // dval of the warp's rows at channels cs*32 + 8j + 4e + t: dv[m][j][2h + e]
    float dv[2][4][4];
    zero(dv);
#pragma unroll 1
    for (int qs = 0; qs < nqs; ++qs) {
      use_g(qs);
      cp_async_wait<0>();
      __syncthreads();   // g landed; every warp is done with the stage and the sample refilled below (one_slab: staged)
      if (!one_slab) {
        stage_wt(p, smem + BwdSmem::W0, k, cs, qs, tid);
        __syncthreads();
      }
      float gv[2][2][8];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          load8(s_g + (32 * warp + 16 * m + g + 8 * h) * (Row<T>::BYTES / (int)sizeof(T)) + 8 * t, 8, true, gv[m][h]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          split_tf32_fast(gv[m][0][2 * ks], ah[m][0], al[m][0]);
          split_tf32_fast(gv[m][1][2 * ks], ah[m][1], al[m][1]);
          split_tf32_fast(gv[m][0][2 * ks + 1], ah[m][2], al[m][2]);
          split_tf32_fast(gv[m][1][2 * ks + 1], ah[m][3], al[m][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 b = ws[(ks * 4 + j) * 32 + lane];
          split_tf32_fast(b.x, bh[j][0], bl[j][0]);
          split_tf32_fast(b.y, bh[j][1], bl[j][1]);
        }
        warp_mma_3xtf32<2, 4>(dv, ah, al, bh, bl);
      }
    }

    // the corners at this lane's channels: bil, its derivatives, S, the sums;
    // dval and the corners' weights and pixels staged for dx
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Tap& qq = q[m][h];
        const int tp = 32 * warp + 16 * m + g + 8 * h;   // tile pixel of row g + 8h of fragment m
        size_t cbase[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const bool ok = (qq.valid >> s) & 1u;
          cbase[s] = ok ? (size_t)corner_pixel(qq, s, W) * C : 0;
          if (t == 0) {
            s_cw[tp * 4 + s] = qq.m * corner_weight(s, qq.wy, qq.wx);
            s_tgt[tp * 4 + s] = ok ? corner_pixel(qq, s, W) : -1;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = 8 * j + 4 * e + t, c = cs * SLAB + cl;
            const bool cok = c < C;
            float v[4];
#pragma unroll
            for (int s = 0; s < 4; ++s) v[s] = cok && ((qq.valid >> s) & 1u) ? to_f(p.x[cbase[s] + c]) : 0.f;
            const float wy = qq.wy, wx = qq.wx;
            const float bil = (1.f - wy) * ((1.f - wx) * v[0] + wx * v[1]) + wy * ((1.f - wx) * v[2] + wx * v[3]);
            const float d = dv[m][j][2 * h + e];
            sums[m][h][0] += d * bil;
            sums[m][h][1] += d * ((1.f - wx) * (v[2] - v[0]) + wx * (v[3] - v[1]));
            sums[m][h][2] += d * ((1.f - wy) * (v[1] - v[0]) + wy * (v[3] - v[2]));
            s_tile[tp * S_STRIDE + cl] = qq.m * bil;
            s_dv[tp * SLAB + cl] = d;
          }
      }
    __syncthreads();   // the tile's S, dval and corners of this slab are staged

    // dx: mask * w_corner * dval added to each corner, a warp its 32 pixels,
    // one corner's 32 channels an atomic instruction (lane = channel)
    {
      const int c = cs * SLAB + lane;
#pragma unroll 1
      for (int tp = 32 * warp; tp < 32 * warp + 32; ++tp) {
        const float d = s_dv[tp * SLAB + lane];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int tgt = s_tgt[tp * 4 + s];
          if (tgt >= 0 && c < C)
            atomicAdd(p.dx_fixed + (size_t)tgt * C + c, (unsigned long long)__float2ll_rn(s_cw[tp * 4 + s] * d * scale));
        }
      }
    }

    // dW_k[cs*32 + 16 mw + (g, g+8)][qs*32 + 16 nw + 8 nn + 2t, +1] over the tile's pixels
    const int mw = warp >> 1, nw = warp & 1;
#pragma unroll 1
    for (int qs = 0; qs < nqs; ++qs) {
      use_g(qs);
      float d2[1][2][4], d2b[1][2][4];   // even and odd k-steps: two shorter chains of products
      zero(d2);
      zero(d2b);
#pragma unroll 4
      for (int kk = 0; kk < TILE_PIX / 8; ++kk) {
        const int p0 = 8 * kk + t, p1 = p0 + 4;
        uint32_t ah[1][4], al[1][4], bh[2][2], bl[2][2];
        const int r0 = 16 * mw + g;
        split_tf32_fast(s_tile[p0 * S_STRIDE + r0], ah[0][0], al[0][0]);
        split_tf32_fast(s_tile[p0 * S_STRIDE + r0 + 8], ah[0][1], al[0][1]);
        split_tf32_fast(s_tile[p1 * S_STRIDE + r0], ah[0][2], al[0][2]);
        split_tf32_fast(s_tile[p1 * S_STRIDE + r0 + 8], ah[0][3], al[0][3]);
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const int col = 16 * nw + 8 * nn + g;
          constexpr int RE = Row<T>::BYTES / (int)sizeof(T);
          split_tf32_fast(to_f(s_g[p0 * RE + col]), bh[nn][0], bl[nn][0]);
          split_tf32_fast(to_f(s_g[p1 * RE + col]), bh[nn][1], bl[nn][1]);
        }
        if (kk & 1)
          warp_mma_3xtf32<1, 2>(d2b, ah, al, bh, bl);
        else
          warp_mma_3xtf32<1, 2>(d2, ah, al, bh, bl);
      }
      add_into(d2, d2b);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = cs * SLAB + 16 * mw + g + 8 * (r >> 1), co = qs * SLAB + 16 * nw + 8 * nn + 2 * t + (r & 1);
          if (c < C && co < Cout) part_w[((size_t)k * C + c) * Cout + co] = d2[0][nn][r];
        }
    }
  }

  // dmask and doffset of tap k: a pixel's four lanes' sums added in a fixed
  // order; [term][lane t] in the pixel's row of s_dv, which only this warp
  // reads (its own 32 pixels)
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tp = 32 * warp + 16 * m + g + 8 * h;
#pragma unroll
      for (int r = 0; r < 3; ++r) s_dv[tp * SLAB + r * 4 + t] = sums[m][h][r];
    }
  __syncthreads();
  const int y = ty0 + tid / TW, x = tx0 + tid % TW;
  if (y < p.H && x < W) {
    const size_t pix = ((size_t)n * p.H + y) * W + x;
    float s3[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* rr = s_dv + tid * SLAB + r * 4;
      s3[r] = ((rr[0] + rr[1]) + rr[2]) + rr[3];
    }
    const float mk = to_f(p.mask[pix * KK + k]);
    from_f(s3[0], p.dmask + pix * KK + k);
    from_f(mk * s3[1], p.doffset + pix * (2 * KK) + 2 * k);
    from_f(mk * s3[2], p.doffset + pix * (2 * KK) + 2 * k + 1);
  }
}

// The order-independent maxima the fixed point's scale is chosen from:
// bound[0] = max |mask|, bound[1] = max over pixels of sum_co |g|, bound[2] =
// max |w|, as the bits of non-negative floats (their order as unsigned ints
// is their order as floats), each block's maximum added by atomicMax.
template <typename T>
__global__ void __launch_bounds__(AUX_THREADS) bound_kernel(DeformArgs<T> p) {
  __shared__ float red[3][AUX_THREADS];
  const int tid = threadIdx.x;
  const size_t npix = (size_t)p.N * p.H * p.W, n_w = (size_t)KK * p.C * p.Cout;
  const size_t stride = (size_t)gridDim.x * AUX_THREADS;
  float bm = 0.f, bg = 0.f, bw = 0.f;
  for (size_t i = (size_t)blockIdx.x * AUX_THREADS + tid; i < npix; i += stride) {
    for (int k = 0; k < KK; ++k) bm = fmaxf(bm, fabsf(to_f(p.mask[i * KK + k])));
    float s = 0.f;
    for (int co = 0; co < p.Cout; co += 8) {
      float v[8];
      load8(p.g + i * p.Cout + co, min(8, p.Cout - co), p.vec_g != 0, v);
      for (int e = 0; e < 8; ++e) s += fabsf(v[e]);
    }
    bg = fmaxf(bg, s);
  }
  for (size_t i = (size_t)blockIdx.x * AUX_THREADS + tid; i < n_w; i += stride) bw = fmaxf(bw, fabsf(to_f(p.w[i])));
  red[0][tid] = bm, red[1][tid] = bg, red[2][tid] = bw;
  __syncthreads();
  for (int s = AUX_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int r = 0; r < 3; ++r) red[r][tid] = fmaxf(red[r][tid], red[r][tid + s]);
    __syncthreads();
  }
  if (tid == 0)
    for (int r = 0; r < 3; ++r) atomicMax(p.bound + r, __float_as_uint(red[r][0]));
}

// dx = dx_fixed * 2^-e in x's dtype (one rounding)
template <typename T>
__global__ void __launch_bounds__(AUX_THREADS) dx_convert_kernel(DeformArgs<T> p) {
  const size_t n = (size_t)p.N * p.H * p.W * p.C;
  const float inv = ldexpf(1.f, -fixed_point_exponent(p.bound, (size_t)p.N * p.H * p.W));
  for (size_t i = (size_t)blockIdx.x * AUX_THREADS + threadIdx.x; i < n; i += (size_t)gridDim.x * AUX_THREADS)
    from_f(__ll2float_rn((long long)p.dx_fixed[i]) * inv, p.dx + i);
}

// dW[e] = the tiles' partials added in a fixed order: a block takes 32
// outputs, 8 threads an output; thread j adds the partials of its eighth of
// the tiles in tile order, then the eight sums are added in order j = 0..7.
template <typename T>
__global__ void __launch_bounds__(AUX_THREADS) reduce_partials_kernel(const float* partial, int groups, int n, T* dw) {
  __shared__ float part[AUX_THREADS / 32][32];
  const int o = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + o;
  const int len = (groups + AUX_THREADS / 32 - 1) / (AUX_THREADS / 32);
  float s = 0.f;
  if (e < n)
    for (int gi = j * len; gi < min(groups, (j + 1) * len); ++gi) s += partial[(size_t)gi * n + e];
  part[j][o] = s;
  __syncthreads();
  if (j == 0 && e < n) {
    float t = 0.f;
    for (int q = 0; q < AUX_THREADS / 32; ++q) t += part[q][o];
    from_f(t, dw + e);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

template <typename T>
DeformArgs<T> args_of(const void* x, const void* offset, const void* mask, const void* weight, int N, int H, int W, int C, int Cout) {
  DeformArgs<T> p{};
  p.x = (const T*)x, p.offset = (const T*)offset, p.mask = (const T*)mask, p.w = (const T*)weight;
  p.N = N, p.H = H, p.W = W, p.C = C, p.Cout = Cout;
  p.tiles_x = (W + TW - 1) / TW, p.tiles_y = (H + 2 * WARPS - 1) / (2 * WARPS);
  p.vec_x = C % (16 / (int)sizeof(T)) == 0 && rows_aligned16(x, 16);
  return p;
}

int tile_count(int N, int H, int W) { return N * ((H + 2 * WARPS - 1) / (2 * WARPS)) * ((W + TW - 1) / TW); }

template <typename T>
int forward(DeformArgs<T> p, void* out, cudaStream_t stream) {
  p.out = (T*)out;
  const int bytes = FwdSmem<T>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(deform_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = tile_count(p.N, p.H, p.W);
  const dim3 grid(min(tiles, BLOCKS_PER_SM * sm_count()), (p.Cout + SLAB - 1) / SLAB);
  deform_forward_kernel<T><<<grid, THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* x, const void* offset, const void* mask, const void* weight, const void* g, void* dx, void* doffset, void* dmask,
             void* dweight, void* dx_fixed, void* partial, void* bound, int N, int H, int W, int C, int Cout, cudaStream_t stream) {
  DeformArgs<T> p = args_of<T>(x, offset, mask, weight, N, H, W, C, Cout);
  p.g = (const T*)g, p.dx = (T*)dx, p.doffset = (T*)doffset, p.dmask = (T*)dmask, p.dw = (T*)dweight;
  p.dx_fixed = (unsigned long long*)dx_fixed, p.partial = (float*)partial, p.bound = (unsigned*)bound;
  p.vec_g = Cout % (16 / (int)sizeof(T)) == 0 && rows_aligned16(g, 16);
  const size_t npix = (size_t)p.N * p.H * p.W;
  const int tiles = tile_count(p.N, p.H, p.W);
  cudaError_t err = cudaMemsetAsync(p.dx_fixed, 0, npix * p.C * sizeof(unsigned long long), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(p.bound, 0, 3 * sizeof(unsigned), stream);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(deform_backward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem::bytes<T>());
  if (err != cudaSuccess) return (int)err;
  const int aux = (int)std::min<size_t>((npix + AUX_THREADS - 1) / AUX_THREADS, (size_t)4 * sm_count());
  bound_kernel<T><<<aux, AUX_THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  deform_backward_kernel<T><<<dim3(tiles, KK), THREADS, BwdSmem::bytes<T>(), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_w = KK * p.C * p.Cout;
  reduce_partials_kernel<T><<<(n_w + 31) / 32, AUX_THREADS, 0, stream>>>(p.partial, tiles, n_w, p.dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int conv = (int)std::min<size_t>((npix * p.C + AUX_THREADS - 1) / AUX_THREADS, (size_t)8 * sm_count());
  dx_convert_kernel<T><<<conv, AUX_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of every tensor argument.
// Shapes: x (N,H,W,C), offset (N,H,W,18), mask (N,H,W,9), weight (3,3,C,Cout),
// out (N,H,W,Cout).
extern "C" int selfc_deform_forward(const void* x, const void* offset, const void* mask, const void* weight, void* out, int N, int H, int W,
                                    int C, int Cout, int dtype, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return forward<float>(args_of<float>(x, offset, mask, weight, N, H, W, C, Cout), out, s);
  if (dtype == 1) return forward<__nv_bfloat16>(args_of<__nv_bfloat16>(x, offset, mask, weight, N, H, W, C, Cout), out, s);
  return (int)cudaErrorInvalidValue;
}

// g (N,H,W,Cout) in x's dtype; dx, doffset, dmask, dweight: written, in x's
// dtype. Scratch: dx_fixed N*H*W*C int64, partial selfc_deform_backward_tiles
// * 9 * C * Cout floats, bound 3 x 32 bits; the launches zero what they need.
extern "C" int selfc_deform_backward(const void* x, const void* offset, const void* mask, const void* weight, const void* g, void* dx,
                                     void* doffset, void* dmask, void* dweight, void* dx_fixed, void* partial, void* bound, int N, int H,
                                     int W, int C, int Cout, int dtype, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return backward<float>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, dx_fixed, partial, bound, N, H, W, C, Cout, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, dx_fixed, partial, bound, N, H, W, C, Cout, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's 8 x 16-pixel tiles (its partial sums of dW: one a tile).
extern "C" int selfc_deform_backward_tiles(int N, int H, int W) { return tile_count(N, H, W); }

extern "C" const char* selfc_deform_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
