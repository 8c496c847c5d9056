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
// walks all nine taps and every input channel, K = 9 * Cin_k.
//
// What bounds it on this card: operations (2 * 9 * Cin * gc a pixel and
// layer against (Cin + gc) * 4 bytes), at the rate of the products that run
// them: here 3xTF32 on the tensor cores (495 / 3 TFLOP/s dense). Measured
// (tools/tc_attribution.py), the mma.sync issue sets the pace: with the
// products off the kernel takes about 40 % of its time.
//
// The design before this one (plain fp32 FMAs from 8 x 8 register
// tiles; a halo tile of every input channel staged at once, so its rows
// shrank with Cin down to 4 rows and one warp at Cin 160; the staging
// scalar, synchronous and unoverlapped) took, on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py's timing_variants rows): serve 64->64 7.187 ms (B1 2.141),
// 3->64 2.360 (B1 1.335); train 64->64 3.914 (B1 1.564), 3->64 1.304 (B1
// 0.930). It refused C + 3 gc > 526.
//
// This design (csrc/tc_mma.cuh): tensor-core products (3xTF32 for fp32, bf16
// mma for bf16) with the staging overlapped with the math.
//  - A spatial layer: a block owns 8 x 16 output pixels of one frame and all
//    gc (padded to 16 or 32) output channels; 4 warps of two tile rows, one
//    m16 fragment a row. K is walked as (slab of 16 fp32 / 32 bf16 input
//    channels) x (9 taps): for each slab the block stages, by cp.async into
//    a 2-stage ring, the 10 x 18 halo tile of those channels ([pixel][c],
//    80-byte rows so the fragment loads meet 32 banks) and, beside it, that
//    slab's 9 x 16 weight rows of the (3,3,Cin,gc) layout as they lie (no
//    weight is remapped). A tap's A fragment is the halo tile shifted by
//    (dy, dx) pixels, which mma.sync reads through registers. The tile no
//    longer depends on Cin, so every C and gc is taken.
//  - conv5: the temporal-conv block loop B6 runs (tc::tconv_block) over two
//    sources, [x | feats], K = 3 (C + 4 gc); taps beyond the clip read a zero
//    row.
// The bias and LeakyReLU are applied on the accumulators; each layer's
// output goes into feats at its true width, (frames, H, W, 4*gc).
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace {

constexpr int GC_MAX = 32;
constexpr int TH = 8, TW = 16;         // output tile: 8 rows x 16 columns, one m16 fragment a row
constexpr int HWD = TW + 2;            // halo tile width ...
constexpr int NPIX = (TH + 2) * HWD;   // ... and pixels
constexpr int THREADS = 128;           // 4 warps, two tile rows each
constexpr int STAGES = 2;
constexpr float SLOPE = 0.2f;

template <int GCP>
struct SpatialSmem {
  static constexpr int SN = tc::b_stride(GCP);
  static constexpr int A_BYTES = NPIX * tc::ROW_STRIDE;
  static constexpr int STAGE_BYTES = (A_BYTES + 9 * tc::ROW_BYTES * SN + 127) / 128 * 128;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
};

template <typename T>
struct SpatialArgs {
  const T* x;      // (frames, H, W, C)
  T* feats;        // (frames, H, W, 4*gc): reads lanes < gc*layer, writes gc*layer ..
  const T* w;      // (3, 3, C + gc*layer, gc)
  const T* b;      // (gc)
  int H, W, C, gc, layer;
  int w_vec;       // the weight rows allow 16-byte copies
};

// One spatial layer. grid = (ceil(W/16), ceil(H/8), frames), 128 threads.
template <typename T, int GCP, int VA>
__global__ void __launch_bounds__(THREADS) v3_spatial_kernel(SpatialArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(dyn_smem);
  using SM = SpatialSmem<GCP>;
  constexpr int BK = tc::Elem<T>::BK, NT = GCP / 8, MT = 2, SN = SM::SN, ES = (int)sizeof(T);
  constexpr int CPR = tc::ROW_BYTES / VA;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int H = p.H, W = p.W, C = p.C, gc = p.gc;
  const int fc = 4 * gc, cf = gc * p.layer;   // feats width; the feats channels this layer reads
  const int cin = C + cf;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  const size_t frame = blockIdx.z;
  const T* xf = p.x + frame * H * W * C;
  T* ff = p.feats + frame * H * W * fc;
  const int ns0 = (C + BK - 1) / BK;
  const int nslab = ns0 + (cf + BK - 1) / BK;

  auto stage = [&](int slab, int st) {
    unsigned char* as = smem + st * SM::STAGE_BYTES;
    unsigned char* bs = as + SM::A_BYTES;
    const bool fs = slab >= ns0;
    const int c0 = (fs ? slab - ns0 : slab) * BK;
    const int ch = fs ? cf : C;   // channels of this source
    const int stride = fs ? fc : C;
    const T* src = fs ? ff : xf;
    // the halo tile of channels c0 .. c0+BK-1, zero outside the image
    for (int i = tid; i < NPIX * CPR; i += THREADS) {
      const int pix = i / CPR, ci = i % CPR;
      const int iy = ty0 - 1 + pix / HWD, ix = tx0 - 1 + pix % HWD;
      const int cc = c0 + ci * (VA / ES);
      const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const int vb = inside ? max(0, min(VA, (ch - cc) * ES)) : 0;
      const T* gp = src + ((size_t)iy * W + ix) * stride + cc;
      tc::stage_copy<VA>(as + pix * tc::ROW_STRIDE + ci * VA, vb ? (const void*)gp : (const void*)src, vb);
    }
    // the slab's weight rows (tap, c0 + kk), every output channel
    const int wrow0 = fs ? C : 0;
    if (p.w_vec) {
      constexpr int CPB = GCP * ES / 16;
      for (int i = tid; i < 9 * BK * CPB; i += THREADS) {
        const int row = i / CPB, n = (i % CPB) * (16 / ES);
        const int tap = row / BK, kk = row % BK;
        const int vb = c0 + kk < ch ? max(0, min(16, (gc - n) * ES)) : 0;
        const T* gp = p.w + ((size_t)tap * cin + wrow0 + c0 + kk) * gc + n;
        tc::cp_async<16>(bs + (row * SN + n) * ES, vb ? (const void*)gp : (const void*)p.w, vb);
      }
    } else {
      for (int i = tid; i < 9 * BK * GCP; i += THREADS) {
        const int row = i / GCP, n = i % GCP;
        const int tap = row / BK, kk = row % BK;
        const int vb = c0 + kk < ch && n < gc ? ES : 0;
        const T* gp = p.w + ((size_t)tap * cin + wrow0 + c0 + kk) * gc + n;
        tc::stage_copy<ES>(bs + (row * SN + n) * ES, vb ? (const void*)gp : (const void*)p.w, vb);
      }
    }
  };

  // rows g and g+8 of fragment m: tile row 2*warp + m, columns g and g+8
  int a0[MT], a1[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    a0[m] = ((2 * warp + m) * HWD + g) * tc::ROW_WORDS;
    a1[m] = a0[m] + 8 * tc::ROW_WORDS;
  }
  float acc[MT][NT][4], part[MT][NT][4];
  tc::zero(acc);

  stage(0, 0);
  tc::cp_async_commit();
  for (int slab = 0; slab < nslab; ++slab) {
    tc::cp_async_wait<0>();
    __syncthreads();   // this slab landed; every warp is done with the stage refilled below
    if (slab + 1 < nslab) stage(slab + 1, (slab + 1) % STAGES);
    tc::cp_async_commit();
    const unsigned char* as = smem + (slab % STAGES) * SM::STAGE_BYTES;
    const T* bs = reinterpret_cast<const T*>(as + SM::A_BYTES);
    const uint32_t* aw = reinterpret_cast<const uint32_t*>(as);
    tc::zero(part);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * HWD + tap % 3) * tc::ROW_WORDS;
      tc::slab_mma<T, MT, NT, SN>(part, aw + shift, a0, a1, bs + tap * BK * SN, 0, g, t);
    }
    tc::add_into(acc, part);
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int oy = ty0 + 2 * warp + m;
    if (oy >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = tx0 + g + 8 * h;
      if (ox >= W) continue;
      T* o = ff + ((size_t)oy * W + ox) * fc + cf;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = 8 * n + 2 * t + e;
          if (co >= gc) continue;
          const float v = acc[m][n][2 * h + e] + tc::to_f(p.b[co]);
          tc::from_f(v >= 0.f ? v : SLOPE * v, o + co);
        }
    }
  }
}

template <typename T, class Tile, int VA>
__global__ void __launch_bounds__(Tile::THREADS, 2) v3_conv5_kernel(tc::TconvArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  tc::tconv_block<T, Tile, VA>(p, reinterpret_cast<unsigned char*>(dyn_smem));
}

template <typename T, int GCP, int VA>
int spatial_at(const SpatialArgs<T>& p, int frames, cudaStream_t stream) {
  constexpr int smem = SpatialSmem<GCP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(v3_spatial_kernel<T, GCP, VA>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, frames);
  v3_spatial_kernel<T, GCP, VA><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, class Tile, int VA>
int conv5_at(tc::TconvArgs<T> p, cudaStream_t stream) {
  tc::tconv_tiling(p.Tlen, Tile::BM, p.TT, p.P, p.halo);
  p.tiles_n = (p.Co + Tile::BN - 1) / Tile::BN;
  p.tiles_s = (p.S + p.P - 1) / p.P;
  p.tiles_t = (p.Tlen + p.TT - 1) / p.TT;
  const long long blocks = (long long)p.B * p.tiles_t * p.tiles_s * p.tiles_n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(v3_conv5_kernel<T, Tile, VA>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  v3_conv5_kernel<T, Tile, VA><<<(unsigned)blocks, Tile::THREADS, Tile::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int VA>
int v3_forward_va(const void* x, const void* const* ws, const void* const* bs, const void* w5, const void* b5, void* feats, void* out,
                  int frames, int Tn, int H, int W, int C, int gc, int c_out, cudaStream_t stream) {
  for (int layer = 0; layer < 4; ++layer) {
    SpatialArgs<T> p{(const T*)x, (T*)feats, (const T*)ws[layer], (const T*)bs[layer], H, W, C, gc, layer,
                     tc::rows_aligned16(ws[layer], (size_t)gc * sizeof(T))};
    const int err = gc <= 16 ? spatial_at<T, 16, VA>(p, frames, stream) : spatial_at<T, GC_MAX, VA>(p, frames, stream);
    if (err != 0) return err;
  }
  tc::TconvArgs<T> p{};
  p.src[0] = (const T*)x;
  p.src[1] = (const T*)feats;
  p.ch[0] = C;
  p.ch[1] = 4 * gc;
  p.w = (const T*)w5;
  p.bias = (const T*)b5;
  p.out = (T*)out;
  p.B = frames / Tn, p.Tlen = Tn, p.S = H * W, p.Co = c_out;
  p.split = 1;
  p.w_vec = tc::rows_aligned16(w5, (size_t)c_out * sizeof(T));
  if (c_out <= 8) return conv5_at<T, tc::TileNarrow8, VA>(p, stream);
  if (c_out <= 16) return conv5_at<T, tc::TileNarrow16, VA>(p, stream);
  return tc::wide48(c_out) ? conv5_at<T, tc::TileWide48, VA>(p, stream) : conv5_at<T, tc::TileWide, VA>(p, stream);
}

template <typename T>
int v3_forward(const void* x, const void* const* ws, const void* const* bs, const void* w5, const void* b5, void* feats, void* out,
               int frames, int Tn, int H, int W, int C, int gc, int c_out, cudaStream_t stream) {
  if (gc < 1 || gc > GC_MAX || frames < 1 || Tn < 1 || frames % Tn != 0 || H < 1 || W < 1 || C < 1 || c_out < 1)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies where every row of x and of feats allows them, else one
  // element a copy
  if (tc::rows_aligned16(x, (size_t)C * sizeof(T)) && tc::rows_aligned16(feats, (size_t)4 * gc * sizeof(T)))
    return v3_forward_va<T, 16>(x, ws, bs, w5, b5, feats, out, frames, Tn, H, W, C, gc, c_out, stream);
  return v3_forward_va<T, (int)sizeof(T)>(x, ws, bs, w5, b5, feats, out, frames, Tn, H, W, C, gc, c_out, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor of one call has the same
// type). x (frames,H,W,C); w1..w4 (3,3,C+gc*k,gc); b1..b4 (gc); w5
// (3,C+4*gc,c_out); b5 (c_out); feats (frames,H,W,4*gc) scratch, written (the
// true width: no pad lanes); out (frames,H,W,c_out). frames = B*T with T =
// frames_per_clip; 1 <= gc <= 32. Returns the first cudaError_t a launch
// reports, 0 when all five were accepted.
extern "C" int selfc_chain_v3_forward(const void* x, const void* w1, const void* w2, const void* w3, const void* w4, const void* b1, const void* b2, const void* b3, const void* b4, const void* w5, const void* b5, void* feats, void* out, int frames, int frames_per_clip, int H, int W, int C, int gc, int c_out, int dtype, void* stream) {
  const void* ws[4] = {w1, w2, w3, w4};
  const void* bs[4] = {b1, b2, b3, b4};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return v3_forward<float>(x, ws, bs, w5, b5, feats, out, frames, frames_per_clip, H, W, C, gc, c_out, s);
  if (dtype == 1) return v3_forward<__nv_bfloat16>(x, ws, bs, w5, b5, feats, out, frames, frames_per_clip, H, W, C, gc, c_out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* selfc_v3_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
