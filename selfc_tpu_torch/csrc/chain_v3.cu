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
// This design: tensor-core products (3xTF32 for fp32, bf16 mma for bf16)
// with the staging overlapped with the math.
//  - The spatial layers: B1's tensor-core layer (csrc/tc_chain.cuh) on a
//    feats buffer at the true width, (frames, H, W, 4*gc): segment j at
//    lanes gc*j, no pad lanes. A block owns 8 x 16 output pixels of one
//    frame and all gc (padded to 16 or 32) output channels; K is walked as
//    (slab of 16 fp32 / 32 bf16 input channels) x (9 taps), the halo tile
//    and the slab's weight rows staged by a cp.async ring. The tile does not
//    depend on Cin, so every C and gc is taken.
//  - conv5: the temporal-conv block loop B6 runs (tc::tconv_block) over two
//    sources, [x | feats], K = 3 (C + 4 gc); taps beyond the clip read a zero
//    row.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include "tc_chain.cuh"

namespace {

constexpr int GC_MAX = tc::GC_MAX;

template <typename T, class Tile, int VA>
__global__ void __launch_bounds__(Tile::THREADS, 2) v3_conv5_kernel(tc::TconvArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  tc::tconv_block<T, Tile, VA>(p, reinterpret_cast<unsigned char*>(dyn_smem));
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
  tc::ChainLayerArgs<T> a{};
  a.x = (const T*)x;
  a.feats = (T*)feats;
  a.H = H, a.W = W, a.C = C, a.gc = gc;
  a.fc = 4 * gc;   // the true width
  a.write_feats = 1;
  a.x_vec = tc::rows_aligned16(x, (size_t)C * sizeof(T));
  a.f_vec = tc::rows_aligned16(feats, (size_t)4 * gc * sizeof(T));
  for (int layer = 0; layer < 4; ++layer) {
    a.layer = layer;
    a.w = (const T*)ws[layer];
    a.b = (const T*)bs[layer];
    a.w_vec = tc::rows_aligned16(ws[layer], (size_t)gc * sizeof(T));
    const int err = gc <= 16 ? tc::launch_chain_layer<T, 16, false, 0, true>(a, frames, stream)
                             : tc::launch_chain_layer<T, GC_MAX, false, 0, true>(a, frames, stream);
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
  // conv5's copies: 16 bytes where every row of x and of feats allows them,
  // else one element a copy
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
