// Dense-chain forward for Hopper (sm_90a): the D2DT chain of the SelfC nets.
//
// Replaces selfc_tpu/ops/pallas_chain.py:_chain_kernel_v2 (forward, all seven
// coupling epilogues; its emit_feats output is the feats buffer below, which
// the caller may keep for the backward) and, through the entry
// selfc_dense_chain_feats, :_pallas_feats and :_chain_kernel (x1..x4 alone,
// the latter with conv5 left to the caller). The first two take stripe_w
// (a W-packed batch: images side by side along W, no 3x3 tap across an
// image's edge). The function:
//
//   x1..x4 : four 3x3 SAME convs over the growing concat [x | x1 .. x_{k-1}],
//            each + bias + LeakyReLU(0.2), gc output channels each
//            (gc in 1..32: 32 in the coupling and the 4x prior, 12 in the
//            codec's prior);
//   y5     : a (3,1,1) temporal conv over [x | x1..x4], zero padded in T, + bias;
//   out    : the coupling epilogue applied to y5 in fp32 (see tc::EpMode).
//
// What bounds it: operations. One output pixel of a 64->64 chain costs about
// 331k operations but moves under 1 KB through device memory even when
// x1..x4 are written out, so the chain sits far above the card's
// operations-per-byte line. The chain is five launches (four spatial layers,
// then conv5 with the epilogue) that write x1..x4 into channel slices of ONE
// preallocated (frames, H, W, 4*GCP) buffer, so no tile ever recomputes a
// halo and the [x | x1..x4] concat is never assembled.
//
// Every product runs on the tensor cores: 3xTF32 mma.sync for fp32 (fp32
// accuracy: each value split hi + lo), bf16 mma for bf16, fp32 sums.
//  - The spatial layers: csrc/tc_chain.cuh (an implicit GEMM over 9 taps x
//    the input channels, a halo tile and the weight rows staged by a cp.async
//    ring, a tile of 8 x 16 pixels, the stripe masks as reads of a zero
//    row).
//  - conv5 + epilogue: B6's temporal-conv block loop (tc::tconv_block in
//    csrc/tc_mma.cuh) over the two sources [x | feats], so each staged slab
//    feeds all three taps and x and feats are read once a block; its CHAIN
//    mode remaps the weight rows of the padded feats and applies the
//    epilogue on the fp32 accumulators, with a and m read as fp32.
//
// Growth width below 32: gc is rounded up to GCP = 16 (gc <= 16) or 32, not
// to 32 as the TPU kernel's pad_gc_params does (a pad lane costs real
// products here). The buffer is (frames, H, W, 4*GCP); segment j of it holds
// x_{j+1} in channels GCP*j .. GCP*j+gc-1 and zeros above. The weights are
// read in their own layout (w_k (3,3,C+gc(k-1),gc), w5 (3,C+4gc,c_out)) and
// remapped while they are staged: buffer channel GCP*j + l is weight row
// C + gc*j + l for l < gc and a zero row otherwise. No padded weight copy is
// made. The 16-lane rounding keeps every segment 16-byte aligned in fp32 and
// bf16, so the feats rows are staged 16 bytes a copy.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include "tc_chain.cuh"

namespace {

using namespace tc;

template <typename T, class Tile, int VA>
__global__ void __launch_bounds__(Tile::THREADS, 2) chain_conv5_kernel(TconvArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  tconv_block<T, Tile, VA, true>(p, reinterpret_cast<unsigned char*>(dyn_smem));
}

template <typename T, class Tile, int VA>
int conv5_at(TconvArgs<T> p, cudaStream_t stream) {
  tconv_tiling(p.Tlen, Tile::BM, p.TT, p.P, p.halo);
  p.tiles_n = (p.Co + Tile::BN - 1) / Tile::BN;
  p.tiles_s = (p.S + p.P - 1) / p.P;
  p.tiles_t = (p.Tlen + p.TT - 1) / p.TT;
  const long long blocks = (long long)p.B * p.tiles_t * p.tiles_s * p.tiles_n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_conv5_kernel<T, Tile, VA>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  chain_conv5_kernel<T, Tile, VA><<<(unsigned)blocks, Tile::THREADS, Tile::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// The four spatial layers, in order: layer k reads what layers < k wrote.
// stripe_w > 0: x is a W-packed batch of images stripe_w columns wide.
template <typename T, int GCP>
int spatial_layers_at(const void* x, void* feats, const void* const* ws, const void* const* bs, int frames, int H, int W, int C, int gc,
                      int stripe_w, cudaStream_t stream) {
  ChainLayerArgs<T> a{};
  a.x = (const T*)x;
  a.feats = (T*)feats;
  a.H = H;
  a.W = W;
  a.C = C;
  a.gc = gc;
  a.fc = 4 * GCP;
  a.f_vec = 1;   // 4*GCP lanes: every feats row is 16-byte aligned
  a.write_feats = 1;
  a.stripe_w = stripe_w;
  a.x_vec = rows_aligned16(x, (size_t)C * sizeof(T));
  for (int layer = 0; layer < 4; ++layer) {
    a.layer = layer;
    a.w = (const T*)ws[layer];
    a.b = (const T*)bs[layer];
    a.w_vec = rows_aligned16(ws[layer], (size_t)gc * sizeof(T));
    const int err = stripe_w > 0 ? launch_chain_layer<T, GCP, true, 0>(a, frames, stream)
                                 : launch_chain_layer<T, GCP, false, 0>(a, frames, stream);
    if (err != 0) return err;
  }
  return 0;
}

template <typename T>
int spatial_layers(const void* x, void* feats, const void* const* ws, const void* const* bs, int frames, int H, int W, int C, int gc,
                   int stripe_w, cudaStream_t stream) {
  if (gc < 1 || gc > GC_MAX || frames < 1 || H < 1 || W < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (stripe_w < 0 || (stripe_w > 0 && W % stripe_w != 0)) return (int)cudaErrorInvalidValue;
  if (gc <= 16) return spatial_layers_at<T, 16>(x, feats, ws, bs, frames, H, W, C, gc, stripe_w, stream);
  return spatial_layers_at<T, GC_MAX>(x, feats, ws, bs, frames, H, W, C, gc, stripe_w, stream);
}

template <typename T, int VA>
int conv5(TconvArgs<T>& p, cudaStream_t stream) {
  if (p.Co <= 8) return conv5_at<T, TileNarrow8, VA>(p, stream);
  if (p.Co <= 16) return conv5_at<T, TileNarrow16, VA>(p, stream);
  return wide48(p.Co) ? conv5_at<T, TileWide48, VA>(p, stream) : conv5_at<T, TileWide, VA>(p, stream);
}

template <typename T>
int chain_forward(const void* x, void* feats, const void* const* ws, const void* const* bs, const void* w5, const void* b5, const void* a,
                  const void* m, void* out, int frames, int Tn, int H, int W, int C, int gc, int c_out, int mode, float clamp, int stripe_w,
                  cudaStream_t stream) {
  if (Tn < 1 || frames % Tn != 0 || c_out < 1) return (int)cudaErrorInvalidValue;
  const int err = spatial_layers<T>(x, feats, ws, bs, frames, H, W, C, gc, stripe_w, stream);
  if (err != 0) return err;
  const int gcp = padded_gc(gc);
  TconvArgs<T> p{};
  p.src[0] = (const T*)x;
  p.src[1] = (const T*)feats;
  p.ch[0] = C;
  p.ch[1] = 4 * gcp;
  p.w = (const T*)w5;
  p.bias = (const T*)b5;
  p.out = (T*)out;
  p.B = frames / Tn, p.Tlen = Tn, p.S = H * W, p.Co = c_out;
  p.split = 1;
  p.w_vec = rows_aligned16(w5, (size_t)c_out * sizeof(T));
  p.seg_gcp = gcp, p.seg_gc = gc;
  p.ep_a = (const T*)a, p.ep_m = (const T*)m, p.ep_mode = mode, p.ep_clamp = clamp;
  // x's rows by 16-byte copies where they allow them (the feats rows always do)
  if (rows_aligned16(x, (size_t)C * sizeof(T))) return conv5<T, 16>(p, stream);
  return conv5<T, (int)sizeof(T)>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor of one call has the same type).
// Every pointer is aligned to 16 bytes.
// x (frames,H,W,C); feats (frames,H,W,4*GCP) scratch, written (GCP = 16 for
// gc <= 16, else 32; lanes >= gc of each segment are written as zeros);
// w1..w4 (3,3,C+gc*k,gc); b1..b4 (gc); w5 (3,C+4*gc,c_out); b5 (c_out);
// a, m (frames,H,W,c_out) or null; out (frames,H,W,c_out). frames = B*T with
// T = frames_per_clip; 1 <= gc <= 32. stripe_w: 0, or the width of one image
// of a W-packed batch (W a multiple of it; conv5 and the epilogue do not see
// the stripes: they are temporal and pointwise). Returns the first
// cudaError_t a launch reports, 0 when all five were accepted.
extern "C" int selfc_dense_chain_forward(const void* x, void* feats, const void* w1, const void* w2, const void* w3, const void* w4, const void* b1, const void* b2, const void* b3, const void* b4, const void* w5, const void* b5, const void* a, const void* m, void* out, int frames, int frames_per_clip, int H, int W, int C, int gc, int c_out, int mode, float clamp, int stripe_w, int dtype, void* stream) {
  const void* ws[4] = {w1, w2, w3, w4};
  const void* bs[4] = {b1, b2, b3, b4};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return chain_forward<float>(x, feats, ws, bs, w5, b5, a, m, out, frames, frames_per_clip, H, W, C, gc, c_out, mode, clamp, stripe_w, s);
  if (dtype == 1) return chain_forward<__nv_bfloat16>(x, feats, ws, bs, w5, b5, a, m, out, frames, frames_per_clip, H, W, C, gc, c_out, mode, clamp, stripe_w, s);
  return (int)cudaErrorInvalidValue;
}

// The spatial half alone (replaces selfc_tpu/ops/pallas_chain.py:_pallas_feats,
// and is the forward of the v1 spatial chain :_chain_kernel): feats
// (frames,H,W,4*GCP), written, = [x1 | x2 | x3 | x4] in the layout above,
// any gc in 1..32. The backward of the chain calls it when the forward did not
// keep its feats buffer. Same arguments and return value as above, without
// conv5 and the epilogue.
extern "C" int selfc_dense_chain_feats(const void* x, void* feats, const void* w1, const void* w2, const void* w3, const void* w4, const void* b1, const void* b2, const void* b3, const void* b4, int frames, int H, int W, int C, int gc, int stripe_w, int dtype, void* stream) {
  const void* ws[4] = {w1, w2, w3, w4};
  const void* bs[4] = {b1, b2, b3, b4};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return spatial_layers<float>(x, feats, ws, bs, frames, H, W, C, gc, stripe_w, s);
  if (dtype == 1) return spatial_layers<__nv_bfloat16>(x, feats, ws, bs, frames, H, W, C, gc, stripe_w, s);
  return (int)cudaErrorInvalidValue;
}

// The per-segment width of the feats buffer that selfc_dense_chain_forward
// writes for growth width gc: the caller sizes the buffer with it.
extern "C" int selfc_dense_chain_padded_gc(int gc) { return tc::padded_gc(gc); }

extern "C" const char* selfc_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
