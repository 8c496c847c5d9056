// The H/G pair of a coupling block for Hopper (sm_90a): both subnet chains
// of one InvBlockExp on their shared input, and the y2 combine.
//
// Replaces selfc_tpu/ops/pallas_chain.py:_hg_kernel (reached through
// _pallas_impl_hg and fused_hg_pair). With x the shared input (y1 forward,
// x1 reverse) and x2 the coupling's other half:
//
//   h5 = chain_H(x), g5 = chain_G(x)          (the D2DT chain of dense_chain.cu)
//   se = exp(+-clamp * (2 sigmoid(h5) - 1))   (+ forward, - reverse)
//   y2 = x2 * se + g5          forward
//   y2 = (x2 - g5) * se        reverse
//
// and returns (y2, se). What the TPU kernel keeps out of memory, and so does
// this one: the combine runs on the fp32 conv5 accumulators of both chains,
// so exp(+-s) never goes to device memory to be read back as the m operand
// of G's epilogue. Five launches where the two epilogue chains make ten:
//
//  - four spatial layers, each of both chains (csrc/tc_chain.cuh's layer,
//    PAIR: blockIdx.z = 2 * frame + chain, the chain chosen by selects), into
//    two feats buffers in B1's (frames, H, W, 4*GCP) layout, pad lanes
//    written as 0; the two blocks of a tile read the same x rows one after
//    the other, the second from L2;
//  - conv5 + combine: B6's temporal-conv block loop (tc::tconv_block in
//    csrc/tc_mma.cuh) over H's K slabs [x | feats_h], then G's [x | feats_g],
//    each slab's products into a zeroed part added into that chain's fp32
//    accumulators; the block holds h5 and g5 of the same outputs and writes
//    y2 and se. x (C = 3 in the 4x net) is staged once a chain.
//
// Products: 3xTF32 mma.sync for fp32, bf16 mma for bf16, fp32 sums; the
// sigmoid and exp in fp32 (the reverse's exp(-s) must invert the forward's).
// Bound: operations, as B1 (two chains' products over one input's bytes).
// Any B, T, H, W, C; growth width 1..32; c_out any.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include "tc_chain.cuh"

namespace {

using namespace tc;

// conv5 of both chains (h over [x | feats_h], g over [x | feats_g]: the
// same geometry, x, seg_gcp and seg_gc; their own src[1], w and bias) and
// the combine.
template <typename T>
struct HgArgs {
  TconvArgs<T> h, g;
  const T* x2;
  T* y2;
  T* se;
  float clamp;
  int rev;
};

template <typename T, class Tile, int VA>
__global__ void __launch_bounds__(Tile::THREADS, 1) hg_conv5_kernel(HgArgs<T> p) {
  extern __shared__ __align__(16) float dyn_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(dyn_smem);
  constexpr int MT = Tile::MT, NT = Tile::NT, SN = Tile::SN, BK = Elem<T>::BK;
  const TconvArgs<T>& q = p.h;   // the geometry both chains share
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / Tile::WN, wn = warp % Tile::WN;

  // the block's tile: clip b, pixels s0.., frames t0..; columns n0..
  int bid = blockIdx.x;
  const int tn = bid % q.tiles_n;
  bid /= q.tiles_n;
  const int tt_i = bid % q.tiles_t;
  bid /= q.tiles_t;
  const int ts = bid % q.tiles_s;
  const int b = bid / q.tiles_s;
  const int TT = q.TT, P = q.P, halo = q.halo, Tl = q.Tlen, S = q.S, Co = q.Co;
  const int s0 = ts * P, t0 = tt_i * TT, n0 = tn * Tile::BN;
  const int NF = TT + 2 * halo;
  const int pv = min(P, S - s0), tv = min(TT, Tl - t0);
  const int ctot = q.ch[0] + q.ch[1] / q.seg_gcp * q.seg_gc;
  const int ns0 = (q.ch[0] + BK - 1) / BK;
  const int nsc = ns0 + (q.ch[1] + BK - 1) / BK;   // K slabs of one chain: H's are 0 .. nsc-1, G's nsc .. 2*nsc-1

  int aoff[2][3][MT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT + m) * 16 + g + 8 * h;
      const int pp = r / TT, ft = r % TT;
      const bool ok = pp < pv && ft < tv;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int f = t0 + ft + k - 1;
        const int row = ok && f >= 0 && f < Tl ? pp * NF + ft + k - 1 + halo : Tile::BM;
        aoff[h][k][m] = row * ROW_WORDS;
      }
    }

  for (int i = tid; i < Tile::STAGES * (ROW_BYTES / 4); i += Tile::THREADS)
    reinterpret_cast<uint32_t*>(smem + (i / (ROW_BYTES / 4)) * Tile::STAGE_BYTES + Tile::BM * ROW_STRIDE)[i % (ROW_BYTES / 4)] = 0u;

  const size_t row_base = (size_t)b * Tl * S + s0;
  const TconvStager<T, Tile, VA, true> stage_h{p.h, smem, tid, t0, halo, NF, pv, P, row_base, n0, ns0, ctot};
  const TconvStager<T, Tile, VA, true> stage_g{p.g, smem, tid, t0, halo, NF, pv, P, row_base, n0, ns0, ctot};
  auto stage = [&](int slab, int st) {
    if (slab < nsc)
      stage_h(slab, st);
    else
      stage_g(slab - nsc, st);
  };
  const int nslab = 2 * nsc;
  float acc_h[MT][NT][4], acc_g[MT][NT][4], part[MT][NT][4];
  zero(acc_h);
  zero(acc_g);

#pragma unroll
  for (int s = 0; s < Tile::STAGES - 1; ++s) {
    if (s < nslab) stage(s, s);
    cp_async_commit();
  }
  for (int slab = 0; slab < nslab; ++slab) {
    cp_async_wait<Tile::STAGES - 2>();
    __syncthreads();   // this slab landed; every warp is done with the stage refilled below
    const int next = slab + Tile::STAGES - 1;
    if (next < nslab) stage(next, next % Tile::STAGES);
    cp_async_commit();
    const unsigned char* as = smem + (slab % Tile::STAGES) * Tile::STAGE_BYTES;
    const T* bs = reinterpret_cast<const T*>(as + Tile::A_BYTES);
    zero(part);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      slab_mma<T, MT, NT, SN, true>(part, reinterpret_cast<const uint32_t*>(as), aoff[0][k], aoff[1][k], bs + k * BK * SN, wn * NT * 8, g, t);
    if (slab < nsc)
      add_into(acc_h, part);
    else
      add_into(acc_g, part);
  }

  // the combine: row (pixel, frame) of fragment row g / g+8, columns 2t, 2t+1
  const float sgn = p.rev ? -1.f : 1.f;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT + m) * 16 + g + 8 * h;
      const int pp = r / TT, ft = r % TT;
      if (pp >= pv || ft >= tv) continue;
      const size_t orow = row_base + (size_t)(t0 + ft) * S + pp;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n0 + (wn * NT + n) * 8 + 2 * t;   // and col + 1
        if (col >= Co) continue;
        const size_t o = orow * Co + col;
        const bool pair = col + 1 < Co;
        float y[2], e[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i && !pair) break;
          const float h5 = acc_h[m][n][2 * h + i] + to_f(p.h.bias[col + i]);
          const float g5 = acc_g[m][n][2 * h + i] + to_f(p.g.bias[col + i]);
          e[i] = expf(sgn * p.clamp * (2.f / (1.f + expf(-h5)) - 1.f));
          const float xv = to_f(p.x2[o + i]);
          y[i] = p.rev ? (xv - g5) * e[i] : xv * e[i] + g5;
        }
        store_pair(p.y2 + o, y, pair, Co);
        store_pair(p.se + o, e, pair, Co);
      }
    }
}

template <typename T, class Tile, int VA>
int conv5_at(HgArgs<T> p, cudaStream_t stream) {
  TconvArgs<T>& q = p.h;
  tconv_tiling(q.Tlen, Tile::BM, q.TT, q.P, q.halo);
  q.tiles_n = (q.Co + Tile::BN - 1) / Tile::BN;
  q.tiles_s = (q.S + q.P - 1) / q.P;
  q.tiles_t = (q.Tlen + q.TT - 1) / q.TT;
  const long long blocks = (long long)q.B * q.tiles_t * q.tiles_s * q.tiles_n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(hg_conv5_kernel<T, Tile, VA>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  hg_conv5_kernel<T, Tile, VA><<<(unsigned)blocks, Tile::THREADS, Tile::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int VA>
int conv5(HgArgs<T>& p, cudaStream_t stream) {
  const int Co = p.h.Co;
  if (Co <= 8) return conv5_at<T, TileNarrow8, VA>(p, stream);
  if (Co <= 16) return conv5_at<T, TileNarrow16, VA>(p, stream);
  return wide48(Co) ? conv5_at<T, TileWide48, VA>(p, stream) : conv5_at<T, TileWide, VA>(p, stream);
}

template <typename T, int GCP>
int spatial_layers_at(ChainLayerArgs<T> a, const void* const* hp, const void* const* gp, int frames, cudaStream_t stream) {
  for (int layer = 0; layer < 4; ++layer) {
    a.layer = layer;
    a.w = (const T*)hp[layer];
    a.b = (const T*)hp[4 + layer];
    a.w_g = (const T*)gp[layer];
    a.b_g = (const T*)gp[4 + layer];
    a.w_vec = rows_aligned16(hp[layer], (size_t)a.gc * sizeof(T)) && rows_aligned16(gp[layer], (size_t)a.gc * sizeof(T));
    const int err = launch_chain_layer<T, GCP, false, 0, false, true>(a, frames, stream);
    if (err != 0) return err;
  }
  return 0;
}

template <typename T>
int hg_forward(const void* x, const void* x2, const void* const* hp, const void* const* gp, void* feats_h, void* feats_g, void* y2, void* se, int frames, int Tn, int H, int W, int C, int gc, int c_out, float clamp, int rev, cudaStream_t stream) {
  if (gc < 1 || gc > GC_MAX || frames < 1 || H < 1 || W < 1 || C < 1 || c_out < 1) return (int)cudaErrorInvalidValue;
  if (Tn < 1 || frames % Tn != 0 || 2LL * frames > 65535) return (int)cudaErrorInvalidValue;
  // hp / gp: w1..w4, b1..b4, w5, b5 of H / G
  const int gcp = padded_gc(gc);
  ChainLayerArgs<T> a{};
  a.x = (const T*)x;
  a.feats = (T*)feats_h;
  a.feats_g = (T*)feats_g;
  a.H = H, a.W = W, a.C = C, a.gc = gc, a.fc = 4 * gcp;
  a.f_vec = 1;   // 4*GCP lanes: every feats row is 16-byte aligned
  a.write_feats = 1;
  a.x_vec = rows_aligned16(x, (size_t)C * sizeof(T));
  const int err = gcp == 16 ? spatial_layers_at<T, 16>(a, hp, gp, frames, stream) : spatial_layers_at<T, GC_MAX>(a, hp, gp, frames, stream);
  if (err != 0) return err;

  HgArgs<T> p{};
  TconvArgs<T>& h = p.h;
  h.src[0] = (const T*)x;
  h.src[1] = (const T*)feats_h;
  h.ch[0] = C;
  h.ch[1] = 4 * gcp;
  h.w = (const T*)hp[8];
  h.bias = (const T*)hp[9];
  h.B = frames / Tn, h.Tlen = Tn, h.S = H * W, h.Co = c_out;
  h.split = 1;
  h.w_vec = rows_aligned16(hp[8], (size_t)c_out * sizeof(T)) && rows_aligned16(gp[8], (size_t)c_out * sizeof(T));
  h.seg_gcp = gcp, h.seg_gc = gc;
  p.g = h;
  p.g.src[1] = (const T*)feats_g;
  p.g.w = (const T*)gp[8];
  p.g.bias = (const T*)gp[9];
  p.x2 = (const T*)x2;
  p.y2 = (T*)y2;
  p.se = (T*)se;
  p.clamp = clamp;
  p.rev = rev;
  // x's rows by 16-byte copies where they allow them (the feats rows always do)
  if (a.x_vec) return conv5<T, 16>(p, stream);
  return conv5<T, (int)sizeof(T)>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor of one call has the same
// type); every pointer aligned to 16 bytes. x (frames,H,W,C), the shared
// input; x2, y2, se (frames,H,W,c_out); H's and G's parameters in the order
// w1..w4 (3,3,C+gc*k,gc), b1..b4 (gc), w5 (3,C+4*gc,c_out), b5 (c_out);
// feats_h, feats_g (frames,H,W,4*GCP) scratch, written (GCP = 16 for gc <=
// 16, else 32; pad lanes as 0); frames = B*T with T = frames_per_clip,
// 2*frames <= 65535; 1 <= gc <= 32; rev 0: forward combine, 1: reverse.
// Returns the first cudaError_t a launch reports, 0 when all five were
// accepted.
extern "C" int selfc_chain_hg_forward(const void* x, const void* x2, const void* hw1, const void* hw2, const void* hw3, const void* hw4, const void* hb1, const void* hb2, const void* hb3, const void* hb4, const void* hw5, const void* hb5, const void* gw1, const void* gw2, const void* gw3, const void* gw4, const void* gb1, const void* gb2, const void* gb3, const void* gb4, const void* gw5, const void* gb5, void* feats_h, void* feats_g, void* y2, void* se, int frames, int frames_per_clip, int H, int W, int C, int gc, int c_out, float clamp, int rev, int dtype, void* stream) {
  const void* hp[10] = {hw1, hw2, hw3, hw4, hb1, hb2, hb3, hb4, hw5, hb5};
  const void* gp[10] = {gw1, gw2, gw3, gw4, gb1, gb2, gb3, gb4, gw5, gb5};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return hg_forward<float>(x, x2, hp, gp, feats_h, feats_g, y2, se, frames, frames_per_clip, H, W, C, gc, c_out, clamp, rev, s);
  if (dtype == 1) return hg_forward<__nv_bfloat16>(x, x2, hp, gp, feats_h, feats_g, y2, se, frames, frames_per_clip, H, W, C, gc, c_out, clamp, rev, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int selfc_chain_hg_padded_gc(int gc) { return tc::padded_gc(gc); }

extern "C" const char* selfc_hg_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
