// Tensor-core machinery the redesigned kernels share: csrc/temporal_conv.cu
// (B6), csrc/chain_v3.cu (B8), csrc/dense_chain_bwd.cu (B2) and, through
// csrc/tc_chain.cuh, csrc/dense_chain.cu (B1, B3), csrc/chain_ride.cu (B9)
// and csrc/chain_hg.cu (B7). All are products whose contraction walks
// shifted taps of a staged tile: the conv5 of B6, B7, B8 and B1 the three
// frames of a temporal conv, the spatial layers and B2's data gradient the
// nine pixels of a 3x3 conv, B2's weight gradient the pixels.
//
// Products: mma.sync on the tensor cores, fp32 accumulation.
//  - fp32 operands take the 3xTF32 split (CUTLASS's fast-fp32 path): each
//    value a = hi + lo with hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi),
//    and D += lo*hi' + hi*lo' + hi*hi' by m16n8k8 TF32 products. The dropped
//    lo*lo' term is ~2^-22 of a product, so sums keep fp32 accuracy; one TF32
//    product alone keeps ~3 digits, and no fp32 path here takes it.
//  - bf16 operands take m16n8k16 bf16 products.
// Why mma.sync and not wgmma: the A operand of a tap is the staged tile
// shifted by one pixel (or one frame). A wgmma shared-memory descriptor
// addresses 8-row-aligned core matrices under its swizzle and cannot start a
// tile one row down; mma.sync reads A through registers, from any row. The
// expectation was that staging, not the issue rate, would set the pace (N is
// 16 or 32 in B8's spatial layers, 3..64 in B6's narrow rows). On an NVIDIA
// H100 the mma issue does: at B6's 432 -> 768 each of the three TF32 passes
// costs the same ~0.13 ms (~170 TFLOP/s), and the kernel with no mma at all
// (fragments still loaded and split) takes the rest. wgmma with A from
// registers (its RS form takes any row) is the next step.
//
// Staging: cp.async into a ring of shared-memory stages, 16 bytes a copy
// where a row is 16-byte aligned, else one element a copy: 4 bytes in fp32,
// and in bf16 a plain 2-byte load and store (cp.async copies 4, 8 or 16
// bytes). A copy fetches only its valid bytes and zero-fills the rest.
//
// The temporal-conv block loop (tconv_block) serves B6 and the conv5 of B8
// and B1 (B7's conv5 runs the same loop over two chains): a block owns P
// pixels x TT frames of one clip (frames fastest, so a tap is a shift by
// one row of the staged tile) and walks K in slabs of 64
// bytes of channels (16 fp32, 32 bf16) of one or two sources; each staged
// slab feeds all three taps, so x is read from device memory once a block.
// B1's conv5 (CHAIN) reads its second source in the padded feats layout and
// applies the coupling epilogue on the fp32 accumulators.
//
// On the CPU (tools/cpu_rehearsal.py) the primitives below the
// SELFC_CPU_STANDIN guard come from the rehearsal's stand-in header: the
// warp products executed warp-collectively from the 32 lanes' fragments (the
// TF32 operands truncated to their 19 bits as the hardware reads them),
// cvt.rna.tf32 emulated, cp.async a plain copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tc {

#ifndef SELFC_CPU_STANDIN
// fp32 -> tf32, round to nearest with ties away from zero; the low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's MT x NT tile of m16n8 products, 3xTF32: the small terms of every
// tile first, then the large, each accumulator in the order lo*hi, hi*lo, hi*hi.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma_3xtf32(float (&acc)[MT][NT][4], const uint32_t (&ah)[MT][4], const uint32_t (&al)[MT][4],
                                                const uint32_t (&bh)[NT][2], const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], al[m], bh[n]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ah[m], bl[n]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(acc[m][n], ah[m], bh[n]);
}

template <int MT, int NT>
__device__ __forceinline__ void warp_mma_bf16(float (&acc)[MT][NT][4], const uint32_t (&a)[MT][4], const uint32_t (&b)[NT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_bf16(acc[m][n], a[m], b[n]);
}

// cp.async of BYTES (4, 8 or 16) of which src_bytes are read, the rest zeroed
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // a slab reads 64 bytes of a row; the L2 prefetch brings the next slabs' in
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(BYTES), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif  // SELFC_CPU_STANDIN

constexpr int ROW_BYTES = 64;       // a staged row: 16 fp32 or 32 bf16 channels of one slab
constexpr int ROW_STRIDE = 80;      // bytes between staged rows (20 words: 8 rows on 32 banks)
constexpr int ROW_WORDS = ROW_STRIDE / 4;

template <typename T>
struct Elem {
  static constexpr int BK = ROW_BYTES / (int)sizeof(T);   // channels a slab
  static constexpr int KSTEP = sizeof(T) == 4 ? 8 : 16;  // k of one mma
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

// The coupling epilogues of the dense chain (ops/dense_chain.py:EP_AUX),
// applied to conv5's fp32 output y with a and m read as fp32.
enum EpMode { EP_NONE = 0, EP_ADD = 1, EP_SUB_FROM = 2, EP_SIG_EXP = 3, EP_SIG_EXP_NEG = 4, EP_MUL_ADD = 5, EP_SUB_MUL = 6 };

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

// Copy VB bytes to shared memory, of which `valid` are read from src (the
// rest zero); VB = 2 is a plain load and store (bf16 rows of an odd width).
template <int VB>
__device__ __forceinline__ void stage_copy(void* dst, const void* src, int valid) {
  if constexpr (VB >= 4)
    cp_async<VB>(dst, src, valid);
  else
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
}

// Whether every row of `row_bytes` bytes from base is 16-byte aligned.
inline bool rows_aligned16(const void* base, size_t row_bytes) {
  return (reinterpret_cast<size_t>(base) | row_bytes) % 16 == 0;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// The split without conversions (B2's, whose fragment loads split every
// operand value again, so that the conversions cost more than the mma): hi
// is v truncated to TF32, lo the exact remainder, which the tensor core reads
// truncated to TF32 too. Each operand keeps ~2^-20 of its value where the
// rounded split keeps ~2^-22 (tools/tc_attribution.py's rna_split times B2
// with the rounded one).
__device__ __forceinline__ void split_tf32_fast(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// Fragments from shared memory. A (m16 x k): r0 / r1 point at rows g and g+8
// of the fragment, at channel k0 (words for fp32; bf16 pairs as words). B
// (k x n8): bp points at element (k0 + t [fp32] or k0 + 2t [bf16], n0 + g)
// of a [k][n] tile whose rows hold sn elements.
__device__ __forceinline__ void frag_a(const float* r0, const float* r1, int t, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(r0[t], hi[0], lo[0]);
  split_tf32(r1[t], hi[1], lo[1]);
  split_tf32(r0[t + 4], hi[2], lo[2]);
  split_tf32(r1[t + 4], hi[3], lo[3]);
}
__device__ __forceinline__ void frag_a(const uint32_t* r0, const uint32_t* r1, int t, uint32_t (&a)[4]) {
  a[0] = r0[t];
  a[1] = r1[t];
  a[2] = r0[t + 4];
  a[3] = r1[t + 4];
}
__device__ __forceinline__ void frag_b(const float* bp, int sn, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(bp[0], hi[0], lo[0]);
  split_tf32(bp[4 * sn], hi[1], lo[1]);
}
__device__ __forceinline__ void frag_b(const uint16_t* bp, int sn, uint32_t (&b)[2]) {
  b[0] = (uint32_t)bp[0] | ((uint32_t)bp[sn] << 16);
  b[1] = (uint32_t)bp[8 * sn] | ((uint32_t)bp[9 * sn] << 16);
}

// Elements between rows of a staged [k][n] weight tile n wide: 16j + 8 >= n,
// so rows lie 8 or 24 words apart mod 32 and the lanes' B loads meet 32
// banks, and every row starts 16-byte aligned.
constexpr int b_stride(int n) { return (n + 7) / 16 * 16 + 8; }

// The tensor cores add into their accumulator with truncation, so an error
// grows with the number of products summed in one: each slab's products (48
// a k-row in the temporal conv, 144 in B8's spatial layers) go into a zeroed
// part, which an fp32 add carries into the running sum. On an NVIDIA H100,
// B6 at 1152 -> 48 (K = 3456, outputs of order 1) differed from the plain
// fp32 version by 9.6e-5 without the parts and by 2.1e-6 with them.
template <int MT, int NT>
__device__ __forceinline__ void zero(float (&a)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[m][n][i] = 0.f;
}
template <int MT, int NT>
__device__ __forceinline__ void add_into(float (&acc)[MT][NT][4], const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] += part[m][n][i];
}

// One k-slab of a warp's product: MT m16 fragments whose rows the lane finds
// at a0[m] / a1[m] (word offsets of rows g and g+8 in the A stage), NT n8
// fragments from the B stage bs (rows of SN elements, starting at column
// n0w), KS k-steps. BY_COLUMN: the fp32 products one n8 column at a time, so
// that only that column's B fragments are live (the temporal conv's wide
// tile, 32 x 32 a warp, stays within 128 registers); else all NT at once.
template <typename T, int MT, int NT, int SN, bool BY_COLUMN = false>
__device__ __forceinline__ void slab_mma(float (&acc)[MT][NT][4], const uint32_t* as, const int (&a0)[MT], const int (&a1)[MT], const T* bs,
                                         int n0w, int g, int t) {
  constexpr int KS = Elem<T>::BK / Elem<T>::KSTEP;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if constexpr (sizeof(T) == 4) {
      const float* af = reinterpret_cast<const float*>(as);
      const float* bf = reinterpret_cast<const float*>(bs);
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) frag_a(af + a0[m] + 8 * ks, af + a1[m] + 8 * ks, t, ah[m], al[m]);
      if constexpr (!BY_COLUMN) {
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) frag_b(bf + (8 * ks + t) * SN + n0w + 8 * n + g, SN, bh[n], bl[n]);
        warp_mma_3xtf32<MT, NT>(acc, ah, al, bh, bl);
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh[1][2], bl[1][2];
          frag_b(bf + (8 * ks + t) * SN + n0w + 8 * n + g, SN, bh[0], bl[0]);
          float c[MT][1][4];   // the column's accumulators (registers: the copies fold away)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i) c[m][0][i] = acc[m][n][i];
          warp_mma_3xtf32<MT, 1>(c, ah, al, bh, bl);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[m][n][i] = c[m][0][i];
        }
      }
    } else {
      const uint16_t* bh16 = reinterpret_cast<const uint16_t*>(bs);
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) frag_a(as + a0[m] + 8 * ks, as + a1[m] + 8 * ks, t, a[m]);
#pragma unroll
      for (int n = 0; n < NT; ++n) frag_b(bh16 + (16 * ks + 2 * t) * SN + n0w + 8 * n + g, SN, b[n]);
      warp_mma_bf16<MT, NT>(acc, a, b);
    }
  }
}

// ---------------------------------------------------------------------------
// The temporal conv (3,1,1), zero padding in T, as one block-tile loop:
//
//   out[b][t][s][n] = act(bias[n] + sum_k sum_c A[b][t+k-1][s][c] * w[k][c][n])
//
// with A = [src0 | src1] along channels (B6: x alone; B8's conv5: x and the
// chain's features). Row (b, t, s) of a source is its ((b*T + t)*S + s)-th.
// ---------------------------------------------------------------------------

template <typename T>
struct TconvArgs {
  const T* src[2];   // (B*T*S, ch[i]) channels-last
  int ch[2];         // channels of each source (ch[1] = 0: one source)
  const T* w;        // (3, ch[0] + ch[1], Co)
  const T* bias;     // (Co) or null
  T* out;            // (B*T*S, Co)
  uint8_t* mask;     // (B*T*S, Co): act input >= 0, or null
  float* partial;    // split-K: (split, B*T*S, Co) fp32 sums before the epilogue, or null
  int B, Tlen, S, Co;   // clips, frames a clip, pixels a frame, output channels
  int TT, P, halo;   // a block: P pixels x TT frames; halo: the frames beside them are staged
  int tiles_n, tiles_s, tiles_t;
  int split;         // parts of the K slabs over blockIdx.y
  int act;           // LeakyReLU of negative slope `slope`
  float slope;
  int w_vec;         // the weight rows allow 16-byte copies
  // B1's conv5 (tconv_block's CHAIN): src[1] is a feats buffer whose lane
  // seg_gcp*j + l holds the chain's channel seg_gc*j + l (l < seg_gc; the
  // lanes above are pads and meet zero rows); the epilogue ep_mode with a
  // and m (as out, or null) follows the bias
  int seg_gcp, seg_gc;
  const T* ep_a;
  const T* ep_m;
  int ep_mode;
  float ep_clamp;
};

// Warps WM x WN, each MT m16 x NT n8 fragments: BM x BN outputs a block.
template <int WM_, int WN_, int MT_, int NT_>
struct TconvTile {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_;
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8, THREADS = WM * WN * 32;
  static constexpr int SN = b_stride(BN);
  static constexpr int STAGES = 3;
  static constexpr int A_BYTES = (BM + 1) * ROW_STRIDE;   // row BM stays zero
  static constexpr int STAGE_BYTES = (A_BYTES + 3 * ROW_BYTES * SN + 127) / 128 * 128;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
};
using TileWide = TconvTile<4, 2, 2, 4>;      // 128 x 64, 8 warps
using TileWide48 = TconvTile<4, 2, 2, 3>;    // 128 x 48, 8 warps
using TileNarrow16 = TconvTile<8, 1, 2, 2>;  // 256 x 16, 8 warps
using TileNarrow8 = TconvTile<8, 1, 2, 1>;   // 256 x 8, 8 warps

// The wide tile's columns for Co: 48 where that pads Co less than 64 does
// (48 exactly, 131 to 144 and not 192, 432), else 64.
inline bool wide48(int Co) { return (Co + 47) / 48 * 48 < (Co + 63) / 64 * 64; }

// P pixels x TT frames of a block (halo: the frames beside them are staged
// too): the whole clip when T fits in bm rows.
inline void tconv_tiling(int Tlen, int bm, int& TT, int& P, int& halo) {
  if (Tlen <= bm) {
    TT = Tlen, P = bm / Tlen, halo = 0;
  } else {
    TT = bm - 2, P = 1, halo = 1;
  }
}

// Two neighbouring outputs of a row (the second where `pair`): one 8-byte
// (fp32) or 4-byte (bf16) store where an even Co keeps the pair aligned.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, const float (&v)[2], bool pair, int Co) {
  if (pair && (Co & 1) == 0) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else {
      T two[2];
      from_f(v[0], &two[0]);
      from_f(v[1], &two[1]);
      uint32_t bits;
      memcpy(&bits, two, 4);
      *reinterpret_cast<uint32_t*>(dst) = bits;
    }
    return;
  }
  from_f(v[0], dst);
  if (pair) from_f(v[1], dst + 1);
}

// Stages K slab `slab` of a block's tile into ring stage `st`: the A rows
// q = p*NF + j (pixel p, frame t0 - halo + j) that lie in the clip, by
// copies of VA bytes (CHAIN: the feats source's by 16; this thread: copy
// tid % CPR of every RSTEP-th row), and the slab's weight rows of the three
// taps, columns n0 .. n0+BN.
template <typename T, class Tile, int VA, bool CHAIN>
struct TconvStager {
  static constexpr int BK = Elem<T>::BK, ES = (int)sizeof(T);
  const TconvArgs<T>& p;
  unsigned char* smem;
  int tid, t0, halo, NF, pv, P;
  size_t row_base;   // row of (clip b, frame 0, pixel s0)
  int n0, ns0, ctot;

  template <int VB>
  __device__ __forceinline__ void stage_a(unsigned char* as, const T* src, int ch, int c0) const {
    constexpr int CPR = ROW_BYTES / VB, RSTEP = Tile::THREADS / CPR;
    const int ci = tid % CPR;
    const int cc = c0 + ci * (VB / ES);   // first channel of this thread's copies
    const int valid_bytes = max(0, min(VB, (ch - cc) * ES));
    const int nrows = P * NF, Tl = p.Tlen, S = p.S;
    const int dp = RSTEP / NF, dj = RSTEP % NF;   // a step of RSTEP rows in (pixel, frame)
    int q = tid / CPR;
    int pp = q / NF, j = q % NF;
    for (; q < nrows; q += RSTEP) {
      const int f = t0 - halo + j;
      if (pp < pv && f >= 0 && f < Tl) {
        const T* gp = src + (row_base + (size_t)f * S + pp) * ch + cc;
        stage_copy<VB>(as + q * ROW_STRIDE + ci * VB, valid_bytes ? (const void*)gp : (const void*)src, valid_bytes);
      }
      pp += dp;
      j += dj;
      if (j >= NF) j -= NF, ++pp;
    }
  }

  __device__ __forceinline__ void operator()(int slab, int st) const {
    unsigned char* as = smem + st * Tile::STAGE_BYTES;
    unsigned char* bs = as + Tile::A_BYTES;
    // selects, not a run-time index into the parameter struct (that copies
    // the struct into a stack frame)
    const bool second = slab >= ns0;
    const int c0 = (second ? slab - ns0 : slab) * BK;
    const int ch = second ? p.ch[1] : p.ch[0];
    const T* src = second ? p.src[1] : p.src[0];
    if constexpr (CHAIN && VA != 16) {
      if (second)
        stage_a<16>(as, src, ch, c0);
      else
        stage_a<VA>(as, src, ch, c0);
    } else {
      stage_a<VA>(as, src, ch, c0);
    }
    const int wrow0 = second ? p.ch[0] : 0, Co = p.Co;
    // the weight row of staged channel c0 + kk, or -1 (beyond the source, or
    // CHAIN's pad lane)
    auto wrow = [&](int kk) {
      const int c = c0 + kk;
      if (c >= ch) return -1;
      if (CHAIN && second) {
        const int l = c % p.seg_gcp;
        return l < p.seg_gc ? wrow0 + p.seg_gc * (c / p.seg_gcp) + l : -1;
      }
      return wrow0 + c;
    };
    if (p.w_vec) {
      constexpr int CPB = Tile::BN * ES / 16;   // 16-byte copies a weight row
      for (int i = tid; i < 3 * BK * CPB; i += Tile::THREADS) {
        const int row = i / CPB, cj = i % CPB;
        const int tap = row / BK, r = wrow(row % BK);
        const int n = n0 + cj * (16 / ES);
        const int vb = r >= 0 ? max(0, min(16, (Co - n) * ES)) : 0;
        const T* gp = p.w + ((size_t)tap * ctot + max(r, 0)) * Co + n;
        cp_async<16>(bs + (row * Tile::SN + cj * (16 / ES)) * ES, vb ? (const void*)gp : (const void*)p.w, vb);
      }
    } else {
      for (int i = tid; i < 3 * BK * Tile::BN; i += Tile::THREADS) {
        const int row = i / Tile::BN, nn = i % Tile::BN;
        const int tap = row / BK, r = wrow(row % BK);
        const int n = n0 + nn;
        const int vb = r >= 0 && n < Co ? ES : 0;
        const T* gp = p.w + ((size_t)tap * ctot + max(r, 0)) * Co + n;
        stage_copy<ES>(bs + (row * Tile::SN + nn) * ES, vb ? (const void*)gp : (const void*)p.w, vb);
      }
    }
  }
};

// CHAIN: B1's conv5 (the feats remap and the coupling epilogue of TconvArgs).
template <typename T, class Tile, int VA, bool CHAIN = false>
__device__ __forceinline__ void tconv_block(const TconvArgs<T>& p, unsigned char* smem) {
  constexpr int MT = Tile::MT, NT = Tile::NT, SN = Tile::SN, BK = Elem<T>::BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / Tile::WN, wn = warp % Tile::WN;

  // the block's tile: clip b, pixels s0.., frames t0..; columns n0..
  int bid = blockIdx.x;
  const int tn = bid % p.tiles_n;
  bid /= p.tiles_n;
  const int tt_i = bid % p.tiles_t;
  bid /= p.tiles_t;
  const int ts = bid % p.tiles_s;
  const int b = bid / p.tiles_s;
  const int TT = p.TT, P = p.P, halo = p.halo, Tl = p.Tlen, S = p.S, Co = p.Co;
  const int s0 = ts * P, t0 = tt_i * TT, n0 = tn * Tile::BN;
  const int NF = TT + 2 * halo;   // staged frames a pixel: rows p*NF + j hold frame t0 - halo + j
  const int pv = min(P, S - s0), tv = min(TT, Tl - t0);
  // rows of one tap of w: CHAIN's feats source has seg_gc real lanes a segment
  const int ctot = p.ch[0] + (CHAIN ? p.ch[1] / p.seg_gcp * p.seg_gc : p.ch[1]);

  // K slabs: the first source's, then the second's; this block's share
  const int ns0 = (p.ch[0] + BK - 1) / BK;
  const int nslab = ns0 + (p.ch[1] + BK - 1) / BK;
  const int kb = (int)((long long)nslab * blockIdx.y / p.split);
  const int ke = (int)((long long)nslab * (blockIdx.y + 1) / p.split);

  // the A rows of this lane's fragments: output row r = pixel r / TT, frame
  // r % TT; tap k reads staged row p*NF + (r % TT) + k - 1 + halo, or the
  // zero row where the frame lies outside the clip or the row outside the tile
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

  // the zero row of every stage
  for (int i = tid; i < Tile::STAGES * (ROW_BYTES / 4); i += Tile::THREADS)
    reinterpret_cast<uint32_t*>(smem + (i / (ROW_BYTES / 4)) * Tile::STAGE_BYTES + Tile::BM * ROW_STRIDE)[i % (ROW_BYTES / 4)] = 0u;

  const TconvStager<T, Tile, VA, CHAIN> stage{p, smem, tid, t0, halo, NF, pv, P, (size_t)b * Tl * S + s0, n0, ns0, ctot};
  float acc[MT][NT][4], part[MT][NT][4];
  zero(acc);

#pragma unroll
  for (int s = 0; s < Tile::STAGES - 1; ++s) {
    if (kb + s < ke) stage(kb + s, s);
    cp_async_commit();
  }
  for (int slab = kb; slab < ke; ++slab) {
    cp_async_wait<Tile::STAGES - 2>();
    __syncthreads();   // this slab landed; every warp is done with the stage refilled below
    const int next = slab + Tile::STAGES - 1;
    if (next < ke) stage(next, (next - kb) % Tile::STAGES);
    cp_async_commit();
    const unsigned char* as = smem + ((slab - kb) % Tile::STAGES) * Tile::STAGE_BYTES;
    const T* bs = reinterpret_cast<const T*>(as + Tile::A_BYTES);
    zero(part);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      slab_mma<T, MT, NT, SN, true>(part, reinterpret_cast<const uint32_t*>(as), aoff[0][k], aoff[1][k], bs + k * BK * SN, wn * NT * 8, g, t);
    add_into(acc, part);
  }

  // epilogue: row (pixel, frame) of fragment row g / g+8, columns 2t, 2t+1
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT + m) * 16 + g + 8 * h;
      const int pp = r / TT, ft = r % TT;
      if (pp >= pv || ft >= tv) continue;
      const size_t orow = (size_t)b * Tl * S + s0 + (size_t)(t0 + ft) * S + pp;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n0 + (wn * NT + n) * 8 + 2 * t;   // and col + 1
        if (col >= Co) continue;
        const size_t o = orow * Co + col;
        float v[2] = {acc[m][n][2 * h], acc[m][n][2 * h + 1]};
        const bool pair = col + 1 < Co;
        if (p.partial) {
          store_pair(p.partial + (size_t)blockIdx.y * ((size_t)p.B * Tl * S * Co) + o, v, pair, Co);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (e && !pair) break;
          if (p.bias) v[e] += to_f(p.bias[col + e]);
          if constexpr (CHAIN) {
            v[e] = ep_apply(v[e], p.ep_mode, p.ep_clamp, p.ep_a ? to_f(p.ep_a[o + e]) : 0.f, p.ep_m ? to_f(p.ep_m[o + e]) : 0.f);
            continue;
          }
          if (p.mask) p.mask[o + e] = v[e] >= 0.f ? 1 : 0;
          if (p.act && !(v[e] >= 0.f)) v[e] *= p.slope;
        }
        store_pair(p.out + o, v, pair, Co);
      }
    }
}

}  // namespace tc
