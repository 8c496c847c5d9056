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
// this one: the two chains read their input once a tile (one launch runs
// layer k of both: the chain is a grid dimension, and the two blocks of a
// tile read the same x rows one after the other, the second from L2), and
// the combine runs on the fp32 conv5 accumulators, so exp(+-s) never goes to
// device memory to be read back as the m operand of G's epilogue. Five
// launches where the two epilogue chains make ten: four spatial layers over
// two feats buffers in B1's (frames, H, W, 4*GCP) layout, then one conv5 +
// combine launch that reads both buffers, holds h5 and g5 in registers and
// writes y2 and se.
//
// Bound: arithmetic, as B1 (two chains' FMAs over one input's bytes). The
// spatial layers are B1's (csrc/chain_common.cuh); plain fp32 FMAs, no
// tensor cores, bf16 widened on load and rounded once on store. Any B, T, H,
// W, C; growth width 1..32; c_out any.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include "chain_common.cuh"

namespace {

using namespace chain;

constexpr int NTHREADS = 128;  // threads of a conv5 block
constexpr int PIX5 = 256;      // conv5: most pixels a block handles
constexpr int CO5 = 64;        // conv5: most output channels a block handles

// conv5 of both chains + the combine. grid = (ceil(HW / (P*npg)),
// ceil(c_out / 64), frames), block = npg*ng threads; thread (pg, cg): pixels
// pg + j*npg (j < P), output channels co_base + 8*cg .. +7 of both chains.
// The sources are x (read for both chains), feats_h and feats_g; a tap whose
// frame lies outside the clip is skipped by the whole block.
template <typename T, int P>
__global__ void __launch_bounds__(NTHREADS) hg_conv5_kernel(const T* x, const T* fh, const T* fg, const T* hw5, const T* hb5, const T* gw5, const T* gb5, const T* x2, T* y2, T* se, int Tn, int HW, int C, int gc, int gcp, int c_out, int ng, int npg, float clamp, int rev) {
  __shared__ float4 in_s[KC / 4][PIX5];
  __shared__ __align__(16) float wh_s[KC][CO5];
  __shared__ __align__(16) float wg_s[KC][CO5];

  const int tid = threadIdx.x;
  const int nthreads = ng * npg;
  const int cg = tid % ng;
  const int pg = tid / ng;
  const int mt = npg * P;
  const int pix0 = blockIdx.x * mt;
  const int co_base = blockIdx.y * CO5;
  const int nco = ng * 8;
  const size_t frame = blockIdx.z;
  const int t = (int)(frame % Tn);
  const int fc = 4 * gcp;
  const int ctot = C + 4 * gc;

  float ah[P][8], ag[P][8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int co = co_base + cg * 8 + q;
    const float bh = co < c_out ? to_f(hb5[co]) : 0.f;
    const float bg = co < c_out ? to_f(gb5[co]) : 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      ah[j][q] = bh;
      ag[j][q] = bg;
    }
  }

  for (int dt = 0; dt < 3; ++dt) {
    const int tt = t + dt - 1;
    if (tt < 0 || tt >= Tn) continue;  // the same for every thread of the block
    const size_t fsrc = frame + dt - 1;
    for (int src = 0; src < 3; ++src) {  // 0: x (both chains), 1: feats_h, 2: feats_g
      const bool use_h = src != 2, use_g = src != 1;
      const int nsrc = src == 0 ? C : fc;
      const T* base = src == 0 ? x + fsrc * HW * C : (src == 1 ? fh : fg) + fsrc * HW * fc;
      for (int c0 = 0; c0 < nsrc; c0 += KC) {
        const int kc = min(KC, nsrc - c0);
        const int kc4 = (kc + 3) >> 2;
        __syncthreads();
        if ((nsrc & 3) == 0) {
          for (int idx = tid; idx < mt * (KC / 4); idx += nthreads) {
            const int c4 = idx & (KC / 4 - 1);
            const int lp = idx / (KC / 4);
            if (c4 >= kc4) continue;
            const int gp = pix0 + lp;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (gp < HW) v = load4(base + (size_t)gp * nsrc + c0 + c4 * 4);
            in_s[c4][lp] = v;
          }
        } else {
          for (int idx = tid; idx < mt * KC; idx += nthreads) {
            const int c = idx & (KC - 1);
            const int lp = idx / KC;
            if (c >= kc4 * 4) continue;
            const int gp = pix0 + lp;
            float v = 0.f;
            if (c < kc && gp < HW) v = to_f(base[(size_t)gp * nsrc + c0 + c]);
            reinterpret_cast<float*>(&in_s[c >> 2][lp])[c & 3] = v;
          }
        }
        const SlabRows sr = slab_rows(src != 0, c0, kc, C, gc, gcp);
        for (int idx = tid; idx < KC * nco; idx += nthreads) {
          const int col = idx % nco;
          const int c = idx / nco;
          const int co = co_base + col;
          const bool real = c < sr.nreal && co < c_out;
          const size_t off = ((size_t)dt * ctot + sr.row0 + c) * c_out + co;
          if (use_h) wh_s[c][col] = real ? to_f(hw5[off]) : 0.f;
          if (use_g) wg_s[c][col] = real ? to_f(gw5[off]) : 0.f;
        }
        __syncthreads();

        for (int c4 = 0; c4 < kc4; ++c4) {
          float in[P][4];
#pragma unroll
          for (int j = 0; j < P; ++j) {
            const float4 v4 = in_s[c4][pg + j * npg];
            in[j][0] = v4.x;
            in[j][1] = v4.y;
            in[j][2] = v4.z;
            in[j][3] = v4.w;
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            if (use_h) {
              const float4 wa = *reinterpret_cast<const float4*>(&wh_s[c4 * 4 + cc][cg * 8]);
              const float4 wb = *reinterpret_cast<const float4*>(&wh_s[c4 * 4 + cc][cg * 8 + 4]);
#pragma unroll
              for (int j = 0; j < P; ++j) {
                const float v = in[j][cc];
                ah[j][0] = fmaf(v, wa.x, ah[j][0]);
                ah[j][1] = fmaf(v, wa.y, ah[j][1]);
                ah[j][2] = fmaf(v, wa.z, ah[j][2]);
                ah[j][3] = fmaf(v, wa.w, ah[j][3]);
                ah[j][4] = fmaf(v, wb.x, ah[j][4]);
                ah[j][5] = fmaf(v, wb.y, ah[j][5]);
                ah[j][6] = fmaf(v, wb.z, ah[j][6]);
                ah[j][7] = fmaf(v, wb.w, ah[j][7]);
              }
            }
            if (use_g) {
              const float4 wa = *reinterpret_cast<const float4*>(&wg_s[c4 * 4 + cc][cg * 8]);
              const float4 wb = *reinterpret_cast<const float4*>(&wg_s[c4 * 4 + cc][cg * 8 + 4]);
#pragma unroll
              for (int j = 0; j < P; ++j) {
                const float v = in[j][cc];
                ag[j][0] = fmaf(v, wa.x, ag[j][0]);
                ag[j][1] = fmaf(v, wa.y, ag[j][1]);
                ag[j][2] = fmaf(v, wa.z, ag[j][2]);
                ag[j][3] = fmaf(v, wa.w, ag[j][3]);
                ag[j][4] = fmaf(v, wb.x, ag[j][4]);
                ag[j][5] = fmaf(v, wb.y, ag[j][5]);
                ag[j][6] = fmaf(v, wb.z, ag[j][6]);
                ag[j][7] = fmaf(v, wb.w, ag[j][7]);
              }
            }
          }
        }
      }
    }
  }

  // the combine, on the fp32 accumulators
  const float sgn = rev ? -1.f : 1.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int gp = pix0 + pg + j * npg;
    if (gp < HW) {
      const size_t o = (frame * HW + gp) * c_out;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int co = co_base + cg * 8 + q;
        if (co < c_out) {
          const float e = expf(sgn * clamp * (2.f / (1.f + expf(-ah[j][q])) - 1.f));
          const float xv = to_f(x2[o + co]);
          const float y = rev ? (xv - ag[j][q]) * e : xv * e + ag[j][q];
          from_f(y, y2 + o + co);
          from_f(e, se + o + co);
        }
      }
    }
  }
}

template <typename T>
int hg_forward(const void* x, const void* x2, const void* const* hp, const void* const* gp, void* feats_h, void* feats_g, void* y2, void* se, int frames, int Tn, int H, int W, int C, int gc, int c_out, float clamp, int rev, cudaStream_t stream) {
  if (gc < 1 || gc > GC_MAX) return (int)cudaErrorInvalidValue;
  const int gcp = padded_gc(gc);
  // hp / gp: w1..w4, b1..b4, w5, b5 of H / G
  SpatialArgs<T> a{};
  a.x = (const T*)x;
  a.feats[0] = (T*)feats_h;
  a.feats[1] = (T*)feats_g;
  a.H = H;
  a.W = W;
  a.C = C;
  a.gc = gc;
  a.write_feats = 1;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, frames * 2);
  for (int layer = 0; layer < 4; ++layer) {
    a.layer = layer;
    a.w[0] = (const T*)hp[layer];
    a.w[1] = (const T*)gp[layer];
    a.b[0] = (const T*)hp[4 + layer];
    a.b[1] = (const T*)gp[4 + layer];
    if (gc == GC_MAX)
      spatial_layer_kernel<T, GC_MAX, true, 2><<<grid, 4 * GC_MAX, 0, stream>>>(a);
    else if (gc <= 16)
      spatial_layer_kernel<T, 16, false, 2><<<grid, 4 * 16, 0, stream>>>(a);
    else
      spatial_layer_kernel<T, GC_MAX, false, 2><<<grid, 4 * GC_MAX, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int co_blk = c_out < CO5 ? c_out : CO5;
  const int ng = (co_blk + 7) / 8;
  const int HW = H * W;
  const int gy = (c_out + CO5 - 1) / CO5;
  const T* hw5 = (const T*)hp[8];
  const T* hb5 = (const T*)hp[9];
  const T* gw5 = (const T*)gp[8];
  const T* gb5 = (const T*)gp[9];
  if (ng == 1) {
    const int npg = NTHREADS;
    const dim3 grid5((HW + npg * 2 - 1) / (npg * 2), gy, frames);
    hg_conv5_kernel<T, 2><<<grid5, npg, 0, stream>>>((const T*)x, (const T*)feats_h, (const T*)feats_g, hw5, hb5, gw5, gb5, (const T*)x2, (T*)y2, (T*)se, Tn, HW, C, gc, gcp, c_out, ng, npg, clamp, rev);
  } else {
    int npg = NTHREADS / ng;
    if (npg > PIX5 / 4) npg = PIX5 / 4;
    const dim3 grid5((HW + npg * 4 - 1) / (npg * 4), gy, frames);
    hg_conv5_kernel<T, 4><<<grid5, ng * npg, 0, stream>>>((const T*)x, (const T*)feats_h, (const T*)feats_g, hw5, hb5, gw5, gb5, (const T*)x2, (T*)y2, (T*)se, Tn, HW, C, gc, gcp, c_out, ng, npg, clamp, rev);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor of one call has the same
// type); every pointer aligned to 16 bytes. x (frames,H,W,C), the shared
// input; x2, y2, se (frames,H,W,c_out); H's and G's parameters in the order
// w1..w4 (3,3,C+gc*k,gc), b1..b4 (gc), w5 (3,C+4*gc,c_out), b5 (c_out);
// feats_h, feats_g (frames,H,W,4*GCP) scratch, written (GCP = 16 for gc <=
// 16, else 32); frames = B*T with T = frames_per_clip; 1 <= gc <= 32;
// rev 0: forward combine, 1: reverse. Returns the first cudaError_t a launch
// reports, 0 when all five were accepted.
extern "C" int selfc_chain_hg_forward(const void* x, const void* x2, const void* hw1, const void* hw2, const void* hw3, const void* hw4, const void* hb1, const void* hb2, const void* hb3, const void* hb4, const void* hw5, const void* hb5, const void* gw1, const void* gw2, const void* gw3, const void* gw4, const void* gb1, const void* gb2, const void* gb3, const void* gb4, const void* gw5, const void* gb5, void* feats_h, void* feats_g, void* y2, void* se, int frames, int frames_per_clip, int H, int W, int C, int gc, int c_out, float clamp, int rev, int dtype, void* stream) {
  const void* hp[10] = {hw1, hw2, hw3, hw4, hb1, hb2, hb3, hb4, hw5, hb5};
  const void* gp[10] = {gw1, gw2, gw3, gw4, gb1, gb2, gb3, gb4, gw5, gb5};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return hg_forward<float>(x, x2, hp, gp, feats_h, feats_g, y2, se, frames, frames_per_clip, H, W, C, gc, c_out, clamp, rev, s);
  if (dtype == 1) return hg_forward<__nv_bfloat16>(x, x2, hp, gp, feats_h, feats_g, y2, se, frames, frames_per_clip, H, W, C, gc, c_out, clamp, rev, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int selfc_chain_hg_padded_gc(int gc) { return chain::padded_gc(gc); }

extern "C" const char* selfc_hg_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
