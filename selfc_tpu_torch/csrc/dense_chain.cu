// Dense-chain forward for Hopper (sm_90a): the D2DT chain of the SelfC nets.
//
// Replaces selfc_tpu/ops/pallas_chain.py:_chain_kernel_v2 (forward, all seven
// coupling epilogues; its emit_feats output is the feats buffer below, which
// the caller may keep for the backward) and, through the entry
// selfc_dense_chain_feats, :_pallas_feats and :_chain_kernel (x1..x4 alone,
// the latter with conv5 left to the caller). The first two take stripe_w
// (a W-packed batch: images side by side along W, no 3x3 tap across an
// image's edge; the masks are in chain_common.cuh:spatial_layer_kernel).
// The function:
//
//   x1..x4 : four 3x3 SAME convs over the growing concat [x | x1 .. x_{k-1}],
//            each + bias + LeakyReLU(0.2), gc output channels each
//            (gc in 1..32: 32 in the coupling and the 4x prior, 12 in the
//            codec's prior);
//   y5     : a (3,1,1) temporal conv over [x | x1..x4], zero padded in T, + bias;
//   out    : the coupling epilogue applied to y5 in fp32 (see EpMode).
//
// What bounds it: arithmetic. One output pixel of a 64->64 chain costs about
// 331k fp32 operations but moves under 1 KB through device memory even when
// x1..x4 are written out, so the chain sits far above the card's fp32
// operations-per-byte line. The design therefore spends device memory to save
// arithmetic: the chain is five launches (four spatial layers, then conv5 with
// the epilogue) that write x1..x4 into channel slices of ONE preallocated
// (frames, H, W, 4*GCP) buffer (128 channels at gc 32), so no tile ever
// recomputes a halo and the [x | x1..x4] concat is never assembled. Inside a
// launch a block stages a
// 16-channel slab of its input tile and of the weights in shared memory as
// fp32, and every thread keeps an 8 pixel x 8 channel accumulator tile in
// registers (one 16-byte shared load per ~20 FMAs). Staging costs as much as
// the FMAs when it is done element by element, so slabs are staged with
// 16-byte loads wherever a pixel's channels start on a 4-element boundary
// (everything but a 3-channel x). All products are plain fp32 FMAs: no tensor
// cores, no TF32. bf16 tensors are widened on the way in and rounded once on
// the way out.
//
// Growth width below 32 (the TPU kernel zero-pads the weights to 32 lanes
// per segment in selfc_tpu/ops/pallas_chain.py:pad_gc_params, which costs its
// MXU nothing). Here a pad lane costs real FMAs (a 24->24 chain at gc 12 does
// ~18k spatial multiply-adds a pixel, ~83k padded to 32), so gc is only
// rounded up to GCP = 16 (gc <= 16: ~28k, and a 64-thread spatial block whose
// threads keep the 8x8 register tile) or 32. The buffer is
// (frames, H, W, 4*GCP); segment j of it holds x_{j+1} in channels
// GCP*j .. GCP*j+gc-1 and zeros above. The
// weights are read in their own layout (w_k (3,3,C+gc(k-1),gc), w5
// (3,C+4gc,c_out)) and remapped while they are staged: buffer channel
// GCP*j + l is weight row C + gc*j + l for l < gc and a zero row otherwise,
// output lanes >= gc get zero weights and bias, so they hold lrelu(0) = 0.
// No padded weight copy is made. The 16-lane rounding also keeps every
// segment 16-byte aligned in fp32 and bf16, so the 16-byte loads stay.
//
// The spatial layer, its staging helpers and the epilogue live in
// csrc/chain_common.cuh, which the chain variants (chain_hg.cu, chain_ride.cu)
// share.
//
// Plain C interface (loaded with ctypes); the caller owns every buffer.

#include "chain_common.cuh"

namespace {

using namespace chain;  // the spatial layer, staging helpers and the epilogue

constexpr int NTHREADS = 128;       // threads of a conv5 block
constexpr int PIX5 = 256;           // conv5: most pixels a block handles
constexpr int CO5 = 64;             // conv5: most output channels a block handles

// conv5 + epilogue: out = ep(b5 + sum_dt [x | feats](t + dt - 1) @ w5[dt]),
// feats of 4*gcp channels with gc real ones a segment (w5 rows remapped).
// grid = (ceil(HW / (P*npg)), ceil(c_out / 64), frames), block = npg*ng threads,
// ng = channel groups of 8 in a block (<= 8), npg = pixel groups, P = pixels a
// thread (P*npg <= 256). Thread (pg, cg): pixels pg + j*npg (j < P) of the
// block's run of pixels, output channels co_base + 8*cg .. +7. A tap whose
// frame lies outside the clip is skipped by the whole block (zero padding in
// T). With one channel group (c_out <= 8) the layer only streams its input, so
// it runs with P = 2: a full block of threads to keep loads in flight.
template <typename T, int P>
__global__ void __launch_bounds__(NTHREADS) conv5_ep_kernel(const T* x, const T* feats, const T* w5, const T* b5, const T* a, const T* m, T* out, int Tn, int HW, int C, int gc, int gcp, int c_out, int ng, int npg, int mode, float clamp) {
  __shared__ float4 in_s[KC / 4][PIX5];
  __shared__ __align__(16) float w_s[KC][CO5];

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
  const int ctot = C + 4 * gc;  // rows of w5

  float acc[P][8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int co = co_base + cg * 8 + q;
    const float bias = co < c_out ? to_f(b5[co]) : 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) acc[j][q] = bias;
  }

  for (int dt = 0; dt < 3; ++dt) {
    const int tt = t + dt - 1;
    if (tt < 0 || tt >= Tn) continue;  // same for every thread of the block
    const size_t fsrc = frame + dt - 1;
    for (int src = 0; src < 2; ++src) {
      const int nsrc = src == 0 ? C : fc;
      const int stride = nsrc;
      const T* base = src == 0 ? x + fsrc * HW * C : feats + fsrc * HW * fc;
      for (int c0 = 0; c0 < nsrc; c0 += KC) {
        const int kc = min(KC, nsrc - c0);
        const int kc4 = (kc + 3) >> 2;
        __syncthreads();
        if ((stride & 3) == 0) {
          for (int idx = tid; idx < mt * (KC / 4); idx += nthreads) {
            const int c4 = idx & (KC / 4 - 1);
            const int lp = idx / (KC / 4);
            if (c4 >= kc4) continue;
            const int gp = pix0 + lp;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (gp < HW) v = load4(base + (size_t)gp * stride + c0 + c4 * 4);
            in_s[c4][lp] = v;
          }
        } else {
          for (int idx = tid; idx < mt * KC; idx += nthreads) {
            const int c = idx & (KC - 1);
            const int lp = idx / KC;
            if (c >= kc4 * 4) continue;
            const int gp = pix0 + lp;
            float v = 0.f;
            if (c < kc && gp < HW) v = to_f(base[(size_t)gp * stride + c0 + c]);
            reinterpret_cast<float*>(&in_s[c >> 2][lp])[c & 3] = v;
          }
        }
        const SlabRows sr = slab_rows(src, c0, kc, C, gc, gcp);
        if ((c_out & 3) == 0) {
          const int nco4 = nco / 4;
          for (int idx = tid; idx < KC * nco4; idx += nthreads) {
            const int col = (idx % nco4) * 4;
            const int c = idx / nco4;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (c < sr.nreal && co_base + col < c_out) v = load4(w5 + ((size_t)dt * ctot + sr.row0 + c) * c_out + co_base + col);
            *reinterpret_cast<float4*>(&w_s[c][col]) = v;
          }
        } else {
          for (int idx = tid; idx < KC * nco; idx += nthreads) {
            const int col = idx % nco;
            const int c = idx / nco;
            const int co = co_base + col;
            float v = 0.f;
            if (c < sr.nreal && co < c_out) v = to_f(w5[((size_t)dt * ctot + sr.row0 + c) * c_out + co]);
            w_s[c][col] = v;
          }
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
            const float4 wa = *reinterpret_cast<const float4*>(&w_s[c4 * 4 + cc][cg * 8]);
            const float4 wb = *reinterpret_cast<const float4*>(&w_s[c4 * 4 + cc][cg * 8 + 4]);
#pragma unroll
            for (int j = 0; j < P; ++j) {
              const float v = in[j][cc];
              acc[j][0] = fmaf(v, wa.x, acc[j][0]);
              acc[j][1] = fmaf(v, wa.y, acc[j][1]);
              acc[j][2] = fmaf(v, wa.z, acc[j][2]);
              acc[j][3] = fmaf(v, wa.w, acc[j][3]);
              acc[j][4] = fmaf(v, wb.x, acc[j][4]);
              acc[j][5] = fmaf(v, wb.y, acc[j][5]);
              acc[j][6] = fmaf(v, wb.z, acc[j][6]);
              acc[j][7] = fmaf(v, wb.w, acc[j][7]);
            }
          }
        }
      }
    }
  }

  // the epilogue runs here, on the fp32 accumulator, with a and m read as fp32
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int gp = pix0 + pg + j * npg;
    if (gp < HW) {
      const size_t o = (frame * HW + gp) * c_out;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int co = co_base + cg * 8 + q;
        if (co < c_out) {
          const float av = a != nullptr ? to_f(a[o + co]) : 0.f;
          const float mv = m != nullptr ? to_f(m[o + co]) : 0.f;
          from_f(ep_apply(acc[j][q], mode, clamp, av, mv), out + o + co);
        }
      }
    }
  }
}


// The four spatial layers, in order: layer k reads what layers < k wrote.
// stripe_w > 0: x is a W-packed batch of images stripe_w columns wide (the
// STRIPE instantiation, which masks the taps across stripe edges).
template <typename T, int GCP, bool FULL>
int spatial_layers_at(const void* x, void* feats, const void* const* ws, const void* const* bs, int frames, int H, int W, int C, int gc, int stripe_w, cudaStream_t stream) {
  const dim3 grid_s((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, frames);
  SpatialArgs<T> a{};
  a.x = (const T*)x;
  a.feats[0] = a.feats[1] = (T*)feats;
  a.H = H;
  a.W = W;
  a.C = C;
  a.gc = gc;
  a.write_feats = 1;
  a.stripe_w = stripe_w;
  for (int layer = 0; layer < 4; ++layer) {
    a.layer = layer;
    a.w[0] = a.w[1] = (const T*)ws[layer];
    a.b[0] = a.b[1] = (const T*)bs[layer];
    if (stripe_w > 0) {
      spatial_layer_kernel<T, GCP, FULL, false, 1, true><<<grid_s, 4 * GCP, 0, stream>>>(a);
    } else {
      spatial_layer_kernel<T, GCP, FULL, false, 1><<<grid_s, 4 * GCP, 0, stream>>>(a);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int spatial_layers(const void* x, void* feats, const void* const* ws, const void* const* bs, int frames, int H, int W, int C, int gc, int stripe_w, cudaStream_t stream) {
  if (gc < 1 || gc > GC_MAX) return (int)cudaErrorInvalidValue;
  if (stripe_w < 0 || (stripe_w > 0 && W % stripe_w != 0)) return (int)cudaErrorInvalidValue;
  if (gc == GC_MAX) return spatial_layers_at<T, GC_MAX, true>(x, feats, ws, bs, frames, H, W, C, gc, stripe_w, stream);
  if (gc <= 16) return spatial_layers_at<T, 16, false>(x, feats, ws, bs, frames, H, W, C, gc, stripe_w, stream);
  return spatial_layers_at<T, GC_MAX, false>(x, feats, ws, bs, frames, H, W, C, gc, stripe_w, stream);
}

template <typename T>
int chain_forward(const void* x, void* feats, const void* const* ws, const void* const* bs, const void* w5, const void* b5, const void* a, const void* m, void* out, int frames, int Tn, int H, int W, int C, int gc, int c_out, int mode, float clamp, int stripe_w, cudaStream_t stream) {
  const int err = spatial_layers<T>(x, feats, ws, bs, frames, H, W, C, gc, stripe_w, stream);
  if (err != 0) return err;
  const int gcp = padded_gc(gc);
  const int co_blk = c_out < CO5 ? c_out : CO5;
  const int ng = (co_blk + 7) / 8;
  const int HW = H * W;
  const int gy = (c_out + CO5 - 1) / CO5;
  if (ng == 1) {
    const int npg = NTHREADS;
    const dim3 grid_5((HW + npg * 2 - 1) / (npg * 2), gy, frames);
    conv5_ep_kernel<T, 2><<<grid_5, npg, 0, stream>>>((const T*)x, (const T*)feats, (const T*)w5, (const T*)b5, (const T*)a, (const T*)m, (T*)out, Tn, HW, C, gc, gcp, c_out, ng, npg, mode, clamp);
  } else {
    int npg = NTHREADS / ng;
    if (npg > PIX5 / 8) npg = PIX5 / 8;
    const dim3 grid_5((HW + npg * 8 - 1) / (npg * 8), gy, frames);
    conv5_ep_kernel<T, 8><<<grid_5, ng * npg, 0, stream>>>((const T*)x, (const T*)feats, (const T*)w5, (const T*)b5, (const T*)a, (const T*)m, (T*)out, Tn, HW, C, gc, gcp, c_out, ng, npg, mode, clamp);
  }
  return (int)cudaGetLastError();
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
extern "C" int selfc_dense_chain_padded_gc(int gc) { return chain::padded_gc(gc); }

extern "C" const char* selfc_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
