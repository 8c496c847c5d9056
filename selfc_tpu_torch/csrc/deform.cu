// Modulated deformable 3x3 convolution for Hopper (sm_90a): forward and
// backward.
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
//   out[p][co] = sum_k mask[p][k] * sum_c bil_k(p)[c] * weight[k][c][co]
//
// x (N,H,W,C), offset (N,H,W,18) with (dy, dx) of tap k at channels 2k and
// 2k+1 (torchvision's order), mask (N,H,W,9), weight (3,3,C,Cout) read as
// (9,C,Cout). The integer part of py is formed exactly and the offset added
// with one rounding, as the plain version forms it, so both floor the same
// float. The bias stays outside, as in the JAX package's Pallas path.
//
// Backward, for the output gradient g (N,H,W,Cout), with dval_k = g @ W_k^T:
//   dW_k     = sum_p (mask_k * bil_k)^T g
//   dmask_k  = <dval_k, bil_k>
//   doffset  = mask_k * <dval_k, d bil_k / d(wy, wx)>  (floor has no gradient;
//              a corner outside the frame contributes nothing)
//   dx       = scatter of mask_k * w_corner * dval_k to the four corners
//
// What bounds it: arithmetic. The contraction is 2 * C * Cout operations a
// tap and pixel against ~10 * C for the bilinear sample, while a pixel's x,
// offset, mask and out are read or written once (the corners come from L2:
// neighbouring pixels share them). At the decode call's (16,270,480), C =
// Cout = 32, a call is ~44 GFLOP against ~0.75 GB.
//
// Design, simple first (plain fp32 FMAs, no tensor cores, no TF32):
//   * forward: a block owns 64 output pixels and 32 output channels. For each
//     tap, 64 threads form the sample points and corner weights (times the
//     mask) into shared memory; the block gathers the four corners'
//     channel-contiguous vectors (a warp reads 32 consecutive channels of one
//     corner: coalesced) into a shared val[64][32] slab, stages W_k's slab
//     (32 x 32) beside it, and each thread accumulates a 4-pixel x 4-channel
//     register tile. C is walked in slabs of 32, so any C fits.
//   * backward, data: a block owns 64 pixels and all taps. For each tap and
//     slab of 32 input channels it forms dval (4 x 4 register tiles over
//     Cout slabs of g and W_k^T in shared memory), then per (pixel, channel)
//     regathers the corners, writes the terms of dmask and doffset into shared
//     rows that one thread a pixel sums in a fixed order, and adds its share
//     into an fp32 dx with atomicAdd (a corner has no fixed owner: offsets
//     are unbounded, so dx may differ in its last bits from run to run).
//   * backward, weights: blocks of one launch each take one tap, one slab of
//     32 input and 32 output channels and a strided share of the 64-pixel
//     tiles, regather the masked samples, and write per-block partial sums of
//     dW; a second launch adds the partials in a fixed order, so dW is the
//     same bits on every run.
//
// fp32 and bf16 in and out (every operand in one type), fp32 arithmetic
// inside. Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int KK = 9;           // taps of the 3x3 kernel
constexpr int P = 64;           // output pixels a block
constexpr int KC = 32;          // input channels a slab
constexpr int CO = 32;          // output channels a block (forward) or a slab
constexpr int THREADS = 128;    // 16 pixel groups x 8 channel groups of 4 x 4
constexpr int RED_THREADS = 256;
static_assert(KC == CO, "the data gradient reuses the g slab's rows for its terms");
static_assert(THREADS == (P / 4) * (CO / 4), "one 4 x 4 register tile a thread");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

// Tap k of pixel pix: the flat pixel indices of the four corners (-1 where a
// corner lies outside the frame) in the order (0,0), (0,1), (1,0), (1,1), and
// the fractional parts and the mask. A pixel beyond npix gets no corner.
template <typename T>
__device__ __forceinline__ void tap_geometry(const T* offset, const T* mask, int pix, int npix, int H, int W, int k,
                                             int* idx, float* wy, float* wx, float* m) {
  if (pix >= npix) {
    idx[0] = idx[1] = idx[2] = idx[3] = -1;
    *wy = *wx = *m = 0.f;
    return;
  }
  const int hw = H * W;
  const int n = pix / hw, r = pix - n * hw;
  const int h = r / W, w = r - (r / W) * W;
  const float py = (float)(h + k / 3 - 1) + to_f(offset[(size_t)pix * (2 * KK) + 2 * k]);
  const float px = (float)(w + k % 3 - 1) + to_f(offset[(size_t)pix * (2 * KK) + 2 * k + 1]);
  const float y0 = floorf(py), x0 = floorf(px);
  *wy = py - y0;
  *wx = px - x0;
  *m = to_f(mask[(size_t)pix * KK + k]);
  for (int s = 0; s < 4; ++s) {
    const float yy = y0 + (float)(s >> 1), xx = x0 + (float)(s & 1);
    // compared as floats: an offset far outside never reaches an int conversion
    const bool inside = yy >= 0.f && yy <= (float)(H - 1) && xx >= 0.f && xx <= (float)(W - 1);
    idx[s] = inside ? n * hw + (int)yy * W + (int)xx : -1;
  }
}

// The bilinear weight of corner s.
__device__ __forceinline__ float corner_weight(int s, float wy, float wx) {
  return ((s >> 1) ? wy : 1.f - wy) * ((s & 1) ? wx : 1.f - wx);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) deform_forward_kernel(const T* x, const T* offset, const T* mask, const T* weight, T* out,
                                                                 int npix, int H, int W, int C, int Cout) {
  __shared__ float val[P][KC + 1];                // masked samples of a channel slab (+1: no bank conflicts)
  __shared__ __align__(16) float ws[KC][CO];      // W_k's slab
  __shared__ int cidx[P][4];
  __shared__ float cw[P][4];                      // corner weight x mask
  const int tid = threadIdx.x;
  const int p_base = blockIdx.x * P;
  const int co_base = blockIdx.y * CO;
  const int tx = tid % (CO / 4), ty = tid / (CO / 4);   // channels co_base + 4tx.., pixels 4ty..
  float acc[4][4];
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int k = 0; k < KK; ++k) {
    // the last slab's products read val and ws only: these rows are free
    if (tid < P) {
      int idx[4];
      float wy, wx, m;
      tap_geometry(offset, mask, p_base + tid, npix, H, W, k, idx, &wy, &wx, &m);
      for (int s = 0; s < 4; ++s) {
        cidx[tid][s] = idx[s];
        cw[tid][s] = m * corner_weight(s, wy, wx);
      }
    }
    for (int c0 = 0; c0 < C; c0 += KC) {
      __syncthreads();  // the geometry is written; the previous products are done with val and ws
      for (int e = tid; e < KC * CO; e += THREADS) {
        const int c = e / CO, co = e % CO;
        ws[c][co] = (c0 + c < C && co_base + co < Cout)
                        ? to_f(weight[((size_t)k * C + c0 + c) * Cout + co_base + co]) : 0.f;
      }
      {
        const int c = tid % KC;
        for (int p = tid / KC; p < P; p += THREADS / KC) {
          float v = 0.f;
          if (c0 + c < C)
            for (int s = 0; s < 4; ++s)
              if (cidx[p][s] >= 0) v += cw[p][s] * to_f(x[(size_t)cidx[p][s] * C + c0 + c]);
          val[p][c] = v;
        }
      }
      __syncthreads();
      for (int c = 0; c < KC; ++c) {
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[c][4 * tx]);
        for (int a = 0; a < 4; ++a) {
          const float v = val[4 * ty + a][c];
          acc[a][0] += v * w4.x;
          acc[a][1] += v * w4.y;
          acc[a][2] += v * w4.z;
          acc[a][3] += v * w4.w;
        }
      }
    }
  }
  for (int a = 0; a < 4; ++a) {
    const int pix = p_base + 4 * ty + a;
    if (pix >= npix) continue;
    for (int b = 0; b < 4; ++b) {
      const int co = co_base + 4 * tx + b;
      if (co < Cout) from_f(acc[a][b], out + (size_t)pix * Cout + co);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) deform_data_grad_kernel(const T* x, const T* offset, const T* mask, const T* weight, const T* g,
                                                                   float* dx, T* doffset, T* dmask, int npix, int H, int W, int C, int Cout) {
  __shared__ float dv[P][KC + 1];                 // dval of a channel slab; then the dmask terms
  __shared__ float gs[P][CO + 1];                 // g's slab; then the d/dwy terms
  __shared__ float rx[P][KC + 1];                 // the d/dwx terms
  __shared__ __align__(16) float wt[CO][KC];      // W_k's slab, transposed
  __shared__ int cidx[P][4];
  __shared__ float geo[P][3];                     // wy, wx, mask
  __shared__ float sum_m[P], sum_y[P], sum_x[P];
  const int tid = threadIdx.x;
  const int p_base = blockIdx.x * P;
  const int tx = tid % (KC / 4), ty = tid / (KC / 4);   // channels 4tx.. of the slab, pixels 4ty..
  for (int k = 0; k < KK; ++k) {
    // the previous tap's last rows were summed by these same threads, behind a barrier
    if (tid < P) {
      int idx[4];
      float wy, wx, m;
      tap_geometry(offset, mask, p_base + tid, npix, H, W, k, idx, &wy, &wx, &m);
      for (int s = 0; s < 4; ++s) cidx[tid][s] = idx[s];
      geo[tid][0] = wy;
      geo[tid][1] = wx;
      geo[tid][2] = m;
      sum_m[tid] = sum_y[tid] = sum_x[tid] = 0.f;
    }
    for (int c0 = 0; c0 < C; c0 += KC) {
      float d[4][4];
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) d[a][b] = 0.f;
      for (int q0 = 0; q0 < Cout; q0 += CO) {
        __syncthreads();  // gs, wt (and the last slab's rows) are free
        for (int e = tid; e < P * CO; e += THREADS) {
          const int p = e / CO, q = e % CO;
          gs[p][q] = (p_base + p < npix && q0 + q < Cout) ? to_f(g[(size_t)(p_base + p) * Cout + q0 + q]) : 0.f;
        }
        for (int e = tid; e < KC * CO; e += THREADS) {
          const int c = e / CO, q = e % CO;
          wt[q][c] = (c0 + c < C && q0 + q < Cout) ? to_f(weight[((size_t)k * C + c0 + c) * Cout + q0 + q]) : 0.f;
        }
        __syncthreads();
        for (int q = 0; q < CO; ++q) {
          const float4 w4 = *reinterpret_cast<const float4*>(&wt[q][4 * tx]);
          for (int a = 0; a < 4; ++a) {
            const float gv = gs[4 * ty + a][q];
            d[a][0] += gv * w4.x;
            d[a][1] += gv * w4.y;
            d[a][2] += gv * w4.z;
            d[a][3] += gv * w4.w;
          }
        }
      }
      __syncthreads();  // every thread is done reading gs
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) dv[4 * ty + a][4 * tx + b] = d[a][b];
      __syncthreads();
      {
        const int c = tid % KC;
        for (int p = tid / KC; p < P; p += THREADS / KC) {
          float tm = 0.f, t_y = 0.f, t_x = 0.f;
          if (c0 + c < C) {
            const float dval = dv[p][c];
            const float wy = geo[p][0], wx = geo[p][1], m = geo[p][2];
            float v[4];
            for (int s = 0; s < 4; ++s) v[s] = cidx[p][s] >= 0 ? to_f(x[(size_t)cidx[p][s] * C + c0 + c]) : 0.f;
            const float bil = (1.f - wy) * ((1.f - wx) * v[0] + wx * v[1]) + wy * ((1.f - wx) * v[2] + wx * v[3]);
            tm = dval * bil;
            t_y = m * dval * ((1.f - wx) * (v[2] - v[0]) + wx * (v[3] - v[1]));
            t_x = m * dval * ((1.f - wy) * (v[1] - v[0]) + wy * (v[3] - v[2]));
            const float md = m * dval;
            for (int s = 0; s < 4; ++s)
              if (cidx[p][s] >= 0) atomicAdd(dx + (size_t)cidx[p][s] * C + c0 + c, md * corner_weight(s, wy, wx));
          }
          // this thread alone reads and writes row p, column c of these three
          dv[p][c] = tm;
          gs[p][c] = t_y;
          rx[p][c] = t_x;
        }
      }
      __syncthreads();
      if (tid < P) {  // in a fixed order, one thread a pixel
        float sm = 0.f, sy = 0.f, sx = 0.f;
        for (int c = 0; c < KC; ++c) {
          sm += dv[tid][c];
          sy += gs[tid][c];
          sx += rx[tid][c];
        }
        sum_m[tid] += sm;
        sum_y[tid] += sy;
        sum_x[tid] += sx;
      }
    }
    if (tid < P && p_base + tid < npix) {
      const size_t pix = (size_t)(p_base + tid);
      from_f(sum_m[tid], dmask + pix * KK + k);
      from_f(sum_y[tid], doffset + pix * (2 * KK) + 2 * k);
      from_f(sum_x[tid], doffset + pix * (2 * KK) + 2 * k + 1);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) deform_weight_grad_kernel(const T* x, const T* offset, const T* mask, const T* g, float* partial,
                                                                     int npix, int H, int W, int C, int Cout, int c_slabs, int co_slabs) {
  __shared__ __align__(16) float sv[P][KC + 4];   // masked samples (rows of 16-byte multiples)
  __shared__ __align__(16) float gs[P][CO + 2];   // g's slab (rows of 8-byte multiples)
  __shared__ int cidx[P][4];
  __shared__ float cw[P][4];
  const int tid = threadIdx.x;
  int y = blockIdx.y;
  const int k = y / (c_slabs * co_slabs);
  y -= k * c_slabs * co_slabs;
  const int c0 = (y / co_slabs) * KC, q0 = (y % co_slabs) * CO;
  const int tx = tid % (KC / 4), ty = tid / (KC / 4);   // input channels 4tx.., output channels 2ty, 2ty+1
  float acc[4][2];
  for (int b = 0; b < 4; ++b) acc[b][0] = acc[b][1] = 0.f;
  const int tiles = (npix + P - 1) / P;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p_base = t * P;
    // the previous tile's gather is behind a barrier; its products read sv and gs only
    if (tid < P) {
      int idx[4];
      float wy, wx, m;
      tap_geometry(offset, mask, p_base + tid, npix, H, W, k, idx, &wy, &wx, &m);
      for (int s = 0; s < 4; ++s) {
        cidx[tid][s] = idx[s];
        cw[tid][s] = m * corner_weight(s, wy, wx);
      }
    }
    __syncthreads();  // the geometry is written; the previous products are done with sv and gs
    {
      const int c = tid % KC;
      for (int p = tid / KC; p < P; p += THREADS / KC) {
        float v = 0.f;
        if (c0 + c < C)
          for (int s = 0; s < 4; ++s)
            if (cidx[p][s] >= 0) v += cw[p][s] * to_f(x[(size_t)cidx[p][s] * C + c0 + c]);
        sv[p][c] = v;
      }
    }
    for (int e = tid; e < P * CO; e += THREADS) {
      const int p = e / CO, q = e % CO;
      gs[p][q] = (p_base + p < npix && q0 + q < Cout) ? to_f(g[(size_t)(p_base + p) * Cout + q0 + q]) : 0.f;
    }
    __syncthreads();
    for (int p = 0; p < P; ++p) {
      const float4 s4 = *reinterpret_cast<const float4*>(&sv[p][4 * tx]);
      const float2 g2 = *reinterpret_cast<const float2*>(&gs[p][2 * ty]);
      acc[0][0] += s4.x * g2.x;
      acc[0][1] += s4.x * g2.y;
      acc[1][0] += s4.y * g2.x;
      acc[1][1] += s4.y * g2.y;
      acc[2][0] += s4.z * g2.x;
      acc[2][1] += s4.z * g2.y;
      acc[3][0] += s4.w * g2.x;
      acc[3][1] += s4.w * g2.y;
    }
  }
  const size_t n_w = (size_t)KK * C * Cout;
  for (int b = 0; b < 4; ++b)
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 4 * tx + b, q = q0 + 2 * ty + e;
      if (c < C && q < Cout) partial[blockIdx.x * n_w + ((size_t)k * C + c) * Cout + q] = acc[b][e];
    }
}

// dW[e] = the partials of every block group added in group order.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS) reduce_partials_kernel(const float* partial, int groups, int n, T* dw) {
  const int e = blockIdx.x * RED_THREADS + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int gi = 0; gi < groups; ++gi) s += partial[(size_t)gi * n + e];
  from_f(s, dw + e);
}

template <typename T>
int forward(const void* x, const void* offset, const void* mask, const void* weight, void* out, int npix, int H, int W, int C, int Cout,
            cudaStream_t stream) {
  const dim3 grid((npix + P - 1) / P, (Cout + CO - 1) / CO);
  deform_forward_kernel<T><<<grid, THREADS, 0, stream>>>((const T*)x, (const T*)offset, (const T*)mask, (const T*)weight, (T*)out,
                                                         npix, H, W, C, Cout);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* x, const void* offset, const void* mask, const void* weight, const void* g, void* dx, void* doffset, void* dmask,
             void* dweight, void* partial, int groups, int npix, int H, int W, int C, int Cout, cudaStream_t stream) {
  deform_data_grad_kernel<T><<<(npix + P - 1) / P, THREADS, 0, stream>>>((const T*)x, (const T*)offset, (const T*)mask, (const T*)weight,
                                                                         (const T*)g, (float*)dx, (T*)doffset, (T*)dmask, npix, H, W, C, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int c_slabs = (C + KC - 1) / KC, co_slabs = (Cout + CO - 1) / CO;
  deform_weight_grad_kernel<T><<<dim3(groups, KK * c_slabs * co_slabs), THREADS, 0, stream>>>(
      (const T*)x, (const T*)offset, (const T*)mask, (const T*)g, (float*)partial, npix, H, W, C, Cout, c_slabs, co_slabs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_w = KK * C * Cout;
  reduce_partials_kernel<T><<<(n_w + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0, stream>>>((const float*)partial, groups, n_w, (T*)dweight);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of every tensor argument but
// dx and partial (float32). Shapes: x (N,H,W,C), offset (N,H,W,18), mask
// (N,H,W,9), weight (3,3,C,Cout), out and g (N,H,W,Cout).
extern "C" int selfc_deform_forward(const void* x, const void* offset, const void* mask, const void* weight, void* out, int N, int H, int W,
                                    int C, int Cout, int dtype, void* stream) {
  const int npix = N * H * W;
  if (npix < 1 || C < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return forward<float>(x, offset, mask, weight, out, npix, H, W, C, Cout, s);
  if (dtype == 1) return forward<__nv_bfloat16>(x, offset, mask, weight, out, npix, H, W, C, Cout, s);
  return (int)cudaErrorInvalidValue;
}

// dx: zeroed by the caller, the gradient added into it (float32); doffset,
// dmask, dweight: written; partial: scratch of groups * 9 * C * Cout floats.
extern "C" int selfc_deform_backward(const void* x, const void* offset, const void* mask, const void* weight, const void* g, void* dx,
                                     void* doffset, void* dmask, void* dweight, void* partial, int groups, int N, int H, int W, int C,
                                     int Cout, int dtype, void* stream) {
  const int npix = N * H * W;
  if (npix < 1 || C < 1 || Cout < 1 || groups < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return backward<float>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, partial, groups, npix, H, W, C, Cout, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, offset, mask, weight, g, dx, doffset, dmask, dweight, partial, groups, npix, H, W, C, Cout, s);
  return (int)cudaErrorInvalidValue;
}

// Output pixels a block of every kernel here takes (the weight gradient's
// block groups walk tiles of this many).
extern "C" int selfc_deform_pixels_per_block() { return P; }

extern "C" const char* selfc_deform_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
