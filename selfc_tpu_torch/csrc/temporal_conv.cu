// The standalone (3,1,1) temporal convolution for Hopper (sm_90a), with its
// bias and an optional LeakyReLU fused into the epilogue.
//
// Replaces selfc_tpu/ops/pallas_kernels.py:_kernel (reached there through
// _tc3_impl and temporal_conv3_pallas). The function, channels-last, zero
// padding in T:
//
//   out[b][t][s][n] = act( bias[n] + sum_{k=0..2} sum_c x[b][t+k-1][s][c] * w[k][c][n] )
//
// x (B,T,S,C) with S = H*W, w (3,C,Co) read as one (3C, Co) matrix, bias (Co)
// or none, out (B,T,S,Co); act is LeakyReLU(negative_slope) or the identity.
// As a product: M = B*T*S rows, N = Co, K = 3C, where row (b,t,s) reads the
// rows (b,t-1,s), (b,t,s), (b,t+1,s) of x, i.e. the row r - S, r, r + S, and
// zero where t-1 or t+1 leaves [0,T). The data gradient is this function
// again: dx = temporal_conv3(dy, [w2^T, w1^T, w0^T]) with no bias (the wrapper
// passes the flipped, transposed weights).
//
// What bounds it: arithmetic at the widths the nets give it (C 131..1152,
// Co 3..768: 2 * 3C * Co operations a row against (C + Co) * 4 bytes), bytes
// only at Co = 3.
//
// Design, right and simple first (plain fp32 FMAs, no tensor cores, no TF32):
// a block owns a 64-row x 64-column tile of the output. K is walked tap by tap
// and, within a tap, in slabs of 16 input channels: the block stages the
// slab's 64 x 16 activations (transposed, rows contiguous; a row whose
// neighbour frame lies outside the clip stages zeros) and the 16 x 64 weights
// in shared memory, and each of 256 threads accumulates a 4-row x 4-column
// register tile. The ragged edges (rows past M, channels past C, columns past
// Co) stage zeros and store nothing, so every B, T, S, C and Co is taken.
// At Co = 3 a 64-column tile leaves 95 % of its FMAs idle; a narrow tile is
// later work, as are wgmma and TMA.
//
// The epilogue adds the bias and applies the LeakyReLU on the fp32
// accumulator; with a non-null mask it also writes mask = (acc >= 0), which
// the backward needs at a slope <= 0 (the output cannot tell it there).
//
// fp32 and bf16 in and out (x, w, bias and out in one type), fp32 arithmetic
// inside. Plain C interface (loaded with ctypes); the caller owns every buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // output rows a block
constexpr int BN = 64;         // output columns a block
constexpr int BK = 16;         // input channels a slab
constexpr int THREADS = 256;   // 16 x 16 threads, a 4 x 4 register tile each
static_assert(THREADS == (BM / 4) * (BN / 4), "one 4 x 4 register tile a thread");
static_assert(BM * BK == 4 * THREADS && BK * BN == 4 * THREADS, "four staged values a thread and operand");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    temporal_conv3_kernel(const T* x, const T* w, const T* bias, T* out, uint8_t* mask, long long M, int T_len, int S, int C,
                          int Co, int act, float slope) {
  __shared__ __align__(16) float xs[BK][BM];   // activations, [channel][row]
  __shared__ __align__(16) float ws[BK][BN];   // weights, [channel][column]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;      // register tile: rows 4ty.., columns 4tx..
  const long long row0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the row this thread stages, and the four channels of the slab it takes
  const int lr = tid / 4, lc = 4 * (tid % 4);
  const long long r = row0 + lr;
  const bool row_ok = r < M;
  const int t = row_ok ? (int)((r / S) % T_len) : 0;
  // the weight row and four columns this thread stages
  const int wk = tid / 16, wn = 4 * (tid % 16);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < 3; ++k) {
    const int tt = t + k - 1;
    const bool src_ok = row_ok && tt >= 0 && tt < T_len;
    const T* xrow = x + (src_ok ? (r + (long long)(k - 1) * S) * C : 0);
    const T* wtap = w + (size_t)k * C * Co;
    for (int c0 = 0; c0 < C; c0 += BK) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + lc + e;
        xs[lc + e][lr] = (src_ok && c < C) ? to_f(xrow[c]) : 0.f;
      }
      {
        const int c = c0 + wk;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + wn + e;
          ws[wk][wn + e] = (c < C && n < Co) ? to_f(wtap[(size_t)c * Co + n]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
        const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bw[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 4 * tx + j;
    if (n >= Co) continue;
    const float bn = bias ? to_f(bias[n]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long ro = row0 + 4 * ty + i;
      if (ro >= M) continue;
      float v = acc[i][j] + bn;
      const size_t o = (size_t)ro * Co + n;
      if (mask) mask[o] = v >= 0.f ? 1 : 0;
      if (act && !(v >= 0.f)) v *= slope;
      from_f(v, out + o);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, void* mask, long long M, int T_len, int S, int C, int Co, int act,
           float slope, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  temporal_conv3_kernel<T><<<grid, THREADS, 0, stream>>>((const T*)x, (const T*)w, (const T*)bias, (T*)out, (uint8_t*)mask, M, T_len, S,
                                                         C, Co, act, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of x, w, bias and out. Shapes:
// x (B,T,S,C), w (3,C,Co), bias (Co) or null, out (B,T,S,Co), mask (B,T,S,Co)
// bytes or null. act: 0 = none, 1 = LeakyReLU with negative slope ``slope``.
extern "C" int selfc_temporal_conv3(const void* x, const void* w, const void* bias, void* out, void* mask, int B, int T, int S, int C,
                                    int Co, int act, float slope, int dtype, void* stream) {
  const long long M = (long long)B * T * S;
  if (M < 1 || T < 1 || S < 1 || C < 1 || Co < 1 || (M + BM - 1) / BM > 0x7fffffffLL || (Co + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, bias, out, mask, M, T, S, C, Co, act, slope, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, bias, out, mask, M, T, S, C, Co, act, slope, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* selfc_temporal_conv3_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
