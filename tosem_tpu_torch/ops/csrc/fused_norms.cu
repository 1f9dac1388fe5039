// Fused layernorm and row softmax, forward and backward, for Hopper
// (sm_90a), plain C interface.
//
// Replaces: tosem_tpu/ops/fused_norms.py `_ln_fwd_kernel` (B6),
// `_ln_bwd_kernel` (B7), `_sm_fwd_kernel` (B8) and `_sm_bwd_kernel` (B9),
// the Pallas kernels behind `fused_layernorm` and `fused_softmax`.
//
// What bounds it on this card, each of the four: bytes. It reads rows and
// writes one row per row read, with a few fp32 operations per element
// (under 12), far below the H100's ~20 fp32 operations per byte of
// device memory. At the kernel suite's bf16 shapes the least times are
// about 3.8 us (B6, [4096, 768]), 5.6 us (B7), 30 us (B8, [49152, 512])
// and 45 us (B9).
//
// What the design does about it, in this first version: one block per
// row (B6, B8, B9), 32 to 256 threads by row length, neighbouring threads
// on neighbouring elements so every load is coalesced; statistics in
// fp32 registers, reduced across the block by warp shuffles and a
// 32-float shared array. A row is read again for each pass rather than
// held in registers, so any row length runs (a row streams through L1
// and L2; at the suite's widths a row is 1-1.5 KB). Vector loads, rows
// held in registers and several rows a block are later work.
//
// Numerics follow the Pallas kernels: x is read in its dtype and
// widened to fp32; layernorm takes the mean first and then the mean of
// squared deviations (two passes, so shifted rows keep their digits),
// rstd = rsqrt(var + eps), and the affine runs in fp32 before the cast;
// softmax subtracts the row max, and its backward reads the saved y in
// the output dtype.
//
// B7's dgamma/dbeta: the TPU kernel adds each row block's sums into one
// output in grid order. Blocks here run in no order, so each block of
// `rows_per_block` rows writes its fp32 sums to its own row of a
// [n_parts, D] scratch, and a second kernel adds those rows in a fixed
// order: partial p goes to warp p % 8, each warp adds its partials in
// ascending p, and the eight warp sums are added in warp order. No
// atomics: two launches agree bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int RED_COLS = 32;  // columns per block of the dgamma/dbeta sum
constexpr int RED_WAYS = 8;   // warps per block of that sum

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A butterfly leaves the same bits on every lane: each step adds the
// same two values on both lanes of a pair, and fp32 addition commutes.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or max) over the block of one value per thread; blockDim.x is a
// multiple of 32. Every thread returns the same value: the warp totals
// go through `red` (32 floats) and each thread combines them in warp
// order. The leading barrier lets a call reuse `red` right after
// another call has read it.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < n_warps; ++w) t = MAX ? fmaxf(t, red[w]) : t + red[w];
  return t;
}

// ---------------------------------------------------------------- B6

template <typename T, typename G>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const G* __restrict__ gamma,
                              const G* __restrict__ beta, T* __restrict__ y,
                              float* __restrict__ mu_out,
                              float* __restrict__ rstd_out, int D,
                              float eps) {
  __shared__ float red[32];
  const long long off = (long long)blockIdx.x * D;
  const T* xr = x + off;
  T* yr = y + off;
  float s = 0.f;
  for (int j = threadIdx.x; j < D; j += blockDim.x) s += to_f(xr[j]);
  const float mu = block_reduce<false>(s, red) / (float)D;
  float ss = 0.f;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const float c = to_f(xr[j]) - mu;
    ss = fmaf(c, c, ss);
  }
  const float var = block_reduce<false>(ss, red) / (float)D;
  const float rstd = rsqrtf(var + eps);
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const float xh = (to_f(xr[j]) - mu) * rstd;
    yr[j] = from_f<T>(xh * to_f(gamma[j]) + to_f(beta[j]));
  }
  if (threadIdx.x == 0) {
    mu_out[blockIdx.x] = mu;
    rstd_out[blockIdx.x] = rstd;
  }
}

// ---------------------------------------------------------------- B7

// One block per `rows_per_block` rows: dx row by row, and this block's
// dgamma/dbeta sums in shared memory, column j kept by thread
// j % blockDim.x alone (no barrier needed between rows), then written to
// the block's row of the partials. Rows at or past R are never read.
template <typename T, typename G>
__global__ void ln_bwd_kernel(const T* __restrict__ x,
                              const G* __restrict__ gamma,
                              const float* __restrict__ mu,
                              const float* __restrict__ rstd,
                              const T* __restrict__ dy, T* __restrict__ dx,
                              float* __restrict__ dg_part,
                              float* __restrict__ db_part, int R, int D,
                              int rows_per_block) {
  extern __shared__ float acc[];  // [2 * D]: dgamma sums, then dbeta sums
  __shared__ float red[32];
  float* ag = acc;
  float* ab = acc + D;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    ag[j] = 0.f;
    ab[j] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, R);
  for (int r = r0; r < r1; ++r) {
    const long long off = (long long)r * D;
    const float m = mu[r];
    const float rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      const float xh = (to_f(x[off + j]) - m) * rs;
      const float w = to_f(dy[off + j]) * to_f(gamma[j]);
      s1 += w;
      s2 = fmaf(w, xh, s2);
    }
    const float c1 = block_reduce<false>(s1, red) / (float)D;
    const float c2 = block_reduce<false>(s2, red) / (float)D;
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      const float xh = (to_f(x[off + j]) - m) * rs;
      const float d = to_f(dy[off + j]);
      const float w = d * to_f(gamma[j]);
      dx[off + j] = from_f<T>((w - c1 - xh * c2) * rs);
      ag[j] = fmaf(d, xh, ag[j]);
      ab[j] += d;
    }
  }
  float* pg = dg_part + (long long)blockIdx.x * D;
  float* pb = db_part + (long long)blockIdx.x * D;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    pg[j] = ag[j];
    pb[j] = ab[j];
  }
}

// The fixed-order sum of the partials: block (RED_COLS, RED_WAYS)
// threads over RED_COLS columns; warp w adds partials w, w + RED_WAYS,
// ... in order, then warp 0 adds the warp sums in warp order and casts.
template <typename G>
__global__ void __launch_bounds__(RED_COLS * RED_WAYS)
ln_bwd_reduce_kernel(const float* __restrict__ dg_part,
                     const float* __restrict__ db_part, G* __restrict__ dg,
                     G* __restrict__ db, int n_parts, int D) {
  __shared__ float sg[RED_WAYS][RED_COLS];
  __shared__ float sb[RED_WAYS][RED_COLS];
  const int c = threadIdx.x;
  const int w = threadIdx.y;
  const int j = blockIdx.x * RED_COLS + c;
  float a = 0.f, b = 0.f;
  if (j < D) {
    for (int p = w; p < n_parts; p += RED_WAYS) {
      a += dg_part[(long long)p * D + j];
      b += db_part[(long long)p * D + j];
    }
  }
  sg[w][c] = a;
  sb[w][c] = b;
  __syncthreads();
  if (w == 0 && j < D) {
    float ta = sg[0][c], tb = sb[0][c];
    for (int k = 1; k < RED_WAYS; ++k) {
      ta += sg[k][c];
      tb += sb[k][c];
    }
    dg[j] = from_f<G>(ta);
    db[j] = from_f<G>(tb);
  }
}

// ---------------------------------------------------------------- B8, B9

template <typename T>
__global__ void sm_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                              int N) {
  __shared__ float red[32];
  const long long off = (long long)blockIdx.x * N;
  const T* xr = x + off;
  T* yr = y + off;
  float m = -CUDART_INF_F;
  for (int j = threadIdx.x; j < N; j += blockDim.x) m = fmaxf(m, to_f(xr[j]));
  m = block_reduce<true>(m, red);
  float s = 0.f;
  for (int j = threadIdx.x; j < N; j += blockDim.x) s += expf(to_f(xr[j]) - m);
  s = block_reduce<false>(s, red);
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    yr[j] = from_f<T>(expf(to_f(xr[j]) - m) / s);
}

template <typename T>
__global__ void sm_bwd_kernel(const T* __restrict__ y,
                              const T* __restrict__ dy, T* __restrict__ dx,
                              int N) {
  __shared__ float red[32];
  const long long off = (long long)blockIdx.x * N;
  float s = 0.f;
  for (int j = threadIdx.x; j < N; j += blockDim.x)
    s = fmaf(to_f(y[off + j]), to_f(dy[off + j]), s);
  const float inner = block_reduce<false>(s, red);
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float yv = to_f(y[off + j]);
    dx[off + j] = from_f<T>(yv * (to_f(dy[off + j]) - inner));
  }
}

// ---------------------------------------------------------------- launch

// threads for a row of n elements: one warp per 128 elements, 1 to 8 warps
int row_threads(int n) {
  int warps = (n + 127) / 128;
  if (warps < 1) warps = 1;
  if (warps > 8) warps = 8;
  return 32 * warps;
}

template <typename T, typename G>
int launch_ln_fwd(const void* x, const void* gamma, const void* beta,
                  void* y, void* mu, void* rstd, int R, int D, float eps,
                  cudaStream_t stream) {
  ln_fwd_kernel<T, G><<<R, row_threads(D), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma),
      static_cast<const G*>(beta), static_cast<T*>(y),
      static_cast<float*>(mu), static_cast<float*>(rstd), D, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename G>
int launch_ln_bwd(const void* x, const void* gamma, const void* mu,
                  const void* rstd, const void* dy, void* dx, void* dg_part,
                  void* db_part, void* dg, void* db, int R, int D,
                  int rows_per_block, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)D * sizeof(float);
  auto kern = ln_bwd_kernel<T, G>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_parts = (R + rows_per_block - 1) / rows_per_block;
  kern<<<n_parts, row_threads(D), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dg_part), static_cast<float*>(db_part), R, D,
      rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 block(RED_COLS, RED_WAYS);
  ln_bwd_reduce_kernel<G><<<(D + RED_COLS - 1) / RED_COLS, block, 0,
                            stream>>>(
      static_cast<const float*>(dg_part), static_cast<const float*>(db_part),
      static_cast<G*>(dg), static_cast<G*>(db), n_parts, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype / gdtype: 0 = float32, 1 = bfloat16, of x (and y, dy, dx) and of
// gamma/beta (and dgamma, dbeta). Every array is contiguous: x, y, dy,
// dx are [R, D] (softmax: [R, N]); mu and rstd are [R] float32. Each
// function launches on `stream` and returns cudaGetLastError().

extern "C" int ln_fwd(int dtype, int gdtype, const void* x, const void* gamma,
                      const void* beta, void* y, void* mu, void* rstd, int R,
                      int D, float eps, void* stream) {
  if (R <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gdtype == 0)
    return launch_ln_fwd<float, float>(x, gamma, beta, y, mu, rstd, R, D, eps,
                                       st);
  if (dtype == 0 && gdtype == 1)
    return launch_ln_fwd<float, __nv_bfloat16>(x, gamma, beta, y, mu, rstd, R,
                                               D, eps, st);
  if (dtype == 1 && gdtype == 0)
    return launch_ln_fwd<__nv_bfloat16, float>(x, gamma, beta, y, mu, rstd, R,
                                               D, eps, st);
  if (dtype == 1 && gdtype == 1)
    return launch_ln_fwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mu,
                                                       rstd, R, D, eps, st);
  return (int)cudaErrorInvalidValue;
}

// dg_part and db_part are [ceil(R / rows_per_block), D] float32 scratch;
// dg and db are [D] in gamma's dtype.
extern "C" int ln_bwd(int dtype, int gdtype, const void* x, const void* gamma,
                      const void* mu, const void* rstd, const void* dy,
                      void* dx, void* dg_part, void* db_part, void* dg,
                      void* db, int R, int D, int rows_per_block,
                      void* stream) {
  if (R <= 0 || D <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gdtype == 0)
    return launch_ln_bwd<float, float>(x, gamma, mu, rstd, dy, dx, dg_part,
                                       db_part, dg, db, R, D, rows_per_block,
                                       st);
  if (dtype == 0 && gdtype == 1)
    return launch_ln_bwd<float, __nv_bfloat16>(x, gamma, mu, rstd, dy, dx,
                                               dg_part, db_part, dg, db, R, D,
                                               rows_per_block, st);
  if (dtype == 1 && gdtype == 0)
    return launch_ln_bwd<__nv_bfloat16, float>(x, gamma, mu, rstd, dy, dx,
                                               dg_part, db_part, dg, db, R, D,
                                               rows_per_block, st);
  if (dtype == 1 && gdtype == 1)
    return launch_ln_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, gamma, mu, rstd, dy, dx, dg_part, db_part, dg, db, R, D,
        rows_per_block, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sm_fwd(int dtype, const void* x, void* y, int R, int N,
                      void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    sm_fwd_kernel<float><<<R, row_threads(N), 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), N);
  else if (dtype == 1)
    sm_fwd_kernel<__nv_bfloat16><<<R, row_threads(N), 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        N);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int sm_bwd(int dtype, const void* y, const void* dy, void* dx,
                      int R, int N, void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    sm_bwd_kernel<float><<<R, row_threads(N), 0, st>>>(
        static_cast<const float*>(y), static_cast<const float*>(dy),
        static_cast<float*>(dx), N);
  else if (dtype == 1)
    sm_bwd_kernel<__nv_bfloat16><<<R, row_threads(N), 0, st>>>(
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), N);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
