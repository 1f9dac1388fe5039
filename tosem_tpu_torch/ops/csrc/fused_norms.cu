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
// What the design does about it. B6, B7 and B8 have two bodies each,
// chosen before launch by shape, dtype and alignment (fused_norms.py
// `_row_body`), never after a failure:
// - the warp-row body, for rows of whole 16-byte vectors, at most 32
//   elements a lane (1024 a row), with every operand 16-byte aligned:
//   one warp per row and the row held in registers. Each lane loads its
//   V vectors once, all before it uses any, and widens them to fp32; row
//   statistics are warp butterflies, with no shared memory and no
//   barrier; outputs go out as 16-byte stores. Blocks of ROW_WARPS warps
//   (B7: BWD_WARPS), no more than the card holds at once: each warp
//   walks rows by grid stride and loads its next row before it reduces
//   the current one. B6 loads gamma and beta into registers once per
//   warp. B8 computes exp(x - max) once per element, keeps it in
//   registers for the sum and the write, and multiplies by one
//   reciprocal of the row sum. B7 holds x, dy and gamma in registers,
//   and each lane keeps the dgamma/dbeta sums of its own columns over
//   the rows its warp walks; at the end the block's warps add those in
//   shared memory by a fixed tree and the block writes one partial row.
// - the block body, for every other row (odd widths, wide rows, views
//   off 16 bytes): one block per row (B7: per row block), 32 to 256
//   threads by row length, neighbouring threads on neighbouring
//   elements; statistics reduced across the block by warp shuffles and
//   a 32-float shared array; the row read again for each pass, so any
//   length runs.
// B9 is a block body of the second kind.
//
// Numerics follow the Pallas kernels: x is read in its dtype and
// widened to fp32; layernorm takes the mean first and then the mean of
// squared deviations (two passes, so shifted rows keep their digits),
// rstd = rsqrt(var + eps), and the affine runs in fp32 before the cast;
// softmax subtracts the row max, and its backward reads the saved y in
// the output dtype.
//
// B7's dgamma/dbeta: the TPU kernel adds each row block's sums into one
// output in grid order. Blocks here run in no order, so each block
// writes its fp32 sums to its own row of a [n_parts, D] scratch (the
// block body: one partial per `rows_per_block` rows; the warp-row body:
// one per block of its grid), and a second kernel adds those rows in a
// fixed order: partial p goes to warp p % RED_WAYS, each warp adds its
// partials in ascending p, and the warp sums are added in warp order.
// No atomics: two launches agree bit for bit.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int RED_COLS = 32;  // columns per block of the dgamma/dbeta sum
constexpr int RED_WAYS = 16;  // warps per block of that sum

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

// ------------------------------------------------ warp-row bodies (B6, B8)

constexpr int ROW_WARPS = 4;       // warps a block, each on its own row
constexpr int ROW_MAX_ELEMS = 32;  // row elements a lane holds at most

// elements of T in one 16-byte vector, and the most vectors a lane holds
template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int max_vecs() {
  return ROW_MAX_ELEMS / vec_elems<T>();
}

// W elements of E as 32-bit words (W * sizeof(E) is 8, 16 or 32 bytes),
// read through the read-only path in 8- or 16-byte loads
template <typename E, int W>
struct Chunk {
  static constexpr int WORDS = W * (int)sizeof(E) / 4;
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const E* p) {
    if constexpr (WORDS == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < WORDS / 4; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = 0u;
  }
  // element i widened to fp32 (a bf16 is the top half of its fp32)
  __device__ __forceinline__ float operator[](int i) const {
    if constexpr (sizeof(E) == 4)
      return __uint_as_float(w[i]);
    else
      return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u
                                   : w[i >> 1] << 16);
  }
};

template <typename T> using Vec = Chunk<T, vec_elems<T>()>;

// one 16-byte vector of T from fp32 values, rounded to nearest even
template <typename T>
__device__ __forceinline__ void store_vec(T* p,
                                          const float (&v)[vec_elems<T>()]) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = reinterpret_cast<const uint32_t&>(h);
    }
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// the lane's V vectors of row r of x ([R, nvec] vectors): vector
// k * 32 + lane in c[k], zeros past the row's end or past R
template <typename T, int V>
__device__ __forceinline__ void load_row(Vec<T> (&c)[V], const T* x, int r,
                                         int R, int nvec, int lane) {
  const T* xr = x + (long long)r * nvec * vec_elems<T>();
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = k * 32 + lane;
    if (r < R && j < nvec)
      c[k].load(xr + j * vec_elems<T>());
    else
      c[k].zero();
  }
}

// The floor of one block an SM in __launch_bounds__ is there for ptxas:
// without it, ptxas spilled 4 to 12 bytes in some bodies to reach the
// next occupancy step (64, 72 or 80 registers).
template <typename T, typename G, int V>
__global__ void __launch_bounds__(ROW_WARPS * 32, 1)
ln_fwd_warp_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                   const G* __restrict__ beta, T* __restrict__ y,
                   float* __restrict__ mu_out, float* __restrict__ rstd_out,
                   int R, int D, float eps) {
  constexpr int W = vec_elems<T>();
  const int lane = threadIdx.x & 31;
  const int nvec = D / W;
  const int stride = gridDim.x * ROW_WARPS;
  int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  Chunk<G, W> g[V], b[V];  // this lane's columns, for all its rows
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = k * 32 + lane;
    if (j < nvec) {
      g[k].load(gamma + j * W);
      b[k].load(beta + j * W);
    }
  }
  Vec<T> cur[V], nxt[V];
  load_row<T, V>(cur, x, r, R, nvec, lane);
  for (; r < R; r += stride) {
    load_row<T, V>(nxt, x, r + stride, R, nvec, lane);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k * 32 + lane < nvec)
#pragma unroll
        for (int i = 0; i < W; ++i) s += cur[k][i];
    const float mu = warp_sum(s) / (float)D;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k * 32 + lane < nvec)
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const float c = cur[k][i] - mu;
          ss = fmaf(c, c, ss);
        }
    const float rstd = rsqrtf(warp_sum(ss) / (float)D + eps);
    T* yr = y + (long long)r * D;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = k * 32 + lane;
      if (j < nvec) {
        float o[W];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const float xh = (cur[k][i] - mu) * rstd;
          o[i] = xh * g[k][i] + b[k][i];
        }
        store_vec<T>(yr + j * W, o);
      }
    }
    if (lane == 0) {
      mu_out[r] = mu;
      rstd_out[r] = rstd;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) cur[k] = nxt[k];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(ROW_WARPS * 32, 1)
sm_fwd_warp_kernel(const T* __restrict__ x, T* __restrict__ y, int R,
                   int N) {
  constexpr int W = vec_elems<T>();
  const int lane = threadIdx.x & 31;
  const int nvec = N / W;
  const int stride = gridDim.x * ROW_WARPS;
  int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  Vec<T> cur[V], nxt[V];
  load_row<T, V>(cur, x, r, R, nvec, lane);
  for (; r < R; r += stride) {
    load_row<T, V>(nxt, x, r + stride, R, nvec, lane);
    float m = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k * 32 + lane < nvec)
#pragma unroll
        for (int i = 0; i < W; ++i) m = fmaxf(m, cur[k][i]);
    m = warp_max(m);
    float e[V][W];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k * 32 + lane < nvec)
#pragma unroll
        for (int i = 0; i < W; ++i) {
          e[k][i] = expf(cur[k][i] - m);
          s += e[k][i];
        }
    const float inv = 1.f / warp_sum(s);
    T* yr = y + (long long)r * N;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = k * 32 + lane;
      if (j < nvec) {
        float o[W];
#pragma unroll
        for (int i = 0; i < W; ++i) o[i] = e[k][i] * inv;
        store_vec<T>(yr + j * W, o);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) cur[k] = nxt[k];
  }
}

constexpr int BWD_WARPS = 8;  // warps a block of B7's warp-row body

// B7's warp-row body: a warp a row, grid-stride over rows with the next
// row's x, dy, mu and rstd loaded before the current row is reduced.
// Each lane keeps the dgamma/dbeta sums of its columns over its warp's
// rows; the block's warps add them by a fixed tree (warp w takes warp
// w + half's sums, half = BWD_WARPS / 2, ..., 1) and warp 0 writes the
// block's partial row. Warps without a row take part with zero sums.
template <typename T, typename G, int V>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
ln_bwd_warp_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                   const float* __restrict__ mu,
                   const float* __restrict__ rstd, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ dg_part,
                   float* __restrict__ db_part, int R, int D) {
  constexpr int W = vec_elems<T>();
  extern __shared__ float4 tree4[];  // [BWD_WARPS / 2][2 * D] floats
  float* tree = reinterpret_cast<float*>(tree4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = D / W;
  const int stride = gridDim.x * BWD_WARPS;
  int r = blockIdx.x * BWD_WARPS + warp;
  Chunk<G, W> g[V];
  float ag[V][W], ab[V][W];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = k * 32 + lane;
    if (j < nvec) g[k].load(gamma + j * W);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      ag[k][i] = 0.f;
      ab[k][i] = 0.f;
    }
  }
  Vec<T> xc[V], dc[V], xn[V], dn[V];
  load_row<T, V>(xc, x, r, R, nvec, lane);
  load_row<T, V>(dc, dy, r, R, nvec, lane);
  float m = r < R ? mu[r] : 0.f, rs = r < R ? rstd[r] : 0.f;
  for (; r < R; r += stride) {
    const int rn = r + stride;
    load_row<T, V>(xn, x, rn, R, nvec, lane);
    load_row<T, V>(dn, dy, rn, R, nvec, lane);
    const float mn = rn < R ? mu[rn] : 0.f;
    const float rsn = rn < R ? rstd[rn] : 0.f;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k * 32 + lane < nvec)
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const float xh = (xc[k][i] - m) * rs;
          const float w = __fmul_rn(dc[k][i], g[k][i]);
          s1 += w;
          s2 = fmaf(w, xh, s2);
        }
    const float c1 = warp_sum(s1) / (float)D;
    const float c2 = warp_sum(s2) / (float)D;
    T* dxr = dx + (long long)r * D;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = k * 32 + lane;
      if (j < nvec) {
        float o[W];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const float xh = (xc[k][i] - m) * rs;
          const float d = dc[k][i];
          // rounded before - c1, as the block body does (an FMA would
          // keep the product's error, which rs magnifies at width 1)
          const float w = __fmul_rn(d, g[k][i]);
          o[i] = (w - c1 - xh * c2) * rs;
          ag[k][i] = fmaf(d, xh, ag[k][i]);
          ab[k][i] += d;
        }
        store_vec<T>(dxr + j * W, o);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      xc[k] = xn[k];
      dc[k] = dn[k];
    }
    m = mn;
    rs = rsn;
  }
  // column k * 32 + lane's W sums sit at tree[slot][(k * 32 + lane) * W]
  // (dgamma) and at D past it (dbeta)
#pragma unroll
  for (int half = BWD_WARPS / 2; half > 0; half >>= 1) {
    if (warp >= half && warp < 2 * half) {
      float* t = tree + (size_t)(warp - half) * 2 * D;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = k * 32 + lane;
        if (j < nvec)
#pragma unroll
          for (int i = 0; i < W; i += 4) {
            *reinterpret_cast<float4*>(t + j * W + i) = make_float4(
                ag[k][i], ag[k][i + 1], ag[k][i + 2], ag[k][i + 3]);
            *reinterpret_cast<float4*>(t + D + j * W + i) = make_float4(
                ab[k][i], ab[k][i + 1], ab[k][i + 2], ab[k][i + 3]);
          }
      }
    }
    __syncthreads();
    if (warp < half) {
      const float* t = tree + (size_t)warp * 2 * D;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = k * 32 + lane;
        if (j < nvec)
#pragma unroll
          for (int i = 0; i < W; ++i) {
            ag[k][i] += t[j * W + i];
            ab[k][i] += t[D + j * W + i];
          }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
    float* pg = dg_part + (long long)blockIdx.x * D;
    float* pb = db_part + (long long)blockIdx.x * D;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int j = k * 32 + lane;
      if (j < nvec)
#pragma unroll
        for (int i = 0; i < W; i += 4) {
          *reinterpret_cast<float4*>(pg + j * W + i) = make_float4(
              ag[k][i], ag[k][i + 1], ag[k][i + 2], ag[k][i + 3]);
          *reinterpret_cast<float4*>(pb + j * W + i) = make_float4(
              ab[k][i], ab[k][i + 1], ab[k][i + 2], ab[k][i + 3]);
        }
    }
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
      // rounded as the first pass rounds it: contracted into an FMA with
      // - c1, w - c1 kept the product's rounding error, which rs (1000
      // at eps 1e-6) made 1e-4 where dx is 0 (D = 1)
      const float w = __fmul_rn(d, to_f(gamma[j]));
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
#pragma unroll 4
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

// blocks of a warp-row kernel (`warps` warps, `smem` dynamic bytes) that
// one SM holds at once
template <typename K>
int row_blocks_per_sm(K kern, int warps = ROW_WARPS, size_t smem = 0) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, warps * 32, smem);
  return n > 0 ? n : 1;
}

// a warp-row grid: a warp for each row, but no more blocks than the card
// holds at once (the warps then walk the rows by grid stride)
int row_grid(int per_sm, int R, int warps = ROW_WARPS) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = ((long long)R + warps - 1) / warps;
  return (int)(need < (long long)per_sm * sms ? need
                                              : (long long)per_sm * sms);
}

// what the warp-row body needs of its caller's choice: rows of whole
// vectors, at most `vecs` of them a lane, every operand 16-byte aligned
template <typename T, typename... P>
bool warp_row_fits(int vecs, int n, P... ptrs) {
  constexpr int W = vec_elems<T>();
  return vecs >= 1 && vecs <= max_vecs<T>() && n % W == 0 &&
         n <= 32 * W * vecs &&
         ((reinterpret_cast<uintptr_t>(ptrs) % 16 == 0) && ...);
}

// launch the warp-row body with V = vecs (instantiated for 1..max_vecs)
template <typename T, typename G, int V = 1>
int launch_ln_fwd_warp(int vecs, const void* x, const void* gamma,
                       const void* beta, void* y, void* mu, void* rstd,
                       int R, int D, float eps, cudaStream_t stream) {
  if constexpr (V > max_vecs<T>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (vecs != V)
      return launch_ln_fwd_warp<T, G, V + 1>(vecs, x, gamma, beta, y, mu,
                                             rstd, R, D, eps, stream);
    auto kern = ln_fwd_warp_kernel<T, G, V>;
    static const int per_sm = row_blocks_per_sm(kern);
    kern<<<row_grid(per_sm, R), ROW_WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const G*>(gamma),
        static_cast<const G*>(beta), static_cast<T*>(y),
        static_cast<float*>(mu), static_cast<float*>(rstd), R, D, eps);
    return (int)cudaGetLastError();
  }
}

template <typename T, int V = 1>
int launch_sm_fwd_warp(int vecs, const void* x, void* y, int R, int N,
                       cudaStream_t stream) {
  if constexpr (V > max_vecs<T>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (vecs != V)
      return launch_sm_fwd_warp<T, V + 1>(vecs, x, y, R, N, stream);
    auto kern = sm_fwd_warp_kernel<T, V>;
    static const int per_sm = row_blocks_per_sm(kern);
    kern<<<row_grid(per_sm, R), ROW_WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), R, N);
    return (int)cudaGetLastError();
  }
}

// vecs = 0: the block body; else the warp-row body with vecs vectors a
// lane, which the operands must fit
template <typename T, typename G>
int launch_ln_fwd(int vecs, const void* x, const void* gamma,
                  const void* beta, void* y, void* mu, void* rstd, int R,
                  int D, float eps, cudaStream_t stream) {
  if (vecs != 0) {
    if (!warp_row_fits<T>(vecs, D, x, gamma, beta, y))
      return (int)cudaErrorInvalidValue;
    return launch_ln_fwd_warp<T, G>(vecs, x, gamma, beta, y, mu, rstd, R, D,
                                    eps, stream);
  }
  ln_fwd_kernel<T, G><<<R, row_threads(D), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma),
      static_cast<const G*>(beta), static_cast<T*>(y),
      static_cast<float*>(mu), static_cast<float*>(rstd), D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sm_fwd(int vecs, const void* x, void* y, int R, int N,
                  cudaStream_t stream) {
  if (vecs != 0) {
    if (!warp_row_fits<T>(vecs, N, x, y)) return (int)cudaErrorInvalidValue;
    return launch_sm_fwd_warp<T>(vecs, x, y, R, N, stream);
  }
  sm_fwd_kernel<T><<<R, row_threads(N), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), N);
  return (int)cudaGetLastError();
}

// the fixed-order sum of n_parts partial rows into dgamma and dbeta
template <typename G>
int launch_ln_bwd_reduce(const void* dg_part, const void* db_part, void* dg,
                         void* db, int n_parts, int D, cudaStream_t stream) {
  dim3 block(RED_COLS, RED_WAYS);
  ln_bwd_reduce_kernel<G><<<(D + RED_COLS - 1) / RED_COLS, block, 0,
                            stream>>>(
      static_cast<const float*>(dg_part), static_cast<const float*>(db_part),
      static_cast<G*>(dg), static_cast<G*>(db), n_parts, D);
  return (int)cudaGetLastError();
}

// B7's warp-row body with V = vecs (instantiated for 1..max_vecs),
// one partial row per block, at most `parts` blocks
template <typename T, typename G, int V = 1>
int launch_ln_bwd_warp(int vecs, const void* x, const void* gamma,
                       const void* mu, const void* rstd, const void* dy,
                       void* dx, void* dg_part, void* db_part, void* dg,
                       void* db, int R, int D, int parts,
                       cudaStream_t stream) {
  if constexpr (V > max_vecs<T>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (vecs != V)
      return launch_ln_bwd_warp<T, G, V + 1>(vecs, x, gamma, mu, rstd, dy,
                                             dx, dg_part, db_part, dg, db, R,
                                             D, parts, stream);
    auto kern = ln_bwd_warp_kernel<T, G, V>;
    // the tree's shared floats at this body's widest row
    constexpr size_t widest = (size_t)BWD_WARPS * 32 * vec_elems<T>() * V *
                              sizeof(float);
    static const int per_sm = row_blocks_per_sm(kern, BWD_WARPS, widest);
    int n_parts = row_grid(per_sm, R, BWD_WARPS);
    if (n_parts > parts) n_parts = parts;
    const size_t smem = (size_t)BWD_WARPS * D * sizeof(float);
    kern<<<n_parts, BWD_WARPS * 32, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const G*>(gamma),
        static_cast<const float*>(mu), static_cast<const float*>(rstd),
        static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(dg_part), static_cast<float*>(db_part), R, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_ln_bwd_reduce<G>(dg_part, db_part, dg, db, n_parts, D,
                                   stream);
  }
}

// vecs = 0: the block body, one partial row per ceil(R / parts) rows;
// else the warp-row body with vecs vectors a lane, which the operands
// must fit
template <typename T, typename G>
int launch_ln_bwd(int vecs, const void* x, const void* gamma, const void* mu,
                  const void* rstd, const void* dy, void* dx, void* dg_part,
                  void* db_part, void* dg, void* db, int R, int D, int parts,
                  cudaStream_t stream) {
  if (vecs != 0) {
    if (!warp_row_fits<T>(vecs, D, x, gamma, dy, dx))
      return (int)cudaErrorInvalidValue;
    return launch_ln_bwd_warp<T, G>(vecs, x, gamma, mu, rstd, dy, dx,
                                    dg_part, db_part, dg, db, R, D, parts,
                                    stream);
  }
  const size_t smem = 2 * (size_t)D * sizeof(float);
  auto kern = ln_bwd_kernel<T, G>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows_per_block = (R + parts - 1) / parts;
  const int n_parts = (R + rows_per_block - 1) / rows_per_block;
  kern<<<n_parts, row_threads(D), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma),
      static_cast<const float*>(mu), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dg_part), static_cast<float*>(db_part), R, D,
      rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_ln_bwd_reduce<G>(dg_part, db_part, dg, db, n_parts, D,
                                 stream);
}

}  // namespace

// dtype / gdtype: 0 = float32, 1 = bfloat16, of x (and y, dy, dx) and of
// gamma/beta (and dgamma, dbeta). Every array is contiguous: x, y, dy,
// dx are [R, D] (softmax: [R, N]); mu and rstd are [R] float32. `vecs`
// (B6, B7, B8) picks the body: 0 the block body, V >= 1 the warp-row body
// with V 16-byte vectors a lane, refused with cudaErrorInvalidValue
// where the operands do not fit it. Each function launches on `stream`
// and returns cudaGetLastError().

extern "C" int ln_fwd(int dtype, int gdtype, int vecs, const void* x,
                      const void* gamma, const void* beta, void* y, void* mu,
                      void* rstd, int R, int D, float eps, void* stream) {
  if (R <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gdtype == 0)
    return launch_ln_fwd<float, float>(vecs, x, gamma, beta, y, mu, rstd, R,
                                       D, eps, st);
  if (dtype == 0 && gdtype == 1)
    return launch_ln_fwd<float, __nv_bfloat16>(vecs, x, gamma, beta, y, mu,
                                               rstd, R, D, eps, st);
  if (dtype == 1 && gdtype == 0)
    return launch_ln_fwd<__nv_bfloat16, float>(vecs, x, gamma, beta, y, mu,
                                               rstd, R, D, eps, st);
  if (dtype == 1 && gdtype == 1)
    return launch_ln_fwd<__nv_bfloat16, __nv_bfloat16>(
        vecs, x, gamma, beta, y, mu, rstd, R, D, eps, st);
  return (int)cudaErrorInvalidValue;
}

// dg_part and db_part are [parts, D] float32 scratch (each body writes at
// most `parts` partial rows); dg and db are [D] in gamma's dtype. `vecs`
// picks B7's body as it does B6's.
extern "C" int ln_bwd(int dtype, int gdtype, int vecs, const void* x,
                      const void* gamma, const void* mu, const void* rstd,
                      const void* dy, void* dx, void* dg_part, void* db_part,
                      void* dg, void* db, int R, int D, int parts,
                      void* stream) {
  if (R <= 0 || D <= 0 || parts <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gdtype == 0)
    return launch_ln_bwd<float, float>(vecs, x, gamma, mu, rstd, dy, dx,
                                       dg_part, db_part, dg, db, R, D, parts,
                                       st);
  if (dtype == 0 && gdtype == 1)
    return launch_ln_bwd<float, __nv_bfloat16>(vecs, x, gamma, mu, rstd, dy,
                                               dx, dg_part, db_part, dg, db,
                                               R, D, parts, st);
  if (dtype == 1 && gdtype == 0)
    return launch_ln_bwd<__nv_bfloat16, float>(vecs, x, gamma, mu, rstd, dy,
                                               dx, dg_part, db_part, dg, db,
                                               R, D, parts, st);
  if (dtype == 1 && gdtype == 1)
    return launch_ln_bwd<__nv_bfloat16, __nv_bfloat16>(
        vecs, x, gamma, mu, rstd, dy, dx, dg_part, db_part, dg, db, R, D,
        parts, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sm_fwd(int dtype, int vecs, const void* x, void* y, int R,
                      int N, void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_sm_fwd<float>(vecs, x, y, R, N, st);
  if (dtype == 1) return launch_sm_fwd<__nv_bfloat16>(vecs, x, y, R, N, st);
  return (int)cudaErrorInvalidValue;
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
