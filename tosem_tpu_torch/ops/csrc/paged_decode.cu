// Paged-KV decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: tosem_tpu/ops/paged_attention.py `_decode_kernel` (B4, one
// query token per sequence, driven by `_paged_attention_pallas`) and
// `_decode_multi_kernel` (B5, k query rows per sequence with the
// intra-step causal bound, sliding window and page offsets, driven by
// `_paged_attention_pallas_multi`).
//
// Each sequence attends over the pages its block-table row names in the
// shared [P, page, H, D] pools. Query row r of a sequence holds the token
// at position sl - kr + r and sees keys pos <= sl - kr + min(r, kr - 1)
// (rows past kr mirror the last real one), and with a window only keys
// pos > bound - window. Pages past ceil(sl / page) are skipped, and with
// a window so are the pages wholly below it. seq_len == 0 gives exact
// zeros, so a scheduler can pad its batch with idle rows.
//
// What bounds it on this card: decode reads each cached K/V element once
// for a handful of operations per element (4*D operations per key and
// query row over 4*D bytes of bf16 K and V): far below the ~295 ops/byte
// ridge, so the bound is the bytes of K/V read from device memory. At the main path's sizes (8 sequences, <= 512 tokens, 12
// heads) that is a few MB, microseconds at 3.35 TB/s, so in practice a
// launch is bounded by latency: the page walk is serial inside a block.
//
// What the design does about it: one block per (sequence, head, 8-row
// tile of queries); the block walks its own block-table row, so no page
// outside the sequence is read, and a K/V page is read once per row tile
// for all of the tile's rows. Scores take one key per thread; the PV
// product reads V rows with neighbouring threads on neighbouring head
// dimensions (coalesced), split over key groups whose partials are
// summed in a fixed order. Split-K over pages is not done: if added, its
// splits must be combined in a fixed order too.
//
// B4 and B5 share one non-inlined device function, and B4 calls it
// exactly as B5 does with k = 1, kr = 1, no offsets and no window: B5's
// row r is then the same arithmetic in the same order as a B4 step at
// seq_len - (kr - 1 - r), bit for bit. The prefix-cache path relies on it.
//
// Numerics follow the reference kernels: operands stay in the input
// dtype (bf16 products are exact in fp32), scores and row statistics
// are fp32, the scale multiplies the fp32 scores, masked scores are
// -1e30 and their probabilities 0, the probabilities are rounded to the
// input dtype before the PV product, and l == 0 is read as 1.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 128;      // threads per block
constexpr int R = 8;         // query rows per block
constexpr float NEG_INF = -1e30f;

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

__host__ __device__ constexpr size_t smem_floats(int D, int page) {
  return (size_t)R * D + (size_t)R * page + (size_t)(NT / D) * R * D + 3 * R;
}

// One (sequence, head, row tile): rows r0 .. r0 + min(R, K - r0) - 1 of
// this sequence's K query rows. q/out point at the sequence's [K, H, D]
// rows; bt_row at its block-table row of width W.
template <typename T, int D>
__device__ __noinline__ void paged_tile(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, T* __restrict__ out,
    const int* __restrict__ bt_row, int W, int sl, int kr, int po,
    int window, int page, int H, int h, int K, int r0, float scale) {
  extern __shared__ float smem[];
  constexpr int G = NT / D;                // key groups of the PV product
  float* qs = smem;                        // [R][D]
  float* ps = qs + R * D;                  // [R][page] scores, then probs
  float* red = ps + R * page;              // [G][R][D]
  float* m_s = red + G * R * D;            // [R]
  float* l_s = m_s + R;                    // [R]
  float* a_s = l_s + R;                    // [R]

  const int tid = threadIdx.x;
  const int nr = min(R, K - r0);
  const long long row_stride = (long long)H * D;

  if (sl <= 0) {
    for (int e = tid; e < nr * D; e += NT) {
      const int r = e / D, d = e % D;
      out[(r0 + r) * row_stride + h * D + d] = from_f<T>(0.f);
    }
    return;
  }
  for (int e = tid; e < R * D; e += NT) {
    const int r = e / D, d = e % D;
    qs[e] = r < nr ? to_f(q[(r0 + r) * row_stride + h * D + d]) : 0.f;
  }
  if (tid < R) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int dd = tid % D;
  const int g = tid / D;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  const int j_last = min(max((sl + page - 1) / page - 1 - po, 0), W - 1);
  int j_first = 0;
  if (window > 0) {
    const int first_pos = max(sl - kr - window + 1, 0);
    j_first = max(first_pos / page - po, 0);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int j = j_first; j <= j_last; ++j) {
    const long long pbase = (long long)bt_row[j] * page * row_stride + h * D;
    const int pos0 = (po + j) * page;

    // scores: thread t owns key t of the page, for every row of the tile
    for (int t = tid; t < page; t += NT) {
      const T* k_t = kp + pbase + (long long)t * row_stride;
      float kv[D];
#pragma unroll
      for (int d = 0; d < D; ++d) kv[d] = to_f(k_t[d]);
      const int pos = pos0 + t;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          float a = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) a = fmaf(qs[r * D + d], kv[d], a);
          const float s = a * scale;
          const int bound = sl - kr + min(r0 + r, kr - 1);
          const bool valid = pos <= bound && (window <= 0 || pos > bound - window);
          ps[r * page + t] = valid ? s : NEG_INF;
        }
      }
    }
    __syncthreads();

    // row statistics: warp w owns rows w, w + NT/32, ...
    for (int r = warp; r < nr; r += NT / 32) {
      float mx = NEG_INF;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, ps[r * page + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const int bound = sl - kr + min(r0 + r, kr - 1);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const int pos = pos0 + t;
        const bool valid = pos <= bound && (window <= 0 || pos > bound - window);
        const float p = valid ? expf(ps[r * page + t] - m_new) : 0.f;
        ps[r * page + t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // PV partials: thread (dd, g) sums keys g, g + G, ... of the page
    float part[R];
#pragma unroll
    for (int r = 0; r < R; ++r) part[r] = 0.f;
    for (int t = g; t < page; t += G) {
      const float vv = to_f(vp[pbase + (long long)t * row_stride + dd]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) part[r] = fmaf(to_f(from_f<T>(ps[r * page + t])), vv, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) red[(g * R + r) * D + dd] = part[r];
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          float pv = 0.f;
          for (int gg = 0; gg < G; ++gg) pv += red[(gg * R + r) * D + dd];
          acc[r] = acc[r] * a_s[r] + pv;
        }
      }
    }
    __syncthreads();
  }

  if (g == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        const float l = l_s[r];
        const float l_safe = (l == 0.f) ? 1.f : l;
        out[(r0 + r) * row_stride + h * D + dd] = from_f<T>(acc[r] / l_safe);
      }
    }
  }
}

// B4: q/out [B, H, D]; one block per (sequence, head).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, T* __restrict__ out,
                    const int* __restrict__ bt, const int* __restrict__ sl,
                    int W, int page, int H, float scale) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long off = (long long)b * H * D;
  paged_tile<T, D>(q + off, kp, vp, out + off, bt + (long long)b * W, W,
                   sl[b], 1, 0, 0, page, H, h, 1, 0, scale);
}

// B5: q/out [B, K, H, D]; one block per (sequence, head, row tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_multi_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp, T* __restrict__ out,
                          const int* __restrict__ bt,
                          const int* __restrict__ sl,
                          const int* __restrict__ kr,
                          const int* __restrict__ po, int K, int W, int page,
                          int H, int window, float scale) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long off = (long long)b * K * H * D;
  paged_tile<T, D>(q + off, kp, vp, out + off, bt + (long long)b * W, W,
                   sl[b], kr != nullptr ? kr[b] : K,
                   po != nullptr ? po[b] : 0, window, page, H, h, K,
                   blockIdx.y * R, scale);
}

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T, int D>
int launch_single(const void* q, const void* kp, const void* vp, void* out,
                  const void* bt, const void* sl, int B, int H, int W,
                  int page, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D, page) * sizeof(float);
  auto kern = paged_decode_kernel<T, D>;
  if (int err = prepare(kern, smem)) return err;
  kern<<<B * H, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<T*>(out),
      static_cast<const int*>(bt), static_cast<const int*>(sl), W, page, H,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_multi(const void* q, const void* kp, const void* vp, void* out,
                 const void* bt, const void* sl, const void* kr,
                 const void* po, int B, int K, int H, int W, int page,
                 int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D, page) * sizeof(float);
  auto kern = paged_decode_multi_kernel<T, D>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid(B * H, (K + R - 1) / R);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<T*>(out),
      static_cast<const int*>(bt), static_cast<const int*>(sl),
      static_cast<const int*>(kr), static_cast<const int*>(po), K, W, page, H,
      window, scale);
  return (int)cudaGetLastError();
}

#define PAGED_DISPATCH(FN, ...)                                             \
  switch (D) {                                                              \
    case 16: return dtype == 0 ? FN<float, 16>(__VA_ARGS__)                 \
                               : FN<__nv_bfloat16, 16>(__VA_ARGS__);        \
    case 32: return dtype == 0 ? FN<float, 32>(__VA_ARGS__)                 \
                               : FN<__nv_bfloat16, 32>(__VA_ARGS__);        \
    case 64: return dtype == 0 ? FN<float, 64>(__VA_ARGS__)                 \
                               : FN<__nv_bfloat16, 64>(__VA_ARGS__);        \
    case 128: return dtype == 0 ? FN<float, 128>(__VA_ARGS__)               \
                                : FN<__nv_bfloat16, 128>(__VA_ARGS__);      \
    default: return (int)cudaErrorInvalidValue;                             \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out [B, H, D]; pools [P, page, H, D];
// bt [B, W] int32; sl [B] int32. Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(int dtype, int D, const void* q, const void* kp,
                            const void* vp, void* out, const void* bt,
                            const void* sl, int B, int H, int W, int page,
                            float scale, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || page <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PAGED_DISPATCH(launch_single, q, kp, vp, out, bt, sl, B, H, W, page, scale,
                 st)
}

// q/out [B, K, H, D]; kr (q_rows) and po (page_offsets) are [B] int32 or
// null (kr = K, po = 0); window <= 0 means no window.
extern "C" int paged_decode_multi(int dtype, int D, const void* q,
                                  const void* kp, const void* vp, void* out,
                                  const void* bt, const void* sl,
                                  const void* kr, const void* po, int B, int K,
                                  int H, int W, int page, int window,
                                  float scale, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || W <= 0 || page <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PAGED_DISPATCH(launch_multi, q, kp, vp, out, bt, sl, kr, po, B, K, H, W,
                 page, window, scale, st)
}
