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
// pos > bound - window. Pages past ceil(sl / page) are never read, and
// with a window neither are the pages wholly below it. seq_len == 0
// gives exact zeros, so a scheduler can pad its batch with idle rows.
//
// What bounds it on this card: decode reads each cached K/V element once
// for a handful of operations per element (4*D operations per key and
// query row over 4*D bytes of bf16 K and V): far below the ~295 ops/byte
// ridge, so the bound is the bytes of K/V read from device memory. At the
// main path's sizes (8 sequences, <= 512 tokens, 12 heads) that is a few
// MB, about 1.5 us at 3.35 TB/s, so what a launch costs is latency: the
// number of dependent memory round trips on its longest block.
//
// What the design does about it: the key axis is split into chunks of
// `ppc` table slots (fixed by the table width W and the page size alone,
// paged_attention.py `_decode_chunks`, so no host read of seq_lens), and
// `paged_chunk_kernel` runs one block per (sequence, head, chunk, tile
// of query rows: one row for a one-row call, RT for more): the chunks of
// a sequence run side by side on as many SMs. A chunk past the
// sequence's last page, or wholly below its window, exits at once.
// Inside a chunk, D / (16 / sizeof(T)) lanes hold one key as 16-byte
// vectors (8 lanes a key at D = 64 bf16, four keys a warp instruction
// over 512 contiguous bytes), q sits in registers, and each score is
// summed over its lanes by butterfly shuffles. V is read the same way,
// its first U keys a thread together with their K, for the PV product,
// whose key groups are summed by shuffles and then across the block's
// warps in warp order. Each chunk writes its own (m, l, acc[D]) per row:
// its max, its sum of exp(s - m) and its unnormalised PV sum in fp32.
// `paged_combine_kernel` then takes the live chunks of each (sequence,
// head, row) in chunk-index order: M = max m_c, l = sum l_c exp(m_c -
// M), acc = sum acc_c exp(m_c - M), out = acc / l. A chunk whose keys
// the row's bound masks entirely has l = 0 and is skipped: an exact
// no-op. No atomics, no order of arrival: two launches agree bit for bit.
//
// B4 and B5 launch the same two kernels; B4 passes k = 1, kr = 1, no
// offsets and no window. Chunk boundaries sit at fixed table slots, so a
// row's partials do not depend on the keys past its own bound, and keys
// a row cannot see add exact zeros (their probabilities are 0 and are
// skipped in the PV sum). B5's row r is then the same arithmetic in the
// same order as a B4 step at seq_len - (kr - 1 - r), bit for bit. The
// prefix-cache path relies on it.
//
// Numerics follow the reference kernels: operands stay in the input
// dtype (bf16 products are exact in fp32), scores and row statistics
// are fp32, the scale multiplies the fp32 scores, masked scores are
// -1e30 and their probabilities 0, the probabilities are rounded to the
// input dtype before the PV product, and l == 0 is read as 1.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 128;       // threads per block
constexpr int NW = NT / 32;   // warps per block
constexpr int RT = 8;         // query rows per chunk block of B5 (B4: 1)
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// elements of T in one 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(T);
}

// one 16-byte vector of T, read through the read-only path
template <typename T>
struct Vec {
  uint32_t w[4];
  __device__ __forceinline__ void load(const T* p) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 0u;
  }
  // element i widened to fp32 (a bf16 is the top half of its fp32)
  __device__ __forceinline__ float operator[](int i) const {
    if constexpr (sizeof(T) == 4)
      return __uint_as_float(w[i]);
    else
      return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u
                                   : w[i >> 1] << 16);
  }
};

// The table slots a sequence reads, [j_first, j_last] (empty when
// j_first > j_last): through its last real page, from the first page
// its window reaches. Both kernels derive the live chunks from it.
__device__ __forceinline__ void live_slots(int sl, int kr, int po,
                                           int window, int page, int W,
                                           int& j_first, int& j_last) {
  j_last = min(max((sl + page - 1) / page - 1 - po, 0), W - 1);
  j_first = 0;
  if (window > 0) {
    const int first_pos = max(sl - kr - window + 1, 0);
    j_first = max(first_pos / page - po, 0);
  }
}

// One (sequence, head, chunk, tile of up to ROWS rows). q/out [B, K, H,
// D]; partials indexed ((b * H + h) * n_chunks + c) * K + r: part_ml
// holds (m, l), part_acc D floats. A row's arithmetic does not depend on
// ROWS (each step is an explicit fmaf, add, max or exp of that row's
// values, in the same order, with no product left for the compiler to
// contract), so the ROWS = 1 body that B4 and one-row B5 calls run and
// the ROWS = RT body of B5 agree bit for bit.
// The floor of one block an SM in __launch_bounds__ is there for ptxas:
// without it, it capped the fp32 eight-row bodies at 128 registers (an
// occupancy step) and spilled 140 bytes.
template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(NT, 1)
paged_chunk_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, float* __restrict__ part_ml,
                   float* __restrict__ part_acc, const int* __restrict__ bt,
                   const int* __restrict__ sl_p, const int* __restrict__ kr_p,
                   const int* __restrict__ po_p, int K, int W, int page,
                   int ppc, int n_chunks, int H, int window, float scale) {
  constexpr int VE = vec_elems<T>();  // elements a lane holds of a key
  constexpr int LPK = D / VE;         // lanes a key
  constexpr int KPI = NT / LPK;       // keys a block pass
  // keys a thread loads before it uses them: eight for one row (a chunk
  // of 128 keys at D = 64 bf16 in one batch), four for RT rows, whose
  // q and PV sums take the registers (at eight, 180 of them: two blocks
  // an SM, and B5's timed shape ran in two waves)
  constexpr int U = ROWS == 1 ? 8 : 4;
  static_assert(LPK >= 1 && LPK <= 32, "a key spans one warp at most");
  extern __shared__ float smem[];

  const int c = blockIdx.x % n_chunks;
  const int bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * ROWS;
  const int nr = min(ROWS, K - r0);
  const int rt = min(ROWS, K);
  const int sl = sl_p[b];
  if (sl <= 0) return;
  const int kr = kr_p != nullptr ? kr_p[b] : K;
  const int po = po_p != nullptr ? po_p[b] : 0;
  int j_first, j_last;
  live_slots(sl, kr, po, window, page, W, j_first, j_last);
  const int j0 = c * ppc;
  const int js = max(j0, j_first), je = min(j0 + ppc - 1, j_last);
  if (js > je) return;

  const int CH = ppc * page;           // keys a chunk frame holds
  float* ps = smem;                    // [rt][CH] scores, then probs
  float* red = ps + rt * CH;           // [NW][rt][D]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ks = tid / LPK, li = tid % LPK;
  const int t_lo = (js - j0) * page, t_hi = (je - j0 + 1) * page;
  const int* bt_row = bt + (long long)b * W;
  const long long row_stride = (long long)H * D;
  const long long off = h * D + li * VE;
  const T* qb = q + (long long)b * K * row_stride;

  Vec<T> qv[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < nr)
      qv[r].load(qb + (long long)(r0 + r) * row_stride + off);
    else
      qv[r].zero();
  }
  int bound[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) bound[r] = sl - kr + min(r0 + r, kr - 1);

  // scores: key t of the chunk frame sits in slot j0 + t / page; the
  // trip count is the block's, so every lane reaches the shuffles. The
  // first U keys' V vectors are loaded with their K ones (a chunk of 128
  // keys at D = 64 bf16 is one such batch: one round trip for K and V).
  Vec<T> v0[U];
  for (int tb = 0; tb < t_hi; tb += U * KPI) {
    Vec<T> kv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = tb + u * KPI + ks;
      if (t >= t_lo && t < t_hi) {
        const int j = t / page;
        const long long a =
            ((long long)bt_row[j0 + j] * page + (t - j * page)) * row_stride +
            off;
        kv[u].load(kp + a);
        if (tb == 0) v0[u].load(vp + a);
      } else {
        kv[u].zero();
        if (tb == 0) v0[u].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = tb + u * KPI + ks;
      const int pos = (po + j0) * page + t;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nr) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < VE; ++e) a = fmaf(qv[r][e], kv[u][e], a);
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1)
            a += __shfl_xor_sync(0xffffffffu, a, o);
          if (li == 0 && t < t_hi) {
            const bool valid = t >= t_lo && pos <= bound[r] &&
                               (window <= 0 || pos > bound[r] - window);
            ps[r * CH + t] = valid ? a * scale : NEG_INF;
          }
        }
      }
    }
  }
  __syncthreads();

  // row statistics of the chunk: warp w owns rows w, w + NW, ...
  const long long pidx = ((long long)bh * n_chunks + c) * K + r0;
  for (int r = warp; r < nr; r += NW) {
    float* pr = ps + r * CH;
    float mx = NEG_INF;
    for (int t = lane; t < t_hi; t += 32) mx = fmaxf(mx, pr[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int t = lane; t < t_hi; t += 32) {
      const float s = pr[t];
      const float p = s == NEG_INF ? 0.f : expf(s - mx);
      pr[t] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      part_ml[2 * (pidx + r)] = mx;
      part_ml[2 * (pidx + r) + 1] = sum;
    }
  }
  __syncthreads();

  // PV: thread (ks, li) sums keys ks, ks + KPI, ... in order; a key a row
  // cannot see has probability 0 and is skipped
  float acc[ROWS][VE];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[r][e] = 0.f;
  for (int tb = 0; tb < t_hi; tb += U * KPI) {
    Vec<T> vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = tb + u * KPI + ks;
      if (tb == 0) {
        vv[u] = v0[u];
      } else if (t >= t_lo && t < t_hi) {
        const int j = t / page;
        vv[u].load(vp + ((long long)bt_row[j0 + j] * page + (t - j * page)) *
                            row_stride + off);
      } else {
        vv[u].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = tb + u * KPI + ks;
      if (t >= t_lo && t < t_hi) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nr) {
            const float p = to_f(from_f<T>(ps[r * CH + t]));
            if (p != 0.f) {
#pragma unroll
              for (int e = 0; e < VE; ++e)
                acc[r][e] = fmaf(p, vv[u][e], acc[r][e]);
            }
          }
        }
      }
    }
  }
  // the warp's key groups by butterfly, then the warps in warp order
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < nr) {
#pragma unroll
      for (int e = 0; e < VE; ++e) {
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        if (lane < LPK) red[(warp * rt + r) * D + li * VE + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float s = red[r * D + d];
#pragma unroll
    for (int w = 1; w < NW; ++w) s += red[(w * rt + r) * D + d];
    part_acc[(pidx + r) * D + d] = s;
  }
}

// The chunks of each (sequence, head, row) in index order; NT / D rows a
// block, one thread a head dimension.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_combine_kernel(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     const int* __restrict__ sl_p,
                     const int* __restrict__ kr_p,
                     const int* __restrict__ po_p, int K, int W, int page,
                     int ppc, int n_chunks, int H, int window) {
  constexpr int RB = NT / D;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int r = blockIdx.y * RB + threadIdx.x / D;
  const int d = threadIdx.x % D;
  if (r >= K) return;
  T* o = out + ((long long)(b * K + r) * H + h) * D + d;
  const int sl = sl_p[b];
  if (sl <= 0) {
    *o = from_f<T>(0.f);
    return;
  }
  const int kr = kr_p != nullptr ? kr_p[b] : K;
  const int po = po_p != nullptr ? po_p[b] : 0;
  int j_first, j_last;
  live_slots(sl, kr, po, window, page, W, j_first, j_last);
  float l = 0.f, a = 0.f;
  if (j_first <= j_last) {
    const int c0 = j_first / ppc, c1 = j_last / ppc;
    const long long base = (long long)bh * n_chunks;
    float M = NEG_INF;
    for (int c = c0; c <= c1; ++c)
      M = fmaxf(M, part_ml[2 * ((base + c) * K + r)]);
    for (int c = c0; c <= c1; ++c) {
      const long long i = (base + c) * K + r;
      const float lc = part_ml[2 * i + 1];
      if (lc > 0.f) {
        const float w = expf(part_ml[2 * i] - M);
        l = fmaf(lc, w, l);
        a = fmaf(part_acc[i * D + d], w, a);
      }
    }
  }
  *o = from_f<T>(a / (l == 0.f ? 1.f : l));
}

template <typename T, int D, int ROWS>
int launch_chunks(const void* q, const void* kp, const void* vp,
                  float* part_ml, float* part_acc, const void* bt,
                  const void* sl, const void* kr, const void* po, int B,
                  int K, int H, int W, int page, int ppc, int n_chunks,
                  int window, float scale, cudaStream_t stream) {
  const int rt = K < ROWS ? K : ROWS;
  const size_t smem =
      ((size_t)rt * ppc * page + (size_t)NW * rt * D) * sizeof(float);
  auto chunk = paged_chunk_kernel<T, D, ROWS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B * H * n_chunks, (K + ROWS - 1) / ROWS);
  chunk<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), part_ml, part_acc,
      static_cast<const int*>(bt), static_cast<const int*>(sl),
      static_cast<const int*>(kr), static_cast<const int*>(po), K, W, page,
      ppc, n_chunks, H, window, scale);
  return (int)cudaGetLastError();
}

// the chunk body (one row a block for k = 1, RT rows for more), then the
// combine
template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, void* out,
           const void* bt, const void* sl, const void* kr, const void* po,
           float* part, int B, int K, int H, int W, int page, int ppc,
           int n_chunks, int window, float scale, cudaStream_t stream) {
  const long long n_part = (long long)B * H * n_chunks * K;
  float* part_acc = part;
  float* part_ml = part + n_part * D;
  const int err =
      K == 1 ? launch_chunks<T, D, 1>(q, kp, vp, part_ml, part_acc, bt, sl,
                                      kr, po, B, K, H, W, page, ppc,
                                      n_chunks, window, scale, stream)
             : launch_chunks<T, D, RT>(q, kp, vp, part_ml, part_acc, bt, sl,
                                       kr, po, B, K, H, W, page, ppc,
                                       n_chunks, window, scale, stream);
  if (err != 0) return err;
  constexpr int RB = NT / D;
  dim3 cgrid(B * H, (K + RB - 1) / RB);
  paged_combine_kernel<T, D><<<cgrid, NT, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), static_cast<const int*>(sl),
      static_cast<const int*>(kr), static_cast<const int*>(po), K, W, page,
      ppc, n_chunks, H, window);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, int D, const void* q, const void* kp,
             const void* vp, void* out, const void* bt, const void* sl,
             const void* kr, const void* po, void* part, int B, int K, int H,
             int W, int page, int ppc, int n_chunks, int window, float scale,
             void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || W <= 0 || page <= 0 || ppc <= 0 ||
      n_chunks != (W + ppc - 1) / ppc || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
#define PAGED_CASE(DD)                                                      \
  case DD:                                                                  \
    return dtype == 0                                                       \
               ? launch<float, DD>(q, kp, vp, out, bt, sl, kr, po, p, B, K, \
                                   H, W, page, ppc, n_chunks, window,       \
                                   scale, st)                               \
               : launch<__nv_bfloat16, DD>(q, kp, vp, out, bt, sl, kr, po,  \
                                           p, B, K, H, W, page, ppc,        \
                                           n_chunks, window, scale, st);
  switch (D) {
    PAGED_CASE(16)
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAGED_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out [B, H, D]; pools [P, page, H, D]
// with q and both pools 16-byte aligned; bt [B, W] int32; sl [B] int32.
// The key axis runs in n_chunks = ceil(W / ppc) chunks of ppc table
// slots; `part` is float32 scratch of B * H * n_chunks * K * (D + 2)
// floats (K = 1 here). Returns cudaGetLastError() after the launches.
extern "C" int paged_decode(int dtype, int D, const void* q, const void* kp,
                            const void* vp, void* out, const void* bt,
                            const void* sl, void* part, int B, int H, int W,
                            int page, int ppc, int n_chunks, float scale,
                            void* stream) {
  return dispatch(dtype, D, q, kp, vp, out, bt, sl, nullptr, nullptr, part,
                  B, 1, H, W, page, ppc, n_chunks, 0, scale, stream);
}

// q/out [B, K, H, D]; kr (q_rows) and po (page_offsets) are [B] int32 or
// null (kr = K, po = 0); window <= 0 means no window; the rest as above.
extern "C" int paged_decode_multi(int dtype, int D, const void* q,
                                  const void* kp, const void* vp, void* out,
                                  const void* bt, const void* sl,
                                  const void* kr, const void* po, void* part,
                                  int B, int K, int H, int W, int page,
                                  int ppc, int n_chunks, int window,
                                  float scale, void* stream) {
  return dispatch(dtype, D, q, kp, vp, out, bt, sl, kr, po, part, B, K, H,
                  W, page, ppc, n_chunks, window, scale, stream);
}
