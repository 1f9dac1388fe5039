// Greedy non-maximum suppression over score-sorted boxes, for Hopper
// (sm_90a), plain C interface: a bitmask NMS in three launches.
//
// Replaces: no Pallas kernel. tosem_tpu/models/pointpillars.py
// `device_nms` (the `nms_cuda` role of Apollo's PointPillars) is an XLA
// program there: an IoU matrix and a `lax.fori_loop` over the sorted
// candidates. Run eagerly in torch, that loop is several launches a box
// (about 10^5 launches at the 141 x 141 grid's 19,881 boxes) over an IoU
// matrix of 1.58 GB, so the sweep is a kernel of its own.
//
// What bounds it on this card: operations, and a chain that cannot run
// in parallel. The greedy work is one IoU (14 fp32 operations) for each
// pair (kept box i, box j > i still live at step i), which is data
// dependent; the bytes are the boxes, scores and order read once and
// `keep` written once (29 bytes a box), far below the operations.
// Whether box j is kept depends on every kept box before it.
//
// What the design does about it: it moves the IoUs off the chain.
// Candidates are cut into chunks of 64 in score order, and W = n / 64
// (rounded up) words of 64 bits cover a row of candidates.
// (1) `nms_gather_kernel` gathers the boxes into score order, packs
//     live0 (score above the threshold) into W words, and clears the
//     occupancy words.
// (2) `nms_mask_kernel` computes, in parallel over 64 x 64 tiles of the
//     upper triangle, the overlap words: bit b of mask[i][c] is set iff
//     j = 64c + b > i, j is live at the start, and IoU(i, j) exceeds the
//     threshold. A tile stages its 64 column boxes in shared memory; rows
//     not live at the start, and tiles with no live row or column, are
//     skipped (the sweep never reads them). Blocks stride over the tiles,
//     so a tile that is skipped costs two cached loads, not a block. A
//     row's word on its own chunk is always written; a word off it only
//     where it is not zero, and then its bit is set in the row's
//     occupancy words occ[i] (W / 64 of them, rounded up; an atomic OR,
//     whose result does not depend on order). Every IoU of a live pair is
//     computed: about n^2 / 2 of them when every box is live, more than
//     the greedy chain needs, but all at once across the card instead of
//     one step at a time.
// (3) `nms_sweep_kernel`, one block, keeps the `removed` bitmap (W words,
//     ~live0 at the start) in dynamic shared memory, and walks the chunks
//     in order. Warp 0 resolves chunk c in series on its diagonal words:
//     a candidate is kept if its bit in the running word is clear, and a
//     kept candidate ORs its mask[i][c] into that word; the running word,
//     whose clear bits are then exactly the kept candidates, is stored
//     back as removed[c]. Meanwhile warps 1-2 fetch the next chunk's
//     diagonal words. After a barrier the block ORs into `removed` the
//     kept rows' non-zero words past the chunk, found from their
//     occupancy words (shared atomics: OR does not depend on their
//     order), and meets at a second barrier. Chunks whose candidates are
//     all removed are passed over without a barrier. Two barriers a chunk
//     replace one a live box, and at the end the clear bits of `removed`
//     are the kept mask, scattered to `keep` in input order.
// The mask takes n * W * 8 bytes of device memory (49.5 MB at 19,881
// boxes; the reference's IoU matrix is 32x that), of which the sweep
// reads the diagonal and the non-zero words, and the bitmap W * 8 bytes
// of shared memory, which caps a launch at `nms_max_n()` boxes.
//
// Numerics: the IoU is the JAX package's operations in its order, with
// no contraction into FMA (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn):
// area = max(x2 - x1, 0) * max(y2 - y1, 0);
// inter = max(min(x2) - max(x1), 0) * max(min(y2) - max(y1), 0);
// iou = inter / max((area_i + area_j) - inter, 1e-9), compared with
// `iou > iou_threshold`. Where the threshold is not below 0, a pair with
// no positive intersection is decided without the division: its IoU is
// 0 or NaN, and neither exceeds it. The plain version (ops/nms.py
// `nms_plain`) gives the same bits on the same inputs, so `keep` is
// compared element for element. No step depends on scheduling: two
// launches give the same bits.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NMS_CHUNK = 64;          // candidates a word, a tile side
constexpr int NMS_GATHER_THREADS = 256;
constexpr int NMS_SWEEP_THREADS = 1024;
constexpr u64 NMS_ALL = ~0ull;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// IoU(a, b) > thr, with the division skipped where it cannot matter
// (`thr_nonneg` and no positive intersection).
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                        float area_b, float thr,
                                        bool thr_nonneg) {
  float x1 = fmaxf(a.x, b.x);
  float y1 = fmaxf(a.y, b.y);
  float x2 = fminf(a.z, b.z);
  float y2 = fminf(a.w, b.w);
  float inter = __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                          fmaxf(__fsub_rn(y2, y1), 0.0f));
  if (thr_nonneg && !(inter > 0.0f)) return false;
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f)) > thr;
}

// sorted[j] = boxes[order[j]]; bit j % 64 of live[j / 64] = score above
// the threshold (bits past n stay clear); occ[*] = 0.
__global__ void __launch_bounds__(NMS_GATHER_THREADS)
nms_gather_kernel(const float4* __restrict__ boxes,
                  const float* __restrict__ scores,
                  const int64_t* __restrict__ order, int n, int W,
                  size_t occ_words, float score_thr,
                  float4* __restrict__ sorted, u64* __restrict__ live,
                  u64* __restrict__ occ) {
  constexpr int WORDS = NMS_GATHER_THREADS / NMS_CHUNK;
  __shared__ u64 words[WORDS];
  int t = threadIdx.x;
  if (t < WORDS) words[t] = 0;
  __syncthreads();
  int j = blockIdx.x * NMS_GATHER_THREADS + t;
  if (j < n) {
    int64_t src = order[j];
    sorted[j] = boxes[src];
    if (scores[src] > score_thr)
      atomicOr(&words[t / NMS_CHUNK], 1ull << (t % NMS_CHUNK));
  }
  __syncthreads();
  int w = blockIdx.x * WORDS + t;
  if (t < WORDS && w < W) live[w] = words[t];
  for (size_t o = static_cast<size_t>(blockIdx.x) * NMS_GATHER_THREADS + t;
       o < occ_words; o += static_cast<size_t>(gridDim.x) * NMS_GATHER_THREADS)
    occ[o] = 0;
}

// Tiles (row chunk r, column chunk c >= r), one thread a row; the blocks
// stride over them. Tile q folds the triangle: with p = q / (W + 1) and
// k = q % (W + 1), it is row chunk p's tile k for k < W - p, and row chunk
// W - 1 - p's after them.
__global__ void __launch_bounds__(NMS_CHUNK)
nms_mask_kernel(const float4* __restrict__ sorted,
                const u64* __restrict__ live, int n, int W, int W2,
                float iou_thr, u64* __restrict__ mask,
                u64* __restrict__ occ) {
  __shared__ float4 cbox[NMS_CHUNK];
  __shared__ float carea[NMS_CHUNK];
  const int t = threadIdx.x;
  const bool thr_nonneg = iou_thr >= 0.0f;
  const long long tiles = static_cast<long long>(W + 1) * ((W + 1) / 2);
  for (long long q = blockIdx.x; q < tiles; q += gridDim.x) {
    int p = static_cast<int>(q / (W + 1)), k = static_cast<int>(q % (W + 1));
    int r, c;
    if (k < W - p) {
      r = p;
      c = p + k;
    } else {
      r = W - 1 - p;
      if (r == p) continue;          // the middle row chunk of an odd W
      c = r + (k - (W - p));
    }
    u64 live_r = live[r], live_c = live[c];
    if (live_r == 0 || live_c == 0) continue;    // the same in every thread
    __syncthreads();                 // the last tile's column reads are done
    int j = c * NMS_CHUNK + t;
    if (j < n) {
      float4 b = sorted[j];
      cbox[t] = b;
      carea[t] = box_area(b);
    }
    __syncthreads();
    if (!((live_r >> t) & 1)) continue;          // also every row past n
    int i = r * NMS_CHUNK + t;
    float4 bi = sorted[i];
    float ai = box_area(bi);
    u64 cols = live_c;               // live columns; past n they are clear
    if (c == r) cols &= t == NMS_CHUNK - 1 ? 0 : NMS_ALL << (t + 1);
    u64 word = 0;
    for (; cols; cols &= cols - 1) {
      int b = __ffsll(static_cast<long long>(cols)) - 1;
      if (overlaps(bi, ai, cbox[b], carea[b], iou_thr, thr_nonneg))
        word |= 1ull << b;
    }
    if (c == r || word) mask[static_cast<size_t>(i) * W + c] = word;
    if (c != r && word)
      atomicOr(&occ[static_cast<size_t>(i) * W2 + c / NMS_CHUNK],
               1ull << (c % NMS_CHUNK));
  }
}

// mask[64c + t][c], candidate 64c + t's word on its own chunk, or 0 past
// n. A row that was not live at the start was never written: its word is
// read and never used, since that candidate's bit is set in `removed`.
__device__ __forceinline__ u64 diag_word(const u64* __restrict__ mask,
                                         int n, int W, int c, int t) {
  int row = c * NMS_CHUNK + t;
  return row < n ? mask[static_cast<size_t>(row) * W + c] : 0;
}

__global__ void __launch_bounds__(NMS_SWEEP_THREADS)
nms_sweep_kernel(const u64* __restrict__ live, const u64* __restrict__ mask,
                 const u64* __restrict__ occ,
                 const int64_t* __restrict__ order, int n, int W, int W2,
                 bool* __restrict__ keep) {
  constexpr int T = NMS_SWEEP_THREADS;
  constexpr int LOADS = 4;           // mask words a thread has in flight
  extern __shared__ u64 removed[];   // W words
  __shared__ u64 diag[2][NMS_CHUNK]; // a chunk's diagonal words, the next's
  __shared__ int rows[NMS_CHUNK];    // the chunk's kept candidates, in order
  __shared__ int n_kept;
  int t = threadIdx.x;
  for (int w = t; w < W; w += T) removed[w] = ~live[w];
  if (t < NMS_CHUNK) diag[0][t] = diag_word(mask, n, W, 0, t);
  __syncthreads();
  int loaded = 0, cur = 0;           // the chunk whose words are in diag[cur]
  for (int c = 0;; ++c) {
    // removed[] is stable until the next barrier: every thread skips alike
    while (c < W && removed[c] == NMS_ALL) ++c;
    if (c >= W) break;
    if (loaded != c) {
      if (t < NMS_CHUNK) diag[cur][t] = diag_word(mask, n, W, c, t);
      __syncthreads();
    }
    const int first = c + 1;
    u64 run = 0;
    if (t < 32) {                    // warp 0, each lane the same chain
      u64 kept = 0;
      run = removed[c];
#pragma unroll 16
      for (int b = 0; b < NMS_CHUNK; ++b) {
        u64 d = diag[cur][b];
        if (!((run >> b) & 1)) {
          kept |= 1ull << b;
          run |= d;                  // bits of later candidates only
        }
      }
      for (int b = t; b < NMS_CHUNK; b += 32)
        if ((kept >> b) & 1)
          rows[__popcll(kept & ((1ull << b) - 1))] = c * NMS_CHUNK + b;
      if (t == 0) n_kept = __popcll(kept);
    } else if (t < 32 + NMS_CHUNK && first < W) {
      diag[cur ^ 1][t - 32] = diag_word(mask, n, W, first, t - 32);
    }
    __syncthreads();
    // lane 0's chain, stored once every lane has read removed[c]: its
    // clear bits are the kept candidates, and no later step writes it
    if (t == 0) removed[c] = run;
    // the kept rows' non-zero words past the chunk: a thread takes one
    // (kept row, occupancy word) pair at a time
    const int o0 = first / NMS_CHUNK, no = W2 - o0;
    const int total = first < W ? n_kept * no : 0;
    for (int q = t; q < total; q += T) {
      const int row = rows[q / no], o = o0 + q % no;
      u64 bits = occ[static_cast<size_t>(row) * W2 + o];
      if (o == o0) bits &= NMS_ALL << (first % NMS_CHUNK);
      while (bits) {
        u64 x[LOADS];
        int w[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          x[u] = 0;
          w[u] = 0;
          if (bits) {
            w[u] = o * NMS_CHUNK + __ffsll(static_cast<long long>(bits)) - 1;
            bits &= bits - 1;
            // a word already full takes nothing more: skip its load
            if (removed[w[u]] != NMS_ALL)
              x[u] = mask[static_cast<size_t>(row) * W + w[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u)
          if (x[u]) atomicOr(&removed[w[u]], x[u]);
      }
    }
    loaded = first;
    cur ^= 1;
    __syncthreads();
  }
  for (int j = t; j < n; j += T)
    keep[order[j]] = !((removed[j / NMS_CHUNK] >> (j % NMS_CHUNK)) & 1);
}

// the sweep's dynamic shared memory ceiling (bytes), read once
int sweep_smem_limit() {
  static int limit = -1;
  if (limit < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncGetAttributes(&attr, nms_sweep_kernel) != cudaSuccess)
      return 0;
    int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
    if (cudaFuncSetAttribute(nms_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dynamic) != cudaSuccess)
      return 0;
    limit = dynamic;
  }
  return limit;
}

// the mask kernel's grid: every SM full of 64-thread blocks (32 each)
int mask_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      sms = 132;
    blocks = sms * 32;
  }
  return blocks;
}

}  // namespace

extern "C" {

// The most boxes one launch takes: one bit a box of the sweep's bitmap in
// the block's dynamic shared memory (0 if the device cannot be read).
int nms_max_n() {
  return sweep_smem_limit() / static_cast<int>(sizeof(u64)) * NMS_CHUNK;
}

// boxes [n, 4] fp32 (x1, y1, x2, y2) and scores [n] fp32 in input order;
// order [n] int64, the stable descending score order; scratch: sorted
// [n, 4] fp32, live [W], mask [n, W] and occ [n, W2] 64-bit words (W =
// ceil(n / 64), W2 = ceil(W / 64)); keep [n] bool, written in input order.
int nms_sweep(const void* boxes, const void* scores, const void* order,
              int n, float iou_thr, float score_thr, void* sorted,
              void* live, void* mask, void* occ, void* keep, void* stream) {
  if (n <= 0 || n > nms_max_n())
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = (n + NMS_CHUNK - 1) / NMS_CHUNK;
  const int W2 = (W + NMS_CHUNK - 1) / NMS_CHUNK;
  const float4* sorted4 = static_cast<const float4*>(sorted);
  const u64* live64 = static_cast<const u64*>(live);
  u64* occ64 = static_cast<u64*>(occ);
  nms_gather_kernel<<<(n + NMS_GATHER_THREADS - 1) / NMS_GATHER_THREADS,
                      NMS_GATHER_THREADS, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const int64_t*>(order), n, W,
      static_cast<size_t>(n) * W2, score_thr, static_cast<float4*>(sorted),
      static_cast<u64*>(live), occ64);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long long tiles = static_cast<long long>(W + 1) * ((W + 1) / 2);
  int blocks = static_cast<int>(
      tiles < mask_blocks() ? tiles : static_cast<long long>(mask_blocks()));
  nms_mask_kernel<<<blocks, NMS_CHUNK, 0, st>>>(
      sorted4, live64, n, W, W2, iou_thr, static_cast<u64*>(mask), occ64);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<1, NMS_SWEEP_THREADS, W * sizeof(u64), st>>>(
      live64, static_cast<const u64*>(mask), occ64,
      static_cast<const int64_t*>(order), n, W, W2,
      static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
