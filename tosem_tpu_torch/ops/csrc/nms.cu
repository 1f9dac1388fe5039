// Greedy non-maximum suppression over score-sorted boxes, for Hopper
// (sm_90a), plain C interface.
//
// Replaces: no Pallas kernel. tosem_tpu/models/pointpillars.py
// `device_nms` (the `nms_cuda` role of Apollo's PointPillars) is an XLA
// program there: an IoU matrix and a `lax.fori_loop` over the sorted
// candidates. Run eagerly in torch, that loop is several launches a box
// (about 10^5 launches at the 141 x 141 grid's 19,881 boxes) over an IoU
// matrix of 1.58 GB, so the sweep is a kernel of its own.
//
// What bounds it on this card: operations, and a chain of n steps that
// cannot run in parallel. The work is one IoU (14 fp32 operations) for
// each pair (kept box i, box j > i still live at step i), which is data
// dependent; the bytes are the boxes, scores and order read once and
// `keep` written once (29 bytes a box), far below the operations. Step
// i can start only when every suppression of steps < i has landed.
//
// What the design does about it (a simple body: one block). One block
// of 1024 threads walks the sorted candidates in order. The live flags
// (score above the threshold, not yet suppressed) sit in shared memory,
// one byte a box, so a step reads them without a trip to device memory;
// the sorted boxes are gathered once into a scratch array the wrapper
// allocates, so each step reads them coalesced (from L2 after the first
// step). At step i every thread reads live[i] after the previous
// step's barrier; if box i is live, each thread clears live[j] for its
// boxes j > i whose IoU with box i exceeds the threshold, and the block
// meets at a barrier. A box never changes its own flag, and step i only
// writes flags of j > i, so when the walk ends live[] is the kept mask
// in sorted order; the block scatters it to `keep` in the input order.
// A faster body (one bitmask row a box, swept by a warp) is later work.
//
// Numerics: the IoU is the JAX package's operations in its order, with
// no contraction into FMA (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn):
// area = max(x2 - x1, 0) * max(y2 - y1, 0);
// inter = max(min(x2) - max(x1), 0) * max(min(y2) - max(y1), 0);
// iou = inter / max((area_i + area_j) - inter, 1e-9), compared with
// `iou > iou_threshold`. The plain version (ops/nms.py `nms_plain`) gives
// the same bits on the same inputs, so `keep` is compared element for
// element.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NMS_THREADS = 1024;
// live flags: one byte a box in static shared memory (48 KB)
constexpr int NMS_MAX_N = 48 * 1024;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float box_iou(float4 a, float area_a, float4 b,
                                         float area_b) {
  float x1 = fmaxf(a.x, b.x);
  float y1 = fmaxf(a.y, b.y);
  float x2 = fminf(a.z, b.z);
  float y2 = fminf(a.w, b.w);
  float inter = __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f),
                          fmaxf(__fsub_rn(y2, y1), 0.0f));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

__global__ void __launch_bounds__(NMS_THREADS)
nms_sweep_kernel(const float4* __restrict__ boxes,
                 const float* __restrict__ scores,
                 const int64_t* __restrict__ order, int n, float iou_thr,
                 float score_thr, float4* __restrict__ sorted,
                 unsigned char* __restrict__ keep) {
  __shared__ unsigned char live[NMS_MAX_N];
  for (int j = threadIdx.x; j < n; j += NMS_THREADS) {
    int64_t src = order[j];
    sorted[j] = boxes[src];
    live[j] = scores[src] > score_thr ? 1 : 0;
  }
  __syncthreads();     // the block's global writes are visible after it
  for (int i = 0; i < n; ++i) {
    if (!live[i]) continue;          // the same branch in every thread
    float4 bi = sorted[i];
    float ai = box_area(bi);
    for (int j = i + 1 + threadIdx.x; j < n; j += NMS_THREADS) {
      if (live[j]) {
        float4 bj = sorted[j];
        if (box_iou(bi, ai, bj, box_area(bj)) > iou_thr) live[j] = 0;
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += NMS_THREADS) keep[order[j]] = live[j];
}

}  // namespace

extern "C" {

int nms_max_n() { return NMS_MAX_N; }

// boxes [n, 4] fp32 (x1, y1, x2, y2) and scores [n] fp32 in input order;
// order [n] int64, the stable descending score order; sorted [n, 4] fp32
// scratch; keep [n] bool, written in input order.
int nms_sweep(const void* boxes, const void* scores, const void* order,
              int n, float iou_thr, float score_thr, void* sorted,
              void* keep, void* stream) {
  if (n <= 0 || n > NMS_MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  nms_sweep_kernel<<<1, NMS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const int64_t*>(order), n, iou_thr, score_thr,
      static_cast<float4*>(sorted), static_cast<unsigned char*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
