// Flash attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces: tosem_tpu/ops/flash_attention.py `_bwd_dkv_kernel` (B2) and
// `_bwd_dq_kernel` (B3), the two Pallas kernels that `_flash_bwd` launches
// after computing Delta = rowsum(dO * O) in plain XLA. Delta is computed
// in torch here too (ops/flash_attention.py), and the forward's LSE
// [B,H,Tq] fp32 comes from csrc/flash_fwd.cu.
//
// With s = scale * q.k (masked to -1e30), p = exp(s - LSE),
// dp = dO.v and ds = p * (dp - Delta):
//   flash_bwd_dkv (B2): per key row, dV = sum_q bf(p) dO and
//                       dK = sum_q bf(ds * scale) q;
//   flash_bwd_dq  (B3): per query row, dQ = scale * sum_k bf(ds) k,
// where bf() rounds to the input dtype, as the reference casts p and ds
// before its dots. Modes: dense, causal (key <= query, top-left aligned,
// as in flash_fwd.cu) and segment ids (attend where q-id == kv-id), in
// any combination, or the block schedule of a mask program
// (`flash_bwd_dkv_sched` / `flash_bwd_dq_sched`, the reference kernels'
// `scheduled=True` path) with or without segment ids; Q/K/V/dO and the
// gradients are addressed through (batch, time, head) strides with a
// contiguous head dimension, so the [B,H,T,D] and [B,T,H,D] layouts both
// run without a transposed copy.
//
// Schedule mode (ops/mask_programs.py compiles it; Tq, Tk multiples of
// 64): head h reads schedule row hs = min(h, Hs-1). dQ walks the q-major
// `dq` schedule over K/V tiles, as flash_fwd.cu does. dK/dV walks the
// kv-major `dkv` schedule: its resident rows are keys and the entries
// name query tiles. The bitmaps keep (query row, key column) orientation
// in both majors (one 64-bit word per query row, key j at bit j), so a
// dK/dV block stages the 64 words of a PARTIAL entry in shared memory and
// resident key r reads bit r of streamed query i's word. KIND_FULL
// entries skip the compare; segment ids refine after the bitmap. Entries
// run in ascending order, the dense loop's order.
//
// What bounds it on this card: B2 does 8*B*H*Tq*Tk*d operations (four
// products per visible pair) and B3 6*B*H*Tq*Tk*d, over about
// 9*B*H*T*d bytes of bf16 operands and gradients. At the training shape
// [8,512,12,64] that is ~12.9 and ~9.7 GFLOP over ~38 and ~32 MB: the
// operations bound both, at ~0.013 and ~0.010 ms on the tensor cores.
//
// The bf16 design (FlashAttention-2's backward on mma.sync, as
// csrc/flash_fwd.cu's forward): one block of 4 warps per (64-row
// resident tile, batch*head), each warp owning 16 resident rows, every
// product an mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 on fragments
// loaded by ldmatrix, so every product stays inside its warp:
// - dQ (B3) keeps Q and dO as the A fragments of S = Q K^T and dP = dO V^T
//   (loaded once), and LSE and Delta of the thread's two rows in
//   registers; per 16 keys of a streamed K/V tile it forms S and dP in
//   registers, dS = P (dP - Delta) with P = 2^(S scale log2 e - LSE log2
//   e), rounds dS to bf16 and repacks it from the accumulator layout into
//   the A layout, and adds dS K to the fp32 dQ accumulators (K read by
//   ldmatrix.trans). The scale multiplies the sum once, at the store.
// - dK/dV (B2) works in the transposed scores, so that the resident keys
//   are the rows: K and V are the A fragments of S^T = K Q^T and dP^T =
//   V dO^T, Q and dO of a streamed tile the B operands (plain ldmatrix);
//   P^T and dS^T scale are rounded to bf16 and repacked as above, then
//   dV += P^T dO and dK += (dS^T scale) Q take dO and Q by
//   ldmatrix.trans. LSE, Delta (read per column) and the q segment ids
//   arrive with their tile; dK and dV stay in fp32 registers until the
//   epilogue writes them once.
// - A tile is worked 16 streamed rows at a time, so the scores of only
//   two n-blocks are live; no score tile goes through shared memory.
// - The streamed tiles arrive by 16-byte cp.async.cg (4-byte for the
//   statistics and ids) into a double buffer: tile t+1 loads while tile t
//   computes, one commit / wait_group 0 / barrier a tile. Rows are padded
//   by 16 bytes so that ldmatrix is free of bank conflicts. A row past
//   the end is zero-filled (src-size 0).
// - 2^x by one SFU instruction (ex2.approx) on scores pre-multiplied by
//   scale*log2(e). A masked score is -1e30 after the fold, and an LSE of
//   -1e30 (a row that sees no key: the forward's finite average) stays
//   -1e30, so such a row's p is exp(-1e30 - (-1e30)) = 1 for each of its
//   keys, as in the reference; a key past Tk (dQ) or a query past Tq
//   (dK/dV) is -inf, so it never counts.
// - Masks are per-fragment predicates, each applied only on a tile that
//   needs it (block-uniform branches), in this order: the causal compare
//   (a tile that crosses the diagonal), the schedule's PARTIAL bitmap, the
//   segment ids, the ragged edge. The bitmaps keep (query row, key
//   column) orientation in both majors, so dK/dV stages the 64 words of a
//   PARTIAL entry with its tile and reads bit `key` of word `query`.
// - The heaviest tiles launch first: batch*head is blockIdx.x, the
//   resident tiles blockIdx.y. dQ walks its q tiles from the last (causal
//   rows grow with the tile); dK/dV its key tiles from the first (causal
//   key tile 0 sees every q tile); schedule mode follows `order` (the
//   resident tiles by descending entry count, ops/flash_attention.py).
//   Within a block the streamed tiles stay ascending.
// The operands must start on 16 bytes with (batch, time, head) strides
// that are multiples of 8 elements (ops/flash_attention.py checks).
//
// fp32 keeps the CUDA-core body below (the tensor cores have no
// full-fp32 product, and TF32 keeps about three digits where the fp32
// runs are the parity checks): one block per (64-row tile, batch*head),
// D/16 threads sharing one row (16 elements each), so a thread holds the
// row's slices of two operands and of one or two fp32 accumulators in
// registers; the dot products over d end in a butterfly of warp shuffles.
// The streamed tiles (K/V for dQ, Q/dO/LSE/Delta for dK/dV) go through
// shared memory once per block. A causal dQ block stops at its diagonal
// tile, a causal dKV block starts at the query tile holding its first key
// row, and only a tile that crosses the diagonal pays the causal compare.
// Ragged Tq/Tk are masked here, so no length has to tile. A schedule
// takes the place of the tile counter (a template flag) and cuts the
// work to the executed fraction of the tile grid.
//
// Numerics follow the reference kernels: operands stay in the input
// dtype (bf16 products are exact in fp32), scores and statistics are
// fp32, masked scores are -1e30, P is rounded to the input dtype before
// dV, dS*scale before dK, and dS before dQ with the scale applied after
// the sum.
//
// Determinism: every output element is written by one thread after a
// loop in a fixed order; there are no atomics, and dQ is its own kernel
// (as in the reference), so two launches on the same inputs agree bit
// for bit, in schedule mode too.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BR = 64;   // resident rows per block (queries for dQ, keys for dKV)
constexpr int BS = 64;   // streamed rows per tile
constexpr int EPT = 16;  // elements of a row each thread holds
constexpr float NEG_INF = -1e30f;
constexpr int KIND_PARTIAL = 2;  // ops/mask_programs.py

// ------------------------------------------------ fp32: the CUDA cores
// (The generic T of the body below is float only; bf16 runs the
// tensor-core bodies further down.)

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
// round to the input dtype and back (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Strides {
  long long b, t, h;
};

// A block schedule on the device (q-major for dQ, kv-major for dK/dV):
// num [Hs, n_major], blk / kind / mid [Hs, n_major, L] int32, bits
// [M, 64] 64-bit bitmap rows (one per query row), and the launch order
// of the resident tiles, order [n_major] (bf16 bodies only).
struct Sched {
  const int* num;
  const int* blk;
  const int* kind;
  const int* mid;
  const unsigned long long* bits;
  const int* order;
  int Hs, n_major, L;
};

// The number of streamed tiles of resident tile `major`'s schedule row,
// and the row's offset into blk/kind/mid.
__device__ __forceinline__ int sched_row(const Sched& sc, int h, int major,
                                         long long* srow) {
  const long long r = (long long)min(h, sc.Hs - 1) * sc.n_major + major;
  *srow = r * sc.L;
  return sc.num[r];
}

// Element e of thread slice `sl` (of TPR) for register index i in
// [0, EPT): the row is cut into float4 chunks dealt round-robin to the
// TPR threads, so chunk c of a thread is float4 number c*TPR + sl.
template <int TPR>
__device__ __forceinline__ int elem(int sl, int i) {
  return ((i >> 2) * TPR + sl) * 4 + (i & 3);
}

// Sum over the TPR consecutive lanes that share a row. The xor butterfly
// leaves the same value on every lane of the group (fp addition is
// commutative), so no broadcast is needed.
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dot of a register slice with the same slice of a shared-memory fp32 row
template <int TPR>
__device__ __forceinline__ float dot_slice(const float* reg,
                                           const float* srow, int sl) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < EPT / 4; ++c) {
    const float4 x = s4[c * TPR + sl];
    a = fmaf(reg[4 * c + 0], x.x, a);
    a = fmaf(reg[4 * c + 1], x.y, a);
    a = fmaf(reg[4 * c + 2], x.z, a);
    a = fmaf(reg[4 * c + 3], x.w, a);
  }
  return a;
}

// acc += w * (the thread's slice of a shared-memory fp32 row)
template <int TPR>
__device__ __forceinline__ void axpy_slice(float* acc, float w,
                                           const float* srow, int sl) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
#pragma unroll
  for (int c = 0; c < EPT / 4; ++c) {
    const float4 x = s4[c * TPR + sl];
    acc[4 * c + 0] = fmaf(w, x.x, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
  }
}

template <typename T, int TPR>
__device__ __forceinline__ void load_slice(float* reg, const T* row, int sl,
                                           bool live) {
#pragma unroll
  for (int i = 0; i < EPT; ++i)
    reg[i] = live ? to_f(row[elem<TPR>(sl, i)]) : 0.f;
}

template <typename T, int TPR>
__device__ __forceinline__ void store_slice(T* row, const float* reg,
                                            float mul, int sl) {
#pragma unroll
  for (int i = 0; i < EPT; ++i) row[elem<TPR>(sl, i)] = from_f<T>(reg[i] * mul);
}

// Stage rows [t0, t0+n) of one (b, h) of x into shared memory as fp32.
template <typename T, int D, int NT>
__device__ __forceinline__ void stage_tile(float* dst, const T* x,
                                           Strides s, int b, int h, int t0,
                                           int n, int tid) {
  for (int e = tid; e < BS * D; e += NT) {
    const int j = e / D;
    const int d = e % D;
    if (j < n)
      dst[e] = to_f(x[b * s.b + (long long)(t0 + j) * s.t + h * s.h + d]);
  }
}

// B3: dQ. One block per (64-query tile, b*h); K/V tiles stream.
template <typename T, int D, bool SCHED>
__global__ void __launch_bounds__(BR * (D / EPT))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, T* __restrict__ dq, int H,
                    int Tq, int Tk, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdq, float scale, int causal,
                    Sched sc) {
  constexpr int TPR = D / EPT;
  constexpr int NT = BR * TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);   // [BS][D]
  float* vs = ks + BS * D;                          // [BS][D]
  int* kseg_s = reinterpret_cast<int*>(vs + BS * D);  // [BS]

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sl = tid % TPR;
  const int q0 = blockIdx.x * BR;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int row = q0 + r;
  const bool live = row < Tq;
  const int rr = live ? row : 0;

  float qr[EPT], dor[EPT], acc[EPT];
  load_slice<T, TPR>(qr, q + b * sq.b + (long long)rr * sq.t + h * sq.h, sl,
                     live);
  load_slice<T, TPR>(dor, dout + b * sdo.b + (long long)rr * sdo.t +
                              h * sdo.h, sl, live);
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = 0.f;
  const long long stat = ((long long)b * H + h) * Tq + rr;
  const float lse_r = live ? lse[stat] : 0.f;
  const float dlt = live ? delta[stat] : 0.f;
  const int qs_row = (qseg != nullptr && live) ? qseg[(long long)b * Tq + row]
                                               : 0;

  int n_tiles = (Tk + BS - 1) / BS;
  long long srow = 0;
  if constexpr (SCHED) {
    n_tiles = sched_row(sc, h, blockIdx.x, &srow);
  } else if (causal) {
    const int last_row = min(q0 + BR, Tq) - 1;
    n_tiles = min(last_row, Tk - 1) / BS + 1;
  }

  for (int it = 0; it < n_tiles; ++it) {
    int kt = it;
    bool partial = false;
    unsigned long long bits = 0ull;
    if constexpr (SCHED) {
      kt = sc.blk[srow + it];
      partial = sc.kind[srow + it] == KIND_PARTIAL;
      if (partial) bits = sc.bits[(long long)sc.mid[srow + it] * BR + r];
    }
    const int k0 = kt * BS;
    const int kn = min(BS, Tk - k0);
    stage_tile<T, D, NT>(ks, k, sk, b, h, k0, kn, tid);
    stage_tile<T, D, NT>(vs, v, sv, b, h, k0, kn, tid);
    if (kseg != nullptr)
      for (int j = tid; j < kn; j += NT)
        kseg_s[j] = kseg[(long long)b * Tk + k0 + j];
    __syncthreads();

    // a tile needs the causal compare only where it crosses the diagonal
    const bool diag = causal && (k0 + kn - 1 > q0);
    for (int j = 0; j < kn; ++j) {
      float s = row_sum<TPR>(dot_slice<TPR>(qr, ks + j * D, sl)) * scale;
      const float dp = row_sum<TPR>(dot_slice<TPR>(dor, vs + j * D, sl));
      if (diag && k0 + j > row) s = NEG_INF;
      if (SCHED && partial && !((bits >> j) & 1ull)) s = NEG_INF;
      if (kseg != nullptr && kseg_s[j] != qs_row) s = NEG_INF;
      const float p = expf(s - lse_r);
      const float ds = round_to<T>(p * (dp - dlt));
      axpy_slice<TPR>(acc, ds, ks + j * D, sl);
    }
    __syncthreads();
  }

  if (live)
    store_slice<T, TPR>(dq + b * sdq.b + (long long)row * sdq.t + h * sdq.h,
                        acc, scale, sl);
}

// B2: dK and dV. One block per (64-key tile, b*h); Q/dO/LSE/Delta stream.
// The body, shared by the dense-mode and schedule-mode entry points below.
template <typename T, int D, bool SCHED>
__device__ __forceinline__ void flash_bwd_dkv_body(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
    Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
    Strides sdv, float scale, int causal, Sched sc) {
  constexpr int TPR = D / EPT;
  constexpr int NT = BR * TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [BS][D]
  float* dos = qs + BS * D;                         // [BS][D]
  float* lse_s = dos + BS * D;                      // [BS]
  float* dlt_s = lse_s + BS;                        // [BS]
  int* qseg_s = reinterpret_cast<int*>(dlt_s + BS);   // [BS]
  // [BS] bitmap words of the current PARTIAL entry (schedule mode)
  unsigned long long* bits_s =
      reinterpret_cast<unsigned long long*>(qseg_s + BS);

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sl = tid % TPR;
  const int k0 = blockIdx.x * BR;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int key = k0 + r;
  const bool live = key < Tk;
  const int kk = live ? key : 0;

  float kr[EPT], vr[EPT], dka[EPT], dva[EPT];
  load_slice<T, TPR>(kr, k + b * sk.b + (long long)kk * sk.t + h * sk.h, sl,
                     live);
  load_slice<T, TPR>(vr, v + b * sv.b + (long long)kk * sv.t + h * sv.h, sl,
                     live);
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  const int ks_key = (kseg != nullptr && live) ? kseg[(long long)b * Tk + key]
                                               : 0;
  const long long stat0 = ((long long)b * H + h) * Tq;

  // a causal key tile sees only queries at or below its first key row
  int first = causal ? k0 / BS : 0;
  int n_tiles = (Tq + BS - 1) / BS;
  long long srow = 0;
  if constexpr (SCHED) {
    first = 0;
    n_tiles = sched_row(sc, h, blockIdx.x, &srow);
  }
  for (int it = first; it < n_tiles; ++it) {
    int qt = it;
    bool partial = false;
    if constexpr (SCHED) {
      qt = sc.blk[srow + it];
      partial = sc.kind[srow + it] == KIND_PARTIAL;
      if (partial) {
        const unsigned long long* words =
            sc.bits + (long long)sc.mid[srow + it] * BS;
        for (int i = tid; i < BS; i += NT) bits_s[i] = words[i];
      }
    }
    const int q0 = qt * BS;
    const int qn = min(BS, Tq - q0);
    stage_tile<T, D, NT>(qs, q, sq, b, h, q0, qn, tid);
    stage_tile<T, D, NT>(dos, dout, sdo, b, h, q0, qn, tid);
    for (int i = tid; i < qn; i += NT) {
      lse_s[i] = lse[stat0 + q0 + i];
      dlt_s[i] = delta[stat0 + q0 + i];
      if (qseg != nullptr) qseg_s[i] = qseg[(long long)b * Tq + q0 + i];
    }
    __syncthreads();

    const bool diag = causal && (q0 < k0 + BR - 1);
    for (int i = 0; i < qn; ++i) {
      const float* qrow = qs + i * D;
      const float* dorow = dos + i * D;
      float s = row_sum<TPR>(dot_slice<TPR>(kr, qrow, sl)) * scale;
      const float dp = row_sum<TPR>(dot_slice<TPR>(vr, dorow, sl));
      if (diag && q0 + i < key) s = NEG_INF;
      if (SCHED && partial && !((bits_s[i] >> r) & 1ull)) s = NEG_INF;
      if (qseg != nullptr && qseg_s[i] != ks_key) s = NEG_INF;
      const float p = expf(s - lse_s[i]);
      axpy_slice<TPR>(dva, round_to<T>(p), dorow, sl);
      const float ds = round_to<T>(p * (dp - dlt_s[i]) * scale);
      axpy_slice<TPR>(dka, ds, qrow, sl);
    }
    __syncthreads();
  }

  if (live) {
    store_slice<T, TPR>(dk + b * sdk.b + (long long)key * sdk.t + h * sdk.h,
                        dka, 1.f, sl);
    store_slice<T, TPR>(dv + b * sdv.b + (long long)key * sdv.t + h * sdv.h,
                        dva, 1.f, sl);
  }
}

#define TOSEM_DKV_PARAMS                                                   \
  const T *__restrict__ q, const T *__restrict__ k,                       \
      const T *__restrict__ v, const T *__restrict__ dout,                \
      const float *__restrict__ lse, const float *__restrict__ delta,     \
      const int *__restrict__ qseg, const int *__restrict__ kseg,         \
      T *__restrict__ dk, T *__restrict__ dv, int H, int Tq, int Tk,      \
      Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,       \
      Strides sdv, float scale, int causal, Sched sc
#define TOSEM_DKV_ARGS                                                    \
  q, k, v, dout, lse, delta, qseg, kseg, dk, dv, H, Tq, Tk, sq, sk, sv, \
      sdo, sdk, sdv, scale, causal, sc

template <typename T, int D>
__global__ void __launch_bounds__(BR * (D / EPT))
flash_bwd_dkv_kernel(TOSEM_DKV_PARAMS) {
  flash_bwd_dkv_body<T, D, false>(TOSEM_DKV_ARGS);
}

// Schedule mode's extra state (the PARTIAL entry's bitmap words) took the
// D = 64 body from 128 registers to 185: one 256-thread block an SM
// instead of two. Its entry point asks for the dense mode's occupancy,
// 128 registers a thread (2, 4 or 8 blocks of 4*D threads). (The floor
// stays off the dense entry point: any explicit floor, even 1, changes how
// ptxas allocates it.)
template <typename T, int D>
__global__ void __launch_bounds__(BR * (D / EPT), 128 / D)
flash_bwd_dkv_sched_kernel(TOSEM_DKV_PARAMS) {
  flash_bwd_dkv_body<T, D, true>(TOSEM_DKV_ARGS);
}

// ------------------------------------------- bf16: the tensor cores

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;   // 4 warps, 16 resident rows each
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes from global to shared memory; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a * b on one m16n8k16 tile: a in the A layout (4 registers of
// bf16 pairs), b0/b1 in the B ("col") layout, c four fp32 values
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the SFU's one instruction (max relative error ~2^-22; results
// below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// an LSE in log2 units; -1e30 (a row that sees no key) stays -1e30
__device__ __forceinline__ float lse_log2(float x) {
  return x <= NEG_INF ? NEG_INF : x * LOG2E;
}

// The four m16n8 accumulators of 16 streamed columns (two n-blocks),
// rounded to bf16 in the A layout of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// 64 rows of D bf16 from global memory (row r at src + r * row_stride)
// into shared memory at a stride of D + 8; rows at or past n are zeros
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int n) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int e = threadIdx.x; e < BS * CPR; e += TC_THREADS) {
    const int j = e / CPR;
    const int c = e % CPR;
    const bool in = j < n;
    cp_async16(dst + j * LD + c * 8, src + (in ? j : 0) * row_stride + c * 8,
               in ? 16 : 0);
  }
}

// 32-bit element t < 64 of a row of n into shared memory (zero past n)
__device__ __forceinline__ void load_word(void* dst, const void* src, int n,
                                          int t) {
  const bool in = t < n;
  cp_async4(static_cast<char*>(dst) + 4 * t,
            static_cast<const char*>(src) + 4 * (in ? t : 0), in ? 4 : 0);
}

// the shared-memory bytes of the bf16 bodies: two resident tiles and two
// double-buffered streamed ones, rows padded by 16 bytes; dQ adds the kv
// segment ids of both buffers, dK/dV their LSE, Delta and q segment ids
// and, in schedule mode, the bitmap words of a PARTIAL entry
template <int D>
constexpr size_t dq_tc_smem() {
  return 6 * BS * (D + 8) * sizeof(bf16) + 2 * BS * sizeof(int);
}

template <int D, bool SCHED>
constexpr size_t dkv_tc_smem() {
  return 6 * BS * (D + 8) * sizeof(bf16) + 6 * BS * sizeof(float) +
         (SCHED ? 2 * BS * sizeof(unsigned long long) : 0);
}

// B3, bf16: dQ. One block per (64-query tile, b*h); K/V tiles stream.
template <int D, bool SCHED>
__device__ __forceinline__ void flash_bwd_dq_tc_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    bf16* __restrict__ dq, int H, int Tq, int Tk, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdq, float scale, int causal,
    Sched sc) {
  constexpr int LD = D + 8;        // padded row, in elements
  constexpr int TILE = BS * LD;
  constexpr int NO = D / 8;        // n-blocks of a dQ row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // [BR][LD]
  bf16* dos = qs + TILE;                                    // [BR][LD]
  bf16* ks = dos + TILE;                                    // [2][BS][LD]
  bf16* vs = ks + 2 * TILE;                                 // [2][BS][LD]
  int* kseg_s = reinterpret_cast<int*>(vs + 2 * TILE);      // [2][BS]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  int qt;
  if constexpr (SCHED) {
    qt = sc.order[blockIdx.y];
  } else {
    qt = gridDim.y - 1 - blockIdx.y;
  }
  const int q0 = qt * BR;
  const int lr = warp * 16 + lane / 4;  // this thread's rows: lr, lr + 8
  const int r0 = q0 + lr;
  const int r1 = r0 + 8;
  const int c0 = 2 * (lane % 4);        // its first column of an n-block

  int n_tiles = (Tk + BS - 1) / BS;
  long long srow = 0;
  if constexpr (SCHED) {
    n_tiles = sched_row(sc, h, qt, &srow);
  } else if (causal) {
    n_tiles = min(min(q0 + BR, Tq) - 1, Tk - 1) / BS + 1;
  }
  const bf16* kbase = k + b * sk.b + h * sk.h;
  const bf16* vbase = v + b * sv.b + h * sv.h;
  const int* kseg_b = kseg == nullptr ? nullptr : kseg + (long long)b * Tk;

  auto tile_of = [&](int it) {
    if constexpr (SCHED)
      return sc.blk[srow + it];
    else
      return it;
  };
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BS;
    const int kn = min(BS, Tk - k0);
    load_rows<D>(ks + buf * TILE, kbase + k0 * sk.t, sk.t, kn);
    load_rows<D>(vs + buf * TILE, vbase + k0 * sv.t, sv.t, kn);
    if (kseg_b != nullptr && tid < BS)
      load_word(kseg_s + buf * BS, kseg_b + k0, kn, tid);
  };

  // prologue: Q, dO and the first K/V tile, one cp.async group
  const int qn = min(BR, Tq - q0);
  load_rows<D>(qs, q + b * sq.b + q0 * sq.t + h * sq.h, sq.t, qn);
  load_rows<D>(dos, dout + b * sdo.b + q0 * sdo.t + h * sdo.h, sdo.t, qn);
  if (n_tiles > 0) load_kv(tile_of(0), 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qa[D / 16][4], da[D / 16][4];   // Q and dO as A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
    ldsm_x4(qa[kk], qs + off);
    ldsm_x4(da[kk], dos + off);
  }
  const long long stat = ((long long)b * H + h) * Tq;
  const float L0 = r0 < Tq ? lse_log2(lse[stat + r0]) : 0.f;
  const float L1 = r1 < Tq ? lse_log2(lse[stat + r1]) : 0.f;
  const float dl0 = r0 < Tq ? delta[stat + r0] : 0.f;
  const float dl1 = r1 < Tq ? delta[stat + r1] : 0.f;
  const int qs0 = (qseg != nullptr && r0 < Tq) ? qseg[(long long)b * Tq + r0]
                                                : 0;
  const int qs1 = (qseg != nullptr && r1 < Tq) ? qseg[(long long)b * Tq + r1]
                                                : 0;
  const float scale2 = scale * LOG2E;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // At the top of tile it, tile it's copies are waited for and a barrier
  // makes them visible and ends every warp's reads of tile it-1; only
  // then is tile it+1 issued into the buffer tile it-1 used.
  for (int it = 0; it < n_tiles; ++it) {
    if (it > 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    const int buf = it & 1;
    if (it + 1 < n_tiles) load_kv(tile_of(it + 1), buf ^ 1);
    cp_async_commit();

    const int k0 = tile_of(it) * BS;
    const int kn = min(BS, Tk - k0);
    const bf16* kb = ks + buf * TILE;
    const bf16* vb = vs + buf * TILE;
    const int* kid_s = kseg_s + buf * BS;
    const bool diag = causal && (k0 + kn - 1 > q0);
    bool partial = false;
    uint32_t hb[4] = {0u, 0u, 0u, 0u};
    if constexpr (SCHED) {
      if (sc.kind[srow + it] == KIND_PARTIAL) {
        partial = true;
        const unsigned long long* wp =
            sc.bits + (long long)sc.mid[srow + it] * BR;
        // bit c0 + 8n + {0,1} of each row's word, as 32-bit halves
        const unsigned long long w0 = wp[lr] >> c0, w1 = wp[lr + 8] >> c0;
        hb[0] = (uint32_t)w0;
        hb[1] = (uint32_t)(w0 >> 32);
        hb[2] = (uint32_t)w1;
        hb[3] = (uint32_t)(w1 >> 32);
      }
    }

#pragma unroll
    for (int kc = 0; kc < BS / 16; ++kc) {   // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] = dp[u][e] = 0.f;
      // S = Q K^T and dP = dO V^T for these 16 keys
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kc * 16 + (lane / 16) * 8 + lane % 8) * LD +
                        kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, kb + off);
        ldsm_x4(bv, vb + off);
        mma_bf16(s[0], qa[kk], bk[0], bk[1]);
        mma_bf16(s[1], qa[kk], bk[2], bk[3]);
        mma_bf16(dp[0], da[kk], bv[0], bv[1]);
        mma_bf16(dp[1], da[kk], bv[2], bv[3]);
      }
      // scale (log2 units), then each mask only on a tile that needs it
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] *= scale2;
      if (diag) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + (2 * kc + u) * 8 + c0 + (e & 1) > (e < 2 ? r0 : r1))
              s[u][e] = NEG_INF;
      }
      if constexpr (SCHED) {
        if (partial) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int n = 2 * kc + u;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!((hb[(e & 2) + n / 4] >> ((n % 4) * 8 + (e & 1))) & 1u))
                s[u][e] = NEG_INF;
          }
        }
      }
      if (kseg_b != nullptr) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int2 kid = *reinterpret_cast<const int2*>(
              kid_s + (2 * kc + u) * 8 + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (((e & 1) ? kid.y : kid.x) != (e < 2 ? qs0 : qs1))
              s[u][e] = NEG_INF;
        }
      }
      if (kn < BS) {   // keys past Tk never count: -inf
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if ((2 * kc + u) * 8 + c0 + (e & 1) >= kn)
              s[u][e] = __int_as_float(0xff800000);
      }
      // dS = P (dP - Delta), rounded to bf16 in the A layout
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[u][e] = fast_exp2(s[u][e] - (e < 2 ? L0 : L1)) *
                    (dp[u][e] - (e < 2 ? dl0 : dl1));
      uint32_t dsa[4];
      pack_a(dsa, s);
      // dQ += dS K
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, kb + (kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                   LD + n2 * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * n2], dsa, bk[0], bk[1]);
        mma_bf16(acc[2 * n2 + 1], dsa, bk[2], bk[3]);
      }
    }
  }

  bf16* qb = dq + b * sdq.b + h * sdq.h;
  if (r0 < Tq) {
    bf16* op = qb + r0 * sdq.t + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(op + n * 8) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
  }
  if (r1 < Tq) {
    bf16* op = qb + r1 * sdq.t + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(op + n * 8) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// B2, bf16: dK and dV. One block per (64-key tile, b*h); Q/dO/LSE/Delta
// stream. Rows are keys, columns queries (the transposed scores).
template <int D, bool SCHED>
__device__ __forceinline__ void flash_bwd_dkv_tc_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq, int Tk,
    Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
    Strides sdv, float scale, int causal, Sched sc) {
  constexpr int LD = D + 8;
  constexpr int TILE = BS * LD;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);            // [BR][LD]
  bf16* vs = ks + TILE;                                     // [BR][LD]
  bf16* qs = vs + TILE;                                     // [2][BS][LD]
  bf16* dos = qs + 2 * TILE;                                // [2][BS][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][BS]
  float* dlt_s = lse_s + 2 * BS;                            // [2][BS]
  int* qseg_s = reinterpret_cast<int*>(dlt_s + 2 * BS);     // [2][BS]
  // [2][BS] bitmap words of a PARTIAL entry (schedule mode)
  unsigned long long* bits_s =
      reinterpret_cast<unsigned long long*>(qseg_s + 2 * BS);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  int kt;
  if constexpr (SCHED) {
    kt = sc.order[blockIdx.y];
  } else {
    kt = blockIdx.y;
  }
  const int k0 = kt * BR;
  const int lr = warp * 16 + lane / 4;  // this thread's key rows: lr, lr + 8
  const int key0 = k0 + lr;
  const int key1 = key0 + 8;
  const int c0 = 2 * (lane % 4);        // its first query column of a block
  const int ks0 = (kseg != nullptr && key0 < Tk)
                      ? kseg[(long long)b * Tk + key0] : 0;
  const int ks1 = (kseg != nullptr && key1 < Tk)
                      ? kseg[(long long)b * Tk + key1] : 0;

  // a causal key tile sees only queries at or below its first key row
  int first = causal ? k0 / BS : 0;
  int n_tiles = (Tq + BS - 1) / BS;
  long long srow = 0;
  if constexpr (SCHED) {
    first = 0;
    n_tiles = sched_row(sc, h, kt, &srow);
  }
  const bf16* qbase = q + b * sq.b + h * sq.h;
  const bf16* dobase = dout + b * sdo.b + h * sdo.h;
  const long long stat = ((long long)b * H + h) * Tq;
  const int* qseg_b = qseg == nullptr ? nullptr : qseg + (long long)b * Tq;

  auto tile_of = [&](int it) {
    if constexpr (SCHED)
      return sc.blk[srow + it];
    else
      return it;
  };
  // Q, dO, LSE, Delta, q segment ids (and a PARTIAL entry's bitmap words)
  // of streamed entry `it` into buffer buf
  auto load_q = [&](int it, int buf) {
    const int q0 = tile_of(it) * BS;
    const int qn = min(BS, Tq - q0);
    load_rows<D>(qs + buf * TILE, qbase + q0 * sq.t, sq.t, qn);
    load_rows<D>(dos + buf * TILE, dobase + q0 * sdo.t, sdo.t, qn);
    if (tid < BS) {
      load_word(lse_s + buf * BS, lse + stat + q0, qn, tid);
      if (qseg_b != nullptr) load_word(qseg_s + buf * BS, qseg_b + q0, qn, tid);
    } else {
      load_word(dlt_s + buf * BS, delta + stat + q0, qn, tid - BS);
      if constexpr (SCHED) {
        const int i = tid - BS;   // 32 threads copy the 64 words
        if (i < BS / 2 && sc.kind[srow + it] == KIND_PARTIAL)
          cp_async16(bits_s + buf * BS + 2 * i,
                     sc.bits + (long long)sc.mid[srow + it] * BS + 2 * i, 16);
      }
    }
  };

  // prologue: K, V and the first streamed tile, one cp.async group
  const int kn = min(BR, Tk - k0);
  load_rows<D>(ks, k + b * sk.b + k0 * sk.t + h * sk.h, sk.t, kn);
  load_rows<D>(vs, v + b * sv.b + k0 * sv.t + h * sv.h, sv.t, kn);
  if (first < n_tiles) load_q(first, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t ka[D / 16][4], va[D / 16][4];   // K and V as A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
    ldsm_x4(ka[kk], ks + off);
    ldsm_x4(va[kk], vs + off);
  }
  const float scale2 = scale * LOG2E;
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = first; it < n_tiles; ++it) {
    if (it > first) {
      cp_async_wait_all();
      __syncthreads();
    }
    const int buf = (it - first) & 1;
    if (it + 1 < n_tiles) load_q(it + 1, buf ^ 1);
    cp_async_commit();

    const int q0 = tile_of(it) * BS;
    const int qn = min(BS, Tq - q0);
    const bf16* qb = qs + buf * TILE;
    const bf16* db = dos + buf * TILE;
    const float* ls = lse_s + buf * BS;
    const float* dl = dlt_s + buf * BS;
    const int* qid_s = qseg_s + buf * BS;
    const unsigned long long* bw = bits_s + buf * BS;
    const bool diag = causal && (q0 < k0 + BR - 1);
    bool partial = false;
    if constexpr (SCHED) partial = sc.kind[srow + it] == KIND_PARTIAL;

#pragma unroll
    for (int qc = 0; qc < BS / 16; ++qc) {   // 16 queries at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] = dp[u][e] = 0.f;
      // S^T = K Q^T and dP^T = V dO^T for these 16 queries
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (qc * 16 + (lane / 16) * 8 + lane % 8) * LD +
                        kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t bq[4], bd[4];
        ldsm_x4(bq, qb + off);
        ldsm_x4(bd, db + off);
        mma_bf16(s[0], ka[kk], bq[0], bq[1]);
        mma_bf16(s[1], ka[kk], bq[2], bq[3]);
        mma_bf16(dp[0], va[kk], bd[0], bd[1]);
        mma_bf16(dp[1], va[kk], bd[2], bd[3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] *= scale2;
      if (diag) {   // the tile crosses the diagonal: key > query is masked
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q0 + (2 * qc + u) * 8 + c0 + (e & 1) < (e < 2 ? key0 : key1))
              s[u][e] = NEG_INF;
      }
      if constexpr (SCHED) {
        if (partial) {   // bit `key` of query word `column`
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(
                bw + (2 * qc + u) * 8 + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!((((e & 1) ? w.y : w.x) >> (lr + (e & 2) * 4)) & 1ull))
                s[u][e] = NEG_INF;
          }
        }
      }
      if (qseg_b != nullptr) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int2 qid = *reinterpret_cast<const int2*>(
              qid_s + (2 * qc + u) * 8 + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (((e & 1) ? qid.y : qid.x) != (e < 2 ? ks0 : ks1))
              s[u][e] = NEG_INF;
        }
      }
      if (qn < BS) {   // queries past Tq never count: -inf
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if ((2 * qc + u) * 8 + c0 + (e & 1) >= qn)
              s[u][e] = __int_as_float(0xff800000);
      }
      // P^T and dS^T scale, per query column's LSE and Delta
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = (2 * qc + u) * 8 + c0;
        const float2 lq = *reinterpret_cast<const float2*>(ls + col);
        const float2 dlq = *reinterpret_cast<const float2*>(dl + col);
        const float lc[2] = {lse_log2(lq.x), lse_log2(lq.y)};
        const float dc[2] = {dlq.x, dlq.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(s[u][e] - lc[e & 1]);
          s[u][e] = p;
          dp[u][e] = p * (dp[u][e] - dc[e & 1]) * scale;
        }
      }
      uint32_t pa[4], dsa[4];
      pack_a(pa, s);
      pack_a(dsa, dp);
      // dV += P^T dO and dK += (dS^T scale) Q
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        const int off = (qc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                        n2 * 16 + (lane / 16) * 8;
        uint32_t bd[4], bq[4];
        ldsm_x4_trans(bd, db + off);
        ldsm_x4_trans(bq, qb + off);
        mma_bf16(dva[2 * n2], pa, bd[0], bd[1]);
        mma_bf16(dva[2 * n2 + 1], pa, bd[2], bd[3]);
        mma_bf16(dka[2 * n2], dsa, bq[0], bq[1]);
        mma_bf16(dka[2 * n2 + 1], dsa, bq[2], bq[3]);
      }
    }
  }

  bf16* dkb = dk + b * sdk.b + h * sdk.h;
  bf16* dvb = dv + b * sdv.b + h * sdv.h;
  if (key0 < Tk) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * sdk.t + n * 8 + c0) =
          pack_bf16(dka[n][0], dka[n][1]);
      *reinterpret_cast<uint32_t*>(dvb + key0 * sdv.t + n * 8 + c0) =
          pack_bf16(dva[n][0], dva[n][1]);
    }
  }
  if (key1 < Tk) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * sdk.t + n * 8 + c0) =
          pack_bf16(dka[n][2], dka[n][3]);
      *reinterpret_cast<uint32_t*>(dvb + key1 * sdv.t + n * 8 + c0) =
          pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

#define TOSEM_DQ_TC_PARAMS                                                 \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                 \
      const bf16 *__restrict__ v, const bf16 *__restrict__ dout,          \
      const float *__restrict__ lse, const float *__restrict__ delta,     \
      const int *__restrict__ qseg, const int *__restrict__ kseg,         \
      bf16 *__restrict__ dq, int H, int Tq, int Tk, Strides sq,           \
      Strides sk, Strides sv, Strides sdo, Strides sdq, float scale,      \
      int causal, Sched sc
#define TOSEM_DQ_ARGS                                                     \
  q, k, v, dout, lse, delta, qseg, kseg, dq, H, Tq, Tk, sq, sk, sv, sdo, \
      sdq, scale, causal, sc
#define TOSEM_DKV_TC_PARAMS                                                \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                 \
      const bf16 *__restrict__ v, const bf16 *__restrict__ dout,          \
      const float *__restrict__ lse, const float *__restrict__ delta,     \
      const int *__restrict__ qseg, const int *__restrict__ kseg,         \
      bf16 *__restrict__ dk, bf16 *__restrict__ dv, int H, int Tq,        \
      int Tk, Strides sq, Strides sk, Strides sv, Strides sdo,            \
      Strides sdk, Strides sdv, float scale, int causal, Sched sc

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_tc_kernel(TOSEM_DQ_TC_PARAMS) {
  flash_bwd_dq_tc_body<D, false>(TOSEM_DQ_ARGS);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_tc_sched_kernel(TOSEM_DQ_TC_PARAMS) {
  flash_bwd_dq_tc_body<D, true>(TOSEM_DQ_ARGS);
}

// dK/dV holds K and V fragments and both fp32 accumulators for the whole
// walk. Left to itself ptxas capped the dense D = 64 and D = 32 bodies at
// 168 and 128 registers (3 and 4 blocks an SM) and spilled; asking for 2
// blocks an SM lets them take what they need (about 217 at D = 64) with
// nothing spilled.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dkv_tc_kernel(TOSEM_DKV_TC_PARAMS) {
  flash_bwd_dkv_tc_body<D, false>(TOSEM_DKV_ARGS);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dkv_tc_sched_kernel(TOSEM_DKV_TC_PARAMS) {
  flash_bwd_dkv_tc_body<D, true>(TOSEM_DKV_ARGS);
}

// ------------------------------------------------------------ launches

template <typename K>
cudaError_t prepare(K kern, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

template <typename T, int D, bool SCHED>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* qseg,
              const void* kseg, void* dq, int B, int H, int Tq, int Tk,
              Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
              float scale, int causal, Sched sc, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    const size_t smem = dq_tc_smem<D>();
    auto kern = SCHED ? flash_bwd_dq_tc_sched_kernel<D>
                      : flash_bwd_dq_tc_kernel<D>;
    cudaError_t err = prepare(kern, smem);
    if (err != cudaSuccess) return (int)err;
    // batch*head in x, the q tiles in y: blocks start heaviest tile first
    dim3 grid(B * H, (Tq + BR - 1) / BR);
    kern<<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(qseg), static_cast<const int*>(kseg),
        static_cast<T*>(dq), H, Tq, Tk, sq, sk, sv, sdo, sdq, scale, causal,
        sc);
  } else {
    const size_t smem = 2 * BS * D * sizeof(float) + BS * sizeof(int);
    auto kern = flash_bwd_dq_kernel<T, D, SCHED>;
    cudaError_t err = prepare(kern, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Tq + BR - 1) / BR, B * H);
    kern<<<grid, BR * (D / EPT), smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(qseg), static_cast<const int*>(kseg),
        static_cast<T*>(dq), H, Tq, Tk, sq, sk, sv, sdo, sdq, scale, causal,
        sc);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D, bool SCHED>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* qseg,
               const void* kseg, void* dk, void* dv, int B, int H, int Tq,
               int Tk, Strides sq, Strides sk, Strides sv, Strides sdo,
               Strides sdk, Strides sdv, float scale, int causal, Sched sc,
               cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    const size_t smem = dkv_tc_smem<D, SCHED>();
    auto kern = SCHED ? flash_bwd_dkv_tc_sched_kernel<D>
                      : flash_bwd_dkv_tc_kernel<D>;
    cudaError_t err = prepare(kern, smem);
    if (err != cudaSuccess) return (int)err;
    // batch*head in x, the key tiles in y: blocks start heaviest tile first
    dim3 grid(B * H, (Tk + BR - 1) / BR);
    kern<<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(qseg), static_cast<const int*>(kseg),
        static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, sq, sk, sv,
        sdo, sdk, sdv, scale, causal, sc);
  } else {
    const size_t smem = 2 * BS * D * sizeof(float) +
                        2 * BS * sizeof(float) + BS * sizeof(int) +
                        (SCHED ? BS * sizeof(unsigned long long) : 0);
    auto kern = SCHED ? flash_bwd_dkv_sched_kernel<T, D>
                      : flash_bwd_dkv_kernel<T, D>;
    cudaError_t err = prepare(kern, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Tk + BR - 1) / BR, B * H);
    kern<<<grid, BR * (D / EPT), smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(qseg), static_cast<const int*>(kseg),
        static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, sq, sk, sv,
        sdo, sdk, sdv, scale, causal, sc);
  }
  return (int)cudaGetLastError();
}

#define TOSEM_DISPATCH_D(LAUNCH, T, S, ...)             \
  switch (D) {                                          \
    case 16:                                            \
      return LAUNCH<T, 16, S>(__VA_ARGS__);             \
    case 32:                                            \
      return LAUNCH<T, 32, S>(__VA_ARGS__);             \
    case 64:                                            \
      return LAUNCH<T, 64, S>(__VA_ARGS__);             \
    default:                                            \
      return (int)cudaErrorInvalidValue;                \
  }

template <typename T, bool SCHED>
int dq_d(int D, const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, const void* qseg,
         const void* kseg, void* dq, int B, int H, int Tq, int Tk, Strides sq,
         Strides sk, Strides sv, Strides sdo, Strides sdq, float scale,
         int causal, Sched sc, cudaStream_t st) {
  TOSEM_DISPATCH_D(launch_dq, T, SCHED, q, k, v, dout, lse, delta, qseg, kseg,
                   dq, B, H, Tq, Tk, sq, sk, sv, sdo, sdq, scale, causal, sc,
                   st)
}

template <typename T, bool SCHED>
int dkv_d(int D, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta,
          const void* qseg, const void* kseg, void* dk, void* dv, int B,
          int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
          Strides sdo, Strides sdk, Strides sdv, float scale, int causal,
          Sched sc, cudaStream_t st) {
  TOSEM_DISPATCH_D(launch_dkv, T, SCHED, q, k, v, dout, lse, delta, qseg,
                   kseg, dk, dv, B, H, Tq, Tk, sq, sk, sv, sdo, sdk, sdv,
                   scale, causal, sc, st)
}

template <bool SCHED>
int dq_t(int dtype, int D, const void* q, const void* k, const void* v,
         const void* dout, const void* lse, const void* delta,
         const void* qseg, const void* kseg, void* dq, int B, int H, int Tq,
         int Tk, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
         float scale, int causal, Sched sc, cudaStream_t st) {
  if (dtype == 0)
    return dq_d<float, SCHED>(D, q, k, v, dout, lse, delta, qseg, kseg, dq, B,
                              H, Tq, Tk, sq, sk, sv, sdo, sdq, scale, causal,
                              sc, st);
  if (dtype == 1)
    return dq_d<__nv_bfloat16, SCHED>(D, q, k, v, dout, lse, delta, qseg,
                                      kseg, dq, B, H, Tq, Tk, sq, sk, sv, sdo,
                                      sdq, scale, causal, sc, st);
  return (int)cudaErrorInvalidValue;
}

template <bool SCHED>
int dkv_t(int dtype, int D, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta,
          const void* qseg, const void* kseg, void* dk, void* dv, int B,
          int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
          Strides sdo, Strides sdk, Strides sdv, float scale, int causal,
          Sched sc, cudaStream_t st) {
  if (dtype == 0)
    return dkv_d<float, SCHED>(D, q, k, v, dout, lse, delta, qseg, kseg, dk,
                               dv, B, H, Tq, Tk, sq, sk, sv, sdo, sdk, sdv,
                               scale, causal, sc, st);
  if (dtype == 1)
    return dkv_d<__nv_bfloat16, SCHED>(D, q, k, v, dout, lse, delta, qseg,
                                       kseg, dk, dv, B, H, Tq, Tk, sq, sk, sv,
                                       sdo, sdk, sdv, scale, causal, sc, st);
  return (int)cudaErrorInvalidValue;
}

Sched make_sched(const void* num, const void* blk, const void* kind,
                 const void* mid, const void* bits, const void* order, int Hs,
                 int n_major, int L) {
  return Sched{static_cast<const int*>(num), static_cast<const int*>(blk),
               static_cast<const int*>(kind), static_cast<const int*>(mid),
               static_cast<const unsigned long long*>(bits),
               static_cast<const int*>(order), Hs, n_major, L};
}

// blocks of `kern` that fit on one SM with `smem` bytes of shared memory,
// or minus a CUDA error code
template <typename K>
int blocks_per_sm(K kern, size_t smem) {
  cudaError_t err = prepare(kern, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, TC_THREADS,
                                                        smem);
  return err == cudaSuccess ? n : -(int)err;
}

template <int D>
int tc_blocks_per_sm(int dkv, int sched) {
  if (dkv)
    return sched ? blocks_per_sm(flash_bwd_dkv_tc_sched_kernel<D>,
                                 dkv_tc_smem<D, true>())
                 : blocks_per_sm(flash_bwd_dkv_tc_kernel<D>,
                                 dkv_tc_smem<D, false>());
  return sched ? blocks_per_sm(flash_bwd_dq_tc_sched_kernel<D>,
                               dq_tc_smem<D>())
               : blocks_per_sm(flash_bwd_dq_tc_kernel<D>, dq_tc_smem<D>());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, as (batch,
// time, head); the head dimension is contiguous. lse and delta are
// [B,H,Tq] float32; qseg/kseg are [B,Tq]/[B,Tk] int32 or null. The bf16
// bodies copy 16-byte rows: q, k, v and dO start on 16 bytes and their
// strides are multiples of 8 (ops/flash_attention.py checks). Each
// returns cudaGetLastError() after its launch.
extern "C" int flash_bwd_dq(int dtype, int D, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, const void* qseg,
                            const void* kseg, void* dq, int B, int H, int Tq,
                            int Tk, long long sqb, long long sqt,
                            long long sqh, long long skb, long long skt,
                            long long skh, long long svb, long long svt,
                            long long svh, long long sdob, long long sdot,
                            long long sdoh, long long sdqb, long long sdqt,
                            long long sdqh, float scale, int causal,
                            void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      sdo{sdob, sdot, sdoh}, sdq{sdqb, sdqt, sdqh};
  return dq_t<false>(dtype, D, q, k, v, dout, lse, delta, qseg, kseg, dq, B,
                     H, Tq, Tk, sq, sk, sv, sdo, sdq, scale, causal, Sched{},
                     static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv(int dtype, int D, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, const void* qseg,
                             const void* kseg, void* dk, void* dv, int B,
                             int H, int Tq, int Tk, long long sqb,
                             long long sqt, long long sqh, long long skb,
                             long long skt, long long skh, long long svb,
                             long long svt, long long svh, long long sdob,
                             long long sdot, long long sdoh, long long sdkb,
                             long long sdkt, long long sdkh, long long sdvb,
                             long long sdvt, long long sdvh, float scale,
                             int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      sdo{sdob, sdot, sdoh}, sdk{sdkb, sdkt, sdkh}, sdv{sdvb, sdvt, sdvh};
  return dkv_t<false>(dtype, D, q, k, v, dout, lse, delta, qseg, kseg, dk, dv,
                      B, H, Tq, Tk, sq, sk, sv, sdo, sdk, sdv, scale, causal,
                      Sched{}, static_cast<cudaStream_t>(stream));
}

// The schedule modes: as flash_bwd_dq / flash_bwd_dkv with no causal flag
// (a mask program carries it), plus a schedule of ops/mask_programs.py at
// 64 x 64 tiles: the q-major `dq` schedule (num [Hs,Tq/64]) for dQ, the
// kv-major `dkv` schedule (num [Hs,Tk/64]) for dK/dV; blk/kind/mid
// [Hs,n_major,L] int32, bits [M,64] 64-bit words, and order [n_major]
// int32, the resident tiles heaviest first (a permutation; the bf16 body
// launches in that order). Tq and Tk must be multiples of 64.
extern "C" int flash_bwd_dq_sched(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, const void* qseg,
    const void* kseg, void* dq, int B, int H, int Tq, int Tk, long long sqb,
    long long sqt, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long sdob,
    long long sdot, long long sdoh, long long sdqb, long long sdqt,
    long long sdqh, float scale, const void* num, const void* blk,
    const void* kind, const void* mid, const void* bits, const void* order,
    int Hs, int L, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || Tq % BR || Tk % BS ||
      Hs <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      sdo{sdob, sdot, sdoh}, sdq{sdqb, sdqt, sdqh};
  return dq_t<true>(dtype, D, q, k, v, dout, lse, delta, qseg, kseg, dq, B, H,
                    Tq, Tk, sq, sk, sv, sdo, sdq, scale, 0,
                    make_sched(num, blk, kind, mid, bits, order, Hs,
                               Tq / BR, L),
                    static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv_sched(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, const void* qseg,
    const void* kseg, void* dk, void* dv, int B, int H, int Tq, int Tk,
    long long sqb, long long sqt, long long sqh, long long skb, long long skt,
    long long skh, long long svb, long long svt, long long svh,
    long long sdob, long long sdot, long long sdoh, long long sdkb,
    long long sdkt, long long sdkh, long long sdvb, long long sdvt,
    long long sdvh, float scale, const void* num, const void* blk,
    const void* kind, const void* mid, const void* bits, const void* order,
    int Hs, int L, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || Tq % BS || Tk % BR ||
      Hs <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      sdo{sdob, sdot, sdoh}, sdk{sdkb, sdkt, sdkh}, sdv{sdvb, sdvt, sdvh};
  return dkv_t<true>(dtype, D, q, k, v, dout, lse, delta, qseg, kseg, dk, dv,
                     B, H, Tq, Tk, sq, sk, sv, sdo, sdk, sdv, scale, 0,
                     make_sched(num, blk, kind, mid, bits, order, Hs,
                                Tk / BR, L),
                     static_cast<cudaStream_t>(stream));
}

// The blocks of one bf16 body that fit on an SM (dkv: 1 for dK/dV, 0 for
// dQ; sched: 1 for the schedule mode; D in {16, 32, 64}), or minus a
// CUDA error code: what the registers and shared memory of the build
// allow.
extern "C" int flash_bwd_tc_blocks_per_sm(int dkv, int sched, int D) {
  switch (D) {
    case 16:
      return tc_blocks_per_sm<16>(dkv, sched);
    case 32:
      return tc_blocks_per_sm<32>(dkv, sched);
    case 64:
      return tc_blocks_per_sm<64>(dkv, sched);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}
