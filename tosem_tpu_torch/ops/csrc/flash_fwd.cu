// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: tosem_tpu/ops/flash_attention.py `_fwd_kernel` (the Pallas
// forward kernel, B1), driven there by `_flash_fwd`.
//
// Computes O = softmax(scale * Q K^T, masked) V and LSE = m + log(l) per
// query row, with an online softmax over K/V tiles, in modes that
// compose: dense, causal (key <= query, top-left aligned) and segment ids
// (attend where q-id == kv-id), or the block schedule of a mask program
// (`flash_fwd_sched`, the reference kernel's `scheduled=True` path) with
// or without segment ids. Q/K/V/O are addressed through (batch, time,
// head) strides with a contiguous head dimension, so the [B,H,T,D] and
// [B,T,H,D] layouts both run without a transposed copy.
//
// Schedule mode (ops/mask_programs.py compiles it): for head h the block
// reads row hs = min(h, Hs-1) of the q-major schedule, so a uniform mask
// has Hs = 1 and a per-head mask Hs = H. It walks entries s < num[hs,i]
// of its q tile i, streaming K/V tile blk[hs,i,s] in ascending order (the
// dense loop's order, so FullMask and CausalMask reproduce the dense and
// causal modes bit for bit). A KIND_FULL entry skips the compare; a
// KIND_PARTIAL entry sets -1e30 where bit j of its bitmap row is 0 (one
// 64-bit word per query row, key j at bit j, packed from the reference's
// [M,64,64] int32 pool), then segment ids refine. A fully masked tile has
// one all-zero PARTIAL entry, which runs: its rows average that V tile,
// the reference's finite result. Tq and Tk are multiples of 64 here.
//
// What bounds it on this card: the work is 4*B*H*Tq*Tk*d operations over
// 8*B*H*T*d bytes of bf16 Q/K/V in and O out, i.e. T/2 operations per
// byte (T/4 causal). At the main path's T <= 512 that is at most 256,
// just under the H100's ~295 bf16 tensor-core ops/byte ridge, so the
// least time is set by the bytes, with the operations close behind; at
// T = 8192 the operations bound it. Either way the bound assumes the
// tensor cores: on the CUDA cores (~67 TFLOP/s, a ridge of ~20 ops/byte)
// the FMAs alone take ~15x longer than the bytes.
//
// The bf16 design (FlashAttention-2 on mma.sync): one block of 4 warps
// per (64-row query tile, batch*head), each warp owning 16 query rows.
// - Both products run on the tensor cores, as
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: S = Q K^T with Q's
//   fragments loaded once by ldmatrix and kept in registers for the
//   whole row, and O += P V with V read by ldmatrix.trans. D in
//   {16, 32, 64} is D/16 k-steps.
// - S stays in registers as the m16n8 accumulator fragments (a thread
//   holds rows g and g+8, g = lane/4, columns 2*(lane%4)+{0,1}+8n); the
//   row max and sum reduce over the 4 lanes of a quad by __shfl_xor_sync,
//   and P is rounded to bf16 and repacked in registers from the
//   accumulator layout into the A-operand layout of the PV product. No
//   score tile goes through shared memory.
// - 2^x by one SFU instruction (ex2.approx) on scores pre-multiplied by
//   scale*log2(e) (one multiply); a masked score is -1e30 after the fold
//   too, so a fully masked row still averages its tiles, and its LSE is
//   -1e30 as before.
// - K and V tiles arrive by 16-byte cp.async.cg into a double buffer
//   (tile t+1 loads while tile t computes; one commit/wait_group 1 a
//   tile), with rows padded by 16 bytes so that ldmatrix is free of bank
//   conflicts. A key row past Tk is zero-filled (src-size 0) and its
//   score set to -inf, so it never counts, not even in a fully masked
//   row.
// - Masks are per-fragment predicates, each applied only on a tile that
//   needs it (block-uniform branches), in this order: the causal compare
//   (a tile that crosses the diagonal), the schedule's PARTIAL bitmap (a
//   thread reads the 64-bit words of its two rows), the segment ids (kseg
//   staged in shared memory with its tile), the ragged edge.
// - The heaviest q tiles launch first: batch*head is blockIdx.x and
//   blockIdx.y walks the q tiles from the last to the first (causal
//   rows grow with the tile), or, in schedule mode, in the order of
//   `order` (descending entry count, computed once per compiled program
//   by ops/flash_attention.py). Within a row the tiles stay ascending.
//
// fp32 keeps the CUDA-core body (one thread a query row, scalar fp32
// FMAs over K/V tiles staged in shared memory; the scores of a tile go
// through shared memory). The tensor cores have no full-fp32 product,
// and TF32 keeps about three digits where the fp32 runs are the parity
// checks, held to 2e-5 against the plain version.
//
// Numerics follow the reference kernel: operands stay in the input dtype
// (bf16 products are exact in fp32), scores and row statistics are fp32,
// the scale multiplies the fp32 scores, masked scores are -1e30, the
// probabilities are rounded to the input dtype before the PV product,
// and l == 0 is read as 1.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per streamed tile
constexpr float NEG_INF = -1e30f;
constexpr int KIND_PARTIAL = 2;  // ops/mask_programs.py

struct Strides {
  long long b, t, h;
};

// A q-major block schedule on the device: num [Hs, n_major], blk / kind /
// mid [Hs, n_major, L] int32, bits [M, 64] 64-bit bitmap rows, and the
// launch order of the q tiles, order [n_major] (bf16 body only).
struct Sched {
  const int* num;
  const int* blk;
  const int* kind;
  const int* mid;
  const unsigned long long* bits;
  const int* order;
  int Hs, n_major, L;
};

// ------------------------------------------------ fp32: the CUDA cores

// One thread owns one query row. Used for T = float only.
template <typename T, int D, bool SCHED>
__device__ __forceinline__ void flash_fwd_body(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ qseg, const int* __restrict__ kseg, int H,
    int Tq, int Tk, Strides sq, Strides sk, Strides sv, Strides so,
    float scale, int causal, Sched sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);                 // [BK][D]
  T* vs = ks + BK * D;                                     // [BK][D]
  float* ss = reinterpret_cast<float*>(vs + BK * D);       // [BK][BQ]
  int* kseg_s = reinterpret_cast<int*>(ss + BK * BQ);      // [BK]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int row = q0 + tid;
  const bool live = row < Tq;

  float qr[D];
  {
    const T* qp = q + b * sq.b + (long long)(live ? row : 0) * sq.t +
                  h * sq.h;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = live ? qp[d] : 0.f;
  }
  const int qs_row = (qseg != nullptr && live) ? qseg[(long long)b * Tq + row]
                                               : 0;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  int n_tiles = (Tk + BK - 1) / BK;
  long long srow = 0;  // this block's schedule row
  if constexpr (SCHED) {
    srow = ((long long)min(h, sc.Hs - 1) * sc.n_major + blockIdx.x);
    n_tiles = sc.num[srow];
    srow *= sc.L;
  } else if (causal) {
    const int last_row = min(q0 + BQ, Tq) - 1;
    const int last_key = min(last_row, Tk - 1);
    n_tiles = last_key / BK + 1;
  }

  for (int it = 0; it < n_tiles; ++it) {
    int kt = it;
    bool partial = false;
    unsigned long long bits = 0ull;
    if constexpr (SCHED) {
      kt = sc.blk[srow + it];
      partial = sc.kind[srow + it] == KIND_PARTIAL;
      if (partial) bits = sc.bits[(long long)sc.mid[srow + it] * BQ + tid];
    }
    const int k0 = kt * BK;
    const int kn = min(BK, Tk - k0);
    for (int e = tid; e < BK * D; e += BQ) {
      const int j = e / D;
      const int d = e % D;
      if (j < kn) {
        const long long t = k0 + j;
        ks[e] = k[b * sk.b + t * sk.t + h * sk.h + d];
        vs[e] = v[b * sv.b + t * sv.t + h * sv.h + d];
      }
    }
    if (kseg != nullptr) {
      for (int j = tid; j < kn; j += BQ) kseg_s[j] = kseg[(long long)b * Tk + k0 + j];
    }
    __syncthreads();

    // a tile needs the causal compare only where it crosses the diagonal
    const bool diag = causal && (k0 + kn - 1 > q0);
    float mx = NEG_INF;
    for (int j = 0; j < kn; j += 4) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      const T* k_j = ks + j * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float x = qr[d];
        a0 = fmaf(x, k_j[d], a0);
        a1 = fmaf(x, k_j[D + d], a1);
        a2 = fmaf(x, k_j[2 * D + d], a2);
        a3 = fmaf(x, k_j[3 * D + d], a3);
      }
      const float a[4] = {a0, a1, a2, a3};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jj = j + u;
        if (jj < kn) {
          float s = a[u] * scale;
          if (diag && k0 + jj > row) s = NEG_INF;
          if (SCHED && partial && !((bits >> jj) & 1ull)) s = NEG_INF;
          if (kseg != nullptr && kseg_s[jj] != qs_row) s = NEG_INF;
          ss[jj * BQ + tid] = s;
          mx = fmaxf(mx, s);
        }
      }
    }

    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    float lsum = 0.f;
    for (int j = 0; j < kn; ++j) {
      const float p = expf(ss[j * BQ + tid] - m_new);
      lsum += p;
      const T* v_j = vs + j * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_j[d], acc[d]);
    }
    l = l * alpha + lsum;
    m = m_new;
    __syncthreads();
  }

  if (live) {
    const float l_safe = (l == 0.f) ? 1.f : l;
    T* op = o + b * so.b + (long long)row * so.t + h * so.h;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] / l_safe;
    lse[((long long)b * H + h) * Tq + row] = m + logf(l_safe);
  }
}

#define TOSEM_FWD_PARAMS                                                    \
  const T *__restrict__ q, const T *__restrict__ k,                        \
      const T *__restrict__ v, T *__restrict__ o, float *__restrict__ lse, \
      const int *__restrict__ qseg, const int *__restrict__ kseg, int H,   \
      int Tq, int Tk, Strides sq, Strides sk, Strides sv, Strides so,      \
      float scale, int causal, Sched sc
#define TOSEM_FWD_ARGS \
  q, k, v, o, lse, qseg, kseg, H, Tq, Tk, sq, sk, sv, so, scale, causal, sc

template <typename T, int D>
__global__ void __launch_bounds__(BQ) flash_fwd_kernel(TOSEM_FWD_PARAMS) {
  flash_fwd_body<T, D, false>(TOSEM_FWD_ARGS);
}

// The schedule entry point asks for six 64-thread blocks an SM (the
// floor stays off the dense entry point: any explicit floor, even 1,
// changes how ptxas allocates it).
template <typename T, int D>
__global__ void __launch_bounds__(BQ, 6)
flash_fwd_sched_kernel(TOSEM_FWD_PARAMS) {
  flash_fwd_body<T, D, true>(TOSEM_FWD_ARGS);
}

// ------------------------------------------- bf16: the tensor cores

using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;   // 4 warps, 16 query rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes zeros
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// below 2^-126 flush to 0, where P rounds to bf16 anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the shared-memory bytes of the bf16 body: Q, two K and two V tiles of
// rows padded by 16 bytes, and two tiles of kv segment ids
template <int D>
constexpr size_t tc_smem_bytes() {
  return 5 * BK * (D + 8) * sizeof(bf16) + 2 * BK * sizeof(int);
}

// 64 rows of D bf16 from global memory (row r at src + r * row_stride)
// into shared memory at a stride of LD; rows at or past n are zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int n) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int e = threadIdx.x; e < BK * CPR; e += TC_THREADS) {
    const int j = e / CPR;
    const int c = e % CPR;
    const bool in = j < n;
    cp_async16(dst + j * LD + c * 8, src + (in ? j : 0) * row_stride + c * 8,
               in ? 16 : 0);
  }
}

template <int D, bool SCHED>
__device__ __forceinline__ void flash_fwd_tc_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int H, int Tq, int Tk, Strides sq,
    Strides sk, Strides sv, Strides so, float scale, int causal, Sched sc) {
  constexpr int LD = D + 8;        // padded row, in elements
  constexpr int TILE = BK * LD;
  constexpr int NS = BK / 8;       // n-blocks of a score row
  constexpr int NO = D / 8;        // n-blocks of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // [BQ][LD]
  bf16* ks = qs + BQ * LD;                                  // [2][BK][LD]
  bf16* vs = ks + 2 * TILE;                                 // [2][BK][LD]
  int* kseg_s = reinterpret_cast<int*>(vs + 2 * TILE);      // [2][BK]

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
  const int q0 = qt * BQ;
  const int lr = warp * 16 + lane / 4;  // this thread's rows: lr, lr + 8
  const int r0 = q0 + lr;
  const int r1 = r0 + 8;
  const int c0 = 2 * (lane % 4);        // its first column of an n-block

  int n_tiles = (Tk + BK - 1) / BK;
  long long srow = 0;
  if constexpr (SCHED) {
    srow = ((long long)min(h, sc.Hs - 1) * sc.n_major + qt);
    n_tiles = sc.num[srow];
    srow *= sc.L;
  } else if (causal) {
    const int last_row = min(q0 + BQ, Tq) - 1;
    const int last_key = min(last_row, Tk - 1);
    n_tiles = last_key / BK + 1;
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
  // K and the kv segment ids of key tile kt into buffer buf; V apart
  auto load_k = [&](int kt, int buf) {
    const int k0 = kt * BK;
    const int kn = min(BK, Tk - k0);
    load_tile<D>(ks + buf * TILE, kbase + k0 * sk.t, sk.t, kn);
    if (kseg_b != nullptr && tid < BK) {
      const bool in = tid < kn;
      cp_async4(kseg_s + buf * BK + tid, kseg_b + k0 + (in ? tid : 0),
                in ? 4 : 0);
    }
  };
  auto load_v = [&](int kt, int buf) {
    const int k0 = kt * BK;
    load_tile<D>(vs + buf * TILE, vbase + k0 * sv.t, sv.t, min(BK, Tk - k0));
  };

  // prologue: Q, K and V of the first tile, one cp.async group each
  load_tile<D>(qs, q + b * sq.b + q0 * sq.t + h * sq.h, sq.t,
               min(BQ, Tq - q0));
  cp_async_commit();
  load_k(tile_of(0), 0);
  cp_async_commit();
  load_v(tile_of(0), 0);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();

  uint32_t qa[D / 16][4];   // Q's A fragments, for the whole row
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qa[kk], qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                        (lane / 16) * 8);
  const int qs0 = (qseg != nullptr && r0 < Tq) ? qseg[(long long)b * Tq + r0]
                                                : 0;
  const int qs1 = (qseg != nullptr && r1 < Tq) ? qseg[(long long)b * Tq + r1]
                                                : 0;
  const float scale2 = scale * LOG2E;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;   // row maxima, log2 units
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the sums

  // At the top of tile it, K(it) and V(it) may still be in flight. K(it+1)
  // is issued, then K(it) must land before S; V(it+1) is issued, then
  // V(it) must land before the PV product. A buffer is refilled only
  // after the barrier that follows its last read, so no barrier ends a
  // tile.
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < n_tiles;
    const int kt_next = more ? tile_of(it + 1) : 0;
    if (more) load_k(kt_next, buf ^ 1);
    cp_async_commit();
    cp_async_wait<2>();   // K(it)
    __syncthreads();

    const int k0 = tile_of(it) * BK;
    const int kn = min(BK, Tk - k0);
    const bf16* kb = ks + buf * TILE;
    const bf16* vb = vs + buf * TILE;

    // S = Q K^T, 16 x 64 a warp, in registers
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t bk[4];
        ldsm_x4(bk, kb + (n2 * 16 + (lane / 16) * 8 + lane % 8) * LD +
                        kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * n2], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // scale (log2 units), then each mask only on a tile that needs it
    // (the conditions are uniform over the block), then the row maxima
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
    if (causal && k0 + kn - 1 > q0) {   // the tile crosses the diagonal
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + n * 8 + c0 + (e & 1) > (e < 2 ? r0 : r1)) s[n][e] = NEG_INF;
    }
    if constexpr (SCHED) {
      if (sc.kind[srow + it] == KIND_PARTIAL) {
        const unsigned long long* wp =
            sc.bits + (long long)sc.mid[srow + it] * BQ;
        // bit c0 + 8n + {0,1} of each row's word, as 32-bit halves
        const unsigned long long w0 = wp[lr] >> c0, w1 = wp[lr + 8] >> c0;
        const uint32_t h[4] = {(uint32_t)w0, (uint32_t)(w0 >> 32),
                               (uint32_t)w1, (uint32_t)(w1 >> 32)};
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!((h[(e & 2) + n / 4] >> ((n % 4) * 8 + (e & 1))) & 1u))
              s[n][e] = NEG_INF;
      }
    }
    if (kseg_b != nullptr) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int2 kid =
            *reinterpret_cast<const int2*>(kseg_s + buf * BK + n * 8 + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (((e & 1) ? kid.y : kid.x) != (e < 2 ? qs0 : qs1))
            s[n][e] = NEG_INF;
      }
    }
    if (kn < BK) {   // keys past Tk never count: -inf
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n * 8 + c0 + (e & 1) >= kn) s[n][e] = __int_as_float(0xff800000);
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = fast_exp2(m0 - mn0);
    const float alpha1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // P = exp2(S - m), rounded to bf16 in the A layout
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        p[u][0] = fast_exp2(s[2 * kk + u][0] - m0);
        p[u][1] = fast_exp2(s[2 * kk + u][1] - m0);
        p[u][2] = fast_exp2(s[2 * kk + u][2] - m1);
        p[u][3] = fast_exp2(s[2 * kk + u][3] - m1);
        l0 += p[u][0] + p[u][1];
        l1 += p[u][2] + p[u][3];
      }
      pa[kk][0] = pack_bf16(p[0][0], p[0][1]);
      pa[kk][1] = pack_bf16(p[0][2], p[0][3]);
      pa[kk][2] = pack_bf16(p[1][0], p[1][1]);
      pa[kk][3] = pack_bf16(p[1][2], p[1][3]);
    }

    if (more) load_v(kt_next, buf ^ 1);
    cp_async_commit();
    cp_async_wait<2>();   // V(it)
    __syncthreads();

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vb + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                                   LD + n2 * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * n2], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * n2 + 1], pa[kk], bv[2], bv[3]);
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = (l0 == 0.f) ? 1.f : l0;
  const float ls1 = (l1 == 0.f) ? 1.f : l1;
  const float inv0 = 1.f / ls0;
  const float inv1 = 1.f / ls1;
  bf16* ob = o + b * so.b + h * so.h;
  float* lb = lse + ((long long)b * H + h) * Tq;
  if (r0 < Tq) {
    bf16* op = ob + r0 * so.t + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(op + n * 8) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (lane % 4 == 0) lb[r0] = m0 <= NEG_INF ? NEG_INF : m0 * LN2 + logf(ls0);
  }
  if (r1 < Tq) {
    bf16* op = ob + r1 * so.t + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(op + n * 8) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
    if (lane % 4 == 0) lb[r1] = m1 <= NEG_INF ? NEG_INF : m1 * LN2 + logf(ls1);
  }
}

#define TOSEM_TC_PARAMS                                                      \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                   \
      const bf16 *__restrict__ v, bf16 *__restrict__ o,                     \
      float *__restrict__ lse, const int *__restrict__ qseg,                \
      const int *__restrict__ kseg, int H, int Tq, int Tk, Strides sq,      \
      Strides sk, Strides sv, Strides so, float scale, int causal, Sched sc

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(TOSEM_TC_PARAMS) {
  flash_fwd_tc_body<D, false>(TOSEM_FWD_ARGS);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_sched_kernel(TOSEM_TC_PARAMS) {
  flash_fwd_tc_body<D, true>(TOSEM_FWD_ARGS);
}

// ------------------------------------------------------------ launches

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, bool SCHED>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, const void* qseg, const void* kseg, int B, int H,
               int Tq, int Tk, Strides sq, Strides sk, Strides sv,
               Strides so, float scale, int causal, Sched sc,
               cudaStream_t stream) {
  const size_t smem = 2 * BK * D * sizeof(float) + BK * BQ * sizeof(float) +
                      BK * sizeof(int);
  auto kern = SCHED ? flash_fwd_sched_kernel<float, D>
                    : flash_fwd_kernel<float, D>;
  if (int err = set_smem(kern, smem)) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, BQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), H, Tq, Tk, sq, sk, sv, so, scale,
      causal, sc);
  return (int)cudaGetLastError();
}

template <int D, bool SCHED>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              void* lse, const void* qseg, const void* kseg, int B, int H,
              int Tq, int Tk, Strides sq, Strides sk, Strides sv, Strides so,
              float scale, int causal, Sched sc, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  auto kern = SCHED ? flash_fwd_tc_sched_kernel<D> : flash_fwd_tc_kernel<D>;
  if (int err = set_smem(kern, smem)) return err;
  // batch*head in x, the q tiles in y: blocks start heaviest tile first
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), H, Tq, Tk, sq, sk, sv, so, scale,
      causal, sc);
  return (int)cudaGetLastError();
}

template <bool SCHED>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             void* o, void* lse, const void* qseg, const void* kseg, int B,
             int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
             Strides so, float scale, int causal, Sched sc,
             cudaStream_t st) {
#define TOSEM_LAUNCH(fn, d)                                                 \
  return fn<d, SCHED>(q, k, v, o, lse, qseg, kseg, B, H, Tq, Tk, sq, sk, sv, \
                      so, scale, causal, sc, st)
  if (dtype == 0) {
    switch (D) {
      case 16: TOSEM_LAUNCH(launch_f32, 16);
      case 32: TOSEM_LAUNCH(launch_f32, 32);
      case 64: TOSEM_LAUNCH(launch_f32, 64);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: TOSEM_LAUNCH(launch_tc, 16);
      case 32: TOSEM_LAUNCH(launch_tc, 32);
      case 64: TOSEM_LAUNCH(launch_tc, 64);
    }
  }
#undef TOSEM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head
// dimension is contiguous. qseg/kseg are [B,Tq]/[B,Tk] int32 or null.
// lse is [B,H,Tq] float32. The bf16 body copies 16-byte rows: its
// operands start on 16 bytes and their strides are multiples of 8
// (ops/flash_attention.py checks). Returns cudaGetLastError() after the
// launch.
extern "C" int flash_fwd(int dtype, int D, const void* q, const void* k,
                         const void* v, void* o, void* lse, const void* qseg,
                         const void* kseg, int B, int H, int Tq, int Tk,
                         long long sqb, long long sqt, long long sqh,
                         long long skb, long long skt, long long skh,
                         long long svb, long long svt, long long svh,
                         long long sob, long long sot, long long soh,
                         float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      so{sob, sot, soh};
  return dispatch<false>(dtype, D, q, k, v, o, lse, qseg, kseg, B, H, Tq, Tk,
                         sq, sk, sv, so, scale, causal, Sched{},
                         static_cast<cudaStream_t>(stream));
}

// The schedule mode: as flash_fwd with no causal flag (a mask program
// carries it), plus the q-major schedule of ops/mask_programs.py at 64 x 64
// tiles: num [Hs,Tq/64], blk/kind/mid [Hs,Tq/64,L] int32, bits [M,64]
// 64-bit words, and order [Tq/64] int32, the q tiles heaviest first (a
// permutation; the bf16 body launches in that order). Tq and Tk must be
// multiples of 64.
extern "C" int flash_fwd_sched(int dtype, int D, const void* q, const void* k,
                               const void* v, void* o, void* lse,
                               const void* qseg, const void* kseg, int B,
                               int H, int Tq, int Tk, long long sqb,
                               long long sqt, long long sqh, long long skb,
                               long long skt, long long skh, long long svb,
                               long long svt, long long svh, long long sob,
                               long long sot, long long soh, float scale,
                               const void* num, const void* blk,
                               const void* kind, const void* mid,
                               const void* bits, const void* order, int Hs,
                               int L, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || Tq % BQ || Tk % BK ||
      Hs <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      so{sob, sot, soh};
  const Sched sc{static_cast<const int*>(num), static_cast<const int*>(blk),
                 static_cast<const int*>(kind), static_cast<const int*>(mid),
                 static_cast<const unsigned long long*>(bits),
                 static_cast<const int*>(order), Hs, Tq / BQ, L};
  return dispatch<true>(dtype, D, q, k, v, o, lse, qseg, kseg, B, H, Tq, Tk,
                        sq, sk, sv, so, scale, 0, sc,
                        static_cast<cudaStream_t>(stream));
}
