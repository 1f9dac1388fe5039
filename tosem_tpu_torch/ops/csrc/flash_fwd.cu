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
// least time is set by the bytes, with the operations close behind. This
// first version does the arithmetic on the CUDA cores in fp32 FMAs
// (exact bf16 products, fp32 sums; ~67 TFLOP/s, a ridge of ~20 ops/byte),
// so in practice it is bound by those FMAs, far from the card's bound;
// mma/wgmma and TMA are later work.
//
// What the design does about it: one block per (64-row query tile,
// batch*head); each thread owns one query row, holding q and the fp32
// accumulator in registers, and the block streams 64-key K/V tiles
// through shared memory, so every K/V element read from device memory
// serves 64 rows. The score dot products run four keys at a time to give
// each thread independent FMA chains. The loop over K/V tiles inside the
// block takes the place of the TPU grid's sequential stream dimension;
// a causal block stops at its diagonal tile, and only a tile that crosses
// the diagonal pays the causal compare. Ragged Tq/Tk are masked here, so
// no length has to tile. A schedule takes the place of the tile counter
// (a template flag of the body, behind its own entry point, so the dense
// kernel is compiled as before), and it cuts the work to the executed
// fraction of the 64 x 64 tile grid.
//
// Numerics follow the reference kernel: operands stay in the input dtype
// (bf16 products are exact in fp32), scores and row statistics are fp32,
// the scale multiplies the fp32 scores, masked scores are -1e30, the
// probabilities are rounded to the input dtype before the PV product,
// and l == 0 is read as 1.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;   // query rows per block, one per thread
constexpr int BK = 64;   // keys per streamed tile
constexpr float NEG_INF = -1e30f;
constexpr int KIND_PARTIAL = 2;  // ops/mask_programs.py

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

struct Strides {
  long long b, t, h;
};

// A q-major block schedule on the device: num [Hs, n_major], blk / kind /
// mid [Hs, n_major, L] int32, bits [M, 64] 64-bit bitmap rows.
struct Sched {
  const int* num;
  const int* blk;
  const int* kind;
  const int* mid;
  const unsigned long long* bits;
  int Hs, n_major, L;
};

// The kernel body, shared by the dense-mode and schedule-mode entry
// points below.
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
    for (int d = 0; d < D; ++d) qr[d] = live ? to_f(qp[d]) : 0.f;
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
        a0 = fmaf(x, to_f(k_j[d]), a0);
        a1 = fmaf(x, to_f(k_j[D + d]), a1);
        a2 = fmaf(x, to_f(k_j[2 * D + d]), a2);
        a3 = fmaf(x, to_f(k_j[3 * D + d]), a3);
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
      const float pb = to_f(from_f<T>(p));
      const T* v_j = vs + j * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pb, to_f(v_j[d]), acc[d]);
    }
    l = l * alpha + lsum;
    m = m_new;
    __syncthreads();
  }

  if (live) {
    const float l_safe = (l == 0.f) ? 1.f : l;
    T* op = o + b * so.b + (long long)row * so.t + h * so.h;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f<T>(acc[d] / l_safe);
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

// Schedule mode's extra state took the bf16 D = 64 body from 168
// registers to 201: five 64-thread blocks an SM instead of six, so the
// encode shape's grid of 768 blocks ran in two waves, not one. Its entry
// point asks for six blocks an SM. (The floor stays off the dense entry
// point: any explicit floor, even 1, changes how ptxas allocates it.)
template <typename T, int D>
__global__ void __launch_bounds__(BQ, 6)
flash_fwd_sched_kernel(TOSEM_FWD_PARAMS) {
  flash_fwd_body<T, D, true>(TOSEM_FWD_ARGS);
}

template <typename T, int D, bool SCHED>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* qseg, const void* kseg, int B, int H, int Tq, int Tk,
           Strides sq, Strides sk, Strides sv, Strides so, float scale,
           int causal, Sched sc, cudaStream_t stream) {
  const size_t smem = 2 * BK * D * sizeof(T) + BK * BQ * sizeof(float) +
                      BK * sizeof(int);
  auto kern = SCHED ? flash_fwd_sched_kernel<T, D> : flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, BQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg), H, Tq, Tk,
      sq, sk, sv, so, scale, causal, sc);
  return (int)cudaGetLastError();
}

template <typename T, bool SCHED>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               void* lse, const void* qseg, const void* kseg, int B, int H,
               int Tq, int Tk, Strides sq, Strides sk, Strides sv, Strides so,
               float scale, int causal, Sched sc, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16, SCHED>(q, k, v, o, lse, qseg, kseg, B, H, Tq, Tk,
                                  sq, sk, sv, so, scale, causal, sc, stream);
    case 32:
      return launch<T, 32, SCHED>(q, k, v, o, lse, qseg, kseg, B, H, Tq, Tk,
                                  sq, sk, sv, so, scale, causal, sc, stream);
    case 64:
      return launch<T, 64, SCHED>(q, k, v, o, lse, qseg, kseg, B, H, Tq, Tk,
                                  sq, sk, sv, so, scale, causal, sc, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool SCHED>
int dispatch_t(int dtype, int D, const void* q, const void* k, const void* v,
               void* o, void* lse, const void* qseg, const void* kseg, int B,
               int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
               Strides so, float scale, int causal, Sched sc,
               cudaStream_t st) {
  if (dtype == 0)
    return dispatch_d<float, SCHED>(D, q, k, v, o, lse, qseg, kseg, B, H, Tq,
                                    Tk, sq, sk, sv, so, scale, causal, sc,
                                    st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, SCHED>(D, q, k, v, o, lse, qseg, kseg, B,
                                            H, Tq, Tk, sq, sk, sv, so, scale,
                                            causal, sc, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head
// dimension is contiguous. qseg/kseg are [B,Tq]/[B,Tk] int32 or null.
// lse is [B,H,Tq] float32. Returns cudaGetLastError() after the launch.
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
  return dispatch_t<false>(dtype, D, q, k, v, o, lse, qseg, kseg, B, H, Tq,
                           Tk, sq, sk, sv, so, scale, causal, Sched{},
                           static_cast<cudaStream_t>(stream));
}

// The schedule mode: as flash_fwd with no causal flag (a mask program
// carries it), plus the q-major schedule of ops/mask_programs.py at 64 x 64
// tiles: num [Hs,Tq/64], blk/kind/mid [Hs,Tq/64,L] int32 and bits [M,64]
// 64-bit words. Tq and Tk must be multiples of 64.
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
                               const void* bits, int Hs, int L,
                               void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || Tq % BQ || Tk % BK ||
      Hs <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh},
      so{sob, sot, soh};
  const Sched sc{static_cast<const int*>(num), static_cast<const int*>(blk),
                 static_cast<const int*>(kind), static_cast<const int*>(mid),
                 static_cast<const unsigned long long*>(bits), Hs, Tq / BQ, L};
  return dispatch_t<true>(dtype, D, q, k, v, o, lse, qseg, kseg, B, H, Tq, Tk,
                          sq, sk, sv, so, scale, 0, sc,
                          static_cast<cudaStream_t>(stream));
}
