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
// any combination; Q/K/V/dO and the gradients are addressed through
// (batch, time, head) strides with a contiguous head dimension, so the
// [B,H,T,D] and [B,T,H,D] layouts both run without a transposed copy.
//
// What bounds it on this card: B2 does 8*B*H*Tq*Tk*d operations (four
// products per visible pair) and B3 6*B*H*Tq*Tk*d, over about
// 9*B*H*T*d bytes of bf16 operands and gradients. At the training shape
// [8,512,12,64] that is ~12.9 and ~9.7 GFLOP over ~38 and ~32 MB: the
// operations bound both, at ~0.013 and ~0.010 ms on the tensor cores.
// This first version does the arithmetic on the CUDA cores in fp32 FMAs
// (~67 TFLOP/s), so in practice it is bound by those FMAs, an order of
// magnitude above the card's bound; mma/wgmma and TMA are later work.
//
// What the design does about it: one block per (64-row tile, batch*head).
// D/16 threads share one row (16 elements each), so a thread holds the
// row's slices of two operands and of one or two fp32 accumulators in
// registers (48 floats for dQ, 64 for dK/dV) and no register spills at
// d = 64; the dot products over d end in a butterfly of warp shuffles,
// which leaves the same sum on every thread of the row. The streamed
// tiles (K/V for dQ, Q/dO/LSE/Delta for dK/dV) go through shared memory
// once per block, converted to fp32 there (exact for bf16), and each
// thread reads its slices as float4. The loop over streamed tiles inside
// the block takes the place of the TPU grid's sequential stream
// dimension; a causal dQ block stops at its diagonal tile, a causal dKV
// block starts at the query tile holding its first key row, and only a
// tile that crosses the diagonal pays the causal compare. Ragged Tq/Tk
// are masked here, so no length has to tile.
//
// Determinism: every output element is written by one thread after a
// loop in a fixed order; there are no atomics, and dQ is its own kernel
// (as in the reference), so two launches on the same inputs agree bit
// for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BR = 64;   // resident rows per block (queries for dQ, keys for dKV)
constexpr int BS = 64;   // streamed rows per tile
constexpr int EPT = 16;  // elements of a row each thread holds
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
// round to the input dtype and back (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Strides {
  long long b, t, h;
};

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
template <typename T, int D>
__global__ void __launch_bounds__(BR * (D / EPT))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, T* __restrict__ dq, int H,
                    int Tq, int Tk, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdq, float scale, int causal) {
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
  if (causal) {
    const int last_row = min(q0 + BR, Tq) - 1;
    n_tiles = min(last_row, Tk - 1) / BS + 1;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
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
template <typename T, int D>
__global__ void __launch_bounds__(BR * (D / EPT))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv, float scale, int causal) {
  constexpr int TPR = D / EPT;
  constexpr int NT = BR * TPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [BS][D]
  float* dos = qs + BS * D;                         // [BS][D]
  float* lse_s = dos + BS * D;                      // [BS]
  float* dlt_s = lse_s + BS;                        // [BS]
  int* qseg_s = reinterpret_cast<int*>(dlt_s + BS);   // [BS]

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
  const int first = causal ? k0 / BS : 0;
  const int n_tiles = (Tq + BS - 1) / BS;
  for (int qt = first; qt < n_tiles; ++qt) {
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

template <typename K>
cudaError_t prepare(K kern, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* qseg,
              const void* kseg, void* dq, int B, int H, int Tq, int Tk,
              Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
              float scale, int causal, cudaStream_t stream) {
  const size_t smem = 2 * BS * D * sizeof(float) + BS * sizeof(int);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BR - 1) / BR, B * H);
  kern<<<grid, BR * (D / EPT), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<T*>(dq), H, Tq, Tk, sq, sk, sv, sdo, sdq, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* qseg,
               const void* kseg, void* dk, void* dv, int B, int H, int Tq,
               int Tk, Strides sq, Strides sk, Strides sv, Strides sdo,
               Strides sdk, Strides sdv, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = 2 * BS * D * sizeof(float) + 2 * BS * sizeof(float) +
                      BS * sizeof(int);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tk + BR - 1) / BR, B * H);
  kern<<<grid, BR * (D / EPT), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, sq, sk, sv, sdo,
      sdk, sdv, scale, causal);
  return (int)cudaGetLastError();
}

#define TOSEM_DISPATCH_D(LAUNCH, T, ...)                \
  switch (D) {                                          \
    case 16:                                            \
      return LAUNCH<T, 16>(__VA_ARGS__);                \
    case 32:                                            \
      return LAUNCH<T, 32>(__VA_ARGS__);                \
    case 64:                                            \
      return LAUNCH<T, 64>(__VA_ARGS__);                \
    default:                                            \
      return (int)cudaErrorInvalidValue;                \
  }

template <typename T>
int dq_d(int D, const void* q, const void* k, const void* v, const void* dout,
         const void* lse, const void* delta, const void* qseg,
         const void* kseg, void* dq, int B, int H, int Tq, int Tk, Strides sq,
         Strides sk, Strides sv, Strides sdo, Strides sdq, float scale,
         int causal, cudaStream_t st) {
  TOSEM_DISPATCH_D(launch_dq, T, q, k, v, dout, lse, delta, qseg, kseg, dq, B,
                   H, Tq, Tk, sq, sk, sv, sdo, sdq, scale, causal, st)
}

template <typename T>
int dkv_d(int D, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta,
          const void* qseg, const void* kseg, void* dk, void* dv, int B,
          int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
          Strides sdo, Strides sdk, Strides sdv, float scale, int causal,
          cudaStream_t st) {
  TOSEM_DISPATCH_D(launch_dkv, T, q, k, v, dout, lse, delta, qseg, kseg, dk,
                   dv, B, H, Tq, Tk, sq, sk, sv, sdo, sdk, sdv, scale, causal,
                   st)
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, as (batch,
// time, head); the head dimension is contiguous. lse and delta are
// [B,H,Tq] float32; qseg/kseg are [B,Tq]/[B,Tk] int32 or null. Each
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dq_d<float>(D, q, k, v, dout, lse, delta, qseg, kseg, dq, B, H, Tq,
                       Tk, sq, sk, sv, sdo, sdq, scale, causal, st);
  if (dtype == 1)
    return dq_d<__nv_bfloat16>(D, q, k, v, dout, lse, delta, qseg, kseg, dq,
                               B, H, Tq, Tk, sq, sk, sv, sdo, sdq, scale,
                               causal, st);
  return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dkv_d<float>(D, q, k, v, dout, lse, delta, qseg, kseg, dk, dv, B,
                        H, Tq, Tk, sq, sk, sv, sdo, sdk, sdv, scale, causal,
                        st);
  if (dtype == 1)
    return dkv_d<__nv_bfloat16>(D, q, k, v, dout, lse, delta, qseg, kseg, dk,
                                dv, B, H, Tq, Tk, sq, sk, sv, sdo, sdk, sdv,
                                scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
