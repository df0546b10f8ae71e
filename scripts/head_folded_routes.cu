// Probes of the head-folded attention kernels on an H100, for
// scripts/head_folded_routes.py, which times them.  Built by that script
// with nvcc for sm_90a.
//
// `legacy`: the forward and the two backward launches that the port ran
// before the kernels were redesigned (one thread a query or key row, 64
// threads a block, the online softmax's compare and rescale at every key,
// every exponential computed twice in the backward), kept here as the
// baseline, each in three modes: whole; with its exponentials removed
// (exp2f(x) replaced by one add); with its products removed (each dot
// product of d terms replaced by one load).
//
// `engine`: the two candidate engines for the forward's products at d 4,
// the scores S = Q K^T and O = S V with no softmax between them (P = S):
//   ffma: q of three query rows a thread in registers, K and V broadcast
//         from shared memory, eight heads of a sample a block;
//   mma:  `mma.sync.m16n8k8` on TF32 operands, one pass (10-bit mantissas)
//         or three (each fp32 value a TF32 "big" part plus the TF32
//         rounding of the rest: big big + big small + small big); S's
//         accumulator fragment feeds P V's A fragment directly, with the
//         keys of V permuted to match.  d 4 fills half of the k = 8 depth
//         of the scores and half of the n = 8 width of P V.
// Both read (BH, L, 4) contiguous operands.
//
// `variant`: the port's first redesigned forward at d 4 (three rows a
// thread, each row offset by the bound |q| max|k| on its scores, K and V by
// cp.async), with its parts switched off one at a time (exponentials, the
// score bound, the asynchronous staging) or its registers capped, to see
// which part costs what; kept as the record of that design.
//
// `portvar`: the port's own kernel bodies (csrc/head_folded_attention.cu,
// included) at d 4 with their probe switches: the forward without exp2,
// without its running max (offset 0), or both; the backward without exp2,
// without its reduce-scatter of dQ, or both.
//
// `small_legacy`: the small-head kernels the port ran before their redesign
// (csrc/small_head_attention.cu as it stood then: one thread a query or key
// row, 64 threads a block, the forward's max a group of 4 keys, the
// backward's two launches computing every exponential twice), at d 4, in
// the three modes of `legacy`.
//
// `small_var`: the port's small-head bodies (csrc/small_head_attention.cu,
// included) at d 4 with their probe switches and their rows (forward, R)
// or keys (backward, RK) a lane chosen by the caller.

#include "../fine_grained_gaussian_process_forcasting_torch/csrc/head_folded_attention.cu"
#include "../fine_grained_gaussian_process_forcasting_torch/csrc/small_head_attention.cu"

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace legacy {

constexpr int ROWS = 64;
constexpr int KC = 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// MODE 0: whole; 1: no exponentials; 2: no products
template <int MODE>
__device__ __forceinline__ float ex(float x) {
  if (MODE == 1) return x + 1.f;
  return exp2f(x);
}

template <int DP, int MODE>
__device__ __forceinline__ float dot(const float (&a)[DP], const float* b) {
  if (MODE == 2) return b[0];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < DP; ++j) s = fmaf(a[j], b[j], s);
  return s;
}

template <int DP, int MODE>
__device__ __forceinline__ float dot_s(const float* a, const float (&b)[DP]) {
  if (MODE == 2) return a[0];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < DP; ++j) s = fmaf(a[j], b[j], s);
  return s;
}

template <int DP>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         int row, int n, int d, float scale,
                                         float (&dst)[DP]) {
#pragma unroll
  for (int j = 0; j < DP; ++j)
    dst[j] = (row < n && j < d) ? src[(size_t)row * d + j] * scale : 0.f;
}

template <int DP>
__device__ __forceinline__ void stage(float (*dst)[DP],
                                      const float* __restrict__ src, int k0,
                                      int n, int d) {
  for (int i = threadIdx.x; i < KC * DP; i += ROWS) {
    const int key = i / DP;
    const int j = i - key * DP;
    dst[key][j] = (key < n && j < d) ? src[(size_t)(k0 + key) * d + j] : 0.f;
  }
}

template <int DP, int MODE>
__global__ void __launch_bounds__(ROWS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int Lq, int Lk, int d, float q_scale) {
  __shared__ __align__(16) float ks[KC][DP];
  __shared__ __align__(16) float vs[KC][DP];
  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;
  const float* kb = k + bh * Lk * d;
  const float* vb = v + bh * Lk * d;
  float qr[DP], acc[DP];
  load_row<DP>(q + bh * Lq * d, row, Lq, d, q_scale, qr);
#pragma unroll
  for (int j = 0; j < DP; ++j) acc[j] = 0.f;
  float run_max = -INFINITY, run_sum = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += KC) {
    const int n = min(KC, Lk - k0);
    __syncthreads();
    stage<DP>(ks, kb, k0, n, d);
    stage<DP>(vs, vb, k0, n, d);
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float s = dot<DP, MODE>(qr, ks[t]);
      if (s > run_max) {
        const float c = ex<MODE>(run_max - s);
        run_sum *= c;
#pragma unroll
        for (int j = 0; j < DP; ++j) acc[j] *= c;
        run_max = s;
      }
      const float p = ex<MODE>(s - run_max);
      run_sum += p;
      if (MODE == 2) {
        acc[0] += p;
      } else {
#pragma unroll
        for (int j = 0; j < DP; ++j) acc[j] = fmaf(p, vs[t][j], acc[j]);
      }
    }
  }
  if (row < Lq) {
    const float inv = 1.f / run_sum;
    float* orow = o + bh * Lq * d + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < DP; ++j)
      if (j < d) orow[j] = acc[j] * inv;
    if (lse != nullptr) lse[bh * Lq + row] = (run_max + log2f(run_sum)) * LN2;
  }
}

template <int DP, int MODE>
__global__ void __launch_bounds__(ROWS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ lse, const float* __restrict__ dout,
              float* __restrict__ dq, float* __restrict__ delta, int Lq,
              int Lk, int d, float q_scale, float scale) {
  __shared__ __align__(16) float ks[KC][DP];
  __shared__ __align__(16) float vs[KC][DP];
  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;
  const float* kb = k + bh * Lk * d;
  const float* vb = v + bh * Lk * d;
  float qr[DP], dor[DP], orow[DP], acc[DP];
  load_row<DP>(q + bh * Lq * d, row, Lq, d, q_scale, qr);
  load_row<DP>(dout + bh * Lq * d, row, Lq, d, 1.f, dor);
  load_row<DP>(o + bh * Lq * d, row, Lq, d, 1.f, orow);
  float dsum = 0.f;
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    dsum = fmaf(dor[j], orow[j], dsum);
    acc[j] = 0.f;
  }
  const float lse2 = row < Lq ? lse[bh * Lq + row] * LOG2E : 0.f;
  for (int k0 = 0; k0 < Lk; k0 += KC) {
    const int n = min(KC, Lk - k0);
    __syncthreads();
    stage<DP>(ks, kb, k0, n, d);
    stage<DP>(vs, vb, k0, n, d);
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float s = dot<DP, MODE>(qr, ks[t]);
      const float dp = dot<DP, MODE>(dor, vs[t]);
      const float ds = ex<MODE>(s - lse2) * (dp - dsum);
      if (MODE == 2) {
        acc[0] += ds;
      } else {
#pragma unroll
        for (int j = 0; j < DP; ++j) acc[j] = fmaf(ds, ks[t][j], acc[j]);
      }
    }
  }
  if (row < Lq) {
    float* dqrow = dq + bh * Lq * d + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < DP; ++j)
      if (j < d) dqrow[j] = acc[j] * scale;
    delta[bh * Lq + row] = dsum;
  }
}

template <int DP, int MODE>
__global__ void __launch_bounds__(ROWS)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta,
               const float* __restrict__ dout, float* __restrict__ dk,
               float* __restrict__ dv, int Lq, int Lk, int d, float q_scale,
               float scale) {
  __shared__ __align__(16) float qs[KC][DP];
  __shared__ __align__(16) float dos[KC][DP];
  __shared__ float lses[KC];
  __shared__ float ds_[KC];
  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;
  const float* qb = q + bh * Lq * d;
  const float* dob = dout + bh * Lq * d;
  float kr[DP], vr[DP], dka[DP], dva[DP];
  load_row<DP>(k + bh * Lk * d, row, Lk, d, 1.f, kr);
  load_row<DP>(v + bh * Lk * d, row, Lk, d, 1.f, vr);
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    dka[j] = 0.f;
    dva[j] = 0.f;
  }
  for (int q0 = 0; q0 < Lq; q0 += KC) {
    const int n = min(KC, Lq - q0);
    __syncthreads();
    for (int i = threadIdx.x; i < KC * DP; i += ROWS) {
      const int r = i / DP;
      const int j = i - r * DP;
      const bool ok = r < n && j < d;
      const size_t at = (size_t)(q0 + r) * d + j;
      qs[r][j] = ok ? qb[at] * q_scale : 0.f;
      dos[r][j] = ok ? dob[at] : 0.f;
    }
    if (threadIdx.x < n) {
      lses[threadIdx.x] = lse[bh * Lq + q0 + threadIdx.x] * LOG2E;
      ds_[threadIdx.x] = delta[bh * Lq + q0 + threadIdx.x];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float s = dot_s<DP, MODE>(qs[t], kr);
      const float dp = dot_s<DP, MODE>(dos[t], vr);
      const float p = ex<MODE>(s - lses[t]);
      const float ds = p * (dp - ds_[t]);
      if (MODE == 2) {
        dva[0] += p;
        dka[0] += ds;
      } else {
#pragma unroll
        for (int j = 0; j < DP; ++j) {
          dva[j] = fmaf(p, dos[t][j], dva[j]);
          dka[j] = fmaf(ds, qs[t][j], dka[j]);
        }
      }
    }
  }
  if (row < Lk) {
    const float to_dk = scale / q_scale;
    float* dkrow = dk + bh * Lk * d + (size_t)row * d;
    float* dvrow = dv + bh * Lk * d + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      if (j < d) {
        dkrow[j] = dka[j] * to_dk;
        dvrow[j] = dva[j];
      }
    }
  }
}

template <int MODE>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse,
        int BH, int Lq, int Lk, int d, cudaStream_t s) {
  const float q_scale = LOG2E / sqrtf((float)d);
  fwd_kernel<4, MODE><<<dim3(BH, (Lq + ROWS - 1) / ROWS), ROWS, 0, s>>>(
      q, k, v, o, lse, Lq, Lk, d, q_scale);
  return (int)cudaGetLastError();
}

// which: 1 the query-parallel launch (D and dQ), 2 the key-parallel one
// (dK and dV; reads the D the first wrote), 3 both
template <int MODE>
int bwd(const float* q, const float* k, const float* v, const float* o,
        const float* lse, const float* dout, float* dq, float* dk, float* dv,
        float* delta, int BH, int Lq, int Lk, int d, int which,
        cudaStream_t s) {
  const float scale = 1.f / sqrtf((float)d);
  const float q_scale = LOG2E * scale;
  if (which & 1)
    bwd_dq_kernel<4, MODE><<<dim3(BH, (Lq + ROWS - 1) / ROWS), ROWS, 0, s>>>(
        q, k, v, o, lse, dout, dq, delta, Lq, Lk, d, q_scale, scale);
  if (which & 2)
    bwd_dkv_kernel<4, MODE><<<dim3(BH, (Lk + ROWS - 1) / ROWS), ROWS, 0, s>>>(
        q, k, v, lse, delta, dout, dk, dv, Lq, Lk, d, q_scale, scale);
  return (int)cudaGetLastError();
}

}  // namespace legacy


namespace small_legacy {

// csrc/small_head_attention.cu before its redesign, at D = 4; MODE 0 whole,
// 1 no exponentials (exp2f(x) replaced by one add), 2 no products (each dot
// product of d terms replaced by one load)
constexpr int D = 4;
constexpr int ROWS = 64;
constexpr int STAGE = 512;

template <int MODE>
__device__ __forceinline__ float ex(float x) {
  if (MODE == 1) return x + 1.f;
  return exp2f(x);
}

__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int r0, int n, float scale) {
  const float* from = src + (size_t)r0 * D;
  for (int i = threadIdx.x; i < n * D; i += ROWS) dst[i] = from[i] * scale;
}

template <int MODE>
__device__ __forceinline__ float dot(const float (&a)[D],
                                     const float* __restrict__ b) {
  if (MODE == 2) return b[0];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) s = fmaf(a[j], b[j], s);
  return s;
}

template <int MODE>
__device__ __forceinline__ void axpy(float p, const float* __restrict__ x,
                                     float (&acc)[D]) {
  if (MODE == 2) {
    acc[0] += p;
    return;
  }
#pragma unroll
  for (int j = 0; j < D; ++j) acc[j] = fmaf(p, x[j], acc[j]);
}

template <int MODE>
__global__ void __launch_bounds__(ROWS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int Lq, int Lk, int stage,
           float q_scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + stage * D;
  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;
  const bool live = row < Lq;
  const float* kb = k + bh * Lk * D;
  const float* vb = v + bh * Lk * D;
  float qr[D], acc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    qr[j] = live ? q[(bh * Lq + row) * D + j] * q_scale : 0.f;
    acc[j] = 0.f;
  }
  float run_max = -INFINITY, run_sum = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += stage) {
    const int n = min(stage, Lk - k0);
    if (k0 > 0) __syncthreads();
    stage_rows(ks, kb, k0, n, 1.f);
    stage_rows(vs, vb, k0, n, 1.f);
    __syncthreads();
    int t = 0;
    for (; t + 4 <= n; t += 4) {
      float s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] = dot<MODE>(qr, ks + (t + u) * D);
      const float m = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
      if (m > run_max) {
        const float c = ex<MODE>(run_max - m);
        run_sum *= c;
#pragma unroll
        for (int j = 0; j < D; ++j) acc[j] *= c;
        run_max = m;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = ex<MODE>(s[u] - run_max);
        run_sum += p;
        axpy<MODE>(p, vs + (t + u) * D, acc);
      }
    }
    for (; t < n; ++t) {
      const float s = dot<MODE>(qr, ks + t * D);
      if (s > run_max) {
        const float c = ex<MODE>(run_max - s);
        run_sum *= c;
#pragma unroll
        for (int j = 0; j < D; ++j) acc[j] *= c;
        run_max = s;
      }
      const float p = ex<MODE>(s - run_max);
      run_sum += p;
      axpy<MODE>(p, vs + t * D, acc);
    }
  }
  if (live) {
    const float inv = 1.f / run_sum;
#pragma unroll
    for (int j = 0; j < D; ++j) o[(bh * Lq + row) * D + j] = acc[j] * inv;
    lse[bh * Lq + row] = (run_max + log2f(run_sum)) * LN2;
  }
}

template <int MODE>
__global__ void __launch_bounds__(ROWS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ lse, const float* __restrict__ dout,
              float* __restrict__ dq, float* __restrict__ delta, int Lq,
              int Lk, int stage, float q_scale, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + stage * D;
  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;
  const bool live = row < Lq;
  const float* kb = k + bh * Lk * D;
  const float* vb = v + bh * Lk * D;
  const size_t at = (bh * Lq + row) * D;
  float qr[D], dor[D], acc[D];
  float dsum = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    qr[j] = live ? q[at + j] * q_scale : 0.f;
    dor[j] = live ? dout[at + j] : 0.f;
    dsum = fmaf(dor[j], live ? o[at + j] : 0.f, dsum);
    acc[j] = 0.f;
  }
  const float lse2 = live ? lse[bh * Lq + row] * LOG2E : 0.f;
  for (int k0 = 0; k0 < Lk; k0 += stage) {
    const int n = min(stage, Lk - k0);
    if (k0 > 0) __syncthreads();
    stage_rows(ks, kb, k0, n, 1.f);
    stage_rows(vs, vb, k0, n, 1.f);
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float* kt = ks + t * D;
      const float s = dot<MODE>(qr, kt);
      const float dp = dot<MODE>(dor, vs + t * D);
      const float ds = ex<MODE>(s - lse2) * (dp - dsum);
      axpy<MODE>(ds, kt, acc);
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < D; ++j) dq[at + j] = acc[j] * scale;
    delta[bh * Lq + row] = dsum;
  }
}

template <int MODE>
__global__ void __launch_bounds__(ROWS)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta,
               const float* __restrict__ dout, float* __restrict__ dk,
               float* __restrict__ dv, int Lq, int Lk, int stage,
               float q_scale, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = smem + stage * D;
  float* lses = smem + 2 * stage * D;
  float* dels = lses + stage;
  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;
  const bool live = row < Lk;
  const float* qb = q + bh * Lq * D;
  const float* dob = dout + bh * Lq * D;
  const size_t at = (bh * Lk + row) * D;
  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    kr[j] = live ? k[at + j] : 0.f;
    vr[j] = live ? v[at + j] : 0.f;
    dka[j] = dva[j] = 0.f;
  }
  for (int q0 = 0; q0 < Lq; q0 += stage) {
    const int n = min(stage, Lq - q0);
    if (q0 > 0) __syncthreads();
    stage_rows(qs, qb, q0, n, q_scale);
    stage_rows(dos, dob, q0, n, 1.f);
    for (int i = threadIdx.x; i < n; i += ROWS) {
      lses[i] = lse[bh * Lq + q0 + i] * LOG2E;
      dels[i] = delta[bh * Lq + q0 + i];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float* qt = qs + t * D;
      const float* dot_ = dos + t * D;
      const float s = dot<MODE>(kr, qt);
      const float dp = dot<MODE>(vr, dot_);
      const float p = ex<MODE>(s - lses[t]);
      const float ds = p * (dp - dels[t]);
      axpy<MODE>(p, dot_, dva);
      axpy<MODE>(ds, qt, dka);
    }
  }
  if (live) {
    const float to_dk = scale / q_scale;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      dk[at + j] = dka[j] * to_dk;
      dv[at + j] = dva[j];
    }
  }
}

template <int MODE>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse,
        int BH, int Lq, int Lk, cudaStream_t s) {
  const int stage = min(STAGE, Lk);
  fwd_kernel<MODE><<<dim3(BH, (Lq + ROWS - 1) / ROWS), ROWS,
                     2 * (size_t)stage * D * sizeof(float), s>>>(
      q, k, v, o, lse, Lq, Lk, stage, LOG2E / 2.f);
  return (int)cudaGetLastError();
}

// which: 1 the query-parallel launch, 2 the key-parallel one, 3 both
template <int MODE>
int bwd(const float* q, const float* k, const float* v, const float* o,
        const float* lse, const float* dout, float* dq, float* dk, float* dv,
        float* delta, int BH, int Lq, int Lk, int which, cudaStream_t s) {
  const float scale = 0.5f, q_scale = LOG2E * scale;
  const int stage_k = min(STAGE, Lk), stage_q = min(STAGE, Lq);
  if (which & 1)
    bwd_dq_kernel<MODE><<<dim3(BH, (Lq + ROWS - 1) / ROWS), ROWS,
                          2 * (size_t)stage_k * D * sizeof(float), s>>>(
        q, k, v, o, lse, dout, dq, delta, Lq, Lk, stage_k, q_scale, scale);
  if (which & 2)
    bwd_dkv_kernel<MODE><<<dim3(BH, (Lk + ROWS - 1) / ROWS), ROWS,
                           (size_t)stage_q * (2 * D + 2) * sizeof(float),
                           s>>>(q, k, v, lse, delta, dout, dk, dv, Lq, Lk,
                                stage_q, q_scale, scale);
  return (int)cudaGetLastError();
}

}  // namespace small_legacy

namespace small_var {

// the port's small-head bodies at d 4 with their probe switches
template <int R, int PROBE>
__global__ void __launch_bounds__(small_head::FWD_MAX_WARPS * 32, 2)
fwd(const small_head::FwdArgs a) {
  small_head::fwd_body<4, R, PROBE>(a);
}

template <int RK, bool FULL, int PROBE>
__global__ void __launch_bounds__(32, small_head::BwdShape<4>::MIN_BLOCKS)
bwd(const small_head::BwdArgs a) {
  small_head::bwd_fused_body<4, RK, FULL, PROBE>(a);
}

template <int R, int PROBE>
int launch_fwd(small_head::FwdArgs a, int BH, cudaStream_t s) {
  size_t smem;
  const dim3 grid = small_head::fwd_grid<4, R>(a, BH, &smem);
  fwd<R, PROBE><<<grid, a.wpb * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int RK, int PROBE>
int launch_bwd(const small_head::BwdArgs& a, int BH, cudaStream_t s) {
  const long long bytes = small_head::fused_bytes(a.Lq, 4);
  auto kernel = a.Lk % (32 * RK) == 0 ? bwd<RK, true, PROBE>
                                      : bwd<RK, false, PROBE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)BH, 32, (size_t)bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace small_var

namespace engine {

// ---------------------------------------------------------------- FFMA --
constexpr int R = 3;       // query rows a thread
constexpr int HEADS = 8;   // heads a block, one warp each
constexpr int KMAX = 192;  // keys staged at once

__global__ void __launch_bounds__(HEADS * 32)
ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int BH, int Lq,
            int Lk) {
  __shared__ __align__(16) float4 ks[KMAX][HEADS];
  __shared__ __align__(16) float4 vs[KMAX][HEADS];
  const int bh0 = blockIdx.x * HEADS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = bh0 + warp;
  const int row0 = blockIdx.y * 32 * R + lane;
  float4 qr[R], acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + 32 * i;
    qr[i] = (bh < BH && row < Lq)
                ? reinterpret_cast<const float4*>(q)[(size_t)bh * Lq + row]
                : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int k0 = 0; k0 < Lk; k0 += KMAX) {
    const int n = min(KMAX, Lk - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * HEADS; i += blockDim.x) {
      const int t = i / HEADS, hh = i - t * HEADS;
      const bool ok = bh0 + hh < BH;
      const size_t at = (size_t)(bh0 + hh) * Lk + k0 + t;
      ks[t][hh] = ok ? reinterpret_cast<const float4*>(k)[at]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      vs[t][hh] = ok ? reinterpret_cast<const float4*>(v)[at]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float4 kk = ks[t][warp], vv = vs[t][warp];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float s = qr[i].x * kk.x;
        s = fmaf(qr[i].y, kk.y, s);
        s = fmaf(qr[i].z, kk.z, s);
        s = fmaf(qr[i].w, kk.w, s);
        acc[i].x = fmaf(s, vv.x, acc[i].x);
        acc[i].y = fmaf(s, vv.y, acc[i].y);
        acc[i].z = fmaf(s, vv.z, acc[i].z);
        acc[i].w = fmaf(s, vv.w, acc[i].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + 32 * i;
    if (bh < BH && row < Lq)
      reinterpret_cast<float4*>(o)[(size_t)bh * Lq + row] = acc[i];
  }
}

// ----------------------------------------------------------- mma.sync --
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x as big + small TF32 parts
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// D (16 x 8) += A (16 x 8, TF32) B (8 x 8, TF32).  Lane 4 g + t: a0 =
// A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]; b0 = B[t][g],
// b1 = B[t+4][g]; c0, c1 = D[g][2t..2t+1], c2, c3 = D[g+8][2t..2t+1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int MW = 4;  // warps a block, 16 query rows each

// one head a block (grid.x), 64 query rows (grid.y); K and V of the head
// in shared memory as TF32 parts, split once
template <int PARTS>
__global__ void __launch_bounds__(MW * 32)
mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int Lq,
           int Lk) {
  __shared__ __align__(16) uint32_t kb[KMAX][4], kl[KMAX][4];
  __shared__ __align__(16) uint32_t vb[KMAX][4], vl[KMAX][4];
  const size_t bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * MW * 16 + warp * 16;
  // Q's A fragment: dims t (a0, a1); dims t + 4 are the padding (0)
  uint32_t qa[4] = {0u, 0u, 0u, 0u}, qa_s[4] = {0u, 0u, 0u, 0u};
  {
    const float x0 = r0 + g < Lq ? q[(bh * Lq + r0 + g) * 4 + t] : 0.f;
    const float x1 = r0 + g + 8 < Lq ? q[(bh * Lq + r0 + g + 8) * 4 + t] : 0.f;
    split(x0, qa[0], qa_s[0]);
    split(x1, qa[1], qa_s[1]);
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < Lk; k0 += KMAX) {
    const int n = min(KMAX, Lk - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * 4; i += blockDim.x) {
      const int key = i >> 2, j = i & 3;
      split(k[(bh * Lk + k0 + key) * 4 + j], kb[key][j], kl[key][j]);
      split(v[(bh * Lk + k0 + key) * 4 + j], vb[key][j], vl[key][j]);
    }
    __syncthreads();
    for (int kt = 0; kt < n; kt += 8) {
      // S (16 rows x 8 keys): B = K^T, b0 = K[kt + g][t], b1 = 0 (dims 4..7)
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(s, qa, kb[kt + g][t], 0u);
      if (PARTS == 3) {
        mma_tf32(s, qa, kl[kt + g][t], 0u);
        mma_tf32(s, qa_s, kb[kt + g][t], 0u);
      }
      // P = S as P V's A fragment: its column t is key 2t, column t + 4
      // key 2t + 1 (the accumulator's own pairs), so V's rows are read in
      // that order: b0 = V[kt + 2t][g], b1 = V[kt + 2t + 1][g], g < 4
      uint32_t pa[4], pa_s[4];
      split(s[0], pa[0], pa_s[0]);
      split(s[2], pa[1], pa_s[1]);
      split(s[1], pa[2], pa_s[2]);
      split(s[3], pa[3], pa_s[3]);
      const bool live = g < 4;
      const uint32_t b0 = live ? vb[kt + 2 * t][g] : 0u;
      const uint32_t b1 = live ? vb[kt + 2 * t + 1][g] : 0u;
      mma_tf32(acc, pa, b0, b1);
      if (PARTS == 3) {
        const uint32_t l0 = live ? vl[kt + 2 * t][g] : 0u;
        const uint32_t l1 = live ? vl[kt + 2 * t + 1][g] : 0u;
        mma_tf32(acc, pa, l0, l1);
        mma_tf32(acc, pa_s, b0, b1);
      }
    }
  }
  // O's columns 2t, 2t + 1: dims 0..3 live in lanes t < 2
  if (t < 2) {
    if (r0 + g < Lq) {
      o[(bh * Lq + r0 + g) * 4 + 2 * t] = acc[0];
      o[(bh * Lq + r0 + g) * 4 + 2 * t + 1] = acc[1];
    }
    if (r0 + g + 8 < Lq) {
      o[(bh * Lq + r0 + g + 8) * 4 + 2 * t] = acc[2];
      o[(bh * Lq + r0 + g + 8) * 4 + 2 * t + 1] = acc[3];
    }
  }
}

}  // namespace engine

namespace variant {

// The port's forward at d 4 (eight heads a block, three query rows a
// thread, K and V broadcast from shared memory), reduced to switches, on
// contiguous (b, h, L, 4) operands, h = 8, Lk <= 192: which part of it
// costs what.
constexpr int EXP = 1;    // ex2 of each score (else the score itself)
constexpr int BOUND = 2;  // the offset |q| max|k| a 48-key group (else 0)
constexpr int ASYNC = 4;  // cp.async in four 48-key groups (else loads)

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
               "l"(src));
}

template <int FLAGS, int UNROLL, int MINB>
__global__ void __launch_bounds__(256, MINB)
fwd(const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Lq, int Lk) {
  __shared__ __align__(16) float4 ks[192][8];
  __shared__ __align__(16) float4 vs[192][8];
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = (size_t)b * 8 + warp;
  const int row0 = blockIdx.y * 96 + lane;
  float qr[3][4], qn[3], acc[3][4], l[3], m[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int row = row0 + 32 * i;
    qn[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      qr[i][j] = row < Lq ? q[(bh * Lq + row) * 4 + j] * 0.72134752f : 0.f;
      qn[i] = fmaf(qr[i][j], qr[i][j], qn[i]);
      acc[i][j] = 0.f;
    }
    l[i] = 0.f;
    m[i] = (FLAGS & BOUND) ? -INFINITY : 0.f;
  }
  const float4* kb = reinterpret_cast<const float4*>(k) + (size_t)b * 8 * Lk;
  const float4* vb = reinterpret_cast<const float4*>(v) + (size_t)b * 8 * Lk;
  if (FLAGS & ASYNC) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      for (int i = threadIdx.x; i < 48 * 8; i += 256) {
        const int t = c * 48 + i / 8, hh = i % 8;
        if (t < Lk) {
          cp16(&ks[t][hh], kb + (size_t)hh * Lk + t);
          cp16(&vs[t][hh], vb + (size_t)hh * Lk + t);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
  } else {
    for (int i = threadIdx.x; i < Lk * 8; i += 256) {
      const int t = i / 8, hh = i % 8;
      ks[t][hh] = kb[(size_t)hh * Lk + t];
      vs[t][hh] = vb[(size_t)hh * Lk + t];
    }
    __syncthreads();
  }
  for (int c = 0; c < 4; ++c) {
    const int c0 = c * 48, c1 = min(Lk, c0 + 48);
    if (FLAGS & ASYNC) {
      if (c == 0) asm volatile("cp.async.wait_group 3;\n" ::);
      if (c == 1) asm volatile("cp.async.wait_group 2;\n" ::);
      if (c == 2) asm volatile("cp.async.wait_group 1;\n" ::);
      if (c == 3) asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
    }
    if (c0 >= c1) continue;
    if (FLAGS & BOUND) {
      float km = 0.f;
      for (int t = c0 + lane; t < c1; t += 32) {
        const float4 x = ks[t][warp];
        km = fmaxf(km, x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w);
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        km = fmaxf(km, __shfl_xor_sync(0xffffffffu, km, off));
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float bound = sqrtf(qn[i] * km);
        if (bound > m[i]) {
          const float sc = ex2(m[i] - bound);
          l[i] *= sc;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= sc;
          m[i] = bound;
        }
      }
    }
#pragma unroll UNROLL
    for (int t = c0; t < c1; ++t) {
      const float4 kk = ks[t][warp], vv = vs[t][warp];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float s = fmaf(qr[i][0], kk.x, -m[i]);
        s = fmaf(qr[i][1], kk.y, s);
        s = fmaf(qr[i][2], kk.z, s);
        s = fmaf(qr[i][3], kk.w, s);
        const float p = (FLAGS & EXP) ? ex2(s) : s;
        l[i] += p;
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int row = row0 + 32 * i;
    if (row < Lq) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[(bh * Lq + row) * 4 + j] = acc[i][j] * inv;
    }
  }
}

typedef void (*Kernel)(const float*, const float*, const float*, float*, int,
                       int);
// 0: whole (as the port, one block an SM's registers free); 1: at most 64
// registers (four blocks an SM); 2: no ex2; 3: no bound; 4: loads, not
// cp.async; 5: keys unrolled by 4; 6: none of ex2, bound, cp.async
const Kernel kernels[] = {
    fwd<EXP | BOUND | ASYNC, 2, 1>, fwd<EXP | BOUND | ASYNC, 2, 4>,
    fwd<BOUND | ASYNC, 2, 1>,       fwd<EXP | ASYNC, 2, 1>,
    fwd<EXP | BOUND, 2, 1>,         fwd<EXP | BOUND | ASYNC, 4, 1>,
    fwd<0, 2, 1>};

}  // namespace variant

namespace portvar {

// the port's own kernel bodies (csrc/head_folded_attention.cu, included)
// at d 4 with their probe switches
template <int PROBE>
__global__ void __launch_bounds__(FWD_WARPS * 32, FwdShape<4>::MIN_BLOCKS)
fwd(const FwdArgs a) {
  fwd_body<4, PROBE>(a);
}

template <int PROBE>
__global__ void __launch_bounds__(BwdShape<4>::THREADS) bwd(const BwdArgs a) {
  bwd_fused_body<4, PROBE>(a);
}

typedef void (*FwdKernel)(const FwdArgs);
typedef void (*BwdKernel)(const BwdArgs);
// forward: 0 as the port; 1 no exp2; 2 no running max (offset 0); 3 neither
const FwdKernel fwd_kernels[] = {fwd<0>, fwd<NO_EXP>, fwd<NO_MAX>,
                                 fwd<NO_EXP | NO_MAX>};
// backward: 0 as the port; 1 no exp2; 2 no reduce-scatter of dQ; 3 neither
const BwdKernel bwd_kernels[] = {bwd<0>, bwd<NO_EXP>, bwd<NO_REDUCE>,
                                 bwd<NO_EXP | NO_REDUCE>};

}  // namespace portvar

extern "C" {

// (BH, L, d) contiguous operands, d <= 4; mode 0 whole, 1 without its
// exponentials, 2 without its products
int probe_legacy_fwd(const float* q, const float* k, const float* v, float* o,
                     float* lse, int BH, int Lq, int Lk, int d, int mode,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d < 1 || d > 4) return (int)cudaErrorInvalidValue;
  if (mode == 1) return legacy::fwd<1>(q, k, v, o, lse, BH, Lq, Lk, d, s);
  if (mode == 2) return legacy::fwd<2>(q, k, v, o, lse, BH, Lq, Lk, d, s);
  return legacy::fwd<0>(q, k, v, o, lse, BH, Lq, Lk, d, s);
}

int probe_legacy_bwd(const float* q, const float* k, const float* v,
                     const float* o, const float* lse, const float* dout,
                     float* dq, float* dk, float* dv, float* delta, int BH,
                     int Lq, int Lk, int d, int mode, int which,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d < 1 || d > 4) return (int)cudaErrorInvalidValue;
  if (mode == 1)
    return legacy::bwd<1>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq,
                          Lk, d, which, s);
  if (mode == 2)
    return legacy::bwd<2>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq,
                          Lk, d, which, s);
  return legacy::bwd<0>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk,
                        d, which, s);
}

// O = (Q K^T) V over (BH, L, 4) contiguous operands
int probe_engine_ffma(const float* q, const float* k, const float* v,
                      float* o, int BH, int Lq, int Lk, void* stream) {
  const dim3 grid((BH + engine::HEADS - 1) / engine::HEADS,
                  (Lq + 32 * engine::R - 1) / (32 * engine::R));
  engine::ffma_kernel<<<grid, engine::HEADS * 32, 0, (cudaStream_t)stream>>>(
      q, k, v, o, BH, Lq, Lk);
  return (int)cudaGetLastError();
}

// the same on mma.sync, TF32 parts 1 or 3; Lk a multiple of 8
int probe_engine_mma(const float* q, const float* k, const float* v, float* o,
                     int BH, int Lq, int Lk, int parts, void* stream) {
  if (Lk % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid(BH, (Lq + engine::MW * 16 - 1) / (engine::MW * 16));
  cudaStream_t s = (cudaStream_t)stream;
  if (parts == 3)
    engine::mma_kernel<3><<<grid, engine::MW * 32, 0, s>>>(q, k, v, o, Lq, Lk);
  else
    engine::mma_kernel<1><<<grid, engine::MW * 32, 0, s>>>(q, k, v, o, Lq, Lk);
  return (int)cudaGetLastError();
}

// the variant forward `which` (variant::kernels) at d 4, h 8, Lk <= 192
int probe_variant_fwd(const float* q, const float* k, const float* v,
                      float* o, int B, int Lq, int Lk, int which,
                      void* stream) {
  if (which < 0 || which > 6 || Lk > 192) return (int)cudaErrorInvalidValue;
  variant::kernels[which]<<<dim3(B, (Lq + 95) / 96), 256, 0,
                            (cudaStream_t)stream>>>(q, k, v, o, Lq, Lk);
  return (int)cudaGetLastError();
}

// the port's forward at d 4 as variant `which` (portvar::fwd_kernels), the
// port's C entry's arguments
int probe_fwd_variant(const float* q, const float* k, const float* v,
                      float* o, float* lse, const long long* strides, int B,
                      int H, int Lq, int Lk, int which, void* stream) {
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  FwdArgs a{q, k, v, o, lse, strides_at(strides, 0), strides_at(strides, 1),
            strides_at(strides, 2), strides_at(strides, 3), H, Lq, Lk, 4, 1,
            0, LOG2E / 2.f};
  a.vec = ((size_t)k | (size_t)v) % 16 == 0;
  for (int i = 3; i < 9; ++i) a.vec = a.vec && strides[i] % 4 == 0;
  a.hb = std::min(H, FwdShape<4>::HB);
  const int wq_n = std::max(1, FWD_WARPS / a.hb);
  const int groups = (H + a.hb - 1) / a.hb;
  const int rows = wq_n * 32 * FwdShape<4>::R;
  portvar::fwd_kernels[which]<<<dim3(B * groups, (Lq + rows - 1) / rows),
                                a.hb * wq_n * 32, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

// the port's fused backward at d 4 as variant `which`
// (portvar::bwd_kernels): the port's C entry's arguments, hb heads a block
// and wph warps a head
int probe_bwd_variant(const float* q, const float* k, const float* v,
                      const float* o, const float* lse, const float* dout,
                      float* dq, float* dk, float* dv,
                      const long long* strides, int B, int H, int Lq, int Lk,
                      int hb, int wph, int which, void* stream) {
  if (which < 0 || which > 3 || hb * wph * 32 > BwdShape<4>::THREADS)
    return (int)cudaErrorInvalidValue;
  const float scale = 0.5f;  // d 4
  BwdArgs a{q, k, v, o, lse, dout, dq, dk, dv, nullptr,
            strides_at(strides, 0), strides_at(strides, 1),
            strides_at(strides, 2), strides_at(strides, 3),
            strides_at(strides, 4), strides_at(strides, 5),
            strides_at(strides, 6), strides_at(strides, 7),
            H, Lq, Lk, 4, hb, wph, LOG2E * scale, scale};
  const long long bytes = 4 * fused_smem_floats(4, hb, wph, Lq, Lk);
  const cudaError_t err = cudaFuncSetAttribute(
      portvar::bwd_kernels[which],
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int groups = (H + hb - 1) / hb;
  portvar::bwd_kernels[which]<<<B * groups, hb * wph * 32, (size_t)bytes,
                                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The first small-head kernels at d 4 (small_legacy): mode 0 whole, 1 without
// exponentials, 2 without products; which 1 dQ launch, 2 dK dV, 3 both
int probe_small_legacy_fwd(const float* q, const float* k, const float* v,
                           float* o, float* lse, int BH, int Lq, int Lk,
                           int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 1) return small_legacy::fwd<1>(q, k, v, o, lse, BH, Lq, Lk, s);
  if (mode == 2) return small_legacy::fwd<2>(q, k, v, o, lse, BH, Lq, Lk, s);
  return small_legacy::fwd<0>(q, k, v, o, lse, BH, Lq, Lk, s);
}

int probe_small_legacy_bwd(const float* q, const float* k, const float* v,
                           const float* o, const float* lse,
                           const float* dout, float* dq, float* dk,
                           float* dv, float* delta, int BH, int Lq, int Lk,
                           int mode, int which, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 1)
    return small_legacy::bwd<1>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH,
                                Lq, Lk, which, s);
  if (mode == 2)
    return small_legacy::bwd<2>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH,
                                Lq, Lk, which, s);
  return small_legacy::bwd<0>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH,
                              Lq, Lk, which, s);
}

// the port's small-head forward at d 4 with r rows a lane (3 or 6) and the
// probe switches `probe` (small_head::NO_EXP 1, NO_CHECK 2)
int probe_small_fwd(const float* q, const float* k, const float* v, float* o,
                    float* lse, int BH, int Lq, int Lk, int r, int probe,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const small_head::FwdArgs a{q, k, v, o, lse, Lq, Lk, 0, 0, LOG2E / 2.f};
#define SH_FWD(R)                                                   \
  switch (probe) {                                                  \
    case 0: return small_var::launch_fwd<R, 0>(a, BH, s);           \
    case 1: return small_var::launch_fwd<R, 1>(a, BH, s);           \
    case 2: return small_var::launch_fwd<R, 2>(a, BH, s);           \
    case 3: return small_var::launch_fwd<R, 3>(a, BH, s);           \
    default: return (int)cudaErrorInvalidValue;                     \
  }
  if (r == 6) SH_FWD(6)
  if (r == 3) SH_FWD(3)
#undef SH_FWD
  return (int)cudaErrorInvalidValue;
}

// the port's fused small-head backward at d 4 with rk keys a lane (3 or 6)
// and the probe switches `probe` (small_head::NO_EXP 1, NO_ROTATE 4)
int probe_small_bwd(const float* q, const float* k, const float* v,
                    const float* o, const float* lse, const float* dout,
                    float* dq, float* dk, float* dv, int BH, int Lq, int Lk,
                    int rk, int probe, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const small_head::BwdArgs a{q,  k,  v,  o,  lse, dout,        dq, dk,
                              dv, nullptr, Lq, Lk, LOG2E * 0.5f, 0.5f};
#define SH_BWD(RK)                                                  \
  switch (probe) {                                                  \
    case 0: return small_var::launch_bwd<RK, 0>(a, BH, s);          \
    case 1: return small_var::launch_bwd<RK, 1>(a, BH, s);          \
    case 4: return small_var::launch_bwd<RK, 4>(a, BH, s);          \
    case 5: return small_var::launch_bwd<RK, 5>(a, BH, s);          \
    default: return (int)cudaErrorInvalidValue;                     \
  }
  if (rk == 6) SH_BWD(6)
  if (rk == 3) SH_BWD(3)
#undef SH_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
