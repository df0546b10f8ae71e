// Softmax attention for head dims d <= 8, forward and backward, fp32 -- for
// sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/
//   small_head_attention.py `_fwd_kernel` (reached through
//   `small_head_attention`, `_fwd`) and `_bwd_kernel` (through `_bwd`):
//   per (batch, head), o = softmax(q k^T / sqrt(d)) v, and its VJP
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dP o P)),
//     dQ = dS K / sqrt(d),  dK = dS^T Q / sqrt(d).
//
// The TPU kernel lays each operand out (d, L) and builds the scores as d
// rank-1 outer products on the vector unit, so that its matrix unit never
// pads a 4-wide contraction to 128 lanes; it groups 8 (batch, head) pairs per
// program to amortise the program's overhead.  On Hopper neither concern
// exists: a thread has no lanes to fill, and a block is cheap.
//
// What bounds it on an H100: a (query, key) pair costs 2d flops of scores,
// 2d of output and one exponential.  At d 4 that is 16 flops per
// exponential, and the special-function units (16 exponentials per SM per
// clock, against 128 fp32 FMAs) are the limit together with the issue rate;
// memory is not (the enc-self call, b 256, h 8, L 192, moves 25 MB and
// evaluates 75.5 M exponentials).  The design spends nothing it need not:
//   - d is a template parameter (1..8) and every loop over it is unrolled:
//     no padding of d to 4 or 8, no masked lanes;
//   - (L, d) is contiguous, so a pair's keys and values are copied into
//     shared memory as one flat, coalesced run (no per-element index
//     arithmetic), up to 512 keys at a time -- at L <= 512 (every call of the
//     flagship) the block stages once, synchronises once, and then loops
//     over all keys without another barrier;
//   - one thread owns one query row (forward, dQ) or one key row (dK, dV):
//     q (or k and v), the running max, the running sum and the d
//     accumulators live in registers; every thread of a block reads the same
//     key at the same time, so shared memory serves it as a broadcast;
//   - the scores are scaled by log2(e)/sqrt(d) once, in q, so every
//     exponential is exp2f;
//   - the forward's online softmax takes the keys four at a time: one max of
//     four scores, and at most one rescale of the accumulators per four keys
//     (a branch that warps seldom diverge on).
//
// Backward: the forward writes each row's log-sum-exp, so P = exp(S - lse) is recomputed pair by pair with no max pass,
// and rowsum(dP o P) is taken as the equal rowsum(dO o O).  Two launches,
// each owning its outputs, no atomics (two runs give equal gradients bit for
// bit):
//   1. query-parallel: D = rowsum(dO o O) of the row, then
//      dQ = sum_k P (dP - D) K / sqrt(d); D goes to a (b*h, Lq) buffer;
//   2. key-parallel: dV = sum_q P dO and dK = sum_q P (dP - D) Q / sqrt(d),
//      with q (pre-scaled), dO, lse and D of up to 512 queries staged at a
//      time.
// Each exponential is computed twice in the backward, once per launch: the
// price of not reducing across blocks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;     // query (or key) rows per block, one per thread
constexpr int STAGE = 512;   // keys (or queries) staged in shared memory
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// rows [r0, r0 + n) of a contiguous (L, D) matrix into shared memory, as one
// flat copy, each value times `scale`
template <int D>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int r0, int n, float scale) {
  const float* from = src + (size_t)r0 * D;
  for (int i = threadIdx.x; i < n * D; i += ROWS) dst[i] = from[i] * scale;
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D],
                                     const float* __restrict__ b) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) s = fmaf(a[j], b[j], s);
  return s;
}

template <int D>
__global__ void __launch_bounds__(ROWS)
small_head_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int Lq, int Lk, int stage,
                      float q_scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                // [stage][D]
  float* vs = smem + stage * D;    // [stage][D]

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
    if (k0 > 0) __syncthreads();  // the previous keys are consumed
    stage_rows<D>(ks, kb, k0, n, 1.f);
    stage_rows<D>(vs, vb, k0, n, 1.f);
    __syncthreads();

    int t = 0;
    for (; t + 4 <= n; t += 4) {
      float s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] = dot<D>(qr, ks + (t + u) * D);
      const float m = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
      if (m > run_max) {
        const float c = exp2f(run_max - m);
        run_sum *= c;
#pragma unroll
        for (int j = 0; j < D; ++j) acc[j] *= c;
        run_max = m;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = exp2f(s[u] - run_max);
        run_sum += p;
        const float* vt = vs + (t + u) * D;
#pragma unroll
        for (int j = 0; j < D; ++j) acc[j] = fmaf(p, vt[j], acc[j]);
      }
    }
    for (; t < n; ++t) {  // the last n % 4 keys
      const float s = dot<D>(qr, ks + t * D);
      if (s > run_max) {
        const float c = exp2f(run_max - s);
        run_sum *= c;
#pragma unroll
        for (int j = 0; j < D; ++j) acc[j] *= c;
        run_max = s;
      }
      const float p = exp2f(s - run_max);
      run_sum += p;
      const float* vt = vs + t * D;
#pragma unroll
      for (int j = 0; j < D; ++j) acc[j] = fmaf(p, vt[j], acc[j]);
    }
  }

  if (live) {
    const float inv = 1.f / run_sum;
    float* orow = o + (bh * Lq + row) * D;
#pragma unroll
    for (int j = 0; j < D; ++j) orow[j] = acc[j] * inv;
    lse[bh * Lq + row] = (run_max + log2f(run_sum)) * LN2;
  }
}

// 1. query-parallel: D = rowsum(dO o O), then dQ
template <int D>
__global__ void __launch_bounds__(ROWS)
small_head_bwd_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ lse,
                         const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ delta,
                         int Lq, int Lk, int stage, float q_scale,
                         float scale) {
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
    stage_rows<D>(ks, kb, k0, n, 1.f);
    stage_rows<D>(vs, vb, k0, n, 1.f);
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float* kt = ks + t * D;
      const float s = dot<D>(qr, kt);
      const float dp = dot<D>(dor, vs + t * D);
      const float ds = exp2f(s - lse2) * (dp - dsum);
#pragma unroll
      for (int j = 0; j < D; ++j) acc[j] = fmaf(ds, kt[j], acc[j]);
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < D; ++j) dq[at + j] = acc[j] * scale;
    delta[bh * Lq + row] = dsum;
  }
}

// 2. key-parallel: dK and dV
template <int D>
__global__ void __launch_bounds__(ROWS)
small_head_bwd_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ dout,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Lq, int Lk, int stage, float q_scale,
                          float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [stage][D], q * q_scale
  float* dos = smem + stage * D;       // [stage][D]
  float* lses = smem + 2 * stage * D;  // [stage], base 2
  float* dels = lses + stage;          // [stage]

  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;  // key row
  const bool live = row < Lk;
  const float* qb = q + bh * Lq * D;
  const float* dob = dout + bh * Lq * D;
  const size_t at = (bh * Lk + row) * D;

  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    kr[j] = live ? k[at + j] : 0.f;
    vr[j] = live ? v[at + j] : 0.f;
    dka[j] = 0.f;
    dva[j] = 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += stage) {
    const int n = min(stage, Lq - q0);
    if (q0 > 0) __syncthreads();
    stage_rows<D>(qs, qb, q0, n, q_scale);
    stage_rows<D>(dos, dob, q0, n, 1.f);
    for (int i = threadIdx.x; i < n; i += ROWS) {
      lses[i] = lse[bh * Lq + q0 + i] * LOG2E;
      dels[i] = delta[bh * Lq + q0 + i];
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float* qt = qs + t * D;
      const float* dot_ = dos + t * D;
      const float s = dot<D>(kr, qt);
      const float dp = dot<D>(vr, dot_);
      const float p = exp2f(s - lses[t]);
      const float ds = p * (dp - dels[t]);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        dva[j] = fmaf(p, dot_[j], dva[j]);
        dka[j] = fmaf(ds, qt[j], dka[j]);
      }
    }
  }

  if (live) {
    // dka holds sum ds * q * q_scale; dK wants sum ds * q * scale
    const float to_dk = scale / q_scale;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      dk[at + j] = dka[j] * to_dk;
      dv[at + j] = dva[j];
    }
  }
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int BH, int Lq, int Lk, cudaStream_t stream) {
  const float q_scale = LOG2E / sqrtf((float)D);
  const int stage = min(STAGE, Lk);
  const size_t smem = 2 * (size_t)stage * D * sizeof(float);
  small_head_fwd_kernel<D>
      <<<dim3(BH, (Lq + ROWS - 1) / ROWS), ROWS, smem, stream>>>(
          q, k, v, o, lse, Lq, Lk, stage, q_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v, const float* o,
               const float* lse, const float* dout, float* dq, float* dk,
               float* dv, float* delta, int BH, int Lq, int Lk,
               cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  const float q_scale = LOG2E * scale;
  const int stage_k = min(STAGE, Lk);
  small_head_bwd_dq_kernel<D>
      <<<dim3(BH, (Lq + ROWS - 1) / ROWS), ROWS,
         2 * (size_t)stage_k * D * sizeof(float), stream>>>(
          q, k, v, o, lse, dout, dq, delta, Lq, Lk, stage_k, q_scale, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int stage_q = min(STAGE, Lq);
  small_head_bwd_dkv_kernel<D>
      <<<dim3(BH, (Lk + ROWS - 1) / ROWS), ROWS,
         (size_t)stage_q * (2 * D + 2) * sizeof(float), stream>>>(
          q, k, v, lse, delta, dout, dk, dv, Lq, Lk, stage_q, q_scale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define SMALL_HEAD_DISPATCH(CALL)          \
  switch (d) {                             \
    case 1: return CALL(1);                \
    case 2: return CALL(2);                \
    case 3: return CALL(3);                \
    case 4: return CALL(4);                \
    case 5: return CALL(5);                \
    case 6: return CALL(6);                \
    case 7: return CALL(7);                \
    case 8: return CALL(8);                \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// q (BH, Lq, d), k and v (BH, Lk, d), o (BH, Lq, d), all contiguous fp32;
// lse (BH, Lq): the natural-log log-sum-exp of each row's scaled
// scores, for the backward.  1 <= d <= 8, Lq >= 1, Lk >= 1, BH >= 1.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a d it
// does not take).
int small_head_attention_fwd(const float* q, const float* k, const float* v,
                             float* o, float* lse, int BH, int Lq, int Lk,
                             int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define FWD(D) launch_fwd<D>(q, k, v, o, lse, BH, Lq, Lk, s)
  SMALL_HEAD_DISPATCH(FWD)
#undef FWD
}

// The VJP: q, k, v, o, lse as the forward saw and wrote them, dout (BH, Lq,
// d) the cotangent of o; writes dq (BH, Lq, d), dk and dv (BH, Lk, d), and
// uses delta (BH, Lq) as scratch.  Two launches; returns the first failure.
int small_head_attention_bwd(const float* q, const float* k, const float* v,
                             const float* o, const float* lse,
                             const float* dout, float* dq, float* dk,
                             float* dv, float* delta, int BH, int Lq, int Lk,
                             int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define BWD(D) launch_bwd<D>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, s)
  SMALL_HEAD_DISPATCH(BWD)
#undef BWD
}

}  // extern "C"
