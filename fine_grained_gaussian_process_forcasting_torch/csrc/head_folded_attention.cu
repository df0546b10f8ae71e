// Softmax attention for small head dims, forward and backward, fp32 -- for
// sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/
//   head_folded_attention.py `_fwd_kernel` (reached through
//   `head_folded_attention`, `_fwd`) and `_bwd_kernel` (through `_bwd`):
//   per (batch, head), out = softmax(q k^T / sqrt(d)) v with the (Lq, Lk)
//   scores kept on chip, and its VJP
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dP o P)),
//     dQ = dS K / sqrt(d),  dK = dS^T Q / sqrt(d).
//
// What bounds it on an H100: at d = 4 a (query, key) pair costs 2*d flops of
// scores, 2*d of output and one exponential, so the special-function units
// (16 exp/clock/SM) and the issue rate bound it, not memory: the enc-self
// call of the flagship (b 256, h 8, L 192) moves 25 MB but evaluates 75.5 M
// exponentials.  The backward is bound the same way: each pass recomputes
// one exponential and about 6*d flops per pair.  The TPU kernel folded heads
// into lanes to avoid padding a 4-wide head to 128 lanes; a GPU thread has
// no lanes to fill, so the port keeps the (b, h, L, d) layout and gives each
// query row (forward, dQ) or key row (dK, dV) one thread.
//
// Forward: one block of 64 threads per (batch*head, 64 query rows).  K and V
// of that head stream through shared memory in chunks of 64 keys (read as
// broadcasts: every thread of the block reads the same key), and each thread
// keeps an online softmax (running max, running sum, d accumulators) in
// registers -- the scores never exist as a tile anywhere.  When the caller
// passes an lse buffer (training), the row's log-sum-exp of the scaled
// scores is written to it as well; serving passes none.
//
// Backward: the TPU kernel recomputed the whole (L, L) softmax of a head in
// VMEM.  Here P = exp(S - lse) is recomputed pair by pair from the forward's
// lse, with no second max pass, and rowsum(dP o P) is replaced by the equal
// D = rowsum(dO o O).  dQ reduces over keys, dK and dV over queries, so the
// work is split in two launches that each own their outputs:
//   1. query-parallel (one thread per query row): D of the row, then
//      dQ = sum_k P (dP - D) K, keys and values streamed through shared
//      memory as in the forward; D goes to a (b*h, Lq) buffer;
//   2. key-parallel (one thread per key row): dV = sum_q P dO and
//      dK = sum_q P (dP - D) Q, queries, dO, lse and D streamed through
//      shared memory.
// No atomics: every output element is summed by one thread in a fixed
// order, so the backward is deterministic run to run.  It computes each
// exponential twice (once per pass), which is the price of not reducing
// across blocks.
//
// The head dim is padded in registers to a compile-time DP in
// {4, 8, 16, 32, 64} with zeros, which leaves every sum unchanged; any
// d < 64 is taken.  Lq != Lk (cross-attention) is just two lengths.  Scores
// are scaled by log2(e)/sqrt(d) once, in q, so the exponentials are exp2f
// and the lse is kept in base 2 inside the kernels (natural log outside).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;  // query (or key) rows, one per thread, per block
constexpr int KC = 64;    // rows per shared-memory chunk
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DP>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         int row, int n, int d, float scale,
                                         float (&dst)[DP]) {
#pragma unroll
  for (int j = 0; j < DP; ++j)
    dst[j] = (row < n && j < d) ? src[(size_t)row * d + j] * scale : 0.f;
}

// chunk of `n` rows (of KC) starting at row k0 of a (L, d) matrix into
// shared memory [KC][DP], zero-padded
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

template <int DP>
__global__ void __launch_bounds__(ROWS)
head_folded_attention_fwd_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ o,
                                 float* __restrict__ lse, int Lq, int Lk,
                                 int d, float q_scale) {
  __shared__ __align__(16) float ks[KC][DP];
  __shared__ __align__(16) float vs[KC][DP];

  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;
  const float* kb = k + bh * Lk * d;
  const float* vb = v + bh * Lk * d;

  float qr[DP];
  float acc[DP];
  load_row<DP>(q + bh * Lq * d, row, Lq, d, q_scale, qr);
#pragma unroll
  for (int j = 0; j < DP; ++j) acc[j] = 0.f;
  float run_max = -INFINITY;
  float run_sum = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += KC) {
    const int n = min(KC, Lk - k0);
    __syncthreads();  // the previous chunk is consumed
    stage<DP>(ks, kb, k0, n, d);
    stage<DP>(vs, vb, k0, n, d);
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) s = fmaf(qr[j], ks[t][j], s);
      if (s > run_max) {
        const float c = exp2f(run_max - s);
        run_sum *= c;
#pragma unroll
        for (int j = 0; j < DP; ++j) acc[j] *= c;
        run_max = s;
      }
      const float p = exp2f(s - run_max);
      run_sum += p;
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[j] = fmaf(p, vs[t][j], acc[j]);
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

// 1. query-parallel: D = rowsum(dO o O) and dQ
template <int DP>
__global__ void __launch_bounds__(ROWS)
head_folded_attention_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ delta, int Lq, int Lk, int d,
    float q_scale, float scale) {
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
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        s = fmaf(qr[j], ks[t][j], s);
        dp = fmaf(dor[j], vs[t][j], dp);
      }
      const float ds = exp2f(s - lse2) * (dp - dsum);
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[j] = fmaf(ds, ks[t][j], acc[j]);
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

// 2. key-parallel: dK and dV
template <int DP>
__global__ void __launch_bounds__(ROWS)
head_folded_attention_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, int Lq, int Lk, int d,
    float q_scale, float scale) {
  __shared__ __align__(16) float qs[KC][DP];
  __shared__ __align__(16) float dos[KC][DP];
  __shared__ float lses[KC];
  __shared__ float ds_[KC];

  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;  // key row
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
    // q scaled by log2(e)/sqrt(d) for the scores; dK uses unscaled q, so
    // the factor is divided out again at the end
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
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        s = fmaf(qs[t][j], kr[j], s);
        dp = fmaf(dos[t][j], vr[j], dp);
      }
      const float p = exp2f(s - lses[t]);
      const float ds = p * (dp - ds_[t]);
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        dva[j] = fmaf(p, dos[t][j], dva[j]);
        dka[j] = fmaf(ds, qs[t][j], dka[j]);
      }
    }
  }

  if (row < Lk) {
    // dka holds sum ds * q * q_scale; dK wants sum ds * q * scale
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

template <int DP>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int BH, int Lq, int Lk, int d, cudaStream_t stream) {
  const float q_scale = LOG2E / sqrtf((float)d);
  const dim3 grid(BH, (Lq + ROWS - 1) / ROWS);
  head_folded_attention_fwd_kernel<DP><<<grid, ROWS, 0, stream>>>(
      q, k, v, o, lse, Lq, Lk, d, q_scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const float* q, const float* k, const float* v, const float* o,
               const float* lse, const float* dout, float* dq, float* dk,
               float* dv, float* delta, int BH, int Lq, int Lk, int d,
               cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)d);
  const float q_scale = LOG2E * scale;
  head_folded_attention_bwd_dq_kernel<DP>
      <<<dim3(BH, (Lq + ROWS - 1) / ROWS), ROWS, 0, stream>>>(
          q, k, v, o, lse, dout, dq, delta, Lq, Lk, d, q_scale, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_folded_attention_bwd_dkv_kernel<DP>
      <<<dim3(BH, (Lk + ROWS - 1) / ROWS), ROWS, 0, stream>>>(
          q, k, v, lse, delta, dout, dk, dv, Lq, Lk, d, q_scale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (BH, Lq, d), k and v (BH, Lk, d), o (BH, Lq, d), all contiguous fp32;
// lse (BH, Lq) or null: the natural-log log-sum-exp of each row's scaled
// scores, for the backward.  1 <= d < 64.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a d it does not take).
int head_folded_attention_fwd(const float* q, const float* k, const float* v,
                              float* o, float* lse, int BH, int Lq, int Lk,
                              int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d < 1 || d >= 64) return (int)cudaErrorInvalidValue;
  if (d <= 4) return launch_fwd<4>(q, k, v, o, lse, BH, Lq, Lk, d, s);
  if (d <= 8) return launch_fwd<8>(q, k, v, o, lse, BH, Lq, Lk, d, s);
  if (d <= 16) return launch_fwd<16>(q, k, v, o, lse, BH, Lq, Lk, d, s);
  if (d <= 32) return launch_fwd<32>(q, k, v, o, lse, BH, Lq, Lk, d, s);
  return launch_fwd<64>(q, k, v, o, lse, BH, Lq, Lk, d, s);
}

// The VJP: q, k, v, o, lse as the forward saw and wrote them, dout (BH, Lq,
// d) the cotangent of o; writes dq (BH, Lq, d), dk and dv (BH, Lk, d), and
// uses delta (BH, Lq) as scratch.  Two launches; returns the first failure.
int head_folded_attention_bwd(const float* q, const float* k, const float* v,
                              const float* o, const float* lse,
                              const float* dout, float* dq, float* dk,
                              float* dv, float* delta, int BH, int Lq, int Lk,
                              int d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d < 1 || d >= 64) return (int)cudaErrorInvalidValue;
  if (d <= 4)
    return launch_bwd<4>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, d, s);
  if (d <= 8)
    return launch_bwd<8>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, d, s);
  if (d <= 16)
    return launch_bwd<16>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, d, s);
  if (d <= 32)
    return launch_bwd<32>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, d, s);
  return launch_bwd<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, d, s);
}

}  // extern "C"
