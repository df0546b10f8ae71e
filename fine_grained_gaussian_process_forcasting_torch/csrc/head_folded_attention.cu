// Softmax attention for small head dims, forward, fp32 -- for sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/
//   head_folded_attention.py `_fwd_kernel` (reached through
//   `head_folded_attention`, `_fwd`): per (batch, head),
//   out = softmax(q k^T / sqrt(d)) v, with the (Lq, Lk) scores kept on chip.
//
// What bounds it on an H100: at d = 4 a (query, key) pair costs 2*d flops of
// scores, 2*d of output and one exponential, so the special-function units
// (16 exp/clock/SM) and the issue rate bound it, not memory: the enc-self
// call of the flagship (b 256, h 8, L 192) moves 25 MB but evaluates 75.5 M
// exponentials.  The TPU kernel folded heads into lanes to avoid padding a
// 4-wide head to 128 lanes; a GPU thread has no lanes to fill, so the port
// keeps the (b, h, L, d) layout and gives each query row one thread.
//
// Design: one block of 64 threads per (batch*head, 64 query rows).  K and V
// of that head stream through shared memory in chunks of 64 keys (read as
// broadcasts: every thread of the block reads the same key), and each thread
// keeps an online softmax (running max, running sum, d accumulators) in
// registers -- the scores never exist as a tile anywhere.  The head dim is
// padded in registers to a compile-time DP in {4, 8, 16, 32, 64} with zeros,
// which leaves the scores unchanged; any d < 64 is taken.  Lq != Lk
// (cross-attention) is just two lengths.  Scores are scaled by
// log2(e)/sqrt(d) once, in q, so the exponentials are exp2f.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;  // query rows (threads) per block
constexpr int KC = 64;    // keys per shared-memory chunk

template <int DP>
__global__ void __launch_bounds__(ROWS)
head_folded_attention_fwd_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ o, int Lq, int Lk, int d,
                                 float q_scale) {
  __shared__ __align__(16) float ks[KC][DP];
  __shared__ __align__(16) float vs[KC][DP];

  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;
  const float* qb = q + bh * Lq * d;
  const float* kb = k + bh * Lk * d;
  const float* vb = v + bh * Lk * d;

  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    qr[j] = (row < Lq && j < d) ? qb[(size_t)row * d + j] * q_scale : 0.f;
    acc[j] = 0.f;
  }
  float run_max = -INFINITY;
  float run_sum = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += KC) {
    const int n = min(KC, Lk - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < KC * DP; i += ROWS) {
      const int key = i / DP;
      const int j = i - key * DP;
      const bool ok = key < n && j < d;
      const size_t at = (size_t)(k0 + key) * d + j;
      ks[key][j] = ok ? kb[at] : 0.f;
      vs[key][j] = ok ? vb[at] : 0.f;
    }
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
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o, int BH,
           int Lq, int Lk, int d, float q_scale, cudaStream_t stream) {
  const dim3 grid(BH, (Lq + ROWS - 1) / ROWS);
  head_folded_attention_fwd_kernel<DP><<<grid, ROWS, 0, stream>>>(
      q, k, v, o, Lq, Lk, d, q_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (BH, Lq, d), k and v (BH, Lk, d), o (BH, Lq, d), all contiguous fp32;
// 1 <= d < 64.  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a d it does not take).
int head_folded_attention_fwd(const float* q, const float* k, const float* v,
                              float* o, int BH, int Lq, int Lk, int d,
                              void* stream) {
  const float q_scale = 1.4426950408889634f / sqrtf((float)d);  // log2(e)/sqrt(d)
  cudaStream_t s = (cudaStream_t)stream;
  if (d < 1 || d >= 64) return (int)cudaErrorInvalidValue;
  if (d <= 4) return launch<4>(q, k, v, o, BH, Lq, Lk, d, q_scale, s);
  if (d <= 8) return launch<8>(q, k, v, o, BH, Lq, Lk, d, q_scale, s);
  if (d <= 16) return launch<16>(q, k, v, o, BH, Lq, Lk, d, q_scale, s);
  if (d <= 32) return launch<32>(q, k, v, o, BH, Lq, Lk, d, q_scale, s);
  return launch<64>(q, k, v, o, BH, Lq, Lk, d, q_scale, s);
}

}  // extern "C"
