// Fused softmax attention for head dims 64 <= d < 128, forward and backward,
// bf16 and fp32 -- for sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/
//   flash_attention.py `_fwd_kernel` (reached through `fused_attention`
//   and `fused_attention_bf16sm`, `_fwd`) and `_bwd_kernel` (through
//   `_bwd`): per (batch, head), o = softmax(q k^T / sqrt(d)) v with the
//   scores kept on chip, and its VJP
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dP o P)),
//     dQ = dS K / sqrt(d),  dK = dS^T Q / sqrt(d).
//   bf16 operands: the products take bf16 inputs and sum in fp32; P and dS
//   are rounded to bf16 before their products; the softmax and dS are fp32.
//   fp32 operands: every product in fp32 FMAs on the CUDA cores (TF32 would
//   break the 1e-4 parity with the reference).
//
// What bounds it on an H100: operations.  The production-width encoder call
// (b 64, h 8, L 512, d 64, bf16) is 4*b*h*L*L*d = 34 GFLOP of products
// (35 us at the tensor cores' 989 TFLOP/s) and 134 M exponentials (32 us at
// 16 per SM per clock), against 0.13 GB of q, k, v, o (40 us at 3.35 TB/s):
// the three are of one size, so the scores must never reach device memory
// and the exponentials must overlap the products.
//
// How the design differs from the TPU's: the Pallas program holds one
// (batch, head)'s whole (L, L) score matrix in VMEM (1 MiB at L 512 in
// fp32, over four times a block's shared memory here) and pads d to the
// 128-lane width.  Here the queries are tiled, 64 rows a block on a grid of
// (b*h, L/64), the keys stream through shared memory 64 at a time and an
// online softmax (running max and sum per row) rescales the output
// accumulators, so no score tile ever exists outside registers.  d is taken
// as it is (a multiple of 16 for bf16, 8 for fp32); lengths that are not a
// multiple of 64 are masked, nothing is padded in device memory.  When the
// caller passes an lse buffer (training), each row's log-sum-exp of the
// scaled scores is written for the backward.
//
// bf16 kernels: 4 warps a block, each owning 16 query (or key) rows, on
// `mma.sync.m16n8k16` with fp32 accumulators.  Q (or K and V, in the
// key-parallel launch) stays in registers as A fragments; the streamed
// operand sits in shared memory once, rows as they come, and `ldmatrix`
// reads its B fragments both ways: plain for the products that sum over d
// (q k^T, dO v^T) and transposed for those that sum over the streamed index
// (P v, dS k, P^T dO, dS^T q).  The accumulator layout of one product is
// the A-fragment layout of the next, so P and dS go from fp32 registers to
// bf16 registers without touching shared memory.
//
// Backward: P = exp(S - lse) is recomputed tile by tile from the forward's
// lse, and rowsum(dP o P) is replaced by the equal D = rowsum(dO o O).  dQ
// sums over keys, dK and dV over queries, so the work is two launches that
// each own their outputs:
//   1. query-parallel: D of each row (kept for launch 2), then
//      dQ = sum_k P (dP - D) K;
//   2. key-parallel: S^T = K Q^T and dP^T = V dO^T computed transposed, so
//      that P^T and dS^T come out as A fragments; dV = P^T dO, dK = dS^T Q.
// No atomics: every output element is summed by one warp in a fixed order,
// so two runs give equal gradients bit for bit, at the price of computing
// S and P twice.
//
// The sm_bf16 variant (`fused_attention_bf16sm`) subtracts the row's max in
// fp32 and then runs the exponential, the sum and the division on bf16
// values (the sum itself in fp32): p = bf16(bf16(exp(bf16(s - max))) /
// bf16(sum)).  What is rounded depends on the row's final max and sum, so a
// running max cannot serve: its forward streams the keys three times (max,
// then sum, then P v with the final p; q k^T is computed each time) and
// saves the max and the rounded sum in the place of the lse; the backward
// kernels are the same two launches with that p.
//
// fp32 kernels: four threads share a row (each holds a quarter of d in
// registers), the streamed rows are read from shared memory as broadcasts,
// and two shuffles finish each dot product; otherwise the same three
// launches.  Scores are scaled by log2(e)/sqrt(d) so the exponentials are
// exp2f; lse is natural-log outside the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BR = 64;        // rows (queries or keys) a block owns
constexpr int BC = 64;        // streamed rows per shared-memory chunk
constexpr int MMA_THREADS = 128;
constexpr int F32_THREADS = 4 * BR;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sm_bf16: exp of a max-subtracted score on bf16 values
__device__ __forceinline__ float exp_bf16(float s_minus_max) {
  return round_bf16(expf(round_bf16(s_minus_max)));
}

// The probability of a score s2 (scaled by log2(e)/sqrt(d)) from its row's
// saved statistics.  SM16 false: st0 = lse * log2(e).  SM16 true: st0 = the
// row's max in natural units, st1 = its bf16-rounded sum.
template <bool SM16>
__device__ __forceinline__ float prob(float s2, float st0, float st1) {
  if constexpr (SM16) return round_bf16(exp_bf16(s2 * LN2 - st0) / st1);
  return exp2f(s2 - st0);
}

// a row's statistics from the buffer the forward wrote: (BH, Lq) lse, or
// (2, BH, Lq) max and sum.  `none`: the st0 of a row past the end.
template <bool SM16>
__device__ __forceinline__ void load_stats(const float* __restrict__ stats,
                                           size_t at, size_t plane, bool ok,
                                           float none, float& st0,
                                           float& st1) {
  st0 = ok ? (SM16 ? stats[at] : stats[at] * LOG2E) : none;
  st1 = (SM16 && ok) ? stats[plane + at] : 1.f;
}

// ---------------------------------------------------------------- bf16 ----

// A chunk of BC rows of a (L, D) bf16 matrix on its way from device memory
// to shared memory [BC][D + 8]: `fetch` starts the loads of the `n` rows
// from r0 into registers (zeros beyond n), `stash` stores them.  A kernel
// fetches the next chunk before it computes on the current one, so the
// loads' latency hides behind the products.
template <int D>
struct Chunk {
  static constexpr int SEG = D / 8;
  static constexpr int N = BC * SEG / MMA_THREADS;
  uint4 r[N];

  __device__ __forceinline__ void fetch(const bf16* __restrict__ src, int r0,
                                        int n) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const int i = threadIdx.x + c * MMA_THREADS;
      const int row = i / SEG;
      const int seg = i - row * SEG;
      r[c] = row < n ? __ldg(reinterpret_cast<const uint4*>(
                           src + (size_t)(r0 + row) * D + seg * 8))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void stash(bf16* rows) const {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const int i = threadIdx.x + c * MMA_THREADS;
      const int row = i / SEG;
      const int seg = i - row * SEG;
      *reinterpret_cast<uint4*>(rows + row * (D + 8) + seg * 8) = r[c];
    }
  }
};

// the two in one step, where nothing is there to overlap
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* rows,
                                           const bf16* __restrict__ src,
                                           int r0, int n) {
  Chunk<D> chunk;
  chunk.fetch(src, r0, n);
  chunk.stash(rows);
}

// A fragments of the 16 rows `row_a` (lanes' g) and row_a + 8 of a (L, D)
// matrix in device memory; rows >= L are zeros
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4],
                                             const bf16* __restrict__ src,
                                             int row_a, int L, int t) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* pa = src + (size_t)row_a * D + kk * 16 + 2 * t;
    const bf16* pb = src + (size_t)row_b * D + kk * 16 + 2 * t;
    a[kk][0] = row_a < L ? __ldg(reinterpret_cast<const uint32_t*>(pa)) : 0u;
    a[kk][1] = row_b < L ? __ldg(reinterpret_cast<const uint32_t*>(pb)) : 0u;
    a[kk][2] = row_a < L ? __ldg(reinterpret_cast<const uint32_t*>(pa + 8)) : 0u;
    a[kk][3] = row_b < L ? __ldg(reinterpret_cast<const uint32_t*>(pb + 8)) : 0u;
  }
}

// c0, c1 (16 x 8 each) = A (16 x D, fragments) * rows[n0 .. n0 + 15][:]^T
// for the 8 streamed rows from n0 and the 8 from n0 + 8; rows [BC][D + 8].
// One ldmatrix.x4 per 16 columns of d: lanes 8 m .. 8 m + 7 address the
// rows of matrix m = (rows n0 + 8 (m >> 1).., columns 16 kk + 8 (m & 1)..).
template <int D>
__device__ __forceinline__ void dot_rows(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[D / 16][4],
                                         const bf16* rows, int n0, int lane) {
  c0[0] = c0[1] = c0[2] = c0[3] = 0.f;
  c1[0] = c1[1] = c1[2] = c1[3] = 0.f;
  const int m = lane >> 3;
  const bf16* p = rows + (n0 + (lane & 7) + 8 * (m >> 1)) * (D + 8) + 8 * (m & 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, p + kk * 16);
    mma_bf16(c0, a[kk], b[0], b[1]);
    mma_bf16(c1, a[kk], b[2], b[3]);
  }
}

// acc[dt] (16 x 8 each, D / 8 of them) += A (16 x 16 fragment over the
// streamed rows 16 j ..) * rows[16 j .. 16 j + 15][:].  One transposing
// ldmatrix.x4 per 16 columns of d: matrix m = (rows 16 j + 8 (m & 1)..,
// columns 16 dp + 8 (m >> 1)..).
template <int D>
__device__ __forceinline__ void accumulate_rows(float (&acc)[D / 8][4],
                                                const uint32_t (&a)[4],
                                                const bf16* rows, int j,
                                                int lane) {
  const int m = lane >> 3;
  const bf16* p = rows + (j * 16 + (lane & 7) + 8 * (m & 1)) * (D + 8) + 8 * (m >> 1);
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, p + dp * 16);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int Lq, int Lk,
                      float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BC][D + 8]
  bf16* vs = ks + BC * (D + 8);                  // [BC][D + 8]

  const size_t bh = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_a = blockIdx.y * BR + warp * 16 + g;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;

  uint32_t qa[D / 16][4];
  load_a_frags<D>(qa, q + bh * Lq * D, row_a, Lq, t);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float max_a = -INFINITY, max_b = -INFINITY;  // rows g and g + 8
  float sum_a = 0.f, sum_b = 0.f;              // this lane's share

  Chunk<D> kc, vc;
  kc.fetch(kb, 0, min(BC, Lk));
  vc.fetch(vb, 0, min(BC, Lk));
  for (int k0 = 0; k0 < Lk; k0 += BC) {
    const int n = min(BC, Lk - k0);
    __syncthreads();  // the previous chunk is consumed
    kc.stash(ks);
    vc.stash(vs);
    __syncthreads();
    if (k0 + BC < Lk) {  // the next chunk's loads fly during the products
      kc.fetch(kb, k0 + BC, min(BC, Lk - k0 - BC));
      vc.fetch(vb, k0 + BC, min(BC, Lk - k0 - BC));
    }

    float s[BC / 8][4];
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BC / 16; ++j)
      dot_rows<D>(s[2 * j], s[2 * j + 1], qa, ks, j * 16, lane);
#pragma unroll
    for (int nt = 0; nt < BC / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        s[nt][e] = col < n ? s[nt][e] * scale_log2 : -INFINITY;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    const float new_a = fmaxf(max_a, quad_max(mx_a));  // finite: n >= 1
    const float new_b = fmaxf(max_b, quad_max(mx_b));
    const float corr_a = exp2f(max_a - new_a);
    const float corr_b = exp2f(max_b - new_b);
    max_a = new_a;
    max_b = new_b;
    sum_a *= corr_a;
    sum_b *= corr_b;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr_a; acc[dt][1] *= corr_a;
      acc[dt][2] *= corr_b; acc[dt][3] *= corr_b;
    }
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      uint32_t pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float (&sv)[4] = s[2 * j + h];
        sv[0] = exp2f(sv[0] - max_a); sv[1] = exp2f(sv[1] - max_a);
        sv[2] = exp2f(sv[2] - max_b); sv[3] = exp2f(sv[3] - max_b);
        sum_a += sv[0] + sv[1];
        sum_b += sv[2] + sv[3];
        pa[2 * h] = pack_bf16(sv[0], sv[1]);
        pa[2 * h + 1] = pack_bf16(sv[2], sv[3]);
      }
      accumulate_rows<D>(acc, pa, vs, j, lane);
    }
  }

  sum_a = quad_sum(sum_a);
  sum_b = quad_sum(sum_b);
  const float inv_a = 1.f / sum_a, inv_b = 1.f / sum_b;
  const int row_b = row_a + 8;
  bf16* ob = o + bh * Lq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < Lq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * D + col) =
          pack_bf16(acc[dt][0] * inv_a, acc[dt][1] * inv_a);
    if (row_b < Lq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * D + col) =
          pack_bf16(acc[dt][2] * inv_b, acc[dt][3] * inv_b);
  }
  if (lse != nullptr && t == 0) {
    if (row_a < Lq) lse[bh * Lq + row_a] = (max_a + log2f(sum_a)) * LN2;
    if (row_b < Lq) lse[bh * Lq + row_b] = (max_b + log2f(sum_b)) * LN2;
  }
}

// The sm_bf16 forward: three passes over the keys.  stats (2, BH, Lq) or
// null: each row's max (natural units) and bf16-rounded sum.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16sm_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ stats, int Lq, int Lk,
                        float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BC][D + 8]
  bf16* vs = ks + BC * (D + 8);                  // [BC][D + 8]

  const size_t bh = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_a = blockIdx.y * BR + warp * 16 + g;
  const int row_b = row_a + 8;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;

  uint32_t qa[D / 16][4];
  load_a_frags<D>(qa, q + bh * Lq * D, row_a, Lq, t);
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float max_a = -INFINITY, max_b = -INFINITY;
  float sum_a = 0.f, sum_b = 0.f;
  float den_a = 1.f, den_b = 1.f;

  for (int pass = 0; pass < 3; ++pass) {
    for (int k0 = 0; k0 < Lk; k0 += BC) {
      const int n = min(BC, Lk - k0);
      __syncthreads();
      stage_bf16<D>(ks, kb, k0, n);
      if (pass == 2) stage_bf16<D>(vs, vb, k0, n);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < BC / 16; ++j) {
        float s[2][4];
        dot_rows<D>(s[0], s[1], qa, ks, j * 16, lane);
        uint32_t pa[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = j * 16 + h * 8 + 2 * t + (e & 1) < n;
            // natural units by way of the log2 ones, as `prob` takes them
            const float sv = s[h][e] * scale_log2 * LN2;
            const float mx = e < 2 ? max_a : max_b;
            if (pass == 0) {
              if (ok && e < 2) max_a = fmaxf(max_a, sv);
              if (ok && e >= 2) max_b = fmaxf(max_b, sv);
            } else {
              const float ev = ok ? exp_bf16(sv - mx) : 0.f;
              if (pass == 1) {
                if (e < 2) sum_a += ev; else sum_b += ev;
              } else {
                p[e] = round_bf16(ev / (e < 2 ? den_a : den_b));
              }
            }
          }
          if (pass == 2) {
            pa[2 * h] = pack_bf16(p[0], p[1]);
            pa[2 * h + 1] = pack_bf16(p[2], p[3]);
          }
        }
        if (pass == 2) accumulate_rows<D>(acc, pa, vs, j, lane);
      }
    }
    if (pass == 0) {
      max_a = quad_max(max_a);
      max_b = quad_max(max_b);
    } else if (pass == 1) {
      den_a = round_bf16(quad_sum(sum_a));
      den_b = round_bf16(quad_sum(sum_b));
    }
  }

  bf16* ob = o + bh * Lq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < Lq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * D + col) =
          pack_bf16(acc[dt][0], acc[dt][1]);
    if (row_b < Lq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * D + col) =
          pack_bf16(acc[dt][2], acc[dt][3]);
  }
  if (stats != nullptr && t == 0) {
    const size_t plane = (size_t)gridDim.x * Lq;
    if (row_a < Lq) {
      stats[bh * Lq + row_a] = max_a;
      stats[plane + bh * Lq + row_a] = den_a;
    }
    if (row_b < Lq) {
      stats[bh * Lq + row_b] = max_b;
      stats[plane + bh * Lq + row_b] = den_b;
    }
  }
}

// 1. query-parallel: D = rowsum(dO o O) and dQ
template <int D, bool SM16>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const float* __restrict__ lse,
                         const bf16* __restrict__ dout, bf16* __restrict__ dq,
                         float* __restrict__ delta, int Lq, int Lk,
                         float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BC][D + 8]
  bf16* vs = ks + BC * (D + 8);                  // [BC][D + 8]
  float* dl = reinterpret_cast<float*>(vs + BC * (D + 8));  // [BR]

  const size_t bh = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.y * BR;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;
  const bf16* dob = dout + bh * Lq * D;
  const bf16* ob = o + bh * Lq * D;

  // D of the warp's 16 rows, lanes stride over d
  for (int rr = 0; rr < 16; ++rr) {
    const int row = q0 + warp * 16 + rr;
    float part = 0.f;
    if (row < Lq)
      for (int j = lane; j < D; j += 32)
        part = fmaf(__bfloat162float(dob[(size_t)row * D + j]),
                    __bfloat162float(ob[(size_t)row * D + j]), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) {
      dl[warp * 16 + rr] = part;
      if (row < Lq) delta[bh * Lq + row] = part;
    }
  }
  __syncwarp();
  const float d_a = dl[warp * 16 + g], d_b = dl[warp * 16 + g + 8];
  const size_t plane = (size_t)gridDim.x * Lq;
  float st0_a, st1_a, st0_b, st1_b;
  load_stats<SM16>(lse, bh * Lq + row_a, plane, row_a < Lq, 0.f, st0_a, st1_a);
  load_stats<SM16>(lse, bh * Lq + row_b, plane, row_b < Lq, 0.f, st0_b, st1_b);

  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_a_frags<D>(qa, q + bh * Lq * D, row_a, Lq, t);
  load_a_frags<D>(doa, dob, row_a, Lq, t);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  Chunk<D> kc, vc;
  kc.fetch(kb, 0, min(BC, Lk));
  vc.fetch(vb, 0, min(BC, Lk));
  for (int k0 = 0; k0 < Lk; k0 += BC) {
    const int n = min(BC, Lk - k0);
    __syncthreads();
    kc.stash(ks);
    vc.stash(vs);
    __syncthreads();
    if (k0 + BC < Lk) {
      kc.fetch(kb, k0 + BC, min(BC, Lk - k0 - BC));
      vc.fetch(vb, k0 + BC, min(BC, Lk - k0 - BC));
    }

#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      uint32_t dsa[4];
      float s[2][4], dp[2][4];
      dot_rows<D>(s[0], s[1], qa, ks, j * 16, lane);
      dot_rows<D>(dp[0], dp[1], doa, vs, j * 16, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 16 + h * 8 + 2 * t + (e & 1);
          const float p = col < n ? prob<SM16>(s[h][e] * scale_log2,
                                               e < 2 ? st0_a : st0_b,
                                               e < 2 ? st1_a : st1_b)
                                  : 0.f;
          ds[e] = p * (dp[h][e] - (e < 2 ? d_a : d_b));
        }
        dsa[2 * h] = pack_bf16(ds[0], ds[1]);
        dsa[2 * h + 1] = pack_bf16(ds[2], ds[3]);
      }
      accumulate_rows<D>(acc, dsa, ks, j, lane);
    }
  }

  bf16* dqb = dq + bh * Lq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < Lq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row_a * D + col) =
          pack_bf16(acc[dt][0] * scale, acc[dt][1] * scale);
    if (row_b < Lq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row_b * D + col) =
          pack_bf16(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// 2. key-parallel: dK and dV
template <int D, bool SM16>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const bf16* __restrict__ dout, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int Lq, int Lk,
                          float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BC][D + 8]
  bf16* dos = qs + BC * (D + 8);                 // [BC][D + 8]
  float* st0s = reinterpret_cast<float*>(dos + BC * (D + 8));  // [BC]
  float* st1s = st0s + BC;                                     // [BC]
  float* dls = st1s + BC;                                      // [BC]

  const size_t bh = blockIdx.x;
  const size_t plane = (size_t)gridDim.x * Lq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_a = blockIdx.y * BR + warp * 16 + g;  // key rows
  const int row_b = row_a + 8;
  const bf16* qb = q + bh * Lq * D;
  const bf16* dob = dout + bh * Lq * D;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a_frags<D>(ka, k + bh * Lk * D, row_a, Lk, t);
  load_a_frags<D>(va, v + bh * Lk * D, row_a, Lk, t);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  Chunk<D> qc, doc;
  qc.fetch(qb, 0, min(BC, Lq));
  doc.fetch(dob, 0, min(BC, Lq));
  for (int q0 = 0; q0 < Lq; q0 += BC) {
    const int n = min(BC, Lq - q0);
    __syncthreads();
    qc.stash(qs);
    doc.stash(dos);
    if (q0 + BC < Lq) {
      qc.fetch(qb, q0 + BC, min(BC, Lq - q0 - BC));
      doc.fetch(dob, q0 + BC, min(BC, Lq - q0 - BC));
    }
    if (threadIdx.x < BC) {
      const int i = threadIdx.x;
      // a query past the end: lse (or max) = +inf makes its P zero
      load_stats<SM16>(lse, bh * Lq + q0 + i, plane, i < n, INFINITY,
                       st0s[i], st1s[i]);
      dls[i] = i < n ? delta[bh * Lq + q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      uint32_t pa[4], dsa[4];
      float st[2][4], dpt[2][4];
      dot_rows<D>(st[0], st[1], ka, qs, j * 16, lane);    // S^T[key][query]
      dot_rows<D>(dpt[0], dpt[1], va, dos, j * 16, lane);  // dP^T[key][query]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 16 + h * 8 + 2 * t + (e & 1);
          p[e] = prob<SM16>(st[h][e] * scale_log2, st0s[col], st1s[col]);
          ds[e] = p[e] * (dpt[h][e] - dls[col]);
        }
        pa[2 * h] = pack_bf16(p[0], p[1]);
        pa[2 * h + 1] = pack_bf16(p[2], p[3]);
        dsa[2 * h] = pack_bf16(ds[0], ds[1]);
        dsa[2 * h + 1] = pack_bf16(ds[2], ds[3]);
      }
      accumulate_rows<D>(dva, pa, dos, j, lane);
      accumulate_rows<D>(dka, dsa, qs, j, lane);
    }
  }

  bf16* dkb = dk + bh * Lk * D;
  bf16* dvb = dv + bh * Lk * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < Lk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)row_a * D + col) =
          pack_bf16(dka[dt][0] * scale, dka[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)row_a * D + col) =
          pack_bf16(dva[dt][0], dva[dt][1]);
    }
    if (row_b < Lk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)row_b * D + col) =
          pack_bf16(dka[dt][2] * scale, dka[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)row_b * D + col) =
          pack_bf16(dva[dt][2], dva[dt][3]);
    }
  }
}

template <int D>
constexpr int smem_fwd_bf16() { return 2 * BC * (D + 8) * 2; }
template <int D>
constexpr int smem_dq_bf16() { return 2 * BC * (D + 8) * 2 + BR * 4; }
template <int D>
constexpr int smem_dkv_bf16() { return 2 * BC * (D + 8) * 2 + 3 * BC * 4; }

template <int D>
int launch_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                    float* lse, int BH, int Lq, int Lk, int sm16,
                    cudaStream_t stream) {
  constexpr int smem = smem_fwd_bf16<D>();
  const dim3 grid(BH, (Lq + BR - 1) / BR);
  const float scale = 1.f / sqrtf((float)D);
  cudaError_t err;
  if (sm16) {
    err = cudaFuncSetAttribute(flash_fwd_bf16sm_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_bf16sm_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, Lq, Lk,
        LOG2E * scale);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_bf16_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, Lq, Lk,
        LOG2E * scale);
  }
  return (int)cudaGetLastError();
}

template <int D, bool SM16>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                    const float* lse, const void* dout, void* dq, void* dk,
                    void* dv, float* delta, int BH, int Lq, int Lk,
                    cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  const float scale_log2 = LOG2E * scale;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<D, SM16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq_bf16<D>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<D, SM16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv_bf16<D>());
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_bf16_kernel<D, SM16>
      <<<dim3(BH, (Lq + BR - 1) / BR), MMA_THREADS, smem_dq_bf16<D>(), stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, lse,
          (const bf16*)dout, (bf16*)dq, delta, Lq, Lk, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dkv_bf16_kernel<D, SM16>
      <<<dim3(BH, (Lk + BR - 1) / BR), MMA_THREADS, smem_dkv_bf16<D>(), stream>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, lse, delta,
          (const bf16*)dout, (bf16*)dk, (bf16*)dv, Lq, Lk, scale_log2, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 ----
// Thread (row, c) of a quad owns elements 16 j + 4 c + e (e < 4) of the
// row's DP-padded head dim: NV = DP / 16 float4s.

template <int NV>
__device__ __forceinline__ void load_slice(float (&dst)[NV * 4],
                                           const float* __restrict__ src,
                                           int row, int L, int d, int c,
                                           float scale) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int at = 16 * j + 4 * c;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < L && at < d)  // d is a multiple of 4
      val = __ldg(reinterpret_cast<const float4*>(src + (size_t)row * d + at));
    dst[4 * j + 0] = val.x * scale; dst[4 * j + 1] = val.y * scale;
    dst[4 * j + 2] = val.z * scale; dst[4 * j + 3] = val.w * scale;
  }
}

template <int NV>
__device__ __forceinline__ void store_slice(float* __restrict__ dst,
                                            const float (&src)[NV * 4],
                                            int row, int d, int c,
                                            float scale) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int at = 16 * j + 4 * c;
    if (at < d)
      *reinterpret_cast<float4*>(dst + (size_t)row * d + at) =
          make_float4(src[4 * j] * scale, src[4 * j + 1] * scale,
                      src[4 * j + 2] * scale, src[4 * j + 3] * scale);
  }
}

// `n` rows (of BC) from row r0 of a (L, d) fp32 matrix into shared memory
// [BC][DP], zero-padded, scaled
template <int DP>
__device__ __forceinline__ void stage_f32(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int n, int d, float scale) {
  constexpr int SEG = DP / 4;
  for (int i = threadIdx.x; i < BC * SEG; i += F32_THREADS) {
    const int row = i / SEG;
    const int c4 = (i - row * SEG) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n && c4 < d)
      val = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + row) * d + c4));
    val.x *= scale; val.y *= scale; val.z *= scale; val.w *= scale;
    *reinterpret_cast<float4*>(dst + row * DP + c4) = val;
  }
}

// this thread's share of a . row (the quad's sum is the dot product)
template <int NV>
__device__ __forceinline__ float dot_slice(const float (&a)[NV * 4],
                                           const float* row, int c) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float4 r = *reinterpret_cast<const float4*>(row + 16 * j + 4 * c);
    s = fmaf(a[4 * j], r.x, s); s = fmaf(a[4 * j + 1], r.y, s);
    s = fmaf(a[4 * j + 2], r.z, s); s = fmaf(a[4 * j + 3], r.w, s);
  }
  return s;
}

template <int NV>
__device__ __forceinline__ void axpy_slice(float (&acc)[NV * 4], float w,
                                           const float* row, int c) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float4 r = *reinterpret_cast<const float4*>(row + 16 * j + 4 * c);
    acc[4 * j] = fmaf(w, r.x, acc[4 * j]);
    acc[4 * j + 1] = fmaf(w, r.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(w, r.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(w, r.w, acc[4 * j + 3]);
  }
}

template <int DP>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk, int d,
                     float q_scale) {
  constexpr int NV = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [BC][DP]
  float* vs = ks + BC * DP;                        // [BC][DP]

  const size_t bh = blockIdx.x;
  const int c = threadIdx.x & 3;
  const int row = blockIdx.y * BR + (threadIdx.x >> 2);
  const float* kb = k + bh * Lk * d;
  const float* vb = v + bh * Lk * d;

  float qr[NV * 4], acc[NV * 4];
  load_slice<NV>(qr, q + bh * Lq * d, row, Lq, d, c, q_scale);
#pragma unroll
  for (int j = 0; j < NV * 4; ++j) acc[j] = 0.f;
  float run_max = -INFINITY, run_sum = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BC) {
    const int n = min(BC, Lk - k0);
    __syncthreads();
    stage_f32<DP>(ks, kb, k0, n, d, 1.f);
    stage_f32<DP>(vs, vb, k0, n, d, 1.f);
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float s = quad_sum(dot_slice<NV>(qr, ks + t * DP, c));
      if (s > run_max) {
        const float corr = exp2f(run_max - s);
        run_sum *= corr;
#pragma unroll
        for (int j = 0; j < NV * 4; ++j) acc[j] *= corr;
        run_max = s;
      }
      const float p = exp2f(s - run_max);
      run_sum += p;
      axpy_slice<NV>(acc, p, vs + t * DP, c);
    }
  }
  if (row < Lq) {
    store_slice<NV>(o + bh * Lq * d, acc, row, d, c, 1.f / run_sum);
    if (lse != nullptr && c == 0)
      lse[bh * Lq + row] = (run_max + log2f(run_sum)) * LN2;
  }
}

// The sm_bf16 forward in fp32 products: three passes over the keys, as the
// bf16 one.
template <int DP>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32sm_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ stats, int Lq, int Lk, int d,
                       float q_scale) {
  constexpr int NV = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [BC][DP]
  float* vs = ks + BC * DP;                        // [BC][DP]

  const size_t bh = blockIdx.x;
  const int c = threadIdx.x & 3;
  const int row = blockIdx.y * BR + (threadIdx.x >> 2);
  const float* kb = k + bh * Lk * d;
  const float* vb = v + bh * Lk * d;

  float qr[NV * 4], acc[NV * 4];
  load_slice<NV>(qr, q + bh * Lq * d, row, Lq, d, c, q_scale);
#pragma unroll
  for (int j = 0; j < NV * 4; ++j) acc[j] = 0.f;
  float row_max = -INFINITY, sum = 0.f, den = 1.f;

  for (int pass = 0; pass < 3; ++pass) {
    for (int k0 = 0; k0 < Lk; k0 += BC) {
      const int n = min(BC, Lk - k0);
      __syncthreads();
      stage_f32<DP>(ks, kb, k0, n, d, 1.f);
      if (pass == 2) stage_f32<DP>(vs, vb, k0, n, d, 1.f);
      __syncthreads();
      for (int t = 0; t < n; ++t) {
        const float sv = quad_sum(dot_slice<NV>(qr, ks + t * DP, c)) * LN2;
        if (pass == 0) {
          row_max = fmaxf(row_max, sv);
        } else {
          const float ev = exp_bf16(sv - row_max);
          if (pass == 1) sum += ev;
          else axpy_slice<NV>(acc, round_bf16(ev / den), vs + t * DP, c);
        }
      }
    }
    if (pass == 1) den = round_bf16(sum);
  }
  if (row < Lq) {
    store_slice<NV>(o + bh * Lq * d, acc, row, d, c, 1.f);
    if (stats != nullptr && c == 0) {
      stats[bh * Lq + row] = row_max;
      stats[(size_t)gridDim.x * Lq + bh * Lq + row] = den;
    }
  }
}

template <int DP, bool SM16>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout, float* __restrict__ dq,
                        float* __restrict__ delta, int Lq, int Lk, int d,
                        float q_scale, float scale) {
  constexpr int NV = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + BC * DP;

  const size_t bh = blockIdx.x;
  const int c = threadIdx.x & 3;
  const int row = blockIdx.y * BR + (threadIdx.x >> 2);
  const float* kb = k + bh * Lk * d;
  const float* vb = v + bh * Lk * d;

  float qr[NV * 4], dor[NV * 4], acc[NV * 4];
  load_slice<NV>(qr, q + bh * Lq * d, row, Lq, d, c, q_scale);
  load_slice<NV>(dor, dout + bh * Lq * d, row, Lq, d, c, 1.f);
  float dsum = 0.f;
  {
    float orow[NV * 4];
    load_slice<NV>(orow, o + bh * Lq * d, row, Lq, d, c, 1.f);
#pragma unroll
    for (int j = 0; j < NV * 4; ++j) dsum = fmaf(dor[j], orow[j], dsum);
    dsum = quad_sum(dsum);
  }
#pragma unroll
  for (int j = 0; j < NV * 4; ++j) acc[j] = 0.f;
  float st0, st1;
  load_stats<SM16>(lse, bh * Lq + row, (size_t)gridDim.x * Lq, row < Lq, 0.f,
                   st0, st1);

  for (int k0 = 0; k0 < Lk; k0 += BC) {
    const int n = min(BC, Lk - k0);
    __syncthreads();
    stage_f32<DP>(ks, kb, k0, n, d, 1.f);
    stage_f32<DP>(vs, vb, k0, n, d, 1.f);
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float s = quad_sum(dot_slice<NV>(qr, ks + t * DP, c));
      const float dp = quad_sum(dot_slice<NV>(dor, vs + t * DP, c));
      const float ds = prob<SM16>(s, st0, st1) * (dp - dsum);
      axpy_slice<NV>(acc, ds, ks + t * DP, c);
    }
  }
  if (row < Lq) {
    store_slice<NV>(dq + bh * Lq * d, acc, row, d, c, scale);
    if (c == 0) delta[bh * Lq + row] = dsum;
  }
}

template <int DP, bool SM16>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ dout, float* __restrict__ dk,
                         float* __restrict__ dv, int Lq, int Lk, int d,
                         float q_scale, float scale) {
  constexpr int NV = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [BC][DP], scaled
  float* dos = qs + BC * DP;                       // [BC][DP]
  float* st0s = dos + BC * DP;                     // [BC]
  float* st1s = st0s + BC;                         // [BC]
  float* dls = st1s + BC;                          // [BC]

  const size_t bh = blockIdx.x;
  const int c = threadIdx.x & 3;
  const int row = blockIdx.y * BR + (threadIdx.x >> 2);  // key row
  const float* qb = q + bh * Lq * d;
  const float* dob = dout + bh * Lq * d;

  float kr[NV * 4], vr[NV * 4], dka[NV * 4], dva[NV * 4];
  load_slice<NV>(kr, k + bh * Lk * d, row, Lk, d, c, 1.f);
  load_slice<NV>(vr, v + bh * Lk * d, row, Lk, d, c, 1.f);
#pragma unroll
  for (int j = 0; j < NV * 4; ++j) { dka[j] = 0.f; dva[j] = 0.f; }

  for (int q0 = 0; q0 < Lq; q0 += BC) {
    const int n = min(BC, Lq - q0);
    __syncthreads();
    // q scaled by log2(e)/sqrt(d) for the scores; dK wants unscaled q, so
    // the factor is divided out again at the end
    stage_f32<DP>(qs, qb, q0, n, d, q_scale);
    stage_f32<DP>(dos, dob, q0, n, d, 1.f);
    if (threadIdx.x < n) {
      load_stats<SM16>(lse, bh * Lq + q0 + threadIdx.x,
                       (size_t)gridDim.x * Lq, true, 0.f, st0s[threadIdx.x],
                       st1s[threadIdx.x]);
      dls[threadIdx.x] = delta[bh * Lq + q0 + threadIdx.x];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float s = quad_sum(dot_slice<NV>(kr, qs + t * DP, c));
      const float dp = quad_sum(dot_slice<NV>(vr, dos + t * DP, c));
      const float p = prob<SM16>(s, st0s[t], st1s[t]);
      const float ds = p * (dp - dls[t]);
      axpy_slice<NV>(dva, p, dos + t * DP, c);
      axpy_slice<NV>(dka, ds, qs + t * DP, c);
    }
  }
  if (row < Lk) {
    store_slice<NV>(dk + bh * Lk * d, dka, row, d, c, scale / q_scale);
    store_slice<NV>(dv + bh * Lk * d, dva, row, d, c, 1.f);
  }
}

template <int DP>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int Lq, int Lk, int d, int sm16,
                   cudaStream_t stream) {
  constexpr int smem = 2 * BC * DP * 4;
  auto kernel = sm16 ? flash_fwd_f32sm_kernel<DP> : flash_fwd_f32_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(BH, (Lq + BR - 1) / BR), F32_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Lq,
      Lk, d, LOG2E / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <int DP, bool SM16>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, float* delta, int BH, int Lq, int Lk, int d,
                   cudaStream_t stream) {
  constexpr int smem_dq = 2 * BC * DP * 4;
  constexpr int smem_dkv = 2 * BC * DP * 4 + 3 * BC * 4;
  const float scale = 1.f / sqrtf((float)d);
  const float q_scale = LOG2E * scale;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<DP, SM16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel<DP, SM16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_f32_kernel<DP, SM16>
      <<<dim3(BH, (Lq + BR - 1) / BR), F32_THREADS, smem_dq, stream>>>(
          (const float*)q, (const float*)k, (const float*)v, (const float*)o,
          lse, (const float*)dout, (float*)dq, delta, Lq, Lk, d, q_scale, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dkv_f32_kernel<DP, SM16>
      <<<dim3(BH, (Lk + BR - 1) / BR), F32_THREADS, smem_dkv, stream>>>(
          (const float*)q, (const float*)k, (const float*)v, lse, delta,
          (const float*)dout, (float*)dk, (float*)dv, Lq, Lk, d, q_scale, scale);
  return (int)cudaGetLastError();
}

// the VJP launcher of head dim d, operand type and softmax variant
template <bool SM16>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const void* dout, void* dq, void* dk,
                 void* dv, float* delta, int BH, int Lq, int Lk, int d,
                 int bf16, cudaStream_t s) {
  if (bf16) {
    switch (d) {
      case 64: return launch_bwd_bf16<64, SM16>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, s);
      case 80: return launch_bwd_bf16<80, SM16>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, s);
      case 96: return launch_bwd_bf16<96, SM16>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, s);
      default: return launch_bwd_bf16<112, SM16>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, s);
    }
  }
  if (d <= 64) return launch_bwd_f32<64, SM16>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, d, s);
  if (d <= 96) return launch_bwd_f32<96, SM16>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, d, s);
  return launch_bwd_f32<128, SM16>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, d, s);
}

bool takes(int d, int bf16) {
  return d >= 64 && d < 128 && d % (bf16 ? 16 : 8) == 0;
}

}  // namespace

extern "C" {

// q (BH, Lq, d), k and v (BH, Lk, d), o (BH, Lq, d), contiguous, all bf16
// (bf16 != 0) or all fp32.  sm16 != 0: the sm_bf16 softmax.  stats, fp32 or
// null, for the backward: (BH, Lq), the natural-log log-sum-exp of each
// row's scaled scores; with sm16 (2, BH, Lq), each row's max and
// bf16-rounded sum.  64 <= d < 128, a multiple of 16 (bf16) or 8 (fp32).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a d it
// does not take).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* stats, int BH, int Lq, int Lk, int d, int bf16,
                        int sm16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!takes(d, bf16)) return (int)cudaErrorInvalidValue;
  if (bf16) {
    switch (d) {
      case 64: return launch_fwd_bf16<64>(q, k, v, o, stats, BH, Lq, Lk, sm16, s);
      case 80: return launch_fwd_bf16<80>(q, k, v, o, stats, BH, Lq, Lk, sm16, s);
      case 96: return launch_fwd_bf16<96>(q, k, v, o, stats, BH, Lq, Lk, sm16, s);
      default: return launch_fwd_bf16<112>(q, k, v, o, stats, BH, Lq, Lk, sm16, s);
    }
  }
  if (d <= 64) return launch_fwd_f32<64>(q, k, v, o, stats, BH, Lq, Lk, d, sm16, s);
  if (d <= 96) return launch_fwd_f32<96>(q, k, v, o, stats, BH, Lq, Lk, d, sm16, s);
  return launch_fwd_f32<128>(q, k, v, o, stats, BH, Lq, Lk, d, sm16, s);
}

// The VJP: q, k, v, o, stats as the forward saw and wrote them, dout (BH,
// Lq, d) the cotangent of o, in the operands' type; writes dq (BH, Lq, d),
// dk and dv (BH, Lk, d) in that type, and uses delta (BH, Lq) fp32 as
// scratch.  Two launches; returns the first failure.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const float* stats, const void* dout,
                        void* dq, void* dk, void* dv, float* delta, int BH,
                        int Lq, int Lk, int d, int bf16, int sm16,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!takes(d, bf16)) return (int)cudaErrorInvalidValue;
  return sm16 ? dispatch_bwd<true>(q, k, v, o, stats, dout, dq, dk, dv, delta, BH, Lq, Lk, d, bf16, s)
              : dispatch_bwd<false>(q, k, v, o, stats, dout, dq, dk, dv, delta, BH, Lq, Lk, d, bf16, s);
}

}  // extern "C"
