// Fused whitened-GP marginals, forward and backward, affine, fp32 and bf16
// -- for sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/fused_gp.py
//   `_fwd_kernel` and `_bwd_kernel` with affine=True, bf16=False (reached
//   through `whitened_marginals_affine`, `_forward` and `_bwd_rule`) and
//   bf16=True (`whitened_marginals_affine_bf16`).
//
// Per row r of the flattened (B*N, d) raw input x:
//   xs      = x[r] * inv_ls
//   K[r, m] = os * exp(-0.5 * |xs - zs[m]|^2)           m < M inducing points
//   mean[r] = x[r] . mean_w + mean_b + sum_m K[r, m] u[m]
//   var[r]  = os - sum_n K[r, n] * (K W)[r, n]
// and, for cotangents dmean, dvar, the VJP (W symmetric, as the Pallas
// kernel takes it):
//   E    = (dmean u^T - 2 dvar o (K W)) o K
//   dxs  = E zs - rowsum(E) o xs      (wrt the scaled x)
//   dx   = dxs o inv_ls + dmean o mean_w                    per row
//   dzs  = E^T xs - colsum(E) o zs,  du = K^T dmean,
//   dW   = -K^T diag(dvar) K,        dos = sum(E) / os + sum(dvar),
//   dinv_ls = sum_r dxs o x,  dmean_w = sum_r dmean o x,  dmean_b = sum dmean
//                                                        summed over rows.
// The bf16 variant means what the Pallas body means by it: only the two
// products K W and K^T (dvar o K) take inputs rounded to bf16, summed in
// fp32; the distance, the exponential, E, E zs, E^T x, every sum and every
// output stay fp32.
//
// What bounds it on an H100: arithmetic.  In fp32 the (K W) product is
// 2*M*M flops per row and the distance 3*M*d, all on the CUDA cores
// (67 TFLOP/s peak; the 2e-5 parity rules out TF32).  At the flagship (73,728
// rows, d 32, M 512) K W is 39 GFLOP, ~0.6 ms; at the production width
// (40,960 rows, d 512, M 512) the distance (32 GFLOP) outweighs it.  In bf16
// the two products move to the tensor cores (`mma.sync.m16n8k16`, 989 TFLOP/s
// peak) and the fp32 distance is what remains.  The bytes (x in, two vectors
// out, W once) take microseconds.
//
// Forward design: one block of 256 threads per tile of 64 rows.  The TPU
// kernel held a 2048-row tile, all of W and the (tile, M) K in VMEM and
// shrank the row tile for wide d; here W alone (1 MiB at M=512) exceeds a
// block's shared memory, so
//   1. the tile's K is computed once into shared memory, transposed
//      (K^T, M x 64, 136 KB at M=512), with the direct difference
//      |xs - zs|^2 (no cancellation, never negative).  x and zs stream
//      through shared memory 16 columns of d at a time while each thread
//      keeps the 64 partial distances of its inducing point in registers,
//      so the shared memory a block needs does not grow with d;
//   2. fp32: W streams through shared memory in 16 x 256 chunks,
//      double-buffered through registers, and each thread accumulates an
//      8 x 8 register tile of K W (warp w owns rows 8w..8w+7, lane c owns
//      columns 4c..4c+3 and 128+4c..128+4c+3 of each 256-column panel);
//      bf16: each warp owns the 64 rows x 32 columns of a panel as 4 x 4
//      `mma` tiles, K rounded to bf16 as it leaves shared memory, W^T read
//      as bf16 pairs from device memory (cast and transposed once per call
//      by the wrapper; 512 KB, resident in L2);
//   3. at the end of each panel the accumulators are multiplied by K and
//      summed into per-row partial variances.  K and K W never reach device
//      memory.
// Rows past the end are zero inputs whose results are never stored (no
// padding in device memory).  K^T over all of M fits a block up to M 720;
// beyond, the chunked kernels further down hold one chunk of 512 inducing
// points and recompute K^T chunk by chunk for each panel (the wrapper's
// `layout` picks the chunk and passes it to the launchers).
//
// Backward design.  The Pallas backward sums the parameter cotangents across
// its grid with init-at-step-0-then-add, which is right only on the TPU's
// sequential grid; CUDA blocks run concurrently and in no order.  The port
// instead splits the work so that every sum over rows is taken by one thread
// in a fixed order -- no atomics, so the gradients are equal bit for bit
// from run to run -- in four launches:
//   1. rows (as the forward, one block per 64-row tile): recompute K^T into
//      shared memory and (K W) panel by panel; at each panel's end form E in
//      registers.  Per row: rowsum(E), then dxs = E zs - rowsum(E) xs from an
//      E^T tile re-read into the K^T buffer (d <= 64: a row and 8 columns
//      per thread; wider: the product is as large as K W and runs through
//      the same register-tiled panels, zs streamed like W), x re-read from
//      device memory, and dx.  Per tile: partial du = K^T dmean and colsum(E) (M each) and the
//      partial scalar sums.  K and E are written to device memory for the
//      two column products (fp32: K as R x M floats; bf16: K and dvar o K
//      rounded to bf16 and transposed, M x R, so that the product reads both
//      operands as pairs along the summed index): those bytes take ~0.1 ms
//      at 3.35 TB/s, where recomputing K inside a tiled product would cost
//      one exponential and 2d flops per element for every output tile.
//   2. dW partials: (K^T diag(dvar) K) over S contiguous row ranges, one
//      (S, M, M) slab.  fp32: a 128 x 128 output tile per block with an
//      8 x 8 register tile per thread; dW is symmetric, so only the tiles on
//      and above the diagonal are computed (10 of 16 at M = 512).  bf16:
//      `mma` tiles, every output tile (rounding dvar o K makes the product
//      asymmetric in the last bits, as the Pallas product is);
//   3. dzs partials: E^T x over row ranges the same way, (S', M, d);
//   4. a reduction that sums the partials in a fixed order and applies the
//      column terms: dW, du, dzs = inv_ls o (E^T x) - colsum(E) o zs, and
//      the scalars.
// Tail rows are masked as in the forward: their cotangents count as zero and
// nothing is written for them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TR = 64;             // rows per block
constexpr int THREADS = 256;       // 8 warps x 8 rows
constexpr int PANEL = 256;         // W columns per panel
constexpr int BK = 16;             // W rows per shared-memory chunk
constexpr int KT_STRIDE = TR + 4;  // padded K^T row, keeps float4 alignment
constexpr int PREFETCH = BK * PANEL / THREADS;  // 16 W values per thread
constexpr int WBUF = 2 * BK * PANEL;            // floats of the W buffers

// distance staging (aliases the W buffers, which are idle until K is done)
constexpr int DC = 16;             // columns of d per chunk
constexpr int XC_STRIDE = TR + 4;  // x chunk [DC][XC_STRIDE]
constexpr int ZC_STRIDE = DC + 1;  // zs chunk [THREADS][ZC_STRIDE]
static_assert(DC * XC_STRIDE + THREADS * ZC_STRIDE <= WBUF, "staging fits");

// column products (launches 2 and 3)
constexpr int CK = 8;              // rows per shared-memory chunk
constexpr int CBM = 128;           // output rows (m) per block
constexpr int DW_TILE = 128;       // dW output tile: 16 x 8 per side
constexpr int TARGET_BLOCKS = 264; // two blocks per SM on 132 SMs
constexpr int SMALL_D = 64;        // up to here dxs is taken row by row
constexpr int GK = 32;             // bf16 dW product: summed rows per stage
constexpr int GS = GK + 8;         // its padded shared-memory row (bf16)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum of v over the block's threads, in a fixed order; every thread gets it
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// chunk c = (panel p, row chunk kc); element (i, tid) = W[k0 + i, n0 + tid]
// of the (M, ncols) row-major W
__device__ __forceinline__ void load_w_chunk(const float* __restrict__ w, int M,
                                             int ncols, int n_chunks, int c,
                                             int tid, float (&regs)[PREFETCH]) {
  const int p = c / n_chunks;
  const int k0 = (c - p * n_chunks) * BK;
  const int n = p * PANEL + tid;
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) {
    const int k = k0 + i;
    regs[i] = (k < M && n < ncols) ? __ldg(w + (size_t)k * ncols + n) : 0.f;
  }
}

// K^T of the tile into kt [m_pad][KT_STRIDE] (columns m >= M are zeros, rows
// past R are those of a zero x).  `stage` is WBUF floats of scratch: chunks
// of DC columns of the scaled x^T and of zs pass through it.
__device__ __forceinline__ void tile_kt(const float* __restrict__ x,
                                        const float* __restrict__ zs,
                                        const float* __restrict__ inv_ls,
                                        float os, float* kt, float* stage,
                                        int row0, int R, int d, int M,
                                        int m_pad) {
  const int tid = threadIdx.x;
  float* xc = stage;                   // [DC][XC_STRIDE]
  float* zc = stage + DC * XC_STRIDE;  // [THREADS][ZC_STRIDE]

  // thread owns whole columns m, rows accumulate in registers
  for (int mb = 0; mb < m_pad; mb += THREADS) {
    const int m = mb + tid;
    float d2[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) d2[r] = 0.f;
    for (int k0 = 0; k0 < d; k0 += DC) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < TR * DC; i += THREADS) {
        const int r = i / DC;
        const int k = i - r * DC;
        const int row = row0 + r;
        const int kk = k0 + k;
        xc[k * XC_STRIDE + r] =
            (row < R && kk < d) ? x[(size_t)row * d + kk] * inv_ls[kk] : 0.f;
      }
      for (int i = tid; i < THREADS * DC; i += THREADS) {
        const int mm = i / DC;
        const int k = i - mm * DC;
        const int kk = k0 + k;
        zc[mm * ZC_STRIDE + k] =
            (mb + mm < M && kk < d) ? __ldg(zs + (size_t)(mb + mm) * d + kk) : 0.f;
      }
      __syncthreads();
      if (m < M) {
        const float* zr = zc + tid * ZC_STRIDE;
#pragma unroll
        for (int k = 0; k < DC; ++k) {  // columns past d hold zeros in both
          const float z = zr[k];
          const float4* xk = reinterpret_cast<const float4*>(xc + k * XC_STRIDE);
#pragma unroll
          for (int r4 = 0; r4 < TR / 4; ++r4) {
            const float4 xv = xk[r4];
            float a;
            a = xv.x - z; d2[4 * r4 + 0] = fmaf(a, a, d2[4 * r4 + 0]);
            a = xv.y - z; d2[4 * r4 + 1] = fmaf(a, a, d2[4 * r4 + 1]);
            a = xv.z - z; d2[4 * r4 + 2] = fmaf(a, a, d2[4 * r4 + 2]);
            a = xv.w - z; d2[4 * r4 + 3] = fmaf(a, a, d2[4 * r4 + 3]);
          }
        }
      }
    }
    if (m < m_pad) {
      float4* ktm = reinterpret_cast<float4*>(kt + m * KT_STRIDE);
#pragma unroll
      for (int r4 = 0; r4 < TR / 4; ++r4) {
        ktm[r4] = m < M ? make_float4(os * expf(-0.5f * d2[4 * r4 + 0]),
                                      os * expf(-0.5f * d2[4 * r4 + 1]),
                                      os * expf(-0.5f * d2[4 * r4 + 2]),
                                      os * expf(-0.5f * d2[4 * r4 + 3]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  __syncthreads();
}

// column of the thread's register tile j within panel p
__device__ __forceinline__ int panel_col(int p, int lane, int j) {
  return p * PANEL + (j < 4 ? 4 * lane + j : PANEL / 2 + 4 * lane + (j - 4));
}

// fp32 (K W) of the tile, panel by panel, for the (M, ncols) row-major W
// streamed through shared memory and K^T in kt; at the end of panel p calls
// epi(p, g) with the thread's 8 x 8 tile g of
// (K W)[8 warp + i, panel_col(p, lane, j)], then zeroes g.
template <class Epilogue>
__device__ __forceinline__ void kw_panels(const float* __restrict__ w,
                                          const float* kt, float* wbuf, int M,
                                          int m_pad, int ncols, Epilogue& epi) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_panels = (ncols + PANEL - 1) / PANEL;
  const int n_chunks = m_pad / BK;
  const int total = n_panels * n_chunks;

  float g[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) g[i][j] = 0.f;

  float pre[PREFETCH];
  load_w_chunk(w, M, ncols, n_chunks, 0, tid, pre);
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) wbuf[i * PANEL + tid] = pre[i];
  __syncthreads();

  for (int c = 0; c < total; ++c) {
    const int p = c / n_chunks;
    const int kc = c - p * n_chunks;
    if (c + 1 < total) load_w_chunk(w, M, ncols, n_chunks, c + 1, tid, pre);

    const float* wb = wbuf + (c & 1) * (BK * PANEL);
    const float* ktk = kt + kc * BK * KT_STRIDE + warp * 8;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4* kr = reinterpret_cast<const float4*>(ktk + kk * KT_STRIDE);
      const float4 ka = kr[0], kb = kr[1];
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
      const float4 wa = reinterpret_cast<const float4*>(wb + kk * PANEL)[lane];
      const float4 wc = reinterpret_cast<const float4*>(wb + kk * PANEL + PANEL / 2)[lane];
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[i][j] = fmaf(kv[i], wv[j], g[i][j]);
    }

    if (kc == n_chunks - 1) {
      epi(p, g);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
    }

    if (c + 1 < total) {
      float* nb = wbuf + ((c + 1) & 1) * (BK * PANEL);
#pragma unroll
      for (int i = 0; i < PREFETCH; ++i) nb[i * PANEL + tid] = pre[i];
    }
    __syncthreads();
  }
}

// bf16 (K W) of the tile on the tensor cores.  wt is W^T in bf16,
// (n_panels * PANEL) x m_pad, zero-padded: wt[n][k] = bf16(W[k][n]).  Warp w
// owns the 64 rows x 32 columns [32 w, 32 w + 32) of each panel as 4 x 4
// `mma` tiles; K leaves shared memory as fp32 and is rounded to bf16 on the
// way into the A fragments.  At the end of each panel calls
// epi(n0, c) with c[mt][nt] the tile of rows 16 mt.. and columns
// n0 + 8 nt.. (the `mma` accumulator layout).
template <class Epilogue>
__device__ __forceinline__ void kw_panels_mma(const __nv_bfloat16* __restrict__ wt,
                                              const float* kt, int M, int m_pad,
                                              Epilogue& epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_panels = (M + PANEL - 1) / PANEL;

  for (int p = 0; p < n_panels; ++p) {
    const int n0 = p * PANEL + warp * 32;
    if (n0 >= M) continue;  // the whole warp: no column of its own here
    float c[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;

    for (int k0 = 0; k0 < m_pad; k0 += 16) {
      const float* kk = kt + (k0 + 2 * t) * KT_STRIDE + g;
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* km = kk + mt * 16;
        a[mt][0] = pack_bf16(km[0], km[KT_STRIDE]);
        a[mt][1] = pack_bf16(km[8], km[KT_STRIDE + 8]);
        a[mt][2] = pack_bf16(km[8 * KT_STRIDE], km[9 * KT_STRIDE]);
        a[mt][3] = pack_bf16(km[8 * KT_STRIDE + 8], km[9 * KT_STRIDE + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* wr = reinterpret_cast<const uint32_t*>(
            wt + (size_t)(n0 + nt * 8 + g) * m_pad + k0 + 2 * t);
        const uint32_t b0 = __ldg(wr);
        const uint32_t b1 = __ldg(wr + 4);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(c[mt][nt], a[mt], b0, b1);
      }
    }
    epi(n0, c);
  }
}

// forward epilogue: var_part[i] += sum_j (K W)[r_i, n_j] * K[r_i, n_j]
struct VarEpilogue {
  const float* kt;
  int M, lane, warp;
  float var_part[8];

  __device__ __forceinline__ void operator()(int p, float (&g)[8][8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = panel_col(p, lane, j);
      if (n < M) {
        const float4* kn = reinterpret_cast<const float4*>(kt + n * KT_STRIDE + warp * 8);
        const float4 a = kn[0], b = kn[1];
        const float kv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) var_part[i] = fmaf(g[i][j], kv[i], var_part[i]);
      }
    }
  }
};

// the same for the `mma` layout: part[2 mt + h] belongs to row 16 mt + 8 h + g
struct VarEpilogueMma {
  const float* kt;
  int M, g, t;
  float part[8];

  __device__ __forceinline__ void operator()(int n0, float (&c)[4][4][4]) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + nt * 8 + 2 * t + e;
        if (n < M) {
          const float* kn = kt + n * KT_STRIDE + g;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            part[2 * mt] = fmaf(c[mt][nt][e], kn[mt * 16], part[2 * mt]);
            part[2 * mt + 1] = fmaf(c[mt][nt][2 + e], kn[mt * 16 + 8], part[2 * mt + 1]);
          }
        }
      }
  }
};

// backward epilogue: E[r_i, n_j] = (dm_i u_j - 2 dv_i (K W)_ij) K_ij, stored
// to device memory, and summed per row
struct EEpilogue {
  const float* kt;
  const float* __restrict__ u;
  float* emat;
  int M, R, lane, warp, row0;
  float dm[8], dv[8], rowsum[8];

  __device__ __forceinline__ void operator()(int p, float (&g)[8][8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = panel_col(p, lane, j);
      if (n < M) {
        const float4* kn = reinterpret_cast<const float4*>(kt + n * KT_STRIDE + warp * 8);
        const float4 a = kn[0], b = kn[1];
        const float kv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        const float un = __ldg(u + n);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float e = (dm[i] * un - 2.f * dv[i] * g[i][j]) * kv[i];
          rowsum[i] += e;
          const int row = row0 + warp * 8 + i;
          if (row < R) emat[(size_t)row * M + n] = e;
        }
      }
    }
  }
};

// the same for the `mma` layout: dm, dv, part[2 mt + h] of row 16 mt + 8 h + g
struct EEpilogueMma {
  const float* kt;
  const float* __restrict__ u;
  float* emat;
  int M, R, g, t, row0;
  float dm[8], dv[8], part[8];

  __device__ __forceinline__ void operator()(int n0, float (&c)[4][4][4]) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + nt * 8 + 2 * t + e;
        if (n < M) {
          const float* kn = kt + n * KT_STRIDE + g;
          const float un = __ldg(u + n);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 2 * mt + h;
              const int r = mt * 16 + 8 * h + g;
              const float ev = (dm[i] * un - 2.f * dv[i] * c[mt][nt][2 * h + e]) * kn[mt * 16 + 8 * h];
              part[i] += ev;
              if (row0 + r < R) emat[(size_t)(row0 + r) * M + n] = ev;
            }
        }
      }
  }
};

// epilogue of the wide-d (E zs) product: g is E zs of rows 8 warp + i and
// columns panel_col(p, lane, j) of d.  Writes dx and, per warp, the sums over
// its 8 rows of dxs o x and dmean o x: part[warp][n] and part[warp][d + n].
struct DxEpilogue {
  const float* __restrict__ x;
  const float* __restrict__ inv_ls;
  const float* __restrict__ mean_w;
  float* __restrict__ dx;
  float* __restrict__ part;  // the tile's [8][2 d]
  const float* rse_s;
  const float* dm_s;
  int R, d, lane, warp, row0;

  __device__ __forceinline__ void operator()(int p, float (&g)[8][8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = panel_col(p, lane, j);
      if (n < d) {
        const float il = inv_ls[n];
        const float mw = mean_w[n];
        float s_dx = 0.f, s_dm = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = warp * 8 + i;
          const int row = row0 + r;
          if (row < R) {
            const float xv = x[(size_t)row * d + n];
            const float dxs = g[i][j] - rse_s[r] * (xv * il);
            dx[(size_t)row * d + n] = fmaf(dxs, il, dm_s[r] * mw);
            s_dx = fmaf(dxs, xv, s_dx);
            s_dm = fmaf(dm_s[r], xv, s_dm);
          }
        }
        part[(size_t)warp * 2 * d + n] = s_dx;
        part[(size_t)warp * 2 * d + d + n] = s_dm;
      }
    }
  }
};

// per-row sums of the `mma` epilogues' partials: over the four lanes that
// share a row, then over the warps in a fixed order; out[r] for r < TR.
// red is 8 x TR floats of shared memory.  Ends with a barrier.
__device__ __forceinline__ void row_sums_mma(float (&part)[8], float* red,
                                             float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = part[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t == 0) red[warp * TR + (i >> 1) * 16 + (i & 1) * 8 + g] = v;
  }
  __syncthreads();
  if (threadIdx.x < TR) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w * TR + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// BF16: w is W^T in bf16 (see kw_panels_mma), else W in fp32, M x M.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
fused_gp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ zs,
                    const float* __restrict__ u, const void* __restrict__ w,
                    const float* __restrict__ os_ptr,
                    const float* __restrict__ inv_ls,
                    const float* __restrict__ mean_w,
                    const float* __restrict__ mean_b_ptr,
                    float* __restrict__ mean_out, float* __restrict__ var_out,
                    int R, int d, int M, int m_pad) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                     // [m_pad][KT_STRIDE]  K^T of the tile
  float* wbuf = kt + m_pad * KT_STRIDE; // [2][BK][PANEL] W chunks; staging

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TR;
  const float os = *os_ptr;

  // 1. K^T of the tile
  tile_kt(x, zs, inv_ls, os, kt, wbuf, row0, R, d, M, m_pad);

  // mean: warp w sums K[r, :] u over its 8 rows, lanes stride over m
  {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float um = __ldg(u + m);
      const float4* km = reinterpret_cast<const float4*>(kt + m * KT_STRIDE + warp * 8);
      const float4 a = km[0], b = km[1];
      acc[0] = fmaf(a.x, um, acc[0]); acc[1] = fmaf(a.y, um, acc[1]);
      acc[2] = fmaf(a.z, um, acc[2]); acc[3] = fmaf(a.w, um, acc[3]);
      acc[4] = fmaf(b.x, um, acc[4]); acc[5] = fmaf(b.y, um, acc[5]);
      acc[6] = fmaf(b.z, um, acc[6]); acc[7] = fmaf(b.w, um, acc[7]);
    }
    // x . mean_w of the warp's rows, lanes stride over d
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + warp * 8 + i;
      if (row < R) {
        const float* xr = x + (size_t)row * d;
        for (int k = lane; k < d; k += 32) acc[i] = fmaf(xr[k], mean_w[k], acc[i]);
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(acc[i]);
      if (lane == i) mine = s;
    }
    const int row = row0 + warp * 8 + lane;
    if (lane < 8 && row < R) mean_out[row] = *mean_b_ptr + mine;
  }

  // 2.-3. var: (K W) panel by panel, each panel's tile met with K
  if constexpr (BF16) {
    VarEpilogueMma epi{kt, M, lane >> 2, lane & 3,
                       {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
    kw_panels_mma(static_cast<const __nv_bfloat16*>(w), kt, M, m_pad, epi);
    float* red = wbuf;             // [8][TR]
    float* sums = wbuf + 8 * TR;   // [TR]
    row_sums_mma(epi.part, red, sums);
    if (tid < TR && row0 + tid < R) var_out[row0 + tid] = os - sums[tid];
  } else {
    VarEpilogue epi{kt, M, lane, warp, {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
    kw_panels(static_cast<const float*>(w), kt, wbuf, M, m_pad, M, epi);

    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(epi.var_part[i]);
      if (lane == i) mine = s;
    }
    const int row = row0 + warp * 8 + lane;
    if (lane < 8 && row < R) var_out[row] = os - mine;
  }
}

// Backward launch 1: per-row cotangents, per-tile partial sums, K and E.
// part_m: [tile][2][M] = (K^T dmean, colsum E) of the tile;
// part_s: [tile][slots * 2d + 3]: per slot (a group of the tile's rows: 2
//         at d <= SMALL_D, else 8) (sum dxs o x, sum dmean o x), then
//         (sum E, sum dvar, sum dmean) of the tile.
// kmat: fp32, K as (R, M) floats; BF16, two (M, Rp) bf16 matrices, K^T and
// (dvar o K)^T, Rp = 64 * tiles (tail rows carry dvar = 0).
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
fused_gp_bwd_rows_kernel(const float* __restrict__ x,
                         const float* __restrict__ zs,
                         const float* __restrict__ u,
                         const void* __restrict__ w,
                         const float* __restrict__ os_ptr,
                         const float* __restrict__ inv_ls,
                         const float* __restrict__ mean_w,
                         const float* __restrict__ dmean,
                         const float* __restrict__ dvar,
                         float* __restrict__ dx, float* kmat, float* emat,
                         float* __restrict__ part_m,
                         float* __restrict__ part_s, int R, int d, int M,
                         int m_pad) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                     // [m_pad][KT_STRIDE]  K^T, then E^T
  float* wbuf = kt + m_pad * KT_STRIDE; // [2][BK][PANEL] W chunks; staging
  float* dm_s = wbuf + WBUF;            // [TR]
  float* dv_s = dm_s + TR;              // [TR]
  float* rse_s = dv_s + TR;             // [TR]                rowsum(E)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int row0 = tile * TR;
  const float os = *os_ptr;

  if (tid < TR) {
    const int row = row0 + tid;
    dm_s[tid] = row < R ? dmean[row] : 0.f;  // tail rows: zero cotangents
    dv_s[tid] = row < R ? dvar[row] : 0.f;
  }
  tile_kt(x, zs, inv_ls, os, kt, wbuf, row0, R, d, M, m_pad);

  // K to device memory, and the tile's K^T dmean
  for (int m = tid; m < M; m += THREADS) {
    const float* ktm = kt + m * KT_STRIDE;
    float acc = 0.f;
    if constexpr (BF16) {
      const size_t rp = (size_t)gridDim.x * TR;
      uint4* k16 = reinterpret_cast<uint4*>(
          reinterpret_cast<__nv_bfloat16*>(kmat) + (size_t)m * rp + row0);
      uint4* dvk16 = reinterpret_cast<uint4*>(
          reinterpret_cast<__nv_bfloat16*>(kmat) + ((size_t)M + m) * rp + row0);
#pragma unroll
      for (int r8 = 0; r8 < TR / 8; ++r8) {
        uint32_t a[4], b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 8 * r8 + 2 * j;
          const float k0v = ktm[r], k1v = ktm[r + 1];
          acc = fmaf(k0v, dm_s[r], acc);
          acc = fmaf(k1v, dm_s[r + 1], acc);
          a[j] = pack_bf16(k0v, k1v);
          b[j] = pack_bf16(dv_s[r] * k0v, dv_s[r + 1] * k1v);
        }
        k16[r8] = make_uint4(a[0], a[1], a[2], a[3]);
        dvk16[r8] = make_uint4(b[0], b[1], b[2], b[3]);
      }
    } else {
#pragma unroll 16
      for (int r = 0; r < TR; ++r) {
        acc = fmaf(ktm[r], dm_s[r], acc);
        const int row = row0 + r;
        if (row < R) kmat[(size_t)row * M + m] = ktm[r];
      }
    }
    part_m[((size_t)tile * 2 + 0) * M + m] = acc;
  }

  // E panel by panel
  if constexpr (BF16) {
    EEpilogueMma epi;
    epi.kt = kt; epi.u = u; epi.emat = emat;
    epi.M = M; epi.R = R; epi.g = lane >> 2; epi.t = lane & 3; epi.row0 = row0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i >> 1) * 16 + (i & 1) * 8 + (lane >> 2);
      epi.dm[i] = dm_s[r];
      epi.dv[i] = dv_s[r];
      epi.part[i] = 0.f;
    }
    kw_panels_mma(static_cast<const __nv_bfloat16*>(w), kt, M, m_pad, epi);
    row_sums_mma(epi.part, wbuf, rse_s);
  } else {
    EEpilogue epi;
    epi.kt = kt; epi.u = u; epi.emat = emat;
    epi.M = M; epi.R = R; epi.lane = lane; epi.warp = warp; epi.row0 = row0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      epi.dm[i] = dm_s[warp * 8 + i];
      epi.dv[i] = dv_s[warp * 8 + i];
      epi.rowsum[i] = 0.f;
    }
    kw_panels(static_cast<const float*>(w), kt, wbuf, M, m_pad, M, epi);  // ends with a barrier
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(epi.rowsum[i]);
      if (lane == i) mine = s;
    }
    if (lane < 8) rse_s[warp * 8 + lane] = mine;
  }

  // E^T of the tile back into the K^T buffer (this block's own writes,
  // visible after the barrier), and the tile's colsum(E)
  __syncthreads();
  for (int m = tid; m < m_pad; m += THREADS) {
    float* ktm = kt + m * KT_STRIDE;
    float acc = 0.f;
#pragma unroll 16  // independent loads in flight together
    for (int r = 0; r < TR; ++r) {
      const int row = row0 + r;
      const float e = (m < M && row < R) ? emat[(size_t)row * M + m] : 0.f;
      ktm[r] = e;
      acc += e;
    }
    if (m < M) part_m[((size_t)tile * 2 + 1) * M + m] = acc;
  }
  __syncthreads();

  // dxs[r, k] = sum_m E[r, m] zs[m, k] - rowsum(E)[r] xs[r, k], dx, and per
  // slot (a group of the tile's rows) the sums of dxs o x and dmean o x
  const int slots = d > SMALL_D ? 8 : 2;
  float* part_t = part_s + (size_t)tile * (slots * 2 * d + 3);
  if (d > SMALL_D) {
    // wide d: the product is as large as K W; the same register-tiled
    // panels, E^T in the place of K^T and zs (M, d) in the place of W
    DxEpilogue epi{x, inv_ls, mean_w, dx, part_t, rse_s, dm_s, R, d, lane,
                   warp, row0};
    kw_panels(zs, kt, wbuf, M, m_pad, d, epi);
  } else {
    // narrow d: thread (r, grp) takes row r and 8 columns of each
    // 32-column pass; a warp's 32 rows are one slot
    const int r = tid & (TR - 1);
    const int grp = tid >> 6;  // 0..3
    const int row = row0 + r;
    const bool vec = (d & 3) == 0 && ((size_t)zs & 15) == 0;
    for (int kb = 0; kb < d; kb += 32) {
      const int k0 = kb + grp * 8;
      const int nk = min(8, d - k0);  // <= 0: no column of its own
      float acc[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[jj] = 0.f;
      if (nk == 8 && vec) {
#pragma unroll 4
        for (int m = 0; m < M; ++m) {
          const float e = kt[m * KT_STRIDE + r];
          const float4* zm = reinterpret_cast<const float4*>(zs + (size_t)m * d + k0);
          const float4 za = __ldg(zm), zb = __ldg(zm + 1);
          acc[0] = fmaf(e, za.x, acc[0]); acc[1] = fmaf(e, za.y, acc[1]);
          acc[2] = fmaf(e, za.z, acc[2]); acc[3] = fmaf(e, za.w, acc[3]);
          acc[4] = fmaf(e, zb.x, acc[4]); acc[5] = fmaf(e, zb.y, acc[5]);
          acc[6] = fmaf(e, zb.z, acc[6]); acc[7] = fmaf(e, zb.w, acc[7]);
        }
      } else if (nk > 0) {
        for (int m = 0; m < M; ++m) {
          const float e = kt[m * KT_STRIDE + r];
          const float* zm = zs + (size_t)m * d + k0;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            if (jj < nk) acc[jj] = fmaf(e, __ldg(zm + jj), acc[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float s_dx = 0.f, s_dm = 0.f;
        if (jj < nk && row < R) {
          const int k = k0 + jj;
          const float xv = x[(size_t)row * d + k];
          const float il = inv_ls[k];
          const float dxs = acc[jj] - rse_s[r] * (xv * il);
          dx[(size_t)row * d + k] = fmaf(dxs, il, dm_s[r] * mean_w[k]);
          s_dx = dxs * xv;
          s_dm = dm_s[r] * xv;
        }
        s_dx = warp_sum(s_dx);
        s_dm = warp_sum(s_dm);
        if (lane == 0 && jj < nk) {
          part_t[(size_t)(warp & 1) * 2 * d + k0 + jj] = s_dx;
          part_t[(size_t)(warp & 1) * 2 * d + d + k0 + jj] = s_dm;
        }
      }
    }
  }
  // the tile's scalar sums
  if (tid < 3) {
    const float* src = tid == 0 ? rse_s : (tid == 1 ? dv_s : dm_s);
    float acc = 0.f;
    for (int r = 0; r < TR; ++r) acc += src[r];
    part_t[slots * 2 * d + tid] = acc;
  }
}

// ------------------------------------------------ M in chunks (M > 720) --
//
// At M > 720 the tile's K^T over all of M (m_pad x 68 floats) no longer fits
// a block's shared memory.  The chunked kernels below hold K^T for one
// chunk of `chunk` inducing points (a multiple of the 256-column panel) and
// recompute it as the panels need it: for each panel p of W's columns, the
// chunks are computed in turn, each multiplied into the panel's register
// tile, the chunk that holds the panel's own columns last, so that the
// panel's epilogue finds K[r, n] of its columns in shared memory.  K is
// computed n_panels times instead of once: 3 M d flops a row per panel
// against the panel's 512 M of K W, d / 170 of the product.  Rows, warps
// and register tiles are those of the single-pass kernels above.

// W rows k0.. (of `rows`) and columns n0 + tid of the row-major (rows,
// ncols) w into registers
__device__ __forceinline__ void load_w_rows(const float* __restrict__ w,
                                            int rows, int ncols, int k0,
                                            int n0, int tid,
                                            float (&regs)[PREFETCH]) {
  const int n = n0 + tid;
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) {
    const int k = k0 + i;
    regs[i] = (k < rows && n < ncols) ? __ldg(w + (size_t)k * ncols + n) : 0.f;
  }
}

// g += the fp32 (K W) tile of panel p over the chunk's rows: kt holds K^T
// of the chunk (rows_pad rows, zeros past `rows`), w the chunk's W rows.
// Begins and ends with a barrier.
__device__ __forceinline__ void kw_panel_rows(const float* __restrict__ w,
                                              const float* kt, float* wbuf,
                                              int rows, int rows_pad,
                                              int ncols, int p,
                                              float (&g)[8][8]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = rows_pad / BK;
  float pre[PREFETCH];
  load_w_rows(w, rows, ncols, 0, p * PANEL, tid, pre);
  __syncthreads();  // wbuf is free
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) wbuf[i * PANEL + tid] = pre[i];
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_w_rows(w, rows, ncols, (c + 1) * BK, p * PANEL, tid, pre);
    const float* wb = wbuf + (c & 1) * (BK * PANEL);
    const float* ktk = kt + c * BK * KT_STRIDE + warp * 8;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4* kr = reinterpret_cast<const float4*>(ktk + kk * KT_STRIDE);
      const float4 ka = kr[0], kb = kr[1];
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
      const float4 wa = reinterpret_cast<const float4*>(wb + kk * PANEL)[lane];
      const float4 wc = reinterpret_cast<const float4*>(wb + kk * PANEL + PANEL / 2)[lane];
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[i][j] = fmaf(kv[i], wv[j], g[i][j]);
    }
    if (c + 1 < n_chunks) {
      float* nb = wbuf + ((c + 1) & 1) * (BK * PANEL);
#pragma unroll
      for (int i = 0; i < PREFETCH; ++i) nb[i * PANEL + tid] = pre[i];
    }
    __syncthreads();
  }
}

// c += the bf16 (K W) tile of the warp's 32 columns n0.. over the chunk's
// rows k_lo.. (rows_pad of them; kt holds their K^T); wt as kw_panels_mma's,
// wt_cols columns
__device__ __forceinline__ void kw_panel_rows_mma(const __nv_bfloat16* __restrict__ wt,
                                                  int wt_cols, const float* kt,
                                                  int k_lo, int rows_pad, int n0,
                                                  float (&c)[4][4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k0 = 0; k0 < rows_pad; k0 += 16) {
    const float* kk = kt + (k0 + 2 * t) * KT_STRIDE + g;
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float* km = kk + mt * 16;
      a[mt][0] = pack_bf16(km[0], km[KT_STRIDE]);
      a[mt][1] = pack_bf16(km[8], km[KT_STRIDE + 8]);
      a[mt][2] = pack_bf16(km[8 * KT_STRIDE], km[9 * KT_STRIDE]);
      a[mt][3] = pack_bf16(km[8 * KT_STRIDE + 8], km[9 * KT_STRIDE + 8]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t* wr = reinterpret_cast<const uint32_t*>(
          wt + (size_t)(n0 + nt * 8 + g) * wt_cols + k_lo + k0 + 2 * t);
      const uint32_t b0 = __ldg(wr);
      const uint32_t b1 = __ldg(wr + 4);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_bf16(c[mt][nt], a[mt], b0, b1);
    }
  }
}

// chunk i of panel p's sweep: all chunks, the one holding the panel's
// columns last
__device__ __forceinline__ int sweep_chunk(int p, int i, int chunk, int n_chunks) {
  return ((p * PANEL) / chunk + 1 + i) % n_chunks;
}

__device__ __forceinline__ int pad16(int n) { return (n + BK - 1) / BK * BK; }

// For each panel p (n_panels of them over M columns) computes K^T chunk by
// chunk into kt and calls on_chunk(p, lo, cnt, cnt_pad) after each; then
// epilogue(p, home_lo) with the panel's home chunk in kt.
template <class OnChunk, class Epilogue>
__device__ __forceinline__ void chunked_sweeps(const float* __restrict__ x,
                                               const float* __restrict__ zs,
                                               const float* __restrict__ inv_ls,
                                               float os, float* kt, float* wbuf,
                                               int row0, int R, int d, int M,
                                               int chunk, OnChunk& on_chunk,
                                               Epilogue& epilogue) {
  const int n_chunks = (M + chunk - 1) / chunk;
  const int n_panels = (M + PANEL - 1) / PANEL;
  for (int p = 0; p < n_panels; ++p) {
    for (int i = 0; i < n_chunks; ++i) {
      const int lo = sweep_chunk(p, i, chunk, n_chunks) * chunk;
      const int cnt = min(chunk, M - lo);
      tile_kt(x, zs + (size_t)lo * d, inv_ls, os, kt, wbuf, row0, R, d, cnt,
              pad16(cnt));
      on_chunk(p, lo, cnt, pad16(cnt));
    }
    epilogue(p, (p * PANEL) / chunk * chunk);
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
fused_gp_fwd_chunked_kernel(const float* __restrict__ x,
                            const float* __restrict__ zs,
                            const float* __restrict__ u,
                            const void* __restrict__ w,
                            const float* __restrict__ os_ptr,
                            const float* __restrict__ inv_ls,
                            const float* __restrict__ mean_w,
                            const float* __restrict__ mean_b_ptr,
                            float* __restrict__ mean_out,
                            float* __restrict__ var_out, int R, int d, int M,
                            int m_pad, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                      // [chunk][KT_STRIDE]
  float* wbuf = kt + chunk * KT_STRIDE;  // [2][BK][PANEL]; staging

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TR;
  const float os = *os_ptr;

  float macc[8];  // K u of the warp's 8 rows, this lane's share
#pragma unroll
  for (int i = 0; i < 8; ++i) macc[i] = 0.f;
  float g[8][8];
  float c[4][4][4];
  VarEpilogue epi{kt, M, lane, warp, {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
  VarEpilogueMma epi16{kt, M, lane >> 2, lane & 3,
                       {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};

  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
  };
  zero();
  auto on_chunk = [&](int p, int lo, int cnt, int cnt_pad) {
    if (p == 0) {
      for (int m = lane; m < cnt; m += 32) {
        const float um = __ldg(u + lo + m);
        const float4* km = reinterpret_cast<const float4*>(kt + m * KT_STRIDE + warp * 8);
        const float4 a = km[0], b = km[1];
        macc[0] = fmaf(a.x, um, macc[0]); macc[1] = fmaf(a.y, um, macc[1]);
        macc[2] = fmaf(a.z, um, macc[2]); macc[3] = fmaf(a.w, um, macc[3]);
        macc[4] = fmaf(b.x, um, macc[4]); macc[5] = fmaf(b.y, um, macc[5]);
        macc[6] = fmaf(b.z, um, macc[6]); macc[7] = fmaf(b.w, um, macc[7]);
      }
    }
    if constexpr (BF16) {
      const int n0 = p * PANEL + warp * 32;
      if (n0 < M)
        kw_panel_rows_mma(static_cast<const __nv_bfloat16*>(w), m_pad, kt, lo,
                          cnt_pad, n0, c);
    } else {
      kw_panel_rows(static_cast<const float*>(w) + (size_t)lo * M, kt, wbuf,
                    cnt, cnt_pad, M, p, g);
    }
  };
  auto epilogue = [&](int p, int home_lo) {
    // kt holds the rows home_lo..: K[r, n] of the panel's columns n
    if constexpr (BF16) {
      const int n0 = p * PANEL + warp * 32;
      epi16.kt = kt - (ptrdiff_t)home_lo * KT_STRIDE;
      if (n0 < M) epi16(n0, c);
    } else {
      epi.kt = kt - (ptrdiff_t)home_lo * KT_STRIDE;
      epi(p, g);
    }
    zero();
  };
  chunked_sweeps(x, zs, inv_ls, os, kt, wbuf, row0, R, d, M, chunk, on_chunk,
                 epilogue);

  // mean: x . mean_w of the warp's rows, lanes stride over d
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + warp * 8 + i;
    if (row < R) {
      const float* xr = x + (size_t)row * d;
      for (int k = lane; k < d; k += 32) macc[i] = fmaf(xr[k], mean_w[k], macc[i]);
    }
  }
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float s = warp_sum(macc[i]);
    if (lane == i) mine = s;
  }
  {
    const int row = row0 + warp * 8 + lane;
    if (lane < 8 && row < R) mean_out[row] = *mean_b_ptr + mine;
  }

  if constexpr (BF16) {
    __syncthreads();  // wbuf: the last product is done
    float* red = wbuf;            // [8][TR]
    float* sums = wbuf + 8 * TR;  // [TR]
    row_sums_mma(epi16.part, red, sums);
    if (tid < TR && row0 + tid < R) var_out[row0 + tid] = os - sums[tid];
  } else {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(epi.var_part[i]);
      if (lane == i) v = s;
    }
    const int row = row0 + warp * 8 + lane;
    if (lane < 8 && row < R) var_out[row] = os - v;
  }
}

// E^T of the tile's rows for inducing points lo.. (cnt of them, cnt_pad
// rows) from emat into kt; colsum (if not null) gets each column's sum at
// lo + m.  Begins and ends with a barrier.
__device__ __forceinline__ void load_et(const float* emat, float* kt,
                                        float* __restrict__ colsum, int lo,
                                        int cnt, int cnt_pad, int row0, int R,
                                        int M) {
  __syncthreads();
  for (int m = threadIdx.x; m < cnt_pad; m += THREADS) {
    float* ktm = kt + m * KT_STRIDE;
    float acc = 0.f;
#pragma unroll 16
    for (int r = 0; r < TR; ++r) {
      const int row = row0 + r;
      const float e = (m < cnt && row < R) ? emat[(size_t)row * M + lo + m] : 0.f;
      ktm[r] = e;
      acc += e;
    }
    if (colsum != nullptr && m < cnt) colsum[lo + m] = acc;
  }
  __syncthreads();
}

// Backward launch 1 with M in chunks: the outputs of fused_gp_bwd_rows_kernel.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
fused_gp_bwd_rows_chunked_kernel(const float* __restrict__ x,
                                 const float* __restrict__ zs,
                                 const float* __restrict__ u,
                                 const void* __restrict__ w,
                                 const float* __restrict__ os_ptr,
                                 const float* __restrict__ inv_ls,
                                 const float* __restrict__ mean_w,
                                 const float* __restrict__ dmean,
                                 const float* __restrict__ dvar,
                                 float* __restrict__ dx, float* kmat,
                                 float* emat, float* __restrict__ part_m,
                                 float* __restrict__ part_s, int R, int d,
                                 int M, int m_pad, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                      // [chunk][KT_STRIDE]  K^T, then E^T
  float* wbuf = kt + chunk * KT_STRIDE;  // [2][BK][PANEL]; staging
  float* dm_s = wbuf + WBUF;             // [TR]
  float* dv_s = dm_s + TR;               // [TR]
  float* rse_s = dv_s + TR;              // [TR]                rowsum(E)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int row0 = tile * TR;
  const float os = *os_ptr;
  const int n_chunks = (M + chunk - 1) / chunk;

  if (tid < TR) {
    const int row = row0 + tid;
    dm_s[tid] = row < R ? dmean[row] : 0.f;  // tail rows: zero cotangents
    dv_s[tid] = row < R ? dvar[row] : 0.f;
  }
  __syncthreads();

  float g[8][8];
  float c[4][4][4];
  EEpilogue epi;
  epi.kt = kt; epi.u = u; epi.emat = emat;
  epi.M = M; epi.R = R; epi.lane = lane; epi.warp = warp; epi.row0 = row0;
  EEpilogueMma epi16;
  epi16.kt = kt; epi16.u = u; epi16.emat = emat;
  epi16.M = M; epi16.R = R; epi16.g = lane >> 2; epi16.t = lane & 3;
  epi16.row0 = row0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    epi.dm[i] = dm_s[warp * 8 + i];
    epi.dv[i] = dv_s[warp * 8 + i];
    epi.rowsum[i] = 0.f;
    const int r = (i >> 1) * 16 + (i & 1) * 8 + (lane >> 2);
    epi16.dm[i] = dm_s[r];
    epi16.dv[i] = dv_s[r];
    epi16.part[i] = 0.f;
  }
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
  };
  zero();

  auto on_chunk = [&](int p, int lo, int cnt, int cnt_pad) {
    if (p == 0) {  // K to device memory, and the tile's K^T dmean
      for (int m = tid; m < cnt; m += THREADS) {
        const float* ktm = kt + m * KT_STRIDE;
        const int mg = lo + m;
        float acc = 0.f;
        if constexpr (BF16) {
          const size_t rp = (size_t)gridDim.x * TR;
          uint4* k16 = reinterpret_cast<uint4*>(
              reinterpret_cast<__nv_bfloat16*>(kmat) + (size_t)mg * rp + row0);
          uint4* dvk16 = reinterpret_cast<uint4*>(
              reinterpret_cast<__nv_bfloat16*>(kmat) + ((size_t)M + mg) * rp + row0);
#pragma unroll
          for (int r8 = 0; r8 < TR / 8; ++r8) {
            uint32_t a[4], b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int r = 8 * r8 + 2 * j;
              const float k0v = ktm[r], k1v = ktm[r + 1];
              acc = fmaf(k0v, dm_s[r], acc);
              acc = fmaf(k1v, dm_s[r + 1], acc);
              a[j] = pack_bf16(k0v, k1v);
              b[j] = pack_bf16(dv_s[r] * k0v, dv_s[r + 1] * k1v);
            }
            k16[r8] = make_uint4(a[0], a[1], a[2], a[3]);
            dvk16[r8] = make_uint4(b[0], b[1], b[2], b[3]);
          }
        } else {
#pragma unroll 16
          for (int r = 0; r < TR; ++r) {
            acc = fmaf(ktm[r], dm_s[r], acc);
            const int row = row0 + r;
            if (row < R) kmat[(size_t)row * M + mg] = ktm[r];
          }
        }
        part_m[((size_t)tile * 2 + 0) * M + mg] = acc;
      }
    }
    if constexpr (BF16) {
      const int n0 = p * PANEL + warp * 32;
      if (n0 < M)
        kw_panel_rows_mma(static_cast<const __nv_bfloat16*>(w), m_pad, kt, lo,
                          cnt_pad, n0, c);
    } else {
      kw_panel_rows(static_cast<const float*>(w) + (size_t)lo * M, kt, wbuf,
                    cnt, cnt_pad, M, p, g);
    }
  };
  auto epilogue = [&](int p, int home_lo) {  // E of the panel's columns
    if constexpr (BF16) {
      const int n0 = p * PANEL + warp * 32;
      epi16.kt = kt - (ptrdiff_t)home_lo * KT_STRIDE;
      if (n0 < M) epi16(n0, c);
    } else {
      epi.kt = kt - (ptrdiff_t)home_lo * KT_STRIDE;
      epi(p, g);
    }
    zero();
  };
  chunked_sweeps(x, zs, inv_ls, os, kt, wbuf, row0, R, d, M, chunk, on_chunk,
                 epilogue);
  __syncthreads();  // emat's writes are read back below; wbuf is free
  if constexpr (BF16) {
    row_sums_mma(epi16.part, wbuf, rse_s);
  } else {
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(epi.rowsum[i]);
      if (lane == i) mine = s;
    }
    if (lane < 8) rse_s[warp * 8 + lane] = mine;
  }

  // dxs = E zs - rowsum(E) xs, dx and the slots' sums, E^T chunk by chunk;
  // colsum(E) with the first sweep over the chunks
  float* colsum = part_m + ((size_t)tile * 2 + 1) * M;
  const int slots = d > SMALL_D ? 8 : 2;
  float* part_t = part_s + (size_t)tile * (slots * 2 * d + 3);
  if (d > SMALL_D) {
    DxEpilogue dxe{x, inv_ls, mean_w, dx, part_t, rse_s, dm_s, R, d, lane,
                   warp, row0};
    const int n_panels = (d + PANEL - 1) / PANEL;
    for (int p = 0; p < n_panels; ++p) {
      zero();
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int lo = ci * chunk;
        const int cnt = min(chunk, M - lo);
        load_et(emat, kt, p == 0 ? colsum : nullptr, lo, cnt, pad16(cnt), row0,
                R, M);
        kw_panel_rows(zs + (size_t)lo * d, kt, wbuf, cnt, pad16(cnt), d, p, g);
      }
      dxe(p, g);
    }
  } else {
    const int r = tid & (TR - 1);
    const int grp = tid >> 6;  // 0..3
    const int row = row0 + r;
    for (int kb = 0; kb < d; kb += 32) {
      const int k0 = kb + grp * 8;
      const int nk = min(8, d - k0);  // <= 0: no column of its own
      float acc[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[jj] = 0.f;
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int lo = ci * chunk;
        const int cnt = min(chunk, M - lo);
        load_et(emat, kt, kb == 0 ? colsum : nullptr, lo, cnt, pad16(cnt),
                row0, R, M);
        if (nk > 0) {
          for (int m = 0; m < cnt; ++m) {
            const float e = kt[m * KT_STRIDE + r];
            const float* zm = zs + (size_t)(lo + m) * d + k0;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              if (jj < nk) acc[jj] = fmaf(e, __ldg(zm + jj), acc[jj]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float s_dx = 0.f, s_dm = 0.f;
        if (jj < nk && row < R) {
          const int k = k0 + jj;
          const float xv = x[(size_t)row * d + k];
          const float il = inv_ls[k];
          const float dxs = acc[jj] - rse_s[r] * (xv * il);
          dx[(size_t)row * d + k] = fmaf(dxs, il, dm_s[r] * mean_w[k]);
          s_dx = dxs * xv;
          s_dm = dm_s[r] * xv;
        }
        s_dx = warp_sum(s_dx);
        s_dm = warp_sum(s_dm);
        if (lane == 0 && jj < nk) {
          part_t[(size_t)(warp & 1) * 2 * d + k0 + jj] = s_dx;
          part_t[(size_t)(warp & 1) * 2 * d + d + k0 + jj] = s_dm;
        }
      }
    }
  }
  // the tile's scalar sums
  if (tid < 3) {
    const float* src = tid == 0 ? rse_s : (tid == 1 ? dv_s : dm_s);
    float acc = 0.f;
    for (int r = 0; r < TR; ++r) acc += src[r];
    part_t[slots * 2 * d + tid] = acc;
  }
}

template <int N>
__device__ __forceinline__ void frag(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// Backward launches 2 and 3 in fp32: for row range s of `rows_per` rows,
//   part[s, m, n] = sum_r A[r, m] * (rw ? rw[r] : 1) * B[r, n]
// with A (R, Mdim) and B (R, Ndim) row-major.  256 threads as 16 x 16; a
// block owns a (16 TM) x (16 TN) output tile and a thread a TM x TN register
// tile (rows ty*TM/2.. and BM/2 + ty*TM/2.., columns likewise).  Row chunks
// of CK stream through two shared-memory buffers: the next chunk's loads are
// in flight in registers while the current one is multiplied.  SYM (A = B,
// the product symmetric): blockIdx.x enumerates only the tiles on and above
// the diagonal, and the reduction reads the others transposed.
template <int TM, int TN, bool SYM>
__global__ void __launch_bounds__(THREADS)
fused_gp_bwd_cols_kernel(const float* A, const float* B,
                         const float* __restrict__ rw,
                         float* __restrict__ part, int R, int Mdim, int Ndim,
                         int rows_per) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  constexpr int HM = TM / 2;
  constexpr int HN = TN / 2;
  constexpr int LA = (CK * BM + THREADS - 1) / THREADS;
  constexpr int LB = (CK * BN + THREADS - 1) / THREADS;
  __shared__ __align__(16) float as[2][CK][BM];
  __shared__ __align__(16) float bs[2][CK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  int bm = blockIdx.y, bn = blockIdx.x;
  if (SYM) {  // the t-th tile of the upper triangle, row by row
    const int nt = (Ndim + BN - 1) / BN;
    int t = blockIdx.x, len = nt;
    bm = 0;
    while (t >= len) { t -= len; ++bm; --len; }
    bn = bm + t;
  }
  const int m0 = bm * BM;
  const int n0 = bn * BN;
  const int s = blockIdx.z;
  const int r0 = s * rows_per;
  const int r1 = min(R, r0 + rows_per);

  float pa[LA], pb[LB];
  auto fetch = [&](int rc) {
#pragma unroll
    for (int c = 0; c < LA; ++c) {
      const int i = tid + c * THREADS;
      const int rr = i / BM;
      const int r = rc + rr;
      const int m = m0 + (i - rr * BM);
      float a = 0.f;
      if (i < CK * BM && r < r1 && m < Mdim) {
        a = A[(size_t)r * Mdim + m];
        if (rw != nullptr) a *= rw[r];
      }
      pa[c] = a;
    }
#pragma unroll
    for (int c = 0; c < LB; ++c) {
      const int i = tid + c * THREADS;
      const int rr = i / BN;
      const int r = rc + rr;
      const int n = n0 + (i - rr * BN);
      pb[c] = (i < CK * BN && r < r1 && n < Ndim) ? B[(size_t)r * Ndim + n] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int c = 0; c < LA; ++c) {
      const int i = tid + c * THREADS;
      if (i < CK * BM) as[buf][i / BM][i % BM] = pa[c];
    }
#pragma unroll
    for (int c = 0; c < LB; ++c) {
      const int i = tid + c * THREADS;
      if (i < CK * BN) bs[buf][i / BN][i % BN] = pb[c];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(r0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int rc = r0; rc < r1; rc += CK) {
    const bool more = rc + CK < r1;
    if (more) fetch(rc + CK);
#pragma unroll
    for (int kk = 0; kk < CK; ++kk) {
      float a[TM], b[TN];
      float lo[HM], hi[HM], bl[HN], bh[HN];
      frag<HM>(&as[buf][kk][ty * HM], lo);
      frag<HM>(&as[buf][kk][BM / 2 + ty * HM], hi);
      frag<HN>(&bs[buf][kk][tx * HN], bl);
      frag<HN>(&bs[buf][kk][BN / 2 + tx * HN], bh);
#pragma unroll
      for (int i = 0; i < HM; ++i) { a[i] = lo[i]; a[HM + i] = hi[i]; }
#pragma unroll
      for (int j = 0; j < HN; ++j) { b[j] = bl[j]; b[HN + j] = bh[j]; }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  float* out = part + (size_t)s * Mdim * Ndim;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i < HM ? ty * HM + i : BM / 2 + ty * HM + (i - HM));
    if (m >= Mdim) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j < HN ? tx * HN + j : BN / 2 + tx * HN + (j - HN));
      if (n < Ndim) out[(size_t)m * Ndim + n] = acc[i][j];
    }
  }
}

// Backward launch 2 in bf16: for row range s of `rows_per` rows (a multiple
// of GK),  part[s, m, n] = sum_r A[m, r] * B[n, r]  with A = K^T and
// B = (dvar o K)^T, both (M, Rp) bf16, so both operands are read as pairs
// along r.  A 128 x 128 output tile per block of 8 warps (2 x 4), a
// 64 x 32 tile of 4 x 4 `mma` tiles per warp; chunks of GK rows pass through
// two shared-memory buffers, the next one's loads in flight in registers.
__global__ void __launch_bounds__(THREADS)
fused_gp_bwd_dw_mma_kernel(const __nv_bfloat16* __restrict__ A,
                           const __nv_bfloat16* __restrict__ B,
                           float* __restrict__ part, int M, int Rp,
                           int rows_per) {
  __shared__ __align__(16) __nv_bfloat16 as[2][DW_TILE][GS];
  __shared__ __align__(16) __nv_bfloat16 bs[2][DW_TILE][GS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * DW_TILE;
  const int n0 = blockIdx.x * DW_TILE;
  const int s = blockIdx.z;
  const int r0 = s * rows_per;
  const int r1 = min(Rp, r0 + rows_per);

  // a stage is 128 rows x 32 bf16 = 512 x 16 bytes per operand: two a thread
  uint4 pa[2], pb[2];
  auto fetch = [&](int rc) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = tid + c * THREADS;
      const int row = i >> 2;
      const int seg = (i & 3) * 8;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      pa[c] = m0 + row < M ? __ldg(reinterpret_cast<const uint4*>(
                                 A + (size_t)(m0 + row) * Rp + rc + seg))
                           : zero;
      pb[c] = n0 + row < M ? __ldg(reinterpret_cast<const uint4*>(
                                 B + (size_t)(n0 + row) * Rp + rc + seg))
                           : zero;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = tid + c * THREADS;
      const int row = i >> 2;
      const int seg = (i & 3) * 8;
      *reinterpret_cast<uint4*>(&as[buf][row][seg]) = pa[c];
      *reinterpret_cast<uint4*>(&bs[buf][row][seg]) = pb[c];
    }
  };

  float c[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;

  if (r0 < r1) {
    fetch(r0);
    stash(0);
  }
  __syncthreads();
  int buf = 0;
  for (int rc = r0; rc < r1; rc += GK) {
    const bool more = rc + GK < r1;
    if (more) fetch(rc + GK);
#pragma unroll
    for (int ks = 0; ks < GK; ks += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const __nv_bfloat16* ap = &as[buf][wm + mt * 16 + g][ks + 2 * t];
        a[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * GS);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * GS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* bp = &bs[buf][wn + nt * 8 + g][ks + 2 * t];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(c[mt][nt], a[mt], b0, b1);
      }
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  float* out = part + (size_t)s * M * M;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mt * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + nt * 8 + 2 * t + (e & 1);
        if (m < M && n < M) out[(size_t)m * M + n] = c[mt][nt][e];
      }
}

// Backward launch 4: fixed-order sums of every partial.  Blocks 0..M-1 own
// inducing point m (du, dzs row, dW row); blocks M.. own one scalar output
// each: dinv_ls[k], dmean_w[k], dos, dmean_b.  sym: only the dW tiles on and
// above the diagonal were computed.
__global__ void __launch_bounds__(THREADS)
fused_gp_bwd_reduce_kernel(const float* __restrict__ part_m,
                           const float* __restrict__ part_s,
                           const float* __restrict__ pw,
                           const float* __restrict__ pz,
                           const float* __restrict__ zs,
                           const float* __restrict__ inv_ls,
                           const float* __restrict__ os_ptr,
                           float* __restrict__ dzs, float* __restrict__ du,
                           float* __restrict__ dw, float* __restrict__ dos,
                           float* __restrict__ dinv_ls,
                           float* __restrict__ dmean_w,
                           float* __restrict__ dmean_b, int n_tiles, int d,
                           int M, int s_w, int s_z, int sym) {
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  if (b < M) {
    const int m = b;
    float a = 0.f, c = 0.f;
    for (int t = tid; t < n_tiles; t += THREADS) {
      a += part_m[((size_t)t * 2 + 0) * M + m];
      c += part_m[((size_t)t * 2 + 1) * M + m];
    }
    a = block_sum(a, red);
    c = block_sum(c, red);  // colsum(E)[m]
    if (tid == 0) du[m] = a;
    for (int k = tid; k < d; k += THREADS) {
      float e = 0.f;
      for (int s = 0; s < s_z; ++s) e += pz[((size_t)s * M + m) * d + k];
      dzs[(size_t)m * d + k] = e * inv_ls[k] - c * zs[(size_t)m * d + k];
    }
    // below the diagonal of a symmetric product, read the mirror element
    for (int n = tid; n < M; n += THREADS) {
      const bool upper = !sym || m / DW_TILE <= n / DW_TILE;
      const size_t at = upper ? (size_t)m * M + n : (size_t)n * M + m;
      float e = 0.f;
      for (int s = 0; s < s_w; ++s) e += pw[(size_t)s * M * M + at];
      dw[(size_t)m * M + n] = -e;
    }
    return;
  }
  const int q = b - M;
  const int slots = d > SMALL_D ? 8 : 2;
  const int ns = slots * 2 * d + 3;
  float a = 0.f, c = 0.f;
  if (q < 2 * d) {
    for (int t = tid; t < n_tiles * slots; t += THREADS)
      a += part_s[(size_t)(t / slots) * ns + (size_t)(t % slots) * 2 * d + q];
  } else {
    const int qa = q == 2 * d ? 0 : 2;
    for (int t = tid; t < n_tiles; t += THREADS) {
      a += part_s[(size_t)t * ns + slots * 2 * d + qa];
      if (q == 2 * d) c += part_s[(size_t)t * ns + slots * 2 * d + 1];
    }
  }
  a = block_sum(a, red);
  if (q == 2 * d) c = block_sum(c, red);
  if (tid != 0) return;
  if (q < d) dinv_ls[q] = a;
  else if (q < 2 * d) dmean_w[q - d] = a;
  else if (q == 2 * d) *dos = a / *os_ptr + c;
  else *dmean_b = a;
}

struct BwdPlan {
  int n_tiles, m_pad, s_w, rows_w, s_z, rows_z, z_tile;
  long long kmat, emat, part_m, part_s, pw, pz, total;  // scratch offsets
};

// splits over rows so that each column product fills one wave of at most
// TARGET_BLOCKS blocks (rounding up would start a second, nearly empty wave);
// rows_per is a multiple of `chunk`
__host__ void split_rows(int R, int tiles, int chunk, int& s, int& rows_per) {
  s = TARGET_BLOCKS / tiles;
  const int max_s = (R + chunk - 1) / chunk;
  if (s > max_s) s = max_s;
  if (s < 1) s = 1;
  rows_per = (R + s - 1) / s;
  rows_per = (rows_per + chunk - 1) / chunk * chunk;
  s = (R + rows_per - 1) / rows_per;
}

__host__ BwdPlan plan(int R, int d, int M, bool bf16) {
  BwdPlan p;
  p.n_tiles = (R + TR - 1) / TR;
  p.m_pad = (M + BK - 1) / BK * BK;
  const int rp = p.n_tiles * TR;
  const int mt = (M + CBM - 1) / CBM;
  const int nt = (M + DW_TILE - 1) / DW_TILE;
  if (bf16) split_rows(rp, nt * nt, GK, p.s_w, p.rows_w);
  else split_rows(R, nt * (nt + 1) / 2, CK, p.s_w, p.rows_w);
  p.z_tile = d > 64 ? 128 : 32;  // columns of d per E^T x block
  split_rows(R, mt * ((d + p.z_tile - 1) / p.z_tile), CK, p.s_z, p.rows_z);
  long long o = 0;
  p.kmat = o; o += (long long)rp * M;  // fp32 K, or two bf16 (M, rp)
  p.emat = o; o += (long long)R * M;
  p.part_m = o; o += (long long)p.n_tiles * 2 * M;
  p.part_s = o; o += (long long)p.n_tiles * ((d > SMALL_D ? 8 : 2) * 2 * d + 3);
  p.pw = o; o += (long long)p.s_w * M * M;
  p.pz = o; o += (long long)p.s_z * M * d;
  p.total = o;
  return p;
}

// Shared memory of a forward block that holds K^T for `rows` inducing
// points (all of M, padded, or one chunk); the backward's row launch needs
// 3 TR floats more.  The wrapper's layout() mirrors these two.
int smem_fwd(int rows) {
  return (int)(((long long)rows * KT_STRIDE + WBUF) * (long long)sizeof(float));
}

int smem_bwd(int rows) { return smem_fwd(rows) + 3 * TR * (int)sizeof(float); }

// chunk >= m_pad: the single-pass kernels; else a multiple of PANEL
bool chunk_ok(int M, int chunk) {
  const int m_pad = (M + BK - 1) / BK * BK;
  return chunk >= m_pad || (chunk > 0 && chunk % PANEL == 0);
}

template <bool BF16>
int launch_fwd(const float* x, const float* zs, const float* u, const void* w,
               const float* os, const float* inv_ls, const float* mean_w,
               const float* mean_b, float* mean, float* var, int R, int d,
               int M, int chunk, cudaStream_t stream) {
  if (!chunk_ok(M, chunk)) return (int)cudaErrorInvalidValue;
  const int m_pad = (M + BK - 1) / BK * BK;
  const int blocks = (R + TR - 1) / TR;
  if (chunk >= m_pad) {
    const int smem = smem_fwd(m_pad);
    cudaError_t err = cudaFuncSetAttribute(
        fused_gp_fwd_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_gp_fwd_kernel<BF16><<<blocks, THREADS, smem, stream>>>(
        x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var, R, d, M, m_pad);
    return (int)cudaGetLastError();
  }
  const int smem = smem_fwd(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gp_fwd_chunked_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_gp_fwd_chunked_kernel<BF16><<<blocks, THREADS, smem, stream>>>(
      x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var, R, d, M, m_pad, chunk);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch_bwd(const float* x, const float* zs, const float* u, const void* w,
               const float* os, const float* inv_ls, const float* mean_w,
               const float* dmean, const float* dvar, float* dx, float* dzs,
               float* du, float* dw, float* dos, float* dinv_ls,
               float* dmean_w, float* dmean_b, float* scratch, int R, int d,
               int M, int chunk, cudaStream_t st) {
  if (!chunk_ok(M, chunk)) return (int)cudaErrorInvalidValue;
  const BwdPlan p = plan(R, d, M, BF16);
  float* kmat = scratch + p.kmat;
  float* emat = scratch + p.emat;
  float* part_m = scratch + p.part_m;
  float* part_s = scratch + p.part_s;
  float* pw = scratch + p.pw;
  float* pz = scratch + p.pz;

  cudaError_t err;
  if (chunk >= p.m_pad) {
    const int smem = smem_bwd(p.m_pad);
    err = cudaFuncSetAttribute(
        fused_gp_bwd_rows_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_gp_bwd_rows_kernel<BF16><<<p.n_tiles, THREADS, smem, st>>>(
        x, zs, u, w, os, inv_ls, mean_w, dmean, dvar, dx, kmat, emat, part_m,
        part_s, R, d, M, p.m_pad);
  } else {
    const int smem = smem_bwd(chunk);
    err = cudaFuncSetAttribute(
        fused_gp_bwd_rows_chunked_kernel<BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_gp_bwd_rows_chunked_kernel<BF16><<<p.n_tiles, THREADS, smem, st>>>(
        x, zs, u, w, os, inv_ls, mean_w, dmean, dvar, dx, kmat, emat, part_m,
        part_s, R, d, M, p.m_pad, chunk);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int mt = (M + CBM - 1) / CBM;
  const int nt = (M + DW_TILE - 1) / DW_TILE;
  if (BF16) {
    const int rp = p.n_tiles * TR;
    const __nv_bfloat16* k16 = reinterpret_cast<const __nv_bfloat16*>(kmat);
    fused_gp_bwd_dw_mma_kernel<<<dim3(nt, nt, p.s_w), THREADS, 0, st>>>(
        k16, k16 + (size_t)M * rp, pw, M, rp, p.rows_w);
  } else {
    fused_gp_bwd_cols_kernel<8, 8, true><<<dim3(nt * (nt + 1) / 2, 1, p.s_w), THREADS, 0, st>>>(
        kmat, kmat, dvar, pw, R, M, M, p.rows_w);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 zgrid((d + p.z_tile - 1) / p.z_tile, mt, p.s_z);
  if (p.z_tile == 128)
    fused_gp_bwd_cols_kernel<8, 8, false><<<zgrid, THREADS, 0, st>>>(
        emat, x, nullptr, pz, R, M, d, p.rows_z);
  else
    fused_gp_bwd_cols_kernel<8, 2, false><<<zgrid, THREADS, 0, st>>>(
        emat, x, nullptr, pz, R, M, d, p.rows_z);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  fused_gp_bwd_reduce_kernel<<<M + 2 * d + 2, THREADS, 0, st>>>(
      part_m, part_s, pw, pz, zs, inv_ls, os, dzs, du, dw, dos, dinv_ls,
      dmean_w, dmean_b, p.n_tiles, d, M, p.s_w, p.s_z, BF16 ? 0 : 1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of device scratch the backward needs (the wrapper allocates it).
long long fused_gp_bwd_scratch_floats(int R, int d, int M) {
  return plan(R, d, M, false).total;
}

long long fused_gp_bf16_bwd_scratch_floats(int R, int d, int M) {
  return plan(R, d, M, true).total;
}

// Rows and columns of the bf16 W^T the bf16 launchers take: wt[n][k] =
// bf16(W[k][n]), zero beyond M.
int fused_gp_bf16_wt_rows(int M) { return (M + PANEL - 1) / PANEL * PANEL; }
int fused_gp_bf16_wt_cols(int M) { return (M + BK - 1) / BK * BK; }

// x (R, d) raw rows; zs (M, d) = Z / lengthscale; u (M,); w (M, M) row-major;
// os, mean_b: device scalars; inv_ls, mean_w (d,); mean, var (R,) outputs.
// chunk: the inducing points a block holds K^T for (the wrapper's layout():
// M padded to 16 for the single-pass kernels, else a multiple of 256).
// Returns the cudaError_t of the launch.
int fused_gp_fwd(const float* x, const float* zs, const float* u, const float* w,
                 const float* os, const float* inv_ls, const float* mean_w,
                 const float* mean_b, float* mean, float* var, int R, int d,
                 int M, int chunk, void* stream) {
  return launch_fwd<false>(x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var,
                           R, d, M, chunk, (cudaStream_t)stream);
}

// The same with the K W product in bf16 on the tensor cores; wt is the bf16
// W^T described at fused_gp_bf16_wt_rows.
int fused_gp_bf16_fwd(const float* x, const float* zs, const float* u,
                      const void* wt, const float* os, const float* inv_ls,
                      const float* mean_w, const float* mean_b, float* mean,
                      float* var, int R, int d, int M, int chunk,
                      void* stream) {
  return launch_fwd<true>(x, zs, u, wt, os, inv_ls, mean_w, mean_b, mean, var,
                          R, d, M, chunk, (cudaStream_t)stream);
}

// The VJP.  Inputs as the forward's, plus dmean, dvar (R,); outputs dx
// (R, d), dzs (M, d), du (M,), dw (M, M), and device scalars / vectors dos,
// dinv_ls (d,), dmean_w (d,), dmean_b; scratch of
// fused_gp_bwd_scratch_floats(R, d, M) floats.  Four launches on `stream`;
// returns the first failure.
int fused_gp_bwd(const float* x, const float* zs, const float* u, const float* w,
                 const float* os, const float* inv_ls, const float* mean_w,
                 const float* dmean, const float* dvar, float* dx, float* dzs,
                 float* du, float* dw, float* dos, float* dinv_ls,
                 float* dmean_w, float* dmean_b, float* scratch, int R, int d,
                 int M, int chunk, void* stream) {
  return launch_bwd<false>(x, zs, u, w, os, inv_ls, mean_w, dmean, dvar, dx,
                           dzs, du, dw, dos, dinv_ls, dmean_w, dmean_b,
                           scratch, R, d, M, chunk, (cudaStream_t)stream);
}

// The bf16 VJP: K W and K^T (dvar o K) in bf16 on the tensor cores; wt as
// the bf16 forward's; scratch of fused_gp_bf16_bwd_scratch_floats floats.
int fused_gp_bf16_bwd(const float* x, const float* zs, const float* u,
                      const void* wt, const float* os, const float* inv_ls,
                      const float* mean_w, const float* dmean,
                      const float* dvar, float* dx, float* dzs, float* du,
                      float* dw, float* dos, float* dinv_ls, float* dmean_w,
                      float* dmean_b, float* scratch, int R, int d, int M,
                      int chunk, void* stream) {
  return launch_bwd<true>(x, zs, u, wt, os, inv_ls, mean_w, dmean, dvar, dx,
                          dzs, du, dw, dos, dinv_ls, dmean_w, dmean_b,
                          scratch, R, d, M, chunk, (cudaStream_t)stream);
}

}  // extern "C"
