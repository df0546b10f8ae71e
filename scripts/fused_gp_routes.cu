// Probes of the fused GP's and the rbf kernel's products on an H100, for
// scripts/fused_gp_routes.py, which times them and holds what each gives
// against float64.  Built by that script with nvcc for sm_90a.
//
// Three ways to run the fp32 fused-GP backward's two large products -- G =
// K W (2 M^2 a row) and dW = K^T diag(dvar) K (symmetric):
//
//   (a) three bf16 parts of each fp32 operand, six part products, on the
//       port's own `wgb::gemm_kernel` (csrc/fused_gp.cu, included below),
//       K split into its parts on the way into shared memory, as the port
//       runs them;
//   (b) 3xTF32 on `wgmma ... .tf32` (m64n64k8): each operand as a TF32
//       "big" part and the TF32 rounding of the rest, three products (big
//       big, big small, small big).  TF32 operands must be K-major in
//       shared memory (rows along the summed index): G^T = W^T K^T takes K
//       as (R, M) rows, dW takes K as (M, R) rows, so one of the two
//       products needs K transposed;
//   (c) FFMA on the CUDA cores: the register-tiled A^T B kernel of the
//       port's earlier fp32 backward (128 x 128 tiles, an 8 x 8 register
//       tile a thread), here at two blocks an SM.
//
// The direct-difference bf16 forward (one fused kernel a 64-row tile: the
// distance by direct difference on FFMA into a shared-memory K^T, then K W
// on `mma.sync`), kept here as the baseline that the redesigned forward is
// timed against, phase by phase (`legacy`).
//
// The rbf cross-covariance's route (a): the cross term of one GP on the
// `wgb::` engine in three bf16 parts, x split and scaled on load, K written
// from the accumulators (`rbf_a`); and a kernel that only writes an rbf
// output, the ceiling of a kernel bound by its stores (`store_only`).

#include "../fine_grained_gaussian_process_forcasting_torch/csrc/fused_gp.cu"
#include "../fine_grained_gaussian_process_forcasting_torch/csrc/mma_bf16.cuh"

namespace probe {

using wgb::GT;

// ------------------------------------------------------------- (b) TF32 --

constexpr int TK = 32;                    // summed index per stage (128 bytes)
constexpr int TTILE = GT * TK * 4;        // bytes of one part of one operand
constexpr int TSTAGE = 4 * TTILE;         // A big, A small, B big, B small
constexpr int TSTAGES = 3;
constexpr int TSMEM = TSTAGES * TSTAGE + 1024;

__device__ __forceinline__ void mma_tf32(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// out[slab] tile = sum over the slab's summed index of A B^T, A (rows, k)
// and B (cols, k) row-major fp32, each given as its TF32 big and small
// parts.  PER: stages whose products the tensor cores sum before the sum is
// added to the tile's in fp32 (0: one unbroken sum).  sym: the tiles on and
// above the diagonal (wgb::sym_tile).
template <int PER>
__global__ void __launch_bounds__(256, 1)
tf32_kernel(const float* ab, const float* as, const float* bb, const float* bs,
            int ld, float* out, int ldo, size_t slab, int row_tiles, int k_len,
            int k_total, int sym) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1024(smem_raw);
  const wgb::Tile t = sym ? wgb::sym_tile(row_tiles) : wgb::tile(row_tiles);
  const int kbeg = t.slab * k_len;
  const int nk = (min(k_len, k_total - kbeg) + TK - 1) / TK;
  const int wgi = threadIdx.x >> 7;
  const float* src[4] = {ab, as, bb, bs};
  auto load = [&](int j) {
    if (j < nk) {
      const uint32_t base = hopper::smem_u32(sm + (j % TSTAGES) * TSTAGE);
      const int k0 = kbeg + j * TK;
      for (int i = threadIdx.x; i < 4 * GT * 8; i += 256) {
        const int p = i / (GT * 8), q = i - p * (GT * 8);
        const int r = q >> 3, c = q & 7;
        const int row = (p < 2 ? t.row0 : t.col0) + r;
        hopper::cp16(base + p * TTILE + hopper::swizzled(GT, r, c),
                     src[p] + (size_t)row * ld + k0 + c * 4);
      }
    }
    hopper::cp_commit();
  };
  float acc[2][32], part[2][32];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nt][i] = part[nt][i] = 0.f;
  load(0);
  load(1);
  for (int j = 0; j < nk; ++j) {
    hopper::cp_wait<TSTAGES - 2>();
    hopper::fence_async_smem();
    __syncthreads();
    load(j + TSTAGES - 1);
    const uint32_t s = hopper::smem_u32(sm + (j % TSTAGES) * TSTAGE);
    const uint32_t a0 = s + wgi * 64 * wgb::ROW_BYTES;
    const bool fresh = PER && j % PER == 0;
    hopper::fence();
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t b0 = s + 2 * TTILE + nt * 64 * wgb::ROW_BYTES;
        float(&d)[32] = PER ? part[nt] : acc[nt];
        const int keep = PER ? (!fresh || kk > 0) : 1;
        mma_tf32(d, hopper::kdesc(a0, GT, kk), hopper::kdesc(b0, GT, kk), keep);
        mma_tf32(d, hopper::kdesc(a0, GT, kk), hopper::kdesc(b0 + TTILE, GT, kk), 1);
        mma_tf32(d, hopper::kdesc(a0 + TTILE, GT, kk), hopper::kdesc(b0, GT, kk), 1);
      }
    hopper::commit();
    hopper::wait<0>();
    hopper::pin(acc[0]);
    hopper::pin(acc[1]);
    hopper::pin(part[0]);
    hopper::pin(part[1]);
    if (PER && (j % PER == PER - 1 || j == nk - 1)) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[nt][i] += part[nt][i];
    }
  }
  hopper::cp_wait<0>();
  float* o = out + t.slab * slab + (size_t)t.row0 * ldo + t.col0;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<float2*>(o + (size_t)wgb::acc_row(i) * ldo + wgb::acc_col(nt, i)) =
          make_float2(acc[nt][i], acc[nt][i + 1]);
}

// ------------------------------------------------------------- (c) FFMA --

constexpr int CK = 8;  // rows per shared-memory chunk

// for row range s of `rows_per` rows,
//   part[s, m, n] = sum_r A[r, m] * (rw ? rw[r] : 1) * B[r, n]
// with A (R, Mdim) and B (R, Ndim) row-major.  256 threads as 16 x 16; a
// block owns a 128 x 128 output tile and a thread an 8 x 8 register tile.
// Row chunks of CK stream through two shared-memory buffers.  SYM (A = B):
// blockIdx.x enumerates only the tiles on and above the diagonal.
template <bool SYM>
__global__ void __launch_bounds__(256, 2)
ffma_kernel(const float* A, const float* B, const float* __restrict__ rw,
            float* __restrict__ part, int R, int Mdim, int Ndim, int rows_per) {
  constexpr int TM = 8, TN = 8, BM = 128, BN = 128, HM = 4, HN = 4;
  constexpr int LA = CK * BM / 256, LB = CK * BN / 256;
  __shared__ __align__(16) float as[2][CK][BM];
  __shared__ __align__(16) float bs[2][CK][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  int bm = blockIdx.y, bn = blockIdx.x;
  if (SYM) {
    const int nt = (Ndim + BN - 1) / BN;
    int t = blockIdx.x, len = nt;
    bm = 0;
    while (t >= len) { t -= len; ++bm; --len; }
    bn = bm + t;
  }
  const int m0 = bm * BM, n0 = bn * BN;
  const int s = blockIdx.z;
  const int r0 = s * rows_per, r1 = min(R, r0 + rows_per);
  float pa[LA], pb[LB];
  auto fetch = [&](int rc) {
#pragma unroll
    for (int c = 0; c < LA; ++c) {
      const int i = tid + c * 256, rr = i / BM, r = rc + rr, m = m0 + (i - rr * BM);
      float a = 0.f;
      if (r < r1 && m < Mdim) {
        a = A[(size_t)r * Mdim + m];
        if (rw != nullptr) a *= rw[r];
      }
      pa[c] = a;
    }
#pragma unroll
    for (int c = 0; c < LB; ++c) {
      const int i = tid + c * 256, rr = i / BN, r = rc + rr, n = n0 + (i - rr * BN);
      pb[c] = (r < r1 && n < Ndim) ? B[(size_t)r * Ndim + n] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int c = 0; c < LA; ++c) {
      const int i = tid + c * 256;
      as[buf][i / BM][i % BM] = pa[c];
    }
#pragma unroll
    for (int c = 0; c < LB; ++c) {
      const int i = tid + c * 256;
      bs[buf][i / BN][i % BN] = pb[c];
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
      const float4 al = *reinterpret_cast<const float4*>(&as[buf][kk][ty * HM]);
      const float4 ah = *reinterpret_cast<const float4*>(&as[buf][kk][BM / 2 + ty * HM]);
      const float4 bl = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * HN]);
      const float4 bh = *reinterpret_cast<const float4*>(&bs[buf][kk][BN / 2 + tx * HN]);
      a[0] = al.x; a[1] = al.y; a[2] = al.z; a[3] = al.w;
      a[4] = ah.x; a[5] = ah.y; a[6] = ah.z; a[7] = ah.w;
      b[0] = bl.x; b[1] = bl.y; b[2] = bl.z; b[3] = bl.w;
      b[4] = bh.x; b[5] = bh.y; b[6] = bh.z; b[7] = bh.w;
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

}  // namespace probe

// ------------------------------- the direct-difference bf16 forward --
//
// One block of 256 threads a tile of 64 rows: (1) the tile's K^T over all
// of M into shared memory by the direct difference |xs - zs|^2 on FFMA, x
// and zs streamed 16 columns of d at a time, and the mean from it; (2) K W
// panel by panel on `mma.sync`, K rounded to bf16 as it leaves shared
// memory, W^T read as bf16 from device memory, each panel's tile met with
// K into per-row partial variances.  PHASES 1 stops after (1): the time of
// (2) is the whole kernel's less that.  M up to 720 (K^T in one block's
// shared memory).
namespace legacy {

constexpr int TR = 64;             // rows per block
constexpr int THREADS = 256;       // 8 warps x 8 rows
constexpr int PANEL = 256;         // W columns per panel
constexpr int BK = 16;             // K^T rows are padded to a multiple of this
constexpr int KT_STRIDE = TR + 4;  // padded K^T row, keeps float4 alignment
constexpr int WBUF = 2 * BK * PANEL;  // floats of staging and reduction space
constexpr int DC = 16;             // columns of d per chunk
constexpr int XC_STRIDE = TR + 4;  // x chunk [DC][XC_STRIDE]
constexpr int ZC_STRIDE = DC + 1;  // zs chunk [THREADS][ZC_STRIDE]

__device__ __forceinline__ void tile_kt(const float* __restrict__ x,
                                        const float* __restrict__ zs,
                                        const float* __restrict__ inv_ls,
                                        float os, float* kt, float* stage,
                                        int row0, int R, int d, int M,
                                        int m_pad) {
  const int tid = threadIdx.x;
  float* xc = stage;
  float* zc = stage + DC * XC_STRIDE;
  for (int mb = 0; mb < m_pad; mb += THREADS) {
    const int m = mb + tid;
    float d2[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) d2[r] = 0.f;
    for (int k0 = 0; k0 < d; k0 += DC) {
      __syncthreads();
      for (int i = tid; i < TR * DC; i += THREADS) {
        const int r = i / DC, k = i - r * DC, row = row0 + r, kk = k0 + k;
        xc[k * XC_STRIDE + r] =
            (row < R && kk < d) ? x[(size_t)row * d + kk] * inv_ls[kk] : 0.f;
      }
      for (int i = tid; i < THREADS * DC; i += THREADS) {
        const int mm = i / DC, k = i - mm * DC, kk = k0 + k;
        zc[mm * ZC_STRIDE + k] =
            (mb + mm < M && kk < d) ? __ldg(zs + (size_t)(mb + mm) * d + kk) : 0.f;
      }
      __syncthreads();
      if (m < M) {
        const float* zr = zc + tid * ZC_STRIDE;
#pragma unroll
        for (int k = 0; k < DC; ++k) {
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
      for (int r4 = 0; r4 < TR / 4; ++r4)
        ktm[r4] = m < M ? make_float4(os * expf(-0.5f * d2[4 * r4 + 0]),
                                      os * expf(-0.5f * d2[4 * r4 + 1]),
                                      os * expf(-0.5f * d2[4 * r4 + 2]),
                                      os * expf(-0.5f * d2[4 * r4 + 3]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
}

template <int PHASES>
__global__ void __launch_bounds__(THREADS, 1)
bf16_fwd_kernel(const float* __restrict__ x, const float* __restrict__ zs,
                const float* __restrict__ u, const __nv_bfloat16* __restrict__ wt,
                const float* __restrict__ os_ptr, const float* __restrict__ inv_ls,
                const float* __restrict__ mean_w, const float* __restrict__ mean_b_ptr,
                float* __restrict__ mean_out, float* __restrict__ var_out, int R,
                int d, int M, int m_pad) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;
  float* wbuf = kt + m_pad * KT_STRIDE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * TR;
  const float os = *os_ptr;
  tile_kt(x, zs, inv_ls, os, kt, wbuf, row0, R, d, M, m_pad);
  {  // mean: warp w sums K[r, :] u over its 8 rows, lanes stride over m
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
  if (PHASES == 1) return;
  // K W panel by panel on `mma.sync`, each panel's tile met with K
  float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int n_panels = (M + PANEL - 1) / PANEL;
  for (int p = 0; p < n_panels; ++p) {
    const int n0 = p * PANEL + warp * 32;
    if (n0 >= M) continue;
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
        const uint32_t b0 = __ldg(wr), b1 = __ldg(wr + 4);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(c[mt][nt], a[mt], b0, b1);
      }
    }
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
  // per-row sums: the four lanes of a row, then the warps in order
  float* red = wbuf;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = part[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t == 0) red[warp * TR + (i >> 1) * 16 + (i & 1) * 8 + g] = v;
  }
  __syncthreads();
  if (tid < TR && row0 + tid < R) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w * TR + tid];
    var_out[row0 + tid] = os - s;
  }
}

}  // namespace legacy

// ------------------------------------------------------- rbf probes --
namespace rbf_a {

// K of one GP from the (r, m) tile of xs zs^T: os exp(-max(0, |xs|^2 +
// |zs|^2 - 2 xs.zs) / 2), written to out (R, M) from the accumulators
struct RbfEpi {
  const float* x2;  // (Rp) |xs|^2
  const float* z2;  // (Mp) |zs|^2
  const float* os;
  float* out;
  int R, M;

  __device__ void operator()(float (&acc)[2][32], float*, const wgb::Tile& t) const {
    const float o = *os;
    const bool pairs = (M & 1) == 0;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = t.row0 + wgb::acc_row(i);
        const int m = t.col0 + wgb::acc_col(nt, i);
        if (r >= R || m >= M) continue;
        const float xx = x2[r];
        float k[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          k[e] = o * expf(-0.5f * fmaxf(xx + z2[m + e] - 2.f * acc[nt][i + e], 0.f));
        float* at = out + (size_t)r * M + m;
        if (pairs) {
          *reinterpret_cast<float2*>(at) = make_float2(k[0], k[1]);
        } else {
          at[0] = k[0];
          if (m + 1 < M) at[1] = k[1];
        }
      }
  }
};

// out[g] = os[g] exp(-1/2) over (G, per_gp) floats, as float4: the stores
// of an rbf output and nothing else
__global__ void __launch_bounds__(256)
store_only_kernel(float* __restrict__ out, const float* __restrict__ os,
                  long long per_gp) {
  const int g = blockIdx.y;
  const float4 v = make_float4(os[g] * 0.60653066f, os[g] * 0.60653066f,
                               os[g] * 0.60653066f, os[g] * 0.60653066f);
  float4* o = reinterpret_cast<float4*>(out + (size_t)g * per_gp);
  const long long n4 = per_gp / 4;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256)
    o[i] = v;
}

}  // namespace rbf_a

extern "C" {

// (a) G^T (Mp, Rp) = W^T K^T: wp three bf16 planes (Mp, Mp) of W^T, kt K^T
// (Mp, Rp) fp32 split on load; sum: wgb's SUM (32 or 4)
int probe_kw_a(const void* wp, const float* kt, float* gt, int Mp, int Rp,
               int sum, void* stream) {
  using namespace wgb;
  const bf16* w = static_cast<const bf16*>(wp);
  const size_t plane = (size_t)Mp * Mp;
  const Operand a{{w, w + plane, w + 2 * plane}, Mp};
  const F32Operand b{kt, nullptr, Rp};
  const PartEpi epi{gt, Rp, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (sum == 32)
    return gemm<PARTS, true, 32>(Mp / GT, Rp / GT, 1, a, b, Mp, Mp, epi, st);
  return gemm<PARTS, true, 4>(Mp / GT, Rp / GT, 1, a, b, Mp, Mp, epi, st);
}

// (a) dW partials pw (s, Mp, Mp), the tiles on and above the diagonal: kt
// K^T (Mp, Rp) fp32, dvp dvar padded to Rp; sum: wgb's SUM (0, 4 or 1)
int probe_dw_a(const float* kt, const float* dvp, float* pw, int Mp, int Rp,
               int s, int k_len, int sum, void* stream) {
  using namespace wgb;
  const F32Operand a{kt, nullptr, Rp}, b{kt, dvp, Rp};
  const PartEpi epi{pw, Mp, (size_t)Mp * Mp};
  cudaStream_t st = (cudaStream_t)stream;
  const int mt = Mp / GT;
  if (sum == 0) return gemm<PARTS, false, 0, true>(mt, mt, s, a, b, k_len, Rp, epi, st);
  if (sum == 1) return gemm<PARTS, false, 1, true>(mt, mt, s, a, b, k_len, Rp, epi, st);
  return gemm<PARTS, false, 4, true>(mt, mt, s, a, b, k_len, Rp, epi, st);
}

// (b) out[slab] (rows, cols) = A B^T on 3xTF32: A (rows, k), B (cols, k) as
// big and small parts, rows of ld floats; tiles row_tiles x col_tiles (sym:
// the upper triangle), s slabs of k_len; per: stages a tensor-core sum spans
// (0: unbroken, or 2: 64 of the summed index)
int probe_tf32(const float* ab, const float* as, const float* bb,
               const float* bs, int ld, float* out, int ldo, long long slab,
               int row_tiles, int col_tiles, int s, int k_len, int k_total,
               int sym, int per, void* stream) {
  auto kernel = per == 2 ? probe::tf32_kernel<2> : probe::tf32_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, probe::TSMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = sym ? row_tiles * (row_tiles + 1) / 2 : row_tiles * col_tiles;
  kernel<<<dim3(tiles, s), 256, probe::TSMEM, (cudaStream_t)stream>>>(
      ab, as, bb, bs, ld, out, ldo, (size_t)slab, row_tiles, k_len, k_total, sym);
  return (int)cudaGetLastError();
}

// (c) part[s] (Mdim, Ndim) = A^T diag(rw) B over row ranges of rows_per
int probe_ffma(const float* A, const float* B, const float* rw, float* part,
               int R, int Mdim, int Ndim, int rows_per, int s, int sym,
               void* stream) {
  const int nt = (Ndim + 127) / 128, mt = (Mdim + 127) / 128;
  cudaStream_t st = (cudaStream_t)stream;
  if (sym)
    probe::ffma_kernel<true><<<dim3(nt * (nt + 1) / 2, 1, s), 256, 0, st>>>(
        A, B, rw, part, R, Mdim, Ndim, rows_per);
  else
    probe::ffma_kernel<false><<<dim3(nt, mt, s), 256, 0, st>>>(
        A, B, rw, part, R, Mdim, Ndim, rows_per);
  return (int)cudaGetLastError();
}

// the direct-difference bf16 forward (legacy::bf16_fwd_kernel): wt is W^T
// in bf16, (ceil(M / 256) 256, ceil(M / 16) 16), zero-padded; phases 1: the
// distance, K and the mean only; 2: the whole kernel.  M <= 720.
int probe_legacy_bf16_fwd(const float* x, const float* zs, const float* u,
                          const void* wt, const float* os, const float* inv_ls,
                          const float* mean_w, const float* mean_b, float* mean,
                          float* var, int R, int d, int M, int phases,
                          void* stream) {
  const int m_pad = (M + legacy::BK - 1) / legacy::BK * legacy::BK;
  const int smem = (m_pad * legacy::KT_STRIDE + legacy::WBUF) * (int)sizeof(float);
  auto kernel = phases == 1 ? legacy::bf16_fwd_kernel<1> : legacy::bf16_fwd_kernel<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(R + legacy::TR - 1) / legacy::TR, legacy::THREADS, smem,
           (cudaStream_t)stream>>>(
      x, zs, u, static_cast<const __nv_bfloat16*>(wt), os, inv_ls, mean_w,
      mean_b, mean, var, R, d, M, m_pad);
  return (int)cudaGetLastError();
}

// rbf route (a), one GP: out (R, M) = K from xs zs^T on `wgb::gemm_kernel`,
// x (Rp, 64) raw and zero-padded, split into three bf16 parts on load after
// scaling by inv_ls (64, zero-padded); zsp three bf16 planes (Mp, 64) of
// zs; x2 (Rp), z2 (Mp) the squared norms; d <= 64, one stage at two blocks
// an SM
int probe_rbf_a(const float* x, const float* inv_ls, const void* zsp,
                const float* x2, const float* z2, const float* os, float* out,
                int R, int M, int Rp, int Mp, void* stream) {
  using namespace wgb;
  const bf16* z = static_cast<const bf16*>(zsp);
  const size_t plane = (size_t)Mp * GKC;
  const F32Operand a{x, inv_ls, GKC};
  const Operand b{{z, z + plane, z + 2 * plane}, GKC};
  const rbf_a::RbfEpi epi{x2, z2, os, out, R, M};
  return gemm<PARTS, false, 0, false, 2, 2>(Rp / GT, Mp / GT, 1, a, b, GKC, GKC,
                                            epi, (cudaStream_t)stream);
}

// out (G, per_gp) written with os[g] exp(-1/2), per_gp a multiple of 4
int probe_store_only(float* out, const float* os, int G, long long per_gp,
                     void* stream) {
  rbf_a::store_only_kernel<<<dim3(132 * 8, G), 256, 0, (cudaStream_t)stream>>>(
      out, os, per_gp);
  return (int)cudaGetLastError();
}

}  // extern "C"
