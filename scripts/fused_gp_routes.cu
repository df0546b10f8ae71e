// Three ways to run the fp32 fused-GP backward's two large products on an
// H100 -- G = K W (2 M^2 a row) and dW = K^T diag(dvar) K (symmetric) -- for
// scripts/fused_gp_routes.py, which times them and holds what each gives
// against float64.  Built by that script with nvcc for sm_90a.
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

#include "../fine_grained_gaussian_process_forcasting_torch/csrc/fused_gp.cu"

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

}  // extern "C"
