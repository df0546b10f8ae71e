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
// What bounds it on an H100: arithmetic.  The fp32 function's products --
// the distance's cross term xs zs^T (2 M d a row), K W (2 M^2), and in the
// VJP E zs, E^T xs (2 M d each) and dW (M (M + 1), symmetric) -- are
// 39-58 GFLOP a call at the flagship (73,728 rows, d 32, M 512), 0.6-0.9 ms
// at the CUDA cores' 67 TFLOP/s.  They run on the tensor cores (`wgmma`,
// 989 TFLOP/s in bf16), as products of bf16 parts that keep the fp32
// operand's 24 bits: the `wgb::` engine below, which every entry uses --
// all but the fp32 forward's K W, which stays an FFMA chain in the plain
// version's order (see kw_var_kernel: at the ill-conditioned W of a
// 512-point Gram matrix the variance's rounding is that chain's).  The
// bytes (x in, two vectors out, W once; between launches K and E) take a
// fraction of that.
//
// Every entry is a `wgb::` sequence of a handful of launches with
// fixed-order sums and no atomics, so the outputs are equal bit for bit
// from run to run, at any M (the Pallas kernels sum across their grid with
// init-at-step-0-then-add, which is right only on the TPU's sequential
// grid; CUDA blocks run concurrently and in no order, so every sum over
// rows or inducing points is taken in partials that a last launch adds in
// a fixed order).  The bf16 forward is the fp32 forward's sequence with
// its K W on the tensor cores: the parts of x (and x . mean_w), zs and
// bf16(W^T); K^T from the cross term in three parts, as the reference's
// fp32 distance needs, written in fp32 with the partial K u; G^T = W^T K^T
// from bf16(W) and bf16(K), K rounded on its way into shared memory (a
// bf16(K) written by the K^T launch measured slower at every shape), its
// epilogue the partial sums of (K W o K) with K in fp32; the last pass a
// row.  K goes from the K^T launch to the next through device memory once,
// in fp32; K W never does.
//
// The seed axis: one call computes S independent functions (S seeds of a
// model, each with its own x and parameters, as JAX's vmap over a leading
// batch axis gives the Pallas kernels a grid axis).  Every launch of the
// sequence runs all S along gridDim.z, and seed z's inputs and outputs lie
// z strides of one seed's element counts past seed 0's, its scratch z
// scratch sizes past (`seed_at`, `bump`).  A seed's blocks compute exactly
// what a call of S = 1 computes, so the outputs equal S calls bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

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

// p (if not null) moved `bytes` on: seed z's scratch array, `bytes` the
// scratch of z seeds
template <class T>
__host__ __device__ __forceinline__ T* bump(T* p, size_t bytes) {
  return p == nullptr ? p
                      : reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(p) + bytes);
}

// seed blockIdx.z's array of n elements a seed (p null stays null)
template <class T>
__device__ __forceinline__ T* seed_at(T* p, size_t n) {
  return p == nullptr ? p : p + blockIdx.z * n;
}

// ---------------------------------- products on `wgmma` (any M): `wgb::` --
//
// Both forwards and both backwards, as a few products and passes around
// them, every product on Hopper's warpgroup tensor-core instructions
// (wgmma_bf16.cuh).  An fp32 operand v is carried as three bf16 parts
// p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1), which hold its 24
// bits, and a product as the sum of the six part products p_i q_j with
// i + j < 3, in fp32.  The tensor cores' fp32 sums are less exact than
// FFMA's over long runs of the summed index (their errors lean one way and
// add up over the rows that E's column sums and dW take), so E zs and E^T
// xs add every 16-column sum into the tile's accumulator in fp32, the fp32
// K W and dW every 64-column one, and the bf16 K W every 512-column one.
// (Two parts of K in E, or of E, put dxs, dzs, dinv_ls and dos several
// times farther from float64 than the plain version; so did long
// tensor-core sums -- 512-column ones in the fp32 K W put dzs 7x as far,
// unbroken ones in dW put dW 8x -- and in the bf16 K W so did short ones
// where W is ill-conditioned.)  An operand enters shared memory in
// one of two ways: its parts stored in device memory and copied by
// cp.async (`Operand`), or as fp32, split into its parts on the way
// (`F32Operand`): each thread loads its share of the next stage into
// registers before the current stage's products are issued, and splits and
// stores it while they run.  Everything is computed in the orientation that
// lets both operands of every product be read from rows in device memory
// (K and E as (M, R)):
//   prep     xs = x o inv_ls in three parts (R, d) and |xs|^2; zs in three
//            parts, and transposed; W^T in three parts (fp32) or as bf16;
//   1. K^T   (M, R) = os exp(-(|zs|^2 + |xs|^2 - 2 zs xs^T) / 2), the cross
//            term summed over d in steps of 64; writes K in fp32 and
//            (forward) per 128-inducing-point range the partial K u, or
//            (backward) per 128-row range the partial K^T dmean (du) and,
//            bf16, bf16(K) and bf16(dvar o K);
//   2. G^T   = W^T K^T, the backward's: fp32, K split on load; bf16, from
//            bf16(K); E^T = (u dmean^T - 2 G^T dvar) o K in the epilogue,
//            written (fp32: as fp32, bf16: in three parts), and per range
//            the partial row and column sums of E.  The bf16 forward's the
//            same with K rounded to bf16 on load, its epilogue the partial
//            sums of (G o K) per range (VarEpi); the fp32 forward's K W is
//            one FFMA chain an element instead, in the plain version's
//            order (kw_var_kernel), its epilogue the same sums;
//   3. dxs^T = zs^T E^T - rowsum(E) xs^T; dx = dxs o inv_ls + dmean mean_w
//            through a shared-memory transpose, and per range the partial
//            sums of dxs o x and dmean o x;
//   4. E^T xs over slabs of rows: (S, M, d) partials;
//   5. dW    fp32: K^T diag(dvar) K over slabs of rows, both operands split
//            from K on load (the second scaled by dvar), only the tiles on
//            and above the diagonal; bf16: bf16(K)^T bf16(dvar o K);
//   reduce   the partials in a fixed order: forward, mean and var a row;
//            backward, in float64, du, dzs, dW, dos, dinv_ls, dmean_w,
//            dmean_b.
// Each product is one kernel, gemm_kernel: a 128 x 128 output tile per
// block of two warpgroups (64 rows each, 64 x 128 accumulators), the
// operands streamed 64 columns of the summed index at a time through a ring
// of shared-memory stages.  Scratch arrays are padded to whole tiles (rows
// and columns to 128) and their pads hold zeros, so the copies need no
// masks; the inputs and outputs are not padded.  No atomics: two runs give
// equal results bit for bit.

namespace wgb {

using hopper::ROW_BYTES;
typedef __nv_bfloat16 bf16;

constexpr int GT = 128;          // output tile rows and columns
constexpr int GKC = 64;          // summed index per stage
constexpr int GTILE = GT * GKC * 2;  // bytes of one operand part a stage
constexpr int PARTS = 3;         // bf16 parts of an fp32 operand
// k16 steps of the tensor cores' sums, each added into the tile's in fp32
constexpr int SUM_KW_BF16 = 32;  // bf16 K W: 512 inducing points
constexpr int SUM_F32 = 4;       // fp32 K W and dW: 64 of the summed index

// An fp32 operand carried as P bf16 parts (P 1: one bf16 operand): part 0 =
// bf16(v), part i = bf16(v - parts 0..i-1), rows of `ld` elements.
struct Operand {
  static constexpr bool f32 = false;
  const bf16* part[PARTS];
  int ld;

  // the same operand of the seed whose scratch starts `zb` bytes on
  __device__ Operand seed(size_t zb) const {
    return {{bump(part[0], zb), bump(part[1], zb), bump(part[2], zb)}, ld};
  }
};

// An fp32 operand split into its parts on the way into shared memory: rows
// of `ld` floats; where `scale` is not null (K-major operands only),
// element k of a row is first multiplied by scale[k], in fp32.
struct F32Operand {
  static constexpr bool f32 = true;
  const float* v;
  const float* scale;
  int ld;

  __device__ F32Operand seed(size_t zb) const {
    return {bump(v, zb), bump(scale, zb), ld};
  }
};

// stages of the ring: three, two where P = 3 parts leave room for two
template <int P>
__host__ __device__ constexpr int stages() { return P == 3 ? 2 : 3; }
template <int P>
__host__ __device__ constexpr int stage_bytes() { return 2 * P * GTILE; }
template <int P>
__host__ __device__ constexpr int gemm_smem() { return stages<P>() * stage_bytes<P>() + 1024; }

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float from_bf16(bf16 v) { return __bfloat162float(v); }

// v split into N bf16 parts: v ~ p[0] + ... + p[N - 1]
template <int N>
__device__ __forceinline__ void split(float v, bf16 (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = to_bf16(v);
    v -= from_bf16(p[i]);
  }
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A block's output tile: row tile rt (rows row0..), column tile ct, and
// the slab of the summed index.  The tiles run along x, the row tiles
// fastest, so that the blocks of a column tile, which share its operand
// rows, run together and x has room for any R; the slabs run along y.
struct Tile {
  int rt, ct, slab, row0, col0;
};
__device__ __forceinline__ Tile tile(int row_tiles) {
  const int rt = blockIdx.x % row_tiles, ct = blockIdx.x / row_tiles;
  return {rt, ct, (int)blockIdx.y, rt * GT, ct * GT};
}
// a symmetric product's: the x-th tile on and above the diagonal of
// row_tiles x row_tiles, row by row
__device__ __forceinline__ Tile sym_tile(int row_tiles) {
  int t = blockIdx.x, len = row_tiles, rt = 0;
  while (t >= len) {
    t -= len;
    ++rt;
    --len;
  }
  return {rt, rt + t, (int)blockIdx.y, rt * GT, (rt + t) * GT};
}

// one stage: A rows row0.. x columns k0..k0+63 (K-major), and B: K-major
// rows col0.. x columns k0.., or MN-major rows k0.. x columns col0..col0+127
template <bool B_MN, int P>
__device__ __forceinline__ void load_stage(unsigned char* st, const Operand& A,
                                           const Operand& B, int row0,
                                           int col0, int k0) {
  const uint32_t base = hopper::smem_u32(st);
  for (int i = threadIdx.x; i < P * GT * 8; i += 2 * 128) {
    const int p = i / (GT * 8);
    const int j = i - p * (GT * 8);
    const int r = j >> 3, c = j & 7;
    const bf16* src = A.part[p] + (size_t)(row0 + r) * A.ld + k0 + c * 8;
    hopper::cp16(base + p * GTILE + hopper::swizzled(GT, r, c), src);
  }
  const uint32_t bbase = base + P * GTILE;
  for (int i = threadIdx.x; i < P * GT * 8; i += 2 * 128) {
    const int p = i / (GT * 8);
    const int j = i - p * (GT * 8);
    const bf16* b = B.part[p];
    if (B_MN) {  // 64 rows of 16 chunks
      const int r = j >> 4, c = j & 15;
      hopper::cp16(bbase + p * GTILE + hopper::swizzled(GKC, r, c),
                   b + (size_t)(k0 + r) * B.ld + col0 + c * 8);
    } else {
      const int r = j >> 3, c = j & 7;
      hopper::cp16(bbase + p * GTILE + hopper::swizzled(GT, r, c),
                   b + (size_t)(col0 + r) * B.ld + k0 + c * 8);
    }
  }
}

// The same for one operand of a stage whose other operand is split on
// load: its parts by cp.async into the operand's planes at `base`; MN:
// rows k0.. x columns rc0..rc0+127, else rows rc0.. x columns k0..
template <bool MN, int P>
__device__ __forceinline__ void copy_operand(uint32_t base, const Operand& o,
                                             int rc0, int k0) {
  for (int i = threadIdx.x; i < P * GT * 8; i += 2 * 128) {
    const int p = i / (GT * 8);
    const int j = i - p * (GT * 8);
    if (MN) {
      const int r = j >> 4, c = j & 15;
      hopper::cp16(base + p * GTILE + hopper::swizzled(GKC, r, c),
                   o.part[p] + (size_t)(k0 + r) * o.ld + rc0 + c * 8);
    } else {
      const int r = j >> 3, c = j & 7;
      hopper::cp16(base + p * GTILE + hopper::swizzled(GT, r, c),
                   o.part[p] + (size_t)(rc0 + r) * o.ld + k0 + c * 8);
    }
  }
}

// A thread's share of one fp32 operand tile of a stage, in registers: 8
// float4 of the 128 x 64 (K-major: rows (tid >> 4) + 16 c, columns
// 4 (tid & 15)..) or 64 x 128 (MN-major: rows (tid >> 5) + 8 c, columns
// 4 (tid & 31)..) floats, and (K-major, scaled) its four columns' scale.
struct Staged {
  float4 v[8];
  float4 s;
};

template <bool MN>
__device__ __forceinline__ void fetch(Staged& st, const F32Operand& o, int rc0,
                                      int k0) {
  const int tid = threadIdx.x;
  const float* src = MN ? o.v + (size_t)(k0 + (tid >> 5)) * o.ld + rc0 + 4 * (tid & 31)
                        : o.v + (size_t)(rc0 + (tid >> 4)) * o.ld + k0 + 4 * (tid & 15);
  const size_t step = (size_t)(MN ? 8 : 16) * o.ld;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    st.v[c] = __ldg(reinterpret_cast<const float4*>(src + c * step));
  if (!MN && o.scale != nullptr)
    st.s = __ldg(reinterpret_cast<const float4*>(o.scale + k0 + 4 * (tid & 15)));
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b)
               : "memory");
}

// the fetched share, split into P parts, into the operand's planes at base
// (the layout cp.async gives Operand's parts)
template <bool MN, int P>
__device__ __forceinline__ void store_split(uint32_t base, const Staged& st,
                                            bool scaled) {
  const int tid = threadIdx.x;
  const int c4 = MN ? tid & 31 : tid & 15;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float4 v = st.v[c];
    if (scaled) {
      v.x *= st.s.x; v.y *= st.s.y; v.z *= st.s.z; v.w *= st.s.w;
    }
    const int r = MN ? (tid >> 5) + 8 * c : (tid >> 4) + 16 * c;
    const uint32_t at = base + hopper::swizzled(MN ? GKC : GT, r, c4 >> 1) + (c4 & 1) * 8;
    bf16 p[4][P];
    split(v.x, p[0]);
    split(v.y, p[1]);
    split(v.z, p[2]);
    split(v.w, p[3]);
#pragma unroll
    for (int i = 0; i < P; ++i)
      st_shared_v2(at + i * GTILE, pack2(p[0][i], p[1][i]), pack2(p[2][i], p[3][i]));
  }
}

// row and column, in the block's 128 x 128 tile, of accumulator element i
// of slab nt
__device__ __forceinline__ int acc_row(int i) {
  return 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) +
         ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int nt, int i) {
  return 64 * nt + 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// sums of a thread's values over the 4 lanes that share its rows
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// sums over the tile's 128 rows of each column of acc, in a fixed order:
// the two rows of a thread, the 8 row groups of a warp, then the 8 warps in
// order; out[c] for the 128 columns c.  red is 8 x 128 floats of shared
// memory.
__device__ __forceinline__ void col_sums(float (&acc)[2][32], float* red,
                                         float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 32; i += 4)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = acc[nt][i + q] + acc[nt][i + 2 + q];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) red[warp * GT + acc_col(nt, i + q)] = v;
      }
  __syncthreads();
  if (threadIdx.x < GT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * GT + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// C (the block's 128 x 128 tile) = sum over the summed index in
// [k_len slab, min(k_len (slab + 1), k_total)) of A B, then epi(acc, smem,
// tile).  A and B carry P parts each (1 or PARTS), and the product sums
// the part products A_i B_j with i + j < P.  SUM: the k16 steps whose
// products the tensor cores sum in a fresh accumulator before it is added
// to the tile's in fp32 (0: the tensor cores carry the whole sum; a
// multiple of 4 steps: whole stages).  SYM: the tiles on and above the
// diagonal of a square product (sym_tile).  OA, OB: Operand or F32Operand.
// NT: the tile's 64-column halves that hold data (1: the second is
// padding, and no product is issued for it).  MINB 2: two blocks an SM: of
// three parts, for a sum of one stage (k_total <= GKC), which needs one
// buffer of the ring; of one part (P 1), the whole ring fits twice.
//
// Seed blockIdx.z: A, B and epi as seed 0's, moved on by `zb` bytes of
// scratch a seed (and the epilogue's inputs and outputs by a seed's
// elements: Epi::seed).
template <int P, bool B_MN, int SUM, class Epi, bool SYM = false,
          class OA = Operand, class OB = Operand, int NT = 2, int MINB = 1>
__global__ void __launch_bounds__(256, MINB)
gemm_kernel(OA A0, OB B0, int row_tiles, int k_len, int k_total, Epi epi0,
            size_t zb) {
  const size_t zoff = blockIdx.z * zb;
  const OA A = A0.seed(zoff);
  const OB B = B0.seed(zoff);
  const Epi epi = epi0.seed(zoff);
  static_assert(SUM == 0 || SUM == 1 || SUM % (GKC / 16) == 0, "SUM");
  constexpr bool SPLIT = OA::f32 || OB::f32;
  static_assert(!SPLIT || P == PARTS || P == 1,
                "an operand is split into PARTS parts, or rounded to one");
  // the fp32 products (an operand split on load, or 64-column sums) issue
  // one m64n128k16 for both halves of the tile, which reads A from shared
  // memory once instead of twice
  constexpr bool N128 = (SPLIT || SUM == SUM_F32) && NT == 2;
  constexpr int GSTAGES = stages<P>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1024(smem_raw);
  const Tile t = SYM ? sym_tile(row_tiles) : tile(row_tiles);
  const int kbeg = t.slab * k_len;
  const int nk = (min(k_len, k_total - kbeg) + GKC - 1) / GKC;
  const int wgi = threadIdx.x >> 7;
  auto stage = [&](int s) { return sm + s * stage_bytes<P>(); };

  float acc[2][32], part[2][32];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nt][i] = 0.f;
  auto add_part = [&] {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nt][i] += part[nt][i];
  };

  // the products of stage j (in buffer j % GSTAGES); between() runs while
  // the first group of them is in flight
  auto products = [&](int js, auto&& between) {
    const uint32_t s = hopper::smem_u32(stage(js % GSTAGES));
    const uint32_t a0 = s + wgi * 64 * ROW_BYTES;
    const uint32_t b0 = s + P * GTILE;
    auto bdesc = [&](int j, int nt, int kk) {
      const uint32_t b = b0 + j * GTILE;
      return B_MN ? hopper::mndesc(b, GKC, nt, kk)
                  : hopper::kdesc(b + nt * 64 * ROW_BYTES, GT, kk);
    };
    // both halves of part j's B at step kk, for mma128
    auto bdesc128 = [&](int j, int kk) {
      const uint32_t b = b0 + j * GTILE;
      return B_MN ? hopper::desc_mn(b + kk * 16 * ROW_BYTES, GKC * ROW_BYTES)
                  : hopper::kdesc(b, GT, kk);
    };
    // the part products smallest first (i + j from P - 1 down to 0): the
    // tensor cores truncate each sum to the accumulator's exponent, so the
    // largest product is added last, once
    if constexpr (SUM == 1) {
#pragma unroll
      for (int kk = 0; kk < GKC / 16; ++kk) {
        hopper::fence();
#pragma unroll
        for (int q = P - 1; q >= 0; --q)
#pragma unroll
          for (int i = 0; i <= q; ++i) {
            const uint64_t a = hopper::kdesc(a0 + i * GTILE, GT, kk);
            const int keep = q < P - 1 || i > 0;
            if constexpr (N128) {
              hopper::mma128<B_MN>(part[0], part[1], a, bdesc128(q - i, kk), keep);
            } else {
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                hopper::mma<B_MN>(part[nt], a, bdesc(q - i, nt, kk), keep);
            }
          }
        hopper::commit();
        if (kk == 0) between();
        hopper::wait<0>();
        hopper::pin(part[0]);
        hopper::pin(part[1]);
        add_part();
      }
    } else {
      [[maybe_unused]] constexpr int per = SUM ? SUM / (GKC / 16) : 1;  // stages a sum spans
      hopper::fence();
#pragma unroll
      for (int q = P - 1; q >= 0; --q)
#pragma unroll
        for (int kk = 0; kk < GKC / 16; ++kk)
#pragma unroll
          for (int i = 0; i <= q; ++i) {
            const uint64_t a = hopper::kdesc(a0 + i * GTILE, GT, kk);
            const int keep = js % per != 0 || q < P - 1 || kk > 0 || i > 0;
            if constexpr (N128) {
              if constexpr (SUM == 0)
                hopper::mma128<B_MN>(acc[0], acc[1], a, bdesc128(q - i, kk));
              else
                hopper::mma128<B_MN>(part[0], part[1], a, bdesc128(q - i, kk), keep);
            } else {
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                if constexpr (SUM == 0)
                  hopper::mma<B_MN>(acc[nt], a, bdesc(q - i, nt, kk));
                else
                  hopper::mma<B_MN>(part[nt], a, bdesc(q - i, nt, kk), keep);
              }
            }
          }
      hopper::commit();
      between();
      hopper::wait<0>();
      if constexpr (SUM == 0) {
        hopper::pin(acc[0]);
        hopper::pin(acc[1]);
      } else {
        hopper::pin(part[0]);
        hopper::pin(part[1]);
        if (js % per == per - 1 || js == nk - 1) add_part();
      }
    }
  };

  if constexpr (SPLIT) {
    // two buffers: stage j + 1 is fetched before stage j's products are
    // issued, and split into the other buffer while they run
    Staged sa, sb;
    auto fetch_stage = [&](int j) {
      const int k0 = kbeg + j * GKC;
      const uint32_t base = hopper::smem_u32(stage(j % GSTAGES));
      if constexpr (OA::f32) fetch<false>(sa, A, t.row0, k0);
      else copy_operand<false, P>(base, A, t.row0, k0);
      if constexpr (OB::f32) fetch<B_MN>(sb, B, t.col0, k0);
      else copy_operand<B_MN, P>(base + P * GTILE, B, t.col0, k0);
      hopper::cp_commit();
    };
    auto store_stage = [&](int j) {
      const uint32_t base = hopper::smem_u32(stage(j % GSTAGES));
      if constexpr (OA::f32) store_split<false, P>(base, sa, A.scale != nullptr);
      if constexpr (OB::f32)
        store_split<B_MN, P>(base + P * GTILE, sb, !B_MN && B.scale != nullptr);
    };
    if (nk > 0) {
      fetch_stage(0);
      store_stage(0);
    }
    for (int j = 0; j < nk; ++j) {
      hopper::cp_wait<0>();
      hopper::fence_async_smem();
      __syncthreads();  // stage j is in; the other buffer is read by no one
      const bool more = j + 1 < nk;
      if (more) fetch_stage(j + 1);
      products(j, [&] {
        if (more) store_stage(j + 1);
      });
    }
  } else {
    auto load = [&](int j) {
      if (j < nk)
        load_stage<B_MN, P>(stage(j % GSTAGES), A, B, t.row0, t.col0, kbeg + j * GKC);
      hopper::cp_commit();
    };
#pragma unroll
    for (int j = 0; j < GSTAGES - 1; ++j) load(j);
    for (int j = 0; j < nk; ++j) {
      hopper::cp_wait<GSTAGES - 2>();
      hopper::fence_async_smem();
      __syncthreads();  // stage j is in; stage j - 1 is read by every warpgroup
      load(j + GSTAGES - 1);
      products(j, [] {});
    }
  }
  hopper::cp_wait<0>();
  __syncthreads();  // the ring is free for the epilogue
  epi(acc, reinterpret_cast<float*>(sm), t);
}

// 1. K^T tile: rows m, columns r; the backward's
struct KEpi {
  const float* x2;  // (Rp) |xs|^2, zeros past R
  const float* z2;  // (Mp)
  const float* os_ptr;
  const float* dmean;
  const float* dvar;
  bf16 *kh, *dvk;   // (Mp, Rp): bf16(K), bf16(dvar o K); null in fp32
  float* kf;        // (Mp, Rp): K
  float* part_du;   // (Rp / 128, Mp)
  int M, R, Mp, Rp;

  // seed blockIdx.z's, its scratch `zb` bytes on
  __device__ KEpi seed(size_t zb) const {
    const size_t z = blockIdx.z;
    return {bump(x2, zb), bump(z2, zb), os_ptr + z, dmean + z * R, dvar + z * R,
            bump(kh, zb), bump(dvk, zb), bump(kf, zb), bump(part_du, zb),
            M, R, Mp, Rp};
  }

  __device__ void operator()(float (&acc)[2][32], float*, const Tile& t) const {
    const float os = *os_ptr;
    float du[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int m = t.row0 + acc_row(i);
        const int r = t.col0 + acc_col(nt, i);
        const float zz = z2[m];
        float k[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = m < M && r + e < R;
          const float d2 = (x2[r + e] + zz) - 2.f * acc[nt][i + e];
          k[e] = ok ? os * expf(-0.5f * d2) : 0.f;
          dv[e] = r + e < R ? dvar[r + e] : 0.f;
          du[(i >> 1) & 1] = fmaf(k[e], r + e < R ? dmean[r + e] : 0.f, du[(i >> 1) & 1]);
        }
        const size_t at = (size_t)m * Rp + r;
        *reinterpret_cast<float2*>(kf + at) = make_float2(k[0], k[1]);
        if (kh != nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(kh + at) =
              __halves2bfloat162(to_bf16(k[0]), to_bf16(k[1]));
          *reinterpret_cast<__nv_bfloat162*>(dvk + at) = __halves2bfloat162(
              to_bf16(dv[0] * k[0]), to_bf16(dv[1] * k[1]));
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s = quad_sum(du[h]);
      if ((threadIdx.x & 3) == 0)
        part_du[(size_t)t.ct * Mp + t.row0 + acc_row(2 * h)] = s;
    }
  }
};

// 1. K^T tile, the forward's: K, and K^T u summed over the tile's rows m
struct FwdKEpi {
  const float* x2;  // (Rp)
  const float* z2;  // (Mp)
  const float* os_ptr;
  const float* u;
  float* kf;        // (Mp, Rp): K
  float* part_mu;   // (Mp / 128, Rp)
  int M, R, Rp;

  __device__ FwdKEpi seed(size_t zb) const {
    const size_t z = blockIdx.z;
    return {bump(x2, zb), bump(z2, zb), os_ptr + z, u + z * M, bump(kf, zb),
            bump(part_mu, zb), M, R, Rp};
  }

  __device__ void operator()(float (&acc)[2][32], float* red, const Tile& t) const {
    const float os = *os_ptr;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int m = t.row0 + acc_row(i);
        const int r = t.col0 + acc_col(nt, i);
        const float zz = z2[m];
        const float um = m < M ? u[m] : 0.f;
        float k[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d2 = (x2[r + e] + zz) - 2.f * acc[nt][i + e];
          k[e] = m < M && r + e < R ? os * expf(-0.5f * d2) : 0.f;
          acc[nt][i + e] = k[e] * um;
        }
        *reinterpret_cast<float2*>(kf + (size_t)m * Rp + r) = make_float2(k[0], k[1]);
      }
    col_sums(acc, red, part_mu + (size_t)t.rt * Rp + t.col0);
  }
};

// 2. (bf16 forward) G^T tile = W^T K^T from bf16(W) and bf16(K): rows n,
// columns r; (G o K) summed over the tile's 128 inducing points n, per row
// r, K in fp32 as the plain version meets K W with it
struct VarEpi {
  const float* kf;  // (Mp, Rp): K
  float* part_v;    // (Mp / 128, Rp)
  int Rp;

  __device__ VarEpi seed(size_t zb) const {
    return {bump(kf, zb), bump(part_v, zb), Rp};
  }

  __device__ void operator()(float (&acc)[2][32], float* red, const Tile& t) const {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 k = *reinterpret_cast<const float2*>(
            kf + (size_t)(t.row0 + acc_row(i)) * Rp + t.col0 + acc_col(nt, i));
        acc[nt][i] *= k.x;
        acc[nt][i + 1] *= k.y;
      }
    col_sums(acc, red, part_v + (size_t)t.rt * Rp + t.col0);
  }
};

// 2. (forward) the variance's sums, (K W o K) over a range of 128 of W's
// columns, per row: FFMA, each (K W)[r, n] one fma chain over m = 0, 1, ...
// in order -- the order of cuBLAS's fp32 product, so that the variance,
// whose rounding at an ill-conditioned W is that chain's (W ~ 100 against
// a variance ~ 0.4), stays within 1e-4 of the plain version's, as no other
// order of the sum can.  256 threads as 16 x 16 own a 128 (n) x 128 (r)
// tile of (K W)^T, a thread 8 x 8 of it; W and K^T stream through shared
// memory FK inducing points at a time, the next chunk's loads in flight in
// registers; two blocks an SM.  The x blocks run along n, so that the
// blocks of one row range, which share its K^T, run together.
constexpr int FK = 8;

__global__ void __launch_bounds__(256, 2)
kw_var_kernel(const float* __restrict__ w, const float* __restrict__ kf,
              float* __restrict__ part_v, int M, int Rp, size_t zb) {
  w = seed_at(w, (size_t)M * M);
  kf = bump(kf, blockIdx.z * zb);
  part_v = bump(part_v, blockIdx.z * zb);
  __shared__ __align__(16) float ws[2][FK][GT];  // W rows m, columns n0..
  __shared__ __align__(16) float ks[2][FK][GT];  // K^T rows m, columns r0..
  __shared__ float red[8][GT];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * GT, r0 = blockIdx.y * GT;
  const int lr = tid >> 5, lc = 4 * (tid & 31);  // this thread's loads
  float pw[4];
  float4 pk;
  auto fetch = [&](int m0) {
    const int m = m0 + lr;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pw[e] = m < M && n0 + lc + e < M ? __ldg(w + (size_t)m * M + n0 + lc + e) : 0.f;
    pk = *reinterpret_cast<const float4*>(kf + (size_t)m * Rp + r0 + lc);
  };
  auto stash = [&](int buf) {
    *reinterpret_cast<float4*>(&ws[buf][lr][lc]) = make_float4(pw[0], pw[1], pw[2], pw[3]);
    *reinterpret_cast<float4*>(&ks[buf][lr][lc]) = pk;
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int chunks = (M + FK - 1) / FK;  // K^T's rows past M are zeros
  fetch(0);
  stash(0);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) fetch((c + 1) * FK);
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 wl = *reinterpret_cast<const float4*>(&ws[buf][kk][ty * 4]);
      const float4 wh = *reinterpret_cast<const float4*>(&ws[buf][kk][64 + ty * 4]);
      const float4 kl = *reinterpret_cast<const float4*>(&ks[buf][kk][tx * 4]);
      const float4 kh = *reinterpret_cast<const float4*>(&ks[buf][kk][64 + tx * 4]);
      const float a[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
      const float b[8] = {kl.x, kl.y, kl.z, kl.w, kh.x, kh.y, kh.z, kh.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(b[j], a[i], acc[i][j]);
    }
    if (c + 1 < chunks) stash(buf ^ 1);
    __syncthreads();
  }
  // v[j]: sum over the thread's 8 columns n of (K W)[r_j, n] K[r_j, n]
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    const float* kn = kf + (size_t)n * Rp + r0 + tx * 4;
    const float4 lo = *reinterpret_cast<const float4*>(kn);
    const float4 hi = *reinterpret_cast<const float4*>(kn + 64);
    const float k[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaf(acc[i][j], k[j], v[j]);
  }
  // over the 16 ty of a column in a fixed order: the two of a warp, then
  // the 8 warps
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], 16);
  if (lane < 16) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[warp][j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4] = v[j];
  }
  __syncthreads();
  if (tid < GT) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) sum += red[q][tid];
    part_v[(size_t)blockIdx.x * Rp + r0 + tid] = sum;
  }
}

// 2. G^T tile = W^T K^T: rows m, columns r; E^T = (u dmean - 2 dvar G) o K
struct EEpi {
  const float* kf;
  const float* u;
  const float* dmean;
  const float* dvar;
  bf16* ep;           // bf16: PARTS planes (Mp, Rp), E's parts
  float* ef;          // fp32: (Mp, Rp), E
  float* part_ce;     // (Rp / 128, Mp): sums over the range's rows
  float* part_re;     // (Mp / 128, Rp): sums over the tile's inducing points
  int M, R, Mp, Rp;

  __device__ EEpi seed(size_t zb) const {
    const size_t z = blockIdx.z;
    return {bump(kf, zb), u + z * M, dmean + z * R, dvar + z * R, bump(ep, zb),
            bump(ef, zb), bump(part_ce, zb), bump(part_re, zb), M, R, Mp, Rp};
  }

  __device__ void operator()(float (&acc)[2][32], float* red, const Tile& t) const {
    const size_t plane = (size_t)Mp * Rp;
    float ce[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int m = t.row0 + acc_row(i);
        const int r = t.col0 + acc_col(nt, i);
        const size_t at = (size_t)m * Rp + r;
        const float2 k = *reinterpret_cast<const float2*>(kf + at);
        const float um = m < M ? u[m] : 0.f;
        bf16 p[2][PARTS];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const bool ok = r + q < R;
          const float dm = ok ? dmean[r + q] : 0.f;
          const float dv = ok ? dvar[r + q] : 0.f;
          const float e = (dm * um - (2.f * dv) * acc[nt][i + q]) * (q ? k.y : k.x);
          acc[nt][i + q] = e;
          ce[(i >> 1) & 1] += e;
          if (ef == nullptr) split(e, p[q]);
        }
        if (ef != nullptr) {
          *reinterpret_cast<float2*>(ef + at) = make_float2(acc[nt][i], acc[nt][i + 1]);
        } else {
#pragma unroll
          for (int j = 0; j < PARTS; ++j)
            *reinterpret_cast<__nv_bfloat162*>(ep + j * plane + at) =
                __halves2bfloat162(p[0][j], p[1][j]);
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s = quad_sum(ce[h]);
      if ((threadIdx.x & 3) == 0)
        part_ce[(size_t)t.ct * Mp + t.row0 + acc_row(2 * h)] = s;
    }
    col_sums(acc, red, part_re + (size_t)t.rt * Rp + t.col0);
  }
};

// 3. (E zs)^T tile: rows k of d, columns r; dx through shared memory
struct DxEpi {
  const float* x;  // (R, d) raw
  const float* inv_ls;
  const float* mean_w;
  const float* dmean;
  const float* part_re;  // (Mp / 128, Rp)
  float* dx;             // (R, d)
  float* part_dx;        // (Rp / 128, 2 Dp): sums of dxs o x, then dmean o x
  int R, d, Dp, Rp, m_tiles;

  __device__ DxEpi seed(size_t zb) const {
    const size_t z = blockIdx.z, rd = (size_t)R * d;
    return {x + z * rd, inv_ls + z * d, mean_w + z * d, dmean + z * R,
            bump(part_re, zb), dx + z * rd, bump(part_dx, zb), R, d, Dp, Rp,
            m_tiles};
  }

  __device__ void operator()(float (&acc)[2][32], float* sm, const Tile& t) const {
    constexpr int LD = GT + 1;
    float* xt = sm;              // [128 r][LD]: x, then dx
    float* rse = sm + GT * LD;   // [128] rowsum(E)
    float* dms = rse + GT;       // [128] dmean
    for (int i = threadIdx.x; i < GT * GT; i += 256) {
      const int rl = i >> 7, kl = i & (GT - 1);
      const int r = t.col0 + rl, k = t.row0 + kl;
      xt[rl * LD + kl] = (r < R && k < d) ? x[(size_t)r * d + k] : 0.f;
    }
    if (threadIdx.x < GT) {
      const int r = t.col0 + threadIdx.x;
      float s = 0.f;
      for (int m = 0; m < m_tiles; ++m) s += part_re[(size_t)m * Rp + r];
      rse[threadIdx.x] = s;
      dms[threadIdx.x] = r < R ? dmean[r] : 0.f;
    }
    __syncthreads();
    float sdx[2] = {0.f, 0.f}, sdm[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kl = acc_row(i), rl = acc_col(nt, i);
        const int k = t.row0 + kl;
        const float il = k < d ? inv_ls[k] : 0.f;
        const float mw = k < d ? mean_w[k] : 0.f;
        const float xv = xt[rl * LD + kl];
        const float dxs = acc[nt][i] - rse[rl] * (xv * il);
        xt[rl * LD + kl] = dxs * il + dms[rl] * mw;
        sdx[(i >> 1) & 1] = fmaf(dxs, xv, sdx[(i >> 1) & 1]);
        sdm[(i >> 1) & 1] = fmaf(dms[rl], xv, sdm[(i >> 1) & 1]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = quad_sum(sdx[h]), b = quad_sum(sdm[h]);
      if ((threadIdx.x & 3) == 0) {
        const int k = t.row0 + acc_row(2 * h);
        part_dx[(size_t)t.ct * 2 * Dp + k] = a;
        part_dx[(size_t)t.ct * 2 * Dp + Dp + k] = b;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < GT * GT; i += 256) {
      const int rl = i >> 7, kl = i & (GT - 1);
      const int r = t.col0 + rl, k = t.row0 + kl;
      if (r < R && k < d) dx[(size_t)r * d + k] = xt[rl * LD + kl];
    }
  }
};

// 4., 5. partial products, one (., ld) plane a slab
struct PartEpi {
  float* out;
  int ld;
  size_t slab;

  __device__ PartEpi seed(size_t zb) const { return {bump(out, zb), ld, slab}; }

  __device__ void operator()(float (&acc)[2][32], float*, const Tile& t) const {
    float* o = out + t.slab * slab + (size_t)t.row0 * ld + t.col0;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        *reinterpret_cast<float2*>(o + (size_t)acc_row(i) * ld + acc_col(nt, i)) =
            make_float2(acc[nt][i], acc[nt][i + 1]);
  }
};

// prep, one warp a row of x: xs = x o inv_ls in three bf16 parts, (Rp, Dp)
// each, and |xs|^2; zeros past R and d.  dvp (if not null): dvar padded
// with zeros to Rp.  xw (if not null, the forward's): x . mean_w a row.
__global__ void __launch_bounds__(256)
prep_x_kernel(const float* __restrict__ x, const float* __restrict__ inv_ls,
              const float* __restrict__ dvar, const float* __restrict__ mean_w,
              bf16* __restrict__ xp, float* __restrict__ x2,
              float* __restrict__ dvp, float* __restrict__ xw, int R, int d,
              int Rp, int Dp, size_t zb) {
  const size_t zoff = blockIdx.z * zb;
  x = seed_at(x, (size_t)R * d);
  inv_ls = seed_at(inv_ls, d);
  dvar = seed_at(dvar, R);
  mean_w = seed_at(mean_w, d);
  xp = bump(xp, zoff);
  x2 = bump(x2, zoff);
  dvp = bump(dvp, zoff);
  xw = bump(xw, zoff);
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= Rp) return;
  const size_t plane = (size_t)Rp * Dp;
  float s = 0.f, sw = 0.f;
  for (int k = 2 * lane; k < Dp; k += 64) {
    bf16 p[2][PARTS];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = r < R && k + e < d;
      const float raw = ok ? x[(size_t)r * d + k + e] : 0.f;
      const float v = ok ? raw * inv_ls[k + e] : 0.f;
      s = fmaf(v, v, s);
      if (xw != nullptr && ok) sw = fmaf(raw, mean_w[k + e], sw);
      split(v, p[e]);
    }
#pragma unroll
    for (int i = 0; i < PARTS; ++i)
      *reinterpret_cast<__nv_bfloat162*>(xp + i * plane + (size_t)r * Dp + k) =
          __halves2bfloat162(p[0][i], p[1][i]);
  }
  s = warp_sum(s);
  if (xw != nullptr) sw = warp_sum(sw);
  if (lane == 0) {
    x2[r] = s;
    if (dvp != nullptr) dvp[r] = r < R ? dvar[r] : 0.f;
    if (xw != nullptr) xw[r] = sw;
  }
}

// prep, one block an inducing point m < Mp: zs in three bf16 parts (Mp, Dp)
// and (if ztp is not null) transposed (Dp, Mp), |zs|^2, and (if wp is not
// null) row m of W^T in WP bf16 parts (Mp, Mp) each; zeros past M and d
template <int WP>
__global__ void __launch_bounds__(256)
prep_z_kernel(const float* __restrict__ zs, const float* __restrict__ w,
              bf16* __restrict__ zp, bf16* __restrict__ ztp,
              float* __restrict__ z2, bf16* __restrict__ wp, int M, int d,
              int Mp, int Dp, size_t zb) {
  const size_t zoff = blockIdx.z * zb;
  zs = seed_at(zs, (size_t)M * d);
  w = seed_at(w, (size_t)M * M);
  zp = bump(zp, zoff);
  ztp = bump(ztp, zoff);
  z2 = bump(z2, zoff);
  wp = bump(wp, zoff);
  __shared__ float red[8];
  const int m = blockIdx.x;
  const size_t plane = (size_t)Mp * Dp;
  float s = 0.f;
  for (int k = threadIdx.x; k < Dp; k += 256) {
    const float v = (m < M && k < d) ? zs[(size_t)m * d + k] : 0.f;
    s = fmaf(v, v, s);
    bf16 p[PARTS];
    split(v, p);
#pragma unroll
    for (int i = 0; i < PARTS; ++i) zp[i * plane + (size_t)m * Dp + k] = p[i];
    if (ztp != nullptr) {
#pragma unroll
      for (int i = 0; i < PARTS; ++i) ztp[i * plane + (size_t)k * Mp + m] = p[i];
    }
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) z2[m] = s;
  if (wp == nullptr) return;
  const size_t wplane = (size_t)Mp * Mp;
  for (int k = threadIdx.x; k < Mp; k += 256) {
    bf16 p[WP];
    split((m < M && k < M) ? w[(size_t)k * M + m] : 0.f, p);
#pragma unroll
    for (int i = 0; i < WP; ++i) wp[i * wplane + (size_t)m * Mp + k] = p[i];
  }
}

// sum of v over the block's threads in a fixed order; every thread gets it
__device__ double block_sum_f64(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// fixed-order sums of every partial, in float64 (so that a sum over all
// the rows, such as dmean_b, carries no more rounding than its result's):
// blocks 0..M-1 own inducing point m (du, dzs row, dW row, and colsum(E)[m]
// into cem[m]); blocks M.. one scalar output each (sum(dvar) into cem[Mp],
// for dos_kernel).  sym: only pw's tiles on and above the diagonal were
// computed, the others are read transposed.
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part_du, const float* __restrict__ part_ce,
              const float* __restrict__ pz, const float* __restrict__ pw,
              const float* __restrict__ part_dx, const float* __restrict__ zs,
              const float* __restrict__ dmean, const float* __restrict__ dvar,
              float* __restrict__ dzs, float* __restrict__ du,
              float* __restrict__ dw, float* __restrict__ dinv_ls,
              float* __restrict__ dmean_w, float* __restrict__ dmean_b,
              double* __restrict__ cem, int R, int d, int M, int Mp, int Dp,
              int r_tiles, int s_z, int s_w, int sym, size_t zb) {
  const size_t zoff = blockIdx.z * zb, md = (size_t)M * d;
  part_du = bump(part_du, zoff);
  part_ce = bump(part_ce, zoff);
  pz = bump(pz, zoff);
  pw = bump(pw, zoff);
  part_dx = bump(part_dx, zoff);
  cem = bump(cem, zoff);
  zs = seed_at(zs, md);
  dmean = seed_at(dmean, R);
  dvar = seed_at(dvar, R);
  dzs = seed_at(dzs, md);
  du = seed_at(du, M);
  dw = seed_at(dw, (size_t)M * M);
  dinv_ls = seed_at(dinv_ls, d);
  dmean_w = seed_at(dmean_w, d);
  dmean_b = seed_at(dmean_b, 1);
  __shared__ double red[8];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  if (b < M) {
    const int m = b;
    double a = 0.0, c = 0.0;
    for (int t = tid; t < r_tiles; t += 256) {
      a += part_du[(size_t)t * Mp + m];
      c += part_ce[(size_t)t * Mp + m];
    }
    a = block_sum_f64(a, red);
    c = block_sum_f64(c, red);  // colsum(E)[m]
    if (tid == 0) {
      du[m] = (float)a;
      cem[m] = c;
    }
    for (int k = tid; k < d; k += 256) {
      double e = 0.0;
      for (int s = 0; s < s_z; ++s) e += pz[((size_t)s * Mp + m) * Dp + k];
      dzs[(size_t)m * d + k] = (float)(e - c * zs[(size_t)m * d + k]);
    }
    for (int n = tid; n < M; n += 256) {
      const bool upper = !sym || m / GT <= n / GT;
      const size_t at = upper ? (size_t)m * Mp + n : (size_t)n * Mp + m;
      double e = 0.0;
      for (int s = 0; s < s_w; ++s) e += pw[(size_t)s * Mp * Mp + at];
      dw[(size_t)m * M + n] = (float)-e;
    }
    return;
  }
  const int q = b - M;
  double a = 0.0;
  if (q < 2 * d) {
    const int col = q < d ? q : Dp + q - d;
    for (int t = tid; t < r_tiles; t += 256) a += part_dx[(size_t)t * 2 * Dp + col];
  } else if (q == 2 * d) {
    for (int r = tid; r < R; r += 256) a += dvar[r];
  } else {
    for (int r = tid; r < R; r += 256) a += dmean[r];
  }
  a = block_sum_f64(a, red);
  if (tid != 0) return;
  if (q < d) dinv_ls[q] = (float)a;
  else if (q < 2 * d) dmean_w[q - d] = (float)a;
  else if (q == 2 * d) cem[Mp] = a;
  else *dmean_b = (float)a;
}

// dos = sum(E) / os + sum(dvar), from reduce_kernel's colsum(E)[m] and
// sum(dvar) in cem; one block
__global__ void __launch_bounds__(256)
dos_kernel(const double* __restrict__ cem, const float* __restrict__ os_ptr,
           float* __restrict__ dos, int M, int Mp, size_t zb) {
  cem = bump(cem, blockIdx.z * zb);
  os_ptr = seed_at(os_ptr, 1);
  dos = seed_at(dos, 1);
  __shared__ double red[8];
  double a = 0.0;
  for (int m = threadIdx.x; m < M; m += 256) a += cem[m];
  a = block_sum_f64(a, red);
  if (threadIdx.x == 0) *dos = (float)(a / *os_ptr + cem[Mp]);
}

// the forward's last pass, a thread a row: mean = x . mean_w (prep_x's) +
// mean_b + the K u partials, var = os - the (G o K) partials, each summed
// over the inducing-point ranges in order
__global__ void __launch_bounds__(256)
fwd_finish_kernel(const float* __restrict__ xw, const float* __restrict__ mean_b,
                  const float* __restrict__ os_ptr,
                  const float* __restrict__ part_mu, const float* __restrict__ part_v,
                  float* __restrict__ mean, float* __restrict__ var, int R,
                  int Rp, int m_tiles, size_t zb) {
  const size_t zoff = blockIdx.z * zb;
  xw = bump(xw, zoff);
  part_mu = bump(part_mu, zoff);
  part_v = bump(part_v, zoff);
  mean_b = seed_at(mean_b, 1);
  os_ptr = seed_at(os_ptr, 1);
  mean = seed_at(mean, R);
  var = seed_at(var, R);
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= R) return;
  const float s = xw[r];
  float mu = 0.f, v = 0.f;
  for (int t = 0; t < m_tiles; ++t) {
    mu += part_mu[(size_t)t * Rp + r];
    v += part_v[(size_t)t * Rp + r];
  }
  mean[r] = s + *mean_b + mu;
  var[r] = *os_ptr - v;
}

__host__ inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// scratch arrays of one call, as byte offsets from its base (each 256-byte
// aligned)
struct Arena {
  size_t total = 0;
  size_t take(size_t bytes) {
    const size_t at = total;
    total += (bytes + 255) / 256 * 256;
    return at;
  }
};

// the backward's scratch.  Dp: d padded to whole output tiles (E zs and
// E^T xs have tiles along d); Dk: d padded to the stage (the cross term sums
// over it)
struct Plan {
  int Rp, Mp, Dp, Dk, r_tiles, s_z, k_z, s_w, k_w;
  size_t xp, x2, dvp, zp, ztp, z2, wp, kh, kf, dvk, e, part_du, part_ce,
      part_re, part_dx, pz, pw, cem, total;
};

// slabs of the summed rows so that `tiles` output tiles make about one wave
__host__ inline void slabs(int Rp, int tiles, int& s, int& k_len) {
  s = 132 / tiles;
  if (s < 1) s = 1;
  if (s > Rp / GKC) s = Rp / GKC;
  k_len = round_up((Rp + s - 1) / s, GKC);
  s = (Rp + k_len - 1) / k_len;
}

// f32: the fp32 backward (W^T, K and E split into three parts, dW
// symmetric), else the bf16 one
__host__ inline Plan plan(int R, int d, int M, bool f32) {
  Plan p;
  p.Rp = round_up(R, GT);
  p.Mp = round_up(M, GT);
  p.Dp = round_up(d, GT);
  p.Dk = round_up(d, GKC);
  p.r_tiles = p.Rp / GT;
  const int mt = p.Mp / GT;
  slabs(p.Rp, mt * (p.Dp / GT), p.s_z, p.k_z);
  slabs(p.Rp, f32 ? mt * (mt + 1) / 2 : mt * mt, p.s_w, p.k_w);
  Arena a;
  const size_t rd = (size_t)p.Rp * p.Dp, md = (size_t)p.Mp * p.Dp,
               mr = (size_t)p.Mp * p.Rp;
  p.xp = a.take(PARTS * rd * 2); p.x2 = a.take((size_t)p.Rp * 4);
  p.dvp = a.take(f32 ? (size_t)p.Rp * 4 : 0);
  p.zp = a.take(PARTS * md * 2); p.ztp = a.take(PARTS * md * 2);
  p.z2 = a.take((size_t)p.Mp * 4);
  p.wp = a.take((f32 ? PARTS : 1) * (size_t)p.Mp * p.Mp * 2);
  p.kh = a.take(f32 ? 0 : mr * 2); p.kf = a.take(mr * 4);
  p.dvk = a.take(f32 ? 0 : mr * 2);
  p.e = a.take(f32 ? mr * 4 : PARTS * mr * 2);
  p.part_du = a.take((size_t)p.r_tiles * p.Mp * 4);
  p.part_ce = a.take((size_t)p.r_tiles * p.Mp * 4);
  p.part_re = a.take((size_t)mt * p.Rp * 4);
  p.part_dx = a.take((size_t)p.r_tiles * 2 * p.Dp * 4);
  p.pz = a.take((size_t)p.s_z * md * 4);
  p.pw = a.take((size_t)p.s_w * p.Mp * p.Mp * 4);
  p.cem = a.take(((size_t)p.Mp + 1) * 8);
  p.total = a.total;
  return p;
}

// the forward's scratch; kw16 (the bf16 forward): W^T in bf16 besides
struct FwdPlan {
  int Rp, Mp, Dk;
  size_t xp, x2, xw, zp, z2, wp, kf, part_mu, part_v, total;
};

__host__ inline FwdPlan fwd_plan(int R, int d, int M, bool kw16) {
  FwdPlan p;
  p.Rp = round_up(R, GT);
  p.Mp = round_up(M, GT);
  p.Dk = round_up(d, GKC);
  const size_t mr = (size_t)p.Mp * p.Rp;
  Arena a;
  p.xp = a.take(PARTS * (size_t)p.Rp * p.Dk * 2); p.x2 = a.take((size_t)p.Rp * 4);
  p.xw = a.take((size_t)p.Rp * 4);
  p.zp = a.take(PARTS * (size_t)p.Mp * p.Dk * 2); p.z2 = a.take((size_t)p.Mp * 4);
  p.wp = a.take(kw16 ? (size_t)p.Mp * p.Mp * 2 : 0);
  p.kf = a.take(mr * 4);
  p.part_mu = a.take((size_t)(p.Mp / GT) * p.Rp * 4);
  p.part_v = a.take((size_t)(p.Mp / GT) * p.Rp * 4);
  p.total = a.total;
  return p;
}

// the tiles of `row_tiles` x `col_tiles` (SYM: those on and above the
// diagonal of row_tiles x row_tiles), `slabs` deep, as gemm_kernel places
// them, for each of the `sd` seeds (`sd.n` along z)
struct SeedGrid {
  int n;      // seeds
  size_t zb;  // bytes of one seed's scratch
};

template <int P, bool B_MN, int SUM, bool SYM = false, int NT = 2,
          int MINB = 1, class OA, class OB, class Epi>
__host__ int gemm(int row_tiles, int col_tiles, int slabs, OA A, OB B,
                  int k_len, int k_total, const Epi& epi, SeedGrid sd,
                  cudaStream_t st) {
  if (MINB == 2 && P != 1 && k_total > GKC) return (int)cudaErrorInvalidValue;
  constexpr int smem = MINB == 2 && P != 1 ? stage_bytes<P>() + 1024 : gemm_smem<P>();
  auto kernel = gemm_kernel<P, B_MN, SUM, Epi, SYM, OA, OB, NT, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = SYM ? row_tiles * (row_tiles + 1) / 2 : row_tiles * col_tiles;
  kernel<<<dim3(tiles, slabs, sd.n), 256, smem, st>>>(A, B, row_tiles, k_len,
                                                      k_total, epi, sd.zb);
  return (int)cudaGetLastError();
}

// P planes of bf16 parts, `plane` elements apart, rows of ld
__host__ inline Operand parts(unsigned char* base, size_t off, size_t plane,
                              int n, int ld) {
  Operand o{{nullptr, nullptr, nullptr}, ld};
  for (int i = 0; i < n; ++i)
    o.part[i] = reinterpret_cast<bf16*>(base + off) + i * plane;
  return o;
}

__host__ int launch_fwd(const float* x, const float* zs, const float* u,
                        const float* w, const float* os, const float* inv_ls,
                        const float* mean_w, const float* mean_b, float* mean,
                        float* var, void* scratch, int R, int d, int M,
                        int S, bool kw16, cudaStream_t st) {
  const FwdPlan p = fwd_plan(R, d, M, kw16);
  const SeedGrid sd{S, p.total};
  unsigned char* base = static_cast<unsigned char*>(scratch);
  auto f32 = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  auto b16 = [&](size_t off) { return reinterpret_cast<bf16*>(base + off); };
  const int mt = p.Mp / GT, rt = p.Rp / GT;
  int err;
  prep_x_kernel<<<dim3((p.Rp + 7) / 8, 1, S), 256, 0, st>>>(
      x, inv_ls, nullptr, mean_w, b16(p.xp), f32(p.x2), nullptr, f32(p.xw), R,
      d, p.Rp, p.Dk, sd.zb);
  if ((err = (int)cudaGetLastError())) return err;
  if (kw16)  // and W^T in bf16
    prep_z_kernel<1><<<dim3(p.Mp, 1, S), 256, 0, st>>>(
        zs, w, b16(p.zp), nullptr, f32(p.z2), b16(p.wp), M, d, p.Mp, p.Dk, sd.zb);
  else
    prep_z_kernel<PARTS><<<dim3(p.Mp, 1, S), 256, 0, st>>>(
        zs, w, b16(p.zp), nullptr, f32(p.z2), nullptr, M, d, p.Mp, p.Dk, sd.zb);
  if ((err = (int)cudaGetLastError())) return err;
  // 1. K^T, and the partial K u (a sum of one stage at d <= 64: two blocks
  // an SM, whose loads and epilogues overlap)
  const Operand zsp = parts(base, p.zp, (size_t)p.Mp * p.Dk, PARTS, p.Dk);
  const Operand xs = parts(base, p.xp, (size_t)p.Rp * p.Dk, PARTS, p.Dk);
  const FwdKEpi kepi{f32(p.x2), f32(p.z2), os, u, f32(p.kf), f32(p.part_mu),
                     M, R, p.Rp};
  err = p.Dk <= GKC
            ? gemm<PARTS, false, 0, false, 2, 2>(mt, rt, 1, zsp, xs, p.Dk, p.Dk,
                                                 kepi, sd, st)
            : gemm<PARTS, false, SUM_F32>(mt, rt, 1, zsp, xs, p.Dk, p.Dk, kepi,
                                          sd, st);
  if (err) return err;
  // 2. the partial (K W o K) sums.  bf16: G^T = W^T K^T on the tensor
  // cores, K rounded to bf16 on its way into shared memory; up to M 512 one
  // tensor-core sum at two blocks an SM, beyond it sums of 64 inducing
  // points added in fp32 (512-point sums put M 2048's variance 2.9 times
  // as far from the bf16 function in float64 as the plain version, past
  // the card test's budget of 2).
  // fp32: K W on FFMA in the plain version's order
  if (kw16) {
    const Operand wt = parts(base, p.wp, 0, 1, p.Mp);
    const F32Operand kt{f32(p.kf), nullptr, p.Rp};
    const VarEpi ve{f32(p.kf), f32(p.part_v), p.Rp};
    err = p.Mp <= 512
              ? gemm<1, true, 0, false, 2, 2>(mt, rt, 1, wt, kt, p.Mp, p.Mp, ve,
                                              sd, st)
              : gemm<1, true, SUM_F32>(mt, rt, 1, wt, kt, p.Mp, p.Mp, ve, sd, st);
    if (err) return err;
  } else {
    kw_var_kernel<<<dim3(mt, rt, S), 256, 0, st>>>(w, f32(p.kf), f32(p.part_v),
                                                   M, p.Rp, sd.zb);
    if ((err = (int)cudaGetLastError())) return err;
  }
  fwd_finish_kernel<<<dim3((R + 255) / 256, 1, S), 256, 0, st>>>(
      f32(p.xw), mean_b, os, f32(p.part_mu), f32(p.part_v), mean, var, R,
      p.Rp, mt, sd.zb);
  return (int)cudaGetLastError();
}

__host__ int launch_bwd(const float* x, const float* zs, const float* u,
                        const float* w, const float* os, const float* inv_ls,
                        const float* mean_w, const float* dmean,
                        const float* dvar, float* dx, float* dzs, float* du,
                        float* dw, float* dos, float* dinv_ls, float* dmean_w,
                        float* dmean_b, void* scratch, int R, int d, int M,
                        int S, bool f32, cudaStream_t st) {
  const Plan p = plan(R, d, M, f32);
  const SeedGrid sd{S, p.total};
  unsigned char* base = static_cast<unsigned char*>(scratch);
  auto b16 = [&](size_t off) { return reinterpret_cast<bf16*>(base + off); };
  auto fp = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  const int mt = p.Mp / GT, rt = p.r_tiles, dt = p.Dp / GT;
  int err;

  prep_x_kernel<<<dim3((p.Rp + 7) / 8, 1, S), 256, 0, st>>>(
      x, inv_ls, dvar, nullptr, b16(p.xp), fp(p.x2), f32 ? fp(p.dvp) : nullptr,
      nullptr, R, d, p.Rp, p.Dp, sd.zb);
  if ((err = (int)cudaGetLastError())) return err;
  if (f32)
    prep_z_kernel<PARTS><<<dim3(p.Mp, 1, S), 256, 0, st>>>(
        zs, w, b16(p.zp), b16(p.ztp), fp(p.z2), b16(p.wp), M, d, p.Mp, p.Dp, sd.zb);
  else
    prep_z_kernel<1><<<dim3(p.Mp, 1, S), 256, 0, st>>>(
        zs, w, b16(p.zp), b16(p.ztp), fp(p.z2), b16(p.wp), M, d, p.Mp, p.Dp, sd.zb);
  if ((err = (int)cudaGetLastError())) return err;

  const size_t rd = (size_t)p.Rp * p.Dp, md = (size_t)p.Mp * p.Dp,
               mr = (size_t)p.Mp * p.Rp;
  const Operand xs = parts(base, p.xp, rd, PARTS, p.Dp);
  const Operand zsp = parts(base, p.zp, md, PARTS, p.Dp);
  const Operand zst = parts(base, p.ztp, md, PARTS, p.Mp);
  // 1. K^T: the distance's cross term in three parts, six products (fp32:
  // summed 64 columns at a time; at d <= 64 a sum of one stage, two blocks
  // an SM)
  const KEpi kepi{fp(p.x2), fp(p.z2), os, dmean, dvar,
                  f32 ? nullptr : b16(p.kh), f32 ? nullptr : b16(p.dvk),
                  fp(p.kf), fp(p.part_du), M, R, p.Mp, p.Rp};
  if (!f32)
    err = gemm<PARTS, false, 0>(mt, rt, 1, zsp, xs, p.Dp, p.Dk, kepi, sd, st);
  else if (p.Dk <= GKC)
    err = gemm<PARTS, false, 0, false, 2, 2>(mt, rt, 1, zsp, xs, p.Dp, p.Dk, kepi,
                                             sd, st);
  else
    err = gemm<PARTS, false, SUM_F32>(mt, rt, 1, zsp, xs, p.Dp, p.Dk, kepi, sd,
                                      st);
  if (err) return err;
  const DxEpi dxe{x, inv_ls, mean_w, dmean, fp(p.part_re), dx, fp(p.part_dx),
                  R, d, p.Dp, p.Rp, mt};
  if (f32) {
    const F32Operand kt{fp(p.kf), nullptr, p.Rp}, et{fp(p.e), nullptr, p.Rp};
    // 2. G^T = W^T K^T, both in three parts (K split on load), E^T in the
    // epilogue
    err = gemm<PARTS, true, SUM_F32>(
        mt, rt, 1, parts(base, p.wp, (size_t)p.Mp * p.Mp, PARTS, p.Mp), kt,
        p.Mp, p.Mp,
        EEpi{fp(p.kf), u, dmean, dvar, nullptr, fp(p.e), fp(p.part_ce),
             fp(p.part_re), M, R, p.Mp, p.Rp}, sd, st);
    if (err) return err;
    // 3. (E zs)^T, E split on load, dx in the epilogue
    err = gemm<PARTS, true, 1>(dt, rt, 1, zst, et, p.Mp, p.Mp, dxe, sd, st);
    if (err) return err;
    // 4. E^T xs over slabs, E split on load; at d <= 64 the tile's second
    // 64 columns are padding
    const PartEpi pze{fp(p.pz), p.Dp, md};
    err = d <= 64 ? gemm<PARTS, true, 1, false, 1>(mt, dt, p.s_z, et, xs, p.k_z,
                                                   p.Rp, pze, sd, st)
                  : gemm<PARTS, true, 1>(mt, dt, p.s_z, et, xs, p.k_z, p.Rp,
                                         pze, sd, st);
    if (err) return err;
    // 5. K^T (dvar o K) over slabs, both split from K on load, the tiles
    // on and above the diagonal
    err = gemm<PARTS, false, SUM_F32, true>(
        mt, mt, p.s_w, kt, F32Operand{fp(p.kf), fp(p.dvp), p.Rp}, p.k_w, p.Rp,
        PartEpi{fp(p.pw), p.Mp, (size_t)p.Mp * p.Mp}, sd, st);
    if (err) return err;
  } else {
    const Operand kt = parts(base, p.kh, 0, 1, p.Rp);
    const Operand et = parts(base, p.e, mr, PARTS, p.Rp);
    // 2. G^T = W^T K^T in bf16 (sums over 512 inducing points at a time),
    // E^T in the epilogue
    err = gemm<1, true, SUM_KW_BF16>(mt, rt, 1, parts(base, p.wp, 0, 1, p.Mp), kt,
                                p.Mp, p.Mp,
                                EEpi{fp(p.kf), u, dmean, dvar, b16(p.e),
                                     nullptr, fp(p.part_ce), fp(p.part_re),
                                     M, R, p.Mp, p.Rp}, sd, st);
    if (err) return err;
    // 3. (E zs)^T in three parts (sums over 16 at a time), dx in the epilogue
    err = gemm<PARTS, true, 1>(dt, rt, 1, zst, et, p.Mp, p.Mp, dxe, sd, st);
    if (err) return err;
    // 4. E^T xs in three parts (sums over 16 rows at a time), over slabs
    err = gemm<PARTS, true, 1>(mt, dt, p.s_z, et, xs, p.k_z, p.Rp,
                               PartEpi{fp(p.pz), p.Dp, md}, sd, st);
    if (err) return err;
    // 5. K^T (dvar o K) in bf16, over slabs of rows
    err = gemm<1, false, 0>(mt, mt, p.s_w, kt, parts(base, p.dvk, 0, 1, p.Rp),
                            p.k_w, p.Rp,
                            PartEpi{fp(p.pw), p.Mp, (size_t)p.Mp * p.Mp}, sd,
                            st);
    if (err) return err;
  }
  double* cem = reinterpret_cast<double*>(base + p.cem);
  reduce_kernel<<<dim3(M + 2 * d + 2, 1, S), 256, 0, st>>>(
      fp(p.part_du), fp(p.part_ce), fp(p.pz), fp(p.pw), fp(p.part_dx), zs,
      dmean, dvar, dzs, du, dw, dinv_ls, dmean_w, dmean_b, cem, R, d,
      M, p.Mp, p.Dp, rt, p.s_z, p.s_w, f32 ? 1 : 0, sd.zb);
  if ((err = (int)cudaGetLastError())) return err;
  dos_kernel<<<dim3(1, 1, S), 256, 0, st>>>(cem, os, dos, M, p.Mp, sd.zb);
  return (int)cudaGetLastError();
}

}  // namespace wgb

}  // namespace

extern "C" {

// Floats of device scratch the two forwards and the two backwards need for
// one seed (the wrapper allocates S times as much for S seeds).
long long fused_gp_fwd_scratch_floats(int R, int d, int M) {
  return (long long)((wgb::fwd_plan(R, d, M, false).total + 3) / 4);
}

long long fused_gp_bf16_fwd_scratch_floats(int R, int d, int M) {
  return (long long)((wgb::fwd_plan(R, d, M, true).total + 3) / 4);
}

long long fused_gp_bwd_scratch_floats(int R, int d, int M) {
  return (long long)((wgb::plan(R, d, M, true).total + 3) / 4);
}

long long fused_gp_bf16_bwd_scratch_floats(int R, int d, int M) {
  return (long long)((wgb::plan(R, d, M, false).total + 3) / 4);
}

// S seeds' whitened-GP marginals, x (S, R, d) raw rows of each seed; zs
// (S, M, d) = Z / lengthscale; u (S, M); w (S, M, M) row-major; os, mean_b
// (S,); inv_ls, mean_w (S, d); mean, var (S, R) outputs; scratch of S times
// fused_gp(_bf16)_fwd_scratch_floats(R, d, M) floats.  bf16 != 0: the K W
// product in bf16 on the tensor cores (w the fp32 (M, M) all the same).
// Five launches on `stream` for every S; seed z's outputs equal a call of
// S = 1 on its inputs bit for bit.  Returns the first failure's
// cudaError_t.
int fused_gp_fwd(const float* x, const float* zs, const float* u, const float* w,
                 const float* os, const float* inv_ls, const float* mean_w,
                 const float* mean_b, float* mean, float* var, float* scratch,
                 int R, int d, int M, int S, int bf16, void* stream) {
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  return wgb::launch_fwd(x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var,
                         scratch, R, d, M, S, bf16 != 0, (cudaStream_t)stream);
}

// The VJP.  Inputs as the forward's, plus dmean, dvar (S, R); outputs dx
// (S, R, d), dzs (S, M, d), du (S, M), dw (S, M, M), dos (S,), dinv_ls
// (S, d), dmean_w (S, d), dmean_b (S,); scratch of S times
// fused_gp(_bf16)_bwd_scratch_floats(R, d, M) floats.  bf16 != 0: K W and
// K^T (dvar o K) in bf16 on the tensor cores.  Nine launches on `stream`
// for every S; returns the first failure.
int fused_gp_bwd(const float* x, const float* zs, const float* u, const float* w,
                 const float* os, const float* inv_ls, const float* mean_w,
                 const float* dmean, const float* dvar, float* dx, float* dzs,
                 float* du, float* dw, float* dos, float* dinv_ls,
                 float* dmean_w, float* dmean_b, float* scratch, int R, int d,
                 int M, int S, int bf16, void* stream) {
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  return wgb::launch_bwd(x, zs, u, w, os, inv_ls, mean_w, dmean, dvar, dx,
                         dzs, du, dw, dos, dinv_ls, dmean_w, dmean_b, scratch,
                         R, d, M, S, bf16 == 0, (cudaStream_t)stream);
}

}  // extern "C"
