// Fused softmax attention at any head dim, forward and backward, bf16 and
// fp32 -- for sm_90a.
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
// the three are of one size, so the scores never reach device memory.
//
// Head dims.  The Pallas program zero-pads d to the 128-lane width and runs
// any d.  Here nothing is padded in device memory: tiles are zero-filled in
// shared memory past d (and past the sequence ends), stores are masked, and
// the scores are scaled by the true 1/sqrt(d).  Which kernels take which d:
//   bf16 at d <= 256 (either softmax): the `wgmma` kernels below, at a
//     padded width DP of 64, 128 or 256;
//   fp32 operands at any d, and bf16 at d > 256: the FFMA kernels further
//     down, which take d in chunks of 64 columns, so every d >= 1 runs.
//
// bf16 design (`wgmma`, Hopper's warpgroup products).  Tiles live in shared
// memory in the 128-byte-swizzled layout that `wgmma` descriptors read:
// DP / 64 slabs of (rows x 128 bytes), the 16-byte chunk c of row r at chunk
// c ^ (r & 7).  They are filled with `cp.async` (16 bytes a thread, zero
// fill past the ends; element by element where d is not a multiple of 8),
// through a ring of stages: the next tiles' copies fly while the current one
// is multiplied.  Every product is m64n64k16 with fp32 accumulators; the
// grids run one head's row blocks side by side, so they share its streamed
// tiles in L2:
//   forward: two warpgroups a block, each owning 64 query rows (128 a
//     block); S = Q K^T reads Q and K from shared memory (K-major),
//     online softmax in exp2 on the accumulators, P rounded to bf16 in
//     registers is the register A operand of P V, and V is read through the
//     transposed (MN-major) descriptor -- the accumulator layout of one
//     product is the A-fragment layout of the next, so P never leaves
//     registers.  Softmax: the row max of the unscaled scores, then one FFMA
//     and one ex2.approx a probability.  For training the forward also
//     writes lse and o_lo (see flash_fwd_wgmma).
//   backward, two launches that each own their outputs (no atomics, so two
//     runs give equal gradients bit for bit):
//     1. query-parallel: D = rowsum(dO o (O + o_lo)) of each row (kept for
//        launch 2),
//        then S = Q K^T and dP = dO V^T (both from shared memory),
//        P = exp2(S - lse) recomputed, dS = P o (dP - D) rounded to bf16 in
//        registers, dQ += dS K (K through the transposed descriptor);
//     2. key-parallel: S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T
//        come out as A fragments; dV += P^T dO and dK += dS^T Q, with the
//        dK / dV accumulators in registers over the whole query loop.  At
//        DP 256 the dK / dV columns are split over two blocks (the grid's
//        third axis), each recomputing S and dP, to keep the accumulators in
//        registers.
//   At DP 256 the backward blocks hold one warpgroup (shared memory).
//
// FFMA design (fp32, and bf16 past 256): 128 threads own a 64 x 64 output tile,
// each thread a 4 x 8 register tile (rows 4 ty.., columns 4 tx.. and
// 32 + 4 tx..).  Products over d stream both operands through shared memory
// 64 columns of d at a time, transposed, so that a thread reads its four
// rows and eight columns as three 16-byte loads per step of d (an operand
// that does not change, such as the forward's Q at d <= 64, stays).  The
// output's columns are the grid's third axis (64 a block), so any d runs; a
// block recomputes the scores for its columns.  Forward: online softmax, P staged
// through shared memory for P V.  Backward: the same two launches as the
// bf16 design.  The sm_bf16 variant (`fused_attention_bf16sm`) subtracts the
// row's max in fp32 and runs the exponential, the sum and the division on
// bf16 values (the sum itself in fp32): p = bf16(bf16(exp(bf16(s - max))) /
// bf16(sum)); what is rounded depends on the row's final max and sum, so its
// forward streams the keys three times (max, sum, then P V) and saves the max
// and the rounded sum in the place of the lse.  Scores are scaled by
// log2(e)/sqrt(d) so the exponentials are base 2; lse is natural-log outside
// the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sm_bf16: exp of a max-subtracted score on bf16 values
__device__ __forceinline__ float exp_bf16(float s_minus_max) {
  return round_bf16(expf(round_bf16(s_minus_max)));
}

// 2^x on the special-function unit alone (x <= 0 here; a result below
// 2^-126 flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The probability of a score s2 (scaled by log2(e)/sqrt(d)) from its row's
// saved statistics.  SM16 false: st0 = lse * log2(e).  SM16 true: st0 = the
// row's max in natural units, st1 = its bf16-rounded sum.
template <bool SM16>
__device__ __forceinline__ float prob(float s2, float st0, float st1) {
  if constexpr (SM16) return round_bf16(exp_bf16(s2 * LN2 - st0) / st1);
  return ex2(s2 - st0);
}

// a row's statistics from the buffer the forward wrote: (BH, Lq) lse, or
// (2, BH, Lq) max and sum.  Rows past the end get st0 = +inf (no mass).
template <bool SM16>
__device__ __forceinline__ void load_stats(const float* __restrict__ stats,
                                           size_t at, size_t plane, bool ok,
                                           float& st0, float& st1) {
  st0 = ok ? (SM16 ? stats[at] : stats[at] * LOG2E) : INFINITY;
  st1 = (SM16 && ok) ? stats[plane + at] : 1.f;
}

// over the `width` neighbouring lanes that share a row
template <int WIDTH>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 1; off < WIDTH; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int WIDTH>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 1; off < WIDTH; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <class T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// ======================================================= bf16: wgmma ====

constexpr int WG = 128;    // threads of a warpgroup
constexpr int TILE = 64;   // rows of a tile: queries or keys
constexpr int ROW_BYTES = 128;  // one swizzled row of a slab: 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// let `kernel` use `bytes` of dynamic shared memory
template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Grids run the row blocks of one (batch, head) next to each other
// (blockIdx.x = bh * blocks + block), so that they stream its K and V (or Q
// and dO) while these sit in L2: with bh on the fast axis, a head's blocks
// would be a wave apart and its tiles read again from device memory.
struct Place {
  size_t bh;
  int blk, heads;
};
__device__ __forceinline__ Place place(int rows, int per_block) {
  const int blocks = (rows + per_block - 1) / per_block;
  const int bh = blockIdx.x / blocks;
  return {(size_t)bh, (int)blockIdx.x - bh * blocks, (int)gridDim.x / blocks};
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Descriptor of a 128-byte-swizzled operand whose 8-row groups lie 1024
// bytes apart.  The leading offset is 1024 as well: for the K-major
// operands it is not read (a k16 step stays inside a swizzled row), and for
// the MN-major ones (N = 64, one swizzle atom wide) it is the step between
// 8-row groups along K.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait0() { wg_wait<0>(); }
// the accumulators are not touched by ordinary code while a product is in
// flight: pin them around the wait
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A fragments that a product in flight still reads: kept in their
// registers until the wait that follows
__device__ __forceinline__ void keep(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(a[i][e]) : "memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16) * B (16 x 64), both from shared
// memory, K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers: warp w of
// the warpgroup holds rows 16 w.., in the mma.m16n8k16 A layout) * B (16 x
// 64 from shared memory, MN-major: the rows of a tile read across)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// ordinary and cp.async writes of shared memory made visible to `wgmma`
// (the async proxy); a barrier follows
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [0, n) of the (., d) bf16 matrix at src into the swizzled tile at
// dst (ROWS rows, DP columns: DP / 64 slabs of ROWS x 128 bytes), zeros past
// n rows and d columns.  vec (d % 8 == 0, 16-byte aligned rows): cp.async,
// 16 bytes a thread; else element by element.  NT threads take part.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const bf16* __restrict__ src, int n,
                                          int d, bool vec) {
  constexpr int CHUNKS = DP / 8;
  const uint32_t base = smem_u32(dst);
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NT) {
    const int r = i / CHUNKS;
    const int c = i - r * CHUNKS;
    const uint32_t off = (c >> 3) * (ROWS * ROW_BYTES) + r * ROW_BYTES +
                         (((c & 7) ^ (r & 7)) << 4);
    const int col = c * 8;
    if (vec) {
      const bool ok = r < n && col < d;
      const bf16* g = ok ? src + (size_t)r * d + col : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       base + off),
                   "l"(g), "r"(ok ? 16 : 0)
                   : "memory");
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = col + 2 * e;
        const uint32_t lo = (r < n && c0 < d)
            ? __bfloat16_as_ushort(src[(size_t)r * d + c0]) : 0u;
        const uint32_t hi = (r < n && c0 + 1 < d)
            ? __bfloat16_as_ushort(src[(size_t)r * d + c0 + 1]) : 0u;
        w[e] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(base + off),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// K-major descriptor of the k16 step kk of the 64-row tile at `tile`
// (shared address) inside a tile of `rows` rows: slab kk / 4, 32 bytes a
// step inside the swizzled row
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int rows, int kk) {
  return desc(tile + (kk >> 2) * (rows * ROW_BYTES) + (kk & 3) * 32);
}

// MN-major descriptor of rows 16 kk.. and columns 64 nt.. of a tile of
// `rows` rows
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int rows, int nt,
                                           int kk) {
  return desc(tile + nt * (rows * ROW_BYTES) + kk * 16 * ROW_BYTES);
}

// An accumulator element i of a 64 x 64 product: row (in the warpgroup's
// 64) 16 warp + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t + (i & 1).
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

// the 16 columns 16 kk.. of an accumulator as a bf16 A fragment
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&s)[32],
                                       int kk) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// the low parts of the same 16 columns: bf16(s - hi), hi the A fragment
// a_frag made of them
__device__ __forceinline__ void lo_frag(uint32_t (&lo)[4], const uint32_t (&hi)[4],
                                        const float (&s)[32], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    lo[r] = pack_bf16(s[8 * kk + 2 * r] - __uint_as_float(hi[r] << 16),
                      s[8 * kk + 2 * r + 1] - __uint_as_float(hi[r] & 0xffff0000u));
}

// store the accumulators acc[nt] (columns c0 + 64 nt..) of the warpgroup's
// 64 rows from row r0 (global rows r0 + ..., valid below L) of a (., d) bf16
// matrix, times `mul`
template <int NT>
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst,
                                          const float (&acc)[NT][32], int r0,
                                          int L, int d, int c0, float mul_a,
                                          float mul_b) {
  const int t = threadIdx.x & 3;
  const int g = (threadIdx.x & 31) >> 2;
  const int w = (threadIdx.x & 127) >> 5;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r0 + 16 * w + g + 8 * ((i >> 1) & 1);
      const int col = c0 + 64 * nt + acc_col(i, t);
      const float mul = ((i >> 1) & 1) ? mul_b : mul_a;
      if (row >= L || col >= d) continue;
      bf16* p = dst + (size_t)row * d + col;
      if ((d & 1) == 0) {
        *reinterpret_cast<uint32_t*>(p) =
            pack_bf16(acc[nt][i] * mul, acc[nt][i + 1] * mul);
      } else {
        p[0] = __float2bfloat16_rn(acc[nt][i] * mul);
        if (col + 1 < d) p[1] = __float2bfloat16_rn(acc[nt][i + 1] * mul);
      }
    }
}

// stages of the ring of streamed tiles: three where shared memory allows
template <int DP>
__host__ __device__ constexpr int ring() { return DP <= 128 ? 3 : 2; }

template <int DP>
__host__ __device__ constexpr int smem_fwd_wg() {  // Q (128 rows), the K, V ring
  return 2 * TILE * DP * 2 + ring<DP>() * 2 * TILE * DP * 2 + 1024;
}

// Each loop below runs a ring of stages of streamed tiles: tile j + stages
// - 1 is requested at the top of iteration j, after the one barrier of the
// iteration (so the stage it overwrites, tile j - 1's, is no longer read),
// and tile j's copies are awaited just before it.
// LO (training: lse wanted): the forward also writes o_lo, the rounding
// residual of the output against the same product with P unrounded,
// bf16(P~ V / l - o), from a second accumulator fed the low bf16 part of P.
// The backward's D = rowsum(dO o (o + o_lo)) is then the reference's
// rowsum(dP o P) to fp32 accuracy; from o alone it would carry the rounding
// of P and of o.  At DP 256 the LO blocks split the output columns in two
// (the grid's third axis) to keep both accumulators in registers.  SM16:
// the sm_bf16 softmax, whose probabilities are bf16 values already; it
// takes three passes over the keys (the row's max, the sum of the rounded
// exponentials, then P V with the final p), saves the max and the rounded
// sum in the place of the lse, and its o_lo is the output's own rounding
// residual (no second product: LO2 below).
template <int DP, bool LO2>
__host__ __device__ constexpr int fwd_dv() { return LO2 && DP == 256 ? 128 : DP; }

// Two blocks an SM at DP 64 (registers capped at 128 a thread), with or
// without LO, whose tiles are the same, so the output is bit for bit the
// same with and without the training statistics.
template <int DP, bool LO, bool SM16>
__global__ void __launch_bounds__(2 * WG, DP == 64 ? 2 : 1)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                bf16* __restrict__ o_lo, float* __restrict__ lse, int Lq,
                int Lk, int d, float scale_log2, int vec) {
  constexpr bool LO2 = LO && !SM16;      // the second product
  constexpr int PASSES = SM16 ? 3 : 1;
  constexpr int BQ = 2 * TILE;
  constexpr int BC = TILE;               // keys a tile
  constexpr int QBYTES = BQ * DP * 2;
  constexpr int KBYTES = BC * DP * 2;
  constexpr int DV = fwd_dv<DP, LO2>();  // output columns a block
  constexpr int NT = DV / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* qs = sm;
  auto ks = [&](int st) { return sm + QBYTES + st * 2 * KBYTES; };
  auto vs = [&](int st) { return sm + QBYTES + st * 2 * KBYTES + KBYTES; };

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const Place at = place(Lq, BQ);
  const size_t bh = at.bh;
  const int q0 = at.blk * BQ;
  const bf16* kb = k + bh * Lk * d;
  const bf16* vb = v + bh * Lk * d;

  constexpr int S = ring<DP>();
  const int n_tiles = (Lk + BC - 1) / BC;
  const int n_steps = PASSES * n_tiles;  // (pass, key tile) in order
  auto load_kv = [&](int jn) {
    if (jn < n_steps) {
      const int k1 = (SM16 ? jn % n_tiles : jn) * BC;
      load_tile<BC, DP, 2 * WG>(ks(jn % S), kb + (size_t)k1 * d, min(BC, Lk - k1), d, vec);
      if (!SM16 || jn >= (PASSES - 1) * n_tiles)  // V: the last pass's
        load_tile<BC, DP, 2 * WG>(vs(jn % S), vb + (size_t)k1 * d, min(BC, Lk - k1), d, vec);
    }
    cp_commit();
  };
  load_tile<BQ, DP, 2 * WG>(qs, q + (bh * Lq + q0) * d, min(BQ, Lq - q0), d, vec);
  for (int jn = 0; jn < S - 1; ++jn) load_kv(jn);

  float acc[NT][32], acc_lo[LO2 ? NT : 1][32];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nt][i] = acc_lo[LO2 ? nt : 0][i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  const int slab0 = blockIdx.z * NT;     // first 64-column slab of V
  float max_a = -INFINITY, max_b = -INFINITY;  // rows g and g + 8
  float sum_a = 0.f, sum_b = 0.f;              // this lane's share
  float den_a = 1.f, den_b = 1.f;              // SM16: the rounded sums
  const uint32_t q_wg = smem_u32(qs) + wg * TILE * ROW_BYTES;

  for (int step = 0; step < n_steps; ++step) {
    const int st = step % S;
    const int j = SM16 ? step % n_tiles : step;
    const int pass = SM16 ? step / n_tiles : 0;
    cp_wait<S - 2>();
    fence_async_smem();
    __syncthreads();
    load_kv(step + S - 1);

    const uint32_t kt = smem_u32(ks(st));
    const uint32_t vt = smem_u32(vs(st));
    const int n = Lk - j * BC;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(s, kdesc(q_wg, BQ, kk), kdesc(kt, BC, kk), kk > 0);
    wg_commit();
    wg_wait0();
    pin(s);

    uint32_t pa[4][4], pl[LO2 ? 4 : 1][4];
    if constexpr (SM16) {
      const float scale = scale_log2 * LN2;  // natural units
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i >> 1) & 1;
        const bool ok = acc_col(i, t) < n;
        const float sv = s[i] * scale;
        if (pass == 0) {
          if (ok && hi) max_b = fmaxf(max_b, sv);
          if (ok && !hi) max_a = fmaxf(max_a, sv);
        } else {
          const float ev = ok ? exp_bf16(sv - (hi ? max_b : max_a)) : 0.f;
          if (pass == 1) {
            if (hi) sum_b += ev;
            else sum_a += ev;
          } else {
            s[i] = round_bf16(ev / (hi ? den_b : den_a));
          }
        }
      }
      if (j == n_tiles - 1 && pass == 0) {
        max_a = group_max<4>(max_a);
        max_b = group_max<4>(max_b);
      } else if (j == n_tiles - 1 && pass == 1) {
        den_a = round_bf16(group_sum<4>(sum_a));
        den_b = round_bf16(group_sum<4>(sum_b));
      }
      if (pass < PASSES - 1) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag(pa[kk], s, kk);
    } else {
    // scores stay unscaled until the exponential: p = 2^(s c - max c),
    // c = log2(e) / sqrt(d), one FFMA and one special-function op each
    if (n < TILE) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (acc_col(i, t) >= n) s[i] = -INFINITY;
    }
    float mx_a = max_a, mx_b = max_b;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      mx_a = fmaxf(mx_a, fmaxf(s[i], s[i + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[i + 2], s[i + 3]));
    }
    mx_a = group_max<4>(mx_a);  // finite: n >= 1
    mx_b = group_max<4>(mx_b);
    const float corr_a = ex2((max_a - mx_a) * scale_log2);
    const float corr_b = ex2((max_b - mx_b) * scale_log2);
    max_a = mx_a;
    max_b = mx_b;
    sum_a *= corr_a;
    sum_b *= corr_b;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float corr = ((i >> 1) & 1) ? corr_b : corr_a;
        acc[nt][i] *= corr;
        if constexpr (LO2) acc_lo[nt][i] *= corr;
      }
    const float off_a = max_a * scale_log2, off_b = max_b * scale_log2;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i >> 1) & 1) {
        s[i] = ex2(fmaf(s[i], scale_log2, -off_b));
        sum_b += s[i];
      } else {
        s[i] = ex2(fmaf(s[i], scale_log2, -off_a));
        sum_a += s[i];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_frag(pa[kk], s, kk);
      if constexpr (LO2) lo_frag(pl[kk], pa[kk], s, kk);
    }
    }

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        wgmma_rs(acc[nt], pa[kk], mndesc(vt, BC, slab0 + nt, kk));
        if constexpr (LO2) wgmma_rs(acc_lo[nt], pl[kk], mndesc(vt, BC, slab0 + nt, kk));
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      pin(acc[nt]);
      if constexpr (LO2) pin(acc_lo[nt]);
    }
  }

  if (!SM16) {
    sum_a = group_sum<4>(sum_a);
    sum_b = group_sum<4>(sum_b);
  }
  const int r0 = q0 + wg * TILE;
  const float inv_a = SM16 ? 1.f : 1.f / sum_a, inv_b = SM16 ? 1.f : 1.f / sum_b;
  store_acc<NT>(o + bh * Lq * d, acc, r0, Lq, d, blockIdx.z * DV, inv_a, inv_b);
  if constexpr (LO) {  // o_lo = bf16((acc + acc_lo) / l - bf16(acc / l))
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float inv = ((i >> 1) & 1) ? inv_b : inv_a;
        float exact = acc[nt][i];
        if constexpr (LO2) exact += acc_lo[nt][i];
        acc[nt][i] = exact * inv - round_bf16(acc[nt][i] * inv);
      }
    store_acc<NT>(o_lo + bh * Lq * d, acc, r0, Lq, d, blockIdx.z * DV, 1.f, 1.f);
  }
  if (lse != nullptr && blockIdx.z == 0 && t == 0) {
    const int row = r0 + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
    const size_t plane = (size_t)at.heads * Lq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= Lq) continue;
      const float mx = h ? max_b : max_a;
      if (SM16) {  // the max (natural units) and the rounded sum
        lse[bh * Lq + r] = mx;
        lse[plane + bh * Lq + r] = h ? den_b : den_a;
      } else {
        lse[bh * Lq + r] = (mx * scale_log2 + log2f(h ? sum_b : sum_a)) * LN2;
      }
    }
  }
}

// warpgroups of a backward block: one at DP 256 (shared memory)
template <int DP>
__host__ __device__ constexpr int bwd_wgs() { return DP <= 128 ? 2 : 1; }
// dK / dV columns a backward block owns
template <int DP>
__host__ __device__ constexpr int bwd_dv() { return DP <= 128 ? DP : 128; }

template <int DP>
__host__ __device__ constexpr int smem_dq_wg() {  // Q, dO (64 NWG rows), the K, V ring
  return 2 * TILE * bwd_wgs<DP>() * DP * 2 + ring<DP>() * 2 * TILE * DP * 2 +
         TILE * bwd_wgs<DP>() * 4 + 1024;
}

template <int DP>
__host__ __device__ constexpr int smem_dkv_wg() {  // K, V (64 NWG rows), the Q, dO, stats, D ring
  return 2 * TILE * bwd_wgs<DP>() * DP * 2 +
         ring<DP>() * (2 * TILE * DP * 2 + 3 * TILE * 4) + 1024;
}

// Backward launch 1: D = rowsum(dO o O) (to `delta`) and dQ.  stats as
// the forward wrote them (SM16: the max and the rounded sum).
template <int DP, bool SM16>
__global__ void __launch_bounds__(bwd_wgs<DP>() * WG, DP == 64 ? 2 : 1)
flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ o,
                   const bf16* __restrict__ o_lo,
                   const float* __restrict__ lse, const bf16* __restrict__ dout,
                   bf16* __restrict__ dq, float* __restrict__ delta, int Lq,
                   int Lk, int d, float scale_log2, float scale, int vec) {
  constexpr int NWG = bwd_wgs<DP>();
  constexpr int NTH = NWG * WG;
  constexpr int BQ = NWG * TILE;
  constexpr int QBYTES = BQ * DP * 2;
  constexpr int KBYTES = TILE * DP * 2;
  constexpr int NT = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* qs = sm;
  unsigned char* dos = sm + QBYTES;
  auto ks = [&](int st) { return sm + 2 * QBYTES + st * 2 * KBYTES; };
  auto vs = [&](int st) { return sm + 2 * QBYTES + st * 2 * KBYTES + KBYTES; };
  float* ds_row = reinterpret_cast<float*>(sm + 2 * QBYTES + ring<DP>() * 2 * KBYTES);  // [BQ]

  const int wg = threadIdx.x >> 7;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const Place at = place(Lq, BQ);
  const size_t bh = at.bh;
  const int q0 = at.blk * BQ;
  const int nq = min(BQ, Lq - q0);
  const bf16* kb = k + bh * Lk * d;
  const bf16* vb = v + bh * Lk * d;

  constexpr int S = ring<DP>();
  const int n_tiles = (Lk + TILE - 1) / TILE;
  auto load_kv = [&](int jn) {
    if (jn < n_tiles) {
      const int k1 = jn * TILE;
      load_tile<TILE, DP, NTH>(ks(jn % S), kb + (size_t)k1 * d, min(TILE, Lk - k1), d, vec);
      load_tile<TILE, DP, NTH>(vs(jn % S), vb + (size_t)k1 * d, min(TILE, Lk - k1), d, vec);
    }
    cp_commit();
  };
  load_tile<BQ, DP, NTH>(qs, q + (bh * Lq + q0) * d, nq, d, vec);
  load_tile<BQ, DP, NTH>(dos, dout + (bh * Lq + q0) * d, nq, d, vec);
  for (int jn = 0; jn < S - 1; ++jn) load_kv(jn);

  // D = rowsum(dO o (o + o_lo)) of the block's rows (o_lo null: of o):
  // two neighbouring threads a row, every load in flight at once (16 bytes
  // a load where the rows allow)
  {
    static_assert(NTH == 2 * BQ, "two threads a row");
    const int r = threadIdx.x >> 1;
    const int part = threadIdx.x & 1;
    float acc = 0.f;
    if (r < nq) {
      const size_t at = (bh * Lq + q0 + r) * d;
      if (vec) {
#pragma unroll 4
        for (int c = 8 * part; c < d; c += 16) {
          const uint4 a = *reinterpret_cast<const uint4*>(dout + at + c);
          const uint4 b = *reinterpret_cast<const uint4*>(o + at + c);
          const uint4 z = o_lo != nullptr
              ? *reinterpret_cast<const uint4*>(o_lo + at + c)
              : make_uint4(0u, 0u, 0u, 0u);
          const bf16* ap = reinterpret_cast<const bf16*>(&a);
          const bf16* bp = reinterpret_cast<const bf16*>(&b);
          const bf16* zp = reinterpret_cast<const bf16*>(&z);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc = fmaf(__bfloat162float(ap[e]),
                       __bfloat162float(bp[e]) + __bfloat162float(zp[e]), acc);
        }
      } else {
        for (int c = part; c < d; c += 2)
          acc = fmaf(__bfloat162float(dout[at + c]),
                     __bfloat162float(o[at + c]) +
                         (o_lo != nullptr ? __bfloat162float(o_lo[at + c]) : 0.f),
                     acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      ds_row[r] = acc;
      if (r < nq) delta[bh * Lq + q0 + r] = acc;
    }
  }

  const int row_a = wg * TILE + 16 * (warp & 3) + (lane >> 2);  // in the block
  const int row_b = row_a + 8;
  float lse_a, lse_b, den_a, den_b;  // (lse log2(e)) or (max, rounded sum)
  load_stats<SM16>(lse, bh * Lq + q0 + row_a, (size_t)at.heads * Lq,
                   row_a < nq, lse_a, den_a);
  load_stats<SM16>(lse, bh * Lq + q0 + row_b, (size_t)at.heads * Lq,
                   row_b < nq, lse_b, den_b);

  float acc[NT][32];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nt][i] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const uint32_t q_wg = smem_u32(qs) + wg * TILE * ROW_BYTES;
  const uint32_t do_wg = smem_u32(dos) + wg * TILE * ROW_BYTES;
  float d_a = 0.f, d_b = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % S;
    cp_wait<S - 2>();
    fence_async_smem();
    __syncthreads();
    load_kv(j + S - 1);
    if (j == 0) {
      d_a = ds_row[row_a];
      d_b = ds_row[row_b];
    }

    const uint32_t kt = smem_u32(ks(st));
    const uint32_t vt = smem_u32(vs(st));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(s, kdesc(q_wg, BQ, kk), kdesc(kt, TILE, kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(dp, kdesc(do_wg, BQ, kk), kdesc(vt, TILE, kk), kk > 0);
    wg_commit();
    wg_wait<1>();  // S is in; dP may still be in flight
    pin(s);

    const int n = Lk - j * TILE;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i >> 1) & 1;
      s[i] = SM16 ? prob<true>(s[i] * scale_log2, hi ? lse_b : lse_a, hi ? den_b : den_a)
                  : ex2(fmaf(s[i], scale_log2, hi ? -lse_b : -lse_a));
    }
    if (n < TILE) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (acc_col(i, t) >= n) s[i] = 0.f;
    }
    wg_wait0();
    pin(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = s[i] * (dp[i] - (((i >> 1) & 1) ? d_b : d_a));
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(da[kk], dp, kk);

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        wgmma_rs(acc[nt], da[kk], mndesc(kt, TILE, nt, kk));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) pin(acc[nt]);
  }
  store_acc<NT>(dq + bh * Lq * d, acc, q0 + wg * TILE, Lq, d, 0, scale, scale);
}

// Backward launch 2: dK and dV of the block's keys, columns DV blockIdx.z..
template <int DP, bool SM16>
__global__ void __launch_bounds__(bwd_wgs<DP>() * WG, 1)
flash_bwd_dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const bf16* __restrict__ dout, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Lq, int Lk, int d,
                    float scale_log2, float scale, int vec) {
  constexpr int NWG = bwd_wgs<DP>();
  constexpr int NTH = NWG * WG;
  constexpr int BK = NWG * TILE;
  constexpr int KBYTES = BK * DP * 2;    // an owned tile: K or V
  constexpr int QBYTES = TILE * DP * 2;  // a streamed tile: Q or dO
  constexpr int NV = bwd_dv<DP>() / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* kts = sm;
  unsigned char* vts = sm + KBYTES;
  constexpr int S = ring<DP>();
  auto qs = [&](int st) { return sm + 2 * KBYTES + st * 2 * QBYTES; };
  auto dos = [&](int st) { return sm + 2 * KBYTES + st * 2 * QBYTES + QBYTES; };
  auto lse_s = [&](int st) {  // [TILE] lse (or max), [TILE] D, [TILE] sum
    return reinterpret_cast<float*>(sm + 2 * KBYTES + S * 2 * QBYTES) + st * 3 * TILE;
  };
  auto d_s = [&](int st) { return lse_s(st) + TILE; };
  auto den_s = [&](int st) { return lse_s(st) + 2 * TILE; };

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const Place at = place(Lk, BK);
  const size_t bh = at.bh;
  const int k0 = at.blk * BK;
  const int c0 = blockIdx.z * bwd_dv<DP>();  // first dK / dV column
  const bf16* qb = q + bh * Lq * d;
  const bf16* dob = dout + bh * Lq * d;

  const int n_tiles = (Lq + TILE - 1) / TILE;
  auto load_q = [&](int jn) {
    if (jn < n_tiles) {
      const int st = jn % S;
      const int q1 = jn * TILE;
      const int n = min(TILE, Lq - q1);
      load_tile<TILE, DP, NTH>(qs(st), qb + (size_t)q1 * d, n, d, vec);
      load_tile<TILE, DP, NTH>(dos(st), dob + (size_t)q1 * d, n, d, vec);
      for (int i = threadIdx.x; i < TILE; i += NTH) {
        const bool ok = i < n;
        load_stats<SM16>(lse, bh * Lq + q1 + i, (size_t)at.heads * Lq, ok,
                         lse_s(st)[i], den_s(st)[i]);
        d_s(st)[i] = ok ? delta[bh * Lq + q1 + i] : 0.f;
      }
    }
    cp_commit();
  };

  load_tile<BK, DP, NTH>(kts, k + (bh * Lk + k0) * d, min(BK, Lk - k0), d, vec);
  load_tile<BK, DP, NTH>(vts, v + (bh * Lk + k0) * d, min(BK, Lk - k0), d, vec);
  for (int jn = 0; jn < S - 1; ++jn) load_q(jn);

  float acc_k[NV][32], acc_v[NV][32];
#pragma unroll
  for (int nt = 0; nt < NV; ++nt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[nt][i] = acc_v[nt][i] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const uint32_t k_wg = smem_u32(kts) + wg * TILE * ROW_BYTES;
  const uint32_t v_wg = smem_u32(vts) + wg * TILE * ROW_BYTES;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % S;
    cp_wait<S - 2>();
    fence_async_smem();
    __syncthreads();
    load_q(j + S - 1);

    const uint32_t qt = smem_u32(qs(st));
    const uint32_t dot = smem_u32(dos(st));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(s, kdesc(k_wg, BK, kk), kdesc(qt, TILE, kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(dp, kdesc(v_wg, BK, kk), kdesc(dot, TILE, kk), kk > 0);
    wg_commit();
    wg_wait<1>();  // S^T is in; dP^T may still be in flight
    pin(s);

    const float* ls = lse_s(st);
    const float* dl = d_s(st);
    const float* dn = den_s(st);
    // this lane's 16 queries: 8 c + 2 t + e
    float lcol[16], dcol[16], ncol[SM16 ? 16 : 1];
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        lcol[2 * c + e] = ls[8 * c + 2 * t + e];
        dcol[2 * c + e] = dl[8 * c + 2 * t + e];
        if constexpr (SM16) ncol[2 * c + e] = dn[8 * c + 2 * t + e];
      }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 2 * (i >> 2) + (i & 1);
      if constexpr (SM16) s[i] = prob<true>(s[i] * scale_log2, lcol[c], ncol[c]);
      else s[i] = ex2(fmaf(s[i], scale_log2, -lcol[c]));
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(pa[kk], s, kk);
    // dV += P^T dO runs while dS^T is formed
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nt = 0; nt < NV; ++nt)
        wgmma_rs(acc_v[nt], pa[kk], mndesc(dot, TILE, blockIdx.z * NV + nt, kk));
    wg_commit();
    wg_wait<1>();  // dP^T is in
    pin(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dcol[2 * (i >> 2) + (i & 1)]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(da[kk], dp, kk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nt = 0; nt < NV; ++nt)
        wgmma_rs(acc_k[nt], da[kk], mndesc(qt, TILE, blockIdx.z * NV + nt, kk));
    wg_commit();
    wg_wait0();
    keep(pa);
    keep(da);
#pragma unroll
    for (int nt = 0; nt < NV; ++nt) {
      pin(acc_v[nt]);
      pin(acc_k[nt]);
    }
  }
  const int r0 = k0 + wg * TILE;
  store_acc<NV>(dk + bh * Lk * d, acc_k, r0, Lk, d, c0, scale, scale);
  store_acc<NV>(dv + bh * Lk * d, acc_v, r0, Lk, d, c0, 1.f, 1.f);
}

template <int DP, bool LO, bool SM16>
int launch_fwd_wgmma_as(const void* q, const void* k, const void* v, void* o,
                        void* o_lo, float* lse, int BH, int Lq, int Lk, int d,
                        int vec, float scale_log2, cudaStream_t s) {
  constexpr int smem = smem_fwd_wg<DP>();
  cudaError_t err = allow_smem(flash_fwd_wgmma<DP, LO, SM16>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH * ((Lq + 2 * TILE - 1) / (2 * TILE)), 1,
                  DP / fwd_dv<DP, LO && !SM16>());
  flash_fwd_wgmma<DP, LO, SM16><<<grid, 2 * WG, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (bf16*)o_lo,
      lse, Lq, Lk, d, scale_log2, vec);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                     void* o_lo, float* lse, int BH, int Lq, int Lk, int d,
                     int vec, int sm16, float scale_log2, cudaStream_t s) {
  if (sm16)
    return o_lo != nullptr
        ? launch_fwd_wgmma_as<DP, true, true>(q, k, v, o, o_lo, lse, BH, Lq, Lk, d, vec, scale_log2, s)
        : launch_fwd_wgmma_as<DP, false, true>(q, k, v, o, o_lo, lse, BH, Lq, Lk, d, vec, scale_log2, s);
  return o_lo != nullptr
      ? launch_fwd_wgmma_as<DP, true, false>(q, k, v, o, o_lo, lse, BH, Lq, Lk, d, vec, scale_log2, s)
      : launch_fwd_wgmma_as<DP, false, false>(q, k, v, o, o_lo, lse, BH, Lq, Lk, d, vec, scale_log2, s);
}

template <int DP, bool SM16>
int launch_bwd_wgmma_as(const void* q, const void* k, const void* v,
                        const void* o, const void* o_lo, const float* lse,
                        const void* dout, void* dq, void* dk, void* dv,
                        float* delta, int BH, int Lq, int Lk, int d, int vec,
                        float scale_log2, float scale, cudaStream_t s) {
  constexpr int NWG = bwd_wgs<DP>();
  constexpr int smem_dq = smem_dq_wg<DP>();
  constexpr int smem_dkv = smem_dkv_wg<DP>();
  cudaError_t err = allow_smem(flash_bwd_dq_wgmma<DP, SM16>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(flash_bwd_dkv_wgmma<DP, SM16>, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const int rows = NWG * TILE;
  flash_bwd_dq_wgmma<DP, SM16><<<BH * ((Lq + rows - 1) / rows), NWG * WG, smem_dq, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)o_lo, lse, (const bf16*)dout, (bf16*)dq, delta, Lq, Lk, d,
      scale_log2, scale, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dkv_wgmma<DP, SM16><<<dim3(BH * ((Lk + rows - 1) / rows), 1, DP / bwd_dv<DP>()),
                                  NWG * WG, smem_dkv, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, lse, delta,
      (const bf16*)dout, (bf16*)dk, (bf16*)dv, Lq, Lk, d, scale_log2, scale, vec);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* o_lo, const float* lse,
                     const void* dout, void* dq, void* dk, void* dv,
                     float* delta, int BH, int Lq, int Lk, int d, int vec,
                     int sm16, float scale_log2, float scale, cudaStream_t s) {
  return sm16 ? launch_bwd_wgmma_as<DP, true>(q, k, v, o, o_lo, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, d, vec, scale_log2, scale, s)
              : launch_bwd_wgmma_as<DP, false>(q, k, v, o, o_lo, lse, dout, dq, dk, dv, delta, BH, Lq, Lk, d, vec, scale_log2, scale, s);
}

// ============================================= FFMA: any d, fp32, sm_bf16 ==

constexpr int FT = 128;      // threads a block: 16 x 8
constexpr int FB = 64;       // rows, keys and columns of a tile
constexpr int FK = 64;       // columns of d a streamed chunk holds
constexpr int FS = FB + 4;   // padded shared-memory row, keeps float4 alignment

// column j of a thread's 4 x 8 register tile: 4 tx.. and 32 + 4 tx..
__device__ __forceinline__ int fcol(int j, int tx) {
  return j < 4 ? 4 * tx + j : 32 + 4 * tx + (j - 4);
}

// dst[c][r] = src[r][c0 + c] (fp32) for r < n, c0 + c < d, else 0:
// an (FB rows x FK columns) chunk of a (., d) matrix, transposed.  vec4
// (fp32, d % 4 == 0, 16-byte aligned rows): 16-byte loads.
template <class T>
__device__ __forceinline__ void stage_t(float* dst, const T* __restrict__ src,
                                        int n, int d, int c0, bool vec4) {
  if (sizeof(T) == 4 && vec4) {
    // neighbouring threads take neighbouring rows: the transposed stores
    // fall in distinct banks
    for (int i = threadIdx.x; i < FB * FK / 4; i += FT) {
      const int r = i % FB;
      const int c = (i / FB) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n && c0 + c < d)
        x = *reinterpret_cast<const float4*>(src + (size_t)r * d + c0 + c);
      dst[(c + 0) * FS + r] = x.x;
      dst[(c + 1) * FS + r] = x.y;
      dst[(c + 2) * FS + r] = x.z;
      dst[(c + 3) * FS + r] = x.w;
    }
    return;
  }
  for (int i = threadIdx.x; i < FB * FK; i += FT) {
    const int r = i / FK;
    const int c = i - r * FK;
    dst[c * FS + r] =
        (r < n && c0 + c < d) ? to_f<T>(src[(size_t)r * d + c0 + c]) : 0.f;
  }
}

// dst[r][c] = src[r][c0 + c] for r < n, c0 + c < d, else 0: FB x FB
template <class T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int n, int d, int c0, bool vec4) {
  if (sizeof(T) == 4 && vec4) {
    for (int i = threadIdx.x; i < FB * FB / 4; i += FT) {
      const int r = i / (FB / 4);
      const int c = (i - r * (FB / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n && c0 + c < d)
        x = *reinterpret_cast<const float4*>(src + (size_t)r * d + c0 + c);
      *reinterpret_cast<float4*>(dst + r * FS + c) = x;
    }
    return;
  }
  for (int i = threadIdx.x; i < FB * FB; i += FT) {
    const int r = i / FB;
    const int c = i - r * FB;
    dst[r * FS + c] =
        (r < n && c0 + c < d) ? to_f<T>(src[(size_t)r * d + c0 + c]) : 0.f;
  }
}

// acc[i][j] = sum_c A[4 ty + i][c] B[fcol(j)][c] over the whole d, for the
// (na, d) and (nb, d) row blocks at a and b, through as, bs (FK x FS each).
// stage_a / stage_b false: as / bs already holds A / B (d <= FK, the same
// rows as at the last call).  Begins with a barrier.
template <class T>
__device__ __forceinline__ void dot_tiles(float (&acc)[4][8], const T* a,
                                          int na, const T* b, int nb, int d,
                                          float* as, float* bs, bool vec4,
                                          bool stage_a = true,
                                          bool stage_b = true) {
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < d; c0 += FK) {
    __syncthreads();
    if (stage_a || d > FK) stage_t<T>(as, a, na, d, c0, vec4);
    if (stage_b || d > FK) stage_t<T>(bs, b, nb, d, c0, vec4);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < min(FK, d - c0); ++c) {
      const float4 av = *reinterpret_cast<const float4*>(as + c * FS + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + c * FS + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + c * FS + 32 + 4 * tx);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

// a thread's 4 x 8 tile x into dst transposed: dst[fcol(j)][4 ty + i]
__device__ __forceinline__ void store_t(float* dst, const float (&x)[4][8]) {
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(dst + fcol(j, tx) * FS + 4 * ty) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

// the same as it lies: dst[4 ty + i][fcol(j)]
__device__ __forceinline__ void store_rows(float* dst, const float (&x)[4][8]) {
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = dst + (4 * ty + i) * FS;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
    *reinterpret_cast<float4*>(row + 32 + 4 * tx) =
        make_float4(x[i][4], x[i][5], x[i][6], x[i][7]);
  }
}

// acc[i][j] += sum_r X[r][4 ty + i] Y[r][fcol(j)], X and Y FB x FS in
// shared memory
__device__ __forceinline__ void acc_tiles(float (&acc)[4][8], const float* x,
                                          const float* y) {
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
#pragma unroll 8
  for (int r = 0; r < FB; ++r) {
    const float4 xv = *reinterpret_cast<const float4*>(x + r * FS + 4 * ty);
    const float4 y0 = *reinterpret_cast<const float4*>(y + r * FS + 4 * tx);
    const float4 y1 = *reinterpret_cast<const float4*>(y + r * FS + 32 + 4 * tx);
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
    const float yr[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xr[i], yr[j], acc[i][j]);
  }
}

// rows r0 + 4 ty + i (below L), columns c0 + fcol(j) (below d) of a (., d)
// matrix: acc * mul
template <class T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst,
                                           const float (&acc)[4][8], int r0,
                                           int L, int d, int c0, float mul) {
  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + fcol(j, tx);
      if (col < d) dst[(size_t)row * d + col] = from_f<T>(acc[i][j] * mul);
    }
  }
}

constexpr int smem_fwd_ffma() { return (2 * FK * FS + FB * FS) * 4; }
constexpr int smem_dq_ffma() { return (3 * FK * FS + FB * FS) * 4; }
constexpr int smem_dkv_ffma() { return (3 * FK * FS + 3 * FB * FS) * 4; }

// grid (BH, Lq / 64, d / 64): the block's 64 query rows and 64 output
// columns.  stats: lse (BH, Lq), or (2, BH, Lq) max and sum; written by the
// blocks of the first column range.
// LO (bf16 operands, training): o_lo as the wgmma forward writes it; the
// sm_bf16 probabilities are bf16 values already, so there it is acc's own
// rounding residual, and otherwise a second product takes P unrounded.
template <class T, bool SM16, bool LO>
__global__ void __launch_bounds__(FT)
flash_fwd_ffma(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               T* __restrict__ o_lo, float* __restrict__ stats, int Lq,
               int Lk, int d, float scale_log2, int vec4) {
  constexpr bool EXACT = LO && !SM16;  // a second product with P unrounded
  extern __shared__ __align__(16) float fsm[];
  float* as = fsm;
  float* bs = as + FK * FS;
  float* ps = bs + FK * FS;  // [key][row]
  float* vs = bs;             // [key][column]: bs is free once S is in
  float* pxs = ps + FB * FS;  // [key][row], P unrounded (EXACT)
  constexpr bool ROUND = sizeof(T) == 2;  // bf16 operands: P rounded

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const Place at = place(Lq, FB);
  const size_t bh = at.bh;
  const int q0 = at.blk * FB;
  const int c0 = blockIdx.z * FB;
  const int nq = min(FB, Lq - q0);
  const T* qb = q + (bh * Lq + q0) * d;
  const T* kb = k + bh * Lk * d;
  const T* vb = v + bh * Lk * d;

  float acc[4][8], s[4][8], acc_x[EXACT ? 4 : 1][8], px[EXACT ? 4 : 1][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = acc_x[EXACT ? i : 0][j] = 0.f;
  float mx[4], sum[4], den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx[i] = -INFINITY;
    sum[i] = 0.f;
    den[i] = 1.f;
  }

  for (int pass = SM16 ? 0 : 2; pass < 3; ++pass) {
    for (int k0 = 0; k0 < Lk; k0 += FB) {
      const int n = min(FB, Lk - k0);
      dot_tiles<T>(s, qb, nq, kb + (size_t)k0 * d, n, d, as, bs, vec4,
                   pass == (SM16 ? 0 : 2) && k0 == 0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (SM16) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bool ok = fcol(j, tx) < n;
            const float sv = s[i][j] * scale_log2 * LN2;  // natural units
            if (pass == 0) {
              if (ok) mx[i] = fmaxf(mx[i], sv);
            } else {
              const float ev = ok ? exp_bf16(sv - mx[i]) : 0.f;
              if (pass == 1) sum[i] += ev;
              else s[i][j] = round_bf16(ev / den[i]);
            }
          }
        } else {
          float m = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = fcol(j, tx) < n ? s[i][j] * scale_log2 : -INFINITY;
            m = fmaxf(m, s[i][j]);
          }
          const float nm = fmaxf(mx[i], group_max<8>(m));  // finite: n >= 1
          const float corr = ex2(mx[i] - nm);
          mx[i] = nm;
          sum[i] *= corr;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] *= corr;
            s[i][j] = ex2(s[i][j] - nm);
            sum[i] += s[i][j];
            if constexpr (EXACT) {
              acc_x[i][j] *= corr;
              px[i][j] = s[i][j];
            }
            if (ROUND) s[i][j] = round_bf16(s[i][j]);
          }
        }
      }
      if (pass < 2) continue;
      __syncthreads();  // ps, vs: the previous tile's P V is done
      store_t(ps, s);
      if constexpr (EXACT) store_t(pxs, px);
      stage<T>(vs, vb + (size_t)k0 * d, n, d, c0, vec4);
      __syncthreads();
      acc_tiles(acc, ps, vs);
      if constexpr (EXACT) acc_tiles(acc_x, pxs, vs);
    }
    if (SM16 && pass == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i] = group_max<8>(mx[i]);
    } else if (SM16 && pass == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) den[i] = round_bf16(group_sum<8>(sum[i]));
    }
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!SM16) sum[i] = group_sum<8>(sum[i]);
    inv[i] = SM16 ? 1.f : 1.f / sum[i];
  }
  T* ob = o + bh * Lq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Lq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + fcol(j, tx);
      if (col >= d) continue;
      const float x = acc[i][j] * inv[i];
      ob[(size_t)row * d + col] = from_f<T>(x);
      if constexpr (LO) {
        float exact = x;
        if constexpr (EXACT) exact = acc_x[i][j] * inv[i];
        o_lo[(bh * Lq + row) * d + col] = from_f<T>(exact - to_f<T>(from_f<T>(x)));
      }
    }
    if (stats != nullptr && blockIdx.z == 0 && tx == 0) {
      if (SM16) {
        stats[bh * Lq + row] = mx[i];
        stats[(size_t)at.heads * Lq + bh * Lq + row] = den[i];
      } else {
        stats[bh * Lq + row] = (mx[i] + log2f(sum[i])) * LN2;
      }
    }
  }
}

// Backward launch 1: D = rowsum(dO o O) of the block's rows (to delta, by
// the blocks of the first column range) and dQ of its 64 columns.
template <class T, bool SM16>
__global__ void __launch_bounds__(FT)
flash_bwd_dq_ffma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ o_lo,
                  const float* __restrict__ stats, const T* __restrict__ dout,
                  T* __restrict__ dq, float* __restrict__ delta, int Lq,
                  int Lk, int d, float scale_log2, float scale, int vec4) {
  extern __shared__ __align__(16) float fsm[];
  float* as = fsm;             // Q^T
  float* as2 = as + FK * FS;   // dO^T
  float* bs = as2 + FK * FS;
  float* dss = bs + FK * FS;  // [key][row]
  float* ks = bs;             // [key][column]: bs is free once dP is in
  constexpr bool ROUND = sizeof(T) == 2;

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const Place at = place(Lq, FB);
  const size_t bh = at.bh;
  const int q0 = at.blk * FB;
  const int c0 = blockIdx.z * FB;
  const int nq = min(FB, Lq - q0);
  const T* qb = q + (bh * Lq + q0) * d;
  const T* dob = dout + (bh * Lq + q0) * d;
  const T* kb = k + bh * Lk * d;
  const T* vb = v + bh * Lk * d;

  float dsum[4], st0[4], st1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    float a = 0.f;
    if (r < nq) {  // D from o + o_lo (o_lo null: o)
      const T* orow = o + (bh * Lq + q0 + r) * d;
      const T* lrow = o_lo != nullptr ? o_lo + (bh * Lq + q0 + r) * d : nullptr;
      for (int c = tx; c < d; c += 8)
        a = fmaf(to_f<T>(dob[(size_t)r * d + c]),
                 to_f<T>(orow[c]) + (lrow != nullptr ? to_f<T>(lrow[c]) : 0.f), a);
    }
    dsum[i] = group_sum<8>(a);
    if (blockIdx.z == 0 && tx == 0 && r < nq) delta[bh * Lq + q0 + r] = dsum[i];
    load_stats<SM16>(stats, bh * Lq + q0 + r, (size_t)at.heads * Lq, r < nq,
                     st0[i], st1[i]);
  }

  float acc[4][8], s[4][8], dp[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += FB) {
    const int n = min(FB, Lk - k0);
    dot_tiles<T>(s, qb, nq, kb + (size_t)k0 * d, n, d, as, bs, vec4, k0 == 0);
    dot_tiles<T>(dp, dob, nq, vb + (size_t)k0 * d, n, d, as2, bs, vec4, k0 == 0);
    __syncthreads();  // dss, ks: the previous tile's product is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds = fcol(j, tx) < n
            ? prob<SM16>(s[i][j] * scale_log2, st0[i], st1[i]) * (dp[i][j] - dsum[i])
            : 0.f;
        if (ROUND) ds = round_bf16(ds);
        dp[i][j] = ds;
      }
    store_t(dss, dp);
    stage<T>(ks, kb + (size_t)k0 * d, n, d, c0, vec4);
    __syncthreads();
    acc_tiles(acc, dss, ks);
  }
  store_tile<T>(dq + bh * Lq * d, acc, q0, Lq, d, c0, scale);
}

// Backward launch 2: dK and dV of the block's 64 keys and 64 columns.
template <class T, bool SM16>
__global__ void __launch_bounds__(FT)
flash_bwd_dkv_ffma(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ stats,
                   const float* __restrict__ delta, const T* __restrict__ dout,
                   T* __restrict__ dk, T* __restrict__ dv, int Lq, int Lk,
                   int d, float scale_log2, float scale, int vec4) {
  extern __shared__ __align__(16) float fsm[];
  float* as = fsm;             // Q^T, dO^T of the query tile, then P
  float* bks = as + FK * FS;   // K^T of the block's keys
  float* bvs = bks + FK * FS;  // V^T
  float* ps = as;             // [query][key]
  float* dss = bvs + FK * FS;  // [query][key]
  float* qs = dss + FB * FS;  // [query][column]
  float* dos = qs + FB * FS;  // [query][column]
  constexpr bool ROUND = sizeof(T) == 2;

  const int ty = threadIdx.x >> 3;
  const Place at = place(Lk, FB);
  const size_t bh = at.bh;
  const int k0 = at.blk * FB;
  const int c0 = blockIdx.z * FB;
  const int nk = min(FB, Lk - k0);
  const T* qb = q + bh * Lq * d;
  const T* dob = dout + bh * Lq * d;
  const T* kb = k + (bh * Lk + k0) * d;
  const T* vb = v + (bh * Lk + k0) * d;

  float acc_k[4][8], acc_v[4][8], s[4][8], dp[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  for (int q0 = 0; q0 < Lq; q0 += FB) {
    const int n = min(FB, Lq - q0);
    // scores of the tile's queries (rows) against the block's keys (columns)
    dot_tiles<T>(s, qb + (size_t)q0 * d, n, kb, nk, d, as, bks, vec4, true,
                 q0 == 0);
    dot_tiles<T>(dp, dob + (size_t)q0 * d, n, vb, nk, d, as, bvs, vec4, true,
                 q0 == 0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float st0, st1;
      load_stats<SM16>(stats, bh * Lq + q0 + r, (size_t)at.heads * Lq, r < n,
                       st0, st1);
      const float dl = r < n ? delta[bh * Lq + q0 + r] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p = r < n ? prob<SM16>(s[i][j] * scale_log2, st0, st1) : 0.f;
        float ds = p * (dp[i][j] - dl);
        if (ROUND) {
          p = round_bf16(p);
          ds = round_bf16(ds);
        }
        s[i][j] = p;
        dp[i][j] = ds;
      }
    }
    store_rows(ps, s);
    store_rows(dss, dp);
    stage<T>(qs, qb + (size_t)q0 * d, n, d, c0, vec4);
    stage<T>(dos, dob + (size_t)q0 * d, n, d, c0, vec4);
    __syncthreads();
    acc_tiles(acc_v, ps, dos);
    acc_tiles(acc_k, dss, qs);
  }
  store_tile<T>(dk + bh * Lk * d, acc_k, k0, Lk, d, c0, scale);
  store_tile<T>(dv + bh * Lk * d, acc_v, k0, Lk, d, c0, 1.f);
}

template <class T, bool SM16, bool LO>
int launch_fwd_ffma_lo(const void* q, const void* k, const void* v, void* o,
                       void* o_lo, float* stats, int BH, int Lq, int Lk, int d,
                       float scale_log2, cudaStream_t s) {
  const int vec4 = d % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) |
                                   reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v)) % 16 == 0);
  constexpr int smem = smem_fwd_ffma() + (LO && !SM16 ? FB * FS * 4 : 0);
  cudaError_t err = allow_smem(flash_fwd_ffma<T, SM16, LO>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH * ((Lq + FB - 1) / FB), 1, (d + FB - 1) / FB);
  flash_fwd_ffma<T, SM16, LO><<<grid, FT, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (T*)o_lo, stats, Lq, Lk,
      d, scale_log2, vec4);
  return (int)cudaGetLastError();
}

// o_lo is written for bf16 operands only (fp32 P is not rounded)
template <class T, bool SM16>
int launch_fwd_ffma(const void* q, const void* k, const void* v, void* o,
                    void* o_lo, float* stats, int BH, int Lq, int Lk, int d,
                    float scale_log2, cudaStream_t s) {
  if (sizeof(T) == 2 && o_lo != nullptr)
    return launch_fwd_ffma_lo<T, SM16, true>(q, k, v, o, o_lo, stats, BH, Lq, Lk, d, scale_log2, s);
  return launch_fwd_ffma_lo<T, SM16, false>(q, k, v, o, nullptr, stats, BH, Lq, Lk, d, scale_log2, s);
}

template <class T, bool SM16>
int launch_bwd_ffma(const void* q, const void* k, const void* v,
                    const void* o, const void* o_lo, const float* stats,
                    const void* dout,
                    void* dq, void* dk, void* dv, float* delta, int BH,
                    int Lq, int Lk, int d, float scale_log2, float scale,
                    cudaStream_t s) {
  const int vec4 = d % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) |
                                   reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v) |
                                   reinterpret_cast<uintptr_t>(dout)) % 16 == 0);
  cudaError_t err = allow_smem(flash_bwd_dq_ffma<T, SM16>, smem_dq_ffma());
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(flash_bwd_dkv_ffma<T, SM16>, smem_dkv_ffma());
  if (err != cudaSuccess) return (int)err;
  const int nc = (d + FB - 1) / FB;
  flash_bwd_dq_ffma<T, SM16><<<dim3(BH * ((Lq + FB - 1) / FB), 1, nc), FT,
                               smem_dq_ffma(), s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)o_lo,
      stats, (const T*)dout, (T*)dq, delta, Lq, Lk, d, scale_log2, scale, vec4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dkv_ffma<T, SM16><<<dim3(BH * ((Lk + FB - 1) / FB), 1, nc), FT,
                                smem_dkv_ffma(), s>>>(
      (const T*)q, (const T*)k, (const T*)v, stats, delta, (const T*)dout,
      (T*)dk, (T*)dv, Lq, Lk, d, scale_log2, scale, vec4);
  return (int)cudaGetLastError();
}

// the padded width of the wgmma kernels for a bf16 d, 0 where the FFMA
// kernels take it
int wgmma_width(int d, int bf16) {
  if (!bf16 || d > 256) return 0;
  return d <= 64 ? 64 : (d <= 128 ? 128 : 256);
}

// cp.async takes 16-byte rows: d a multiple of 8 and every pointer aligned
bool rows_aligned(int d, const void* a, const void* b, const void* c,
                  const void* e = nullptr, const void* f = nullptr) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(e) |
                        reinterpret_cast<uintptr_t>(f);
  return d % 8 == 0 && any % 16 == 0;
}

}  // namespace

extern "C" {

// q (BH, Lq, d), k, v (BH, Lk, d), o (BH, Lq, d), all bf16 (bf16 != 0) or
// all fp32; stats null, or (BH, Lq) fp32 lse (sm16: (2, BH, Lq), the max and
// the rounded sum); o_lo null, or like o: for bf16 operands the forward
// then writes the residual that D of the backward takes (see flash_fwd_wgmma).
// Lk >= 1, d >= 1.  Returns the cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* o_lo, float* stats, int BH, int Lq, int Lk,
                        int d, int bf16, int sm16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float scale_log2 = LOG2E / sqrtf((float)d);
  const int vec = rows_aligned(d, q, k, v);
  switch (wgmma_width(d, bf16)) {
    case 64: return launch_fwd_wgmma<64>(q, k, v, o, o_lo, stats, BH, Lq, Lk, d, vec, sm16, scale_log2, s);
    case 128: return launch_fwd_wgmma<128>(q, k, v, o, o_lo, stats, BH, Lq, Lk, d, vec, sm16, scale_log2, s);
    case 256: return launch_fwd_wgmma<256>(q, k, v, o, o_lo, stats, BH, Lq, Lk, d, vec, sm16, scale_log2, s);
    default: break;
  }
  if (bf16)
    return sm16 ? launch_fwd_ffma<__nv_bfloat16, true>(q, k, v, o, o_lo, stats, BH, Lq, Lk, d, scale_log2, s)
                : launch_fwd_ffma<__nv_bfloat16, false>(q, k, v, o, o_lo, stats, BH, Lq, Lk, d, scale_log2, s);
  return sm16 ? launch_fwd_ffma<float, true>(q, k, v, o, nullptr, stats, BH, Lq, Lk, d, scale_log2, s)
              : launch_fwd_ffma<float, false>(q, k, v, o, nullptr, stats, BH, Lq, Lk, d, scale_log2, s);
}

// The VJP for the cotangent dout (the operands' dtype): dq, dk, dv like q,
// k, v; o, o_lo (or null) and stats as the forward wrote them; delta (BH,
// Lq) fp32 scratch.  Two launches; returns the first failure.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* o_lo, const float* stats,
                        const void* dout, void* dq, void* dk, void* dv,
                        float* delta, int BH, int Lq, int Lk, int d, int bf16,
                        int sm16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float scale = 1.f / sqrtf((float)d);
  const float scale_log2 = LOG2E * scale;
  const int vec = rows_aligned(d, q, k, v, o, dout) &&
                  reinterpret_cast<uintptr_t>(o_lo) % 16 == 0;
  switch (wgmma_width(d, bf16)) {
    case 64: return launch_bwd_wgmma<64>(q, k, v, o, o_lo, stats, dout, dq, dk, dv, delta, BH, Lq, Lk, d, vec, sm16, scale_log2, scale, s);
    case 128: return launch_bwd_wgmma<128>(q, k, v, o, o_lo, stats, dout, dq, dk, dv, delta, BH, Lq, Lk, d, vec, sm16, scale_log2, scale, s);
    case 256: return launch_bwd_wgmma<256>(q, k, v, o, o_lo, stats, dout, dq, dk, dv, delta, BH, Lq, Lk, d, vec, sm16, scale_log2, scale, s);
    default: break;
  }
  if (bf16)
    return sm16 ? launch_bwd_ffma<__nv_bfloat16, true>(q, k, v, o, o_lo, stats, dout, dq, dk, dv, delta, BH, Lq, Lk, d, scale_log2, scale, s)
                : launch_bwd_ffma<__nv_bfloat16, false>(q, k, v, o, o_lo, stats, dout, dq, dk, dv, delta, BH, Lq, Lk, d, scale_log2, scale, s);
  return sm16 ? launch_bwd_ffma<float, true>(q, k, v, o, nullptr, stats, dout, dq, dk, dv, delta, BH, Lq, Lk, d, scale_log2, scale, s)
              : launch_bwd_ffma<float, false>(q, k, v, o, nullptr, stats, dout, dq, dk, dv, delta, BH, Lq, Lk, d, scale_log2, scale, s);
}

}  // extern "C"
