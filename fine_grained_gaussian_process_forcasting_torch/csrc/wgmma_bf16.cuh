// Hopper warpgroup products (`wgmma`) on bf16 tiles in shared memory, and
// the `cp.async` copies that fill them -- sm_90a only.
//
// Tiles use the 128-byte-swizzled layout that `wgmma` descriptors read: a
// tile of `rows` rows of 64 bf16 (128 bytes) is one slab, the 16-byte chunk
// c of row r stored at chunk c ^ (r & 7), and 8-row groups 1024 bytes apart
// (the tile's base 1024-byte aligned).  An operand that is K-major (its rows
// run along the summed index) is read 16 columns (32 bytes) a step; one that
// is MN-major (its rows run along the summed index's partner: rows = k) is
// read 16 rows a step, 64 columns a slab.  Every product is m64n64k16 with
// fp32 accumulators: warp w of the warpgroup holds rows 16 w + g and
// 16 w + g + 8 (g = lane / 4) of the 64, element i of its 32 at row
// + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 (lane % 4) + (i & 1).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Descriptor of a 128-byte-swizzled operand whose 8-row groups lie 1024
// bytes apart (the stride byte offset: along M or N for a K-major operand,
// along K for an MN-major one).  The leading byte offset, the step between
// the 64-column slabs of an MN-major operand, is unread for one slab wide
// and for K-major operands; it is set to 1024 too.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// K-major: the k16 step kk of the 64-row tile at `tile` inside a tile of
// `rows` rows: slab kk / 4, 32 bytes a step inside the swizzled row
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int rows, int kk) {
  return desc(tile + (kk >> 2) * (rows * ROW_BYTES) + (kk & 3) * 32);
}

// MN-major: rows 16 kk.. and columns 64 nt.. of a tile of `rows` rows
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int rows, int nt,
                                           int kk) {
  return desc(tile + nt * (rows * ROW_BYTES) + kk * 16 * ROW_BYTES);
}

// byte offset of the 16-byte chunk c (of 8 bf16) of row r in a tile of
// `rows` rows: slab c / 8, swizzled inside its row
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int c) {
  return (c >> 3) * (rows * ROW_BYTES) + r * ROW_BYTES +
         (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulators are not touched by ordinary code while a product is in
// flight: pin them around the wait
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, fp32) += A (64 x 16, K-major) * B (16 x 64; TB 0: K-major,
// 1: MN-major), both from shared memory; accumulate 0: d = A B
template <int TB>
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                    int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

// The same as two `mma` on the 64-column halves of a 128-column B, in one
// m64n128k16 instruction that reads A once: d0 and d1 are the halves'
// accumulators.  b: a K-major B's descriptor (128 rows), or an MN-major B's
// of its first 64 columns, the next 64 `mn_step` bytes on.
template <int TB>
__device__ __forceinline__ void mma128(float (&d0)[32], float (&d1)[32],
                                       uint64_t a, uint64_t b,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]),
        "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]),
        "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]),
        "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]), "+f"(d0[24]),
        "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]), "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]),
        "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]),
        "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]), "+f"(d1[16]), "+f"(d1[17]),
        "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]),
        "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

// An MN-major operand's descriptor whose 64-column slabs lie `mn_step`
// bytes apart (the leading byte offset), for `mma128`
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t mn_step) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(mn_step >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// 16 bytes from device to shared memory, in flight until cp_wait
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
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

}  // namespace hopper
