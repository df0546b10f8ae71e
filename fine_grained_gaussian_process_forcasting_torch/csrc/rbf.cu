// RBF cross-covariance of h GPs over shared points, fp32 -- for sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/rbf.py
//   `_rbf_body` (reached through `rbf_cross_kernel`, `_rbf_pallas`):
//     K[g, r, m] = os[g] * exp(-0.5 * max(0, |xs_r|^2 + |zs_m|^2
//                                            - 2 xs_r . zs_m)),
//     xs = x / ls[g],  zs = z[g] / ls[g].
//   The deep GP's hidden layer vmaps the op over its h GPs, which batches
//   the Pallas grid; here the h GPs are the grid's second axis of one launch.
//   Multi-seed training vmaps the layer again over S seeds, each with its
//   own x and its own h GPs: the seeds are the grid's third axis, so one
//   launch computes every seed's K, (S, h, R, M).
//   The VJP is plain PyTorch over the saved K, as it is plain XLA there.
//
// What bounds it on an H100: the stores.  At the hidden layer of the
// multi-layer flagship (h 8, R = 256 * 288 rows, M 512, d 32) K is 302 M
// floats, 1.21 GB written (0.361 ms at 3.35 TB/s; a kernel that does nothing
// but write them reaches 3.2 TB/s), against 19.3 GFLOP of cross products
// (0.289 ms at the fp32 peak) and 302 M exponentials (0.072 ms).  So the
// products and the exponentials have to run while the stores drain, and
// cost as few instructions as they can: the cross term is a register-tiled
// fp32 product on FFMA (TF32 would break the Gram decomposition's
// consistency, see gp/kernels.py; three bf16 parts measured slower: on the
// `wgmma` engine of fused_gp.cu 1.15 ms (scripts/fused_gp_routes.py, H100
// 80GB HBM3 at 700 W), its one-stage tiles writing K at 1.05 TB/s, and on
// `mma.sync`, where splitting each tile of z into its parts cost more than
// the products saved), and K is written once, in whole 128-byte lines,
// never read back.
//
// A block of 256 threads owns 128 rows of one GP and walks all of M, 128
// columns at a time; two blocks an SM.  Its rows of x are staged once (d up
// to 32; above, 32 columns of d at a time per column tile) and their
// squared norms |x / ls|^2 taken once, as warp sums.  x enters shared
// memory scaled by 1/ls^2, so that its product with the raw z is xs . zs
// and z needs no arithmetic on its way in: each column tile of z[g] is
// copied by `cp.async` while the previous tile's epilogue runs.  1/ls is
// computed once per block for the one column of d that a lane stages (not
// a divide per element).  A thread accumulates an 8 x 8 tile of the cross
// term from float4 reads of shared memory.  The epilogue is one FADD,
// FFMA, FMNMX, `ex2` and FMUL an element, the norms and the clamp folded
// into the exponent of 2:
//   K = os 2^min(0, t),  t = log2(e) acc - (log2(e) / 2) (|xs|^2 + |zs|^2),
// stored from the registers as float4 with the streaming hint (`st.cs`):
// each warp writes two rows' 256 contiguous bytes an instruction, whole
// 128-byte lines, and the stores of one tile drain while the next tile's
// products run.  (A 64 KB tile of K in shared memory leaving by bulk copies,
// `cp.async.bulk`, measured slower than these stores, as did plain float4
// stores and 64-column tiles at three blocks an SM.)  Ragged R, M and d are masked (zeros in shared
// memory, not stored; at an M that is no multiple of 4, rows do not start
// on 16-byte boundaries and the stores are scalar).  No padding in device
// memory, no atomics.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BR = 128;       // rows of K per block
constexpr int BM = 128;       // columns (inducing points) per tile
constexpr int DK = 32;        // columns of d staged at a time
constexpr int THREADS = 256;  // 16 column groups x 16 row groups
constexpr int LD = BM + 4;    // padded rows of the transposed tiles (float4)
constexpr int PER = BM * DK / THREADS;  // z (and x) values a thread stages
constexpr float LOG2E = 1.4426950408889634f;
// dynamic shared memory: x's and z's chunks, 1/ls^2, the norms
constexpr int SMEM = (2 * DK * LD + DK + BR + BM) * (int)sizeof(float);

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// c += the cross products of column kk of one staged chunk: rows ty*4..
// and 64 + ty*4.. of xt, columns tx*4.. and 64 + tx*4.. of zt
__device__ __forceinline__ void product(float (&c)[8][8], const float* xt,
                                        const float* zt, int tx, int ty, int kk) {
  const float4 a0 = *reinterpret_cast<const float4*>(xt + kk * LD + ty * 4);
  const float4 a1 = *reinterpret_cast<const float4*>(xt + kk * LD + 64 + ty * 4);
  const float4 b0 = *reinterpret_cast<const float4*>(zt + kk * LD + tx * 4);
  const float4 b1 = *reinterpret_cast<const float4*>(zt + kk * LD + 64 + tx * 4);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
}

// 4 bytes from device to shared memory, in flight until cp_wait; zeros
// where `ok` is false (src is then not read)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS, 2)
rbf_cross_kernel(const float* __restrict__ x, const float* __restrict__ z,
                 const float* __restrict__ ls, const float* __restrict__ os,
                 float* __restrict__ out, int R, int M, int d, int G) {
  extern __shared__ __align__(128) float smem[];
  float* xt = smem;                // x chunk / ls^2, [k][r]
  float* zt = xt + DK * LD;        // z chunk, raw, [k][m]
  float* inv2 = zt + DK * LD;      // 1 / ls^2 of the chunk's columns
  float* ra = inv2 + DK;           // |xs_r|^2
  float* cb = ra + BR;             // -(log2(e) / 2) |zs_m|^2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * BR;
  // the seed's GP g: x is the seed's, z, ls, os and K the pair's
  const size_t sg = (size_t)blockIdx.z * G + blockIdx.y;
  x += (size_t)blockIdx.z * R * d;
  const float* zg = z + sg * M * d;
  const float* lsg = ls + sg * d;
  const float osg = os[sg];
  const int nd = (d + DK - 1) / DK;       // chunks of d
  const int steps = (M + BM - 1) / BM * nd;
  const bool vec = (M & 3) == 0;  // rows start on 16-byte boundaries

  // A thread's share of a 128 x DK chunk: rows (or columns) warp + 8 i,
  // column of d k0 + lane.  x enters scaled by 1/ls^2, so that its product
  // with the raw z is xs . zs; its rows' |xs|^2 are warp sums of (x / ls)^2,
  // added into ra (norms: the first column tile, whose steps see every
  // chunk of d).
  auto stage_x = [&](int kc, bool norms) {
    const int k = kc * DK + lane;
    const float inv = k < d ? 1.f / lsg[k] : 0.f;
    if (warp == 0) inv2[lane] = inv * inv;
#pragma unroll 4
    for (int i = 0; i < PER; ++i) {
      const int rr = warp + 8 * i, r = r0 + rr;
      const float v = (r < R && k < d) ? x[(size_t)r * d + k] * inv : 0.f;
      xt[lane * LD + rr] = v * inv;
      if (norms) {
        const float sq = warp_sum(v * v);
        if (lane == 0) ra[rr] = kc == 0 ? sq : ra[rr] + sq;
      }
    }
  };
  // step s's chunk of z (column tile s / nd, chunk of d s % nd) into zt
  auto copy_z = [&](int s) {
    const int m0 = (s / nd) * BM, k = (s % nd) * DK + lane;
#pragma unroll 4
    for (int i = 0; i < PER; ++i) {
      const int m = m0 + warp + 8 * i;
      const bool ok = m < M && k < d;
      cp4(zt + lane * LD + warp + 8 * i, ok ? zg + (size_t)m * d + k : zg, ok);
    }
    cp_commit();
  };

  if (nd == 1) stage_x(0, true);
  copy_z(0);
  float c[8][8];
  float norm = 0.f;  // |zs|^2 of column tid - BR of the tile
  for (int s = 0; s < steps; ++s) {
    const int ct = s / nd, kc = s % nd;
    if (nd > 1) stage_x(kc, ct == 0);
    cp_wait_all();
    __syncthreads();  // the chunk is staged
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
      norm = 0.f;
    }
    if (tid >= BR) {  // four chains of 8, not one of 32
      const float* v = zt + tid - BR;
      float n4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        n4[kk & 3] = fmaf(v[kk * LD] * v[kk * LD], inv2[kk], n4[kk & 3]);
      norm += (n4[0] + n4[1]) + (n4[2] + n4[3]);
    }
    const int kn = min(DK, d - kc * DK);
    if (kn == DK) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) product(c, xt, zt, tx, ty, kk);
    } else {  // the last chunk of a ragged d
      for (int kk = 0; kk < kn; ++kk) product(c, xt, zt, tx, ty, kk);
    }
    const bool last = kc == nd - 1;
    if (last && tid >= BR) cb[tid - BR] = -0.5f * LOG2E * norm;
    __syncthreads();  // zt and xt are read; the norms are written
    if (s + 1 < steps) copy_z(s + 1);  // lands while the epilogue runs
    if (!last) continue;
    const int m0 = ct * BM;
    float cbv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) cbv[j] = cb[(j < 4 ? 0 : 64) + tx * 4 + (j & 3)];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
      const float ar = -0.5f * LOG2E * ra[rr];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = h * 64 + tx * 4;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = osg * ex2(fminf(fmaf(LOG2E, c[i][4 * h + j], ar + cbv[4 * h + j]), 0.f));
        const int r = r0 + rr, m = m0 + cc;
        if (r < R) {
          float* o = out + (sg * R + r) * M + m;
          if (vec && m + 3 < M) {
            __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (m + j < M) o[j] = v[j];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// S seeds (1 without the seed axis), each with its raw points x (R, d)
// shared by its G GPs: x (S, R, d); z (S, G, M, d) inducing points; ls
// (S, G, d) lengthscales; os (S, G) outputscales; out (S, G, R, M).  All
// contiguous fp32.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an empty or oversized shape).
int rbf_cross_fwd(const float* x, const float* z, const float* ls,
                  const float* os, float* out, int R, int M, int d, int G,
                  int S, void* stream) {
  if (R < 1 || M < 1 || d < 1 || G < 1 || G > 65535 || S < 1 || S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rbf_cross_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + BR - 1) / BR, G, S);
  rbf_cross_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      x, z, ls, os, out, R, M, d, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
