// RBF cross-covariance of h GPs over shared points, fp32 -- for sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/rbf.py
//   `_rbf_body` (reached through `rbf_cross_kernel`, `_rbf_pallas`):
//     K[g, r, m] = os[g] * exp(-0.5 * max(0, |xs_r|^2 + |zs_m|^2
//                                            - 2 xs_r . zs_m)),
//     xs = x / ls[g],  zs = z[g] / ls[g].
//   The deep GP's hidden layer vmaps the op over its h GPs, which batches
//   the Pallas grid; here the h GPs are the grid's third axis of one launch.
//   The VJP is plain PyTorch over the saved K, as it is plain XLA there.
//
// What bounds it on an H100: the output.  At the hidden layer of the
// multi-layer flagship (h 8, R = 256 * 288 rows, M 512, d 32) K is 302 M
// floats, 1.21 GB written (0.361 ms at 3.35 TB/s), against 19.3 GFLOP of
// cross products (0.289 ms at the fp32 peak) and 302 M exponentials
// (0.072 ms).  So the kernel has to keep the products off the critical path
// of the stores: it is a register-tiled fp32 product (TF32 would break the
// Gram decomposition's consistency, see gp/kernels.py) with the distance,
// clamp and exponential as its epilogue, and K is written once, as float4
// where M allows, never read back.
//
// One block of 256 threads computes a 64-row x 128-column tile of one GP's
// K.  x and z pass through shared memory 16 columns of d at a time, divided
// by the GP's lengthscale on the way in (no scaled copy of x in device
// memory), stored transposed so that a thread reads its 4 rows and 8
// columns as float4.  Each thread accumulates its 4 x 8 cross products in
// registers; threads 0-63 and 64-191 accumulate the rows' and columns'
// squared norms from the same staged values.  Ragged edges of R, M and d
// are masked (zero-padded in shared memory, not stored).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BR = 64;        // rows of K per block
constexpr int BM = 128;       // columns (inducing points) per block
constexpr int DK = 16;        // columns of d staged per round
constexpr int THREADS = 256;  // 16 column groups x 16 row groups
constexpr int XS = BR + 4;    // padded row lengths of the transposed tiles,
constexpr int ZS = BM + 4;    // multiples of 4 floats for float4 reads

__global__ void __launch_bounds__(THREADS)
rbf_cross_kernel(const float* __restrict__ x, const float* __restrict__ z,
                 const float* __restrict__ ls, const float* __restrict__ os,
                 float* __restrict__ out, int R, int M, int d) {
  __shared__ __align__(16) float xt[DK][XS];
  __shared__ __align__(16) float zt[DK][ZS];
  __shared__ float x2s[BR];
  __shared__ float z2s[BM];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid >> 4;  // rows ty*4 .. +3
  const int r0 = blockIdx.x * BR;
  const int m0 = blockIdx.y * BM;
  const int g = blockIdx.z;
  const float* zg = z + (size_t)g * M * d;
  const float* lsg = ls + (size_t)g * d;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float norm = 0.f;  // row tid (tid < BR) or column tid - BR (tid < BR + BM)

  for (int k0 = 0; k0 < d; k0 += DK) {
    // stage: consecutive threads read consecutive columns of d
    for (int e = tid; e < BR * DK; e += THREADS) {
      const int rr = e / DK, kk = e % DK;
      const int r = r0 + rr, k = k0 + kk;
      xt[kk][rr] = (r < R && k < d) ? x[(size_t)r * d + k] / lsg[k] : 0.f;
    }
    for (int e = tid; e < BM * DK; e += THREADS) {
      const int mm = e / DK, kk = e % DK;
      const int m = m0 + mm, k = k0 + kk;
      zt[kk][mm] = (m < M && k < d) ? zg[(size_t)m * d + k] / lsg[k] : 0.f;
    }
    __syncthreads();

    if (tid < BR) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        norm = fmaf(xt[kk][tid], xt[kk][tid], norm);
    } else if (tid < BR + BM) {
      const int c = tid - BR;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        norm = fmaf(zt[kk][c], zt[kk][c], norm);
    }

#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xt[kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&zt[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&zt[kk][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BR)
    x2s[tid] = norm;
  else if (tid < BR + BM)
    z2s[tid - BR] = norm;
  __syncthreads();

  const float osg = os[g];
  const bool vec = (M & 3) == 0;  // rows start on 16-byte boundaries
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty * 4 + i;
    const int r = r0 + rr;
    if (r >= R) break;
    float* orow = out + ((size_t)g * R + r) * M;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cc = half * 64 + tx * 4;
      const int m = m0 + cc;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d2 =
            fmaxf(x2s[rr] + z2s[cc + j] - 2.f * acc[i][half * 4 + j], 0.f);
        v[j] = osg * expf(-0.5f * d2);
      }
      if (vec && m + 3 < M) {
        *reinterpret_cast<float4*>(orow + m) = make_float4(v[0], v[1], v[2],
                                                           v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (m + j < M) orow[m + j] = v[j];
      }
    }
  }
}

}  // namespace

extern "C" {

// x (R, d) raw points shared by the G GPs; z (G, M, d) inducing points;
// ls (G, d) lengthscales; os (G,) outputscales; out (G, R, M).  All
// contiguous fp32.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an empty or oversized shape).
int rbf_cross_fwd(const float* x, const float* z, const float* ls,
                  const float* os, float* out, int R, int M, int d, int G,
                  void* stream) {
  if (R < 1 || M < 1 || d < 1 || G < 1 || G > 65535 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + BR - 1) / BR, (M + BM - 1) / BM, G);
  rbf_cross_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, z, ls, os,
                                                               out, R, M, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
