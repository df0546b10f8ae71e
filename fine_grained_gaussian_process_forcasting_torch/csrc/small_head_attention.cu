// Softmax attention for head dims d <= 8, forward and backward, fp32 -- for
// sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/
//   small_head_attention.py `_fwd_kernel` (reached through
//   `small_head_attention`, `_fwd`) and `_bwd_kernel` (through `_bwd`):
//   per (batch, head), o = softmax(q k^T / sqrt(d)) v, and its VJP
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dP o P)),
//     dQ = dS K / sqrt(d),  dK = dS^T Q / sqrt(d).
//
// The TPU kernel lays each operand out (d, L) and builds the scores as d
// rank-1 outer products on the vector unit, so that its matrix unit never
// pads a 4-wide contraction to 128 lanes; it groups 8 (batch, head) pairs per
// program to amortise the program's overhead.  On Hopper neither concern
// exists: a thread has no lanes to fill, and a block is cheap.
//
// What bounds it on an H100: the instructions a (query, key) pair, issued at
// 4 warp instructions a clock an SM.  The function is 4d + 3 flops and one
// exponential a pair forward, 10d + 3 flops and one exponential backward;
// memory is not the limit (the enc-self call, b 256, h 8, L 192, moves 25
// MB and has 75.5 M pairs), and the special-function units (16 exp2 a clock
// an SM, against 128 issue slots) need three quarters of the forward's
// issue time at d 4 and a third of the backward's.  So both kernels count
// the instructions a pair, with every loop over d unrolled (d is a template
// parameter, 1..8: no padding, no masked lanes):
//
// Forward (`fwd_kernel`): a block is one (batch, head) pair; K and V are
// staged into shared memory as one flat copy (up to 48 KB of keys a
// chunk; one chunk at every flagship call), and a warp owns R query rows a
// lane (R = 6 where d <= 4 and a head has more than 96 rows, so that
// 192-row heads take one warp; else 3), each key broadcast from shared
// memory to the warp and used by the R rows.  The online softmax keeps a
// lazy offset instead of a running max: each row's offset starts at its
// score of key 0 (so the row sum stays >= 1), and a group of G = 4 keys
// takes its probabilities exp2(s - offset), with the offset folded into the
// first FFMA of each score, and their products with v; only then, with no
// branch between the exponentials and the products, does a row whose group
// summed past 2^8 (or to an inf or NaN) take the group's max as its new
// offset and rescale its sums -- or restart them at the group where what it
// summed before no longer counts at the new offset, which also drops an
// exponential that overflowed.  Between rescales every exponential's
// argument stays at most 8 (an exact running max keeps it at most 0, at the
// same rounding); only a group that jumps past the threshold is taken at a
// larger one (at most log2 of the row's sum + 26), within a few ulp.  A
// pair costs d FFMA + ex2 + FADD + d FFMA, plus 2 / R shared-memory loads
// and, a group, one FADD and one compare a row (10.6 instructions a pair
// at d 4, R 6, scripts/head_folded_routes.py).  The groups' sums gather
// in a second sum a row that enters the row sum every FWD_FOLD groups: added
// a group at a time, a row sum near 1 that takes many small groups (one key
// far above 280 others) drifts by roundings of one sign, 5e-6 of itself,
// which the backward's D = rowsum(dO o O) carries into dQ.
// The row's log-sum-exp (natural log) is written for training.
//
// Backward (`bwd_fused_kernel`): one launch, each exponential computed
// once, where a head's rows fit on chip (FUSED_SMEM).  A block is one warp
// and one (batch, head) pair: it stages q (scaled by log2(e)/sqrt(d)), dO
// and (lse in base 2, D = rowsum(dO o O)) of all rows in shared memory, and
// its lanes own RK keys each (k, v, dK and dV in registers; RK = 6 where d
// <= 4 and the head has more than 96 keys, else 3; d > 4: 3 or 2) and walk
// every row.  dQ's sum over the keys needs no reduction across lanes: in a
// block of 32 rows the lanes take the rows in rotation (lane l row l + j at
// step j), add their keys' dS K to a running dQ row in registers, and pass
// it one lane down (d shuffles a step); after 32 steps each lane holds one
// row's sum over the warp's keys, added to shared memory once a block of
// rows.  A pair costs 5d FFMA/FMUL + ex2 + 1; a step adds 3 loads and d
// shuffles over RK pairs (24.7 instructions a pair at d 4, RK 6).  Heads
// with more keys than 32 RK take the key chunks in turn.
//
// Where a head's rows do not fit, the backward streams them in two
// launches (`bwd_dq_kernel`, `bwd_dkv_kernel`, the port's first design):
// query-parallel (D and dQ) and key-parallel (dK and dV), one thread a row,
// up to 512 rows staged a time, each exponential computed once in each.
//
// No atomics anywhere and every sum in a fixed order: two runs give the same
// bits.  The exponentials are `ex2.approx.ftz` (the streamed route's
// `exp2f`).
//
// `PROBE` switches of the kernel bodies, for the timing probe
// (scripts/head_folded_routes.cu, which includes this file); the kernels
// here run them with 0.  Their results are not the function's.

#include <cuda_runtime.h>
#include <math.h>

#include <initializer_list>

namespace small_head {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// one bit each
constexpr int NO_EXP = 1;     // exp2 of each score replaced by the score
constexpr int NO_CHECK = 2;   // forward: no test of the group's sums
constexpr int NO_ROTATE = 4;  // backward: dQ's running rows not passed on

// kernels this library has launched, counted at each launch statement
static unsigned long long kernels_launched = 0;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D consecutive floats at p, 16-byte aligned where D % 4 == 0, 8-byte
// where D == 2
template <int D>
__device__ __forceinline__ void load_vec(const float* p, float (&r)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      r[c] = x.x, r[c + 1] = x.y, r[c + 2] = x.z, r[c + 3] = x.w;
    }
  } else if constexpr (D == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x, r[1] = x.y;
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) r[c] = p[c];
  }
}

template <int D>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(r[c], r[c + 1], r[c + 2], r[c + 3]);
  } else if constexpr (D == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) p[c] = r[c];
  }
}

// n floats from src into shared memory, the block's threads in turn, 16
// bytes a load where D % 4 == 0
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  if constexpr (D % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
  }
}

// ---------------------------------------------------------------- forward

constexpr int FWD_G = 4;              // keys a group
constexpr float FWD_LIMIT = 256.f;    // 2^8: a group's sum before a rescale
constexpr int FWD_FOLD = 16;          // groups summed apart before the row sum
constexpr float FWD_KEEP = 1.f / (1 << 26);  // mass that a restart keeps
constexpr int FWD_MAX_WARPS = 8;      // warps a block, at most

template <int D>
struct FwdShape {
  static constexpr int KC = 6144 / D;  // keys a chunk: K and V in 48 KB
  // rows a lane: 6 fill a warp with a 192-row head at d <= 4
  static constexpr int R_BIG = D <= 4 ? 6 : 3;
};

struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int Lq, Lk;
  int kc;   // keys a chunk
  int wpb;  // warps a block
  float q_scale;  // log2(e) / sqrt(d)
};

// The row's rare path, after a group whose probabilities summed past
// FWD_LIMIT (or to an inf or a NaN): the group's max score gm lies above the
// offset m.  Where what the row summed before the group still counts at the
// new offset (l_before 2^(m - gm) >= 2^-26), the sums are rescaled to it: the
// group's own probabilities were taken at arguments of at most log2(l_before)
// + 26 <= 45, finite and within a few ulp.  Where it does not count, the
// sums restart at the group, taken again against gm: that also drops what an
// exponential past 2^127 made inf or NaN.
template <int D, int R, bool FULL>
__device__ __forceinline__ void fwd_rescale(const float* __restrict__ ks,
                                            const float* __restrict__ vs,
                                            int t0, int n, int i,
                                            const float (&qr)[R][D],
                                            float (&acc)[R][D], float (&l)[R],
                                            float (&lb)[R], float (&m)[R],
                                            float g) {
  l[i] += lb[i];  // the row sum, this group's included
  lb[i] = 0.f;
  float gm = -INFINITY;
#pragma unroll
  for (int j = 0; j < FWD_G; ++j) {
    if (!FULL && t0 + j >= n) continue;
    float kk[D];
    load_vec<D>(ks + (t0 + j) * D, kk);
    float s = qr[i][0] * kk[0];
#pragma unroll
    for (int c = 1; c < D; ++c) s = fmaf(qr[i][c], kk[c], s);
    gm = fmaxf(gm, s);
  }
  const float mn = fmaxf(m[i], gm);
  const float sc = ex2(m[i] - mn);
  if ((l[i] - g) * sc >= FWD_KEEP) {
    l[i] *= sc;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[i][c] *= sc;
  } else {
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[i][c] = 0.f;
#pragma unroll
    for (int j = 0; j < FWD_G; ++j) {
      if (!FULL && t0 + j >= n) continue;
      float kk[D], vv[D];
      load_vec<D>(ks + (t0 + j) * D, kk);
      load_vec<D>(vs + (t0 + j) * D, vv);
      float x = -mn;
#pragma unroll
      for (int c = 0; c < D; ++c) x = fmaf(qr[i][c], kk[c], x);
      const float p = ex2(x);
      l[i] += p;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
    }
  }
  m[i] = mn;
}

// One group of G keys t0 .. t0 + G - 1 (FULL: all below n; else the rest
// are left out): the probabilities against the rows' offsets, their
// products with v and their sums, then the test of the sums and the rare
// rescale.  No branch lies between the exponentials and their products.
template <int D, int R, bool FULL, int PROBE>
__device__ __forceinline__ void fwd_group(const float* __restrict__ ks,
                                          const float* __restrict__ vs, int t0,
                                          int n, const float (&qr)[R][D],
                                          float (&acc)[R][D], float (&l)[R],
                                          float (&lb)[R], float (&m)[R]) {
  constexpr int G = FWD_G;
  float p[R][G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const bool ok = FULL || t0 + j < n;
    float kk[D];
    load_vec<D>(ks + (ok ? t0 + j : 0) * D, kk);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float x = -m[i];
#pragma unroll
      for (int c = 0; c < D; ++c) x = fmaf(qr[i][c], kk[c], x);
      const float e = (PROBE & NO_EXP) ? x : ex2(x);
      p[i][j] = ok ? e : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const bool ok = FULL || t0 + j < n;
    float vv[D];
    load_vec<D>(vs + (ok ? t0 + j : 0) * D, vv);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < D; ++c) acc[i][c] = fmaf(p[i][j], vv[c], acc[i][c]);
    }
  }
  float g[R];
  bool over = false;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    g[i] = p[i][0];
#pragma unroll
    for (int j = 1; j < G; ++j) g[i] += p[i][j];
    lb[i] += g[i];
    over |= !(g[i] <= FWD_LIMIT);
  }
  if (!(PROBE & NO_CHECK) && over) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (!(g[i] <= FWD_LIMIT))
        fwd_rescale<D, R, FULL>(ks, vs, t0, n, i, qr, acc, l, lb, m, g[i]);
  }
}

template <int D, int R, int PROBE>
__device__ __forceinline__ void fwd_body(const FwdArgs& a) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;             // [kc][D]
  float* vs = smem + a.kc * D;  // [kc][D]
  const long long bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = (blockIdx.y * a.wpb + warp) * 32 * R;  // the warp's rows
  const bool live = first < a.Lq;
  const float* kb = a.k + bh * a.Lk * D;
  const float* vb = a.v + bh * a.Lk * D;

  // l the row sum; lb the sums of the groups since it last took them
  float qr[R][D], acc[R][D], l[R], lb[R], m[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = first + 32 * i + lane;
    if (row < a.Lq) {
      load_vec<D>(a.q + (bh * a.Lq + row) * D, qr[i]);
#pragma unroll
      for (int c = 0; c < D; ++c) qr[i][c] *= a.q_scale;
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) qr[i][c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < D; ++c) acc[i][c] = 0.f;
    l[i] = lb[i] = 0.f;
  }

  for (int k0 = 0; k0 < a.Lk; k0 += a.kc) {
    const int n = min(a.kc, a.Lk - k0);
    if (k0 > 0) __syncthreads();  // the previous chunk is consumed
    stage<D>(ks, kb + (long long)k0 * D, n * D);
    stage<D>(vs, vb + (long long)k0 * D, n * D);
    __syncthreads();
    if (!live) continue;
    if (k0 == 0) {  // each row's offset: its score of key 0
      float kk[D];
      load_vec<D>(ks, kk);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float s = qr[i][0] * kk[0];
#pragma unroll
        for (int c = 1; c < D; ++c) s = fmaf(qr[i][c], kk[c], s);
        m[i] = s;
      }
    }
    int t0 = 0;
    while (t0 + FWD_G <= n) {
      const int last = min(n - FWD_G, t0 + (FWD_FOLD - 1) * FWD_G);
      for (; t0 <= last; t0 += FWD_G)
        fwd_group<D, R, true, PROBE>(ks, vs, t0, n, qr, acc, l, lb, m);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        l[i] += lb[i];
        lb[i] = 0.f;
      }
    }
    if (t0 < n)
      fwd_group<D, R, false, PROBE>(ks, vs, t0, n, qr, acc, l, lb, m);
  }
  if (!live) return;

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = first + 32 * i + lane;
    if (row >= a.Lq) continue;
    l[i] += lb[i];
    const float inv = 1.f / l[i];
    float out[D];
#pragma unroll
    for (int c = 0; c < D; ++c) out[c] = acc[i][c] * inv;
    store_vec<D>(a.o + (bh * a.Lq + row) * D, out);
    a.lse[bh * a.Lq + row] = (m[i] + log2f(l[i])) * LN2;
  }
}

template <int D, int R>
__global__ void __launch_bounds__(FWD_MAX_WARPS * 32, 2)
fwd_kernel(const FwdArgs a) {
  fwd_body<D, R, 0>(a);
}

// the launch's shape: grid (BH, row blocks), wpb warps of 32 R rows each
template <int D, int R>
dim3 fwd_grid(FwdArgs& a, int BH, size_t* smem) {
  const int slabs = (a.Lq + 32 * R - 1) / (32 * R);
  const int by = (slabs + FWD_MAX_WARPS - 1) / FWD_MAX_WARPS;
  a.wpb = (slabs + by - 1) / by;
  a.kc = a.Lk < FwdShape<D>::KC ? a.Lk : FwdShape<D>::KC;
  *smem = 2 * (size_t)a.kc * D * sizeof(float);
  return dim3((unsigned)BH, (unsigned)by);
}

template <int D, int R>
int launch_fwd_r(FwdArgs a, int BH, cudaStream_t stream) {
  size_t smem;
  const dim3 grid = fwd_grid<D, R>(a, BH, &smem);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  fwd_kernel<D, R><<<grid, a.wpb * 32, smem, stream>>>(a);
  ++kernels_launched;
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd(const FwdArgs& a, int BH, cudaStream_t stream) {
  if (FwdShape<D>::R_BIG != 3 && a.Lq > 96)
    return launch_fwd_r<D, FwdShape<D>::R_BIG>(a, BH, stream);
  return launch_fwd_r<D, 3>(a, BH, stream);
}

// ------------------------------------------------------- backward, fused

// a head's rows staged for the fused route, at most (q, dO, dQ and (lse,
// D) of every row)
constexpr long long FUSED_SMEM = 64 * 1024;

template <int D>
struct BwdShape {
  // keys a lane: the larger where a head has more than 96 (d > 4: 64) keys
  static constexpr int RK_BIG = D <= 4 ? 6 : 3;
  static constexpr int RK_SMALL = D <= 4 ? 3 : 2;
  // one-warp blocks an SM the registers are budgeted for: 16 (128
  // registers) hold the flagship's 2048 heads in one wave
  static constexpr int MIN_BLOCKS = D <= 4 ? 16 : 8;
};

__host__ __device__ inline int padded32(int n) { return (n + 31) / 32 * 32; }

__host__ __device__ inline long long fused_bytes(int Lq, int d) {
  return 4LL * padded32(Lq) * (3 * d + 2);
}

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* lse;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* delta;  // (BH, Lq) scratch of the streamed route
  int Lq, Lk;
  float q_scale;  // log2(e) / sqrt(d)
  float scale;    // 1 / sqrt(d)
};

template <int D, int RK, bool FULL, int PROBE>
__device__ __forceinline__ void bwd_fused_body(const BwdArgs& a) {
  extern __shared__ __align__(16) float smem[];
  const int Lp = padded32(a.Lq);
  float* qs = smem;                  // [Lp][D], q * log2(e) / sqrt(d)
  float* dos = qs + Lp * D;          // [Lp][D]
  float* dqs = dos + Lp * D;         // [Lp][D], dQ over the chunks so far
  float2* ld = reinterpret_cast<float2*>(dqs + Lp * D);  // [Lp]
  const long long bh = blockIdx.x;
  const int lane = threadIdx.x;
  const long long row_base = bh * a.Lq;

  // the rows; padded rows get lse +inf, so that their probabilities are 0
  for (int r = lane; r < Lp; r += 32) {
    float qv[D], dov[D];
    float dd = 0.f, l2 = INFINITY;
    if (r < a.Lq) {
      float ov[D];
      load_vec<D>(a.q + (row_base + r) * D, qv);
      load_vec<D>(a.dout + (row_base + r) * D, dov);
      load_vec<D>(a.o + (row_base + r) * D, ov);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        qv[c] *= a.q_scale;
        dd = fmaf(dov[c], ov[c], dd);
      }
      l2 = a.lse[row_base + r] * LOG2E;
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) qv[c] = dov[c] = 0.f;
    }
    store_vec<D>(qs + r * D, qv);
    store_vec<D>(dos + r * D, dov);
    ld[r] = make_float2(l2, dd);
  }
  __syncwarp();

  constexpr int KW = 32 * RK;  // keys a chunk
  const int chunks = (a.Lk + KW - 1) / KW;
  for (int kc = 0; kc < chunks; ++kc) {
    float kr[RK][D], vr[RK][D], dka[RK][D], dva[RK][D];
    bool kok[RK];
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int key = kc * KW + i * 32 + lane;
      kok[i] = key < a.Lk;
      if (kok[i]) {
        load_vec<D>(a.k + (bh * a.Lk + key) * D, kr[i]);
        load_vec<D>(a.v + (bh * a.Lk + key) * D, vr[i]);
      } else {
#pragma unroll
        for (int c = 0; c < D; ++c) kr[i][c] = vr[i][c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < D; ++c) dka[i][c] = dva[i][c] = 0.f;
    }
    for (int rb = 0; rb < Lp; rb += 32) {
      // dQ of the row the lane takes next, summed over the keys of the
      // lanes that took it before
      float dqa[D];
#pragma unroll
      for (int c = 0; c < D; ++c) dqa[c] = 0.f;
#pragma unroll 2
      for (int j = 0; j < 32; ++j) {
        const int r = rb + ((lane + j) & 31);
        float qv[D], dov[D];
        load_vec<D>(qs + r * D, qv);
        load_vec<D>(dos + r * D, dov);
        const float2 lv = ld[r];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          float s = -lv.x;
#pragma unroll
          for (int c = 0; c < D; ++c) s = fmaf(qv[c], kr[i][c], s);
          float p = (PROBE & NO_EXP) ? s : ex2(s);
          if (!FULL) p = kok[i] ? p : 0.f;
          float dp = -lv.y;
#pragma unroll
          for (int c = 0; c < D; ++c) dp = fmaf(dov[c], vr[i][c], dp);
          const float ds = p * dp;
#pragma unroll
          for (int c = 0; c < D; ++c) {
            dva[i][c] = fmaf(p, dov[c], dva[i][c]);
            dka[i][c] = fmaf(ds, qv[c], dka[i][c]);
            dqa[c] = fmaf(ds, kr[i][c], dqa[c]);
          }
        }
        // the running row passes one lane down: lane l takes row l + j + 1
        // next, which lane l + 1 held
        if (!(PROBE & NO_ROTATE)) {
#pragma unroll
          for (int c = 0; c < D; ++c)
            dqa[c] = __shfl_sync(0xffffffffu, dqa[c], (lane + 1) & 31);
        }
      }
      // after 32 steps lane l holds row rb + l, over all the chunk's keys
      float* dst = dqs + (rb + lane) * D;
      if (kc > 0) {
        float prev[D];
        load_vec<D>(dst, prev);
#pragma unroll
        for (int c = 0; c < D; ++c) dqa[c] += prev[c];
      }
      store_vec<D>(dst, dqa);
    }
    // dK = sum dS q / sqrt(d): the q here carries log2(e) / sqrt(d)
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      if (!kok[i]) continue;
      const long long at = (bh * a.Lk + kc * KW + i * 32 + lane) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) dka[i][c] *= LN2;
      store_vec<D>(a.dk + at, dka[i]);
      store_vec<D>(a.dv + at, dva[i]);
    }
  }
  __syncwarp();
  for (int r = lane; r < a.Lq; r += 32) {
    float out[D];
    load_vec<D>(dqs + r * D, out);
#pragma unroll
    for (int c = 0; c < D; ++c) out[c] *= a.scale;
    store_vec<D>(a.dq + (row_base + r) * D, out);
  }
}

template <int D, int RK, bool FULL>
__global__ void __launch_bounds__(32, BwdShape<D>::MIN_BLOCKS)
bwd_fused_kernel(const BwdArgs a) {
  bwd_fused_body<D, RK, FULL, 0>(a);
}

template <int D, int RK>
int launch_bwd_fused_rk(const BwdArgs& a, int BH, cudaStream_t stream) {
  const long long bytes = fused_bytes(a.Lq, D);
  const bool full = a.Lk % (32 * RK) == 0;
  auto kernel = full ? bwd_fused_kernel<D, RK, true>
                     : bwd_fused_kernel<D, RK, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)BH, 32, (size_t)bytes, stream>>>(a);
  ++kernels_launched;
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_fused(const BwdArgs& a, int BH, cudaStream_t stream) {
  using S = BwdShape<D>;
  if (a.Lk > 32 * S::RK_SMALL)
    return launch_bwd_fused_rk<D, S::RK_BIG>(a, BH, stream);
  return launch_bwd_fused_rk<D, S::RK_SMALL>(a, BH, stream);
}

// --------------------------------------------- backward, streamed route

constexpr int ROWS = 64;    // query (or key) rows per block, one per thread
constexpr int STAGE = 512;  // keys (or queries) staged in shared memory

// rows [r0, r0 + n) of a contiguous (L, D) matrix into shared memory, as one
// flat copy, each value times `scale`
template <int D>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int r0, int n, float scale) {
  const float* from = src + (size_t)r0 * D;
  for (int i = threadIdx.x; i < n * D; i += ROWS) dst[i] = from[i] * scale;
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D],
                                     const float* __restrict__ b) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) s = fmaf(a[j], b[j], s);
  return s;
}

// 1. query-parallel: D = rowsum(dO o O), then dQ
template <int D>
__global__ void __launch_bounds__(ROWS)
bwd_dq_kernel(const BwdArgs a, int stage) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + stage * D;

  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;
  const bool live = row < a.Lq;
  const float* kb = a.k + bh * a.Lk * D;
  const float* vb = a.v + bh * a.Lk * D;
  const size_t at = (bh * a.Lq + row) * D;

  float qr[D], dor[D], acc[D];
  float dsum = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    qr[j] = live ? a.q[at + j] * a.q_scale : 0.f;
    dor[j] = live ? a.dout[at + j] : 0.f;
    dsum = fmaf(dor[j], live ? a.o[at + j] : 0.f, dsum);
    acc[j] = 0.f;
  }
  const float lse2 = live ? a.lse[bh * a.Lq + row] * LOG2E : 0.f;

  for (int k0 = 0; k0 < a.Lk; k0 += stage) {
    const int n = min(stage, a.Lk - k0);
    if (k0 > 0) __syncthreads();
    stage_rows<D>(ks, kb, k0, n, 1.f);
    stage_rows<D>(vs, vb, k0, n, 1.f);
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float* kt = ks + t * D;
      const float s = dot<D>(qr, kt);
      const float dp = dot<D>(dor, vs + t * D);
      const float ds = exp2f(s - lse2) * (dp - dsum);
#pragma unroll
      for (int j = 0; j < D; ++j) acc[j] = fmaf(ds, kt[j], acc[j]);
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < D; ++j) a.dq[at + j] = acc[j] * a.scale;
    a.delta[bh * a.Lq + row] = dsum;
  }
}

// 2. key-parallel: dK and dV
template <int D>
__global__ void __launch_bounds__(ROWS)
bwd_dkv_kernel(const BwdArgs a, int stage) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [stage][D], q * q_scale
  float* dos = smem + stage * D;       // [stage][D]
  float* lses = smem + 2 * stage * D;  // [stage], base 2
  float* dels = lses + stage;          // [stage]

  const size_t bh = blockIdx.x;
  const int row = blockIdx.y * ROWS + threadIdx.x;  // key row
  const bool live = row < a.Lk;
  const float* qb = a.q + bh * a.Lq * D;
  const float* dob = a.dout + bh * a.Lq * D;
  const size_t at = (bh * a.Lk + row) * D;

  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    kr[j] = live ? a.k[at + j] : 0.f;
    vr[j] = live ? a.v[at + j] : 0.f;
    dka[j] = 0.f;
    dva[j] = 0.f;
  }

  for (int q0 = 0; q0 < a.Lq; q0 += stage) {
    const int n = min(stage, a.Lq - q0);
    if (q0 > 0) __syncthreads();
    stage_rows<D>(qs, qb, q0, n, a.q_scale);
    stage_rows<D>(dos, dob, q0, n, 1.f);
    for (int i = threadIdx.x; i < n; i += ROWS) {
      lses[i] = a.lse[bh * a.Lq + q0 + i] * LOG2E;
      dels[i] = a.delta[bh * a.Lq + q0 + i];
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float* qt = qs + t * D;
      const float* dot_ = dos + t * D;
      const float s = dot<D>(kr, qt);
      const float dp = dot<D>(vr, dot_);
      const float p = exp2f(s - lses[t]);
      const float ds = p * (dp - dels[t]);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        dva[j] = fmaf(p, dot_[j], dva[j]);
        dka[j] = fmaf(ds, qt[j], dka[j]);
      }
    }
  }

  if (live) {
    // dka holds sum ds * q * q_scale; dK wants sum ds * q * scale
    const float to_dk = a.scale / a.q_scale;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      a.dk[at + j] = dka[j] * to_dk;
      a.dv[at + j] = dva[j];
    }
  }
}

template <int D>
int launch_bwd_streamed(const BwdArgs& a, int BH, cudaStream_t stream) {
  if ((a.Lq + ROWS - 1) / ROWS > 65535 || (a.Lk + ROWS - 1) / ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  const int stage_k = min(STAGE, a.Lk);
  bwd_dq_kernel<D><<<dim3(BH, (a.Lq + ROWS - 1) / ROWS), ROWS,
                     2 * (size_t)stage_k * D * sizeof(float), stream>>>(
      a, stage_k);
  ++kernels_launched;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int stage_q = min(STAGE, a.Lq);
  bwd_dkv_kernel<D><<<dim3(BH, (a.Lk + ROWS - 1) / ROWS), ROWS,
                      (size_t)stage_q * (2 * D + 2) * sizeof(float),
                      stream>>>(a, stage_q);
  ++kernels_launched;
  return (int)cudaGetLastError();
}

// the backward's route: the fused one-launch route where a head's rows fit
inline bool bwd_fused(int Lq, int d) { return fused_bytes(Lq, d) <= FUSED_SMEM; }

template <int D>
int launch_bwd(const BwdArgs& a, int BH, cudaStream_t stream) {
  return bwd_fused(a.Lq, D) ? launch_bwd_fused<D>(a, BH, stream)
                            : launch_bwd_streamed<D>(a, BH, stream);
}

// every operand 16-byte aligned, as the vector loads take them
inline bool aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((size_t)p % 16) return false;
  return true;
}

}  // namespace small_head

#define SMALL_HEAD_DISPATCH(CALL)          \
  switch (d) {                             \
    case 1: return CALL(1);                \
    case 2: return CALL(2);                \
    case 3: return CALL(3);                \
    case 4: return CALL(4);                \
    case 5: return CALL(5);                \
    case 6: return CALL(6);                \
    case 7: return CALL(7);                \
    case 8: return CALL(8);                \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// q (BH, Lq, d), k and v (BH, Lk, d), o (BH, Lq, d), all contiguous fp32
// and 16-byte aligned; lse (BH, Lq): the natural-log log-sum-exp of each
// row's scaled scores, for the backward.  1 <= d <= 8, Lq >= 1, Lk >= 1,
// BH >= 1.  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a shape or an alignment it does not take).
int small_head_attention_fwd(const float* q, const float* k, const float* v,
                             float* o, float* lse, int BH, int Lq, int Lk,
                             int d, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 || !small_head::aligned({q, k, v, o}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const small_head::FwdArgs a{q, k, v, o, lse, Lq, Lk, 0, 0,
                              small_head::LOG2E / sqrtf((float)d)};
#define FWD(D) small_head::launch_fwd<D>(a, BH, s)
  SMALL_HEAD_DISPATCH(FWD)
#undef FWD
}

// The VJP: q, k, v, o, lse as the forward saw and wrote them, dout (BH, Lq,
// d) the cotangent of o; writes dq (BH, Lq, d), dk and dv (BH, Lk, d), and
// uses delta (BH, Lq) as scratch where the head's rows do not fit on chip.
// All contiguous and 16-byte aligned.  Returns the first failure.
int small_head_attention_bwd(const float* q, const float* k, const float* v,
                             const float* o, const float* lse,
                             const float* dout, float* dq, float* dk,
                             float* dv, float* delta, int BH, int Lq, int Lk,
                             int d, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 ||
      !small_head::aligned({q, k, v, o, dout, dq, dk, dv}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float scale = 1.f / sqrtf((float)d);
  const small_head::BwdArgs a{q,  k,  v,  o,  lse, dout, dq,
                              dk, dv, delta, Lq, Lk, small_head::LOG2E * scale,
                              scale};
#define BWD(D) small_head::launch_bwd<D>(a, BH, s)
  SMALL_HEAD_DISPATCH(BWD)
#undef BWD
}

// The backward's kernel launches for a head of Lq rows at head dim d: 1 (the
// fused route) or 2 (streamed).
int small_head_attention_bwd_launches(int Lq, int d) {
  return small_head::bwd_fused(Lq, d) ? 1 : 2;
}

// The kernels the entries above have launched since the library was loaded.
unsigned long long small_head_attention_kernels_launched() {
  return small_head::kernels_launched;
}

}  // extern "C"
