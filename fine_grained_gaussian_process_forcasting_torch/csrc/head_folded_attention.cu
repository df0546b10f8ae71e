// Softmax attention for small head dims, forward and backward, fp32 -- for
// sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/
//   head_folded_attention.py:108 (`_fwd`, the `pl.pallas_call` of
//   `_fwd_kernel`) and :139 (`_bwd`, of `_bwd_kernel`): per (batch, head),
//   out = softmax(q k^T / sqrt(d)) v with the (Lq, Lk) scores kept on chip,
//   and its VJP
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dP o P)),
//     dQ = dS K / sqrt(d),  dK = dS^T Q / sqrt(d).
//   The TPU kernel took its operands as (b, L, h d), all heads of a sample
//   in one grid cell.  These kernels take (b, h, L, d) views with any
//   strides on b, h and L (d's stride 1), so they read and write the
//   projections' own (b, L, h, d) buffers in place: no copy on either side.
//
// What bounds it on an H100: not memory -- the flagship's enc-self call (b
// 256, h 8, L 192) moves 25 MB but evaluates 75.5 M (query, key) pairs --
// and not the exponentials (16 exp2 a clock an SM; taking them out saves
// 1-5 %, scripts/head_folded_routes.py): the instructions a pair, d FFMA a
// product at d = 4, and the shared-memory loads that feed them.  Both
// kernels reach about 40-55 % of the issue rate (4 warp instructions a
// clock an SM) at the flagship's shapes; the design counts instructions a
// pair and keeps every global access in whole rows.
//
// Forward (`fwd_kernel`): a block holds up to 8 heads of one sample (a
// warp a head, HB x DP <= 32 floats of each key row) and 96 query rows of
// each at d <= 8 (R = 3 rows a thread: 192 and 96 rows are whole blocks);
// K and V are staged as (keys, heads, DP) panels, read from the (L, h d)
// rows in whole lines, 192 keys at a time, and every key is broadcast from
// shared memory to the warp.  q comes in, and the output goes out, through
// the same shared memory as a (rows, heads, DP) tile, in whole rows too: a
// thread's own rows are 16 bytes each at d 4, one 128-byte line apart, and
// loads and stores that scatter so cost the forward 9-20 % of its time.
// The online softmax takes its max over a group of G = 4 keys before their
// exponentials: the group's scores (q scaled by log2(e)/sqrt(d) once),
// their max, one rescale of the rows whose max rose, then exp2 on the
// special-function units and the products with v.  A pair costs d FFMA +
// FMNMX + FADD + ex2 + FADD + d FFMA.  For training the row's log-sum-exp
// is written too.
//
// Backward (`bwd_fused_kernel`): where a head fits on chip (d <= 16, Lq <=
// 256) one launch computes each exponential once.  A block holds HB heads
// of a sample: q (scaled by log2(e)/sqrt(d)), dO, lse (base 2) and D =
// rowsum(dO o O) of all Lq rows in shared memory, D computed while staging.
// A warp owns 32 RK keys of a head (RK = 3 at d <= 4: k, v, dK and dV in
// registers, a lane's keys its own) and walks every query row, 32 / DP rows
// a step: P = exp2(q.k - lse) once, dP = dO.v - D, dS = P dP, dV += P dO,
// dK += dS q in registers; dQ's sum over the warp's keys is a reduce-scatter
// across the lanes (31 shuffles and adds a step; each lane keeps the step's
// rows in slots permuted by its own row bits, so that the row levels need
// no select, and the d 4 dims in order, two levels with selects), and lane
// l writes element l of the step's (rows, DP) tile to the warp's partial in
// shared memory.  After all warps, dQ is the sum of the warps' partials in
// warp order, and dK and dV leave through shared memory as (keys, heads,
// DP) tiles, in whole rows (scattered, their 16-byte rows cost the backward
// 15-34 % of its time).  No atomics; every sum in a fixed order, so reruns
// are bit-equal.  A pair costs 21 FP32 instructions + 1 ex2, a step's
// reduce-scatter about 70 over 24 pairs (d 4).
//
// Where a head does not fit (Lq > 256 or d > 16), the backward streams it in
// two launches, as the port's first kernel did: query-parallel (D and dQ)
// and key-parallel (dK and dV), one thread a row, 64-row chunks through
// shared memory, each exponential computed once in each.
//
// The head dim is padded in registers and shared memory to a compile-time
// DP in {4, 8, 16, 32, 64} with zeros, which leaves every sum unchanged; any
// 1 <= d < 64 is taken, Lq != Lk (cross-attention) is just two lengths, and
// tail rows and keys are masked, never padded in device memory.  Scores are
// kept in base 2 (q scaled by log2(e)/sqrt(d) once), the exponentials are
// `ex2.approx.ftz` (the streamed backward's `exp2f`), and the lse leaves the
// kernels in natural log.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// element strides of a (b, h, L, d) view; d's stride is 1
struct Str {
  long long b, h, l;
};

__device__ __forceinline__ const float* row_of(const float* base, const Str& s,
                                               int b, int h, int l) {
  return base + b * s.b + h * s.h + l * s.l;
}

__device__ __forceinline__ float* row_of(float* base, const Str& s, int b,
                                         int h, int l) {
  return base + b * s.b + h * s.h + l * s.l;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- forward

constexpr int FWD_WARPS = 8;

// `probe` switches of the kernel bodies, for the timing probe
// (scripts/head_folded_routes.cu), which builds them under other launch
// bounds; the kernels here run them with 0.  Their results are not the
// function's.
constexpr int NO_EXP = 1;     // exp2 of each score replaced by the score
constexpr int NO_MAX = 2;     // forward: no running max (offset 0)
constexpr int NO_REDUCE = 2;  // backward: no reduce-scatter of dQ

template <int DP>
struct FwdShape {
  // query rows a thread, keys a group (the max taken before their exps)
  static constexpr int R = DP <= 8 ? 3 : (DP == 16 ? 2 : 1);
  static constexpr int G = DP == 64 ? 2 : 4;
  // blocks an SM the registers are budgeted for: 4 fill one wave with the
  // flagship's 512 enc-self blocks
  static constexpr int MIN_BLOCKS = DP == 4 ? 4 : 1;
  static constexpr int HB = DP >= 32 ? 1 : 32 / DP;  // heads a block, at most
  static constexpr int KC = 6144 / (HB * DP);        // keys a chunk (24 KB)
};

struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (b, h, Lq) or null
  Str sq, sk, sv, so;
  int H, Lq, Lk, d;
  int hb;         // heads a block
  int vec;        // K and V in 16-byte groups (d % 4 == 0, aligned)
  float q_scale;  // log2(e) / sqrt(d)
};

// keys k0 .. k0 + n - 1 of heads h0 .. h0 + hbn - 1 into dst[key][head][j],
// zero-padded: consecutive threads read consecutive (head, j), whole (L, h d)
// rows when the heads are folded; 16 bytes a load where `vec`
template <int DP, int HB>
__device__ __forceinline__ void stage(float (*dst)[HB][DP],
                                      const float* __restrict__ src,
                                      const Str& s, int b, int h0, int hbn,
                                      int k0, int n, int d, bool vec) {
  const float* base = row_of(src, s, b, h0, k0);
  if (vec) {
    constexpr int G4 = DP / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < n * HB * G4; i += blockDim.x) {
      const int g = i % G4;
      const int hh = (i / G4) % HB;
      const int t = i / (G4 * HB);
      const bool ok = hh < hbn && 4 * g < d;
      *reinterpret_cast<float4*>(&dst[t][hh][4 * g]) =
          ok ? __ldg(reinterpret_cast<const float4*>(base + t * s.l +
                                                     hh * s.h + 4 * g))
             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < n * HB * DP; i += blockDim.x) {
      const int j = i % DP;
      const int hh = (i / DP) % HB;
      const int t = i / (DP * HB);
      dst[t][hh][j] = (hh < hbn && j < d)
                          ? __ldg(base + t * s.l + hh * s.h + j) : 0.f;
    }
  }
}

// One group of G keys t0 .. t0 + G - 1 (FULL: all below n; else the rest
// score -inf): the scores and their max first, one rescale of the rows
// whose max rose, then the probabilities and their products with v.
template <int DP, bool FULL, int PROBE>
__device__ __forceinline__ void fwd_group(
    const float (*ks)[FwdShape<DP>::HB][DP],
    const float (*vs)[FwdShape<DP>::HB][DP], int hh, int t0, int n,
    const float (&qr)[FwdShape<DP>::R][DP],
    float (&acc)[FwdShape<DP>::R][DP], float (&l)[FwdShape<DP>::R],
    float (&m)[FwdShape<DP>::R]) {
  constexpr int R = FwdShape<DP>::R, G = FwdShape<DP>::G;
  float s[R][G], gm[R];
#pragma unroll
  for (int i = 0; i < R; ++i) gm[i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int t = t0 + j;
    const bool ok = FULL || t < n;
    float kk[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) kk[c] = ks[ok ? t : 0][hh][c];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float x = qr[i][0] * kk[0];
#pragma unroll
      for (int c = 1; c < DP; ++c) x = fmaf(qr[i][c], kk[c], x);
      s[i][j] = ok ? x : -INFINITY;
      if (!(PROBE & NO_MAX)) gm[i] = fmaxf(gm[i], s[i][j]);
    }
  }
  bool up = false;
#pragma unroll
  for (int i = 0; i < R; ++i) up |= gm[i] > m[i];
  if (up) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float mn = fmaxf(m[i], gm[i]);
      const float sc = ex2(m[i] - mn);
      l[i] *= sc;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[i][c] *= sc;
      m[i] = mn;
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int t = t0 + j;
    const bool ok = FULL || t < n;
    float vv[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) vv[c] = vs[ok ? t : 0][hh][c];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float x = s[i][j] - m[i];
      const float p = (PROBE & NO_EXP) ? x : ex2(x);
      l[i] += p;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
    }
  }
}

template <int DP, int PROBE>
__device__ __forceinline__ void fwd_body(const FwdArgs& a) {
  using S = FwdShape<DP>;
  constexpr int R = S::R, G = S::G;
  // the K and V panels; before and after the keys, the block's (rows,
  // heads, DP) tile of q and of the output, so that both cross device
  // memory in whole (L, h d) rows
  __shared__ __align__(16) float kv[2][S::KC][S::HB][DP];
  float(*ks)[S::HB][DP] = kv[0];
  float(*vs)[S::HB][DP] = kv[1];
  float* tile = &kv[0][0][0][0];

  const int groups = (a.H + a.hb - 1) / a.hb;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x - b * groups) * a.hb;
  const int hbn = min(a.hb, a.H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hh = warp % a.hb;  // the warp's head in the block
  const int wq_n = (blockDim.x >> 5) / a.hb;
  const int wq = warp / a.hb;
  const bool live = hh < hbn;
  const int head = h0 + hh;
  const int rb = wq_n * 32 * R;  // rows a block
  const int rb0 = blockIdx.y * rb;
  // the thread's rows: row0, row0 + 32, ...
  const int row0 = rb0 + wq * 32 * R + lane;
  const int tile_n = rb * S::HB * DP;
  const bool tiled = tile_n <= 2 * S::KC * S::HB * DP;

  if (tiled) {
    for (int i = threadIdx.x; i < tile_n; i += blockDim.x) {
      const int c = i % DP;
      const int h1 = (i / DP) % S::HB;
      const int row = rb0 + i / (DP * S::HB);
      tile[i] = (h1 < hbn && c < a.d && row < a.Lq)
                    ? __ldg(row_of(a.q, a.sq, b, h0 + h1, row) + c) *
                          a.q_scale
                    : 0.f;
    }
    __syncthreads();
  }
  float qr[R][DP], acc[R][DP], l[R], m[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + 32 * i;
    const bool ok = live && row < a.Lq;
    const float* src = row_of(a.q, a.sq, b, ok ? head : 0, ok ? row : 0);
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (tiled)
        qr[i][c] = tile[((row - rb0) * S::HB + hh) * DP + c];
      else
        qr[i][c] = (ok && c < a.d) ? __ldg(src + c) * a.q_scale : 0.f;
      acc[i][c] = 0.f;
    }
    l[i] = 0.f;
    // below every score, and finite: exp2(-inf - m) = 0
    m[i] = (PROBE & NO_MAX) ? 0.f : -1e30f;
  }

  for (int k0 = 0; k0 < a.Lk; k0 += S::KC) {
    const int n = min(S::KC, a.Lk - k0);
    __syncthreads();  // the previous chunk (or the q tile) is consumed
    stage<DP, S::HB>(ks, a.k, a.sk, b, h0, hbn, k0, n, a.d, a.vec);
    stage<DP, S::HB>(vs, a.v, a.sv, b, h0, hbn, k0, n, a.d, a.vec);
    __syncthreads();
    if (!live) continue;
    int t0 = 0;
    for (; t0 + G <= n; t0 += G)
      fwd_group<DP, true, PROBE>(ks, vs, hh, t0, n, qr, acc, l, m);
    if (t0 < n) fwd_group<DP, false, PROBE>(ks, vs, hh, t0, n, qr, acc, l, m);
  }

  if (tiled) __syncthreads();  // the panels are consumed: the output tile
  if (live) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + 32 * i;
      if (row >= a.Lq) continue;
      const float inv = 1.f / l[i];
      float* dst = row_of(a.o, a.so, b, head, row);
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        if (tiled)
          tile[((row - rb0) * S::HB + hh) * DP + c] = acc[i][c] * inv;
        else if (c < a.d)
          dst[c] = acc[i][c] * inv;
      }
      if (a.lse != nullptr)
        a.lse[((long long)b * a.H + head) * a.Lq + row] =
            (m[i] + log2f(l[i])) * LN2;
    }
  }
  if (tiled) {
    __syncthreads();
    for (int i = threadIdx.x; i < tile_n; i += blockDim.x) {
      const int c = i % DP;
      const int h1 = (i / DP) % S::HB;
      const int row = rb0 + i / (DP * S::HB);
      if (h1 < hbn && c < a.d && row < a.Lq)
        row_of(a.o, a.so, b, h0 + h1, row)[c] = tile[i];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(FWD_WARPS * 32, FwdShape<DP>::MIN_BLOCKS)
fwd_kernel(const FwdArgs a) {
  fwd_body<DP, 0>(a);
}

template <int DP>
int launch_fwd(FwdArgs a, int B, cudaStream_t stream) {
  using S = FwdShape<DP>;
  a.hb = std::min(a.H, S::HB);
  const int wq_n = std::max(1, FWD_WARPS / a.hb);
  const int groups = (a.H + a.hb - 1) / a.hb;
  const int rows = wq_n * 32 * S::R;
  const dim3 grid((unsigned)(B * groups), (a.Lq + rows - 1) / rows);
  if ((long long)B * groups > 0x7fffffffLL || grid.y > 65535)
    return (int)cudaErrorInvalidValue;
  fwd_kernel<DP><<<grid, a.hb * wq_n * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- backward

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
  float* delta;  // (b, h, Lq) scratch of the streamed route
  Str sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, Lq, Lk, d;
  int hb, wph;     // the fused route: heads a block, warps a head
  float q_scale;   // log2(e) / sqrt(d)
  float scale;     // 1 / sqrt(d)
};

template <int DP>
struct BwdShape {
  static constexpr int RK = DP == 4 ? 3 : (DP == 8 ? 2 : 1);  // keys a lane
  static constexpr int RQ = 32 / DP;  // query rows a step: RQ x DP = 32
  static constexpr int KW = 32 * RK;  // keys a warp
  static constexpr int THREADS = DP == 4 ? 512 : 256;
};

// the fused route's shared memory, in floats, and its rows padded to RQ
__host__ __device__ inline int padded_rows(int Lq, int rq) {
  return (Lq + rq - 1) / rq * rq;
}

__host__ __device__ inline long long fused_smem_floats(int dp, int hb,
                                                       int wph, int Lq,
                                                       int Lk) {
  const int lp = padded_rows(Lq, 32 / dp);
  return (long long)hb * lp * (2 * dp + 2) + (long long)wph * hb * lp * dp +
         2LL * Lk * hb * dp;
}

// k and v of the lane's RK keys key0, key0 + 32, ...; zero past Lk
template <int DP, int RK>
__device__ __forceinline__ void load_keys(const BwdArgs& a, int b, int head,
                                          int key0, float (&kr)[RK][DP],
                                          float (&vr)[RK][DP]) {
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = key0 + i * 32;
    const bool ok = key < a.Lk;
    const float* krow = row_of(a.k, a.sk, b, head, ok ? key : 0);
    const float* vrow = row_of(a.v, a.sv, b, head, ok ? key : 0);
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      kr[i][j] = (ok && j < a.d) ? __ldg(krow + j) : 0.f;
      vr[i][j] = (ok && j < a.d) ? __ldg(vrow + j) : 0.f;
    }
  }
}

// One step of the fused backward: the lane's RK keys against query rows
// r0 .. r0 + RQ - 1 (slot rr of acc holds row r0 + (rr ^ rbits)): P, dP, dS
// a pair, dK and dV summed in registers, dQ's sums over the lane's keys in
// acc.
template <int DP, int RK, int PROBE>
__device__ __forceinline__ void bwd_step(
    const float* qsh, const float* dosh, const float2* ldh, int r0,
    int rbits, const float (&kr)[RK][DP], const float (&vr)[RK][DP],
    float (&dka)[RK][DP], float (&dva)[RK][DP],
    float (&acc)[BwdShape<DP>::RQ * DP]) {
  constexpr int RQ = BwdShape<DP>::RQ;
#pragma unroll
  for (int s = 0; s < RQ * DP; ++s) acc[s] = 0.f;
#pragma unroll
  for (int rr = 0; rr < RQ; ++rr) {
    const int r = r0 + (rr ^ rbits);
    float qv[DP], dov[DP];
#pragma unroll
    for (int j = 0; j < DP; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qsh + r * DP + j);
      const float4 y = *reinterpret_cast<const float4*>(dosh + r * DP + j);
      qv[j] = x.x, qv[j + 1] = x.y, qv[j + 2] = x.z, qv[j + 3] = x.w;
      dov[j] = y.x, dov[j + 1] = y.y, dov[j + 2] = y.z, dov[j + 3] = y.w;
    }
    const float2 lv = ldh[r];
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      float s = -lv.x;
#pragma unroll
      for (int j = 0; j < DP; ++j) s = fmaf(qv[j], kr[i][j], s);
      const float p = (PROBE & NO_EXP) ? s : ex2(s);
      float dp = -lv.y;
#pragma unroll
      for (int j = 0; j < DP; ++j) dp = fmaf(dov[j], vr[i][j], dp);
      const float ds = p * dp;
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        dva[i][j] = fmaf(p, dov[j], dva[i][j]);
        dka[i][j] = fmaf(ds, qv[j], dka[i][j]);
        acc[rr * DP + j] = fmaf(ds, kr[i][j], acc[rr * DP + j]);
      }
    }
  }
}

// A step's dQ values summed over the warp's lanes by a reduce-scatter, a
// level a lane bit.  Row levels (o >= DP): slot s (< o) takes the
// partner's slot s + o, which holds the same element.  Dim levels (o < DP):
// the lane keeps the half of its dims whose bit o is its own and sends the
// other half.  Lane l ends with element l of the step's (RQ, DP) tile and
// writes it to the warp's partial (`first`) or adds it there.
template <int DP, int PROBE>
__device__ __forceinline__ void bwd_reduce(float (&acc)[BwdShape<DP>::RQ * DP],
                                           int lane, float* dst, bool first) {
#pragma unroll
  for (int lv = 0; lv < ((PROBE & NO_REDUCE) ? 0 : 5); ++lv) {
    const int o = 16 >> lv;
    const bool hi = lane & o;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      if (s >= o) continue;
      if (o >= DP) {
        acc[s] += __shfl_xor_sync(0xffffffffu, acc[s + o], o);
      } else {
        const float send = hi ? acc[s] : acc[s + o];
        const float keep = hi ? acc[s + o] : acc[s];
        acc[s] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
  }
  dst[lane] = first ? acc[0] : dst[lane] + acc[0];
}

template <int DP, int PROBE>
__device__ __forceinline__ void bwd_fused_body(const BwdArgs& a) {
  using S = BwdShape<DP>;
  constexpr int RK = S::RK, RQ = S::RQ, KW = S::KW;
  extern __shared__ __align__(16) float smem[];
  const int hb = a.hb;
  const int Lp = padded_rows(a.Lq, RQ);
  float* qs = smem;                                        // [hb][Lp][DP]
  float* dos = qs + hb * Lp * DP;                          // [hb][Lp][DP]
  float2* ld = reinterpret_cast<float2*>(dos + hb * Lp * DP);  // [hb][Lp]
  float* dqp = reinterpret_cast<float*>(ld + hb * Lp);  // [wph][hb][Lp][DP]
  // dK and dV as (keys, heads, DP) tiles, written out in whole rows
  float* dkt = dqp + a.wph * hb * Lp * DP;  // [Lk][hb][DP]
  float* dvt = dkt + a.Lk * hb * DP;        // [Lk][hb][DP]

  const int groups = (a.H + hb - 1) / hb;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x - b * groups) * hb;
  const int hbn = min(hb, a.H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hh = warp % hb, w = warp / hb;
  const int head = h0 + hh;
  const bool live = hh < hbn;
  // slot rr * DP + j of a step's dQ values holds row rr ^ rbits of the
  // step, dim j
  const int rbits = lane / DP;
  const int chunks = (a.Lk + KW - 1) / KW;

  // the first chunk's keys are read while the rows are staged
  float kr[RK][DP], vr[RK][DP];
  if (live && w < chunks) load_keys<DP, RK>(a, b, head, w * KW + lane, kr, vr);

  // q scaled, dO, (lse in base 2, D = dO . O) of every row; padded rows
  // get lse +inf, so that their probabilities are 0
#pragma unroll 2
  for (int i = threadIdx.x; i < Lp * hb; i += blockDim.x) {
    const int r = i / hb;
    const int h1 = i - r * hb;
    const bool ok = r < a.Lq && h1 < hbn;
    float qv[DP], dov[DP];
    float dd = 0.f, l2 = INFINITY;
    if (ok) {
      const float* qrow = row_of(a.q, a.sq, b, h0 + h1, r);
      const float* drow = row_of(a.dout, a.sdo, b, h0 + h1, r);
      const float* orow = row_of(a.o, a.so, b, h0 + h1, r);
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        const bool in = j < a.d;
        qv[j] = in ? __ldg(qrow + j) * a.q_scale : 0.f;
        dov[j] = in ? __ldg(drow + j) : 0.f;
        if (in) dd = fmaf(dov[j], __ldg(orow + j), dd);
      }
      l2 = __ldg(a.lse + ((long long)b * a.H + h0 + h1) * a.Lq + r) * LOG2E;
    } else {
#pragma unroll
      for (int j = 0; j < DP; ++j) qv[j] = dov[j] = 0.f;
    }
    float* qdst = qs + (h1 * Lp + r) * DP;
    float* ddst = dos + (h1 * Lp + r) * DP;
#pragma unroll
    for (int j = 0; j < DP; j += 4) {
      *reinterpret_cast<float4*>(qdst + j) =
          make_float4(qv[j], qv[j + 1], qv[j + 2], qv[j + 3]);
      *reinterpret_cast<float4*>(ddst + j) =
          make_float4(dov[j], dov[j + 1], dov[j + 2], dov[j + 3]);
    }
    ld[h1 * Lp + r] = make_float2(l2, dd);
  }
  __syncthreads();

  if (live) {
    const float* qsh = qs + hh * Lp * DP;
    const float* dosh = dos + hh * Lp * DP;
    const float2* ldh = ld + hh * Lp;
    float* dqh = dqp + (w * hb + hh) * Lp * DP;
    for (int kc = w; kc < chunks; kc += a.wph) {
      if (kc != w) load_keys<DP, RK>(a, b, head, kc * KW + lane, kr, vr);
      float dka[RK][DP], dva[RK][DP];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
#pragma unroll
        for (int j = 0; j < DP; ++j) dka[i][j] = dva[i][j] = 0.f;
      }
      for (int r0 = 0; r0 < Lp; r0 += RQ) {
        float acc[RQ * DP];
        bwd_step<DP, RK, PROBE>(qsh, dosh, ldh, r0, rbits, kr, vr, dka, dva,
                                acc);
        bwd_reduce<DP, PROBE>(acc, lane, dqh + r0 * DP, kc == w);
      }
      // dK = sum dS q / sqrt(d): the q here carries log2(e) / sqrt(d)
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int key = kc * KW + i * 32 + lane;
        if (key >= a.Lk) continue;
#pragma unroll
        for (int j = 0; j < DP; j += 4) {
          const int at = (key * hb + hh) * DP + j;
          *reinterpret_cast<float4*>(dkt + at) =
              make_float4(dka[i][j] * LN2, dka[i][j + 1] * LN2,
                          dka[i][j + 2] * LN2, dka[i][j + 3] * LN2);
          *reinterpret_cast<float4*>(dvt + at) = make_float4(
              dva[i][j], dva[i][j + 1], dva[i][j + 2], dva[i][j + 3]);
        }
      }
    }
  }
  __syncthreads();

  // dQ: the warps' partials of each row added in warp order
  for (int i = threadIdx.x; i < a.Lq * hbn * DP; i += blockDim.x) {
    const int j = i % DP;
    const int h2 = (i / DP) % hbn;
    const int r = i / (DP * hbn);
    if (j >= a.d) continue;
    float s = 0.f;
    for (int w2 = 0; w2 < a.wph; ++w2)
      s += dqp[((w2 * hb + h2) * Lp + r) * DP + j];
    row_of(a.dq, a.sdq, b, h0 + h2, r)[j] = s * a.scale;
  }
  for (int i = threadIdx.x; i < a.Lk * hbn * DP; i += blockDim.x) {
    const int j = i % DP;
    const int h2 = (i / DP) % hbn;
    const int key = i / (DP * hbn);
    if (j >= a.d) continue;
    const int at = (key * hb + h2) * DP + j;
    row_of(a.dk, a.sdk, b, h0 + h2, key)[j] = dkt[at];
    row_of(a.dv, a.sdv, b, h0 + h2, key)[j] = dvt[at];
  }
}

template <int DP>
__global__ void __launch_bounds__(BwdShape<DP>::THREADS)
bwd_fused_kernel(const BwdArgs a) {
  bwd_fused_body<DP, 0>(a);
}

template <int DP>
int launch_bwd_fused(const BwdArgs& a, int B, cudaStream_t stream) {
  using S = BwdShape<DP>;
  const int chunks = (a.Lk + S::KW - 1) / S::KW;
  if (a.hb < 1 || a.hb > a.H || a.wph < 1 || a.wph > chunks ||
      a.hb * a.wph * 32 > S::THREADS)
    return (int)cudaErrorInvalidValue;
  const long long bytes = 4 * fused_smem_floats(DP, a.hb, a.wph, a.Lq, a.Lk);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  static long long granted = 48 * 1024;
  if (bytes > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_fused_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    granted = bytes;
  }
  const long long groups = (a.H + a.hb - 1) / a.hb;
  if ((long long)B * groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_fused_kernel<DP><<<(unsigned)(B * groups), a.hb * a.wph * 32,
                         (size_t)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------------------------- backward, streamed route

constexpr int ROWS = 64;  // query (or key) rows, one a thread, a block
constexpr int KC = 64;    // rows a shared-memory chunk

template <int DP>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         bool ok, int d, float scale,
                                         float (&dst)[DP]) {
#pragma unroll
  for (int j = 0; j < DP; ++j) dst[j] = (ok && j < d) ? src[j] * scale : 0.f;
}

// rows k0 .. k0 + n - 1 of one head into shared memory [KC][DP]
template <int DP>
__device__ __forceinline__ void stage_rows(float (*dst)[DP],
                                           const float* __restrict__ src,
                                           const Str& s, int b, int h, int k0,
                                           int n, int d, float scale) {
  const float* base = row_of(src, s, b, h, k0);
  for (int i = threadIdx.x; i < KC * DP; i += ROWS) {
    const int r = i / DP;
    const int j = i - r * DP;
    dst[r][j] = (r < n && j < d) ? base[r * s.l + j] * scale : 0.f;
  }
}

// 1. query-parallel: D = rowsum(dO o O) and dQ
template <int DP>
__global__ void __launch_bounds__(ROWS) bwd_dq_kernel(const BwdArgs a) {
  __shared__ __align__(16) float ks[KC][DP];
  __shared__ __align__(16) float vs[KC][DP];
  const int b = blockIdx.x / a.H, h = blockIdx.x - b * a.H;
  const int row = blockIdx.y * ROWS + threadIdx.x;
  const bool ok = row < a.Lq;
  const int rr = ok ? row : 0;
  float qr[DP], dor[DP], orow[DP], acc[DP];
  load_row<DP>(row_of(a.q, a.sq, b, h, rr), ok, a.d, a.q_scale, qr);
  load_row<DP>(row_of(a.dout, a.sdo, b, h, rr), ok, a.d, 1.f, dor);
  load_row<DP>(row_of(a.o, a.so, b, h, rr), ok, a.d, 1.f, orow);
  float dsum = 0.f;
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    dsum = fmaf(dor[j], orow[j], dsum);
    acc[j] = 0.f;
  }
  const long long at = ((long long)b * a.H + h) * a.Lq + rr;
  const float lse2 = ok ? a.lse[at] * LOG2E : 0.f;
  for (int k0 = 0; k0 < a.Lk; k0 += KC) {
    const int n = min(KC, a.Lk - k0);
    __syncthreads();
    stage_rows<DP>(ks, a.k, a.sk, b, h, k0, n, a.d, 1.f);
    stage_rows<DP>(vs, a.v, a.sv, b, h, k0, n, a.d, 1.f);
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        s = fmaf(qr[j], ks[t][j], s);
        dp = fmaf(dor[j], vs[t][j], dp);
      }
      const float ds = exp2f(s - lse2) * (dp - dsum);
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[j] = fmaf(ds, ks[t][j], acc[j]);
    }
  }
  if (ok) {
    float* dst = row_of(a.dq, a.sdq, b, h, row);
#pragma unroll
    for (int j = 0; j < DP; ++j)
      if (j < a.d) dst[j] = acc[j] * a.scale;
    a.delta[at] = dsum;
  }
}

// 2. key-parallel: dK and dV
template <int DP>
__global__ void __launch_bounds__(ROWS) bwd_dkv_kernel(const BwdArgs a) {
  __shared__ __align__(16) float qs[KC][DP];
  __shared__ __align__(16) float dos[KC][DP];
  __shared__ float lses[KC];
  __shared__ float ds_[KC];
  const int b = blockIdx.x / a.H, h = blockIdx.x - b * a.H;
  const int row = blockIdx.y * ROWS + threadIdx.x;  // key row
  const bool ok = row < a.Lk;
  const int rr = ok ? row : 0;
  const long long at = ((long long)b * a.H + h) * a.Lq;
  float kr[DP], vr[DP], dka[DP], dva[DP];
  load_row<DP>(row_of(a.k, a.sk, b, h, rr), ok, a.d, 1.f, kr);
  load_row<DP>(row_of(a.v, a.sv, b, h, rr), ok, a.d, 1.f, vr);
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    dka[j] = 0.f;
    dva[j] = 0.f;
  }
  for (int q0 = 0; q0 < a.Lq; q0 += KC) {
    const int n = min(KC, a.Lq - q0);
    __syncthreads();
    // q scaled by log2(e)/sqrt(d) for the scores; dK uses unscaled q, so
    // the factor is divided out again at the end
    stage_rows<DP>(qs, a.q, a.sq, b, h, q0, n, a.d, a.q_scale);
    stage_rows<DP>(dos, a.dout, a.sdo, b, h, q0, n, a.d, 1.f);
    if (threadIdx.x < n) {
      lses[threadIdx.x] = a.lse[at + q0 + threadIdx.x] * LOG2E;
      ds_[threadIdx.x] = a.delta[at + q0 + threadIdx.x];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        s = fmaf(qs[t][j], kr[j], s);
        dp = fmaf(dos[t][j], vr[j], dp);
      }
      const float p = exp2f(s - lses[t]);
      const float ds = p * (dp - ds_[t]);
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        dva[j] = fmaf(p, dos[t][j], dva[j]);
        dka[j] = fmaf(ds, qs[t][j], dka[j]);
      }
    }
  }
  if (ok) {
    // dka holds sum ds * q * q_scale; dK wants sum ds * q * scale
    const float to_dk = a.scale / a.q_scale;
    float* dkrow = row_of(a.dk, a.sdk, b, h, row);
    float* dvrow = row_of(a.dv, a.sdv, b, h, row);
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      if (j < a.d) {
        dkrow[j] = dka[j] * to_dk;
        dvrow[j] = dva[j];
      }
    }
  }
}

template <int DP>
int launch_bwd_streamed(const BwdArgs& a, int B, cudaStream_t stream) {
  const long long bh = (long long)B * a.H;
  if (bh > 0x7fffffffLL || (a.Lq + ROWS - 1) / ROWS > 65535 ||
      (a.Lk + ROWS - 1) / ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  bwd_dq_kernel<DP><<<dim3((unsigned)bh, (a.Lq + ROWS - 1) / ROWS), ROWS, 0,
                      stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkv_kernel<DP><<<dim3((unsigned)bh, (a.Lk + ROWS - 1) / ROWS), ROWS, 0,
                       stream>>>(a);
  return (int)cudaGetLastError();
}

Str strides_at(const long long* s, int i) {
  return Str{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

extern "C" {

// q (b, h, Lq, d), k and v (b, h, Lk, d), o (b, h, Lq, d): fp32 views with
// unit stride on d and the element strides (b, h, L) of q, k, v and o, in
// that order, in `strides` (12 values, host memory); lse (b, h, Lq)
// contiguous, or null: the natural-log log-sum-exp of each row's scaled
// scores, for the backward.  1 <= d < 64.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a shape it does not take).
int head_folded_attention_fwd(const float* q, const float* k, const float* v,
                              float* o, float* lse, const long long* strides,
                              int B, int H, int Lq, int Lk, int d,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d < 1 || d >= 64 || B < 1 || H < 1 || Lq < 1 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  FwdArgs a{q, k, v, o, lse, strides_at(strides, 0), strides_at(strides, 1),
            strides_at(strides, 2), strides_at(strides, 3), H, Lq, Lk, d, 1,
            0, LOG2E / sqrtf((float)d)};
  a.vec = d % 4 == 0 && ((size_t)k | (size_t)v) % 16 == 0;
  for (int i = 3; i < 9; ++i) a.vec = a.vec && strides[i] % 4 == 0;
  if (d <= 4) return launch_fwd<4>(a, B, s);
  if (d <= 8) return launch_fwd<8>(a, B, s);
  if (d <= 16) return launch_fwd<16>(a, B, s);
  if (d <= 32) return launch_fwd<32>(a, B, s);
  return launch_fwd<64>(a, B, s);
}

// The VJP: q, k, v, o and lse as the forward saw and wrote them, dout the
// cotangent of o; writes dq, dk and dv.  `strides`: 24 values, the (b, h,
// L) element strides of q, k, v, o, dout, dq, dk and dv.  hb > 0: the fused
// route, one launch, hb heads a block and wph warps a head (d <= 16, the
// rows' shared memory within the card's 227 KB); hb = 0: the streamed
// route, two launches, delta (b, h, Lq) contiguous as scratch.
int head_folded_attention_bwd(const float* q, const float* k, const float* v,
                              const float* o, const float* lse,
                              const float* dout, float* dq, float* dk,
                              float* dv, float* delta,
                              const long long* strides, int B, int H, int Lq,
                              int Lk, int d, int hb, int wph, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d < 1 || d >= 64 || B < 1 || H < 1 || Lq < 1 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)d);
  BwdArgs a{q, k, v, o, lse, dout, dq, dk, dv, delta,
            strides_at(strides, 0), strides_at(strides, 1),
            strides_at(strides, 2), strides_at(strides, 3),
            strides_at(strides, 4), strides_at(strides, 5),
            strides_at(strides, 6), strides_at(strides, 7),
            H, Lq, Lk, d, hb, wph, LOG2E * scale, scale};
  if (hb > 0) {
    if (d <= 4) return launch_bwd_fused<4>(a, B, s);
    if (d <= 8) return launch_bwd_fused<8>(a, B, s);
    if (d <= 16) return launch_bwd_fused<16>(a, B, s);
    return (int)cudaErrorInvalidValue;
  }
  if (delta == nullptr) return (int)cudaErrorInvalidValue;
  if (d <= 4) return launch_bwd_streamed<4>(a, B, s);
  if (d <= 8) return launch_bwd_streamed<8>(a, B, s);
  if (d <= 16) return launch_bwd_streamed<16>(a, B, s);
  if (d <= 32) return launch_bwd_streamed<32>(a, B, s);
  return launch_bwd_streamed<64>(a, B, s);
}

}  // extern "C"
