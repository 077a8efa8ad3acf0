// Append-time kNN candidate ranking, with the brick probe gather fused in.
//
// Replaces the Pallas kernel `_rank_kernel` / `probe_rank_pallas`
// (pin_slam_tpu/ops/rank_kernel.py) together with the XLA gather that feeds
// it on the brick layout, `brick_gather_fm` (pin_slam_tpu/models/
// neural_points.py), which the JAX `_probe_rank` calls before the kernel.
//
// Semantics.  For each of G probe groups, n queries share one ball of Kc
// candidates, field-major [x|y|z|lidx|gidx] (Kc columns each).  A candidate
// is valid iff lidx < L and d2 <= max_valid_dist2; invalid ones rank at 9e3.
// The k nearest are the first k of the order (d2m, column): k argmin passes
// with first-occurrence tie-break and chosen columns masked away (an
// exhausted ball re-picks untouched invalid columns in column order).
//
// Two entry points share one device routine, `rank_group`:
//  - rank_brick_kernel (the main path): the warp computes the probe's grid
//    coordinate floor(p * float32(1/voxel)) (no FMA contraction), its brick
//    coordinate by floor division and parity bidx; lane kb hashes the
//    parity's brick offset kb (uint32 wrap-around multiply-add, then % Hb;
//    the template's padding offsets 1 << 20 hash to real rows and only
//    `memb` masks them), loads that whole brick row (nsub * 5 floats, as
//    float4s where rows are 16-byte aligned) and writes it to shared memory
//    field-major in the candidate order c = s * Kb + kb (lanes write
//    consecutive addresses: no bank conflicts), with lidx set to L where
//    memb <= 0.5.  `rows_fm` is never materialised.
//  - rank_kernel (the per-cell layout): the warp copies the group's
//    (5 * Kc) field-major row to shared memory.
//
// Bound on an H100: memory.  The call must read each distinct brick row its
// groups hash to once (neighbouring groups share most of their Kb rows, so
// the re-reads can come from L2), each probe and its n queries, and write
// n * k * 17 bytes a group; d2 for n * Kc pairs is ~9 operations each.
// What held the first port of this kernel back: one thread per query with a
// k-slot list in local memory, candidates re-read from global memory by
// every query, and five torch passes over rows_fm before it.  Design:
//  - one warp per group (grid-stride, the grid from the build's occupancy);
//  - each lane keeps its ceil(Kc / 32) columns' xyz and lidx validity in
//    registers (CPL is a template parameter, so nothing is indexed at run
//    time) for all n queries;
//  - the k rounds of a query are warp argmins with two `redux.sync` minima:
//    the float bits of d2m (d2m >= 0, so the bit order is the numeric
//    order), then the lowest column holding that minimum; the owner lane
//    masks the chosen column to 0xffffffff, above every unmasked key;
//  - when max_valid_dist2 < 9e3 every valid key lies below every invalid
//    one, so once a query's valid candidates are used up its remaining
//    picks are the untouched invalid columns in column order, which the
//    valid-column ballots (taken once a query) give without argmin rounds:
//    the sparse balls of the free-space probes skip most rounds;
//  - lane r keeps round r's column and writes its gidx / pos / valid.
// The template tables (P * Kb * 3 ints, P * Kc floats) are read through the
// read-only cache; they are a few KB and stay in L1.
// Measured on the paths' inputs (PERF.md): the argmin rounds are about 40 %
// of a near call (k = 1 instead of 6 takes that off), the staging with one
// query about 45 % of a far call; 2, 4 or 8 warps a block time the same; two
// queries at a time on half-warps, and staging by coalesced loads (five
// lanes a row) into shared rows of odd stride, were both slower.
//
// d2 is written with __fmul_rn/__fadd_rn in the JAX package's order
// ((dx*dx + dy*dy) + dz*dz): nvcc would otherwise contract it into FMAs,
// which moves d2 by an ulp and reorders near-ties against the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#define RANK_WARPS 4          // groups in flight per block (2 and 8 time the same)
#define RANK_MAX_CPL 8        // columns per lane: Kc <= 256

struct RankOut {
  const float* q;             // (G, n, 3) queries, row g at q + g * q_stride
  long q_stride;
  int G, n, Kc, k;
  float L_f, maxd2;
  int* gidx;                  // (G, n, k)
  float* pos;                 // (G, n, k, 3)
  unsigned char* valid;       // (G, n, k)
};

__device__ __forceinline__ float dist2_rn(float x, float y, float z, float qx, float qy,
                                          float qz) {
  const float dx = __fsub_rn(x, qx), dy = __fsub_rn(y, qy), dz = __fsub_rn(z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Rank group g's candidates, staged field-major in `cand` (5 * Kc floats of
// this warp's shared memory), for each of its n queries.
template <int CPL>
__device__ __forceinline__ void rank_group(const float* cand, long g, const RankOut& a,
                                           int lane) {
  const int Kc = a.Kc;
  float cx[CPL], cy[CPL], cz[CPL];
  bool lv[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    const bool in = c < Kc;
    cx[j] = in ? cand[c] : 0.f;
    cy[j] = in ? cand[Kc + c] : 0.f;
    cz[j] = in ? cand[2 * Kc + c] : 0.f;
    lv[j] = in && cand[3 * Kc + c] < a.L_f;
  }
  // valid keys lie below every invalid one (9e3) when maxd2 < 9e3: then
  // the rounds after the last valid candidate pick the untouched invalid
  // columns in column order, which the valid ballots give without rounds
  const bool fill = a.maxd2 < 9e3f;
  const float* qg = a.q + g * a.q_stride;
  for (int qi = 0; qi < a.n; ++qi) {
    const float qx = qg[3 * qi], qy = qg[3 * qi + 1], qz = qg[3 * qi + 2];
    unsigned key[CPL], vb[CPL];
    int nvalid = 0;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float d2 = dist2_rn(cx[j], cy[j], cz[j], qx, qy, qz);
      const bool v = lv[j] && d2 <= a.maxd2;
      key[j] = lane + 32 * j < Kc ? __float_as_uint(v ? d2 : 9e3f) : 0xffffffffu;
      vb[j] = __ballot_sync(0xffffffffu, v);
      nvalid += __popc(vb[j]);
    }
    const int kv = fill && nvalid < a.k ? nvalid : a.k;
    unsigned mine = 0;
    if (kv < a.k) {                          // lane r in [kv, k): invalid column r - kv
      int t = lane - kv;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int left = Kc - 32 * j;        // the invalid columns of this j
        unsigned inv = ~vb[j] & (left >= 32 ? 0xffffffffu : left > 0 ? (1u << left) - 1 : 0u);
        const int cnt = __popc(inv);
        if (t >= 0 && t < cnt) {
          for (int i = 0; i < t; ++i) inv &= inv - 1;
          mine = 32 * j + __ffs(inv) - 1;
        }
        t -= cnt;
      }
    }
    for (int r = 0; r < kv; ++r) {
      unsigned best = 0xffffffffu;
      int bj = 0;
#pragma unroll
      for (int j = 0; j < CPL; ++j)          // strict: the lane's lowest column wins ties
        if (key[j] < best) { best = key[j]; bj = j; }
      const unsigned m = __reduce_min_sync(0xffffffffu, best);
      const unsigned c = __reduce_min_sync(0xffffffffu,
                                           best == m ? (unsigned)(lane + 32 * bj) : 0xffffffffu);
      if ((int)(c & 31u) == lane) {
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (j == (int)(c >> 5)) key[j] = 0xffffffffu;
      }
      if (lane == r) mine = c;
    }
    if (lane < a.k) {
      const float x = cand[mine], y = cand[Kc + mine], z = cand[2 * Kc + mine];
      const float d2 = dist2_rn(x, y, z, qx, qy, qz);
      const bool v = cand[3 * Kc + mine] < a.L_f && d2 <= a.maxd2;
      const long o = (g * a.n + qi) * a.k + lane;
      a.gidx[o] = v ? (int)lrintf(cand[4 * Kc + mine]) : -1;
      a.pos[o * 3 + 0] = x;
      a.pos[o * 3 + 1] = y;
      a.pos[o * 3 + 2] = z;
      a.valid[o] = v ? 1 : 0;
    }
  }
}

template <int CPL>
__global__ void __launch_bounds__(32 * RANK_WARPS)
    rank_kernel(const float* __restrict__ rows, RankOut a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = 5 * a.Kc;
  float* cand = smem + warp * W;
  for (long g = (long)blockIdx.x * RANK_WARPS + warp; g < a.G;
       g += (long)gridDim.x * RANK_WARPS) {
    const float* r = rows + g * W;
    for (int i = lane; i < W; i += 32) cand[i] = __ldg(r + i);
    __syncwarp();
    rank_group<CPL>(cand, g, a, lane);
    __syncwarp();                            // before the next group overwrites cand
  }
}

struct BrickGeom {
  const int* bricks;          // (P, Kb, 3) parity-indexed brick offsets
  const float* memb;          // (P, Kb * nsub) membership, column order s * Kb + kb
  const float* probe;         // (G, 3), row g at probe + g * probe_stride
  long probe_stride;
  int Kb, nsub, bx, by, bz;
  unsigned Hb;
  float inv_voxel;
};

__device__ __forceinline__ int floor_div(int a, int b) {     // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// NSUB: sub-cells a brick, known at compile time (rows read as float4s:
// the table must be 16-byte aligned and 5 * NSUB a multiple of 4), or 0
// for any brick (scalar loads).
template <int CPL, int NSUB>
__global__ void __launch_bounds__(32 * RANK_WARPS)
    rank_brick_kernel(const float* __restrict__ table, BrickGeom b, RankOut a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Kc = a.Kc, Kb = b.Kb, nsub = NSUB ? NSUB : b.nsub, R = 5 * nsub;
  float* cand = smem + warp * 5 * Kc;
  for (long g = (long)blockIdx.x * RANK_WARPS + warp; g < a.G;
       g += (long)gridDim.x * RANK_WARPS) {
    const float* p = b.probe + g * b.probe_stride;
    const int bvec[3] = {b.bx, b.by, b.bz};
    int bc[3], par[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int gc = (int)floorf(__fmul_rn(__ldg(p + d), b.inv_voxel));
      bc[d] = floor_div(gc, bvec[d]);
      par[d] = gc - bc[d] * bvec[d];
    }
    const int bidx = par[0] * (b.by * b.bz) + par[1] * b.bz + par[2];
    const int* boff = b.bricks + (long)bidx * Kb * 3;
    const float* mb = b.memb + (long)bidx * Kc;
    // lane kb hashes brick kb and copies its whole row: sub-cell s, field
    // f goes to cand[f * Kc + s * Kb + kb] (conflict-free across lanes)
    for (int kb = lane; kb < Kb; kb += 32) {
      const unsigned x = (unsigned)bc[0] + (unsigned)__ldg(boff + 3 * kb);
      const unsigned y = (unsigned)bc[1] + (unsigned)__ldg(boff + 3 * kb + 1);
      const unsigned z = (unsigned)bc[2] + (unsigned)__ldg(boff + 3 * kb + 2);
      const float* row = table + (size_t)((x * 73856093u + y * 19349669u + z * 83492791u) % b.Hb) * R;
      if constexpr (NSUB != 0) {
        float v[5 * NSUB];
#pragma unroll
        for (int j4 = 0; j4 < 5 * NSUB / 4; ++j4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(row) + j4);
          v[4 * j4] = t.x; v[4 * j4 + 1] = t.y; v[4 * j4 + 2] = t.z; v[4 * j4 + 3] = t.w;
        }
#pragma unroll
        for (int s = 0; s < NSUB; ++s) {
          const int col = s * Kb + kb;
#pragma unroll
          for (int f = 0; f < 5; ++f)
            cand[f * Kc + col] = (f == 3 && !(__ldg(mb + col) > 0.5f)) ? a.L_f : v[5 * s + f];
        }
      } else {
        for (int s = 0; s < nsub; ++s) {
          const int col = s * Kb + kb;
          for (int f = 0; f < 5; ++f)
            cand[f * Kc + col] =
                (f == 3 && !(__ldg(mb + col) > 0.5f)) ? a.L_f : __ldg(row + 5 * s + f);
        }
      }
    }
    __syncwarp();
    rank_group<CPL>(cand, g, a, lane);
    __syncwarp();                            // before the next group overwrites cand
  }
}

// Launch over min(ceil(G / RANK_WARPS), resident blocks) blocks: the
// resident count comes from the occupancy of the instantiation at the
// largest shared memory its CPL allows (cached per instantiation).
template <int ID, typename K, typename... Args>
static int launch(K kern, int cpl, long G, size_t smem, cudaStream_t st, Args... args) {
  static int cap[RANK_MAX_CPL + 1] = {0};     // per kernel family ID and CPL
  if (cap[cpl] == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, 32 * RANK_WARPS,
                                                  RANK_WARPS * 5 * 32 * cpl * sizeof(float));
    cap[cpl] = (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }
  const long need = (G + RANK_WARPS - 1) / RANK_WARPS;
  kern<<<(unsigned)(need < cap[cpl] ? need : cap[cpl]), 32 * RANK_WARPS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

#define RANK_CASES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

extern "C" int rank_launch(const void* rows, const void* q, int G, int n, int K, int k,
                           int L, float maxd2, void* gidx, void* pos, void* valid,
                           void* stream) {
  const RankOut a = {(const float*)q, 3L * n, G, n, K, k, (float)L, maxd2,
                     (int*)gidx, (float*)pos, (unsigned char*)valid};
  const int cpl = (K + 31) / 32;
  const size_t smem = (size_t)RANK_WARPS * 5 * K * sizeof(float);
  if (G <= 0 || n <= 0) return 0;
  switch (cpl) {
#define X(C) \
  case C:    \
    return launch<0>(rank_kernel<C>, C, G, smem, (cudaStream_t)stream, (const float*)rows, a);
    RANK_CASES(X)
#undef X
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int rank_brick_launch(const void* table, const void* bricks, const void* memb,
                                 const void* probe, long probe_stride, const void* q,
                                 long q_stride, int G, int n, int Kb, int nsub, int bx, int by,
                                 int bz, int Hb, float inv_voxel, int k, int L, float maxd2,
                                 void* gidx, void* pos, void* valid, void* stream) {
  const int Kc = Kb * nsub;
  const RankOut a = {(const float*)q, q_stride, G, n, Kc, k, (float)L, maxd2,
                     (int*)gidx, (float*)pos, (unsigned char*)valid};
  const BrickGeom b = {(const int*)bricks, (const float*)memb, (const float*)probe,
                       probe_stride, Kb, nsub, bx, by, bz, (unsigned)Hb, inv_voxel};
  const int cpl = (Kc + 31) / 32;
  const size_t smem = (size_t)RANK_WARPS * 5 * Kc * sizeof(float);
  const bool vec4 = nsub == 4 && (uintptr_t)table % 16 == 0;
  if (G <= 0 || n <= 0) return 0;
  switch (cpl) {
#define X(C)                                                                               \
  case C:                                                                                  \
    return vec4 ? launch<1>(rank_brick_kernel<C, 4>, C, G, smem, (cudaStream_t)stream,    \
                            (const float*)table, b, a)                                     \
                : launch<2>(rank_brick_kernel<C, 0>, C, G, smem, (cudaStream_t)stream,    \
                            (const float*)table, b, a);
    RANK_CASES(X)
#undef X
  }
  return (int)cudaErrorInvalidValue;
}
