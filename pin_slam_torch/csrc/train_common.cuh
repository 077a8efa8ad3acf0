// Shared pieces of the training-iteration and eikonal kernels
// (csrc/train_iter.cu, csrc/eikonal.cu): the decoder's shapes, the
// fixed-order sum of the blocks' partial gradients, and the decode tiles of
// the kernels' general forms (offset widths VD up to 64 at F = 8, H = 64,
// namespace gen; every other width the predicate takes, namespace gtl).
//
// Both kernels take the one-hidden-layer decoder (W1 in x H, b1, W2, b2;
// F features + VD offset dims in, H hidden; the dedicated kernels F = 8,
// VD = 3, H = 64) as one packed vector,
// and write their decoder gradients without float atomics: each block
// stores its partial sums, one row of E floats, to a scratch buffer, and
// `reduce_partials` adds the blocks in a fixed order, so a run is
// bit-repeatable.  A row's layout [dW1 (in,H) | db1 (H) | dW2 (H) | db2 |
// loss] equals the packed decoder vector's layout plus the summed loss.
// The kernels built for VD = 3 (the offset vector unencoded) keep their
// constants below; with positional encoding (VD != 3, up to MAXVD) the
// general forms are built once for each padded input width class and take
// VD at run time, and the tiled form takes F, H and VD at run time.  Each
// kernel's own design is described in its source.

#pragma once
#include <cuda_runtime.h>

namespace tk {

constexpr int F = 8;
constexpr int VD = 3;
constexpr int H = 64;
constexpr int IN = F + VD;
constexpr int C = F + 1;                  // feature row incl. the certainty column
constexpr int NP = IN * H + 2 * H + 1;    // packed decoder parameters
constexpr int E = NP + 1;                 // gradient entries + summed loss
constexpr int MAXK = 16;

// out[e] = the sum over blocks b of partial[b][e] in a fixed order: warp w
// of a reduction block adds blocks w, w + RW, w + 2 RW, ... in turn for 32
// consecutive entries (each load a coalesced 128-byte piece of a row, four
// in flight), then the RW warp sums are added in warp order.  One block per
// 32 entries, so each thread walks nblocks / RW partial rows, not all.
constexpr int RW = 8;                     // warps per reduction block

__global__ void __launch_bounds__(RW * 32) reduce_partials(const float* __restrict__ partial,
                                                           int nblocks, int ne,
                                                           float* __restrict__ out) {
  __shared__ float sums[RW][33];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (e < ne) {
    const float* p = partial + e;
    int b = w;
    for (; b + 3 * RW < nblocks; b += 4 * RW) {
      const float v0 = p[(long)b * ne], v1 = p[(long)(b + RW) * ne];
      const float v2 = p[(long)(b + 2 * RW) * ne], v3 = p[(long)(b + 3 * RW) * ne];
      a += v0;
      a += v1;
      a += v2;
      a += v3;
    }
    for (; b < nblocks; b += RW) a += p[(long)b * ne];
  }
  sums[w][lane] = a;
  __syncthreads();
  if (w == 0 && e < ne) {
    float t = sums[0][lane];
    for (int i = 1; i < RW; ++i) t += sums[i][lane];
    out[e] = t;
  }
}

// ne: the partial rows' width (E for VD = 3, (F + VD) H + 2 H + 2 otherwise)
inline int launch_reduce(const float* partial, int nblocks, float* out, cudaStream_t st,
                         int ne = E) {
  reduce_partials<<<(ne + 31) / 32, RW * 32, 0, st>>>(partial, nblocks, ne, out);
  return (int)cudaGetLastError();
}

}  // namespace tk

// The general forms (any VD up to MAXVD, positional encoding), redesigned
// for the H100.  Built for five padded input widths IP (16, 24, 36, 48, 72:
// NeRF band 1, band 2, bands 3-4, Gaussian 16 bands, the widest; `width_of`);
// a decode's IN = F + VD inputs are zero-padded to IP, W1's rows past IN are
// zero, and the padding never reaches the packed gradient.
// Bound: float32 FMAs, about 2 IN x 64 + 640 a decode (the forward, the
// feature gradient's 8 x 64, the decoder-gradient sums).  What held the first
// general form (PR 12) at 12-23x that bound: one shared-memory load per FMA
// (the decoder read from shared memory in every product, two loads per FMA
// in the gradient sums), the inputs built twice from strided global loads, and
// rows per block sized as if one block ran per SM.  This design:
//   - the rows come in groups of R; a launch has at most as many blocks as the
//     card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor over
//     the build that runs: two of 256 threads an SM), each taking groups b,
//     b + gridDim.x, ... with the decoder loaded once and the decoder-gradient
//     sums in registers across its groups, so the block partials that
//     `reduce_partials` adds number no more than the resident blocks;
//   - a group's D <= DMAX decodes are staged once: x (D, IP) in shared memory
//     from one flat cp.async copy of the group's rows (all copies in flight at
//     once), the weighted_first blend of the k feature rows done once from
//     the staged rows; the forward and the backward both read it;
//   - forward, per tile of TILE = 64 decodes: thread (dg, ug) computes the
//     pre-activations of 4 decodes x 4 hidden units as a register-blocked
//     product, each step a float4 of four inputs of each decode and a float4
//     of four units of each of four W1 rows (64 FMAs for 8 vector loads), the
//     inputs in order from 0, then + b1 (so the float64 checks see the same
//     ReLU masks).  z is kept in shared memory (no recomputation); the output
//     o = sum_j relu(z_j) W2_j and the feature gradient's factor P_f = sum_j
//     [z_j > 0] W2_j W1[f][j] (dx_f = dO P_f) are summed over the 16 unit
//     groups by a reduce-scatter of xor shuffles;
//   - backward: the dh pass turns z into dh = [z > 0] dO W2 in place (thread
//     (ug, s) adding db1, dW2, db2 over decodes s, s + DS, ...); then thread
//     (ug, ig, s) owns 4 hidden units x TI inputs of dW1 = X^T dH and adds
//     decodes s, s + S, ... in order, a register-blocked outer product fed by
//     float4 loads (TI x 4 FMAs for TI / 4 + 1 loads); the streams' sums are
//     staged and added in stream order at the block's end.
// Every sum has a fixed order and there are no float atomics, so two
// launches give the same bits.
namespace gen {

using tk::C;
using tk::F;
using tk::H;

constexpr int GB = 256;                   // threads per block
constexpr int UG = 16;                    // unit groups in the forward
constexpr int UW = H / UG;                // hidden units a thread: one float4 of a W1 row
constexpr int DW = 4;                     // decodes a thread in the forward
constexpr int TILE = GB / UG * DW;        // decodes a forward tile
constexpr int ZP = H + 4;                 // pitch of the staged pre-activations
constexpr int DMAX = 128;                 // decodes per block
constexpr int STAGE = DMAX * ZP;          // floats of the staging scratch (rows, then z)
constexpr int WMAX = 6 * (DMAX / 6) * tk::MAXK;   // staged IDW weights, at most
constexpr int MAXVD = 64;                 // widest offset vector
constexpr unsigned FULL = 0xffffffffu;
static_assert(UW == 4 && TILE == 64, "forward tile layout");

// Built with -DGEN_STAMPS (scripts/train_phases.py), thread 0 of each of the
// first STAMP_BLOCKS blocks adds the clock64() cycles since its last stamp to
// the block's entry n at GEN_STAMP(n) (after each phase's barrier), so an
// entry sums one phase over the block's groups; without it the stamps are
// empty.
#ifdef GEN_STAMPS
constexpr int STAMP_BLOCKS = 4096;
constexpr int NSTAMPS = 6;
__device__ long long stamps[STAMP_BLOCKS][NSTAMPS];
#define GEN_STAMP_START                                                          \
  long long stamp_t = clock64();                                                 \
  if (threadIdx.x == 0 && blockIdx.x < gen::STAMP_BLOCKS)                        \
    for (int i = 0; i < gen::NSTAMPS; ++i) gen::stamps[blockIdx.x][i] = 0
#define GEN_STAMP(n)                                                             \
  if (threadIdx.x == 0 && blockIdx.x < gen::STAMP_BLOCKS) {                      \
    const long long now = clock64();                                             \
    gen::stamps[blockIdx.x][n] += now - stamp_t;                                 \
    stamp_t = now;                                                               \
  }
#else
#define GEN_STAMP_START
#define GEN_STAMP(n)
#endif

// the padded input width of the build that takes offset width vd (0: none)
__host__ __device__ constexpr int width_of(int vd) {
  return vd < 1 || vd > MAXVD ? 0
       : F + vd <= 16 ? 16
       : F + vd <= 24 ? 24
       : F + vd <= 36 ? 36
       : F + vd <= 48 ? 48
       : 72;
}

// a width class: XP, the staging pitch of x (4 mod 8: a warp's two decode
// rows of the forward on distinct banks); TI inputs x 4 units of dW1 a
// backward thread, NIG input groups, S decode streams (16 NIG S <= GB); RED,
// the floats staging the streams' sums (dW1 of the S streams, then db1 and
// dW2 of the DS streams of the dh pass, then their db2)
constexpr int DS = GB / UG;               // decode streams of the dh pass
template <int IP>
struct Cls {
  static constexpr int XP = IP % 8 == 0 ? IP + 4 : IP + 8;
  static constexpr int TI = IP % 12 == 0 ? 12 : 8;
  static constexpr int NIG = IP / TI;
  static constexpr int S = GB / (UG * NIG);
  static constexpr int RED = (S * IP * H + DS * (2 * H + 1) + 3) & ~3;
  static_assert(IP % TI == 0 && S >= 1 && XP % 8 == 4, "width class");
};

__host__ __device__ constexpr int r4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// shared memory, in floats from the start: decoder W1 (IP, H) | b1 | W2;
// then xs (Dp, XP), zs (Dp, ZP) or the staged feature rows (stage floats),
// both later reused for the streams' sums; od (Dp) the outputs, then dO;
// pd (Dp, F) the factors P; ws (nw) the staged IDW weights; pwr (R) the rows'
// loss terms, then two more R-float arrays (the rows' per-row inputs, staged:
// label and weight, or the eikonal weight).  Dp: D rounded up to whole tiles.
struct Lay {
  int xs, zs, od, pd, ws, pwr, ra, rb, total;
};

template <int IP>
__host__ __device__ inline Lay layout(int D, int stage, int nw, int R) {
  const int Dp = (D + TILE - 1) / TILE * TILE;
  Lay l;
  l.xs = (IP + 2) * H;
  l.zs = l.xs + Dp * Cls<IP>::XP;
  const int u = imax(Dp * Cls<IP>::XP + imax(Dp * ZP, r4(stage)), Cls<IP>::RED);
  l.od = l.xs + u;
  l.pd = l.od + Dp;
  l.ws = l.pd + Dp * F;
  l.pwr = l.ws + r4(nw);
  l.ra = l.pwr + r4(R);
  l.rb = l.ra + r4(R);
  l.total = l.rb + r4(R);
  return l;
}

// the most any launch of the class takes (the dynamic shared memory opted in
// and the residency the wrappers size R with)
template <int IP>
__host__ __device__ inline int max_smem_floats() {
  return layout<IP>(DMAX, STAGE, WMAX, DMAX).total;
}

// a / b for block-local a < 2^22 from rb = 1.f / b: (a + 0.5) / b is at least
// 0.5 / b from an integer, far beyond the product's rounding
__device__ __forceinline__ int fdiv(int a, float rb) { return (int)((a + 0.5f) * rb); }

// one float global -> shared without a register (cp.async): a thread issues
// all its staging copies before it waits once (cp_wait, then a barrier)
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// the decoder into shared memory (cp4), W1's rows past `in` zero
template <int IP>
__device__ __forceinline__ void load_decoder(float* sm, const float* __restrict__ params,
                                             int in) {
  for (int e = threadIdx.x; e < (IP + 2) * H; e += GB) {
    if (e < IP * H && e >= in * H)
      sm[e] = 0.f;
    else
      cp4(sm + e, params + (e < IP * H ? e : in * H + e - IP * H));
  }
}

// Sums v[0..W) over the 16 lanes of a unit-group row (xor M = 8, 4, 2, 1) in
// a fixed order: while W > 1 each step keeps half the values (the upper half
// where lane bit M is set) and adds the partner's copy of them; once one value
// is left, the remaining steps add whole sums (a + b on one lane, b + a on its
// partner: the same bits).  Returns the index of the entry v[0] now holds (and
// v[1] the next one, where two are left).
template <int M, int W, int N>
__device__ __forceinline__ int hsum(float (&v)[N], int lane, int base) {
  if constexpr (M == 0) {
    return base;
  } else if constexpr (W > 1) {
    constexpr int HW = W / 2;
    const bool hi = (lane & M) != 0;
#pragma unroll
    for (int i = 0; i < HW; ++i) {
      const float send = hi ? v[i] : v[i + HW];
      const float keep = hi ? v[i + HW] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, M);
    }
    return hsum<M / 2, HW, N>(v, lane, hi ? base + HW : base);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] += __shfl_xor_sync(FULL, v[i], M);
    return hsum<M / 2, W, N>(v, lane, base);
  }
}

// The forward of tile t (decodes t TILE .. + TILE): z = x W1 (inputs in
// order) + b1 into zs, the output o + b2 into od and the factors P into pd,
// for the decodes below Dv.
template <int IP>
__device__ __forceinline__ void forward_tile(const float* sm, const float* xs, float* zs,
                                             float* od, float* pd, int t, int Dv, float b2) {
  constexpr int XP = Cls<IP>::XP;
  const int ug = threadIdx.x % UG, d0 = t * TILE + threadIdx.x / UG * DW;
  const float* W1 = sm + UW * ug;         // column 4 ug of each W1 row
  float z[DW][UW];
#pragma unroll
  for (int p = 0; p < DW; ++p)
#pragma unroll
    for (int u = 0; u < UW; ++u) z[p][u] = 0.f;
#pragma unroll
  for (int i = 0; i < IP; i += 4) {
    float x[DW][4], w[4][UW];
#pragma unroll
    for (int p = 0; p < DW; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(xs + (d0 + p) * XP + i);
      x[p][0] = v.x;
      x[p][1] = v.y;
      x[p][2] = v.z;
      x[p][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(W1 + (i + q) * H);
      w[q][0] = v.x;
      w[q][1] = v.y;
      w[q][2] = v.z;
      w[q][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < DW; ++p)
#pragma unroll
        for (int u = 0; u < UW; ++u) z[p][u] = fmaf(x[p][q], w[q][u], z[p][u]);
  }
  const float4 bv = *reinterpret_cast<const float4*>(sm + IP * H + UW * ug);
  const float4 wv = *reinterpret_cast<const float4*>(sm + IP * H + H + UW * ug);
  const float b1[UW] = {bv.x, bv.y, bv.z, bv.w}, w2[UW] = {wv.x, wv.y, wv.z, wv.w};
  float o[DW], g[DW][UW];
#pragma unroll
  for (int p = 0; p < DW; ++p) {
    o[p] = 0.f;
#pragma unroll
    for (int u = 0; u < UW; ++u) {
      const float zz = z[p][u] + b1[u];
      z[p][u] = zz;
      o[p] = fmaf(fmaxf(zz, 0.f), w2[u], o[p]);
      g[p][u] = zz > 0.f ? w2[u] : 0.f;
    }
    if (d0 + p < Dv)
      *reinterpret_cast<float4*>(zs + (d0 + p) * ZP + UW * ug) =
          make_float4(z[p][0], z[p][1], z[p][2], z[p][3]);
  }
  float P[DW * F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float4 v = *reinterpret_cast<const float4*>(W1 + f * H);
    const float wf[UW] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int p = 0; p < DW; ++p) {
      float a = 0.f;
#pragma unroll
      for (int u = 0; u < UW; ++u) a = fmaf(g[p][u], wf[u], a);
      P[p * F + f] = a;
    }
  }
  const int po = hsum<UG / 2, DW, DW>(o, ug, 0);   // four lanes hold each output
  if (ug % (UG / DW) == 0 && d0 + po < Dv) od[d0 + po] = o[0] + b2;
  const int pp = hsum<UG / 2, DW * F, DW * F>(P, ug, 0);   // P[0], P[1]: entries pp, pp + 1
  if (d0 + pp / F < Dv) {
    pd[(d0 + pp / F) * F + pp % F] = P[0];
    pd[(d0 + pp / F) * F + pp % F + 1] = P[1];
  }
}

// a thread's sums: dW1 (TI inputs x 4 units, as a backward thread), and
// db1, dW2, db2 (4 units, as a thread of the dh pass)
template <int IP>
struct Grad {
  float w1[Cls<IP>::TI][UW];
  float b1[UW], w2[UW], b2;
};

template <int IP>
__device__ __forceinline__ void grad_init(Grad<IP>& a) {
#pragma unroll
  for (int u = 0; u < UW; ++u) {
#pragma unroll
    for (int i = 0; i < Cls<IP>::TI; ++i) a.w1[i][u] = 0.f;
    a.b1[u] = 0.f;
    a.w2[u] = 0.f;
  }
  a.b2 = 0.f;
}

// The dh pass over a group's Dv decodes (dO in od): z in zs becomes dh = [z >
// 0] dO W2, in place, and thread (ug, s) adds decodes s, s + DS, ... to db1
// (dh), dW2 (dO relu(z)) and, for ug = 0, db2 (dO), in order.
template <int IP>
__device__ __forceinline__ void dh_pass(const float* sm, float* zs, const float* od, int Dv,
                                        Grad<IP>& a) {
  const int ug = threadIdx.x % UG, s = threadIdx.x / UG;
  const float4 wv = *reinterpret_cast<const float4*>(sm + IP * H + H + UW * ug);
  const float w2[UW] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll 2
  for (int d = s; d < Dv; d += DS) {
    const float dO = od[d];
    float4* zp = reinterpret_cast<float4*>(zs + d * ZP + UW * ug);
    const float4 zv = *zp;
    const float z[UW] = {zv.x, zv.y, zv.z, zv.w};
    float dh[UW];
#pragma unroll
    for (int u = 0; u < UW; ++u) {
      dh[u] = z[u] > 0.f ? dO * w2[u] : 0.f;
      a.b1[u] += dh[u];
      a.w2[u] = fmaf(dO, fmaxf(z[u], 0.f), a.w2[u]);
    }
    if (ug == 0) a.b2 += dO;
    *zp = make_float4(dh[0], dh[1], dh[2], dh[3]);
  }
}

// Adds a group's Dv decodes (dh in zs) to dW1 = X^T dH: thread (ug, ig, s)
// adds decodes s, s + S, ... in order.
template <int IP>
__device__ __forceinline__ void backward(const float* xs, const float* zs, int Dv, Grad<IP>& a) {
  using K = Cls<IP>;
  const int ug = threadIdx.x % UG, rest = threadIdx.x / UG;
  const int ig = rest % K::NIG, s = rest / K::NIG;
  if (s >= K::S) return;
#pragma unroll 2
  for (int d = s; d < Dv; d += K::S) {
    const float4 hv = *reinterpret_cast<const float4*>(zs + d * ZP + UW * ug);
    const float dh[UW] = {hv.x, hv.y, hv.z, hv.w};
    float x[K::TI];
#pragma unroll
    for (int q = 0; q < K::TI / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(xs + d * K::XP + ig * K::TI + 4 * q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < K::TI; ++i)
#pragma unroll
      for (int u = 0; u < UW; ++u) a.w1[i][u] = fmaf(x[i], dh[u], a.w1[i][u]);
  }
}

// warp 0's running loss: lane l adds the group's terms l, l + 32, ... in order
__device__ __forceinline__ void loss_add(float& l, const float* pwr, int rows) {
  if (threadIdx.x < 32)
    for (int r = threadIdx.x; r < rows; r += 32) l += pwr[r];
}

// The block's partial row [dW1 (in, H) | db1 | dW2 | db2 | loss]: the
// streams' sums staged at red (the x / z staging, free by now) and added in
// stream order (S streams of dW1, DS of the rest); warp 0's running loss (loss_add) added over its lanes by xor
// shuffles.  Call after a barrier.
template <int IP>
__device__ __forceinline__ void store_partial(float* red, const Grad<IP>& a, float loss, int in,
                                              float* __restrict__ pb) {
  using K = Cls<IP>;
  const int tid = threadIdx.x, ug = tid % UG, rest = tid / UG;
  const int ig = rest % K::NIG, s = rest / K::NIG;
  float* rb = red + K::S * IP * H;         // (DS, 2, H) db1, dW2, then (DS) db2
  if (s < K::S) {
#pragma unroll
    for (int i = 0; i < K::TI; ++i)
      *reinterpret_cast<float4*>(red + (s * IP + ig * K::TI + i) * H + UW * ug) =
          make_float4(a.w1[i][0], a.w1[i][1], a.w1[i][2], a.w1[i][3]);
  }
  *reinterpret_cast<float4*>(rb + 2 * rest * H + UW * ug) =
      make_float4(a.b1[0], a.b1[1], a.b1[2], a.b1[3]);
  *reinterpret_cast<float4*>(rb + (2 * rest + 1) * H + UW * ug) =
      make_float4(a.w2[0], a.w2[1], a.w2[2], a.w2[3]);
  if (ug == 0) rb[2 * DS * H + rest] = a.b2;
  __syncthreads();
  const int nw1 = in * H, np = nw1 + 2 * H + 1;
  for (int e = tid; e < np; e += GB) {
    const float* v;
    int stride;
    if (e < nw1) {
      v = red + e;
      stride = IP * H;
    } else if (e < np - 1) {
      v = rb + (e - nw1);
      stride = 2 * H;
    } else {
      v = rb + 2 * DS * H;
      stride = 1;
    }
    float t = v[0];
    if (e < nw1) {
#pragma unroll
      for (int m = 1; m < K::S; ++m) t += v[m * stride];
    } else {
#pragma unroll
      for (int m = 1; m < DS; ++m) t += v[m * stride];
    }
    pb[e] = t;
  }
  if (tid < 32) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) loss += __shfl_xor_sync(FULL, loss, m);
    if (tid == 0) pb[np] = loss;
  }
}

}  // namespace gen

// return fn<IP, WF>(args...) for the general form's build of vd's width
// class (in a function templated on WF, with vd in scope)
#define GEN_DISPATCH(fn, ...)                                    \
  switch (gen::width_of(vd)) {                                   \
    case 16: return fn<16, WF>(__VA_ARGS__);                     \
    case 24: return fn<24, WF>(__VA_ARGS__);                     \
    case 36: return fn<36, WF>(__VA_ARGS__);                     \
    case 48: return fn<48, WF>(__VA_ARGS__);                     \
    case 72: return fn<72, WF>(__VA_ARGS__);                     \
    default: return (int)cudaErrorInvalidValue;                  \
  }

// The tiled general form: every (F, H, VD) the wrappers' predicate takes
// (ops/train_kernel.kernels_take: F <= 64, H <= 256, VD <= 195, k <= 16)
// outside the width classes above (which keep F = 8, H = 64, VD <= 64).
// F, H and VD are run-time values: the register blocks below are fixed
// (4 x 4), and the loops run over input quads, 64-unit tiles of the hidden
// layer and 64-decode tiles.  Zero padding is exact: inputs to IP (a
// multiple of 8), hidden units to HP (a multiple of 64) with zero W1
// columns, b1 and W2 entries (z = 0, relu 0, a [z > 0] mask of 0, zero
// gradients), features to FP (a multiple of 4) in the feature gradient.
// Per block (the launch has at most the resident blocks, each taking groups
// of R rows in turn, as above), shared memory holds
//   - W1 (IP, HP) for the whole launch when it fits ("resident"), else one
//     64-unit slab at a time, staged again for each use;
//   - b1, W2 (HP);
//   - a chunk of DC decodes' inputs x (DC, IP) and pre-activations z
//     (DC, HP); a group of D <= DMAX decodes runs in ceil(D / DC) chunks;
//     with more than one, the backward stages each chunk's x and z again
//     (the same bits: the same code on the same inputs), so a group's
//     shared memory does not grow with D;
//   - the group's outputs, then dO (DMAX), its feature gradients dX
//     (DMAX, FP), its IDW weights and per-row values.
// `plan` picks, in order, the first layout that fits two blocks an SM, then
// one: W1 resident before a slab, DMAX 128 / 96 / 64, DC 128 / 64.  At the
// widest (F 64, H 256, VD 195) W1 alone is 264 KB, so it streams in slabs.
// Passes per chunk:
//   forward: thread (ug, dg) computes 4 decodes x 4 units a tile, a float4
//     of four inputs of each decode and a float4 of four units of each of
//     four W1 rows per step (64 FMAs for 8 vector loads), the inputs in
//     order from 0, then + b1; each tile's share of the outputs o (a
//     thread's 4 units, then its 16 unit groups by xor shuffles) added to o
//     tile after tile, + b2 last;
//   dh: thread (j, s) (unit j, decode stream s of GB / HP) turns z into dh
//     = [z > 0] dO W2_j in place over its stream's decodes and keeps db1_j
//     and dW2_j in registers across the block's groups (streams added in
//     order at the block's end);
//   dW1 = X^T dH: task (input quad, unit quad) adds the chunk's decodes in
//     order (16 FMAs for two float4 loads) and adds its 4 x 4 sums to the
//     block's partial row in global memory; the block's own row, so each
//     entry has one writer and a fixed order: groups in turn, chunks in
//     turn, decodes in order (the dW1 sums of all units do not fit in
//     registers at H = 256: 66 k floats);
//   dX = dH W1[:F]^T: task (feature quad, decode) for four decodes a
//     quarter of the chunk apart (lanes on consecutive decode rows: no bank
//     conflicts), summed over the units in order (over slabs in order when
//     W1 streams).
// No float atomics: two launches give the same bits.
namespace gtl {

using gen::cp4;
using gen::cp_wait;

constexpr int GB = 256;                   // threads per block
constexpr int UG = 16;                    // unit groups of a forward tile
constexpr int UW = 4;                     // units a thread in the forward
constexpr int DW = 4;                     // decodes a thread in the forward
constexpr int UT = UG * UW;               // units a tile, and a W1 slab
constexpr int TILE = GB / UG * DW;        // decodes a forward tile
constexpr int MAXF = 64, MAXH = 256, MAXVD = 195;
constexpr int SMEM_TWO = 115712 / 4;      // floats a block with two an SM (H100: 228 KB
constexpr int SMEM_ONE = 232448 / 4;      // an SM, 1 KB reserved a block); one an SM
constexpr unsigned FULL = 0xffffffffu;
static_assert(UT == 64 && TILE == 64 && MAXH <= GB, "tile layout; one dh thread a unit");

__host__ __device__ constexpr int rup(int x, int m) { return (x + m - 1) / m * m; }

// a launch's widths and its shared-memory layout (floats from the start)
struct Plan {
  int ok, F, H, vd, in, C, IP, XP, HP, ZP, FP;
  int res, WC, DC, DMAX;                  // W1 resident; W1 columns staged; chunk; group
  int w1, b1, w2, xs, zs, od, pd, ws, pwr, ra, rb, total;
};

// the layout for (F, H, vd, k) and mode (ok = 0: none fits, or a width
// past the predicate's)
__host__ __device__ inline Plan plan(int F, int H, int vd, int k, bool wf, bool eik) {
  Plan p{};
  if (F < 1 || F > MAXF || H < 1 || H > MAXH || vd < 1 || vd > MAXVD || k < 1 || k > tk::MAXK)
    return p;
  p.F = F;
  p.H = H;
  p.vd = vd;
  p.in = F + vd;
  p.C = F + 1;
  p.IP = rup(p.in, 8);
  p.XP = p.IP + 4;                        // 4 mod 8: two decode rows a warp on distinct banks
  p.HP = rup(H, UT);
  p.ZP = p.HP + 4;                        // 4 mod 32: consecutive rows on distinct banks
  p.FP = rup(F, 4);
  const int dr = (eik ? 6 : 1) * (wf ? 1 : k);   // decodes a row
  const int budget[2] = {SMEM_TWO, SMEM_ONE};
  const int dmax[3] = {128, 96, 64};
  for (int b = 0; b < 2; ++b)
    for (int res = 1; res >= 0; --res)
      for (int m = 0; m < 3; ++m)
        for (int DC = 128; DC >= TILE; DC -= TILE) {
          const int DMAX = dmax[m];
          if (DMAX < dr || DC > rup(DMAX, TILE)) continue;
          const int rmax = DMAX / dr, nw = (eik ? 6 : 1) * rmax * k;
          p.res = res;
          p.WC = res ? p.HP : UT;
          p.DC = DC;
          p.DMAX = DMAX;
          int o = 0;
          p.w1 = o;
          o += p.IP * p.WC;
          p.b1 = o;
          o += p.HP;
          p.w2 = o;
          o += p.HP;
          p.xs = o;
          o += DC * p.XP;
          p.zs = o;
          o += DC * p.ZP;
          p.od = o;
          o += rup(DMAX, 4);
          p.pd = o;
          o += DMAX * p.FP;
          p.ws = o;
          o += rup(nw, 4);
          p.pwr = o;
          o += rup(rmax, 4);
          p.ra = o;
          o += rup(rmax, 4);
          p.rb = o;
          o += rup(rmax, 4);
          p.total = o;
          if (o <= budget[b]) {
            p.ok = 1;
            return p;
          }
        }
  p.ok = 0;
  return p;
}

// W1 rows [0, rows) x hidden columns [c0, c0 + WC) into w1s (pitch WC), zero
// past `in` rows and H columns; waited for with cp_wait
__device__ __forceinline__ void stage_w1(float* w1s, const float* __restrict__ params,
                                         const Plan& P, int c0, int rows) {
  const int nc = P.WC;
  for (int e = threadIdx.x; e < rows * nc; e += GB) {
    const int i = e / nc, u = e - i * nc, j = c0 + u;
    if (i < P.in && j < P.H)
      cp4(w1s + e, params + i * P.H + j);
    else
      w1s[e] = 0.f;
  }
}

// forward tile t of a chunk: z = x W1 (inputs in order) + b1 for the 64
// units at W (pitch WC), b1, zs (pitch ZP), for the decodes below Dc; with
// `od`, the tile's share of each output, sum_j relu(z_j) W2_j over its 64
// units (each thread's 4 in order, then the 16 unit groups by xor
// shuffles), added to od (set by the first unit tile)
__device__ __forceinline__ void fwd_tile(const float* xs, const float* W, const float* b1,
                                         const float* w2, float* zs, float* od, bool first,
                                         const Plan& P, int t, int Dc) {
  const int ug = threadIdx.x % UG, d0 = t * TILE + threadIdx.x / UG * DW;
  const float* Wc = W + UW * ug;
  float z[DW][UW];
#pragma unroll
  for (int p = 0; p < DW; ++p)
#pragma unroll
    for (int u = 0; u < UW; ++u) z[p][u] = 0.f;
#pragma unroll 2
  for (int i = 0; i < P.IP; i += 4) {
    float x[DW][4], w[4][UW];
#pragma unroll
    for (int p = 0; p < DW; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(xs + (d0 + p) * P.XP + i);
      x[p][0] = v.x;
      x[p][1] = v.y;
      x[p][2] = v.z;
      x[p][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(Wc + (i + q) * P.WC);
      w[q][0] = v.x;
      w[q][1] = v.y;
      w[q][2] = v.z;
      w[q][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < DW; ++p)
#pragma unroll
        for (int u = 0; u < UW; ++u) z[p][u] = fmaf(x[p][q], w[q][u], z[p][u]);
  }
  const float4 bv = *reinterpret_cast<const float4*>(b1 + UW * ug);
  const float bb[UW] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int p = 0; p < DW; ++p) {
#pragma unroll
    for (int u = 0; u < UW; ++u) z[p][u] += bb[u];
    if (d0 + p < Dc)
      *reinterpret_cast<float4*>(zs + (d0 + p) * P.ZP + UW * ug) =
          make_float4(z[p][0], z[p][1], z[p][2], z[p][3]);
  }
  if (od == nullptr) return;
  const float4 wv = *reinterpret_cast<const float4*>(w2 + UW * ug);
  const float ww[UW] = {wv.x, wv.y, wv.z, wv.w};
  float o[DW];
#pragma unroll
  for (int p = 0; p < DW; ++p) {
    o[p] = 0.f;
#pragma unroll
    for (int u = 0; u < UW; ++u) o[p] = fmaf(fmaxf(z[p][u], 0.f), ww[u], o[p]);
#pragma unroll
    for (int m = UG / 2; m >= 1; m >>= 1) o[p] += __shfl_xor_sync(FULL, o[p], m);
  }
  if (ug == 0)
#pragma unroll
    for (int p = 0; p < DW; ++p)
      if (d0 + p < Dc) od[d0 + p] = first ? o[p] : od[d0 + p] + o[p];
}

// a chunk's forward (x staged): z for every unit tile, W1 slab by slab when
// it streams, and with `od` the outputs o + b2 (``fwd_tile``); ends with a
// barrier
__device__ __forceinline__ void forward(float* w1s, const float* b1s, const float* w2s,
                                        const float* xs, float* zs, float* od, float b2,
                                        const float* __restrict__ params, const Plan& P, int Dc) {
  const int nt = (Dc + TILE - 1) / TILE;
  for (int ut = 0; ut < P.HP / UT; ++ut) {
    if (!P.res) {
      __syncthreads();                    // the last slab read
      stage_w1(w1s, params, P, ut * UT, P.IP);
      cp_wait();
      __syncthreads();
    }
    const float* W = w1s + (P.res ? ut * UT : 0);
    for (int t = 0; t < nt; ++t)
      fwd_tile(xs, W, b1s + ut * UT, w2s + ut * UT, zs + ut * UT, od, ut == 0, P, t, Dc);
  }
  if (od != nullptr) {
    __syncthreads();
    for (int d = threadIdx.x; d < Dc; d += GB) od[d] += b2;
  }
  __syncthreads();
}

// z becomes dh = [z > 0] dO W2 in place; thread (j, s) (unit j, one of GB /
// HP decode streams) adds unit j's db1 (dh) and dW2 (dO relu(z)) over
// decodes s, s + streams, ... in order
__device__ __forceinline__ void dh_pass(float* zs, const float* w2s, const float* dO,
                                        const Plan& P, int Dc, float& sb1, float& sw2) {
  const int ns = GB / P.HP, j = threadIdx.x % P.HP, st = threadIdx.x / P.HP;
  if (st >= ns) return;
  const float w2 = w2s[j];
#pragma unroll 4
  for (int d = st; d < Dc; d += ns) {
    const float g = dO[d];
    float* zp = zs + d * P.ZP + j;
    const float z = *zp;
    const float h = z > 0.f ? g * w2 : 0.f;
    sb1 += h;
    sw2 = fmaf(g, fmaxf(z, 0.f), sw2);
    *zp = h;
  }
}

// the chunk's dW1 = X^T dH added to the block's partial row pb
__device__ __forceinline__ void dw1_pass(const float* xs, const float* zs,
                                         float* __restrict__ pb, const Plan& P, int Dc) {
  const int nj = P.HP / 4, nt = P.IP / 4 * nj;
  for (int t = threadIdx.x; t < nt; t += GB) {
    const int iq = t / nj, jq = t - iq * nj;
    float a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < Dc; ++d) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + d * P.XP + 4 * iq);
      const float4 hv = *reinterpret_cast<const float4*>(zs + d * P.ZP + 4 * jq);
      const float x[4] = {xv.x, xv.y, xv.z, xv.w}, h[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) a[r][c] = fmaf(x[r], h[c], a[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * iq + r;
      if (i < P.in)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * jq + c < P.H) pb[i * P.H + 4 * jq + c] += a[r][c];
    }
  }
}

// pd (pitch FP) = (first ? 0 : pd) + dH W[:FP]^T over the nc units of dh
// (zs, pitch ZP) and W (pitch WC), for the chunk's Dc decodes
__device__ __forceinline__ void dx_pass(const float* zs, const float* W, float* pd, const Plan& P,
                                        int Dc, int nc, bool first) {
  const int nf = P.FP / 4, nd = (Dc + 3) / 4, nt = nf * nd;
  for (int t = threadIdx.x; t < nt; t += GB) {
    const int fq = t / nd, dq = t - fq * nd;
    float a[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[p][q] = 0.f;
#pragma unroll 2
    for (int u = 0; u < nc; u += 4) {
      float h[4][4], w[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(zs + (dq + p * nd) * P.ZP + u);
        h[p][0] = v.x;
        h[p][1] = v.y;
        h[p][2] = v.z;
        h[p][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(W + (4 * fq + q) * P.WC + u);
        w[q][0] = v.x;
        w[q][1] = v.y;
        w[q][2] = v.z;
        w[q][3] = v.w;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int uu = 0; uu < 4; ++uu) a[p][q] = fmaf(h[p][uu], w[q][uu], a[p][q]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int d = dq + p * nd;
      if (d < Dc)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float* o = pd + d * P.FP + 4 * fq + q;
          *o = first ? a[p][q] : *o + a[p][q];
        }
    }
  }
}

// the chunk's feature gradients dX = dH W1[:F]^T into pd, over the slabs in
// order when W1 streams
__device__ __forceinline__ void feature_grad(float* w1s, const float* zs, float* pd,
                                             const float* __restrict__ params, const Plan& P,
                                             int Dc) {
  if (P.res) {
    dx_pass(zs, w1s, pd, P, Dc, P.HP, true);
    return;
  }
  for (int ut = 0; ut < P.HP / UT; ++ut) {
    __syncthreads();                      // the last slab read
    stage_w1(w1s, params, P, ut * UT, P.FP);
    cp_wait();
    __syncthreads();
    dx_pass(zs + ut * UT, w1s, pd, P, Dc, UT, ut == 0);
  }
}

// the decoder's b1, W2 (zero past H) and, when resident, W1; the block's
// partial dW1 zeroed (it accumulates there); x zeroed once (its columns
// past `in` stay zero).  Ends with a barrier.
__device__ __forceinline__ void block_start(float* sm, const float* __restrict__ params,
                                            const Plan& P, float* __restrict__ pb) {
  const int n1 = P.in * P.H;
  for (int j = threadIdx.x; j < P.HP; j += GB) {
    sm[P.b1 + j] = j < P.H ? params[n1 + j] : 0.f;
    sm[P.w2 + j] = j < P.H ? params[n1 + P.H + j] : 0.f;
  }
  if (P.res) stage_w1(sm + P.w1, params, P, 0, P.IP);
  for (int e = threadIdx.x; e < P.DC * P.XP; e += GB) sm[P.xs + e] = 0.f;
  for (int e = threadIdx.x; e < n1; e += GB) pb[e] = 0.f;
  cp_wait();
  __syncthreads();
}

// warp 0 adds the group's n terms v[0..n) to its running sum, lane l the
// terms l, l + 32, ... in order, then xor shuffles (every lane the same
// bits); call from all of warp 0
__device__ __forceinline__ float warp_sum(const float* v, int n) {
  float a = 0.f;
  for (int i = threadIdx.x; i < n; i += 32) a += v[i];
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) a += __shfl_xor_sync(FULL, a, m);
  return a;
}

// the block's partial row's last entries: db1, dW2 (the dh pass's streams,
// staged at red and added in stream order by thread j: unit j), db2 and the
// loss (thread 0).  Call after a barrier; red is free shared memory of 2 GB
// floats.
__device__ __forceinline__ void block_end(const Plan& P, float sb1, float sw2, float db2,
                                          float loss, float* red, float* __restrict__ pb) {
  const int n1 = P.in * P.H, t = threadIdx.x, ns = GB / P.HP;
  if (t < ns * P.HP) {
    red[t] = sb1;                         // thread (j, s) at s HP + j
    red[GB + t] = sw2;
  }
  __syncthreads();
  if (t < P.H) {
    float a = red[t], b = red[GB + t];
    for (int s = 1; s < ns; ++s) {
      a += red[s * P.HP + t];
      b += red[GB + s * P.HP + t];
    }
    pb[n1 + t] = a;
    pb[n1 + P.H + t] = b;
  }
  if (t == 0) {
    pb[n1 + 2 * P.H] = db2;
    pb[n1 + 2 * P.H + 1] = loss;
  }
}

}  // namespace gtl
