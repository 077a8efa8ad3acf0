// Shared pieces of the training-iteration and eikonal kernels
// (csrc/train_iter.cu, csrc/eikonal.cu): the decoder's shapes, the
// fixed-order sum of the blocks' partial gradients, and the decode chunk of
// the kernels' general forms (any offset width VD, namespace gen).
//
// Both kernels take the one-hidden-layer decoder (W1 in x H, b1, W2, b2;
// F = 8 features + VD offset dims in, H = 64 hidden) as one packed vector,
// and write their decoder gradients without float atomics: each block
// stores its partial sums, one row of E floats, to a scratch buffer, and
// `reduce_partials` adds the blocks in a fixed order, so a run is
// bit-repeatable.  A row's layout [dW1 (in,H) | db1 (H) | dW2 (H) | db2 |
// loss] equals the packed decoder vector's layout plus the summed loss.
// The kernels built for VD = 3 (the offset vector unencoded) keep their
// constants below; with positional encoding (VD = 9 .. MAXVD) the general
// forms take VD at run time.  Each kernel's own design is described in its
// source.

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

// ne: the partial rows' width (E for VD = 3, gen::Dims::ne otherwise)
inline int launch_reduce(const float* partial, int nblocks, float* out, cudaStream_t st,
                         int ne = E) {
  reduce_partials<<<(ne + 31) / 32, RW * 32, 0, st>>>(partial, nblocks, ne, out);
  return (int)cudaGetLastError();
}

}  // namespace tk

// The general forms (any VD up to MAXVD).  A block of GB = 256 threads runs
// its decodes in chunks of SLOTS = 64: the chunk's inputs x (in = F + VD a
// decode) are staged in shared memory by the kernel (`build`), four lanes
// share a decode, each taking 16 of the 64 hidden units (unit 4t + lane)
// with the decoder read from shared memory, and add their partial output and
// feature gradients by two xor shuffles.  The backward stages each decode's
// activations h and their gradients dh; the block then adds the chunk's
// decoder-gradient terms once: thread (g, j) owns hidden unit j and the
// inputs i = g, g + 4, ... (at most APT = 18 sums in registers), adding
// x_i dh_j over the chunk's decodes in order, and one quarter each the unit's
// db1 (dh_j), dW2 (dO h_j) and, for j = 0, db2 (dO).  Every sum has a fixed
// order, so two launches give the same bits.  Pre-activations are summed as
// in the VD = 3 kernels: fma over the inputs in order from 0, then + b1.
namespace gen {

using tk::C;
using tk::F;
using tk::H;

constexpr int GB = 256;                   // threads per block
constexpr int LANES = 4;                  // lanes per decode
constexpr int SLOTS = GB / LANES;         // decodes per chunk
constexpr int UPL = H / LANES;            // hidden units per lane
constexpr int HP = H + 4;                 // staging pitch of h and dh
constexpr int MAXVD = 64;                 // widest offset vector
constexpr int MAXIN = F + MAXVD;
constexpr int GROUPS = GB / H;            // input groups of the decoder-gradient owners
constexpr int APT = (MAXIN + GROUPS - 1) / GROUPS;   // dW1 sums a thread
constexpr int DMAX = 512;                 // decodes per block
constexpr unsigned FULL = 0xffffffffu;

struct Dims {
  int vd, in, xp, np, ne, par;
};

// in: inputs a decode; xp: their odd staging pitch (8 decodes of a warp on
// distinct banks); np / ne: packed decoder / partial row; par: np padded to 4
__host__ __device__ inline Dims dims(int vd) {
  Dims d;
  d.vd = vd;
  d.in = F + vd;
  d.xp = d.in | 1;
  d.np = d.in * H + 2 * H + 1;
  d.ne = d.np + 1;
  d.par = (d.np + 3) & ~3;
  return d;
}

// shared memory in floats: decoder | xs (SLOTS, xp) | hs, dhs (SLOTS, HP) |
// od (D) | dxs (D, F) | the rows' loss terms (R)
__host__ __device__ inline int smem_floats(const Dims& m, int D, int R) {
  return m.par + SLOTS * m.xp + 2 * SLOTS * HP + D * (1 + F) + R;
}

struct Smem {
  float *W1, *b1, *W2, *xs, *hs, *dhs, *od, *dxs, *pwr;
};

__device__ inline Smem carve(float* sm, const Dims& m, int D) {
  Smem s;
  s.W1 = sm;
  s.b1 = sm + m.in * H;
  s.W2 = s.b1 + H;
  s.xs = sm + m.par;
  s.hs = s.xs + SLOTS * m.xp;
  s.dhs = s.hs + SLOTS * HP;
  s.od = s.dhs + SLOTS * HP;
  s.dxs = s.od + D;
  s.pwr = s.dxs + D * F;
  return s;
}

// the lane's UPL pre-activations (before b1) of the decode staged at x
__device__ __forceinline__ void preacts(const Smem& s, const float* x, int in, int lane,
                                       float (&z)[UPL]) {
#pragma unroll
  for (int t = 0; t < UPL; ++t) z[t] = 0.f;
#pragma unroll 2
  for (int i = 0; i < in; ++i) {
    const float xi = x[i];
    const float* wr = s.W1 + i * H + lane;
#pragma unroll
    for (int t = 0; t < UPL; ++t) z[t] = fmaf(xi, wr[LANES * t], z[t]);
  }
}

// the decode's raw output (without b2), in every lane of its group
__device__ __forceinline__ float forward(const Smem& s, const float* x, int in, int lane) {
  float z[UPL];
  preacts(s, x, in, lane, z);
  float o = 0.f;
#pragma unroll
  for (int t = 0; t < UPL; ++t) {
    const int j = LANES * t + lane;
    o = fmaf(fmaxf(z[t] + s.b1[j], 0.f), s.W2[j], o);
  }
  o += __shfl_xor_sync(FULL, o, 1);
  o += __shfl_xor_sync(FULL, o, 2);
  return o;
}

// the decode's backward with upstream gradient dO: h and dh staged in rows
// hr, dhr; the F feature gradients summed over the lanes, in every lane
__device__ __forceinline__ void backward(const Smem& s, const float* x, int in, int lane,
                                         float dO, float* hr, float* dhr, float (&dx)[F]) {
  float z[UPL];
  preacts(s, x, in, lane, z);
#pragma unroll
  for (int f = 0; f < F; ++f) dx[f] = 0.f;
#pragma unroll
  for (int t = 0; t < UPL; ++t) {
    const int j = LANES * t + lane;
    const float zz = z[t] + s.b1[j];
    const float dh = zz > 0.f ? dO * s.W2[j] : 0.f;
    hr[j] = fmaxf(zz, 0.f);
    dhr[j] = dh;
#pragma unroll
    for (int f = 0; f < F; ++f) dx[f] = fmaf(dh, s.W1[f * H + j], dx[f]);
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    dx[f] += __shfl_xor_sync(FULL, dx[f], 1);
    dx[f] += __shfl_xor_sync(FULL, dx[f], 2);
  }
}

// the decoder-gradient owner's sums over a chunk's nd decodes (dO in od0)
struct Acc {
  float w1[APT];
  float a;                                // db1 (group 0), dW2 (group 1), db2 (group 2)
};

__device__ __forceinline__ void acc_init(Acc& a) {
#pragma unroll
  for (int m = 0; m < APT; ++m) a.w1[m] = 0.f;
  a.a = 0.f;
}

__device__ __forceinline__ void acc_chunk(const Smem& s, const Dims& m, const float* od0,
                                          int nd, int grp, int jo, Acc& a) {
  for (int q = 0; q < nd; ++q) {
    const float dh = s.dhs[q * HP + jo];
    const float* xr = s.xs + q * m.xp;
#pragma unroll
    for (int u = 0; u < APT; ++u) {
      const int i = grp + GROUPS * u;
      if (i < m.in) a.w1[u] = fmaf(xr[i], dh, a.w1[u]);
    }
    if (grp == 0)
      a.a += dh;
    else if (grp == 1)
      a.a = fmaf(od0[q], s.hs[q * HP + jo], a.a);
    else if (grp == 2 && jo == 0)
      a.a += od0[q];
  }
}

// the block's partial row: each owner's sums, the loss (terms in row order)
__device__ __forceinline__ void store_partial(const Smem& s, const Dims& m, const Acc& a,
                                              int grp, int jo, int rows, float* pb) {
#pragma unroll
  for (int u = 0; u < APT; ++u) {
    const int i = grp + GROUPS * u;
    if (i < m.in) pb[i * H + jo] = a.w1[u];
  }
  if (grp == 0) pb[m.in * H + jo] = a.a;
  if (grp == 1) pb[m.in * H + H + jo] = a.a;
  if (grp == 2 && jo == 0) pb[m.in * H + 2 * H] = a.a;
  if (threadIdx.x == GB - 1) {
    float l = 0.f;
    for (int r = 0; r < rows; ++r) l += s.pwr[r];
    pb[m.ne - 1] = l;
  }
}

}  // namespace gen
