// Shared pieces of the training-iteration and eikonal kernels
// (csrc/train_iter.cu, csrc/eikonal.cu): the decoder's shapes and the
// fixed-order sum of the blocks' partial gradients.
//
// Both kernels take the one-hidden-layer decoder (W1 in x H, b1, W2, b2;
// F = 8 features + VD = 3 offset dims in, H = 64 hidden) as one packed
// vector, and write their decoder gradients without float atomics: each
// block stores its partial sums, one row of E floats, to a scratch buffer,
// and `reduce_partials` adds the blocks in a fixed order, so a run is
// bit-repeatable.  A row's layout [dW1 (in,H) | db1 (H) | dW2 (H) | db2 |
// loss] equals the packed decoder vector's layout plus the summed loss.
// Each kernel's own design is described in its source.

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
                                                           int nblocks,
                                                           float* __restrict__ out) {
  __shared__ float sums[RW][33];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (e < E) {
    const float* p = partial + e;
    int b = w;
    for (; b + 3 * RW < nblocks; b += 4 * RW) {
      const float v0 = p[(long)b * E], v1 = p[(long)(b + RW) * E];
      const float v2 = p[(long)(b + 2 * RW) * E], v3 = p[(long)(b + 3 * RW) * E];
      a += v0;
      a += v1;
      a += v2;
      a += v3;
    }
    for (; b < nblocks; b += RW) a += p[(long)b * E];
  }
  sums[w][lane] = a;
  __syncthreads();
  if (w == 0 && e < E) {
    float t = sums[0][lane];
    for (int i = 1; i < RW; ++i) t += sums[i][lane];
    out[e] = t;
  }
}

inline int launch_reduce(const float* partial, int nblocks, float* out, cudaStream_t st) {
  reduce_partials<<<(E + 31) / 32, RW * 32, 0, st>>>(partial, nblocks, out);
  return (int)cudaGetLastError();
}

}  // namespace tk
