// Shared pieces of the training-iteration and eikonal kernels
// (csrc/train_iter.cu, csrc/eikonal.cu).
//
// Both kernels run one thread per batch row, with the one-hidden-layer
// decoder (W1 in x H, b1, W2, b2; F = 8 features + VD = 3 offset dims in,
// H = 64 hidden) staged in shared memory.  Hidden activations are never
// stored per row: each decode is recomputed in the backward pass (11 FMAs per
// hidden unit), which keeps the per-thread state to a few dozen registers.
//
// Decoder gradients without float atomics: every backward "step" (one
// decode) writes its row's x, h, dh, dO and loss term to shared memory; the
// block then sums each of the E = in*H + 2H + 2 gradient entries over its
// rows in a fixed order into per-thread accumulators.  Each block stores its
// partial sums to a scratch buffer, and `reduce_partials` adds the blocks in
// block order, so a run is bit-repeatable.  The output layout
// [dW1 (in,H) | db1 (H) | dW2 (H) | db2 | loss] equals the packed decoder
// vector's layout plus the summed loss.

#pragma once
#include <cuda_runtime.h>

namespace tk {

constexpr int F = 8;
constexpr int VD = 3;
constexpr int H = 64;
constexpr int IN = F + VD;
constexpr int C = F + 1;                  // feature row incl. the certainty column
constexpr int BLK = 64;                   // rows per block
constexpr int NP = IN * H + 2 * H + 1;    // packed decoder parameters
constexpr int E = NP + 1;                 // gradient entries + summed loss
constexpr int NE = (E + BLK - 1) / BLK;   // entries owned per thread
constexpr int MAXK = 16;

struct Smem {
  float W1[IN * H];
  float b1[H];
  float W2[H];
  float b2;
  float x[BLK][IN];
  float h[BLK][H + 1];                    // +1: conflict-free row writes
  float dh[BLK][H + 1];
  float dO[BLK];
  float pw[BLK];
};

__device__ inline void load_params(Smem& s, const float* __restrict__ p) {
  for (int e = threadIdx.x; e < NP; e += BLK) {
    float v = p[e];
    if (e < IN * H) s.W1[e] = v;
    else if (e < IN * H + H) s.b1[e - IN * H] = v;
    else if (e < IN * H + 2 * H) s.W2[e - IN * H - H] = v;
    else s.b2 = v;
  }
  __syncthreads();
}

// o = relu(x W1 + b1) W2 + b2 (unscaled)
__device__ inline float mlp_fwd(const Smem& s, const float* x) {
  float o = 0.f;
  for (int j = 0; j < H; ++j) {
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < IN; ++i) z = fmaf(x[i], s.W1[i * H + j], z);
    z += s.b1[j];
    o = fmaf(fmaxf(z, 0.f), s.W2[j], o);
  }
  return o + s.b2;
}

// Backward of one decode with upstream gradient dO: dx = W1 (dO W2 * [z>0]);
// the step's reduction operands go to shared memory.
__device__ inline void mlp_bwd_step(Smem& s, const float* x, float dO, float pw, float* dx) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < IN; ++i) { s.x[t][i] = x[i]; dx[i] = 0.f; }
  for (int j = 0; j < H; ++j) {
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < IN; ++i) z = fmaf(x[i], s.W1[i * H + j], z);
    z += s.b1[j];
    float dh = z > 0.f ? dO * s.W2[j] : 0.f;
    s.h[t][j] = fmaxf(z, 0.f);
    s.dh[t][j] = dh;
#pragma unroll
    for (int i = 0; i < IN; ++i) dx[i] = fmaf(dh, s.W1[i * H + j], dx[i]);
  }
  s.dO[t] = dO;
  s.pw[t] = pw;
}

// Sum the block's step operands into the thread's owned gradient entries
// (fixed row order).
__device__ inline void reduce_step(Smem& s, float* acc) {
  __syncthreads();
#pragma unroll
  for (int m = 0; m < NE; ++m) {
    const int e = threadIdx.x + m * BLK;
    float a = 0.f;
    if (e < IN * H) {
      const int i = e / H, j = e % H;
      for (int r = 0; r < BLK; ++r) a = fmaf(s.x[r][i], s.dh[r][j], a);
    } else if (e < IN * H + H) {
      const int j = e - IN * H;
      for (int r = 0; r < BLK; ++r) a += s.dh[r][j];
    } else if (e < IN * H + 2 * H) {
      const int j = e - IN * H - H;
      for (int r = 0; r < BLK; ++r) a = fmaf(s.dO[r], s.h[r][j], a);
    } else if (e == IN * H + 2 * H) {
      for (int r = 0; r < BLK; ++r) a += s.dO[r];
    } else if (e == E - 1) {
      for (int r = 0; r < BLK; ++r) a += s.pw[r];
    }
    acc[m] += a;
  }
  __syncthreads();
}

__device__ inline void store_partials(const float* acc, float* __restrict__ partial) {
#pragma unroll
  for (int m = 0; m < NE; ++m) {
    const int e = threadIdx.x + m * BLK;
    if (e < E) partial[(long)blockIdx.x * E + e] = acc[m];
  }
}

// out[e] = sum over blocks b (in order) of partial[b][e]
__global__ void reduce_partials(const float* __restrict__ partial, int nblocks,
                                float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float a = 0.f;
  for (int b = 0; b < nblocks; ++b) a += partial[(long)b * E + e];
  out[e] = a;
}

inline int launch_reduce(const float* partial, int nblocks, float* out, cudaStream_t st) {
  reduce_partials<<<(E + 127) / 128, 128, 0, st>>>(partial, nblocks, out);
  return (int)cudaGetLastError();
}

}  // namespace tk
