// Append-time kNN candidate ranking (kernel 1 of the port).
//
// Replaces the Pallas kernel `_rank_kernel` / `probe_rank_pallas` in
// pin_slam_tpu/ops/rank_kernel.py.  For each of G probe groups, n queries
// share one ball of K gathered candidates, field-major [x|y|z|lidx|gidx]
// (K columns each).  A candidate is valid iff lidx < L and d2 <= max_valid_dist2;
// invalid ones rank at 9e3.  The k nearest are the first k of the order
// (d2m, column): equal to k argmin passes with first-occurrence tie-break
// and chosen columns masked away, whenever K >= k (the wrapper checks).
//
// Bound on an H100: memory.  Each (group, query) reads 5K floats and writes
// k*(4+3*4+1) bytes; the arithmetic (K distance evaluations and a k-slot
// insertion) is a few hundred operations per query.  Design: one thread per
// (group, query), candidates read straight from global memory (queries of
// one group share the group's row through L1/L2), the k-slot list in a small
// per-thread array.  Staging a group's row in shared memory is later work.
//
// d2 is written with __fmul_rn/__fadd_rn in the JAX package's order
// ((dx*dx + dy*dy) + dz*dz): nvcc would otherwise contract it into FMAs,
// which moves d2 by an ulp and reorders near-ties against the plain version.

#include <cuda_runtime.h>

#define RANK_MAXK 16

__global__ void rank_kernel(const float* __restrict__ rows, const float* __restrict__ q,
                            int G, int n, int K, int k, float L_f, float maxd2,
                            int* __restrict__ gidx, float* __restrict__ pos,
                            unsigned char* __restrict__ valid) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)G * n) return;
  long g = t / n;
  const float* r = rows + g * 5L * K;
  const float qx = q[t * 3 + 0], qy = q[t * 3 + 1], qz = q[t * 3 + 2];

  float sd[RANK_MAXK];
  int sc[RANK_MAXK];
  for (int j = 0; j < k; ++j) { sd[j] = __int_as_float(0x7f800000); sc[j] = 0; }

  for (int c = 0; c < K; ++c) {
    float dx = __fsub_rn(r[c], qx);
    float dy = __fsub_rn(r[K + c], qy);
    float dz = __fsub_rn(r[2 * K + c], qz);
    float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    bool v = (r[3 * K + c] < L_f) && (d2 <= maxd2);
    float dm = v ? d2 : 9e3f;
    if (dm < sd[k - 1]) {               // strict: equal keys keep column order
      int j = k - 1;
      while (j > 0 && dm < sd[j - 1]) { sd[j] = sd[j - 1]; sc[j] = sc[j - 1]; --j; }
      sd[j] = dm;
      sc[j] = c;
    }
  }
  for (int j = 0; j < k; ++j) {
    int c = sc[j];
    float x = r[c], y = r[K + c], z = r[2 * K + c];
    float dx = __fsub_rn(x, qx), dy = __fsub_rn(y, qy), dz = __fsub_rn(z, qz);
    float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    bool v = (r[3 * K + c] < L_f) && (d2 <= maxd2);
    long o = t * k + j;
    gidx[o] = v ? (int)lrintf(r[4 * K + c]) : -1;
    pos[o * 3 + 0] = x;
    pos[o * 3 + 1] = y;
    pos[o * 3 + 2] = z;
    valid[o] = v ? 1 : 0;
  }
}

extern "C" int rank_launch(const void* rows, const void* q, int G, int n, int K, int k,
                           int L, float maxd2, void* gidx, void* pos, void* valid,
                           void* stream) {
  long total = (long)G * n;
  if (total > 0) {
    int block = 128;
    long grid = (total + block - 1) / block;
    rank_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)rows, (const float*)q, G, n, K, k, (float)L, maxd2, (int*)gidx,
        (float*)pos, (unsigned char*)valid);
  }
  return (int)cudaGetLastError();
}
