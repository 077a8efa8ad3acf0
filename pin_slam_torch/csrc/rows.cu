// Row gather and deterministic row scatter-add (kernels 4 and 5 of the port).
//
// gather_rows replaces the Pallas kernel `make_gather_kernel`
// (experiments/profile_pallas_gather.py:43): a random row gather from a
// feature table.  scatter_rows replaces `make_scatter_kernel` (:66): a row
// scatter-add into a table.  On the main path they are the training loop's
// pool-row and feature-row gathers and its row-gradient scatter
// (pin_slam_tpu/slam/mapper.py:1220, 1351, 1356-1367).
//
// Bound on an H100: bytes.  A gather reads each selected row once and writes
// it once (no arithmetic); a scatter reads the table, the values and the
// indices once and writes the table once, with one add per value element.
//
// gather: one thread per output element, so neighbouring threads read
// neighbouring floats of a row and write neighbouring floats of the output.
// Rows of C = 9 floats (36 bytes) are not 16-byte aligned, so 16-byte vector
// loads do not fit a row; element-wise access keeps the loads coalesced
// within each row instead.
//
// scatter: no float atomics.  The caller sorts the indices by destination
// (stable, so equal destinations keep their original order) and passes the
// permutation `order` and the segment offsets `offsets` (N+1): segment r is
// order[offsets[r] .. offsets[r+1]).  One thread per (destination row,
// column) adds its segment's values in that order onto the table's value, so
// every launch gives the same bits, and they are the bits of a sequential
// in-order index_add.  Destination `skip_row` (the training loop's sentinel
// row, one very long segment whose gradient is never read) keeps the table's
// value; -1 skips nothing.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const int64_t* __restrict__ idx, int64_t M, int C,
                                   float* __restrict__ out) {
  const int64_t total = M * C;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    int64_t m = t / C;
    int64_t c = t - m * C;
    out[t] = table[idx[m] * C + c];
  }
}

__global__ void scatter_rows_kernel(const float* __restrict__ table,
                                    const float* __restrict__ val,
                                    const int64_t* __restrict__ order,
                                    const int64_t* __restrict__ offsets, int64_t N, int C,
                                    int64_t skip_row, float* __restrict__ out) {
  const int64_t total = N * C;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = t / C;
    int64_t c = t - r * C;
    float acc = table[t];
    if (r != skip_row) {
      int64_t e = offsets[r + 1];
      for (int64_t j = offsets[r]; j < e; ++j)
        acc = __fadd_rn(acc, val[order[j] * C + c]);
    }
    out[t] = acc;
  }
}

static unsigned grid_for(int64_t total, int block) {
  int64_t g = (total + block - 1) / block;
  const int64_t cap = 132 * 64;          // enough blocks to fill 132 SMs many times over
  return (unsigned)(g < cap ? g : cap);
}

extern "C" int gather_rows_launch(const void* table, const void* idx, int64_t M, int C,
                                  void* out, void* stream) {
  if (M > 0 && C > 0) {
    int block = 256;
    gather_rows_kernel<<<grid_for(M * C, block), block, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int64_t*)idx, M, C, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int scatter_rows_launch(const void* table, const void* val, const void* order,
                                   const void* offsets, int64_t N, int C, int64_t skip_row,
                                   void* out, void* stream) {
  if (N > 0 && C > 0) {
    int block = 256;
    scatter_rows_kernel<<<grid_for(N * C, block), block, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const float*)val, (const int64_t*)order,
        (const int64_t*)offsets, N, C, skip_row, (float*)out);
  }
  return (int)cudaGetLastError();
}
