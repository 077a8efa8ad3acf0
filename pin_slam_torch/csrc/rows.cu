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
// gather: a warp copies a tile of 32 rows.  Lane l reads the index of tile
// row l once.  The tile's 32 * C output floats are contiguous, so the warp
// walks them as 32 * NV vectors of V floats (NV = C / V): vector e (lane +
// 32 * it) is vector e % NV of tile row e / NV, whose index the warp takes
// by a shuffle from lane e / NV.  Writes are fully coalesced, reads are
// coalesced within a row, and each lane keeps its NV loads in flight before
// it stores.  The width is a template parameter for the widths of the main
// path, so the divisions are by constants and the loops unroll: C = 9 (the
// feature rows, scalar: 36-byte rows are only 4-byte aligned), 24 (pool rows
// with weighted_first, float4 when the table is 16-byte aligned) and 42 (pool
// rows per neighbour, float2 when 8-byte aligned); a misaligned table view
// takes the scalar instantiation of its width, and any other C a generic
// kernel.  Offsets are 32-bit where the table and the output stay below
// 2^31 floats, 64-bit otherwise.  The grid is the SM count times the
// kernel's occupancy, or fewer blocks where the tiles run out.
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

constexpr int GB = 256;                   // gather block: 8 warps, 8 tiles of 32 rows

template <int V> struct Vec;
template <> struct Vec<1> { using type = float; };
template <> struct Vec<2> { using type = float2; };
template <> struct Vec<4> { using type = float4; };

// CW > 0: rows of CW floats moved as vectors of V floats; CW == 0: rows of
// c_rt floats, scalar.  Off: the offset type (int or int64_t).
template <int CW, int V, typename Off>
__global__ void __launch_bounds__(GB) gather_rows_kernel(const float* __restrict__ table,
                                                         const int64_t* __restrict__ idx,
                                                         Off M, int c_rt,
                                                         float* __restrict__ out) {
  using T = typename Vec<V>::type;
  const T* __restrict__ tv = reinterpret_cast<const T*>(table);
  const int lane = threadIdx.x & 31;
  const Off step = (Off)gridDim.x * GB;
  for (Off m0 = (Off)blockIdx.x * GB + (threadIdx.x & ~31); m0 < M; m0 += step) {
    const Off left = M - m0;
    const int rows = left < 32 ? (int)left : 32;          // warp-uniform
    T* __restrict__ ov = reinterpret_cast<T*>(out);
    if constexpr (CW > 0) {
      constexpr int NV = CW / V;
      const Off src = lane < rows ? (Off)idx[m0 + lane] * NV : 0;   // row start, in vectors
      ov += m0 * NV;
      T v[NV];
#pragma unroll
      for (int it = 0; it < NV; ++it) {
        const int e = lane + 32 * it;
        const int r = e / NV;                             // < 32: e < 32 * NV
        const Off s = __shfl_sync(0xffffffffu, src, r);
        if (r < rows) v[it] = tv[s + (e - r * NV)];
      }
#pragma unroll
      for (int it = 0; it < NV; ++it) {
        const int e = lane + 32 * it;
        if (e < rows * NV) ov[e] = v[it];
      }
    } else {
      const int C = c_rt;
      const Off src = lane < rows ? (Off)idx[m0 + lane] * C : 0;
      ov += m0 * C;
      for (int e = lane; e < 32 * C; e += 32) {           // C trips on every lane
        const int r = e / C;
        const Off s = __shfl_sync(0xffffffffu, src, r);
        if (r < rows) ov[e] = tv[s + (e - r * C)];
      }
    }
  }
}

template <int CW, int V, typename Off>
static int launch_gather(const void* table, const void* idx, int64_t M, int C, void* out,
                         cudaStream_t st) {
  const auto kern = gather_rows_kernel<CW, V, Off>;
  static int cap = 0;                     // resident blocks on the card, per instantiation
  if (cap == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, GB, 0);
    cap = (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }
  const int64_t need = (M + GB - 1) / GB;
  kern<<<(unsigned)(need < cap ? need : cap), GB, 0, st>>>(
      (const float*)table, (const int64_t*)idx, (Off)M, C, (float*)out);
  return (int)cudaGetLastError();
}

template <typename Off>
static int dispatch_gather(const void* table, const void* idx, int64_t M, int C, void* out,
                           cudaStream_t st) {
  const uintptr_t a = (uintptr_t)table | (uintptr_t)out;
  switch (C) {
    case 9:
      return launch_gather<9, 1, Off>(table, idx, M, C, out, st);
    case 24:
      return a % 16 == 0 ? launch_gather<24, 4, Off>(table, idx, M, C, out, st)
                         : launch_gather<24, 1, Off>(table, idx, M, C, out, st);
    case 42:
      return a % 8 == 0 ? launch_gather<42, 2, Off>(table, idx, M, C, out, st)
                        : launch_gather<42, 1, Off>(table, idx, M, C, out, st);
    default:
      return launch_gather<0, 1, Off>(table, idx, M, C, out, st);
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

// rows idx (M,) of the (N, C) table into out (M, C); the caller has checked
// every index against N
extern "C" int gather_rows_launch(const void* table, const void* idx, int64_t N, int64_t M,
                                  int C, void* out, void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaGetLastError();
  const int64_t lim = (int64_t)1 << 31;
  // 32-bit offsets: table offsets stay below N * C, output offsets and the
  // tile loop's counter below (M + the grid's rows) * C
  const bool narrow = N * C < lim && (M + ((int64_t)1 << 22)) * C < lim;
  const cudaStream_t st = (cudaStream_t)stream;
  return narrow ? dispatch_gather<int>(table, idx, M, C, out, st)
                : dispatch_gather<int64_t>(table, idx, M, C, out, st);
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
