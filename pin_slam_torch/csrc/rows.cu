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
// it once (no arithmetic); a scatter reads the values that are not skipped,
// their entries of `order` and the offsets once and writes the sums once
// (the table form also reads the table), with one add per value element.
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
// permutation `order` and the segment offsets `offsets` (N+1), both int32:
// segment r is order[offsets[r] .. offsets[r+1]).  Each row's sum starts
// from its base (the table's row, or +0.0f in the zero-base form, which
// reads no table: 0 + (-0.0) is +0.0, the bits of a zero table) and adds
// the segment's values in that order with __fadd_rn, so every launch gives
// the same bits, and they are the bits of a sequential in-order index_add.
// Destination `skip_row` (the training loop's sentinel row, one very long
// segment whose gradient is never read) keeps its base; -1 skips nothing.
//
// A thread owns one (row, column) element of the output: C threads a row,
// so a warp's loads of a value row, and its stores, are contiguous.  Its
// row's bounds are two loads; a thread whose row has no terms writes its
// base and is done, which is most of the table on the main path (the local
// map's rows that receive terms are a few tens of thousands of 2^16 or
// 2^18).  A thread with terms walks its segment SU terms a round: SU loads
// of `order`, then the SU values, all in flight together, with the next
// round's entries of `order` loaded beside this round's values; the adds
// follow in order.  Offsets are 32-bit where the table and the values stay below 2^31 floats,
// 64-bit otherwise.  C is a template parameter for the main path's width
// (9) and the Pallas experiment's (8), so the division by C is by a
// constant; any other C takes the same kernel with C at run time.  The grid
// is the SM count times the kernel's occupancy, or fewer blocks where the
// elements run out.  (Measured against a warp a 32-row tile, with lane l
// owning row l or the tile's contiguous elements, and the terms gathered a
// level of every row at a time: slower on the paths' inputs, where a few
// tiles hold all the terms.)

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

// blocks of `block` threads of `kern` that the card holds at once, queried
// on the first launch of each instantiation (`cap` is its own static)
template <typename Kern>
static int resident_blocks(Kern kern, int block, int& cap) {
  if (cap == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, block, 0);
    cap = (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }
  return cap;
}

static unsigned grid_of(int64_t need, int cap) { return (unsigned)(need < cap ? need : cap); }

template <int CW, int V, typename Off>
static int launch_gather(const void* table, const void* idx, int64_t M, int C, void* out,
                         cudaStream_t st) {
  const auto kern = gather_rows_kernel<CW, V, Off>;
  static int cap = 0;
  kern<<<grid_of((M + GB - 1) / GB, resident_blocks(kern, GB, cap)), GB, 0, st>>>(
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

constexpr int SB = 256;                   // scatter block
constexpr int SU = 4;                     // terms a thread loads a round

// CW floats a row (CW == 0: c_rt floats); ZERO: the zero-base form (`table`
// is not read).  Off: the offset type (int or int64_t).
template <int CW, bool ZERO, typename Off>
__global__ void __launch_bounds__(SB) scatter_rows_kernel(const float* __restrict__ table,
                                                          const float* __restrict__ val,
                                                          const int* __restrict__ order,
                                                          const int* __restrict__ offsets,
                                                          Off total, int c_rt, Off skip_row,
                                                          float* __restrict__ out) {
  const int C = CW > 0 ? CW : c_rt;
  for (Off t = (Off)blockIdx.x * SB + threadIdx.x; t < total; t += (Off)gridDim.x * SB) {
    const Off r = t / C;
    const int c = (int)(t - r * C);
    float acc = ZERO ? 0.0f : table[t];
    const int beg = offsets[r];
    const int end = r == skip_row ? beg : offsets[r + 1];
    if (beg < end) {
      int oc[SU];                                       // this round's rows of val, or -1
#pragma unroll
      for (int u = 0; u < SU; ++u) oc[u] = beg + u < end ? order[beg + u] : -1;
      for (int j = beg; j < end; j += SU) {
        int on[SU];
        float v[SU];
#pragma unroll
        for (int u = 0; u < SU; ++u) on[u] = j + SU + u < end ? order[j + SU + u] : -1;
#pragma unroll
        for (int u = 0; u < SU; ++u) v[u] = oc[u] >= 0 ? val[(Off)oc[u] * C + c] : 0.0f;
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          if (oc[u] >= 0) acc = __fadd_rn(acc, v[u]);
          oc[u] = on[u];
        }
      }
    }
    out[t] = acc;
  }
}

template <int CW, bool ZERO, typename Off>
static void launch_scatter(const float* table, const float* val, const int* order,
                           const int* offsets, int64_t N, int C, int64_t skip_row, float* out,
                           cudaStream_t st) {
  const auto kern = scatter_rows_kernel<CW, ZERO, Off>;
  static int cap = 0;
  kern<<<grid_of((N * C + SB - 1) / SB, resident_blocks(kern, SB, cap)), SB, 0, st>>>(
      table, val, order, offsets, (Off)(N * C), C, (Off)skip_row, out);
}

template <bool ZERO, typename Off>
static void dispatch_scatter(const float* table, const float* val, const int* order,
                             const int* offsets, int64_t N, int C, int64_t skip_row,
                             float* out, cudaStream_t st) {
  switch (C) {
    case 9:
      return launch_scatter<9, ZERO, Off>(table, val, order, offsets, N, C, skip_row, out, st);
    case 8:
      return launch_scatter<8, ZERO, Off>(table, val, order, offsets, N, C, skip_row, out, st);
    default:
      return launch_scatter<0, ZERO, Off>(table, val, order, offsets, N, C, skip_row, out, st);
  }
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

// the in-order row sums of val (M, C) at the plan's destinations into out
// (N, C), from table's rows or, where table is null, from +0.0f; the caller
// has checked the plan (int32, built from indices in [0, N))
extern "C" int scatter_rows_launch(const void* table, const void* val, const void* order,
                                   const void* offsets, int64_t N, int C, int64_t M,
                                   int64_t skip_row, void* out, void* stream) {
  if (N > 0 && C > 0) {
    const float* t = (const float*)table;
    const float* v = (const float*)val;
    const int* o = (const int*)order;
    const int* f = (const int*)offsets;
    const cudaStream_t st = (cudaStream_t)stream;
    // 32-bit offsets: the element loop's counter stays below N * C plus the
    // grid's threads, the value offsets below M * C
    const int64_t lim = (int64_t)1 << 31;
    const bool narrow = (N + ((int64_t)1 << 22)) * C < lim && M * C < lim;
    if (t == nullptr)
      narrow ? dispatch_scatter<true, int>(t, v, o, f, N, C, skip_row, (float*)out, st)
             : dispatch_scatter<true, int64_t>(t, v, o, f, N, C, skip_row, (float*)out, st);
    else
      narrow ? dispatch_scatter<false, int>(t, v, o, f, N, C, skip_row, (float*)out, st)
             : dispatch_scatter<false, int64_t>(t, v, o, f, N, C, skip_row, (float*)out, st);
  }
  return (int)cudaGetLastError();
}
