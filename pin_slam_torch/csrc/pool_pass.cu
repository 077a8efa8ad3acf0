// The replay pool's re-derivation after a pose change, in one launch.
//
// Replaces no TPU kernel: the JAX package's `pool_retransform` and
// `pool_refresh_cache` (pin_slam_tpu/slam/mapper.py) are plain jnp under jit,
// where XLA fuses them.  Eagerly they were two torch passes, the second in
// 2^20-row chunks, each chunk materialising its (c, k, 16) gathered attribute
// rows and a chain of `idw_blend` temporaries.  The plain twin is
// `pool_pass_plain` (pin_slam_torch/ops/pool_kernel.py): those two calls.
//
// Semantics, for every row of the (n, W) pool, the rows past its fill
// included (W = 9 + 2k + 3, and + 3k without weighted_first):
//  - coord = R x + t, (R | t) = poses[clamp(int(ts), 0, T - 1)], x the
//    sensor-frame coordinates (columns 6..8), ts column 5; coord goes to
//    columns 0..2 (frame ids past T - 1, which the pose table's TS_CAPACITY
//    rows never leave, are clamped where the twin's index would raise);
//  - for each of the k cached neighbour ids g (columns 9..9+k): attribute
//    row g (clamped at cap; none where g < 0) gives the neighbour's position
//    p and quaternion q (columns 0..2 and 3..6); valid iff g >= 0 and
//    ((px-cx)^2 + (py-cy)^2) + (pz-cz)^2 <= max_valid_dist2;
//  - v = coord - p under q's passive rotation (q^-1 v q), zero where invalid;
//    w = rcp(d2 + eps) / sum (the sum in neighbour order), zero where invalid,
//    all zero where no neighbour is valid;
//  - columns 9+k..9+2k take w, the next 3 the blend sum_j w_j v_j, and
//    without weighted_first the next 3k each v_j.
// Every other column (label, weight, frame id, sensor-frame coordinates,
// neighbour ids) is written back with the bits it was read with.
//
// Bound on an H100 (3.35 TB/s), each byte counted once: the pass reads and
// writes every row, 2 x (2e7 + 1) x 168 B = 6.7 GB, 2.0 ms, on KITTI's pool
// (k 6, per neighbour), and reads its neighbours' positions and quaternions,
// at most the first 32 B of each of the attribute table's 2^22 + 1 rows (134
// MB, 0.04 ms); NCD's (1e7 + 1)-row pool of the same width 3.4 GB, 1.0 ms.  Where the
// neighbour rows miss L2 (KITTI's table is 268 MB, L2 50 MB), each valid
// neighbour of a live row costs its 32-byte sector: up to 6 x 32 B x 2e7 =
// 3.8 GB, 1.1 ms more, were every row live.  Design:
//  - a block of POOL_ROWS threads owns a tile of POOL_ROWS rows (a multiple
//    of 4, so a tile starts on a 16-byte boundary whatever W is): it reads
//    the tile with 16-byte coalesced streaming loads into shared memory at an
//    odd row stride (W | 1), so that thread t's accesses to row t fall in
//    distinct banks, derives one row a thread, and writes the tile back with
//    16-byte coalesced streaming stores (the pool is touched once; the
//    streaming hints leave L2 to the attribute rows and the poses);
//  - the poses (T x 64 B) are three 16-byte loads a row through L1 / L2;
//    each valid neighbour's position and quaternion two 16-byte loads, all k
//    issued before any is used; a row with no neighbour id loads none;
//  - the twin's separate products and sums are __fmul_rn / __fadd_rn, so
//    nvcc does not contract them; the coordinate's 3-term product is an FMA
//    chain, as a float32 GEMM of depth 3 forms it, then + t; the blend an
//    FMA chain in neighbour order, as a GEMM over k.

#include <cuda_runtime.h>
#include <stdint.h>

#define POOL_ROWS 128            // rows (and threads) a block
#define POOL_MAX_K 8

struct PoolArgs {
  float* rows;                   // (n, W), contiguous, 16-byte aligned
  const float* poses;            // (T, 4, 4), 16-byte aligned
  const float* attr;             // (cap + 1, .), rows attr_stride floats apart, 16-byte aligned
  long long n, cap;
  int T, attr_stride;
  float maxd2, eps;
};

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

// a x b, as torch.linalg.cross
__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  o[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  o[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

// `apply_quaternion_rotation(q, v)`: v + w t + u x t, t = 2 (u x v), u = -q_xyz
__device__ __forceinline__ void passive_rot(float w, const float* u, const float* v, float* o) {
  float c[3], t[3], c2[3];
  cross3(u, v, c);
  for (int i = 0; i < 3; ++i) t[i] = __fmul_rn(2.f, c[i]);
  cross3(u, t, c2);
  for (int i = 0; i < 3; ++i) o[i] = __fadd_rn(__fadd_rn(v[i], __fmul_rn(w, t[i])), c2[i]);
}

// the float f of a tile (row-major, W a row) at its shared-memory place
template <int W, int WS>
__device__ __forceinline__ int tile_at(int f) {
  return WS == W ? f : (f / W) * WS + f % W;
}

// one row, in shared memory, derived in place
template <int K, bool WF>
__device__ __forceinline__ void derive_row(float* s, const PoolArgs& a) {
  long long ti = (long long)s[5];                      // .to(torch.int64): truncation
  ti = ti < 0 ? 0 : (ti >= a.T ? (long long)a.T - 1 : ti);
  const float4* pz = reinterpret_cast<const float4*>(a.poses + ti * 16);
  const float4 r0 = __ldg(pz), r1 = __ldg(pz + 1), r2 = __ldg(pz + 2);
  const float x = s[6], y = s[7], z = s[8];
  float c[3];
  c[0] = __fadd_rn(__fmaf_rn(r0.z, z, __fmaf_rn(r0.y, y, __fmul_rn(r0.x, x))), r0.w);
  c[1] = __fadd_rn(__fmaf_rn(r1.z, z, __fmaf_rn(r1.y, y, __fmul_rn(r1.x, x))), r1.w);
  c[2] = __fadd_rn(__fmaf_rn(r2.z, z, __fmaf_rn(r2.y, y, __fmul_rn(r2.x, x))), r2.w);

  float4 pq[K], qq[K];                                 // (px, py, pz, qw), (qx, qy, qz, .)
  bool has[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const long long g = (long long)s[9 + j];
    has[j] = g >= 0;
    if (has[j]) {
      const float4* ar = reinterpret_cast<const float4*>(a.attr + (g < a.cap ? g : a.cap) *
                                                         (long long)a.attr_stride);
      pq[j] = __ldg(ar);
      qq[j] = __ldg(ar + 1);
    } else {
      pq[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      qq[j] = pq[j];
    }
  }

  float v[K][3], w[K];
  bool valid[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float d[3] = {__fsub_rn(c[0], pq[j].x), __fsub_rn(c[1], pq[j].y),
                        __fsub_rn(c[2], pq[j].z)};
    const float d2 = sq3(d[0], d[1], d[2]);
    valid[j] = has[j] && d2 <= a.maxd2;
    w[j] = valid[j] ? __frcp_rn(__fadd_rn(d2, a.eps)) : 0.f;
    if (valid[j]) {
      const float u[3] = {-qq[j].x, -qq[j].y, -qq[j].z};
      passive_rot(pq[j].w, u, d, v[j]);
    } else {
      v[j][0] = v[j][1] = v[j][2] = 0.f;
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) sum = __fadd_rn(sum, w[j]);
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = valid[j] ? __fdiv_rn(w[j], sum) : 0.f;
  // a row with no valid neighbour: every w and v is 0, so is the blend
  float b[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    b[p] = __fmul_rn(w[0], v[0][p]);
#pragma unroll
    for (int j = 1; j < K; ++j) b[p] = __fmaf_rn(w[j], v[j][p], b[p]);
  }

  for (int p = 0; p < 3; ++p) s[p] = c[p];
#pragma unroll
  for (int j = 0; j < K; ++j) s[9 + K + j] = w[j];
  for (int p = 0; p < 3; ++p) s[9 + 2 * K + p] = b[p];
  if (!WF) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      for (int p = 0; p < 3; ++p) s[12 + 2 * K + 3 * j + p] = v[j][p];
  }
}

template <int K, bool WF>
__global__ void __launch_bounds__(POOL_ROWS) pool_pass_kernel(const PoolArgs a) {
  constexpr int W = 12 + 2 * K + (WF ? 0 : 3 * K);
  constexpr int WS = W | 1;
  __shared__ float tile[POOL_ROWS * WS];
  const long long r0 = (long long)blockIdx.x * POOL_ROWS;
  const int nr = (int)(a.n - r0 < POOL_ROWS ? a.n - r0 : POOL_ROWS);
  float* g = a.rows + r0 * W;
  const int nf = nr * W, n4 = nf >> 2;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int i = threadIdx.x; i < n4; i += POOL_ROWS) {
    const float4 q = __ldcs(g4 + i);
    const int f = 4 * i;
    tile[tile_at<W, WS>(f)] = q.x;
    tile[tile_at<W, WS>(f + 1)] = q.y;
    tile[tile_at<W, WS>(f + 2)] = q.z;
    tile[tile_at<W, WS>(f + 3)] = q.w;
  }
  for (int f = 4 * n4 + threadIdx.x; f < nf; f += POOL_ROWS) tile[tile_at<W, WS>(f)] = __ldcs(g + f);
  __syncthreads();
  if ((int)threadIdx.x < nr) derive_row<K, WF>(tile + threadIdx.x * WS, a);
  __syncthreads();
  float4* o4 = reinterpret_cast<float4*>(g);
  for (int i = threadIdx.x; i < n4; i += POOL_ROWS) {
    const int f = 4 * i;
    __stcs(o4 + i, make_float4(tile[tile_at<W, WS>(f)], tile[tile_at<W, WS>(f + 1)],
                               tile[tile_at<W, WS>(f + 2)], tile[tile_at<W, WS>(f + 3)]));
  }
  for (int f = 4 * n4 + threadIdx.x; f < nf; f += POOL_ROWS) __stcs(g + f, tile[tile_at<W, WS>(f)]);
}

template <int K>
static int launch_k(const PoolArgs& a, int wf, cudaStream_t st) {
  const long long blocks = (a.n + POOL_ROWS - 1) / POOL_ROWS;
  if (wf)
    pool_pass_kernel<K, true><<<(unsigned)blocks, POOL_ROWS, 0, st>>>(a);
  else
    pool_pass_kernel<K, false><<<(unsigned)blocks, POOL_ROWS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// rows / poses / attr: device pointers; n pool rows, cap the attribute
// table's sentinel row, T poses, k neighbours, weighted_first 0 / 1
int pool_pass_launch(void* rows, const void* poses, const void* attr, long long n,
                     long long cap, int T, int attr_stride, int k, int weighted_first,
                     float max_valid_dist2, float eps, void* stream) {
  if (n < 1 || cap < 0 || T < 1 || attr_stride < 8 || k < 1 || k > POOL_MAX_K ||
      (n + POOL_ROWS - 1) / POOL_ROWS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  PoolArgs a;
  a.rows = (float*)rows;
  a.poses = (const float*)poses;
  a.attr = (const float*)attr;
  a.n = n;
  a.cap = cap;
  a.T = T;
  a.attr_stride = attr_stride;
  a.maxd2 = max_valid_dist2;
  a.eps = eps;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch_k<1>(a, weighted_first, st);
    case 2: return launch_k<2>(a, weighted_first, st);
    case 3: return launch_k<3>(a, weighted_first, st);
    case 4: return launch_k<4>(a, weighted_first, st);
    case 5: return launch_k<5>(a, weighted_first, st);
    case 6: return launch_k<6>(a, weighted_first, st);
    case 7: return launch_k<7>(a, weighted_first, st);
    default: return launch_k<8>(a, weighted_first, st);
  }
}

}  // extern "C"
