// The tracker's cached Gauss-Newton step, in one launch.
//
// Replaces no TPU kernel: the JAX package runs this step inside its jitted
// while_loop (pin_slam_tpu/slam/tracker.py `one_step` over
// slam/tracker_grad.py `sdf_value_and_grad_cached`), where XLA fuses it.
// Eagerly the step was ~150 small torch launches, two pose uploads and a
// packed read; the host's enqueue of those launches set odometry's pace.
// The plain twin is `track_step_plain` (pin_slam_torch/ops/track_kernel.py).
//
// Semantics, for each source row with source_valid (the others add exact
// zeros to every sum, so they are skipped; no other row is):
//  - cur = R s + t, p = cur + origin (R, t, origin by value);
//  - the row's M cached candidates: d2 = ((x-px)^2 + (y-py)^2) + (z-pz)^2,
//    valid iff lidx < L and d2 <= max_valid_dist2; nn_count = #valid;
//    invalid keys 9e3; the k nearest as `npts.exact_k_min` picks them
//    (ascending, the lowest column first among ties);
//  - each neighbour's feature row (layer-normalised with layer_norm_on;
//    zero where invalid), its offset p - pos (rotated by the passive
//    rotation of its quaternion after a pose-graph optimisation), its IDW
//    weight w and weight gradient dw;
//  - the one-hidden-layer decoder with its closed-form input gradient:
//    per neighbour (o_j, g_j), blended sdf = sum w o, std, grad = sum o dw
//    + sum w R_j^T g_v; or weighted_first, one decode of h = sum w [f; v]
//    with grad = sum (fv . g_h) dw + sum w R_j^T g_h[v];
//  - mask = nn_count >= min_nn, min_grad < |grad| < max_grad, std < max_std;
//    w = GM(dist, sdf) GM(grad, |grad| - 1) (x 0.5 + |n . grad/|grad||
//    where the row has a valid normal); J = [cur x grad, grad].
// Each block adds its rows' N' = sum w J J^T (21 entries), g' = sum w J r,
// sum w, the count and sum |r| in a fixed order into a partial row; the last
// block to finish (a ticket, no float atomics) sums the partial rows in
// block order and writes the packed vector [N | g | res_cm | count | 0]
// with w normalised by twice its mean, as the twin does.  The order of
// every sum is fixed, so two launches give the same bits (a changing last
// bit would wander the tracker's stop decisions).
//
// Bound on an H100, at the cells' shape (16384 rows, ~3,300 valid, M 16,
// k 6, F 8, H 64): ~2 MB read (the cache's 16 B x 16 a row, the source,
// the neighbours' rows) and ~60 MFLOP (6 decodes of 11 -> 64 -> 1 with the
// input gradient a row), so ~1 us either way; one launch's latency is what
// the step costs.  Design, after the train kernel (csrc/train_iter.cu):
//  - one warp a row, the warps taking rows in turn (the valid rows sit at
//    the front of the bucket, so they spread over every warp);
//  - lane m holds candidate m (M <= 32); the top-k is k rounds of two
//    `redux.sync` minima (the float bits of d2, then the lowest lane);
//  - lane r (< k) then holds neighbour r's weights and offset; the k feature
//    rows are gathered at once into the warp's shared rows;
//  - lanes split the H hidden units (UPL = ceil(H / 32) a lane, a template
//    parameter); W1 (row stride H|1, odd: the weighted_first gradient reads
//    it by input row without bank conflicts), b1 and W2 sit in shared memory;
//  - the decode's sums over units are xor-butterfly warp sums (every lane
//    ends with the same bits); sums over neighbours go in neighbour order;
//  - lane e (< 30) keeps the warp's running sum e.
// Products and sums in the twin's order use __fmul_rn / __fadd_rn where nvcc
// would otherwise contract them; the decoder's dot products use fmaf.  The
// rows' points are R s as a float32 GEMM of depth 3 forms it (an FMA chain
// over the depth, as the twin's `source @ R.T` does), then + t, + origin:
// a kilometre from the world's origin one ulp of a point (6e-5 m) is 1e-3
// of a 6 cm neighbour offset, so the point has to match the twin's bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define TS_WARPS 8                     // warps a block
#define TS_THREADS (TS_WARPS * 32)
#define TS_SUMS 30                     // N' (21) | g' (6) | sum w | count | sum |r|
#define TS_OUT 45                      // N (36) | g (6) | res_cm | count | photometric count
#define FULL 0xffffffffu

struct TrackArgs {
  float R[9], t[3], origin[3];
  float sdf_scale, maxd2, eps, gm_d, gm_d2, gm_g, gm_g2, min_grad, max_grad, max_std;
  int N, M, k, F, H, L, feat_stride, attr_stride, min_nn, weighted_first, layer_norm, after_pgo;
  const float* src;                    // (N, 3)
  const unsigned char* src_valid;      // (N,) bool
  const float *xs, *ys, *zs;           // (N, M)
  const long long* lidx;               // (N, M)
  const float* feats;                  // (L + 1, F), rows feat_stride apart
  const float* attr;                   // (L + 1, .), rows attr_stride apart, quaternion at 3..6
  const float* W1;                     // (H, F + 3): nn.Linear's weight
  const float* b1;                     // (H,) or null
  const float* W2;                     // (H,)
  const float* b2;                     // (1,) or null
  const float* normals;                // (N, 3) or null
  const unsigned char* normal_valid;   // (N,) bool or null
  float* out;                          // (45,)
  float* partial;                      // (gridDim.x, 30)
  unsigned* ticket;                    // one counter, 0 between launches
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

// a x b, as torch.linalg.cross
__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  o[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  o[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

// v + w * t + u x t with t = 2 (u x v): the rotation of v by the unit
// quaternion (w, u); u = -q_xyz is npts' passive rotation, u = q_xyz its
// transpose (tracker_grad._rotate_back)
__device__ __forceinline__ void quat_rot(float w, const float* u, const float* v, float* o) {
  float c[3], t[3], c2[3];
  cross3(u, v, c);
  for (int i = 0; i < 3; ++i) t[i] = __fmul_rn(2.f, c[i]);
  cross3(u, t, c2);
  for (int i = 0; i < 3; ++i) o[i] = __fadd_rn(__fadd_rn(v[i], __fmul_rn(w, t[i])), c2[i]);
}

// (k / (k^2 + r^2))^2, with k / x as torch computes a scalar over a tensor:
// the reciprocal times k
__device__ __forceinline__ float gm_weight(float k, float kk, float r) {
  const float q = __fmul_rn(__frcp_rn(__fadd_rn(kk, __fmul_rn(r, r))), k);
  return __fmul_rn(q, q);
}

__device__ __forceinline__ float pick6(const float* J, int i) {
  float v = J[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) v = i == j ? J[j] : v;
  return v;
}

// floats of a block's dynamic shared memory
__host__ __device__ inline int track_smem_floats(int F, int H, int k) {
  const int IN = F + 3, HS = H | 1, XS = IN | 1;
  return IN * HS + 3 * H + TS_WARPS * (k * XS + 2 * XS + H + 2 * k) + TS_WARPS * TS_SUMS;
}

template <int UPL>
__global__ void __launch_bounds__(TS_THREADS) track_step_kernel(const TrackArgs a) {
  extern __shared__ float sm[];
  const int F = a.F, H = a.H, k = a.k, IN = F + 3, HS = H | 1, XS = IN | 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* W1s = sm;                     // [d * HS + u]
  float* b1s = W1s + IN * HS;
  float* w2s = b1s + H;                // W2
  float* w2g = w2s + H;                // W2 * sdf_scale, the output's input gradient
  float* wb = w2g + H + warp * (k * XS + 2 * XS + H + 2 * k);
  float* X = wb;                       // k rows [f (F) | v (3)], stride XS
  float* HB = X + k * XS;              // weighted_first: h
  float* GH = HB + XS;                 // weighted_first: dsdf/dh
  float* GSC = GH + XS;                // weighted_first: the units' output gradient
  float* WR = GSC + H;                 // w_r
  int* SAFE = (int*)(WR + k);          // the neighbours' rows (L where invalid)
  float* red = w2g + H + TS_WARPS * (k * XS + 2 * XS + H + 2 * k);
  __shared__ unsigned s_last;

  for (int i = threadIdx.x; i < IN * H; i += TS_THREADS) {
    const int u = i / IN, d = i - u * IN;
    W1s[d * HS + u] = a.W1[i];
  }
  for (int u = threadIdx.x; u < H; u += TS_THREADS) {
    b1s[u] = a.b1 ? a.b1[u] : 0.f;
    w2s[u] = a.W2[u];
    w2g[u] = __fmul_rn(a.W2[u], a.sdf_scale);
  }
  const float b2 = a.b2 ? a.b2[0] : 0.f;
  // lane e < 21 keeps N'[ia][ib] (the upper triangle, row by row)
  int ia = 0, ib = 0;
  if (lane < 21) {
    int e = lane;
    while (e >= 6 - ia) { e -= 6 - ia; ++ia; }
    ib = ia + e;
  }
  __syncthreads();

  float acc = 0.f;
  const int nw = gridDim.x * TS_WARPS;
  for (int row = blockIdx.x * TS_WARPS + warp; row < a.N; row += nw) {
    if (!a.src_valid[row]) continue;                       // the whole warp
    // 1. the row's point in the shifted frame and on the map
    const float s0 = a.src[3 * row], s1 = a.src[3 * row + 1], s2 = a.src[3 * row + 2];
    float cur[3], p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      cur[c] = __fadd_rn(fmaf(a.R[3 * c + 2], s2, fmaf(a.R[3 * c + 1], s1,
                                                       __fmul_rn(a.R[3 * c], s0))), a.t[c]);
      p[c] = __fadd_rn(cur[c], a.origin[c]);
    }
    // 2. lane m: candidate m
    const bool in = lane < a.M;
    const long cb = (long)row * a.M + lane;
    const float cx = in ? a.xs[cb] : 0.f, cy = in ? a.ys[cb] : 0.f, cz = in ? a.zs[cb] : 0.f;
    const long long cl = in ? a.lidx[cb] : (long long)a.L;
    const float d2 = sq3(__fsub_rn(cx, p[0]), __fsub_rn(cy, p[1]), __fsub_rn(cz, p[2]));
    const bool vall = in && cl < a.L && d2 <= a.maxd2;
    const int nn = __popc(__ballot_sync(FULL, vall));
    // 3. the k nearest: k rounds of a warp argmin (d2 >= 0, so the float
    //    bits order as the values); chosen columns masked above every key
    unsigned key = in ? __float_as_uint(vall ? d2 : 9e3f) : FULL;
    unsigned mykey = FULL;
    int mysel = 0;
    for (int r = 0; r < k; ++r) {
      const unsigned kmin = __reduce_min_sync(FULL, key);
      const unsigned lsel = __reduce_min_sync(FULL, key == kmin ? (unsigned)lane : 32u);
      if ((unsigned)lane == lsel) key = FULL;
      if (lane == r) { mykey = kmin; mysel = (int)lsel; }
    }
    // 4. lane r < k: neighbour r's offset, weight and weight gradient
    const bool isr = lane < k;
    const float nx = __shfl_sync(FULL, cx, mysel), ny = __shfl_sync(FULL, cy, mysel),
                nz = __shfl_sync(FULL, cz, mysel);
    const long long nl = __shfl_sync(FULL, cl, mysel);
    const bool vr = isr && __uint_as_float(mykey) < 9e3f;
    const int safe = vr ? (int)(nl < (long long)a.L ? nl : (long long)a.L) : a.L;
    float vraw[3] = {__fsub_rn(p[0], nx), __fsub_rn(p[1], ny), __fsub_rn(p[2], nz)};
    const float dd = vr ? sq3(vraw[0], vraw[1], vraw[2]) : 9e3f;
    float what = vr ? __frcp_rn(__fadd_rn(dd, a.eps)) : 0.f;
    if (!__any_sync(FULL, vr)) what = a.eps;
    float S = 0.f;
    for (int r = 0; r < k; ++r) S = __fadd_rn(S, __shfl_sync(FULL, what, r));
    const float w = vr ? __fdiv_rn(what, S) : 0.f;
    float dwh[3], dw[3];
    const float what2 = __fmul_rn(what, what);
#pragma unroll
    for (int c = 0; c < 3; ++c) dwh[c] = vr ? __fmul_rn(__fmul_rn(-2.f, vraw[c]), what2) : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sdw = 0.f;
      for (int r = 0; r < k; ++r) sdw = __fadd_rn(sdw, __shfl_sync(FULL, dwh[c], r));
      dw[c] = __fdiv_rn(__fsub_rn(dwh[c], __fmul_rn(w, sdw)), S);
    }
    float qw = 1.f, qv[3] = {0.f, 0.f, 0.f};
    float v[3] = {vraw[0], vraw[1], vraw[2]};
    if (a.after_pgo && isr) {
      const float* q = a.attr + (long)safe * a.attr_stride + 3;
      qw = q[0];
      qv[0] = q[1]; qv[1] = q[2]; qv[2] = q[3];
      const float nq[3] = {-qv[0], -qv[1], -qv[2]};
      quat_rot(qw, nq, vraw, v);
    }
    if (isr) {
      X[lane * XS + F] = vr ? v[0] : 0.f;
      X[lane * XS + F + 1] = vr ? v[1] : 0.f;
      X[lane * XS + F + 2] = vr ? v[2] : 0.f;
      SAFE[lane] = safe;
      WR[lane] = w;
    }
    __syncwarp();
    // 5. the k feature rows (zero where invalid: only valid rows are < L)
    for (int i = lane; i < k * F; i += 32) {
      const int r = i / F, d = i - r * F;
      const int sf = SAFE[r];
      X[r * XS + d] = sf < a.L ? a.feats[(long)sf * a.feat_stride + d] : 0.f;
    }
    __syncwarp();
    if (a.layer_norm) {
      // each row less its mean, over its population std + 1e-6
      for (int r = 0; r < k; ++r) {
        float* xr = X + r * XS;
        float s = 0.f;
        for (int d = lane; d < F; d += 32) s = __fadd_rn(s, xr[d]);
        const float mu = __fdiv_rn(warp_sum(s), (float)F);
        float q2 = 0.f;
        for (int d = lane; d < F; d += 32) {
          const float e = __fsub_rn(xr[d], mu);
          q2 = __fadd_rn(q2, __fmul_rn(e, e));
        }
        const float sig = __fadd_rn(__fsqrt_rn(__fdiv_rn(warp_sum(q2), (float)F)), 1e-6f);
        const bool valid_r = SAFE[r] < a.L;
        __syncwarp();
        for (int d = lane; d < F; d += 32)
          xr[d] = valid_r ? __fdiv_rn(__fsub_rn(xr[d], mu), sig) : 0.f;
        __syncwarp();
      }
    }
    // 6. the decode and the blend
    float sdf, sstd = 0.f, grad[3];
    if (!a.weighted_first) {
      float my_o = 0.f, my_g[3] = {0.f, 0.f, 0.f};
      for (int j = 0; j < k; ++j) {
        const float* xj = X + j * XS;
        float z[UPL];
#pragma unroll
        for (int i = 0; i < UPL; ++i) z[i] = 0.f;
        for (int d = 0; d < IN; ++d) {
          const float xv = xj[d];
          const float* wr = W1s + d * HS + lane;
#pragma unroll
          for (int i = 0; i < UPL; ++i)
            if (lane + 32 * i < H) z[i] = fmaf(xv, wr[32 * i], z[i]);
        }
        float po = 0.f, pg0 = 0.f, pg1 = 0.f, pg2 = 0.f;
#pragma unroll
        for (int i = 0; i < UPL; ++i) {
          const int u = lane + 32 * i;
          if (u < H) {
            const float zz = __fadd_rn(z[i], b1s[u]);
            if (zz > 0.f) {
              po = fmaf(zz, w2s[u], po);
              pg0 = fmaf(w2g[u], W1s[F * HS + u], pg0);
              pg1 = fmaf(w2g[u], W1s[(F + 1) * HS + u], pg1);
              pg2 = fmaf(w2g[u], W1s[(F + 2) * HS + u], pg2);
            }
          }
        }
        po = warp_sum(po);
        pg0 = warp_sum(pg0);
        pg1 = warp_sum(pg1);
        pg2 = warp_sum(pg2);
        if (lane == j) {
          my_o = __fmul_rn(__fadd_rn(po, b2), a.sdf_scale);
          my_g[0] = pg0; my_g[1] = pg1; my_g[2] = pg2;
        }
      }
      float gv[3];
      if (a.after_pgo) quat_rot(qw, qv, my_g, gv);
      else { gv[0] = my_g[0]; gv[1] = my_g[1]; gv[2] = my_g[2]; }
      sdf = 0.f;
      for (int r = 0; r < k; ++r)
        sdf = __fadd_rn(sdf, __fmul_rn(__shfl_sync(FULL, w, r), __shfl_sync(FULL, my_o, r)));
      float var = 0.f;
      for (int r = 0; r < k; ++r) {
        const float e = __fsub_rn(__shfl_sync(FULL, my_o, r), sdf);
        var = __fadd_rn(var, __fmul_rn(__shfl_sync(FULL, w, r), __fmul_rn(e, e)));
      }
      sstd = __fsqrt_rn(fmaxf(var, 0.f));
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float g1 = 0.f, g2 = 0.f;
        for (int r = 0; r < k; ++r) {
          g1 = __fadd_rn(g1, __fmul_rn(__shfl_sync(FULL, my_o, r), __shfl_sync(FULL, dw[c], r)));
          g2 = __fadd_rn(g2, __fmul_rn(__shfl_sync(FULL, w, r), __shfl_sync(FULL, gv[c], r)));
        }
        grad[c] = __fadd_rn(g1, g2);
      }
    } else {
      // h = sum_r w_r [f_r; v_r]
      for (int d = lane; d < IN; d += 32) {
        float h = 0.f;
        for (int r = 0; r < k; ++r) h = __fadd_rn(h, __fmul_rn(X[r * XS + d], WR[r]));
        HB[d] = h;
      }
      __syncwarp();
      float z[UPL];
#pragma unroll
      for (int i = 0; i < UPL; ++i) z[i] = 0.f;
      for (int d = 0; d < IN; ++d) {
        const float hv = HB[d];
        const float* wr = W1s + d * HS + lane;
#pragma unroll
        for (int i = 0; i < UPL; ++i)
          if (lane + 32 * i < H) z[i] = fmaf(hv, wr[32 * i], z[i]);
      }
      float po = 0.f;
#pragma unroll
      for (int i = 0; i < UPL; ++i) {
        const int u = lane + 32 * i;
        if (u < H) {
          const float zz = __fadd_rn(z[i], b1s[u]);
          if (zz > 0.f) po = fmaf(zz, w2s[u], po);
          GSC[u] = zz > 0.f ? w2g[u] : 0.f;
        }
      }
      sdf = __fmul_rn(__fadd_rn(warp_sum(po), b2), a.sdf_scale);
      __syncwarp();
      for (int d = lane; d < IN; d += 32) {
        const float* wr = W1s + d * HS;
        float g = 0.f;
        for (int u = 0; u < H; ++u) g = fmaf(GSC[u], wr[u], g);
        GH[d] = g;
      }
      __syncwarp();
      // lane r: a_r = [f_r; v_r] . g_h, and R_r^T g_h[v]
      float ar = 0.f;
      if (isr)
        for (int d = 0; d < IN; ++d) ar = fmaf(X[lane * XS + d], GH[d], ar);
      const float gh[3] = {GH[F], GH[F + 1], GH[F + 2]};
      float gv[3];
      if (a.after_pgo) quat_rot(qw, qv, gh, gv);
      else { gv[0] = gh[0]; gv[1] = gh[1]; gv[2] = gh[2]; }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float g1 = 0.f, g2 = 0.f;
        for (int r = 0; r < k; ++r) {
          g1 = __fadd_rn(g1, __fmul_rn(__shfl_sync(FULL, ar, r), __shfl_sync(FULL, dw[c], r)));
          g2 = __fadd_rn(g2, __fmul_rn(__shfl_sync(FULL, w, r), __shfl_sync(FULL, gv[c], r)));
        }
        grad[c] = __fadd_rn(g1, g2);
      }
    }
    __syncwarp();                      // the warp's rows are free for its next row
    // 7. the row's terms
    const float gn = __fsqrt_rn(sq3(grad[0], grad[1], grad[2]));
    const bool mask = nn >= a.min_nn && gn > a.min_grad && gn < a.max_grad && sstd < a.max_std;
    if (!mask) continue;               // the whole warp: its terms are exact zeros
    float wt = __fmul_rn(gm_weight(a.gm_d, a.gm_d2, sdf),
                         gm_weight(a.gm_g, a.gm_g2, __fsub_rn(gn, 1.f)));
    if (a.normals && (!a.normal_valid || a.normal_valid[row])) {
      const float* nr = a.normals + 3 * row;
      float nwv[3], dot = 0.f;
      const float gd = fmaxf(gn, 1e-12f);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        nwv[c] = fmaf(nr[2], a.R[3 * c + 2], fmaf(nr[1], a.R[3 * c + 1], __fmul_rn(nr[0], a.R[3 * c])));
#pragma unroll
      for (int c = 0; c < 3; ++c) dot = __fadd_rn(dot, __fmul_rn(nwv[c], __fdiv_rn(grad[c], gd)));
      wt = __fmul_rn(wt, __fadd_rn(0.5f, fabsf(dot)));
    }
    float J[6];
    cross3(cur, grad, J);
    J[3] = grad[0]; J[4] = grad[1]; J[5] = grad[2];
    float term = 0.f;
    if (lane < 21) term = __fmul_rn(pick6(J, ia), __fmul_rn(pick6(J, ib), wt));
    else if (lane < 27) term = __fmul_rn(__fmul_rn(pick6(J, lane - 21), wt), sdf);
    else if (lane == 27) term = wt;
    else if (lane == 28) term = 1.f;
    else if (lane == 29) term = fabsf(sdf);
    acc = __fadd_rn(acc, term);
  }

  // the block's partial row: its warps' sums in warp order
  if (lane < TS_SUMS) red[warp * TS_SUMS + lane] = acc;
  __syncthreads();
  if (threadIdx.x < TS_SUMS) {
    float s = 0.f;
    for (int wi = 0; wi < TS_WARPS; ++wi) s = __fadd_rn(s, red[wi * TS_SUMS + threadIdx.x]);
    a.partial[(long)blockIdx.x * TS_SUMS + threadIdx.x] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block: the partial rows in block order (warp wi sums blocks
  // wi, wi + 8, ...; then the eight in warp order)
  __threadfence();
  if (lane < TS_SUMS) {
    float s = 0.f;
    for (int b = warp; b < (int)gridDim.x; b += TS_WARPS)
      s = __fadd_rn(s, __ldcg(a.partial + (long)b * TS_SUMS + lane));
    red[warp * TS_SUMS + lane] = s;
  }
  __syncthreads();
  float* tot = red + TS_WARPS * TS_SUMS;   // the block's dynamic memory holds it
  if (threadIdx.x < TS_SUMS) {
    float s = 0.f;
    for (int wi = 0; wi < TS_WARPS; ++wi) s = __fadd_rn(s, red[wi * TS_SUMS + threadIdx.x]);
    tot[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x < TS_OUT) {
    const int i = threadIdx.x;
    const float cnt = tot[28], cl = fmaxf(cnt, 1.f);
    const float den = fmaxf(__fmul_rn(2.f, __fdiv_rn(tot[27], cl)), 1e-12f);
    float v = 0.f;
    if (i < 36) {
      int r = i / 6, c = i - 6 * (i / 6);
      if (r > c) { const int x = r; r = c; c = x; }
      // entry (r, c), r <= c, of the upper triangle
      const int e = r * 6 - r * (r - 1) / 2 + (c - r);
      v = __fdiv_rn(tot[e], den);
    } else if (i < 42) {
      v = -__fdiv_rn(tot[21 + i - 36], den);
    } else if (i == 42) {
      v = __fmul_rn(__fdiv_rn(tot[29], cl), 100.f);
    } else if (i == 43) {
      v = cnt;
    }
    a.out[i] = v;
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

template <int UPL>
static int launch(const TrackArgs& a, int grid, cudaStream_t st) {
  const size_t bytes = (size_t)(track_smem_floats(a.F, a.H, a.k) + TS_SUMS) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        track_step_kernel<UPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  track_step_kernel<UPL><<<grid, TS_THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// (warps a block, floats of a partial row, floats of the packed vector)
void track_step_geometry(int* out) {
  out[0] = TS_WARPS;
  out[1] = TS_SUMS;
  out[2] = TS_OUT;
}

// fl: R (9) | t (3) | origin (3) | sdf_scale | max_valid_dist2 | idw_eps |
//     GM_dist | GM_dist^2 | GM_grad | GM_grad^2 | min_grad | max_grad | max_std
// in: N | M | k | F | H | L | feat_stride | attr_stride | min_nn |
//     weighted_first | layer_norm | after_pgo
// p:  src | src_valid | xs | ys | zs | lidx | feats | attr | W1 | b1 | W2 |
//     b2 | normals | normal_valid | out | partial | ticket (0 = none)
// (all host arrays; the pose and scalars reach the kernel by value)
int track_step_launch(const float* fl, const int* in, void* const* p, int grid, void* stream) {
  TrackArgs a;
  for (int i = 0; i < 9; ++i) a.R[i] = fl[i];
  for (int i = 0; i < 3; ++i) { a.t[i] = fl[9 + i]; a.origin[i] = fl[12 + i]; }
  a.sdf_scale = fl[15]; a.maxd2 = fl[16]; a.eps = fl[17];
  a.gm_d = fl[18]; a.gm_d2 = fl[19]; a.gm_g = fl[20]; a.gm_g2 = fl[21];
  a.min_grad = fl[22]; a.max_grad = fl[23]; a.max_std = fl[24];
  a.N = in[0]; a.M = in[1]; a.k = in[2]; a.F = in[3]; a.H = in[4]; a.L = in[5];
  a.feat_stride = in[6]; a.attr_stride = in[7]; a.min_nn = in[8]; a.weighted_first = in[9];
  a.layer_norm = in[10]; a.after_pgo = in[11];
  a.src = (const float*)p[0];
  a.src_valid = (const unsigned char*)p[1];
  a.xs = (const float*)p[2]; a.ys = (const float*)p[3]; a.zs = (const float*)p[4];
  a.lidx = (const long long*)p[5];
  a.feats = (const float*)p[6];
  a.attr = (const float*)p[7];
  a.W1 = (const float*)p[8]; a.b1 = (const float*)p[9];
  a.W2 = (const float*)p[10]; a.b2 = (const float*)p[11];
  a.normals = (const float*)p[12];
  a.normal_valid = (const unsigned char*)p[13];
  a.out = (float*)p[14];
  a.partial = (float*)p[15];
  a.ticket = (unsigned*)p[16];
  if (a.M < 1 || a.M > 32 || a.k < 1 || a.k > 16 || a.k > a.M || a.F < 1 || a.F > 64 ||
      a.H < 1 || a.H > 256 || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.H <= 32) return launch<1>(a, grid, st);
  if (a.H <= 64) return launch<2>(a, grid, st);
  if (a.H <= 128) return launch<4>(a, grid, st);
  return launch<8>(a, grid, st);
}

}  // extern "C"
