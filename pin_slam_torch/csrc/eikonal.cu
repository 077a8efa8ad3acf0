// Decimated central-difference eikonal term (kernel 3 of the port).
//
// Replaces the Pallas kernel `_eik_kernel` / `fused_eikonal_iter` in
// pin_slam_tpu/ops/train_kernel.py.  Per base row: six stencil decodes
// (+-step along each axis) share the base row's k gathered feature rows,
// blended with the stencil's own IDW weights (weighted_first) or decoded per
// neighbour and blended (otherwise).  g = (sdf+ - sdf-) / 2h,
// loss = (|g| - 1)^2 * esc.  Backward to the base rows' feature gradients
// (certainty column = sum of the six stencil weights) and the decoder.
//
// Bound on an H100: operations.  At the main path's n = 1638 base rows and
// k = 6 the launch reads and writes well under 1 MB, and its float32 FMAs
// (a forward decode, its recomputation and the input gradient, ~2.1 k FMAs
// per decode, plus ~0.8 k for the decoder-gradient sums) take a few
// microseconds at the card's peak; a shared-memory read per FMA makes the
// practical limit the SM's shared-memory port, not the FMA units.
//
// Design: parallel over decodes, not base rows.  A block of 256 threads owns
// R consecutive base rows and all their D = R * 6 (weighted_first) or
// R * 6k decodes, which it runs in chunks of 64: four lanes share a decode,
// each taking 16 of the 64 hidden units (unit 4t + lane), and add their
// partial outputs and input gradients by two xor shuffles.  The wrapper
// picks R from n, k and the SM count so that the blocks spread over the
// card with few idle decode slots (ops/train_kernel.eikonal_rows_per_block).
// Phases, separated by barriers:
//   1. forward: per chunk, the inputs x (11 per decode) are built into
//      shared memory once, then each decode's raw output is kept (od);
//   2. per row (one thread each): sdf_j, g, |g|, the loss term and dsdf_j;
//      od becomes each decode's upstream gradient dO;
//   3. backward: per chunk, x is rebuilt, each decode's hidden activations h
//      and their gradients dh are staged in shared memory and its feature
//      gradient dx (8 values) is kept; then the block sums the chunk's
//      decoder-gradient terms once: thread (g, j) owns hidden unit j for a
//      quarter of the chunk's decodes and adds x_i dh_j (11 entries of dW1),
//      dh_j (db1), dO h_j (dW2) and, for j = 0, dO (db2) in slot order;
//   4. feature gradients: for each (row, neighbour, column) the six
//      stencils' terms are added in stencil order, written contiguously;
//   5. the four quarter sums are added in order and the block's partial
//      gradient is stored; `reduce_partials` (train_common.cuh) then adds
//      the blocks' partials in a fixed order.
// Every sum has a fixed order and there are no atomics, so two launches on
// the same inputs give the same bits.  Shared memory depends on D (dynamic,
// up to ~59 KB, above the 48 KB default after cudaFuncSetAttribute).
// Float32 on the CUDA cores, as the port's precision policy asks; a
// 3xTF32 mma.sync split of the 11 x 64 products is a later option.
//
// With positional encoding (VD != 3) the wrapper launches the general form
// below (namespace eig; its design, shared with the train kernel's, is at
// namespace gen in train_common.cuh): at path H's n = 1638, k = 6 per
// neighbour, VD = 27, 0.0414 ms on the device against a 0.0092 ms bound
// (operations; PR 12's first general form 0.145 ms), at pe_gaussian's
// weighted_first VD = 35 0.0170 ms against 0.0018 (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py, scripts/kernel_ab.py).  At any other feature
// width F, hidden width H or VD > 64 it launches the tiled general form
// (namespace eit below, over gtl in train_common.cuh).

#include "train_common.cuh"

using namespace tk;

namespace eik {

constexpr int EB = 256;                   // threads per block
constexpr int LANES = 4;                  // lanes per decode
constexpr int SLOTS = EB / LANES;         // decodes per chunk
constexpr int UPL = H / LANES;            // hidden units per lane
constexpr int HP = H + 4;                 // staging pitch: conflict-free writes and reads
constexpr int DMAX = 512;                 // decodes per block
constexpr int PAR = (NP + 3) & ~3;        // decoder block, padded
constexpr int GROUPS = EB / H;            // reduction quarters
constexpr int RED = IN + 2;               // per-owner sums: dW1[:, j], db1[j], dW2[j]
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int smem_floats(int D, int R) {
  return PAR + SLOTS * IN + 2 * SLOTS * HP + D * (1 + F) + R;
}

template <bool WF>
__global__ void __launch_bounds__(EB) eikonal_kernel(
    const float* __restrict__ feats, const float* __restrict__ wst,
    const float* __restrict__ vst, const float* __restrict__ esc,
    const float* __restrict__ params, int n, int k, int R, float scale, float inv2e,
    float* __restrict__ dfeats, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const float* W1 = sm;                   // packed decoder: W1 (IN, H) | b1 | W2 | b2
  const float* b1 = sm + IN * H;
  const float* W2 = b1 + H;
  const float* b2 = W2 + H;
  float* xs = sm + PAR;                   // (SLOTS, IN) chunk inputs
  float* hs = xs + SLOTS * IN;            // (SLOTS, HP) hidden activations
  float* dhs = hs + SLOTS * HP;           // (SLOTS, HP) their gradients
  const int kd = WF ? 1 : k;
  const int dr = 6 * kd;                  // decodes per base row: (stencil, neighbour)
  const int D = R * dr;
  float* od = dhs + SLOTS * HP;           // (D,) raw outputs, then dO
  float* dxs = od + D;                    // (D, F) feature gradients
  float* pwr = dxs + D * F;               // (R,) loss terms

  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * R;
  const int rows = (int)min((long)R, (long)n - row0);
  const int Dv = rows * dr;               // decodes of real rows
  for (int e = tid; e < NP; e += EB) sm[e] = params[e];

  // x of chunk c's decodes into xs (zeros past the block's real decodes)
  auto build_xs = [&](int c) {
    for (int e = tid; e < SLOTS * IN; e += EB) {
      const int s = e / IN, i = e - s * IN;
      const int d = c * SLOTS + s;
      float v = 0.f;
      if (d < Dv) {
        const int r = d / dr, rem = d - r * dr, j = rem / kd, kk = rem - j * kd;
        const long row = row0 + r, sr = (long)j * n + row;
        if (i < F) {
          if (WF) {
            const float* wj = wst + sr * k;
            const float* fr = feats + row * k * C;
            for (int q = 0; q < k; ++q) v = fmaf(wj[q], fr[q * C + i], v);
          } else {
            v = feats[(row * k + kk) * C + i];
          }
        } else {
          v = WF ? vst[sr * VD + (i - F)] : vst[sr * (k * VD) + kk * VD + (i - F)];
        }
      }
      xs[e] = v;
    }
  };

  const int s = tid / LANES, lane = tid % LANES;
  const int nchunks = (Dv + SLOTS - 1) / SLOTS;

  // 1. forward
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();                      // params loaded / previous chunk's xs read
    build_xs(c);
    __syncthreads();
    float xv[IN];
#pragma unroll
    for (int i = 0; i < IN; ++i) xv[i] = xs[s * IN + i];
    float o = 0.f;
#pragma unroll 4
    for (int t = 0; t < UPL; ++t) {
      const int j = LANES * t + lane;
      float z = 0.f;
#pragma unroll
      for (int i = 0; i < IN; ++i) z = fmaf(xv[i], W1[i * H + j], z);
      z += b1[j];
      o = fmaf(fmaxf(z, 0.f), W2[j], o);
    }
    o += __shfl_xor_sync(FULL, o, 1);
    o += __shfl_xor_sync(FULL, o, 2);
    const int d = c * SLOTS + s;
    if (lane == 0 && d < Dv) od[d] = o + b2[0];
  }
  __syncthreads();

  // 2. per row: the loss term and each decode's upstream gradient
  if (tid < rows) {
    const int r = tid;
    const long row = row0 + r;
    float* o = od + r * dr;
    auto wgt = [&](int j, int kk) { return wst[((long)j * n + row) * k + kk]; };
    float sdf[6];
    for (int j = 0; j < 6; ++j) {
      if (WF) {
        sdf[j] = o[j] * scale;
      } else {
        float p = 0.f;
        for (int kk = 0; kk < k; ++kk) p = fmaf(wgt(j, kk), o[j * k + kk], p);
        sdf[j] = p * scale;
      }
    }
    const float e = esc[row];
    const float gx = (sdf[0] - sdf[3]) * inv2e;
    const float gy = (sdf[1] - sdf[4]) * inv2e;
    const float gz = (sdf[2] - sdf[5]) * inv2e;
    const float nrm = sqrtf(gx * gx + gy * gy + gz * gz + 1e-12f);
    pwr[r] = (nrm - 1.f) * (nrm - 1.f) * e;
    const float dg = 2.f * (nrm - 1.f) * e / nrm * inv2e;
    const float dsdf[6] = {dg * gx, dg * gy, dg * gz, -dg * gx, -dg * gy, -dg * gz};
    for (int j = 0; j < 6; ++j) {
      if (WF)
        o[j] = dsdf[j] * scale;
      else
        for (int kk = 0; kk < k; ++kk) o[j * k + kk] = dsdf[j] * scale * wgt(j, kk);
    }
  }

  // 3. backward, one decoder-gradient sum per chunk
  const int grp = tid / H, jo = tid % H;  // reduction owner: quarter, hidden unit
  float acc[IN];
#pragma unroll
  for (int i = 0; i < IN; ++i) acc[i] = 0.f;
  float adb1 = 0.f, adw2 = 0.f, adb2 = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();                      // dO written / previous chunk's staging read
    build_xs(c);
    __syncthreads();
    const int d = c * SLOTS + s;
    const bool act = d < Dv;
    const float dO = act ? od[d] : 0.f;
    float xv[IN], dx[F];
#pragma unroll
    for (int i = 0; i < IN; ++i) xv[i] = xs[s * IN + i];
#pragma unroll
    for (int i = 0; i < F; ++i) dx[i] = 0.f;
#pragma unroll 4
    for (int t = 0; t < UPL; ++t) {
      const int j = LANES * t + lane;
      float w[IN];
#pragma unroll
      for (int i = 0; i < IN; ++i) w[i] = W1[i * H + j];
      float z = 0.f;
#pragma unroll
      for (int i = 0; i < IN; ++i) z = fmaf(xv[i], w[i], z);
      z += b1[j];
      const float dh = z > 0.f ? dO * W2[j] : 0.f;
      hs[s * HP + j] = fmaxf(z, 0.f);
      dhs[s * HP + j] = dh;
#pragma unroll
      for (int i = 0; i < F; ++i) dx[i] = fmaf(dh, w[i], dx[i]);
    }
#pragma unroll
    for (int i = 0; i < F; ++i) {
      dx[i] += __shfl_xor_sync(FULL, dx[i], 1);
      dx[i] += __shfl_xor_sync(FULL, dx[i], 2);
      if (act && i / 2 == lane) dxs[d * F + i] = dx[i];
    }
    __syncthreads();
    const int nd = min(SLOTS, Dv - c * SLOTS);
    const int q0 = grp * (SLOTS / GROUPS), q1 = min(q0 + SLOTS / GROUPS, nd);
    for (int q = q0; q < q1; ++q) {
      const float h = hs[q * HP + jo], dh = dhs[q * HP + jo], g = od[c * SLOTS + q];
#pragma unroll
      for (int i = 0; i < IN; ++i) acc[i] = fmaf(xs[q * IN + i], dh, acc[i]);
      adb1 += dh;
      adw2 = fmaf(g, h, adw2);
      if (jo == 0) adb2 += g;
    }
  }
  __syncthreads();                        // last chunk's staging read: reuse hs as red

  // 5a. stage the quarter sums
  float* red = hs;                        // (GROUPS, RED, H) then (GROUPS,) db2
#pragma unroll
  for (int i = 0; i < IN; ++i) red[(grp * RED + i) * H + jo] = acc[i];
  red[(grp * RED + IN) * H + jo] = adb1;
  red[(grp * RED + IN + 1) * H + jo] = adw2;
  if (jo == 0) red[GROUPS * RED * H + grp] = adb2;

  // 4. feature gradients of the block's rows, in stencil order
  const int per_row = k * C;
  float* dst = dfeats + row0 * per_row;
  for (int e = tid; e < rows * per_row; e += EB) {
    const int r = e / per_row, rem = e - r * per_row, kk = rem / C, f = rem - kk * C;
    const long row = row0 + r;
    const float* dxr = dxs + (long)r * dr * F;
    float a = 0.f;
    if (f == F) {
      for (int j = 0; j < 6; ++j) a += wst[((long)j * n + row) * k + kk];
    } else if (WF) {
      for (int j = 0; j < 6; ++j) a = fmaf(wst[((long)j * n + row) * k + kk], dxr[j * F + f], a);
    } else {
      for (int j = 0; j < 6; ++j) a += dxr[(j * k + kk) * F + f];
    }
    dst[e] = a;
  }
  __syncthreads();

  // 5b. the block's partial gradient: quarters added in order
  float* pb = partial + (long)blockIdx.x * E;
  for (int e = tid; e < RED * H; e += EB) {
    const int m = e / H, j = e - m * H;
    float a = red[m * H + j];
    for (int g = 1; g < GROUPS; ++g) a += red[(g * RED + m) * H + j];
    pb[m < IN ? m * H + j : (m == IN ? IN * H + j : IN * H + H + j)] = a;
  }
  if (tid == 0) {
    float a = red[GROUPS * RED * H];
    for (int g = 1; g < GROUPS; ++g) a += red[GROUPS * RED * H + g];
    pb[IN * H + 2 * H] = a;
    float l = 0.f;
    for (int r = 0; r < rows; ++r) l += pwr[r];
    pb[E - 1] = l;
  }
}

template <bool WF>
int launch(const void* feats, const void* wst, const void* vst, const void* esc,
           const void* params, int n, int k, int R, float scale, float inv2e, void* dfeats,
           void* partial, int nblocks, cudaStream_t st) {
  static bool opted_in = false;           // the dynamic shared memory above 48 KB
  if (!opted_in) {
    const int err = (int)cudaFuncSetAttribute(eikonal_kernel<WF>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              smem_floats(DMAX, DMAX / 6) * 4);
    if (err) return err;
    opted_in = true;
  }
  const int D = R * 6 * (WF ? 1 : k);
  eikonal_kernel<WF><<<nblocks, EB, smem_floats(D, R) * 4, st>>>(
      (const float*)feats, (const float*)wst, (const float*)vst, (const float*)esc,
      (const float*)params, n, k, R, scale, inv2e, (float*)dfeats, (float*)partial);
  return (int)cudaGetLastError();
}

}  // namespace eik

namespace eig {

using namespace gen;

// The general form for VD != 3 (positional encoding; gen:: in
// train_common.cuh), built for the padded input width IP.  The base rows come
// in groups of R, each row with its 6 (weighted_first) or 6 k decodes (row,
// stencil, neighbour); block b takes groups b, b + gridDim.x, ... in turn,
// with the decoder loaded once and its decoder-gradient sums kept in
// registers across its groups.  Per group:
//   0. one flat copy each (cp.async, all in flight at once) of the rows'
//      stencil weights (stencil by stencil), eikonal weights, feature rows
//      (into the scratch) and each stencil's offset vectors (into x); then
//      each decode's features from the staged rows: the blend over the
//      neighbours with its stencil's weights (weighted_first, fma in order),
//      or its neighbour's row;
//   1. forward, tile by tile (gen::forward_tile);
//   2. a warp a row: lane j < 6 the stencil's sdf (its neighbours' outputs
//      blended in order), shuffled to every lane; the gradient's norm, the
//      loss term; each decode's dO, a lane each;
//   3. the group's decodes added to the decoder-gradient sums: dh in place
//      of z with db1, dW2, db2 (gen::dh_pass), then dW1 (gen::backward);
//   4. feature gradients: each (row, neighbour, column)'s six stencil terms
//      (dx = dO P, times the stencil's weight with weighted_first) added in
//      stencil order.
// Then the block's partial row (gen::store_partial).
template <int IP, bool WF>
__global__ void __launch_bounds__(GB, 2) eikonal_general_kernel(
    const float* __restrict__ feats, const float* __restrict__ wst,
    const float* __restrict__ vst, const float* __restrict__ esc,
    const float* __restrict__ params, int n, int k, int vd, int R, float scale, float inv2e,
    float* __restrict__ dfeats, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int XP = Cls<IP>::XP;
  const int in = F + vd, kd = WF ? 1 : k;
  const int dr = 6 * kd;                  // decodes per base row: (stencil, neighbour)
  const Lay L = layout<IP>(R * dr, R * k * C, 6 * R * k, R);
  float *xs = sm + L.xs, *zs = sm + L.zs, *od = sm + L.od, *pd = sm + L.pd;
  float *ws = sm + L.ws, *pwr = sm + L.pwr, *es = sm + L.ra;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ngroups = (n + R - 1) / R;
  const float rdr = 1.f / dr, rkd = 1.f / kd, rk = 1.f / k, rv = 1.f / vd;
  GEN_STAMP_START;
  load_decoder<IP>(sm, params, in);       // waited for with the first group's rows
  const float b2 = params[in * H + 2 * H];
  Grad<IP> a;
  grad_init<IP>(a);
  float loss = 0.f;
  // x zero once: its columns past `in` stay zero (no copy reaches them), and
  // rows past a group's decodes hold zeros or an earlier group's inputs,
  // whose outputs are never stored
  for (int e = tid; e < L.zs - L.xs; e += GB) xs[e] = 0.f;
  __syncthreads();

  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const long row0 = (long)grp * R;
    const int rows = (int)min((long)R, (long)n - row0);
    const int Dv = rows * dr, Dp = (Dv + TILE - 1) / TILE * TILE;

    // 0. staging: ws (6, rows, k); the feature rows (rows, k, C) in zs
    {
      const int nw = rows * k;
      const float rnw = 1.f / nw;
      for (int e = tid; e < 6 * nw; e += GB) {
        const int j = fdiv(e, rnw);
        cp4(ws + e, wst + ((long)j * n + row0) * k + e - j * nw);
      }
      for (int e = tid; e < rows; e += GB) cp4(es + e, esc + row0 + e);
      const float* f0 = feats + row0 * k * C;
      for (int e = tid; e < rows * k * C; e += GB) cp4(zs + e, f0 + e);
      const int nv = rows * kd * vd;
      for (int j = 0; j < 6; ++j) {
        const float* v0 = vst + ((long)j * n + row0) * kd * vd;
        for (int e = tid; e < nv; e += GB) {
          const int m = fdiv(e, rv), r = fdiv(m, rkd);   // m = r kd + kk
          const int d = (r * 6 + j) * kd + m - r * kd;
          cp4(xs + d * XP + F + e - m * vd, v0 + e);
        }
      }
      cp_wait();
    }
    __syncthreads();
    for (int e = tid; e < Dv * F; e += GB) {
      const int d = e / F, f = e - d * F;
      const int r = fdiv(d, rdr), rem = d - r * dr, j = fdiv(rem, rkd), kk = rem - j * kd;
      float v;
      if (WF) {
        const float* wj = ws + (j * rows + r) * k;
        const float* fr = zs + r * k * C + f;
        v = 0.f;
        for (int q = 0; q < k; ++q) v = fmaf(wj[q], fr[q * C], v);
      } else {
        v = zs[(r * k + kk) * C + f];
      }
      xs[d * XP + f] = v;
    }
    __syncthreads();
    GEN_STAMP(0);

    // 1. forward
    for (int t = 0; t < Dp / TILE; ++t) forward_tile<IP>(sm, xs, zs, od, pd, t, Dv, b2);
    __syncthreads();
    GEN_STAMP(1);

    // 2. a warp a row: the loss term and each decode's upstream gradient
    for (int r = warp; r < rows; r += GB / 32) {
      float* o = od + r * dr;
      const float* wr = ws + r * k;       // stencil j's weights at wr + j * rows * k
      float sj = 0.f;
      if (lane < 6) {
        if (WF) {
          sj = o[lane] * scale;
        } else {
          float p = 0.f;
          for (int kk = 0; kk < k; ++kk) p = fmaf(wr[lane * rows * k + kk], o[lane * k + kk], p);
          sj = p * scale;
        }
      }
      float sdf[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) sdf[j] = __shfl_sync(FULL, sj, j);
      const float e = es[r];
      const float gx = (sdf[0] - sdf[3]) * inv2e;
      const float gy = (sdf[1] - sdf[4]) * inv2e;
      const float gz = (sdf[2] - sdf[5]) * inv2e;
      const float nrm = sqrtf(gx * gx + gy * gy + gz * gz + 1e-12f);
      if (lane == 0) pwr[r] = (nrm - 1.f) * (nrm - 1.f) * e;
      const float dg = 2.f * (nrm - 1.f) * e / nrm * inv2e;
      for (int m = lane; m < dr; m += 32) {
        const int j = fdiv(m, rkd), kk = m - j * kd;
        const float gj = j % 3 == 0 ? gx : (j % 3 == 1 ? gy : gz);
        const float ds = j < 3 ? dg * gj : -dg * gj;
        o[m] = WF ? ds * scale : ds * scale * wr[j * rows * k + kk];
      }
    }
    __syncthreads();
    GEN_STAMP(2);

    // 3. backward: the dh pass, then dW1
    loss_add(loss, pwr, rows);
    dh_pass<IP>(sm, zs, od, Dv, a);
    __syncthreads();
    backward<IP>(xs, zs, Dv, a);
    GEN_STAMP(3);

    // 4. feature gradients of the group's rows, in stencil order
    float* dst = dfeats + row0 * k * C;
    for (int e = tid; e < rows * k * C; e += GB) {
      const int rq = e / C, f = e - rq * C;   // rq = r k + kk
      const int r = fdiv(rq, rk), kk = rq - r * k;
      float v = 0.f;
      if (f == F) {
        for (int j = 0; j < 6; ++j) v += ws[(j * rows + r) * k + kk];
      } else if (WF) {
        for (int j = 0; j < 6; ++j) {
          const int d = r * 6 + j;
          v = fmaf(ws[(j * rows + r) * k + kk], od[d] * pd[d * F + f], v);
        }
      } else {
        for (int j = 0; j < 6; ++j) {
          const int d = (r * 6 + j) * k + kk;
          v += od[d] * pd[d * F + f];
        }
      }
      dst[e] = v;
    }
    __syncthreads();                      // the group's staging read: the next one's, or
    GEN_STAMP(4);                         // the streams' sums, reuse it
  }

  // 5. the block's partial row
  store_partial<IP>(xs, a, loss, in, partial + (long)blockIdx.x * (in * H + 2 * H + 2));
  GEN_STAMP(5);
}

template <int IP, bool WF>
int opt_in() {
  static bool done = false;               // the dynamic shared memory above 48 KB
  if (!done) {
    const int err = (int)cudaFuncSetAttribute(eikonal_general_kernel<IP, WF>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              max_smem_floats<IP>() * 4);
    if (err) return err;
    done = true;
  }
  return 0;
}

template <int IP, bool WF>
int launch_general(const void* feats, const void* wst, const void* vst, const void* esc,
                   const void* params, int n, int k, int vd, int R, float scale, float inv2e,
                   void* dfeats, void* partial, int nblocks, cudaStream_t st) {
  const int err = opt_in<IP, WF>();
  if (err) return err;
  const Lay L = layout<IP>(R * 6 * (WF ? 1 : k), R * k * C, 6 * R * k, R);
  eikonal_general_kernel<IP, WF><<<nblocks, GB, L.total * 4, st>>>(
      (const float*)feats, (const float*)wst, (const float*)vst, (const float*)esc,
      (const float*)params, n, k, vd, R, scale, inv2e, (float*)dfeats, (float*)partial);
  return (int)cudaGetLastError();
}

template <int IP, bool WF>
int blocks_per_sm() {
  int nb = 0;
  int err = opt_in<IP, WF>();
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, eikonal_general_kernel<IP, WF>, GB, max_smem_floats<IP>() * 4);
  return err ? -err : nb;
}

template <bool WF>
int launch_vd(const void* feats, const void* wst, const void* vst, const void* esc,
              const void* params, int n, int k, int vd, int R, float scale, float inv2e,
              void* dfeats, void* partial, int nblocks, cudaStream_t st) {
  GEN_DISPATCH(launch_general, feats, wst, vst, esc, params, n, k, vd, R, scale, inv2e, dfeats,
               partial, nblocks, st)
}

template <bool WF>
int blocks_per_sm_vd(int vd) {
  GEN_DISPATCH(blocks_per_sm)
}

}  // namespace eig

// The tiled general form (gtl in train_common.cuh): any F, H and VD the
// wrappers' predicate takes outside the width classes.  Per group of R base
// rows, decode d = (r 6 + j) kd + kk as above:
//   0. the stencil weights (stencil by stencil) and eikonal weights;
//   1. chunk by chunk: x (the stencil's blend of the base row's k feature
//      rows with weighted_first, fma in order from global memory, or the
//      neighbour's row; then the stencil's offset vector: copies by
//      cp.async, element by element), z, o;
//   2. a warp a row: the stencil sdfs, the gradient's norm, the loss term,
//      each decode's dO; warp 0 adds the loss and db2 terms;
//   3. chunk by chunk (x and z staged again when the group has several):
//      dh with db1 / dW2, dW1 into the block's partial row, dX into pd;
//   4. the feature gradients, each (row, neighbour, column)'s six stencil
//      terms added in stencil order.
namespace eit {

using namespace gtl;

template <bool WF>
__device__ __forceinline__ void build_x(float* xs, const float* __restrict__ feats,
                                        const float* __restrict__ vst, const float* ws,
                                        const Plan& P, int n, long row0, int rows, int k, int c0,
                                        int Dc) {
  const int in = P.in, F = P.F, C = P.C, vd = P.vd, kd = WF ? 1 : k, dr = 6 * kd;
  const float rin = 1.f / in, rdr = 1.f / dr, rkd = 1.f / kd;
  for (int e = threadIdx.x; e < Dc * in; e += GB) {
    const int dd = gen::fdiv(e, rin), i = e - dd * in, d = c0 + dd;
    const int r = gen::fdiv(d, rdr), rem = d - r * dr, j = gen::fdiv(rem, rkd);
    const int kk = rem - j * kd;
    float* dst = xs + dd * P.XP + i;
    if (i >= F) {
      cp4(dst, vst + (((long)j * n + row0 + r) * kd + kk) * vd + (i - F));
    } else if (WF) {
      const float* fr = feats + (row0 + r) * k * C + i;
      const float* wj = ws + (j * rows + r) * k;
      float v = 0.f;
#pragma unroll 4
      for (int q = 0; q < k; ++q) v = fmaf(wj[q], __ldg(fr + q * C), v);
      *dst = v;
    } else {
      cp4(dst, feats + ((row0 + r) * k + kk) * C + i);
    }
  }
  cp_wait();
}

template <bool WF>
__global__ void __launch_bounds__(GB, 2) eikonal_tiled_kernel(
    const float* __restrict__ feats, const float* __restrict__ wst,
    const float* __restrict__ vst, const float* __restrict__ esc,
    const float* __restrict__ params, const __grid_constant__ Plan P, int n, int k, int R,
    float scale, float inv2e, float* __restrict__ dfeats, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *w1s = sm + P.w1, *b1s = sm + P.b1, *w2s = sm + P.w2, *xs = sm + P.xs, *zs = sm + P.zs;
  float *od = sm + P.od, *pd = sm + P.pd, *ws = sm + P.ws, *pwr = sm + P.pwr, *es = sm + P.ra;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kd = WF ? 1 : k, dr = 6 * kd, F = P.F, C = P.C;
  const int ngroups = (n + R - 1) / R;
  float* pb = partial + (long)blockIdx.x * (P.in * P.H + 2 * P.H + 2);
  block_start(sm, params, P, pb);
  const float b2 = params[P.in * P.H + 2 * P.H];
  float sb1 = 0.f, sw2 = 0.f, db2 = 0.f, loss = 0.f;

  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const long row0 = (long)grp * R;
    const int rows = (int)min((long)R, (long)n - row0);
    const int Dv = rows * dr, nch = (Dv + P.DC - 1) / P.DC;

    // 0. staging: ws (6, rows, k), es (rows)
    {
      const int nw = rows * k;
      for (int e = tid; e < 6 * nw; e += GB) {
        const int j = e / nw;
        cp4(ws + e, wst + ((long)j * n + row0) * k + e - j * nw);
      }
      for (int e = tid; e < rows; e += GB) cp4(es + e, esc + row0 + e);
      cp_wait();
    }
    __syncthreads();

    // 1. forward, chunk by chunk
    for (int c = 0; c < nch; ++c) {
      const int c0 = c * P.DC, Dc = min(P.DC, Dv - c0);
      build_x<WF>(xs, feats, vst, ws, P, n, row0, rows, k, c0, Dc);
      __syncthreads();
      forward(w1s, b1s, w2s, xs, zs, od + c0, b2, params, P, Dc);
    }

    // 2. a warp a row: the loss term and each decode's upstream gradient
    for (int r = warp; r < rows; r += GB / 32) {
      float* o = od + r * dr;
      const float* wr = ws + r * k;       // stencil j's weights at wr + j * rows * k
      float sj = 0.f;
      if (lane < 6) {
        if (WF) {
          sj = o[lane] * scale;
        } else {
          float p = 0.f;
          for (int kk = 0; kk < k; ++kk) p = fmaf(wr[lane * rows * k + kk], o[lane * k + kk], p);
          sj = p * scale;
        }
      }
      float sdf[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) sdf[j] = __shfl_sync(FULL, sj, j);
      const float e = es[r];
      const float gx = (sdf[0] - sdf[3]) * inv2e;
      const float gy = (sdf[1] - sdf[4]) * inv2e;
      const float gz = (sdf[2] - sdf[5]) * inv2e;
      const float nrm = sqrtf(gx * gx + gy * gy + gz * gz + 1e-12f);
      if (lane == 0) pwr[r] = (nrm - 1.f) * (nrm - 1.f) * e;
      const float dg = 2.f * (nrm - 1.f) * e / nrm * inv2e;
      for (int m = lane; m < dr; m += 32) {
        const int j = m / kd, kk = m - j * kd;
        const float gj = j % 3 == 0 ? gx : (j % 3 == 1 ? gy : gz);
        const float ds = j < 3 ? dg * gj : -dg * gj;
        o[m] = WF ? ds * scale : ds * scale * wr[j * rows * k + kk];
      }
    }
    __syncthreads();
    if (tid < 32) {                       // warp 0: the loss and db2 terms in a fixed order
      const float l = warp_sum(pwr, rows), g = warp_sum(od, Dv);
      loss += l;
      db2 += g;
    }

    // 3. backward, chunk by chunk
    for (int c = 0; c < nch; ++c) {
      const int c0 = c * P.DC, Dc = min(P.DC, Dv - c0);
      if (nch > 1) {
        __syncthreads();                  // the last chunk's x and dh read
        build_x<WF>(xs, feats, vst, ws, P, n, row0, rows, k, c0, Dc);
        __syncthreads();
        forward(w1s, b1s, w2s, xs, zs, nullptr, 0.f, params, P, Dc);
      }
      dh_pass(zs, w2s, od + c0, P, Dc, sb1, sw2);
      __syncthreads();
      dw1_pass(xs, zs, pb, P, Dc);
      feature_grad(w1s, zs, pd + c0 * P.FP, params, P, Dc);
    }
    __syncthreads();

    // 4. feature gradients of the group's rows, in stencil order
    float* dst = dfeats + row0 * k * C;
    for (int e = tid; e < rows * k * C; e += GB) {
      const int rq = e / C, f = e - rq * C;   // rq = r k + kk
      const int r = rq / k, kk = rq - r * k;
      float v = 0.f;
      if (f == F) {
        for (int j = 0; j < 6; ++j) v += ws[(j * rows + r) * k + kk];
      } else if (WF) {
        for (int j = 0; j < 6; ++j)
          v = fmaf(ws[(j * rows + r) * k + kk], pd[(r * 6 + j) * P.FP + f], v);
      } else {
        for (int j = 0; j < 6; ++j) v += pd[((r * 6 + j) * k + kk) * P.FP + f];
      }
      dst[e] = v;
    }
    __syncthreads();                      // the group's staging read
  }

  // 5. the block's partial row (its dW1 is there already)
  block_end(P, sb1, sw2, db2, loss, xs, pb);
}

template <bool WF>
int opt_in() {
  static bool done = false;               // the dynamic shared memory above 48 KB
  if (!done) {
    const int err = (int)cudaFuncSetAttribute(eikonal_tiled_kernel<WF>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              SMEM_ONE * 4);
    if (err) return err;
    done = true;
  }
  return 0;
}

template <bool WF>
int launch(const void* feats, const void* wst, const void* vst, const void* esc,
           const void* params, const Plan& P, int n, int k, int R, float scale, float inv2e,
           void* dfeats, void* partial, int nblocks, cudaStream_t st) {
  const int err = opt_in<WF>();
  if (err) return err;
  eikonal_tiled_kernel<WF><<<nblocks, GB, P.total * 4, st>>>(
      (const float*)feats, (const float*)wst, (const float*)vst, (const float*)esc,
      (const float*)params, P, n, k, R, scale, inv2e, (float*)dfeats, (float*)partial);
  return (int)cudaGetLastError();
}

template <bool WF>
int blocks_per_sm(const Plan& P) {
  int nb = 0;
  int err = opt_in<WF>();
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, eikonal_tiled_kernel<WF>, GB,
                                                             P.total * 4);
  return err ? -err : nb;
}

}  // namespace eit

using namespace eik;

// R base rows per block (R * decodes per row <= 512); partial holds
// ceil(n / R) rows of E
extern "C" int eikonal_launch(const void* feats, const void* wst, const void* vst,
                              const void* esc, const void* params, int n, int k,
                              int weighted_first, int R, float scale, float inv2e,
                              void* dfeats, void* partial, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R < 1 || k < 1 || k > MAXK || R * 6 * (weighted_first ? 1 : k) > DMAX)
    return (int)cudaErrorInvalidValue;
  const int nblocks = (n + R - 1) / R;
  if (nblocks > 0) {
    const int err = weighted_first
        ? launch<true>(feats, wst, vst, esc, params, n, k, R, scale, inv2e, dfeats, partial,
                       nblocks, st)
        : launch<false>(feats, wst, vst, esc, params, n, k, R, scale, inv2e, dfeats, partial,
                        nblocks, st);
    if (err) return err;
  }
  return launch_reduce((const float*)partial, nblocks, (float*)out, st);
}

// the general forms: (nf, nh, vd) = (8, 64, vd <= gen::MAXVD) runs the
// build of vd's width class (groups of R base rows, R * decodes a row <=
// gen::DMAX), any other width the predicate takes the tiled form (R *
// decodes a row <= its plan's DMAX); over at most `grid` blocks (the caller
// passes the blocks the card holds at once); partial holds min(ceil(n / R),
// grid) rows of (nf + vd) nh + 2 nh + 2
extern "C" int eikonal_launch_vd(const void* feats, const void* wst, const void* vst,
                                 const void* esc, const void* params, int n, int k, int nf,
                                 int nh, int vd, int weighted_first, int R, int grid, float scale,
                                 float inv2e, void* dfeats, void* partial, void* out,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int dr = 6 * (weighted_first ? 1 : k);
  if (R < 1 || grid < 1 || k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  const int nblocks = min((n + R - 1) / R, grid);
  if (nf == F && nh == H && gen::width_of(vd) != 0) {
    if (R * dr > gen::DMAX || R * k * C > gen::STAGE) return (int)cudaErrorInvalidValue;
    if (nblocks > 0) {
      const int err = weighted_first
          ? eig::launch_vd<true>(feats, wst, vst, esc, params, n, k, vd, R, scale, inv2e,
                                 dfeats, partial, nblocks, st)
          : eig::launch_vd<false>(feats, wst, vst, esc, params, n, k, vd, R, scale, inv2e,
                                  dfeats, partial, nblocks, st);
      if (err) return err;
    }
  } else {
    const gtl::Plan P = gtl::plan(nf, nh, vd, k, weighted_first, true);
    if (!P.ok || R * dr > P.DMAX) return (int)cudaErrorInvalidValue;
    if (nblocks > 0) {
      const int err = weighted_first
          ? eit::launch<true>(feats, wst, vst, esc, params, P, n, k, R, scale, inv2e, dfeats,
                              partial, nblocks, st)
          : eit::launch<false>(feats, wst, vst, esc, params, P, n, k, R, scale, inv2e, dfeats,
                               partial, nblocks, st);
      if (err) return err;
    }
  }
  return launch_reduce((const float*)partial, nblocks, (float*)out, st,
                       (nf + vd) * nh + 2 * nh + 2);
}

// the tiled form's plan for (nf, nh, vd, k, mode): ok, W1 resident, chunk
// decodes, group decodes, shared-memory floats (ok = 0: none)
extern "C" void eikonal_tiled_plan(int nf, int nh, int vd, int k, int weighted_first,
                                   int* out) {
  const gtl::Plan P = gtl::plan(nf, nh, vd, k, weighted_first, true);
  out[0] = P.ok;
  out[1] = P.res;
  out[2] = P.DC;
  out[3] = P.DMAX;
  out[4] = P.total;
}

// blocks of the tiled form an SM holds at once at that plan's shared memory
extern "C" int eikonal_tiled_blocks_per_sm(int nf, int nh, int vd, int k, int weighted_first) {
  const gtl::Plan P = gtl::plan(nf, nh, vd, k, weighted_first, true);
  if (!P.ok) return -(int)cudaErrorInvalidValue;
  return weighted_first ? eit::blocks_per_sm<true>(P) : eit::blocks_per_sm<false>(P);
}

// blocks of the general form's build for vd an SM holds at once, as its
// registers and its most shared memory allow
extern "C" int eikonal_general_blocks_per_sm(int weighted_first, int vd) {
  return weighted_first ? eig::blocks_per_sm_vd<true>(vd) : eig::blocks_per_sm_vd<false>(vd);
}

#ifdef GEN_STAMPS
// the general form's stamps of the last launch, (gen::STAMP_BLOCKS,
// gen::NSTAMPS) int64, into host dst
extern "C" int eikonal_general_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, gen::stamps, sizeof(gen::stamps));
}
#endif
