// One training iteration's math between the feature gather and the
// gradient scatter (kernel 2 of the port).
//
// Replaces the Pallas kernel `_train_iter_kernel` / `fused_train_iter` in
// pin_slam_tpu/ops/train_kernel.py.  Per batch row: IDW-blend the k gathered
// feature rows then decode once (weighted_first), or decode each neighbour
// and blend the k predictions; BCE-with-logits against sigmoid(label/sigma)
// with the premultiplied row weight; hand-derived backward to the
// per-(row, neighbour) feature gradients (certainty column = w) and the
// decoder gradients.
//
// Bound on an H100: at the main path's B = 16384, k = 6 a launch moves
// ~7.8 MB with weighted_first (read feats, weights, vectors; write dfeats:
// 2.3 us at 3.35 TB/s, bytes-bound) and ~9 MB per neighbour, where its
// 98304 decodes take 4288 float32 operations each (the forward's 11 x 64 + 64
// FMAs and 64 bias adds; dh, 64; the input gradient of the 8 feature columns
// only, 8 x 64 FMAs, as the offset vectors take none; the decoder-gradient
// sums, 11 x 64 + 64 FMAs and 64 adds; the recomputed pre-activations not
// counted) and the blend 2 per (row, neighbour): 0.42 GFLOP, 6.3 us at
// 67 TFLOP/s, operations.
//
// Design: parallel over decodes, not rows.  A decode is one row
// (weighted_first) or one (row, neighbour).  A block of 128 threads owns R
// consecutive rows and all their D = R or R * k decodes.  LANES = 16 lanes
// share a decode, lane l owning the hidden units l, l + 16, l + 32, l + 48;
// the block's 8 lane groups run two decodes each at a time, a pass of 16
// decodes.  A lane keeps its units' W1 columns, b1 and W2 in registers for
// the whole block (52 floats), so no FMA reads the decoder from shared
// memory.  Sixteen lanes of four units, not eight of eight: a lane also keeps
// its units' decoder-gradient sums in registers (52 more floats), and eight
// units a lane would need ~210 registers of state alone.
// Phases, separated by barriers:
//   0. one flat copy stages the block's feature rows, offset vectors and IDW
//      weights in shared memory (32 loads in flight per thread); with
//      weighted_first the blended inputs of every decode are then built
//      once, padded to 12 floats (read as three broadcast float4s); per
//      neighbour a decode reads its 11 inputs from the staged rows;
//   1. forward: each decode's output o, summed over its lanes by xor
//      shuffles, is kept in shared memory;
//   2. one thread per row: the prediction (o, or sum_k w_k o_k), the BCE,
//      the row's loss term and db2 term, each decode's upstream gradient dO
//      (overwriting o) and the certainty column w_k;
//   3. backward: z is recomputed from the registers, then dh and the
//      decode's 8 feature gradients dx, which a reduce-scatter over the 16
//      lanes (xor 8, 4, 2: each step keeps half the values, 7 shuffles;
//      then xor 1) leaves one per lane pair, written to the staged tile
//      (w_k dx for each neighbour with weighted_first); the lane adds
//      dW1[:, j], db1[j] and dW2[j] of its units in registers, decode after
//      decode;
//   4. the rows' feature gradients, one contiguous copy of the tile;
//   5. the two slots of each warp are added by one xor shuffle, the four
//      warps' sums in warp order, the rows' loss and db2 terms by warp 0 in
//      a fixed order; `reduce_partials` (train_common.cuh) then adds the
//      blocks' partial rows in a fixed order.
// No block-wide reduction per decode and no float atomics: every sum has a
// fixed order, so two launches on the same inputs give the same bits.
// Registers: ~165 a thread, no spills (the -Xptxas -v report in
// build/kernels/train_iter.log), so an SM holds three blocks (12 warps).
// The wrapper picks R from B, k, the mode and the card's resident blocks
// (ops/train_kernel.train_rows_per_block): at the main path's shape, R = 42,
// 391 blocks, one wave.  128-thread blocks, not 256: three resident blocks
// hide more latency than one of 256 threads (scripts/kernel_ab.py on the
// H100).  Shared memory depends on R (dynamic; 26 KB at R = 42 per
// neighbour).  The pre-activations are summed in the order of the first port
// of this kernel (z = fma over the 11 inputs in order, then + b1), so the
// float64 checks see the same ReLU masks.  Float32 on the CUDA cores, as the
// port's precision policy asks: the passes are bound by instruction issue
// (FMAs plus the recomputed pre-activations, shuffles and selects); a
// 3xTF32 mma.sync split of the three 11 x 64 products is a later option,
// against the same 6.3 us bound.
//
// Built with -DTRAIN_STAMPS (scripts/train_phases.py), thread 0 of each of
// the first STAMP_BLOCKS blocks reads clock64() at the kernel's start, after
// each phase's barrier and at its end, and train_iter_stamps copies the
// stamps out; without it STAMP is empty.
//
// With positional encoding (VD != 3) the wrapper launches the general form
// below (namespace tig; its design, shared with the eikonal kernel's, is at
// namespace gen in train_common.cuh): at path H's B = 16384, k = 6 per
// neighbour, VD = 27, 0.0454 ms on the device against a 0.0153 ms bound
// (operations; PR 12's first general form 0.189 ms), at pe_gaussian's
// weighted_first VD = 35 0.0188 ms against 0.0031 (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py, scripts/kernel_ab.py).  At any other feature
// width F, hidden width H or VD > 64 it launches the tiled general form
// (namespace tit below, over gtl in train_common.cuh).

#include "train_common.cuh"

using namespace tk;

namespace ti {

#ifdef TRAIN_STAMPS
constexpr int STAMP_BLOCKS = 4096;
constexpr int NSTAMPS = 7;
__device__ long long stamps[STAMP_BLOCKS][NSTAMPS];
#define STAMP(n) \
  if (threadIdx.x == 0 && blockIdx.x < STAMP_BLOCKS) stamps[blockIdx.x][n] = clock64()
#else
#define STAMP(n)
#endif

constexpr int TB = 128;                   // threads per block
constexpr int LANES = 16;                 // lanes per decode
constexpr int SLOTS = TB / LANES;         // lane groups
constexpr int DPT = 2;                    // decodes a lane group runs together
constexpr int PASS = SLOTS * DPT;         // decodes per pass
constexpr int UPL = H / LANES;            // hidden units per lane: LANES * t + lane
constexpr int WARPS = TB / 32;
constexpr int XP = 12;                    // staged input pitch: 11 inputs + a zero
constexpr int DMAX = 1024;                // decodes (and rows x k) per block
constexpr int SB = 32;                    // staging loads in flight per thread
constexpr int RED = IN + 2;               // per-unit sums: dW1[:, j], db1[j], dW2[j]
constexpr unsigned FULL = 0xffffffffu;
static_assert(H % LANES == 0 && 32 % LANES == 0 && LANES >= F, "lane layout");
static_assert(RED * H + 2 == E, "a partial row is the per-unit sums, db2 and the loss");

// dynamic shared memory, in floats, for Dp staged decodes of R rows with
// kd decodes a row: [xs (Dp, XP), weighted_first only | od (Dp)] (then the
// warps' gradient sums) | ts (R, k, C) | vs (R, kd * VD) | ws (R, k) | the
// rows' loss and db2 terms (R each); a block of fewer rows packs ts, vs and
// ws as tightly (one contiguous staging copy)
__host__ __device__ constexpr int head_floats(int Dp, bool wf) {
  return Dp * (wf ? XP + 1 : 1) > WARPS * RED * H ? Dp * (wf ? XP + 1 : 1) : WARPS * RED * H;
}
__host__ __device__ constexpr int smem_floats(int Dp, int R, int k, bool wf) {
  return head_floats(Dp, wf) + R * k * C + R * (wf ? 1 : k) * VD + R * k + 2 * R;
}
// the most any launch takes: R * k <= DMAX, R <= DMAX
constexpr int SMEM_MAX = head_floats(DMAX, true) + DMAX * (C + VD + 1 + 2);

__device__ inline void bce(float pred, float label, float wt, float inv_sigma, float& pw,
                           float& dpred) {
  const float z = pred * inv_sigma;
  const float tgt = 1.f / (1.f + expf(-label * inv_sigma));
  const float per = fmaxf(z, 0.f) - z * tgt + log1pf(expf(-fabsf(z)));
  const float sz = 1.f / (1.f + expf(-z));
  pw = per * wt;
  dpred = (sz - tgt) * wt * inv_sigma;
}

// decode d's inputs: weighted_first from xs (pitch XP, three broadcast
// float4s), per neighbour from the staged feature rows and vectors (zeros
// past the block's decodes)
template <bool WF>
__device__ __forceinline__ void load_x(const float* xs, const float* ts, const float* vs, int d,
                                       bool act, float (&x)[XP]) {
  if (WF) {
    const float4* p = reinterpret_cast<const float4*>(xs + d * XP);
#pragma unroll
    for (int q = 0; q < XP / 4; ++q) {
      const float4 v = p[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < F; ++i) x[i] = act ? ts[d * C + i] : 0.f;
#pragma unroll
    for (int i = 0; i < VD; ++i) x[F + i] = act ? vs[d * VD + i] : 0.f;
    x[IN] = 0.f;
  }
}

// pre-activation of the lane's unit t: the inputs in order, then the bias
__device__ __forceinline__ float preact(const float (&x)[XP], const float (&w1)[IN][UPL],
                                        const float (&b1)[UPL], int t) {
  float z = 0.f;
#pragma unroll
  for (int i = 0; i < IN; ++i) z = fmaf(x[i], w1[i][t], z);
  return z + b1[t];
}

// Sums v[0..W) over the decode's lanes in a fixed order.  While W > 1 each
// xor step M keeps half the values (the upper half where lane bit M is set)
// and adds the partner's copy of them; once one value is left, the remaining
// steps add whole sums (a + b on one lane, b + a on its partner: the same
// bits).  Returns the feature index of v[0].
template <int M, int W>
__device__ __forceinline__ int reduce_scatter(float (&v)[F], int lane, int base) {
  if constexpr (M == 0) {
    return base;
  } else if constexpr (W > 1) {
    constexpr int HW = W / 2;
    const bool hi = (lane & M) != 0;
#pragma unroll
    for (int i = 0; i < HW; ++i) {
      const float send = hi ? v[i] : v[i + HW];
      const float keep = hi ? v[i + HW] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, M);
    }
    return reduce_scatter<M / 2, HW>(v, lane, hi ? base + HW : base);
  } else {
    v[0] += __shfl_xor_sync(FULL, v[0], M);
    return reduce_scatter<M / 2, 1>(v, lane, base);
  }
}

// the warp's slots added: xor LANES, 2 LANES, ... (one step at 16 lanes)
__device__ __forceinline__ float slot_sum(float a) {
#pragma unroll
  for (int m = LANES; m < 32; m <<= 1) a += __shfl_xor_sync(FULL, a, m);
  return a;
}

template <bool WF>
__global__ void __launch_bounds__(TB) train_iter_kernel(
    const float* __restrict__ feats, const float* __restrict__ w,
    const float* __restrict__ vin, const float* __restrict__ label,
    const float* __restrict__ wt, const float* __restrict__ params, int B, int k, int R,
    float scale, float inv_sigma, float* __restrict__ dfeats, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int kd = WF ? 1 : k;              // decodes per row
  const int Dp = (R * kd + PASS - 1) / PASS * PASS;
  float* xs = sm;                         // weighted_first: (Dp, XP) inputs
  float* od = xs + (WF ? Dp * XP : 0);    // (Dp,) outputs, then dO
  float* red = sm;                        // (WARPS, RED, H) after the backward pass
  const int tid = threadIdx.x;
  STAMP(0);
  const long row0 = (long)blockIdx.x * R;
  const int rows = (int)min((long)R, (long)B - row0);
  float* ts = sm + head_floats(Dp, WF);   // (rows, k, C) feature rows, then their gradients
  float* vs = ts + rows * k * C;          // (rows, kd * VD) offset vectors
  float* ws = vs + rows * kd * VD;        // (rows, k) IDW weights
  float* pwr = ws + rows * k;             // (rows,) loss terms
  float* pdb = pwr + rows;                // (rows,) db2 terms
  const int Dv = rows * kd;               // the block's decodes
  const int s = tid / LANES, lane = tid % LANES;

  float w1[IN][UPL], b1[UPL], w2[UPL];
#pragma unroll
  for (int t = 0; t < UPL; ++t) {
    const int j = LANES * t + lane;
#pragma unroll
    for (int i = 0; i < IN; ++i) w1[i][t] = params[i * H + j];
    b1[t] = params[IN * H + j];
    w2[t] = params[IN * H + H + j];
  }
  const float b2 = params[IN * H + 2 * H];

  // 0. the rows' feature rows, offset vectors and weights, copied flat (SB
  // loads in flight per thread); weighted_first then blends every decode's
  // inputs into xs (zeros past Dv)
  {
    const int n1 = rows * k * C, n2 = n1 + rows * kd * VD, n3 = n2 + rows * k;
    const float* f0 = feats + row0 * k * C;
    const float* v0 = vin + row0 * kd * VD;
    const float* w0 = w + row0 * k;
    for (int e0 = tid; e0 < n3; e0 += SB * TB) {
      float v[SB];
#pragma unroll
      for (int m = 0; m < SB; ++m) {
        const int e = e0 + m * TB;
        v[m] = e < n1 ? f0[e] : (e < n2 ? v0[e - n1] : (e < n3 ? w0[e - n2] : 0.f));
      }
#pragma unroll
      for (int m = 0; m < SB; ++m)        // ts, vs and ws are contiguous
        if (e0 + m * TB < n3) ts[e0 + m * TB] = v[m];
    }
  }
  __syncthreads();
  STAMP(1);
  if (WF) {                               // the blended inputs, in xs
#pragma unroll 4
    for (int e = tid; e < Dp * XP; e += TB) {
      const int d = e / XP, i = e - d * XP;
      float v = 0.f;
      if (d < Dv && i < F) {
        const float* fr = ts + d * k * C + i;
        const float* wr = ws + d * k;
#pragma unroll
        for (int q = 0; q < MAXK; ++q)
          if (q < k) v = fmaf(wr[q], fr[q * C], v);
      } else if (d < Dv && i < IN) {
        v = vs[d * VD + (i - F)];
      }
      xs[e] = v;
    }
    __syncthreads();
  }

  // a slot's DPT decodes of pass c
  const int npass = (Dv + PASS - 1) / PASS;
  auto dec = [&](int c, int u) { return (c * DPT + u) * SLOTS + s; };

  // 1. forward
#pragma unroll 1
  for (int c = 0; c < npass; ++c) {
    float x[DPT][XP], o[DPT];
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      load_x<WF>(xs, ts, vs, dec(c, u), dec(c, u) < Dv, x[u]);
      o[u] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < UPL; ++t)
#pragma unroll
      for (int u = 0; u < DPT; ++u)
        o[u] = fmaf(fmaxf(preact(x[u], w1, b1, t), 0.f), w2[t], o[u]);
#pragma unroll
    for (int m = LANES / 2; m >= 1; m >>= 1)
#pragma unroll
      for (int u = 0; u < DPT; ++u) o[u] += __shfl_xor_sync(FULL, o[u], m);
#pragma unroll
    for (int u = 0; u < DPT; ++u)
      if (lane == 0 && dec(c, u) < Dv) od[dec(c, u)] = o[u] + b2;
  }
  __syncthreads();
  STAMP(2);

  // 2. per row: the loss term, the db2 term, each decode's dO and the
  // certainty column of the row's feature gradients
  for (int r = tid; r < rows; r += TB) {
    const float* wr = ws + r * k;
    float* o = od + r * kd;
    float pred = 0.f;
    if (WF)
      pred = o[0];
    else
      for (int q = 0; q < k; ++q) pred = fmaf(wr[q], o[q], pred);
    float pw, dpred;
    bce(pred * scale, label[row0 + r], wt[row0 + r], inv_sigma, pw, dpred);
    const float g = dpred * scale;
    pwr[r] = pw;
    if (WF) {
      o[0] = g;
      pdb[r] = g;
    } else {
      float a = 0.f;
      for (int q = 0; q < k; ++q) {
        const float dO = g * wr[q];
        o[q] = dO;
        a += dO;
      }
      pdb[r] = a;
    }
    for (int q = 0; q < k; ++q) ts[(r * k + q) * C + F] = wr[q];
  }
  __syncthreads();
  STAMP(3);

  // 3. backward; the lane's decoder-gradient sums stay in registers, the
  // feature gradients go to ts
  float aw1[IN][UPL], ab1[UPL], aw2[UPL];
#pragma unroll
  for (int t = 0; t < UPL; ++t) {
#pragma unroll
    for (int i = 0; i < IN; ++i) aw1[i][t] = 0.f;
    ab1[t] = 0.f;
    aw2[t] = 0.f;
  }
#pragma unroll 1
  for (int c = 0; c < npass; ++c) {
    float x[DPT][XP], dx[DPT][F], dO[DPT];
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      const int d = dec(c, u);
      dO[u] = d < Dv ? od[d] : 0.f;       // past Dv: x = 0 and dO = 0 add nothing
      load_x<WF>(xs, ts, vs, d, d < Dv, x[u]);
#pragma unroll
      for (int f = 0; f < F; ++f) dx[u][f] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < UPL; ++t) {
#pragma unroll
      for (int u = 0; u < DPT; ++u) {
        const float z = preact(x[u], w1, b1, t);
        const float dh = z > 0.f ? dO[u] * w2[t] : 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) dx[u][f] = fmaf(dh, w1[f][t], dx[u][f]);
#pragma unroll
        for (int i = 0; i < IN; ++i) aw1[i][t] = fmaf(x[u][i], dh, aw1[i][t]);
        ab1[t] += dh;
        aw2[t] = fmaf(dO[u], fmaxf(z, 0.f), aw2[t]);
      }
    }
    int f[DPT];
#pragma unroll
    for (int u = 0; u < DPT; ++u) f[u] = reduce_scatter<LANES / 2, F>(dx[u], lane, 0);
#pragma unroll
    for (int u = 0; u < DPT; ++u) {
      const int d = dec(c, u);
      if (d < Dv && lane % (LANES / F) == 0) {
        if (WF)
          for (int q = 0; q < k; ++q) ts[(d * k + q) * C + f[u]] = ws[d * k + q] * dx[u][0];
        else
          ts[d * C + f[u]] = dx[u][0];
      }
    }
  }
  __syncthreads();                        // xs and od are free: red reuses them
  STAMP(4);

  // 4. the rows' feature gradients, one contiguous copy
  float* dst = dfeats + row0 * k * C;
  for (int e = tid; e < rows * k * C; e += TB) dst[e] = ts[e];

  // 5. each warp's sums staged per hidden unit (the warp's slots added by
  // xor shuffles), then added in warp order; the rows' terms by warp 0
  const int warp = tid / 32;
#pragma unroll
  for (int t = 0; t < UPL; ++t) {
    const int j = LANES * t + lane;
    float* rw = red + warp * RED * H + j;
#pragma unroll
    for (int i = 0; i < IN; ++i) {
      const float a = slot_sum(aw1[i][t]);
      if (tid % 32 < LANES) rw[i * H] = a;
    }
    const float a1 = slot_sum(ab1[t]), a2 = slot_sum(aw2[t]);
    if (tid % 32 < LANES) {
      rw[IN * H] = a1;
      rw[(IN + 1) * H] = a2;
    }
  }
  __syncthreads();
  STAMP(5);
  float* pb = partial + (long)blockIdx.x * E;
  for (int e = tid; e < RED * H; e += TB) {
    float a = red[e];
#pragma unroll
    for (int g = 1; g < WARPS; ++g) a += red[g * RED * H + e];
    pb[e] = a;
  }
  if (tid < 32) {
    float l = 0.f, g = 0.f;
    for (int r = tid; r < rows; r += 32) {
      l += pwr[r];
      g += pdb[r];
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      l += __shfl_xor_sync(FULL, l, m);
      g += __shfl_xor_sync(FULL, g, m);
    }
    if (tid == 0) {
      pb[IN * H + 2 * H] = g;
      pb[E - 1] = l;
    }
  }
#ifdef TRAIN_STAMPS
  __syncthreads();
  STAMP(6);
#endif
}

template <bool WF>
int launch(const void* feats, const void* w, const void* vin, const void* label,
           const void* wt, const void* params, int B, int k, int R, float scale,
           float inv_sigma, void* dfeats, void* partial, int nblocks, cudaStream_t st) {
  static bool opted_in = false;           // the dynamic shared memory above 48 KB
  if (!opted_in) {
    const int err = (int)cudaFuncSetAttribute(train_iter_kernel<WF>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              SMEM_MAX * 4);
    if (err) return err;
    opted_in = true;
  }
  const int kd = WF ? 1 : k;
  const int Dp = (R * kd + PASS - 1) / PASS * PASS;
  train_iter_kernel<WF><<<nblocks, TB, smem_floats(Dp, R, k, WF) * 4, st>>>(
      (const float*)feats, (const float*)w, (const float*)vin, (const float*)label,
      (const float*)wt, (const float*)params, B, k, R, scale, inv_sigma, (float*)dfeats,
      (float*)partial);
  return (int)cudaGetLastError();
}

}  // namespace ti

namespace tig {

using namespace gen;

// The general form for VD != 3 (positional encoding; gen:: in
// train_common.cuh), built for the padded input width IP.  The rows come in
// groups of R (D = R with weighted_first, else R k decodes); block b takes
// groups b, b + gridDim.x, ... in turn, with the decoder loaded once and its
// decoder-gradient sums kept in registers across its groups, so the grid is at
// most the blocks the card holds at once and the block partials number no
// more.  Per group:
//   0. one flat copy each (cp.async, all in flight at once) of the rows' IDW
//      weights, labels and loss weights, feature rows (into the scratch with
//      weighted_first, else straight into x) and offset vectors (into x);
//      then, with weighted_first, each decode's blended features (fma over
//      the neighbours in order, as the VD = 3 kernel) from the staged rows;
//   1. forward, tile by tile: z, o and P (gen::forward_tile);
//   2. one thread a row: prediction, BCE, the loss term, each decode's dO;
//   3. backward: the group's decodes added to the sums, dh in place of z with
//      db1, dW2, db2 (gen::dh_pass), then dW1 (gen::backward);
//   4. the rows' feature gradients, dx = dO P (w_k dx with weighted_first),
//      the certainty column w.
// Then the block's partial row (gen::store_partial).
template <int IP, bool WF>
__global__ void __launch_bounds__(GB, 2) train_iter_general_kernel(
    const float* __restrict__ feats, const float* __restrict__ w,
    const float* __restrict__ vin, const float* __restrict__ label,
    const float* __restrict__ wt, const float* __restrict__ params, int B, int k, int vd,
    int R, float scale, float inv_sigma, float* __restrict__ dfeats,
    float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int XP = Cls<IP>::XP;
  const int in = F + vd, kd = WF ? 1 : k;
  const Lay L = layout<IP>(R * kd, WF ? R * k * C : 0, R * k, R);
  float *xs = sm + L.xs, *zs = sm + L.zs, *od = sm + L.od, *pd = sm + L.pd;
  float *ws = sm + L.ws, *pwr = sm + L.pwr, *lab = sm + L.ra, *lwt = sm + L.rb;
  const int tid = threadIdx.x;
  const int ngroups = (B + R - 1) / R;
  const float rv = 1.f / vd, rk = 1.f / k;
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
    const int rows = (int)min((long)R, (long)B - row0);
    const int Dv = rows * kd, Dp = (Dv + TILE - 1) / TILE * TILE;

    // 0. staging
    {
      const float* w0 = w + row0 * k;
      for (int e = tid; e < rows * k; e += GB) cp4(ws + e, w0 + e);
      for (int e = tid; e < rows; e += GB) {
        cp4(lab + e, label + row0 + e);
        cp4(lwt + e, wt + row0 + e);
      }
      const float* f0 = feats + row0 * k * C;
      for (int e = tid; e < rows * k * C; e += GB) {
        if (WF) {
          cp4(zs + e, f0 + e);
        } else {
          const int d = e / C, c = e - d * C;
          if (c < F) cp4(xs + d * XP + c, f0 + e);
        }
      }
      const float* v0 = vin + row0 * kd * vd;
      for (int e = tid; e < Dv * vd; e += GB) {
        const int d = fdiv(e, rv);
        cp4(xs + d * XP + F + e - d * vd, v0 + e);
      }
      cp_wait();
    }
    __syncthreads();
    if (WF) {
      for (int e = tid; e < Dv * F; e += GB) {
        const int d = e / F, f = e - d * F;
        float v = 0.f;
        for (int q = 0; q < k; ++q) v = fmaf(ws[d * k + q], zs[(d * k + q) * C + f], v);
        xs[d * XP + f] = v;
      }
      __syncthreads();
    }
    GEN_STAMP(0);

    // 1. forward
    for (int t = 0; t < Dp / TILE; ++t) forward_tile<IP>(sm, xs, zs, od, pd, t, Dv, b2);
    __syncthreads();
    GEN_STAMP(1);

    // 2. per row: the loss term and each decode's dO
    for (int r = tid; r < rows; r += GB) {
      const float* wr = ws + r * k;
      float* o = od + r * kd;
      float pred = 0.f;
      if (WF)
        pred = o[0];
      else
        for (int q = 0; q < k; ++q) pred = fmaf(wr[q], o[q], pred);
      float pw, dpred;
      ti::bce(pred * scale, lab[r], lwt[r], inv_sigma, pw, dpred);
      const float g = dpred * scale;
      pwr[r] = pw;
      if (WF)
        o[0] = g;
      else
        for (int q = 0; q < k; ++q) o[q] = g * wr[q];
    }
    __syncthreads();
    GEN_STAMP(2);

    // 3. backward: the dh pass, then dW1
    loss_add(loss, pwr, rows);
    dh_pass<IP>(sm, zs, od, Dv, a);
    __syncthreads();
    backward<IP>(xs, zs, Dv, a);
    GEN_STAMP(3);

    // 4. the rows' feature gradients; the certainty column is w
    float* dst = dfeats + row0 * k * C;
    for (int e = tid; e < rows * k * C; e += GB) {
      const int rq = e / C, f = e - rq * C;   // rq = r k + q
      const float wq = ws[rq];
      float v;
      if (f == F) {
        v = wq;
      } else if (WF) {
        const int r = fdiv(rq, rk);
        v = wq * (od[r] * pd[r * F + f]);
      } else {
        v = od[rq] * pd[rq * F + f];
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
    const int err = (int)cudaFuncSetAttribute(train_iter_general_kernel<IP, WF>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              max_smem_floats<IP>() * 4);
    if (err) return err;
    done = true;
  }
  return 0;
}

template <int IP, bool WF>
int launch_general(const void* feats, const void* w, const void* vin, const void* label,
                   const void* wt, const void* params, int B, int k, int vd, int R,
                   float scale, float inv_sigma, void* dfeats, void* partial, int nblocks,
                   cudaStream_t st) {
  const int err = opt_in<IP, WF>();
  if (err) return err;
  const Lay L = layout<IP>(R * (WF ? 1 : k), WF ? R * k * C : 0, R * k, R);
  train_iter_general_kernel<IP, WF><<<nblocks, GB, L.total * 4, st>>>(
      (const float*)feats, (const float*)w, (const float*)vin, (const float*)label,
      (const float*)wt, (const float*)params, B, k, vd, R, scale, inv_sigma, (float*)dfeats,
      (float*)partial);
  return (int)cudaGetLastError();
}

template <int IP, bool WF>
int blocks_per_sm() {
  int n = 0;
  int err = opt_in<IP, WF>();
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, train_iter_general_kernel<IP, WF>, GB, max_smem_floats<IP>() * 4);
  return err ? -err : n;
}

template <bool WF>
int launch_vd(const void* feats, const void* w, const void* vin, const void* label,
              const void* wt, const void* params, int B, int k, int vd, int R, float scale,
              float inv_sigma, void* dfeats, void* partial, int nblocks, cudaStream_t st) {
  GEN_DISPATCH(launch_general, feats, w, vin, label, wt, params, B, k, vd, R, scale,
               inv_sigma, dfeats, partial, nblocks, st)
}

template <bool WF>
int blocks_per_sm_vd(int vd) {
  GEN_DISPATCH(blocks_per_sm)
}

}  // namespace tig

// The tiled general form (gtl in train_common.cuh): any F, H and VD the
// wrappers' predicate takes outside the width classes.  Per group of R rows:
//   0. the rows' IDW weights, labels and loss weights (cp.async);
//   1. chunk by chunk: x (the blended features with weighted_first, fma
//      over the neighbours in order from global memory; else the
//      neighbour's row; then the offset vector: copies by cp.async, every
//      element its own, so rows of any width stay exact), z
//      (gtl::forward), o;
//   2. one thread a row: prediction, BCE, the loss term, each decode's dO;
//      warp 0 adds the loss and db2 terms;
//   3. chunk by chunk (x and z staged again when the group has several):
//      dh with db1 / dW2, dW1 into the block's partial row, dX into pd;
//   4. the rows' feature gradients (w_k dX with weighted_first), the
//      certainty column w.
namespace tit {

using namespace gtl;

template <bool WF>
__device__ __forceinline__ void build_x(float* xs, const float* __restrict__ feats,
                                        const float* __restrict__ vin, const float* ws,
                                        const Plan& P, long row0, int k, int c0, int Dc) {
  const int in = P.in, F = P.F, C = P.C, vd = P.vd;
  const float rin = 1.f / in;
  for (int e = threadIdx.x; e < Dc * in; e += GB) {
    const int dd = gen::fdiv(e, rin), i = e - dd * in, d = c0 + dd;
    float* dst = xs + dd * P.XP + i;
    if (i >= F) {
      cp4(dst, vin + (row0 * (WF ? 1 : k) + d) * vd + (i - F));
    } else if (WF) {
      const float* fr = feats + ((row0 + d) * k) * C + i;
      const float* wr = ws + d * k;
      float v = 0.f;
#pragma unroll 4
      for (int q = 0; q < k; ++q) v = fmaf(wr[q], __ldg(fr + q * C), v);
      *dst = v;
    } else {
      cp4(dst, feats + (row0 * k + d) * C + i);
    }
  }
  cp_wait();
}

template <bool WF>
__global__ void __launch_bounds__(GB, 2) train_iter_tiled_kernel(
    const float* __restrict__ feats, const float* __restrict__ w,
    const float* __restrict__ vin, const float* __restrict__ label,
    const float* __restrict__ wt, const float* __restrict__ params,
    const __grid_constant__ Plan P, int B, int k, int R, float scale, float inv_sigma,
    float* __restrict__ dfeats, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *w1s = sm + P.w1, *b1s = sm + P.b1, *w2s = sm + P.w2, *xs = sm + P.xs, *zs = sm + P.zs;
  float *od = sm + P.od, *pd = sm + P.pd, *ws = sm + P.ws, *pwr = sm + P.pwr;
  float *lab = sm + P.ra, *lwt = sm + P.rb;
  const int tid = threadIdx.x, kd = WF ? 1 : k, F = P.F, C = P.C;
  const int ngroups = (B + R - 1) / R;
  float* pb = partial + (long)blockIdx.x * (P.in * P.H + 2 * P.H + 2);
  block_start(sm, params, P, pb);
  const float b2 = params[P.in * P.H + 2 * P.H];
  float sb1 = 0.f, sw2 = 0.f, db2 = 0.f, loss = 0.f;

  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const long row0 = (long)grp * R;
    const int rows = (int)min((long)R, (long)B - row0);
    const int Dv = rows * kd, nch = (Dv + P.DC - 1) / P.DC;

    // 0. staging
    for (int e = tid; e < rows * k; e += GB) cp4(ws + e, w + row0 * k + e);
    for (int e = tid; e < rows; e += GB) {
      cp4(lab + e, label + row0 + e);
      cp4(lwt + e, wt + row0 + e);
    }
    cp_wait();
    __syncthreads();

    // 1. forward, chunk by chunk
    for (int c = 0; c < nch; ++c) {
      const int c0 = c * P.DC, Dc = min(P.DC, Dv - c0);
      build_x<WF>(xs, feats, vin, ws, P, row0, k, c0, Dc);
      __syncthreads();
      forward(w1s, b1s, w2s, xs, zs, od + c0, b2, params, P, Dc);
    }

    // 2. per row: the loss term and each decode's dO
    for (int r = tid; r < rows; r += GB) {
      const float* wr = ws + r * k;
      float* o = od + r * kd;
      float pred = 0.f;
      if (WF)
        pred = o[0];
      else
        for (int q = 0; q < k; ++q) pred = fmaf(wr[q], o[q], pred);
      float pw, dpred;
      ti::bce(pred * scale, lab[r], lwt[r], inv_sigma, pw, dpred);
      const float g = dpred * scale;
      pwr[r] = pw;
      if (WF)
        o[0] = g;
      else
        for (int q = 0; q < k; ++q) o[q] = g * wr[q];
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
        build_x<WF>(xs, feats, vin, ws, P, row0, k, c0, Dc);
        __syncthreads();
        forward(w1s, b1s, w2s, xs, zs, nullptr, 0.f, params, P, Dc);
      }
      dh_pass(zs, w2s, od + c0, P, Dc, sb1, sw2);
      __syncthreads();
      dw1_pass(xs, zs, pb, P, Dc);
      feature_grad(w1s, zs, pd + c0 * P.FP, params, P, Dc);
    }
    __syncthreads();

    // 4. the rows' feature gradients; the certainty column is w
    float* dst = dfeats + row0 * k * C;
    for (int e = tid; e < rows * k * C; e += GB) {
      const int rq = e / C, f = e - rq * C;   // rq = r k + q
      const float wq = ws[rq];
      float v;
      if (f == F)
        v = wq;
      else if (WF)
        v = wq * pd[(rq / k) * P.FP + f];
      else
        v = pd[rq * P.FP + f];
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
    const int err = (int)cudaFuncSetAttribute(train_iter_tiled_kernel<WF>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              SMEM_ONE * 4);
    if (err) return err;
    done = true;
  }
  return 0;
}

template <bool WF>
int launch(const void* feats, const void* w, const void* vin, const void* label,
           const void* wt, const void* params, const Plan& P, int B, int k, int R, float scale,
           float inv_sigma, void* dfeats, void* partial, int nblocks, cudaStream_t st) {
  const int err = opt_in<WF>();
  if (err) return err;
  train_iter_tiled_kernel<WF><<<nblocks, GB, P.total * 4, st>>>(
      (const float*)feats, (const float*)w, (const float*)vin, (const float*)label,
      (const float*)wt, (const float*)params, P, B, k, R, scale, inv_sigma, (float*)dfeats,
      (float*)partial);
  return (int)cudaGetLastError();
}

template <bool WF>
int blocks_per_sm(const Plan& P) {
  int n = 0;
  int err = opt_in<WF>();
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, train_iter_tiled_kernel<WF>,
                                                             GB, P.total * 4);
  return err ? -err : n;
}

}  // namespace tit

using namespace ti;

// R rows per block (R * k <= DMAX); partial holds ceil(B / R) rows of E.
// B = 0 launches nothing (the caller zero-fills out).
extern "C" int train_iter_launch(const void* feats, const void* w, const void* vin,
                                 const void* label, const void* wt, const void* params,
                                 int B, int k, int weighted_first, int R, float scale,
                                 float inv_sigma, void* dfeats, void* partial, void* out,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R < 1 || k < 1 || k > MAXK || R * k > DMAX || B < 0)
    return (int)cudaErrorInvalidValue;
  const int nblocks = (B + R - 1) / R;
  if (nblocks == 0) return (int)cudaGetLastError();
  const int err = weighted_first
      ? launch<true>(feats, w, vin, label, wt, params, B, k, R, scale, inv_sigma, dfeats,
                     partial, nblocks, st)
      : launch<false>(feats, w, vin, label, wt, params, B, k, R, scale, inv_sigma, dfeats,
                      partial, nblocks, st);
  if (err) return err;
  return launch_reduce((const float*)partial, nblocks, (float*)out, st);
}

// the general forms: (nf, nh, vd) = (8, 64, vd <= MAXVD) runs the build of
// vd's width class (groups of R rows: R * k <= gen::DMAX for per-neighbour
// decoding; R <= gen::DMAX and R * k * C <= gen::STAGE with weighted_first),
// any other width the predicate takes the tiled form (R * decodes a row <=
// its plan's DMAX); over at most `grid` blocks (the caller passes the blocks
// the card holds at once); partial holds min(ceil(B / R), grid) rows of
// (nf + vd) nh + 2 nh + 2
extern "C" int train_iter_launch_vd(const void* feats, const void* w, const void* vin,
                                    const void* label, const void* wt, const void* params,
                                    int B, int k, int nf, int nh, int vd, int weighted_first,
                                    int R, int grid, float scale, float inv_sigma, void* dfeats,
                                    void* partial, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int kd = weighted_first ? 1 : k;
  if (R < 1 || grid < 1 || k < 1 || k > MAXK || B < 0) return (int)cudaErrorInvalidValue;
  const int nblocks = min((B + R - 1) / R, grid);
  int err;
  if (nf == F && nh == H && gen::width_of(vd) != 0) {
    if (R * kd > gen::DMAX || (weighted_first && R * k * C > gen::STAGE))
      return (int)cudaErrorInvalidValue;
    if (nblocks == 0) return (int)cudaGetLastError();
    err = weighted_first
        ? tig::launch_vd<true>(feats, w, vin, label, wt, params, B, k, vd, R, scale, inv_sigma,
                               dfeats, partial, nblocks, st)
        : tig::launch_vd<false>(feats, w, vin, label, wt, params, B, k, vd, R, scale,
                                inv_sigma, dfeats, partial, nblocks, st);
  } else {
    const gtl::Plan P = gtl::plan(nf, nh, vd, k, weighted_first, false);
    if (!P.ok || R * kd > P.DMAX) return (int)cudaErrorInvalidValue;
    if (nblocks == 0) return (int)cudaGetLastError();
    err = weighted_first
        ? tit::launch<true>(feats, w, vin, label, wt, params, P, B, k, R, scale, inv_sigma,
                            dfeats, partial, nblocks, st)
        : tit::launch<false>(feats, w, vin, label, wt, params, P, B, k, R, scale, inv_sigma,
                             dfeats, partial, nblocks, st);
  }
  if (err) return err;
  return launch_reduce((const float*)partial, nblocks, (float*)out, st,
                       (nf + vd) * nh + 2 * nh + 2);
}

// the tiled form's plan for (nf, nh, vd, k, mode): ok, W1 resident, chunk
// decodes, group decodes, shared-memory floats (ok = 0: none)
extern "C" void train_iter_tiled_plan(int nf, int nh, int vd, int k, int weighted_first,
                                      int* out) {
  const gtl::Plan P = gtl::plan(nf, nh, vd, k, weighted_first, false);
  out[0] = P.ok;
  out[1] = P.res;
  out[2] = P.DC;
  out[3] = P.DMAX;
  out[4] = P.total;
}

// blocks of the tiled form an SM holds at once at that plan's shared memory
extern "C" int train_iter_tiled_blocks_per_sm(int nf, int nh, int vd, int k,
                                              int weighted_first) {
  const gtl::Plan P = gtl::plan(nf, nh, vd, k, weighted_first, false);
  if (!P.ok) return -(int)cudaErrorInvalidValue;
  return weighted_first ? tit::blocks_per_sm<true>(P) : tit::blocks_per_sm<false>(P);
}

// the general form's block geometry: threads, decodes per forward tile,
// decodes per block, staging floats, widest offset vector
extern "C" void train_iter_general_geometry(int* out) {
  out[0] = gen::GB;
  out[1] = gen::TILE;
  out[2] = gen::DMAX;
  out[3] = gen::STAGE;
  out[4] = gen::MAXVD;
}

// the padded input width of the general form's build for vd (0: none)
extern "C" int train_iter_general_width(int vd) { return gen::width_of(vd); }

// blocks of the general form's build for vd an SM holds at once, as its
// registers and its most shared memory allow
extern "C" int train_iter_general_blocks_per_sm(int weighted_first, int vd) {
  return weighted_first ? tig::blocks_per_sm_vd<true>(vd) : tig::blocks_per_sm_vd<false>(vd);
}

// blocks of the kernel an SM holds at once, as its registers allow
extern "C" int train_iter_blocks_per_sm(int weighted_first) {
  int n = 0;
  const int err = weighted_first
      ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, train_iter_kernel<true>, TB, 0)
      : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, train_iter_kernel<false>, TB, 0);
  return err ? -err : n;
}

// the block geometry the wrapper's choice of R assumes: threads per block,
// decodes per pass, the most decodes (and rows x k) a block takes
extern "C" void train_iter_geometry(int* out) {
  out[0] = TB;
  out[1] = PASS;
  out[2] = DMAX;
}

#ifdef TRAIN_STAMPS
// the stamps of the last launch, (STAMP_BLOCKS, NSTAMPS) int64, into host dst
extern "C" int train_iter_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, stamps, sizeof(stamps));
}
#endif

#ifdef GEN_STAMPS
// the general form's stamps of the last launch, (gen::STAMP_BLOCKS,
// gen::NSTAMPS) int64, into host dst
extern "C" int train_iter_general_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, gen::stamps, sizeof(gen::stamps));
}
#endif
