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
// Bound on an H100: at n = 1638 base rows the launch moves well under 1 MB
// and does ~6-40 MFLOP: launch- and latency-bound, and with one thread per
// row it fills only 26 blocks of the 132 SMs.  Design: the train kernel's
// structure (train_common.cuh) with the six stencils in a loop; stencil
// activations are recomputed in the backward pass instead of saved (the
// Pallas kernel's saved activations and its tile-count sizing for scoped
// VMEM are TPU workarounds and are not ported).  Decoder gradients by the
// same fixed-order two-pass reduction, no atomics.

#include "train_common.cuh"

using namespace tk;

template <bool WF>
__global__ void __launch_bounds__(BLK) eikonal_kernel(
    const float* __restrict__ feats, const float* __restrict__ wst,
    const float* __restrict__ vst, const float* __restrict__ esc,
    const float* __restrict__ params, int n, int k, float scale, float inv2e,
    float* __restrict__ dfeats, float* __restrict__ partial) {
  __shared__ Smem s;
  load_params(s, params);
  const long row = (long)blockIdx.x * BLK + threadIdx.x;
  const bool act = row < n;
  float acc[NE];
#pragma unroll
  for (int m = 0; m < NE; ++m) acc[m] = 0.f;
  const float* fr = feats + row * k * C;
  const int vcols = WF ? VD : k * VD;
  float x[IN], dx[IN];

  // stencil j's input for neighbour kk (WF: the blended row, kk unused)
  auto build_x = [&](int j, int kk) {
    const long sr = (long)j * n + row;
    if (WF) {
      const float* wj = wst + sr * k;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float a = 0.f;
        if (act)
          for (int q = 0; q < k; ++q) a = fmaf(wj[q], fr[q * C + f], a);
        x[f] = a;
      }
#pragma unroll
      for (int v = 0; v < VD; ++v) x[F + v] = act ? vst[sr * vcols + v] : 0.f;
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) x[f] = act ? fr[kk * C + f] : 0.f;
#pragma unroll
      for (int v = 0; v < VD; ++v) x[F + v] = act ? vst[sr * vcols + kk * VD + v] : 0.f;
    }
  };
  auto wgt = [&](int j, int kk) { return act ? wst[((long)j * n + row) * k + kk] : 0.f; };

  float sdf[6];
  for (int j = 0; j < 6; ++j) {
    if (WF) {
      build_x(j, 0);
      sdf[j] = mlp_fwd(s, x) * scale;
    } else {
      float p = 0.f;
      for (int kk = 0; kk < k; ++kk) {
        build_x(j, kk);
        p = fmaf(wgt(j, kk), mlp_fwd(s, x), p);
      }
      sdf[j] = p * scale;
    }
  }
  const float e = act ? esc[row] : 0.f;
  const float gx = (sdf[0] - sdf[3]) * inv2e;
  const float gy = (sdf[1] - sdf[4]) * inv2e;
  const float gz = (sdf[2] - sdf[5]) * inv2e;
  const float nrm = sqrtf(gx * gx + gy * gy + gz * gz + 1e-12f);
  const float pw = (nrm - 1.f) * (nrm - 1.f) * e;
  const float dg = 2.f * (nrm - 1.f) * e / nrm * inv2e;
  const float dsdf[6] = {dg * gx, dg * gy, dg * gz, -dg * gx, -dg * gy, -dg * gz};

  if (act) {
    for (int kk = 0; kk < k; ++kk) {
      float* d = dfeats + (row * k + kk) * C;
      float ws = 0.f;
      for (int j = 0; j < 6; ++j) ws += wgt(j, kk);
#pragma unroll
      for (int f = 0; f < F; ++f) d[f] = 0.f;
      d[F] = ws;
    }
  }
  for (int j = 0; j < 6; ++j) {
    if (WF) {
      build_x(j, 0);
      mlp_bwd_step(s, x, act ? dsdf[j] * scale : 0.f, j == 0 ? pw : 0.f, dx);
      if (act)
        for (int kk = 0; kk < k; ++kk) {
          float* d = dfeats + (row * k + kk) * C;
          const float wq = wgt(j, kk);
#pragma unroll
          for (int f = 0; f < F; ++f) d[f] = fmaf(wq, dx[f], d[f]);
        }
      reduce_step(s, acc);
    } else {
      for (int kk = 0; kk < k; ++kk) {
        build_x(j, kk);
        mlp_bwd_step(s, x, act ? dsdf[j] * scale * wgt(j, kk) : 0.f,
                     (j == 0 && kk == 0) ? pw : 0.f, dx);
        if (act) {
          float* d = dfeats + (row * k + kk) * C;
#pragma unroll
          for (int f = 0; f < F; ++f) d[f] += dx[f];
        }
        reduce_step(s, acc);
      }
    }
  }
  store_partials(acc, partial);
}

extern "C" int eikonal_launch(const void* feats, const void* wst, const void* vst,
                              const void* esc, const void* params, int n, int k,
                              int weighted_first, float scale, float inv2e, void* dfeats,
                              void* partial, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nblocks = (n + BLK - 1) / BLK;
  if (nblocks > 0) {
    if (weighted_first)
      eikonal_kernel<true><<<nblocks, BLK, 0, st>>>(
          (const float*)feats, (const float*)wst, (const float*)vst, (const float*)esc,
          (const float*)params, n, k, scale, inv2e, (float*)dfeats, (float*)partial);
    else
      eikonal_kernel<false><<<nblocks, BLK, 0, st>>>(
          (const float*)feats, (const float*)wst, (const float*)vst, (const float*)esc,
          (const float*)params, n, k, scale, inv2e, (float*)dfeats, (float*)partial);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_reduce((const float*)partial, nblocks, (float*)out, st);
}
