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
// Bound on an H100: at B = 16384, k = 6 the launch moves ~5 MB (read feats,
// weights, vectors; write dfeats) and does ~50-300 MFLOP of float32 FMAs, so
// it is a few microseconds of either at the card's peak: launch- and
// latency-bound.  Design: one thread per row (no k^2 block-diagonal decoder,
// no ones-column packing, no tile padding: all TPU-specific), decoder in
// shared memory, decodes recomputed in the backward pass, decoder gradients
// by a fixed-order block reduction plus `reduce_partials` (no atomics).
// k is a runtime value up to 16.

#include "train_common.cuh"

using namespace tk;

__device__ inline void bce(float pred, float label, float wt, float inv_sigma, float& pw,
                           float& dpred) {
  const float z = pred * inv_sigma;
  const float tgt = 1.f / (1.f + expf(-label * inv_sigma));
  const float per = fmaxf(z, 0.f) - z * tgt + log1pf(expf(-fabsf(z)));
  const float sz = 1.f / (1.f + expf(-z));
  pw = per * wt;
  dpred = (sz - tgt) * wt * inv_sigma;
}

template <bool WF>
__global__ void __launch_bounds__(BLK) train_iter_kernel(
    const float* __restrict__ feats, const float* __restrict__ w,
    const float* __restrict__ vin, const float* __restrict__ label,
    const float* __restrict__ wt, const float* __restrict__ params, int B, int k,
    float scale, float inv_sigma, float* __restrict__ dfeats, float* __restrict__ partial) {
  __shared__ Smem s;
  load_params(s, params);
  const long row = (long)blockIdx.x * BLK + threadIdx.x;
  const bool act = row < B;
  float acc[NE];
#pragma unroll
  for (int m = 0; m < NE; ++m) acc[m] = 0.f;

  float wk[MAXK];
  for (int kk = 0; kk < k; ++kk) wk[kk] = act ? w[row * k + kk] : 0.f;
  const float* fr = feats + row * k * C;
  const float lab = act ? label[row] : 0.f;
  const float wtr = act ? wt[row] : 0.f;
  float x[IN], dx[IN];

  if (WF) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float a = 0.f;
      if (act)
        for (int kk = 0; kk < k; ++kk) a = fmaf(wk[kk], fr[kk * C + f], a);
      x[f] = a;
    }
#pragma unroll
    for (int v = 0; v < VD; ++v) x[F + v] = act ? vin[row * VD + v] : 0.f;
    const float o = mlp_fwd(s, x);
    float pw, dpred;
    bce(o * scale, lab, wtr, inv_sigma, pw, dpred);
    const float dO = act ? dpred * scale : 0.f;
    mlp_bwd_step(s, x, dO, act ? pw : 0.f, dx);
    if (act) {
      for (int kk = 0; kk < k; ++kk) {
        float* d = dfeats + (row * k + kk) * C;
#pragma unroll
        for (int f = 0; f < F; ++f) d[f] = wk[kk] * dx[f];
        d[F] = wk[kk];
      }
    }
    reduce_step(s, acc);
  } else {
    float o[MAXK];
    float pred = 0.f;
    for (int kk = 0; kk < k; ++kk) {
#pragma unroll
      for (int f = 0; f < F; ++f) x[f] = act ? fr[kk * C + f] : 0.f;
#pragma unroll
      for (int v = 0; v < VD; ++v) x[F + v] = act ? vin[(row * k + kk) * VD + v] : 0.f;
      o[kk] = mlp_fwd(s, x);
      pred = fmaf(wk[kk], o[kk], pred);
    }
    float pw, dpred;
    bce(pred * scale, lab, wtr, inv_sigma, pw, dpred);
    for (int kk = 0; kk < k; ++kk) {
      const float dO = act ? dpred * scale * wk[kk] : 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) x[f] = act ? fr[kk * C + f] : 0.f;
#pragma unroll
      for (int v = 0; v < VD; ++v) x[F + v] = act ? vin[(row * k + kk) * VD + v] : 0.f;
      mlp_bwd_step(s, x, dO, (act && kk == 0) ? pw : 0.f, dx);
      if (act) {
        float* d = dfeats + (row * k + kk) * C;
#pragma unroll
        for (int f = 0; f < F; ++f) d[f] = dx[f];
        d[F] = wk[kk];
      }
      reduce_step(s, acc);
    }
  }
  store_partials(acc, partial);
}

extern "C" int train_iter_launch(const void* feats, const void* w, const void* vin,
                                 const void* label, const void* wt, const void* params,
                                 int B, int k, int weighted_first, float scale,
                                 float inv_sigma, void* dfeats, void* partial, void* out,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nblocks = (B + BLK - 1) / BLK;
  if (nblocks > 0) {
    if (weighted_first)
      train_iter_kernel<true><<<nblocks, BLK, 0, st>>>(
          (const float*)feats, (const float*)w, (const float*)vin, (const float*)label,
          (const float*)wt, (const float*)params, B, k, scale, inv_sigma, (float*)dfeats,
          (float*)partial);
    else
      train_iter_kernel<false><<<nblocks, BLK, 0, st>>>(
          (const float*)feats, (const float*)w, (const float*)vin, (const float*)label,
          (const float*)wt, (const float*)params, B, k, scale, inv_sigma, (float*)dfeats,
          (float*)partial);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_reduce((const float*)partial, nblocks, (float*)out, st);
}
