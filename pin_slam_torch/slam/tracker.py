"""Correspondence-free point-to-implicit registration (odometry), torch
counterpart of ``pin_slam_tpu/slam/tracker.py``: the analytic-gradient path
with the candidate cache, every health gate, and with a colour head the JAX
package's colour path (a fresh kNN and autograd input gradients every
iteration; the intensity-consistency weight or the photometric rows).

The JAX package runs the Gauss-Newton/LM iterations as two nested
``lax.while_loop``s on the device.  Here they are Python loops: the device
computes the per-point SDF, gradient and the 6x6 normal equations, and one
packed (N, g, residual, count) tensor comes back to the host per iteration;
the damped 6x6 solve, the se(3) update and the convergence / health gates
run on host float32 tensors with the same operations as the JAX package.
That one host synchronisation per iteration is accepted in this slice
(CUDA graphs are queued in ROADMAP.md).

As in the JAX package, registration runs in a sensor-centred shifted frame
(translations relative to ``lm.origin``) so float32 stays well-conditioned.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from pin_slam_torch.models import decoder as dec
from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.ops import smallmat
from pin_slam_torch.ops.transforms import _cross, quat_to_rotmat, rotmat_to_quat, so3_expmap
from pin_slam_torch.slam import tracker_grad as tg


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    reg_iter_n: int = 50
    min_grad_norm: float = 0.5
    max_grad_norm: float = 2.0
    GM_dist: float = 0.5
    GM_grad: float = 0.2
    lm_lambda: float = 1e-4
    term_thre_deg: float = 0.01
    term_thre_m: float = 0.0005
    max_sdf_std_ratio: float = 1.0
    surface_sample_range: float = 0.25
    eigenvalue_check: bool = True
    mask_min_nn_count: int = 6
    min_valid_points: int = 30
    min_valid_ratio: float = 0.2
    max_increment_ratio: float = 1.1
    eigenvalue_ratio_thre: float = 0.01
    consist_weight_on: bool = True
    photometric_on: bool = False
    photometric_weight: float = 0.01

    @staticmethod
    def from_config(cfg, loop_reg: bool = False) -> "TrackerConfig":
        """``loop_reg``: the loop-verification registration, whose source
        overlaps the map around the loop frame less (valid ratio 0.15)."""
        return TrackerConfig(
            reg_iter_n=cfg.reg_iter_n, min_grad_norm=cfg.reg_min_grad_norm,
            max_grad_norm=cfg.reg_max_grad_norm, GM_dist=cfg.reg_GM_dist_m,
            GM_grad=cfg.reg_GM_grad, lm_lambda=cfg.reg_lm_lambda,
            term_thre_deg=cfg.reg_term_thre_deg, term_thre_m=cfg.reg_term_thre_m,
            max_sdf_std_ratio=cfg.max_sdf_std_ratio,
            surface_sample_range=cfg.surface_sample_range_m,
            eigenvalue_check=cfg.eigenvalue_check, mask_min_nn_count=cfg.query_nn_k,
            min_valid_ratio=0.15 if loop_reg else 0.2,
            consist_weight_on=cfg.consist_wieght_on,
            photometric_on=cfg.photometric_loss_on and cfg.color_on,
            photometric_weight=cfg.photometric_loss_weight)


class TrackResult(NamedTuple):
    """Host (CPU float32) tensors and python scalars."""
    R: torch.Tensor            # (3,3) rotation
    t: torch.Tensor            # (3,) translation in the shifted frame
    valid: bool                # all health gates passed
    converged: bool
    iterations: int
    sdf_residual_cm: float
    valid_count: int
    min_eigenvalue: float
    cov: torch.Tensor          # (6,6)
    photo_count: int = 0       # points with a photometric weight in the final statistics


def _gm_weight(k: float, r: torch.Tensor) -> torch.Tensor:
    return (k / (k * k + r * r)) ** 2


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def color_to_intensity(colors: torch.Tensor) -> torch.Tensor:
    """RGB [..., 3] -> intensity (the JAX package's weights); a single
    channel passes through."""
    if colors.dim() >= 1 and colors.shape[-1] == 3:
        return 0.144 * colors[..., 0] + 0.299 * colors[..., 1] + 0.587 * colors[..., 2]
    return colors[..., 0] if colors.dim() > 1 else colors


def _sdf_intensity_grads(lm, mc, decoder, color_decoder, sdf_scale, cells, pts, after_pgo,
                         intensity_grad: bool):
    """The colour path's query at ``pts``: a fresh kNN, the interpolated
    geometry and colour features, the SDF and the intensity of the regressed
    colour, and their gradients in ``pts`` by autograd (the intensity's
    only with ``intensity_grad``).  Returns (sdf, grad, intensity, its
    gradient or None, nn_count, sdf_std)."""
    knn = npts.knn_search(lm, mc, pts, cells)
    with torch.enable_grad():
        p = pts.detach().requires_grad_(True)
        geo, col, w, _ = npts.interpolate_features(lm, mc, p, knn.lidx, after_pgo=after_pgo,
                                                   query_color=True)
        sdf, sdf_std = decoder.blended_sdf(geo, w, mc.weighted_first, sdf_scale)
        inten = color_to_intensity(dec.blended_head(dec.regress_color, color_decoder, col, w,
                                                    mc.weighted_first))
        grad, = torch.autograd.grad(sdf.sum(), p, retain_graph=intensity_grad)
        c_grad = torch.autograd.grad(inten.sum(), p)[0] if intensity_grad else None
    return sdf.detach(), grad, inten.detach(), c_grad, knn.nn_count, sdf_std.detach()


def track_frame(lm: npts.LocalMap, mc: npts.MapConfig, tc: TrackerConfig, decoder,
                sdf_scale: float, offsets, source: torch.Tensor,
                source_valid: torch.Tensor, R_init, t_init,
                after_pgo: bool = False, color_decoder=None,
                source_colors=None) -> TrackResult:
    """Register ``source`` (sensor frame, padded, on the map's device)
    against the implicit map.  R_init / t_init: the initial guess with the
    translation expressed in the shifted frame (world minus ``lm.origin``).
    ``after_pgo``: the map has been deformed (quaternion-rotated offsets).
    With a colour head (``color_decoder``, ``source_colors`` (N, C) and the
    map's colour features) it takes the JAX package's colour path: no
    candidate cache, a fresh kNN every iteration, the SDF's and the
    regressed intensity's gradients by autograd, and either the photometric
    rows (``tc.photometric_on``) or the intensity-consistency weight."""
    dev = source.device
    color_on = (color_decoder is not None and source_colors is not None
                and lm.color_features is not None)
    cells = offsets.cells if isinstance(offsets, npts.ProbeTemplate) else offsets
    with torch.no_grad():
        src_intensity = color_to_intensity(source_colors) if color_on else None
        origin = lm.origin
        src_count = max(int(torch.sum(source_valid)), 1)
        r_max = _f32(torch.max(torch.where(source_valid, torch.linalg.norm(source, dim=-1),
                                           torch.zeros_like(source[:, 0]))).cpu())
        probe_margin = 0.25 * mc.voxel_size
        max_sdf_std = tc.surface_sample_range * tc.max_sdf_std_ratio

        def probe(R, t):
            return tg.probe_candidates(lm, mc, source @ R.to(dev).T + t.to(dev) + origin,
                                       offsets)

        photometric = color_on and tc.photometric_on

        def one_step(R, t, cache=None):
            cur = source @ R.to(dev).T + t.to(dev)
            if color_on:
                sdf, grad, inten, c_grad, nn_count, sdf_std = _sdf_intensity_grads(
                    lm, mc, decoder, color_decoder, sdf_scale, cells, cur + origin, after_pgo,
                    photometric)
            else:
                sdf, grad, nn_count, sdf_std = tg.sdf_value_and_grad_cached(
                    cache, lm, mc, decoder, sdf_scale, cur + origin, after_pgo)
            grad_norm = torch.linalg.norm(grad, dim=-1)
            mask = (source_valid & (nn_count >= tc.mask_min_nn_count)
                    & (grad_norm > tc.min_grad_norm) & (grad_norm < tc.max_grad_norm)
                    & (sdf_std < max_sdf_std))
            residual = sdf
            w = _gm_weight(tc.GM_dist, residual) * _gm_weight(tc.GM_grad, grad_norm - 1.0)
            if color_on and not tc.photometric_on and tc.consist_weight_on:
                w = w * torch.exp(-torch.abs(inten - src_intensity))
            w = torch.where(mask, w, torch.zeros_like(w))
            valid_count = torch.sum(mask)
            w_mean = torch.sum(w) / torch.clamp(valid_count, min=1)
            w = w / torch.clamp(2.0 * w_mean, min=1e-12)
            J = torch.cat([_cross(cur, grad), grad], dim=-1)
            Jw = J * w[:, None]
            N = J.T @ Jw
            g = -(Jw.T @ residual)
            photo_n = torch.zeros((), dtype=torch.float32, device=dev)
            if photometric:
                # the photometric rows: the regressed intensity against the
                # source's, with the geometric weights
                J_c = torch.cat([_cross(cur, c_grad), c_grad], dim=-1)
                Jw_c = J_c * w[:, None]
                N = N + tc.photometric_weight * (J_c.T @ Jw_c)
                g = g - tc.photometric_weight * (Jw_c.T @ (inten - src_intensity))
                photo_n = torch.sum(w != 0.0).to(torch.float32)
            res_cm = (torch.sum(torch.where(mask, torch.abs(residual), torch.zeros_like(residual)))
                      / torch.clamp(valid_count, min=1) * 100.0)
            packed = torch.cat([N.reshape(-1), g, res_cm[None],
                                valid_count.to(torch.float32)[None], photo_n[None]]).cpu()
            return (packed[:36].reshape(6, 6), packed[36:42], packed[42], int(packed[43]),
                    int(packed[44]))

        def solve(N, g):
            N_d = N + tc.lm_lambda * torch.diag(torch.diag(N))
            d = 1.0 / torch.sqrt(torch.clamp(torch.diag(N_d), min=1e-12))
            Ns = N_d * d[:, None] * d[None, :]
            return d * smallmat.cholesky_solve6(Ns + 1e-7 * torch.eye(6), d * g)

        R = _f32(R_init).reshape(3, 3).clone()
        t = _f32(t_init).reshape(3).clone()
        st = {"i": 0, "converged": False, "valid": True, "last_res": _f32(1e5)}

        def running():
            return st["i"] < tc.reg_iter_n and not st["converged"] and st["valid"]

        def gn_update(R, t, cache):
            """One damped Gauss-Newton step from (R, t) and its gates."""
            N, g, res_cm, vc, _ = one_step(R, t, cache)
            xi = solve(N, g)
            w_norm = torch.linalg.norm(xi[:3])
            v_norm = torch.linalg.norm(xi[3:])
            scale = torch.clamp(torch.minimum(0.5 / torch.clamp(w_norm, min=1e-12),
                                              2.0 / torch.clamp(v_norm, min=1e-12)), max=1.0)
            xi = xi * scale
            dR = so3_expmap(xi[:3])
            dt = xi[3:]
            R = quat_to_rotmat(rotmat_to_quat(dR @ R))
            t = dR @ t + dt
            last_res = st["last_res"]
            grew = bool((res_cm - last_res) / torch.clamp(last_res, min=1e-9)
                        > tc.max_increment_ratio)
            enough = (vc >= tc.min_valid_points
                      and bool(_f32(vc) / _f32(src_count) >= tc.min_valid_ratio))
            st["valid"] = st["valid"] and not grew and enough
            st["last_res"] = last_res if grew else res_cm
            rot_deg = torch.arccos(torch.clamp((torch.trace(dR) - 1) / 2, -1.0, 1.0)) \
                * (180.0 / math.pi)
            st["converged"] = bool((rot_deg < tc.term_thre_deg)
                                   & (torch.linalg.norm(dt) < tc.term_thre_m))
            st["i"] += 1
            return R, t

        cache = None
        if color_on:
            while running():
                R, t = gn_update(R, t, None)
        else:
            # outer loop: one candidate probe per epoch; inner loop: GN
            # iterations until the pose has moved past the probe margin
            cache = probe(R, t)
            while running():
                pR, pt = R, t
                while running() and bool(torch.linalg.norm(t - pt)
                                         + torch.linalg.norm(R - pR) * r_max <= probe_margin):
                    R, t = gn_update(R, t, cache)
                cache = probe(R, t)

        R = quat_to_rotmat(rotmat_to_quat(R))
        N, g, res_cm, vc, photo_n = one_step(R, t, cache)
        valid = st["valid"] and bool(res_cm <= tc.surface_sample_range * 0.5 * 100.0)
        min_eig = smallmat.sym_eigvals_min3(N[3:, 3:])
        if tc.eigenvalue_check:
            valid = valid and bool(min_eig >= _f32(vc) * tc.eigenvalue_ratio_thre)
        mse = (res_cm / 100.0) ** 2
        cov = smallmat.cholesky_inverse6(N + 1e-6 * torch.eye(6)) * mse
    return TrackResult(R=R, t=t, valid=valid, converged=st["converged"], iterations=st["i"],
                       sdf_residual_cm=float(res_cm), valid_count=vc,
                       min_eigenvalue=float(min_eig), cov=cov, photo_count=photo_n)
