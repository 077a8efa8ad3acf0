"""Correspondence-free point-to-implicit registration (odometry), torch
counterpart of ``pin_slam_tpu/slam/tracker.py``: the analytic-gradient path
with the candidate cache, every health gate, the normal-consistency weight
of source points that carry a normal, and with a colour head the JAX
package's colour path (a fresh kNN and autograd input gradients every
iteration; the intensity-consistency weight or the photometric rows).

The JAX package runs the Gauss-Newton/LM iterations as two nested
``lax.while_loop``s on the device.  Here they are Python loops: the device
computes the per-point SDF, gradient and the 6x6 normal equations, and one
packed (N, g, residual, count) tensor comes back to the host per iteration;
the damped 6x6 solve, the se(3) update and the convergence / health gates
run on host float32 tensors with the same operations as the JAX package.
The cached step (no colour, no encoding) is one launch of the track-step
kernel (``ops/track_kernel.py``, the pose passed by value) wherever
``track_kernel.track_kernel_takes`` holds; past it, and on the CPU, its
plain twin.  Every host sync and upload goes through ``utils/tracing.py``
(the packed fetch counts as ``gn_fetch``, once an iteration and once for
the final statistics), charged to the caller's stage: odometry, or pgo in
loop verification.

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
from pin_slam_torch.ops import smallmat, track_kernel
from pin_slam_torch.ops.transforms import quat_to_rotmat, rotmat_to_quat, so3_expmap
from pin_slam_torch.slam import tracker_grad as tg
from pin_slam_torch.utils import tracing


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


def _autograd_sdf(lm, mc, decoder, sdf_scale, cells, pts, after_pgo):
    """The query with positional encoding, whose input gradient has no
    closed form here (the JAX package's ``jax.vjp`` path): a fresh kNN, the
    interpolated (encoded) features, the SDF, and its gradient in ``pts``
    by one ``autograd.grad``.  Returns (sdf, grad, nn_count, sdf_std)."""
    knn = npts.knn_search(lm, mc, pts, cells)
    with torch.enable_grad():
        p = pts.detach().requires_grad_(True)
        geo, w, _ = npts.interpolate_features(lm, mc, p, knn.lidx, after_pgo=after_pgo)
        sdf, sdf_std = decoder.blended_sdf(geo, w, mc.weighted_first, sdf_scale)
        grad, = torch.autograd.grad(sdf.sum(), p)
    return sdf.detach(), grad, knn.nn_count, sdf_std.detach()


def kernel_route(mc: npts.MapConfig, decoder, M: int) -> bool:
    """Whether the cached step of a map with ``mc`` and this geometry
    decoder, over M cached candidates a row, is the track-step kernel's
    (``track_kernel.track_kernel_takes``); the colour and encoded paths
    never reach it."""
    layers = decoder.layers()
    return track_kernel.track_kernel_takes(mc.feature_dim, layers[0][0].shape[1],
                                           len(layers) - 1, min(mc.nn_k, M), M)


def track_frame(lm: npts.LocalMap, mc: npts.MapConfig, tc: TrackerConfig, decoder,
                sdf_scale: float, offsets, source: torch.Tensor,
                source_valid: torch.Tensor, R_init, t_init,
                after_pgo: bool = False, color_decoder=None,
                source_colors=None, source_normals=None,
                source_normal_valid=None, origin=None) -> TrackResult:
    """Register ``source`` (sensor frame, padded, on the map's device)
    against the implicit map.  R_init / t_init: the initial guess with the
    translation expressed in the shifted frame (world minus ``lm.origin``).
    ``after_pgo``: the map has been deformed (quaternion-rotated offsets).
    With a colour head (``color_decoder``, ``source_colors`` (N, C) and the
    map's colour features) it takes the JAX package's colour path: no
    candidate cache, a fresh kNN every iteration, the SDF's and the
    regressed intensity's gradients by autograd, and either the photometric
    rows (``tc.photometric_on``) or the intensity-consistency weight.  With
    positional encoding (``mc.pos_encoding_band``) the geometry alone takes
    that shape too (``_autograd_sdf``), as the JAX package takes ``jax.vjp``
    there.
    ``source_normals`` (N, 3) in the sensor frame (``ops/normals.py``)
    weight each point by 0.5 + |n . g|, n rotated by the current rotation
    and g the SDF's unit gradient; 1 where ``source_normal_valid`` is
    False.  ``origin``: ``lm.origin``'s value on the host (float32), which
    the track-step kernel takes by value; read from the map where the
    kernel needs it and the caller did not give it."""
    dev = source.device
    color_on = (color_decoder is not None and source_colors is not None
                and lm.color_features is not None)
    cells = offsets.cells if isinstance(offsets, npts.ProbeTemplate) else offsets
    uncached = color_on or mc.pos_encoding_band > 0      # the autograd paths
    with torch.no_grad():
        src_intensity = color_to_intensity(source_colors) if color_on else None
        src_count = max(tracing.read(torch.sum(source_valid), "src_count", int), 1)
        r_max = _f32(tracing.read(torch.max(torch.where(
            source_valid, torch.linalg.norm(source, dim=-1), torch.zeros_like(source[:, 0]))),
            "r_max"))
        probe_margin = 0.25 * mc.voxel_size

        def upload_pose(R, t):
            return tracing.upload(R, "pose_R", dev), tracing.upload(t, "pose_t", dev)

        def probe(R, t):
            with tracing.part("probe"):
                R_d, t_d = upload_pose(R, t)
                return tg.probe_candidates(lm, mc, source @ R_d.T + t_d + lm.origin, offsets)

        photometric = color_on and tc.photometric_on
        kernel = False                 # the cached step is the kernel's (set at the first probe)

        def one_step(R, t, cache=None):
            if not uncached:
                if kernel:
                    packed = track_kernel.track_step(
                        cache, lm, mc, decoder, sdf_scale, source, source_valid, R, t,
                        origin, tc, after_pgo, source_normals, source_normal_valid)
                else:
                    packed = track_kernel.track_step_plain(
                        cache, lm, mc, decoder, sdf_scale, source, source_valid, R, t, tc,
                        after_pgo, source_normals, source_normal_valid)
            else:
                R_d, t_d = upload_pose(R, t)
                cur = source @ R_d.T + t_d
                consist = photo = None
                if color_on:
                    sdf, grad, inten, c_grad, nn_count, sdf_std = _sdf_intensity_grads(
                        lm, mc, decoder, color_decoder, sdf_scale, cells, cur + lm.origin,
                        after_pgo, photometric)
                    if photometric:
                        photo = (c_grad, inten - src_intensity)
                    elif tc.consist_weight_on:
                        consist = torch.exp(-torch.abs(inten - src_intensity))
                else:
                    sdf, grad, nn_count, sdf_std = _autograd_sdf(
                        lm, mc, decoder, sdf_scale, cells, cur + lm.origin, after_pgo)
                packed = track_kernel.normal_equations(
                    tc, cur, sdf, grad, nn_count, sdf_std, source_valid, R, source_normals,
                    source_normal_valid, consist, photo)
            packed = tracing.read(packed, "gn_fetch")
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
            with tracing.part("gn_step"):
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
        if uncached:
            while running():
                R, t = gn_update(R, t, None)
        else:
            # outer loop: one candidate probe per epoch; inner loop: GN
            # iterations until the pose has moved past the probe margin
            cache = probe(R, t)
            kernel = kernel_route(mc, decoder, cache.lidx.shape[1])
            if kernel and origin is None and source.is_cuda:
                origin = tracing.read(lm.origin, "origin")
            while running():
                pR, pt = R, t
                while running() and bool(torch.linalg.norm(t - pt)
                                         + torch.linalg.norm(R - pR) * r_max <= probe_margin):
                    R, t = gn_update(R, t, cache)
                cache = probe(R, t)

        R = quat_to_rotmat(rotmat_to_quat(R))
        with tracing.part("gn_final"):
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
