"""The tracker's cached Gauss-Newton step: the CUDA kernel
``csrc/track_step.cu`` and its plain PyTorch twin.

No TPU kernel stands behind it: the JAX package runs this step inside its
jitted ``lax.while_loop`` (``pin_slam_tpu/slam/tracker.py``), where XLA
fuses it.  Eagerly, the same step is some 150 small torch launches, two
pose uploads and one packed read, and the host's enqueue of those launches
set odometry's pace on the card.  The kernel does the whole step in one
launch: it takes the pose (R, t) and the local map's ``origin`` by value,
re-ranks each source row's cached candidates, decodes the k nearest through
the one-hidden-layer SDF decoder with its closed-form input gradient, builds
the mask, the robust weights and the Jacobian, and reduces the normal
equations in a fixed order into the packed vector the tracker reads.

Both take the candidate cache of ``tracker_grad.probe_candidates``, the
local map, the decoder, the source rows and the pose, and return the packed
(45,) vector ``[N (6x6, row-major) | g (6) | residual cm | valid count |
photometric count (0)]`` on the source's device.  ``track_step_plain`` is
the torch arithmetic: ``tracker_grad.sdf_value_and_grad_cached`` and
``normal_equations``, which the tracker's other branches (the colour and
the encoded autograd paths) share.  On the CPU ``track_step`` runs the plain
twin; on CUDA it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from pin_slam_torch.ops import _cuda
from pin_slam_torch.ops.transforms import _cross
from pin_slam_torch.utils import tracing

PACKED = 45                 # N (36) | g (6) | residual cm | valid count | photometric count
MAX_F, MAX_H, MAX_K, MAX_M = 64, 256, 16, 32
TRACK_WARPS = 8             # warps a block of csrc/track_step.cu
TRACK_SUMS = 30             # a block's partial row: N' (21) | g' (6) | sum w | count | sum |r|
TRACK_BLOCKS_PER_SM = 4     # the launch's blocks: at most this many an SM
_ARGS = [_cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.P]
_TICKETS = {}               # device index -> the last-block ticket (one int, kept at 0)
_GEOMETRY = []


def track_kernel_takes(F: int, H: int, depth: int, k: int, M: int) -> bool:
    """Whether the kernel takes a decoder of ``depth`` hidden layers of H
    units over F features, k neighbours of M cached candidates: the one
    place that says so."""
    return depth == 1 and 1 <= F <= MAX_F and 1 <= H <= MAX_H and 1 <= k <= MAX_K \
        and k <= M <= MAX_M


def _gm_weight(k: float, r: torch.Tensor) -> torch.Tensor:
    return (k / (k * k + r * r)) ** 2


def normal_equations(tc, cur, sdf, grad, nn_count, sdf_std, source_valid, R=None,
                     source_normals=None, source_normal_valid=None, consist=None,
                     photo=None) -> torch.Tensor:
    """The packed (45,) normal equations of one step from the per-row SDF,
    gradient, neighbour count and spread at ``cur`` (the source rows in the
    shifted frame): the mask, the Geman-McClure weights, with
    ``source_normals`` (rotated by the host rotation R) the normal weight
    0.5 + |n . g/|g|| (1 where ``source_normal_valid`` is False), times
    ``consist`` where given (the colour path's intensity weight), the
    weights' normalisation by twice their mean, J = [cur x g, g], N = J^T W J
    and g = -J^T W r; with ``photo`` = (intensity gradient, intensity
    residual) the photometric rows."""
    dev = cur.device
    max_sdf_std = tc.surface_sample_range * tc.max_sdf_std_ratio
    grad_norm = torch.linalg.norm(grad, dim=-1)
    mask = (source_valid & (nn_count >= tc.mask_min_nn_count)
            & (grad_norm > tc.min_grad_norm) & (grad_norm < tc.max_grad_norm)
            & (sdf_std < max_sdf_std))
    residual = sdf
    w = _gm_weight(tc.GM_dist, residual) * _gm_weight(tc.GM_grad, grad_norm - 1.0)
    if source_normals is not None:
        n_w = source_normals @ tracing.upload(R, "pose_R", dev).T
        grad_unit = grad / torch.clamp(grad_norm, min=1e-12)[:, None]
        w_normal = 0.5 + torch.abs(torch.sum(n_w * grad_unit, dim=-1))
        if source_normal_valid is not None:
            w_normal = torch.where(source_normal_valid, w_normal, torch.ones_like(w_normal))
        w = w * w_normal
    if consist is not None:
        w = w * consist
    w = torch.where(mask, w, torch.zeros_like(w))
    valid_count = torch.sum(mask)
    w_mean = torch.sum(w) / torch.clamp(valid_count, min=1)
    w = w / torch.clamp(2.0 * w_mean, min=1e-12)
    J = torch.cat([_cross(cur, grad), grad], dim=-1)
    Jw = J * w[:, None]
    N = J.T @ Jw
    g = -(Jw.T @ residual)
    photo_n = torch.zeros((), dtype=torch.float32, device=dev)
    if photo is not None:
        # the photometric rows: the regressed intensity against the
        # source's, with the geometric weights
        c_grad, c_res = photo
        J_c = torch.cat([_cross(cur, c_grad), c_grad], dim=-1)
        Jw_c = J_c * w[:, None]
        N = N + tc.photometric_weight * (J_c.T @ Jw_c)
        g = g - tc.photometric_weight * (Jw_c.T @ c_res)
        photo_n = torch.sum(w != 0.0).to(torch.float32)
    res_cm = (torch.sum(torch.where(mask, torch.abs(residual), torch.zeros_like(residual)))
              / torch.clamp(valid_count, min=1) * 100.0)
    return torch.cat([N.reshape(-1), g, res_cm[None], valid_count.to(torch.float32)[None],
                      photo_n[None]])


def track_step_plain(cache, lm, mc, decoder, sdf_scale: float, source, source_valid, R, t,
                     tc, after_pgo: bool = False, source_normals=None,
                     source_normal_valid=None) -> torch.Tensor:
    """The cached step in torch: the pose uploaded (``pose_R``, ``pose_t``),
    ``tracker_grad.sdf_value_and_grad_cached`` at the source rows moved to
    the map, and ``normal_equations``."""
    from pin_slam_torch.slam import tracker_grad as tg

    dev = source.device
    R_d, t_d = tracing.upload(R, "pose_R", dev), tracing.upload(t, "pose_t", dev)
    cur = source @ R_d.T + t_d
    sdf, grad, nn_count, sdf_std = tg.sdf_value_and_grad_cached(
        cache, lm, mc, decoder, sdf_scale, cur + lm.origin, after_pgo)
    return normal_equations(tc, cur, sdf, grad, nn_count, sdf_std, source_valid, R,
                            source_normals, source_normal_valid)


def _check(cache, lm, mc, decoder, source, source_valid, R, t, origin, after_pgo,
           source_normals, source_normal_valid):
    """Input checks shared by the CPU and CUDA paths, so that the CPU tests
    catch what the kernel would refuse; on CUDA also ``track_kernel_takes``.
    Returns (F, H, k, M, layers)."""
    N, M = cache.lidx.shape
    layers = decoder.layers()
    F, H = lm.geo_features.shape[1], layers[0][0].shape[1]
    k = min(mc.nn_k, M)
    dev = source.get_device()
    if source.shape != (N, 3) or source_valid.shape != (N,) or source_valid.dtype != torch.bool:
        raise ValueError(f"source {tuple(source.shape)} / {tuple(source_valid.shape)} for a "
                         f"cache of {N} rows")
    floats = [source, cache.xs, cache.ys, cache.zs]
    floats += [source_normals] if source_normals is not None else []
    tables = [lm.geo_features] + ([lm.attr_rows] if after_pgo else [])
    for i, ts in enumerate(floats + tables):
        if ts.get_device() != dev or ts.dtype != torch.float32 or not (
                ts.is_contiguous() or (i >= len(floats) and ts.stride(1) == 1)):
            raise ValueError("the track step takes contiguous float32 tensors (tables with "
                             "contiguous rows) on one device")
    if (cache.lidx.dtype != torch.int64 or not cache.lidx.is_contiguous()
            or any(a.shape != (N, M) for a in cache[:3])):
        raise ValueError("the candidate cache takes (N, M) float32 xs, ys, zs and int64 lidx")
    if source_normals is not None and source_normals.shape != (N, 3):
        raise ValueError(f"source normals {tuple(source_normals.shape)} for {N} rows")
    if source_normal_valid is not None and (source_normal_valid.shape != (N,)
                                            or source_normal_valid.dtype != torch.bool):
        raise ValueError("source_normal_valid takes (N,) bool")
    if (layers[-1][0].shape[1] != 1 or layers[0][0].shape[0] != F + 3
            or tuple(R.shape) != (3, 3) or tuple(t.shape) != (3,)
            or (origin is not None and tuple(origin.shape) != (3,))):
        raise ValueError("the track step takes an SDF decoder of F + 3 inputs, a 3x3 R, a "
                         "translation and an origin of 3")
    if not all(w.T.is_contiguous() for w, _ in layers) or not all(
            b is None or b.is_contiguous() for _, b in layers):
        raise ValueError("the track step reads the decoder's weights as nn.Linear stores them")
    if source.is_cuda and (origin is None or not (origin.is_cpu and R.is_cpu and t.is_cpu)):
        raise ValueError("the track-step kernel takes R, t and the origin on the host")
    if source.is_cuda and not track_kernel_takes(F, H, len(layers) - 1, k, M):
        raise NotImplementedError(
            f"the track-step kernel takes one hidden layer, F <= {MAX_F}, H <= {MAX_H}, "
            f"k <= {MAX_K}, M <= {MAX_M} (track_kernel_takes); got F {F}, H {H}, "
            f"{len(layers) - 1} hidden layers, k {k}, M {M}")
    return F, H, k, M, layers


def _geometry() -> None:
    """Raise unless csrc/track_step.cu's block geometry is the one these
    wrappers size the partial rows and the packed vector for (once)."""
    if not _GEOMETRY:
        geom = (ctypes.c_int * 3)()
        _cuda.lib("track_step").track_step_geometry(geom)
        if tuple(geom) != (TRACK_WARPS, TRACK_SUMS, PACKED):
            raise RuntimeError(f"csrc/track_step.cu's geometry {tuple(geom)} is not "
                               f"({TRACK_WARPS}, {TRACK_SUMS}, {PACKED})")
        _GEOMETRY.append(True)


def track_grid(N: int, device: int) -> int:
    """Blocks of a launch over N source rows: a warp a row, at most
    ``TRACK_BLOCKS_PER_SM`` blocks an SM; the warps take rows in turn, so
    the valid rows at the front of the bucket spread over every warp."""
    return max(1, min(-(-N // TRACK_WARPS), TRACK_BLOCKS_PER_SM * _cuda.sm_count(device)))


def _ticket(device: int) -> torch.Tensor:
    tk = _TICKETS.get(device)
    if tk is None:
        tk = _TICKETS[device] = torch.zeros((1,), dtype=torch.int32, device=f"cuda:{device}")
    return tk


def _ptr(ts) -> int:
    return 0 if ts is None else ts.data_ptr()


def track_step(cache, lm, mc, decoder, sdf_scale: float, source, source_valid, R, t, origin,
               tc, after_pgo: bool = False, source_normals=None,
               source_normal_valid=None) -> torch.Tensor:
    """One cached Gauss-Newton step's packed normal equations.  R (3,3), t
    (3,) and ``origin`` (3,) (``lm.origin``'s value) are host float32
    tensors, passed to the kernel by value.  On the CPU: the plain twin (the
    origin is read from ``lm``)."""
    F, H, k, M, layers = _check(cache, lm, mc, decoder, source, source_valid, R, t, origin,
                                after_pgo, source_normals, source_normal_valid)
    if source.is_cpu:
        return track_step_plain(cache, lm, mc, decoder, sdf_scale, source, source_valid, R, t,
                                tc, after_pgo, source_normals, source_normal_valid)
    dev = source.get_device()
    _geometry()
    N = source.shape[0]
    grid = track_grid(N, dev)
    buf = source.new_empty((PACKED + grid * TRACK_SUMS,))      # out | block partials
    (W1, b1), (W2, b2) = layers
    gm_d, gm_g = float(tc.GM_dist), float(tc.GM_grad)
    fl = (ctypes.c_float * 25)(
        *R.reshape(9).tolist(), *t.reshape(3).tolist(), *origin.reshape(3).tolist(),
        sdf_scale, mc.max_valid_dist2, mc.idw_eps, gm_d, gm_d * gm_d, gm_g, gm_g * gm_g,
        tc.min_grad_norm, tc.max_grad_norm, tc.surface_sample_range * tc.max_sdf_std_ratio)
    ints = (ctypes.c_int * 12)(N, M, k, F, H, mc.local_capacity, lm.geo_features.stride(0),
                               lm.attr_rows.stride(0), int(tc.mask_min_nn_count),
                               int(mc.weighted_first), int(mc.layer_norm_on), int(after_pgo))
    # W1 and W2 are views of nn.Linear's (H, F + 3) and (1, H) weights: the
    # kernel reads W1 (in, H) at [d + u * (F + 3)]
    ptrs = (ctypes.c_void_p * 17)(
        source.data_ptr(), source_valid.data_ptr(), cache.xs.data_ptr(), cache.ys.data_ptr(),
        cache.zs.data_ptr(), cache.lidx.data_ptr(), lm.geo_features.data_ptr(),
        lm.attr_rows.data_ptr(), W1.data_ptr(), _ptr(b1), W2.data_ptr(), _ptr(b2),
        _ptr(source_normals),
        _ptr(source_normal_valid), buf.data_ptr(), buf.data_ptr() + 4 * PACKED,
        _ticket(dev).data_ptr())
    f = _cuda.fn("track_step", "track_step_launch", _ARGS)
    _cuda.check(f(fl, ints, ptrs, grid, _cuda.stream_ptr(dev)), "track_step_kernel")
    _cuda.COUNTS["track_step"] += 1
    return buf[:PACKED]
