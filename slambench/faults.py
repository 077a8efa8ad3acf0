"""The control and the faults: the timed path broken underneath, to show
that the check fails them.

Each plant takes the built ``SlamSystem`` and returns a function that
undoes it.  ``CONTROL`` breaks a guarantee every configuration states,
that every frame is registered against the map: the tracker returns its
initial guess (from the first frame on, the motion model's guess of no
motion), which the pipeline takes as a valid registration.  The faults
are those a SLAM cell can have: a step that returns its state unchanged
(the training returns the map it was given; the map update inserts
nothing) and an answer altered where it is produced (one frame's pose
moved by a metre).
"""

from __future__ import annotations

from typing import Callable, Dict

from slambench.harness import patch_attr as _patch


def train_off(system):
    """Every training call returns the features, the decoder and the
    optimiser's state it was given."""
    import torch

    F = system.mc.feature_dim

    def skipped(lm, feats, gvec, opt, frame_id, chunk, use_new, dec_scale, num_iters,
                color=None):
        lm.geo_features = feats[:, :F]
        return lm, feats, gvec, opt, torch.zeros(num_iters, device=feats.device)
    return _patch(system, "_train", skipped)


def track_off(system):
    """The tracker returns its initial guess as a valid registration."""
    import torch

    from pin_slam_torch.slam import tracker as trk

    def guess(lm, mc, tc, decoder, sdf_scale, offsets, source, source_valid, R_init, t_init,
              **kw):
        return trk.TrackResult(R=torch.as_tensor(R_init, dtype=torch.float32).reshape(3, 3),
                               t=torch.as_tensor(t_init, dtype=torch.float32).reshape(3),
                               valid=True, converged=True, iterations=0, sdf_residual_cm=1.0,
                               valid_count=int(source_valid.sum()), min_eigenvalue=1.0,
                               cov=torch.eye(6) * 1e-4)
    return _patch(trk, "track_frame", guess)


def map_update_off(system):
    """The map update inserts nothing: the frame trains on the map as it
    was."""
    def unchanged(points, valid, pose_R, pose_t, frame_id, colors=None, sem_labels=None):
        return system.lm
    return _patch(system, "_frame_update", unchanged)


def pose_jump(system, at_call: int = 8, shift_m: float = 1.0):
    """The ``at_call``-th registration's pose moved by ``shift_m`` along x."""
    import torch

    from pin_slam_torch.slam import tracker as trk

    orig = trk.track_frame
    calls = {"n": 0}

    def shifted(*a, **kw):
        res = orig(*a, **kw)
        calls["n"] += 1
        if calls["n"] == at_call:
            res = res._replace(t=res.t + torch.tensor([shift_m, 0.0, 0.0]))
        return res
    return _patch(trk, "track_frame", shifted)


CONTROL = "track_off"
PLANTS: Dict[str, Callable] = {"train_off": train_off, "track_off": track_off,
                               "map_update_off": map_update_off, "pose_jump": pose_jump}
