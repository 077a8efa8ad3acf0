"""Experiment runtime, the port's counterpart of
``pin_slam_tpu/utils/experiment.py``: the run directory (``setup_experiment``)
and map persistence (``save_implicit_map`` / ``load_implicit_map``: the
global map's live rows, with a colour head its colour features, and the
decoders (geometry, semantic, colour) in one ``.npz`` with the JAX package's keys and layouts (decoder
weights as (in, out)), so each package loads the other's file)."""

from __future__ import annotations

import json
import os
import subprocess
import time
import types
from typing import Optional

import numpy as np
import torch

from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.models.decoder import Decoder, decoder_from_jax
from pin_slam_torch.utils.platform import resolve_device


def setup_experiment(cfg, argv=None, create: bool = True) -> str:
    """Create ``<output_root>/<name>_<timestamp>/`` with ``map/``, ``mesh/``
    and ``meta/``, set ``cfg.run_path`` / ``cfg.run_name``, seed numpy's
    global generator and torch's with ``cfg.seed``, and write
    ``meta/run.json`` (argv, seed, time, and the checkout's git commit when
    there is one).  Returns the run path.  ``create`` False (a rank that
    writes nothing) only names the run and seeds."""
    ts = time.strftime("%Y-%m-%d_%H-%M-%S")
    run_name = f"{cfg.name}_{ts}"
    run_path = os.path.join(cfg.output_root or "./experiments", run_name)
    cfg.run_path = run_path
    cfg.run_name = run_name
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    if not create:
        return run_path
    for sub in ("map", "mesh", "meta"):
        os.makedirs(os.path.join(run_path, sub), exist_ok=True)
    meta = {"argv": argv or [], "seed": cfg.seed, "time": ts}
    try:
        meta["git_commit"] = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL,
            cwd=os.path.dirname(os.path.abspath(__file__))).decode().strip()
    except Exception:
        pass
    with open(os.path.join(run_path, "meta", "run.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return run_path


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_implicit_map(path: str, state: npts.MapState, decoder: Decoder,
                      extra: Optional[dict] = None,
                      color_decoder: Optional[Decoder] = None,
                      sem_decoder: Optional[Decoder] = None) -> None:
    """Write the map's first ``count`` rows (with their colour features
    where the map has them), the geometry decoder, and the semantic and
    colour decoders when given."""
    n = int(state.count)
    attr = state.attr_rows[:n]
    blob = {
        "positions": _np(attr[:, npts.C_POS]),
        "orientations": _np(attr[:, npts.C_QUAT]),
        "geo_features": _np(state.geo_features[:n]),
        "ts_create": _np(attr[:, npts.C_TSC].to(torch.int32)),
        "ts_update": _np(attr[:, npts.C_TSU].to(torch.int32)),
        "certainties": _np(attr[:, npts.C_CERT]),
    }
    if state.color_features is not None:
        blob["color_features"] = _np(state.color_features[:n])
    for head, dec in (("geo", decoder), ("sem", sem_decoder), ("color", color_decoder)):
        if dec is None:
            continue
        layers = dec.layers()
        for i, (W, b) in enumerate(layers):
            name = "out" if i == len(layers) - 1 else f"hidden_{i}"
            blob[f"decoder_{head}_{name}_W"] = _np(W)
            if b is not None:
                blob[f"decoder_{head}_{name}_b"] = _np(b)
    for k, v in (extra or {}).items():
        blob[f"extra_{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **blob)


def load_implicit_map(path: str, mc: npts.MapConfig, device=None,
                      color: bool = False, semantic: bool = False):
    """A saved map -> (a fresh MapState holding its rows with the hash
    rebuilt, the geometry decoder), on ``device``: the GPU unless the CPU
    is asked for (raises without one).  With ``color`` the colour decoder
    (or None) follows, and the state holds the file's colour features
    (``mc.color_on``); with ``semantic`` the semantic decoder (or None)
    comes last.  The file records no encoder: the decoders' width must be
    ``mc``'s ``feature_dim + vec_dim``, as the JAX package builds them."""
    device = resolve_device(device)
    blob = dict(np.load(path, allow_pickle=False))
    n = blob["positions"].shape[0]
    if n > mc.capacity:
        raise ValueError(f"saved map ({n} points) exceeds the map capacity {mc.capacity}")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    state = npts.init_map_state(mc, device)
    attr = state.attr_rows
    attr[:n, npts.C_POS] = t(blob["positions"])
    attr[:n, npts.C_QUAT] = t(blob["orientations"])
    attr[:n, npts.C_CERT] = t(blob["certainties"])
    attr[:n, npts.C_TSC] = t(blob["ts_create"])
    attr[:n, npts.C_TSU] = t(blob["ts_update"])
    state.geo_features[:n] = t(blob["geo_features"])
    if "color_features" in blob and state.color_features is not None:
        state.color_features[:n] = t(blob["color_features"])
    state.count = torch.tensor(n, dtype=torch.int64, device=device)
    state = npts.recreate_hash(state, mc, int(blob["ts_create"].max(initial=0)))
    geo = _decoder_of(blob, "geo", device)
    want = mc.feature_dim + mc.vec_dim
    if geo is not None and geo.hidden[0].in_features != want:
        raise ValueError(f"the saved decoder reads {geo.hidden[0].in_features} inputs; this "
                         f"configuration's features and offset encoding give {want}")
    out = (state, geo)
    if color:
        out += (_decoder_of(blob, "color", device),)
    if semantic:
        out += (_decoder_of(blob, "sem", device),)
    return out


def _decoder_of(blob: dict, head: str, device) -> Optional[Decoder]:
    """The ``decoder_<head>_*`` arrays of a saved map as a Decoder, or None."""
    if f"decoder_{head}_out_W" not in blob:
        return None
    hidden, i = [], 0
    while f"decoder_{head}_hidden_{i}_W" in blob:
        hidden.append((blob[f"decoder_{head}_hidden_{i}_W"],
                       blob.get(f"decoder_{head}_hidden_{i}_b")))
        i += 1
    params = types.SimpleNamespace(
        hidden=tuple(hidden),
        out=(blob[f"decoder_{head}_out_W"], blob.get(f"decoder_{head}_out_b")))
    return decoder_from_jax(params, device)
