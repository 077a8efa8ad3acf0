"""Map persistence, the port's counterpart of ``save_implicit_map`` /
``load_implicit_map`` in ``pin_slam_tpu/utils/experiment.py``: the global
map's live rows and the decoder in one ``.npz`` with the JAX package's keys
and layouts (decoder weights as (in, out)), so each package loads the
other's file."""

from __future__ import annotations

import os
import types
from typing import Optional, Tuple

import numpy as np
import torch

from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.models.decoder import Decoder, decoder_from_jax
from pin_slam_torch.utils.platform import resolve_device


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_implicit_map(path: str, state: npts.MapState, decoder: Decoder,
                      extra: Optional[dict] = None) -> None:
    """Write the map's first ``count`` rows and the geometry decoder."""
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
    layers = decoder.layers()
    for i, (W, b) in enumerate(layers):
        name = "out" if i == len(layers) - 1 else f"hidden_{i}"
        blob[f"decoder_geo_{name}_W"] = _np(W)
        if b is not None:
            blob[f"decoder_geo_{name}_b"] = _np(b)
    for k, v in (extra or {}).items():
        blob[f"extra_{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **blob)


def load_implicit_map(path: str, mc: npts.MapConfig,
                      device=None) -> Tuple[npts.MapState, Decoder]:
    """A saved map -> (a fresh MapState holding its rows with the hash
    rebuilt, the geometry decoder), on ``device``: the GPU unless the CPU
    is asked for (raises without one)."""
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
    state.count = torch.tensor(n, dtype=torch.int64, device=device)
    state = npts.recreate_hash(state, mc, int(blob["ts_create"].max(initial=0)))

    hidden, i = [], 0
    while f"decoder_geo_hidden_{i}_W" in blob:
        hidden.append((blob[f"decoder_geo_hidden_{i}_W"], blob.get(f"decoder_geo_hidden_{i}_b")))
        i += 1
    params = types.SimpleNamespace(
        hidden=tuple(hidden), out=(blob["decoder_geo_out_W"], blob.get("decoder_geo_out_b")))
    return state, decoder_from_jax(params, device)
