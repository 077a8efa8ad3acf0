"""Positional encoders of the query-to-neighbour offset vector, torch
counterpart of ``pin_slam_tpu/ops/encodings.py``: NeRF sine/cosine ladders
and Gaussian Fourier features, applied to the (..., 3) offset vectors
before they are concatenated to the neighbour features.  The Gaussian
projection comes from a fixed numpy seed, so a saved map decodes the same
after a reload in either package (the file records no encoder)."""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Optional

import numpy as np
import torch


def encoded_dim(in_dim: int, bands: int, gaussian: bool) -> int:
    """Output width of the encoder; ``in_dim`` when encoding is off."""
    if bands <= 0:
        return in_dim
    if gaussian:
        return in_dim + 2 * bands
    return in_dim * (2 * bands + 1)


@lru_cache(maxsize=8)
def _nerf_scales(bands: int, freq: float, base: float) -> np.ndarray:
    """logspace(0, log_base(freq / 2), bands): the geometric frequency ladder."""
    hi = np.log(freq / 2.0) / np.log(base)
    return (base ** np.linspace(0.0, hi, bands)).astype(np.float32)


@lru_cache(maxsize=8)
def _gaussian_B(in_dim: int, bands: int, freq: float, seed: int) -> np.ndarray:
    """The fixed projection (in_dim, bands), N(0, freq^2), from ``seed``."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((in_dim, bands)) * freq).astype(np.float32)


def positional_encode(x: torch.Tensor, bands: int, freq: float, base: float,
                      gaussian: bool, seed: int = 42) -> torch.Tensor:
    """x (..., D) -> (..., encoded_dim(D, bands, gaussian)).  NeRF: per input
    dimension ``[sin(pi s_0 x) .. sin(pi s_B x), cos(pi s_0 x) .. cos(pi s_B x),
    x]``, flattened over the dimensions; Gaussian: ``[x, sin(2 pi x @ B),
    cos(2 pi x @ B)]``.  Identity when ``bands <= 0``."""
    if bands <= 0:
        return x
    if gaussian:
        B = torch.as_tensor(_gaussian_B(x.shape[-1], bands, float(freq), seed), device=x.device)
        proj = (2.0 * math.pi) * (x @ B)
        return torch.cat([x, torch.sin(proj), torch.cos(proj)], -1)
    scales = torch.as_tensor(_nerf_scales(bands, float(freq), float(base)), device=x.device)
    xs = x[..., None] * scales * math.pi                       # (..., D, bands)
    enc = torch.cat([torch.sin(xs), torch.cos(xs), x[..., None]], -1)
    return enc.reshape(*x.shape[:-1], x.shape[-1] * (2 * bands + 1))


def encoder(bands: int, freq: float, base: float,
            gaussian: bool) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The offset vectors' encoder of a configuration, or None when off."""
    if bands <= 0:
        return None
    return lambda v: positional_encode(v, bands, float(freq), float(base), gaussian)
