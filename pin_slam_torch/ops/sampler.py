"""Along-ray sampling for SDF supervision, torch counterpart of
``pin_slam_tpu/ops/sampler.py``: per ray the exact endpoint, ``n_surf``
Gaussian close-to-surface samples, ``n_front`` / ``n_behind`` uniform
free-space samples, ray-major layout [endpoint, surf x n, front, behind];
with colours, each ray's colour labels its surface samples."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    surface_sample_range_m: float = 0.25
    surface_sample_n: int = 3
    free_front_n: int = 2
    free_behind_n: int = 1
    free_sample_begin_ratio: float = 0.3
    free_sample_end_dist_m: float = 1.0
    sigma_base: float = 0.1
    dist_weight_on: bool = True
    dist_weight_scale: float = 0.8
    max_range: float = 60.0
    behind_dropoff_on: bool = False

    @property
    def ray_sample_count(self) -> int:
        return 1 + self.surface_sample_n + self.free_front_n + self.free_behind_n

    @staticmethod
    def from_config(cfg) -> "SamplerConfig":
        return SamplerConfig(
            surface_sample_range_m=cfg.surface_sample_range_m,
            surface_sample_n=cfg.surface_sample_n,
            free_front_n=cfg.free_front_n,
            free_behind_n=cfg.free_behind_n,
            free_sample_begin_ratio=cfg.free_sample_begin_ratio,
            free_sample_end_dist_m=cfg.free_sample_end_dist_m,
            sigma_base=cfg.sigma_sigmoid_m,
            dist_weight_on=cfg.dist_weight_on,
            dist_weight_scale=cfg.dist_weight_scale,
            max_range=cfg.max_range,
            behind_dropoff_on=cfg.behind_dropoff_on)


class SampleBatch(NamedTuple):
    coord: torch.Tensor      # (N*S, 3) sensor-frame sample positions (ray-major)
    sdf_label: torch.Tensor  # (N*S,)
    weight: torch.Tensor     # (N*S,) sign < 0 flags free space
    valid: torch.Tensor      # (N*S,) bool
    color_label: Optional[torch.Tensor] = None   # (N*S, C): the ray's colour on its
    #                                              surface samples, 0 on free space


def draw_ray_noise(gen: torch.Generator, sc: SamplerConfig, n: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(standard normal (n, n_surf), uniform (n, n_front), uniform (n, n_behind))."""
    return (torch.randn((n, sc.surface_sample_n), generator=gen, device=device),
            torch.rand((n, sc.free_front_n), generator=gen, device=device),
            torch.rand((n, sc.free_behind_n), generator=gen, device=device))


def sample_rays(sc: SamplerConfig, points: torch.Tensor, valid: torch.Tensor,
                draws: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                color: Optional[torch.Tensor] = None) -> SampleBatch:
    """points (N,3) sensor-frame ray endpoints (padded); valid (N,); draws from
    ``draw_ray_noise`` (tests hand in the JAX package's draws instead);
    color (N,C) the endpoints' colours or None."""
    n = points.shape[0]
    S = sc.ray_sample_count
    dev, dt = points.device, points.dtype
    normal, u_front, u_behind = draws
    dist = torch.linalg.norm(points, dim=1)
    safe_dist = torch.clamp(dist, min=1e-6)
    sigma_ratio = 2.0

    disp_surf = normal.to(dt) * sc.surface_sample_range_m
    disp_surface_block = torch.cat([torch.zeros((n, 1), dtype=dt, device=dev),
                                    disp_surf], dim=1)
    ratio_surface = disp_surface_block / safe_dist[:, None] + 1.0

    free_max_ratio = 1.0 - sigma_ratio * sc.surface_sample_range_m / safe_dist[:, None]
    ratio_front = (u_front.to(dt) * (free_max_ratio - sc.free_sample_begin_ratio)
                   + sc.free_sample_begin_ratio)
    disp_front = (ratio_front - 1.0) * safe_dist[:, None]

    behind_min = 1.0 + sigma_ratio * sc.surface_sample_range_m / safe_dist[:, None]
    behind_max = sc.free_sample_end_dist_m / safe_dist[:, None] + 1.0
    ratio_behind = u_behind.to(dt) * (behind_max - behind_min) + behind_min
    disp_behind = (ratio_behind - 1.0) * safe_dist[:, None]

    ratio = torch.cat([ratio_surface, ratio_front, ratio_behind], dim=1)
    disp = torch.cat([disp_surface_block, disp_front, disp_behind], dim=1)
    coord = points[:, None, :] * ratio[:, :, None]

    n_surf_tot = 1 + sc.surface_sample_n
    weight = torch.ones((n, S), dtype=dt, device=dev)
    if sc.dist_weight_on:
        w_dist = (1.0 + sc.dist_weight_scale * 0.5
                  - (dist / sc.max_range) * sc.dist_weight_scale)
        weight[:, :n_surf_tot] = w_dist[:, None]
    if sc.behind_dropoff_on:
        dropoff_min = 0.2 * sc.free_sample_end_dist_m
        dropoff_max = sc.free_sample_end_dist_m
        dw = torch.clamp((dropoff_max - disp) / (dropoff_max - dropoff_min), 0.0, 1.0)
        weight = weight * (dw * 0.8 + 0.2)
    free_flag = torch.arange(S, device=dev) >= n_surf_tot
    weight = torch.where(free_flag[None, :], -weight, weight)

    color_out = None
    if color is not None:
        surf = (torch.arange(S, device=dev) < n_surf_tot)[None, :, None]
        color_out = torch.where(surf, color[:, None, :], torch.zeros((), dtype=color.dtype,
                                                                     device=dev))
        color_out = color_out.reshape(n * S, -1)
    return SampleBatch(coord=coord.reshape(n * S, 3), sdf_label=(-disp).reshape(-1),
                       weight=weight.reshape(-1),
                       valid=valid[:, None].expand(n, S).reshape(-1), color_label=color_out)
