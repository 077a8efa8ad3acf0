"""Mesh reconstruction from the implicit map, torch counterpart of
``pin_slam_tpu/slam/mesher.py``: SDF and neighbour-count queries on a regular
grid inside an axis-aligned box (on the map's device, in padded chunks of
``query_bucket`` points), a neighbour-count marching mask, isosurface
extraction on the host (``ops/marching_cubes.py``), and SDF slices.

The grid query is ``knn_search`` + ``interpolate_features`` +
``Decoder.blended_sdf`` as torch ops, as the JAX package's is XLA; it runs
no hand-written kernel.  With a colour head each box's vertices are painted
with the regressed colours at them (``paint_vertices``, in padded chunks of
``query_bucket`` on the same view).  Semantic painting and the
data-parallel query are not ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from pin_slam_torch.models import neural_points as npts
from pin_slam_torch.models.decoder import Decoder, blended_head, regress_color
from pin_slam_torch.ops import marching_cubes as mcubes
from pin_slam_torch.utils.platform import not_ported


@dataclasses.dataclass(frozen=True)
class MesherConfig:
    mc_res_m: float = 0.1
    pad_voxel: int = 2
    skip_top_voxel: int = 2
    mc_mask_on: bool = True
    mesh_min_nn: int = 8
    min_cluster_vertices: int = 200
    query_bucket: int = 1 << 18
    semantic_on: bool = False
    color_on: bool = False


def grid_query(lm: npts.LocalMap, mc: npts.MapConfig, decoder: Decoder, sdf_scale: float,
               offsets: torch.Tensor, pts: torch.Tensor):
    """SDF and neighbour count at ``pts`` (B, 3) on ``lm``'s device."""
    knn = npts.knn_search(lm, mc, pts, offsets)
    feat, w, _ = npts.interpolate_features(lm, mc, pts, knn.lidx)
    sdf, _ = decoder.blended_sdf(feat, w, mc.weighted_first, sdf_scale)
    return sdf, knn.nn_count


def grid_query_color(lm: npts.LocalMap, mc: npts.MapConfig, color_decoder: Decoder,
                     offsets: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The colour head's regressed colour at ``pts`` (B, 3): (B, C) in [0, 1]."""
    knn = npts.knn_search(lm, mc, pts, offsets)
    _, col, w, _ = npts.interpolate_features(lm, mc, pts, knn.lidx, query_color=True)
    return blended_head(regress_color, color_decoder, col, w, mc.weighted_first)


class Mesher:
    def __init__(self, cfg: MesherConfig, mc: npts.MapConfig, offsets: torch.Tensor,
                 dp_mesh=None):
        if cfg.semantic_on:
            raise not_ported("semantic vertex painting (ROADMAP A 11, the semantic head)")
        if dp_mesh is not None:
            raise not_ported("data-parallel mesh queries, dp_mesh (ROADMAP A 12)")
        self.cfg = cfg
        self.mc = mc
        self.offsets = offsets

    # ------------------------------------------------------------------
    def query_sdf_grid(self, lm, decoder: Decoder, sdf_scale: float,
                       coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Batched SDF query over world coords (N, 3) float32 (host numpy in
        and out; the queries run on ``lm``'s device)."""
        n = coords.shape[0]
        B = self.cfg.query_bucket
        dev = lm.attr_rows.device
        sdf_out = torch.zeros((n,), dtype=torch.float32, device=dev)
        nn_out = torch.zeros((n,), dtype=torch.int64, device=dev)
        with torch.no_grad():
            for s in range(0, n, B):
                e = min(s + B, n)
                chunk = np.zeros((B, 3), np.float32)
                chunk[: e - s] = coords[s:e]
                sdf, nn = grid_query(lm, self.mc, decoder, sdf_scale, self.offsets,
                                     torch.as_tensor(chunk, device=dev))
                sdf_out[s:e] = sdf[: e - s]
                nn_out[s:e] = nn[: e - s]
        return sdf_out.cpu().numpy(), nn_out.to(torch.int32).cpu().numpy()

    def paint_vertices(self, lm, color_decoder: Decoder, verts: np.ndarray) -> np.ndarray:
        """The regressed colour at each vertex (V, 3) float32, queried on
        ``lm``'s device in padded chunks of ``query_bucket`` (a one-channel
        head is repeated to grey RGB)."""
        n = verts.shape[0]
        B = self.cfg.query_bucket
        dev = lm.attr_rows.device
        colors = np.zeros((n, 3), np.float32)
        with torch.no_grad():
            for s in range(0, n, B):
                e = min(s + B, n)
                chunk = np.zeros((B, 3), np.float32)
                chunk[: e - s] = verts[s:e]
                c = grid_query_color(lm, self.mc, color_decoder, self.offsets,
                                     torch.as_tensor(chunk, device=dev))[: e - s].cpu().numpy()
                colors[s:e] = c if c.shape[1] == 3 else np.repeat(c, 3, axis=1)
        return colors

    def recon_aabb_mesh(self, lm, decoder: Decoder, sdf_scale: float,
                        aabb_min: np.ndarray, aabb_max: np.ndarray,
                        color_decoder: Optional[Decoder] = None):
        """Reconstruct one box; returns (vertices [V,3] float32, faces [F,3]
        int64) in world coordinates, and with ``color_decoder`` (vertices,
        faces, vertex colours [V,3] float32 or None for an empty box)."""
        res = self.cfg.mc_res_m
        lo = np.floor(aabb_min / res) - self.cfg.pad_voxel
        hi = np.ceil(aabb_max / res) + self.cfg.pad_voxel
        hi[2] -= self.cfg.skip_top_voxel  # skip roof artifacts
        dims = np.maximum((hi - lo).astype(int) + 1, 2)
        ii = np.arange(dims[0]) + lo[0]
        jj = np.arange(dims[1]) + lo[1]
        kk = np.arange(dims[2]) + lo[2]
        grid = np.stack(np.meshgrid(ii, jj, kk, indexing="ij"), axis=-1).reshape(-1, 3) * res
        grid = grid.astype(np.float32)

        sdf, nn = self.query_sdf_grid(lm, decoder, sdf_scale, grid)
        sdf3 = sdf.reshape(dims)
        mask3 = (nn >= self.cfg.mesh_min_nn).reshape(dims) if self.cfg.mc_mask_on else None

        # the decoder is positive in free space: flip so "inside" is negative
        verts, faces = mcubes.marching_tetrahedra(-sdf3, mask3, origin=lo * res, spacing=res)
        if verts.shape[0] and self.cfg.min_cluster_vertices > 0:
            verts, faces = mcubes.filter_isolated_vertices(verts, faces,
                                                           self.cfg.min_cluster_vertices)
        if color_decoder is None:
            return verts, faces
        colors = self.paint_vertices(lm, color_decoder, verts) if verts.shape[0] else None
        return verts, faces, colors

    def recon_aabb_collections_mesh(self, lm, decoder: Decoder, sdf_scale: float,
                                    aabbs: List[Tuple[np.ndarray, np.ndarray]],
                                    color_decoder: Optional[Decoder] = None):
        """Chunked reconstruction over a list of boxes, one mesh.  ``lm`` is
        one view for every box, or a function ``(amin, amax) -> view`` that
        gives each box its own, built when the box is meshed.  Returns
        (vertices, faces), and with ``color_decoder`` (vertices, faces,
        vertex colours), each box painted on its own view."""
        all_v, all_f, all_c = [], [], []
        off = 0
        for amin, amax in aabbs:
            view = lm(amin, amax) if callable(lm) else lm
            out = self.recon_aabb_mesh(view, decoder, sdf_scale, amin, amax, color_decoder)
            v, f = out[:2]
            if v.shape[0] == 0:
                continue
            all_v.append(v)
            all_f.append(f + off)
            off += v.shape[0]
            if color_decoder is not None:
                all_c.append(out[2])
        if not all_v:
            empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
            return empty if color_decoder is None else empty + (np.zeros((0, 3), np.float32),)
        mesh = (np.concatenate(all_v), np.concatenate(all_f))
        return mesh if color_decoder is None else mesh + (np.concatenate(all_c),)

    # ------------------------------------------------------------------
    def sdf_slice(self, lm, decoder: Decoder, sdf_scale: float, center: np.ndarray,
                  extent: float, height: float, res: Optional[float] = None):
        """Horizontal SDF slice point cloud for visualisation."""
        res = res or self.cfg.mc_res_m
        xs = np.arange(center[0] - extent, center[0] + extent, res)
        ys = np.arange(center[1] - extent, center[1] + extent, res)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        pts = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, height)], axis=-1).astype(np.float32)
        sdf, nn = self.query_sdf_grid(lm, decoder, sdf_scale, pts)
        ok = nn >= 1
        return pts[ok], sdf[ok]


def split_chunks(points: np.ndarray, chunk_m: float = 100.0,
                 pad: float = 0.0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Partition a point cloud's bounding box into ~chunk_m-sized boxes in
    xy (full height), keeping those that hold a point."""
    if points.shape[0] == 0:
        return []
    lo, hi = points.min(0) - pad, points.max(0) + pad
    spans = np.maximum(hi - lo, 1e-6)
    n = np.maximum(np.ceil(spans[:2] / chunk_m).astype(int), 1)
    out = []
    for i in range(n[0]):
        for j in range(n[1]):
            amin = np.array([lo[0] + i * spans[0] / n[0], lo[1] + j * spans[1] / n[1], lo[2]])
            amax = np.array([lo[0] + (i + 1) * spans[0] / n[0],
                             lo[1] + (j + 1) * spans[1] / n[1], hi[2]])
            sel = ((points[:, 0] >= amin[0]) & (points[:, 0] < amax[0])
                   & (points[:, 1] >= amin[1]) & (points[:, 1] < amax[1]))
            if sel.any():
                out.append((amin, amax))
    return out
