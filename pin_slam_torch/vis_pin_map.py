"""Offline map inspector and mesher of the PyTorch port, the counterpart of
the repository's ``vis_pin_map.py`` (reference vis_pin_map.py:24-136): load
a saved implicit map, rebuild its hash, mesh it at any resolution and write
the PLY and a self-contained ``viewer.html``.

    python -m pin_slam_torch.vis_pin_map <run_dir_or_map.npz> [mc_res_m]
        [out_mesh.ply] [crop.ply] [--device cuda|cpu]

The map is loaded onto the GPU unless ``--device cpu`` is given.  The whole
map becomes one read-only query view and is meshed in 60 m chunks, with the
JAX script's map constants (voxel 0.3 m, k 6, blended features), so both
mesh the same function.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="mesh a saved pin_map.npz")
    ap.add_argument("map_path", help="a run directory or a pin_map.npz")
    ap.add_argument("mc_res_m", nargs="?", type=float, default=0.1)
    ap.add_argument("out_mesh", nargs="?", default=None)
    ap.add_argument("crop_ply", nargs="?", default=None,
                    help="mesh only the points inside this cloud's box (1 m margin)")
    ap.add_argument("--device", default=None,
                    help="torch device: the GPU by default, 'cpu' only when named")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pin_slam_torch.dataset import io as pio
    from pin_slam_torch.models import neural_points as npts
    from pin_slam_torch.ops.marching_cubes import vertex_normals
    from pin_slam_torch.slam.mesher import Mesher, MesherConfig, split_chunks
    from pin_slam_torch.utils.experiment import load_implicit_map
    from pin_slam_torch.utils.platform import resolve_device
    from pin_slam_torch.utils.viewer_html import export_html

    map_path = args.map_path
    if os.path.isdir(map_path):
        map_path = os.path.join(map_path, "map", "pin_map.npz")
    mc_res = args.mc_res_m
    out_mesh = args.out_mesh or os.path.join(os.path.dirname(map_path),
                                             f"mesh_{int(mc_res * 100)}cm.ply")
    dev = resolve_device(args.device)

    with np.load(map_path) as blob:
        n_pts = blob["positions"].shape[0]
        feature_dim = blob["geo_features"].shape[1]
        color_on = "color_features" in blob.files
    cap = 1 << max(12, (n_pts - 1).bit_length())
    mc = npts.MapConfig(
        capacity=cap, local_capacity=cap, hash_size=max(1 << 22, 4 * cap),
        voxel_size=0.3, feature_dim=feature_dim, color_on=color_on, nn_k=6,
        max_valid_dist2=3.0 * (3 * 0.3) ** 2, local_map_radius=1e6,
        travel_dist_window=1e9, local_hash_size=max(1 << 22, 4 * cap))
    state, geo, color, sem = load_implicit_map(map_path, mc, dev, color=True, semantic=True)
    print(f"[vis_pin_map] loaded {int(state.count)} neural points from {map_path}")

    with torch.no_grad():
        # the whole map as one read-only query view (the reference's global
        # query mode, vis_pin_map.py:70)
        lm = npts.build_query_view(state, mc, torch.zeros(3, device=dev), 1e6)
    offsets = torch.as_tensor(npts.neighbor_offsets(2, 0.2), device=dev)

    pts = state.positions[:int(state.count)].cpu().numpy()
    if args.crop_ply:
        d = pio.read_ply(args.crop_ply)
        crop = np.stack([d["x"], d["y"], d["z"]], 1)
        lo, hi = crop.min(0) - 1, crop.max(0) + 1
        pts = pts[((pts >= lo) & (pts <= hi)).all(1)]
        print(f"[vis_pin_map] cropped to {len(pts)} points inside {args.crop_ply}")

    mesher = Mesher(MesherConfig(mc_res_m=mc_res, mesh_min_nn=8, query_bucket=1 << 17),
                    mc, offsets)
    chunks = split_chunks(pts, chunk_m=60.0, pad=1.0)
    print(f"[vis_pin_map] reconstructing {len(chunks)} chunk(s) at {mc_res} m ...")
    out = mesher.recon_aabb_collections_mesh(lm, geo, 0.055, chunks, color_decoder=color,
                                             sem_decoder=sem)
    verts, faces = out[:2]
    colors = out[2] if len(out) == 4 else None
    print(f"[vis_pin_map] mesh: {len(verts)} vertices, {len(faces)} faces")

    if len(verts):
        pio.write_ply(out_mesh, verts, colors=colors, normals=vertex_normals(verts, faces),
                      faces=faces)
        print(f"[vis_pin_map] wrote {out_mesh}")

    viewer = os.path.join(os.path.dirname(out_mesh) or ".", "viewer.html")
    export_html(viewer, neural_points=pts,
                mesh_verts=verts if len(verts) else None,
                mesh_faces=faces if len(verts) else None,
                mesh_colors=colors if len(verts) else None)
    print(f"[vis_pin_map] wrote {viewer}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
