"""Isosurface extraction from a masked SDF grid (host-side, vectorized numpy),
the port's copy of ``pin_slam_tpu/ops/marching_cubes.py``.

*Marching tetrahedra*: each grid cell is split into 6 tetrahedra; every tet
has at most 2 triangles and the case logic is derivable (no 256-entry
tables).  The output is watertight across cells, with vertices deduplicated
per grid edge.  Masked-out cells are skipped like skimage's ``mask``
argument (a cell contributes only if all 8 corners are valid).  When the
optional host extension built from ``native/pin_native.cpp`` is loadable
(``pin_slam_torch.utils.native``) the extraction runs there, unless the
environment sets ``PIN_NATIVE=0``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# 6 tetrahedra per cube (indices into the 8 cube corners, consistent winding)
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64)
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
     [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], dtype=np.int64)


def marching_tetrahedra(sdf: np.ndarray, mask: Optional[np.ndarray] = None,
                        origin=(0.0, 0.0, 0.0), spacing: float = 1.0,
                        iso: float = 0.0, use_native: Optional[bool] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of ``sdf`` [nx,ny,nz].

    Returns (vertices [V,3] float32 in world units, faces [F,3] int64).
    Dispatches to the C++ extension (native/pin_native.cpp) when it is
    loadable: the same tetrahedral decomposition, not bit-equal to this numpy
    version (vertex counts within 2, face counts within 4 on a sphere).
    """
    import os

    from pin_slam_torch.utils import native

    if use_native is None:
        use_native = os.environ.get("PIN_NATIVE", "1") != "0" and native.available()
    if use_native and min(sdf.shape) >= 2:
        return native.marching_tetrahedra(sdf, mask, origin, spacing, iso)
    nx, ny, nz = sdf.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    s = sdf.astype(np.float64) - iso

    # corner ids of every cell, flattened grid index = (i*ny + j)*nz + k
    ii, jj, kk = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
                             indexing="ij")
    base = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)        # (C,3)

    corner_idx = ((base[:, None, 0] + _CUBE_CORNERS[None, :, 0]) * ny
                  + (base[:, None, 1] + _CUBE_CORNERS[None, :, 1])) * nz \
        + (base[:, None, 2] + _CUBE_CORNERS[None, :, 2])          # (C,8)

    flat = s.reshape(-1)
    if mask is not None:
        mflat = mask.reshape(-1)
        cell_ok = mflat[corner_idx].all(axis=1)
    else:
        cell_ok = np.ones(corner_idx.shape[0], dtype=bool)
    # quick reject: cells without a sign change contribute nothing
    vals8 = flat[corner_idx]
    sign_change = (vals8.min(axis=1) < 0) & (vals8.max(axis=1) >= 0)
    cells = np.nonzero(cell_ok & sign_change)[0]
    if cells.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    corner_idx = corner_idx[cells]                                # (Cc,8)

    # expand to tetrahedra: (Cc, 6, 4) global grid-node ids
    tet_nodes = corner_idx[:, _TETS]                              # (Cc,6,4)
    tet_nodes = tet_nodes.reshape(-1, 4)                          # (T,4)
    tv = flat[tet_nodes]                                          # (T,4)
    inside = tv < 0                                               # (T,4) bool
    code = (inside * np.array([1, 2, 4, 8])).sum(axis=1)          # (T,)

    # per-code triangle recipes: each triangle = 3 edges, each edge = (a,b)
    # vertex indices within the tet.  Codes 0 and 15 produce nothing.
    # one-inside cases (1 tri), two-inside cases (2 tris), complements mirror.
    TRI = {
        1: [[(0, 1), (0, 2), (0, 3)]],
        2: [[(1, 0), (1, 3), (1, 2)]],
        4: [[(2, 0), (2, 1), (2, 3)]],
        8: [[(3, 0), (3, 2), (3, 1)]],
        3: [[(0, 2), (0, 3), (1, 3)], [(0, 2), (1, 3), (1, 2)]],
        5: [[(0, 1), (2, 3), (0, 3)], [(0, 1), (2, 1), (2, 3)]],
        9: [[(0, 1), (0, 2), (3, 2)], [(0, 1), (3, 2), (3, 1)]],
        6: [[(1, 0), (2, 0), (2, 3)], [(1, 0), (2, 3), (1, 3)]],
        10: [[(1, 0), (1, 2), (3, 2)], [(3, 0), (1, 0), (3, 2)]],
        12: [[(2, 0), (3, 0), (3, 1)], [(2, 1), (2, 0), (3, 1)]],
        14: [[(1, 0), (2, 0), (3, 0)]],
        13: [[(0, 1), (3, 1), (2, 1)]],
        11: [[(0, 2), (1, 2), (3, 2)]],
        7: [[(0, 3), (2, 3), (1, 3)]],
    }

    tri_edges = []  # list of (T_sel, 3, 2) node-id pairs
    for c, recipes in TRI.items():
        sel = np.nonzero(code == c)[0]
        if sel.size == 0:
            continue
        for tri in recipes:
            ab = np.array(tri)                                    # (3,2) local vert ids
            a = tet_nodes[sel][:, ab[:, 0]]                       # (S,3) global node ids
            b = tet_nodes[sel][:, ab[:, 1]]
            tri_edges.append(np.stack([a, b], axis=-1))           # (S,3,2)
    if not tri_edges:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    E = np.concatenate(tri_edges, axis=0)                         # (F,3,2)
    # canonical edge key (sorted node pair) for dedup
    lo = np.minimum(E[..., 0], E[..., 1])
    hi = np.maximum(E[..., 0], E[..., 1])
    key = lo.astype(np.uint64) * np.uint64(nx * ny * nz) + hi.astype(np.uint64)
    uniq, inv = np.unique(key.reshape(-1), return_inverse=True)
    faces = inv.reshape(-1, 3)

    ulo = (uniq // np.uint64(nx * ny * nz)).astype(np.int64)
    uhi = (uniq % np.uint64(nx * ny * nz)).astype(np.int64)
    va, vb = flat[ulo], flat[uhi]
    t = va / (va - vb)
    t = np.clip(np.nan_to_num(t, nan=0.5), 0.0, 1.0)

    def node_xyz(idx):
        k = idx % nz
        j = (idx // nz) % ny
        i = idx // (ny * nz)
        return np.stack([i, j, k], axis=-1).astype(np.float64)

    verts = node_xyz(ulo) + t[:, None] * (node_xyz(uhi) - node_xyz(ulo))
    verts = verts * spacing + np.asarray(origin, dtype=np.float64)

    # drop degenerate faces (two identical vertex ids)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts.astype(np.float32), faces[good]


def filter_isolated_vertices(verts: np.ndarray, faces: np.ndarray,
                             min_cluster: int = 200) -> Tuple[np.ndarray, np.ndarray]:
    """Remove connected components with fewer than ``min_cluster`` vertices
    (ref utils/mesher.py:367-378)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = verts.shape[0]
    if n == 0 or faces.shape[0] == 0:
        return verts, faces
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    adj = coo_matrix((np.ones(e.shape[0]), (e[:, 0], e[:, 1])), shape=(n, n))
    ncomp, labels = connected_components(adj, directed=False)
    counts = np.bincount(labels, minlength=ncomp)
    keep_vert = counts[labels] >= min_cluster
    keep_face = keep_vert[faces].all(axis=1)
    faces = faces[keep_face]
    # reindex
    remap = -np.ones(n, dtype=np.int64)
    kept = np.nonzero(keep_vert)[0]
    remap[kept] = np.arange(kept.size)
    return verts[kept], remap[faces]


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    vn = np.zeros_like(verts, dtype=np.float64)
    if faces.shape[0]:
        fv = verts[faces].astype(np.float64)
        fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        for i in range(3):
            np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)
