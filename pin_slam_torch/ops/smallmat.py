"""Unrolled small-matrix routines, torch counterpart of
``pin_slam_tpu/ops/smallmat.py`` (same operation order, so float32 results
track the JAX package's closely)."""

from __future__ import annotations

import math

import torch


def cholesky_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a 6x6 SPD matrix via unrolled Cholesky."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def cholesky_inverse6(A: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    return torch.stack([cholesky_solve6(A, eye[:, i]) for i in range(6)], dim=1)


def sym_eigvals_min3(A: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue of a symmetric 3x3 matrix (trigonometric method)."""
    p1 = A[0, 1] ** 2 + A[0, 2] ** 2 + A[1, 2] ** 2
    q = (A[0, 0] + A[1, 1] + A[2, 2]) / 3.0
    p2 = (A[0, 0] - q) ** 2 + (A[1, 1] - q) ** 2 + (A[2, 2] - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    B = (A - q * torch.eye(3, dtype=A.dtype, device=A.device)) / p
    detB = (B[0, 0] * (B[1, 1] * B[2, 2] - B[1, 2] * B[2, 1])
            - B[0, 1] * (B[1, 0] * B[2, 2] - B[1, 2] * B[2, 0])
            + B[0, 2] * (B[1, 0] * B[2, 1] - B[1, 1] * B[2, 0]))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    diag_min = torch.minimum(torch.minimum(A[0, 0], A[1, 1]), A[2, 2])
    return torch.where(p1 < 1e-20, diag_min, lam_min)
