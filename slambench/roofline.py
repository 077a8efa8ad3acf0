"""The chip's peaks and the least time of the work the benchmark counts.

Copied from ``chip_smoke.py`` (``bound``, ``decode_flops``), whose kernel
table in PERF.md these numbers reproduce.  The work is counted from the
configuration and from counts the benchmark's wrappers take (training
iterations, tracker query points), never from which kernels ran, so a later
PR that fuses or replaces a kernel is read against the same yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the card's full 700 W power limit
H100_BYTES_PER_S = 3.35e12        # HBM3
H100_F32_FLOPS = 67e12            # float32 outside the tensor cores


def bound(nbytes: float, flops: float):
    """(least milliseconds, what bounds it): the larger of the bytes over the
    memory bandwidth and the operations over the float32 peak."""
    tb, tf = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def decode_flops(F: int, H: int, vd: int) -> int:
    """Float32 operations one decode of a training step needs at F features,
    H hidden units and offset width ``vd`` (IN = F + vd inputs): the forward
    (IN x H FMAs, H bias adds, H FMAs into the output), dh (H), the input
    gradient of the F feature columns only (F x H FMAs: the offset vectors
    take none), and the decoder-gradient sums (IN x H + H FMAs, H adds)."""
    IN = F + vd
    return (2 * IN * H + 3 * H) + H + 2 * F * H + (2 * IN * H + 3 * H)


def query_flops(F: int, H: int, vd: int) -> int:
    """Float32 operations of one decode of the tracker's SDF query with its
    gradient in the query point: the forward (2 IN H + 3 H), dh (H) and the
    gradient of the ``vd`` offset inputs (vd x H FMAs)."""
    IN = F + vd
    return (2 * IN * H + 3 * H) + H + 2 * vd * H


def train_iteration_work(B: int, k: int, F: int, H: int, vd: int, n_grad: int,
                         weighted_first: bool):
    """(flops, bytes) of one training iteration: B rows of k neighbours (one
    decode a row when the features are blended first, else k), and, with the
    eikonal term, n_grad rows of a six-point stencil.  Bytes: each input
    read once and each output written once (the rows' features, weights,
    offsets, labels and loss weights, the decoder, the feature gradients
    and the decoder gradient); the eikonal's stencil weights and offsets
    likewise."""
    per_row = 1 if weighted_first else k
    P = (F + vd) * H + 2 * H + 1
    flops = B * per_row * decode_flops(F, H, vd) + (2 * B * k * F if weighted_first else 2 * B * k)
    vcols = vd if weighted_first else k * vd
    nbytes = 4 * (2 * B * k * (F + 1) + B * k + B * vcols + 2 * B + 2 * P)
    if n_grad:
        flops += 6 * n_grad * per_row * decode_flops(F, H, vd)
        nbytes += 4 * (2 * n_grad * k * (F + 1) + 6 * n_grad * k + 6 * n_grad * vcols
                       + n_grad + 2 * P)
    return flops, nbytes
