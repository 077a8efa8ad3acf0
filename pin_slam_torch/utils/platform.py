"""Device choice and the numeric precision policy of the PyTorch port.

Every entry point runs on the GPU unless the caller asks for the CPU: a
missing GPU raises instead of falling back silently.

Precision: the JAX package pins the highest matmul precision
(``pin_slam_tpu/utils/platform.py``) because several tiny matmuls carry
value-cast indices (exact only up to 2^24 in float32) and metric
coordinates.  TF32 keeps ~10 mantissa bits and would corrupt both, so the
port switches it off for matmuls and convolutions, once, here.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

ROADMAP_HINT = "not ported yet; see ROADMAP.md (PyTorch/CUDA port queues)"


def set_precision_policy() -> None:
    """Full float32 matmuls everywhere (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the GPU; the CPU only when asked for by name.

    Raises RuntimeError when a CUDA device is wanted and none is present."""
    set_precision_policy()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pin_slam_torch needs a CUDA device; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def not_ported(what: str) -> NotImplementedError:
    """The error every unported option raises."""
    return NotImplementedError(f"{what}: {ROADMAP_HINT}")
