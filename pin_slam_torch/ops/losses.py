"""Training losses, torch counterpart of ``pin_slam_tpu/ops/losses.py``
(padding-aware means through a ``valid`` mask): the SDF's BCE, the eikonal
term and the colour head's L1 / L2."""

from __future__ import annotations

from typing import Optional

import torch


def _masked_mean(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return torch.mean(x)
    denom = torch.clamp(torch.sum(valid), min=1)
    return torch.sum(torch.where(valid, x, torch.zeros_like(x))) / denom


def sdf_bce_loss(pred: torch.Tensor, label: torch.Tensor, sigma: float,
                 weight: Optional[torch.Tensor] = None, weighted: bool = False,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCE-with-logits against the squashed label sigmoid(label/sigma)."""
    target = torch.sigmoid(label / sigma)
    logits = pred / sigma
    per = (torch.clamp(logits, min=0.0) - logits * target
           + torch.log1p(torch.exp(-torch.abs(logits))))
    if weighted and weight is not None:
        per = per * weight
    return _masked_mean(per, valid)


def eikonal_loss(grad: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE of |grad| against 1, epsilon-guarded norm."""
    norm = torch.sqrt(torch.sum(grad * grad, dim=-1) + 1e-12)
    return _masked_mean((norm - 1.0) ** 2, valid)


def color_diff_loss(pred: torch.Tensor, label: torch.Tensor,
                    weight: Optional[torch.Tensor] = None, weighted: bool = False,
                    l2: bool = False, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 (or L2) colour error, each sample times ``weight`` when
    ``weighted``; the mean over the ``valid`` samples' channels."""
    diff = pred - label
    per = diff ** 2 if l2 else torch.abs(diff)
    if weighted and weight is not None:
        per = per * weight[:, None]
    if valid is not None:
        valid = valid[:, None].expand(per.shape)
    return _masked_mean(per, valid)
