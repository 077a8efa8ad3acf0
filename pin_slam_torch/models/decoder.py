"""Shared tiny MLP decoder, torch counterpart of ``pin_slam_tpu/models/decoder.py``:
``Linear(F+3 -> H) -> ReLU -> [Linear(H->H) -> ReLU]* -> Linear(H -> out)``,
SDF head scaled by ``sdf_scale`` under the BCE loss; the colour head's
output clipped to [0, 1] (``regress_color``), and the blend of a head's
predictions in either interpolation mode (``blended_head``)."""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn


class Decoder(nn.Module):
    """Linear layers with torch.nn.Linear's default U(+-1/sqrt(fan_in)) init,
    drawn from an explicit ``torch.Generator``."""

    def __init__(self, in_dim: int, hidden_dim: int, hidden_level: int,
                 out_dim: int, bias_on: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * hidden_level
        self.hidden = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], bias=bias_on) for i in range(hidden_level))
        self.out = nn.Linear(dims[-1], out_dim, bias=bias_on)
        with torch.no_grad():
            for lin in list(self.hidden) + [self.out]:
                bound = 1.0 / math.sqrt(lin.in_features)
                lin.weight.uniform_(-bound, bound, generator=generator)
                if lin.bias is not None:
                    lin.bias.uniform_(-bound, bound, generator=generator)
        if device is not None:
            self.to(device)

    def layers(self) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """[(W (in,out), b)] in the JAX package's layout, hidden layers first,
        output layer last."""
        return [(lin.weight.T, lin.bias) for lin in list(self.hidden) + [self.out]]

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for lin in self.hidden:
            h = torch.relu(lin(h))
        return self.out(h)

    forward = mlp

    def sdf(self, features: torch.Tensor, sdf_scale: float) -> torch.Tensor:
        return self.mlp(features)[..., 0] * sdf_scale

    def blended_sdf(self, features: torch.Tensor, weights: torch.Tensor,
                    weighted_first: bool, sdf_scale: float):
        """(sdf [B], std [B]) under either interpolation mode."""
        if weighted_first:
            out = self.sdf(features, sdf_scale)
            return out, torch.zeros_like(out)
        per = self.sdf(features, sdf_scale)
        mean = torch.sum(per * weights, dim=-1)
        var = torch.sum(weights * (per - mean[..., None]) ** 2, dim=-1)
        return mean, torch.sqrt(torch.clamp(var, min=0.0))

    # ---- packed vector [W1 (in,H) | b1 | W2 (H,1) | b2] of the one-hidden-
    # layer SDF decoder, the training loop's Adam leaf (mapper.mapping_loop_cached)
    def pack(self) -> torch.Tensor:
        if len(self.hidden) != 1 or self.hidden[0].bias is None or self.out.bias is None:
            raise NotImplementedError("packed decoder needs 1 hidden layer with biases")
        W1, b1 = self.hidden[0].weight.T, self.hidden[0].bias
        W2, b2 = self.out.weight.T, self.out.bias
        return torch.cat([W1.reshape(-1), b1, W2.reshape(-1), b2]).detach().clone()

    def load_packed(self, vec: torch.Tensor) -> None:
        W1, b1, W2, b2 = unpack(vec, self.hidden[0].in_features,
                                self.hidden[0].out_features)
        with torch.no_grad():
            self.hidden[0].weight.copy_(W1.T)
            self.hidden[0].bias.copy_(b1)
            self.out.weight.copy_(W2.T)
            self.out.bias.copy_(b2)


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``x`` clipped to [0, 1] as ``min(max(x, 0), 1)``: torch's maximum /
    minimum split the gradient in half at a tie, as JAX's clip does
    (``torch.clamp`` would pass it whole at 0 and 1)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def regress_color(decoder: Decoder, features: torch.Tensor) -> torch.Tensor:
    """The colour head's prediction, clipped to [0, 1] (``clip01``)."""
    return clip01(decoder.mlp(features))


def blended_head(head_fn, decoder: Decoder, features: torch.Tensor, weights: torch.Tensor,
                 weighted_first: bool) -> torch.Tensor:
    """A colour / semantic head's prediction: one decode of the blended
    features [B, F+3] (``weighted_first``), or the IDW blend of the k
    per-neighbour predictions of features [B, k, F+3]."""
    if weighted_first:
        return head_fn(decoder, features)
    return torch.sum(head_fn(decoder, features) * weights[..., None], dim=-2)


def unpack(vec: torch.Tensor, in_dim: int, H: int):
    """Packed decoder vector -> (W1 (in,H), b1 (H,), W2 (H,1), b2 (1,)) views."""
    n1 = in_dim * H
    return (vec[:n1].view(in_dim, H), vec[n1:n1 + H],
            vec[n1 + H:n1 + 2 * H].view(H, 1), vec[n1 + 2 * H:n1 + 2 * H + 1])


def params_from_jax(params) -> dict:
    """A JAX ``DecoderParams`` (given as numpy arrays: ``hidden`` = ((W, b),
    ...), ``out`` = (W, b), W laid out (in, out)) -> a ``Decoder`` state
    dict (nn.Linear weights are (out, in), so every W is transposed)."""
    state = {}
    for i, (W, b) in enumerate(params.hidden if hasattr(params, "hidden") else params[0]):
        state[f"hidden.{i}.weight"] = torch.as_tensor(_np(W)).T.contiguous()
        if b is not None:
            state[f"hidden.{i}.bias"] = torch.as_tensor(_np(b)).clone()
    W, b = params.out if hasattr(params, "out") else params[1]
    state["out.weight"] = torch.as_tensor(_np(W)).T.contiguous()
    if b is not None:
        state["out.bias"] = torch.as_tensor(_np(b)).clone()
    return state


def _np(a):
    return np.array(a, dtype=np.float32)


def decoder_from_jax(params, device=None) -> Decoder:
    """Build a ``Decoder`` whose weights equal the JAX decoder's."""
    state = params_from_jax(params)
    hidden = [k for k in state if k.startswith("hidden.") and k.endswith(".weight")]
    H, in_dim = state["hidden.0.weight"].shape
    out_dim = state["out.weight"].shape[0]
    dec = Decoder(in_dim, H, len(hidden), out_dim, bias_on="out.bias" in state)
    dec.load_state_dict(state)
    return dec.to(device) if device is not None else dec
