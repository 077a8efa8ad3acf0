"""Random streams drawn from a run's seed: every generator and the check
take their ``torch.Generator`` from here, one stream a purpose."""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one random stream of a run (``--seed`` may exceed
    32 bits)."""
    s = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), int(stream)])
    return int(s.generate_state(2, dtype=np.uint32).astype(np.uint64)
               .dot(np.array([1 << 32, 1], np.uint64)) >> np.uint64(1))


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g
