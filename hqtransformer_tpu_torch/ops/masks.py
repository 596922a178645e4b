"""Attention mask constructors used on the slice's path, as bool tensors.

True = attend, False = blocked (the attention op turns it into a -1e10
score). Counterparts of `causal` and `parallel_2level` in the JAX package's
`ops/masks.py`.
"""

from __future__ import annotations

from typing import Optional

import torch


def causal(t: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """Standard lower-triangular mask [t, t]."""
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def parallel_2level(t: int, parallel_len: int,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Depth-transformer mask for 2-level models: token 0 (sos+h) sees only
    itself; each group of `parallel_len` bottom positions sees everything up
    to and including its own group."""
    mask = torch.zeros((t, t), dtype=torch.bool, device=device)
    mask[0, 0] = True
    if t > parallel_len:
        win = parallel_len
        for si in range((t - 1) // win):
            mask[1 + si * win:(si + 1) * win + 1, 0:win * (si + 1) + 1] = True
    return mask
