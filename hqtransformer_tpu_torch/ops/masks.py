"""Attention mask constructors used on the slice's path, as bool tensors.

True = attend, False = blocked (the attention op turns it into a -1e10
score). Counterparts of `causal`, `parallel_2level`, `level3` and
`level3_decode` in the JAX package's `ops/masks.py`.
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


LEVEL3_LEN = 1 + 4 + 16  # a 3-level cell: one top, 4 mid and 16 bottom codes


def level3(parallel_type: str,
           device: Optional[torch.device] = None) -> torch.Tensor:
    """The 21x21 depth mask of 3-level models. 'tree' / 'quad': the top
    sees itself, the mids see the top and the mids, each group of 4
    bottoms sees itself, its parent mid and the top. 'parallel': the same
    for top and mids, and the bottoms see everything."""
    tm = LEVEL3_LEN
    mask = torch.zeros((tm, tm), dtype=torch.bool, device=device)
    mask[0, 0] = True
    mask[1:5, 0:5] = True
    if parallel_type in ('tree', 'quad'):
        for i in range(4):
            lo, hi = 5 + 4 * i, 5 + 4 * (i + 1)
            mask[lo:hi, lo:hi] = True
            mask[lo:hi, 0] = True
            mask[lo:hi, 1 + i] = True
    elif parallel_type == 'parallel':
        mask[5:, :] = True
    else:
        raise ValueError(parallel_type)
    return mask


def level3_decode(parallel_type: str, t_past: int, t: int,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """The rows [t_past, t_past + t) of `level3`, over its first
    t_past + t columns: the mask of t new depth tokens against t_past
    cached ones."""
    return level3(parallel_type, device)[t_past:t_past + t, :t_past + t]
