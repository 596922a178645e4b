"""Logits post-processing and categorical sampling for the decode loops.

Counterpart of `hqtransformer_tpu/ops/topk_topp.py::sample_from_logits`
for the nucleus-free path: temperature, top-k, then one inverse-CDF draw
per row, all in the fused sampling kernel (`ops/sample_topk.py`).
"""

from __future__ import annotations

from typing import Optional

import torch

from .sample_topk import sample_topk


def sample_from_logits(generator: torch.Generator, logits: torch.Tensor, *,
                       temperature: float = 1.0,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None,
                       bisect3: bool = False) -> torch.Tensor:
    """temperature -> top-k -> categorical draw over logits [..., V].
    Draws one uniform per row from `generator` (on the logits' device).
    `bisect3` finds the top-k threshold by the quartile search (see
    `sample_topk`). Returns int32 codes [...]."""
    if top_p is not None:
        raise NotImplementedError(
            'nucleus (top-p) filtering is not ported yet')
    shape = logits.shape[:-1]
    V = logits.shape[-1]
    flat = logits.reshape(-1, V)
    u = torch.rand(flat.shape[0], generator=generator, dtype=torch.float32,
                   device=logits.device)
    k = V if top_k is None else min(int(top_k), V)
    return sample_topk(flat.contiguous(), u, k, temperature,
                       bisect3=bisect3).reshape(shape)
