"""EMA vector-quantizer codebook.

Counterpart of `hqtransformer_tpu/models/stage1/quantizer.py::
EMAVectorQuantizer`: the codebook and its EMA statistics are buffers named
as in the PyTorch reference (`embedding`, `cluster_size`,
`embedding_avg`). `forward` quantizes through the nearest-code search
(`ops/quantize.py::vq_lookup`, the K3 kernel on CUDA tensors). The EMA
update belongs to training and is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import quantize as q


class EMAVectorQuantizer(nn.Module):
    def __init__(self, n_embed: int, dim: int, beta: float = 0.25,
                 use_l2_norm: bool = False):
        super().__init__()
        self.n_embed = n_embed
        self.dim = dim
        self.beta = beta
        self.use_l2_norm = use_l2_norm
        self.register_buffer('embedding', torch.zeros(n_embed, dim))
        self.register_buffer('cluster_size', torch.zeros(n_embed))
        self.register_buffer('embedding_avg', torch.zeros(n_embed, dim))

    def _normalize(self, flat: torch.Tensor) -> torch.Tensor:
        return q._l2_normalize(flat) if self.use_l2_norm else flat

    def forward(self, z: torch.Tensor, update_ema: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z [..., dim] -> (z_q straight-through [..., dim], commitment
        loss, codes [...])."""
        if update_ema:
            raise NotImplementedError('the EMA codebook update is not ported')
        flat = self._normalize(z.reshape(-1, z.shape[-1]))
        codes, z_q = q.quantize_lookup(flat, self.embedding)
        z_q = z_q.reshape(z.shape)
        diff = q.commitment_loss(z, z_q, self.beta)
        return (q.straight_through(z, z_q), diff,
                codes.reshape(z.shape[:-1]))

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """Codes [...] -> code vectors [..., dim]."""
        return F.embedding(indices, self.embedding)
