"""EMA vector-quantizer codebook, decode side.

Counterpart of `hqtransformer_tpu/models/stage1/quantizer.py::
EMAVectorQuantizer`: the codebook and its EMA statistics are buffers named
as in the PyTorch reference (`embedding`, `cluster_size`,
`embedding_avg`). Encoding (the nearest-code search) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class EMAVectorQuantizer(nn.Module):
    def __init__(self, n_embed: int, dim: int):
        super().__init__()
        self.n_embed = n_embed
        self.dim = dim
        self.register_buffer('embedding', torch.zeros(n_embed, dim))
        self.register_buffer('cluster_size', torch.zeros(n_embed))
        self.register_buffer('embedding_avg', torch.zeros(n_embed, dim))

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """Codes [...] -> code vectors [..., dim]."""
        return F.embedding(indices, self.embedding)
