"""Vector-quantizer codebooks: learned (`VectorQuantizer`) and EMA
(`EMAVectorQuantizer`).

Counterparts of `hqtransformer_tpu/models/stage1/quantizer.py`, named as
in the PyTorch reference: the learned codebook is the weight of an
`nn.Embedding` (`embedding.weight`); the EMA codebook and its statistics
are buffers (`embedding`, `cluster_size`, `embedding_avg`). `codebook`
gives either as a [K, dim] tensor. `forward` quantizes through the
nearest-code search (`ops/quantize.py::quantize_lookup`, the K3 kernel on
CUDA tensors); `get_soft_codes` gives the soft code distributions of
soft-label stage-2 training (`ops/quantize.py::soft_codes`, off K3 as in
the JAX package). The EMA update belongs to training and is not ported
yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import quantize as q


class _Quantizer(nn.Module):
    """What both codebooks share: lookups and soft codes over `codebook`
    on the (optionally L2-normalized) rows of z."""

    beta: float
    use_l2_norm: bool = False

    @property
    def codebook(self) -> torch.Tensor:
        raise NotImplementedError

    def _normalize(self, flat: torch.Tensor) -> torch.Tensor:
        return q._l2_normalize(flat) if self.use_l2_norm else flat

    def _lookup(self, z: torch.Tensor):
        """z [..., dim] -> (z_q [..., dim], codes [...]) by the nearest-code
        search."""
        flat = self._normalize(z.reshape(-1, z.shape[-1]))
        codes, z_q = q.quantize_lookup(flat, self.codebook)
        return z_q.reshape(z.shape), codes.reshape(z.shape[:-1])

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """Codes [...] -> code vectors [..., dim]."""
        return F.embedding(indices, self.codebook)

    def get_soft_codes(self, z: torch.Tensor, temp: float = 1.0,
                       stochastic: bool = False,
                       generator: Optional[torch.Generator] = None):
        """z [..., dim] -> (z_q straight-through [..., dim], commitment
        loss, codes [...], soft codes [..., K]); the codes are the nearest
        or, with `stochastic`, drawn from the soft codes with the
        generator's noise."""
        flat = self._normalize(z.reshape(-1, z.shape[-1]))
        codes, soft = q.soft_codes(flat, self.codebook, temp, stochastic,
                                   generator)
        z_q = F.embedding(codes, self.codebook).reshape(z.shape)
        diff = q.commitment_loss(z, z_q, self.beta)
        return (q.straight_through(z, z_q), diff, codes.reshape(z.shape[:-1]),
                soft.reshape(z.shape[:-1] + (soft.shape[-1],)))


class VectorQuantizer(_Quantizer):
    """Learned codebook. Its loss is the commitment loss plus the codebook
    term mean((z_q - sg(z))^2); `get_soft_codes` returns the commitment
    loss alone, as the JAX package's does."""

    def __init__(self, n_embed: int, dim: int, beta: float = 0.25):
        super().__init__()
        self.n_embed = n_embed
        self.dim = dim
        self.beta = beta
        self.embedding = nn.Embedding(n_embed, dim)

    @property
    def codebook(self) -> torch.Tensor:
        return self.embedding.weight

    def forward(self, z: torch.Tensor, update_ema: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z [..., dim] -> (z_q straight-through [..., dim], loss, codes
        [...]); `update_ema` is accepted and ignored, as in JAX."""
        z_q, codes = self._lookup(z)
        loss = q.commitment_loss(z, z_q, self.beta) + \
            torch.mean(torch.square(z_q - z.detach()))
        return q.straight_through(z, z_q), loss, codes


class EMAVectorQuantizer(_Quantizer):
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

    @property
    def codebook(self) -> torch.Tensor:
        return self.embedding

    def forward(self, z: torch.Tensor, update_ema: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z [..., dim] -> (z_q straight-through [..., dim], commitment
        loss, codes [...])."""
        if update_ema:
            raise NotImplementedError('the EMA codebook update is not ported')
        z_q, codes = self._lookup(z)
        diff = q.commitment_loss(z, z_q, self.beta)
        return q.straight_through(z, z_q), diff, codes


def make_quantizer(ema_update: bool, dim: int, n_embed: int) -> _Quantizer:
    """The EMA codebook when `ema_update`, else the learned one."""
    if ema_update:
        return EMAVectorQuantizer(n_embed, dim)
    return VectorQuantizer(n_embed, dim)
