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
the JAX package). `EMAVectorQuantizer.forward(z, update_ema=True)`
(training) searches the old codebook, then updates the buffers in place
(`ops/quantize.py::ema_update`): decay 0.99, eps 1e-5, restarting unused
codes from the caller's `torch.Generator` where the stage-1 config asks
(`restart_unused_codes`), the statistics summed over the data-parallel
ranks when built with `ema_distributed` (the JAX `ema_axis_name`).
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

    def forward(self, z: torch.Tensor, update_ema: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z [..., dim] -> (z_q straight-through [..., dim], loss, codes
        [...]); `update_ema` and `generator` are accepted and ignored, as
        in JAX."""
        z_q, codes = self._lookup(z)
        loss = q.commitment_loss(z, z_q, self.beta) + \
            torch.mean(torch.square(z_q - z.detach()))
        return q.straight_through(z, z_q), loss, codes


class EMAVectorQuantizer(_Quantizer):
    def __init__(self, n_embed: int, dim: int, beta: float = 0.25,
                 use_l2_norm: bool = False, decay: float = 0.99,
                 eps: float = 1e-5, restart_unused_codes: bool = False,
                 ema_distributed: bool = False):
        super().__init__()
        self.n_embed = n_embed
        self.dim = dim
        self.beta = beta
        self.use_l2_norm = use_l2_norm
        self.decay = decay
        self.eps = eps
        self.restart_unused_codes = restart_unused_codes
        self.ema_distributed = ema_distributed
        self.register_buffer('embedding', torch.zeros(n_embed, dim))
        self.register_buffer('cluster_size', torch.zeros(n_embed))
        self.register_buffer('embedding_avg', torch.zeros(n_embed, dim))

    @property
    def codebook(self) -> torch.Tensor:
        return self.embedding

    def forward(self, z: torch.Tensor, update_ema: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z [..., dim] -> (z_q straight-through [..., dim], commitment
        loss, codes [...]), from the codebook as it was; with `update_ema`
        the buffers then take one EMA step (`generator` draws the
        restarts)."""
        flat = self._normalize(z.reshape(-1, z.shape[-1]))
        codes, z_q = q.quantize_lookup(flat, self.codebook)
        z_q = z_q.reshape(z.shape)
        if update_ema:
            new = q.ema_update(
                q.EMAState(self.embedding, self.cluster_size,
                           self.embedding_avg), flat, codes,
                decay=self.decay, eps=self.eps, use_l2_norm=self.use_l2_norm,
                restart_unused_codes=self.restart_unused_codes,
                generator=generator, distributed=self.ema_distributed)
            with torch.no_grad():
                self.embedding.copy_(new.embedding)
                self.cluster_size.copy_(new.cluster_size)
                self.embedding_avg.copy_(new.embedding_avg)
        diff = q.commitment_loss(z, z_q, self.beta)
        return q.straight_through(z, z_q), diff, codes.reshape(z.shape[:-1])


def make_quantizer(ema_update: bool, dim: int, n_embed: int,
                   restart_unused_codes: bool = False,
                   ema_distributed: bool = False) -> _Quantizer:
    """The EMA codebook when `ema_update`, else the learned one (which
    takes neither training option)."""
    if ema_update:
        return EMAVectorQuantizer(
            n_embed, dim, restart_unused_codes=restart_unused_codes,
            ema_distributed=ema_distributed)
    return VectorQuantizer(n_embed, dim)
