"""Vector-quantization primitives for encoding: nearest-code lookup,
straight-through estimator, commitment loss.

The port's copy of the parts of `hqtransformer_tpu/ops/quantize.py` that
encoding needs. The nearest-code search is the K3 kernel (`vq_argmin`),
which takes CUDA tensors to the kernel and CPU tensors to its plain
version; `codebook_distances`, which the plain version uses, lives beside
it in `ops/vq_argmin.py`. The EMA update and soft codes belong to
training and are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .vq_argmin import vq_argmin


def _l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / max(|x|, eps) over the last axis."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def vq_lookup(z_flat: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices, int64 [N], ties to the lowest index. No
    gradient flows through the search."""
    return vq_argmin(z_flat.detach().contiguous(), embedding.detach())


def quantize_lookup(z: torch.Tensor, embedding: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z [..., D] -> (codes [...], z_q [..., D])."""
    codes = vq_lookup(z.reshape(-1, z.shape[-1]), embedding)
    z_q = F.embedding(codes, embedding).reshape(z.shape)
    return codes.reshape(z.shape[:-1]), z_q


def straight_through(z: torch.Tensor, z_q: torch.Tensor) -> torch.Tensor:
    """z + stop_grad(z_q - z): the forward value rounds as the JAX
    package's does."""
    return z + (z_q - z).detach()


def commitment_loss(z: torch.Tensor, z_q: torch.Tensor,
                    beta: float) -> torch.Tensor:
    """beta * mean((stop_grad(z_q) - z)^2)."""
    return beta * torch.mean(torch.square(z_q.detach() - z))
