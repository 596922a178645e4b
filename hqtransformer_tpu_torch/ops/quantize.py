"""Vector-quantization primitives for encoding: nearest-code lookup,
straight-through estimator, commitment loss, soft code distributions.

The port's copy of the parts of `hqtransformer_tpu/ops/quantize.py` that
encoding needs. The nearest-code search is the K3 kernel (`vq_argmin`),
which takes CUDA tensors to the kernel and CPU tensors to its plain
version; `codebook_distances`, which the plain version uses, lives beside
it in `ops/vq_argmin.py`. `soft_codes`, like the JAX function, takes its
hard codes from the f32 distance matrix it computes anyway, not from K3.
The EMA update belongs to training and is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .vq_argmin import codebook_distances, vq_argmin


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


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)) in f32 on the generator's device,
    u uniform in [tiny, 1), as `jax.random.gumbel` draws it."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def categorical_draw(log_probs: torch.Tensor,
                     gumbel: torch.Tensor) -> torch.Tensor:
    """One draw per row of [N, K] log-probabilities: argmax(log_probs +
    gumbel), which is `jax.random.categorical` given the Gumbel noise its
    key draws."""
    return torch.argmax(log_probs + gumbel, dim=1)


def soft_codes(z_flat: torch.Tensor, embedding: torch.Tensor,
               temp: float = 1.0, stochastic: bool = False,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes [N], soft codes [N, K]): softmax(-d / temp) over the f32
    squared distances d of z_flat [N, D] to the codebook [K, D]. The codes
    are argmin(d), or with `stochastic` one draw from each row's soft
    distribution, from log(soft + 1e-20) and the generator's Gumbel
    noise."""
    d = codebook_distances(z_flat, embedding)
    soft = torch.softmax(-d / temp, dim=1)
    if not stochastic:
        return torch.argmin(d, dim=1), soft
    if generator is None:
        raise ValueError('a stochastic draw needs a generator')
    return categorical_draw(torch.log(soft + 1e-20),
                            gumbel_noise(soft.shape, generator)), soft
