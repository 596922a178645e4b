"""Vector-quantization primitives: nearest-code lookup, straight-through
estimator, commitment loss, soft code distributions and the EMA codebook
update.

The port's copy of `hqtransformer_tpu/ops/quantize.py`. The nearest-code
search is the K3 kernel (`vq_argmin`), which takes CUDA tensors to the
kernel and CPU tensors to its plain version; `codebook_distances`, which
the plain version uses, lives beside it in `ops/vq_argmin.py`.
`soft_codes`, like the JAX function, takes its hard codes from the f32
distance matrix it computes anyway, not from K3.

`ema_update` is one step of the EMA codebook (training): the batch's
per-code counts and sums are index-adds of the codes (not a dense [N, K]
one-hot product), summed over the data-parallel ranks when asked (the
JAX package's psum over its 'dp' axis); restarting unused codes draws
from a `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
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


class EMAState(NamedTuple):
    embedding: torch.Tensor       # [K, D]
    cluster_size: torch.Tensor    # [K]
    embedding_avg: torch.Tensor   # [K, D]


def _tile_with_noise(x: torch.Tensor, target_n: int,
                     generator: torch.Generator) -> torch.Tensor:
    """x [N, D] repeated until it has at least `target_n` rows, plus
    uniform noise in [0, 0.01 / sqrt(D)) drawn from the generator."""
    n, dim = x.shape
    n_repeats = (target_n + n - 1) // n
    std = 0.01 / torch.sqrt(torch.tensor(float(dim), dtype=torch.float32))
    tiled = x.repeat(n_repeats, 1)
    noise = torch.rand(tiled.shape, generator=generator,
                       device=generator.device).to(x.device)
    return tiled + noise * std.to(x.device)


def _all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of `x` of every data-parallel rank, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def ema_update(state: EMAState, z_flat: torch.Tensor, codes: torch.Tensor,
               *, decay: float = 0.99, eps: float = 1e-5,
               use_l2_norm: bool = False, restart_unused_codes: bool = False,
               generator: Optional[torch.Generator] = None,
               distributed: bool = False) -> EMAState:
    """One EMA codebook step on z_flat [N, D] (L2-normalized already when
    `use_l2_norm`) and its codes [N], in f32: counts and sums by index-add,
    all-reduced over the default process group when `distributed`; the
    decayed statistics; with `restart_unused_codes`, every code whose
    decayed count is under 1 takes a random batch vector (the batch's rows
    tiled with noise while it has fewer rows than codes; under
    `distributed`, the rows of every rank) and count 1; then the codebook,
    the sums over the Laplace-smoothed counts."""
    n_embed, dim = state.embedding.shape
    z32 = z_flat.detach().float()
    codes = codes.reshape(-1)
    counts = torch.zeros(n_embed, dtype=torch.float32, device=z32.device)
    counts.index_add_(0, codes, torch.ones_like(codes, dtype=torch.float32))
    sums = torch.zeros(n_embed, dim, dtype=torch.float32, device=z32.device)
    sums.index_add_(0, codes, z32)
    if distributed:
        dist.all_reduce(counts)
        dist.all_reduce(sums)
    cluster_size = state.cluster_size * decay + counts * (1.0 - decay)
    embedding_avg = state.embedding_avg * decay + sums * (1.0 - decay)
    if restart_unused_codes:
        if generator is None:
            raise ValueError('restarting unused codes needs a generator')
        vectors = _all_gather_rows(z32) if distributed else z32
        if vectors.shape[0] < n_embed:
            vectors = _tile_with_noise(vectors, n_embed, generator)
        perm = torch.randperm(vectors.shape[0], generator=generator,
                              device=generator.device).to(vectors.device)
        random_vectors = vectors[perm][:n_embed]
        usage = (cluster_size >= 1.0).float()
        embedding_avg = embedding_avg * usage[:, None] + \
            random_vectors * (1.0 - usage[:, None])
        cluster_size = cluster_size * usage + (1.0 - usage)
    n = cluster_size.sum()
    smoothed = (cluster_size + eps) / (n + n_embed * eps) * n
    embedding = embedding_avg / smoothed[:, None]
    if use_l2_norm:
        embedding = _l2_normalize(embedding)
    return EMAState(embedding, cluster_size, embedding_avg)
