"""Logits post-processing and categorical sampling for the decode loops.

Counterpart of `hqtransformer_tpu/ops/topk_topp.py`. `sample_from_logits`
routes as the JAX function does:
- without nucleus filtering (`top_p` None): temperature, top-k and one
  inverse-CDF draw per row, all in the fused sampling kernel
  (`ops/sample_topk.py`, the port of the TPU kernel);
- with `top_p`: the JAX function leaves the kernel for plain XLA ops, and
  the port likewise runs plain PyTorch ops: f32 logits over the
  temperature, `cutoff_topk_logits` (a 30-step bisection over the row's
  whole range, `kth_largest_threshold`, not the kernel's [max - 44, max]
  window), softmax, `cutoff_topp_probs` (a stable descending sort, a
  running sum, `cum >= p` shifted right by one so that the top token
  always stays, the inverse permutation, renormalisation), then one
  inverse-CDF draw over the renormalised probabilities in vocabulary
  order (`sample_topk.inverse_cdf_draw`).

The bisection is exact f32 arithmetic, so its threshold is bit-equal to
JAX's. The softmax and the running sum may round differently from XLA's,
so the kept sets can differ where |cum - p| is within a few ulps. JAX draws
from log(probs + 1e-20), which leaves a removed token a weight of about
1e-20; here a removed token has none.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import tracing
from .sample_topk import inverse_cdf_draw, sample_topk, scaled_logits

BISECT_ITERS = 30


def kth_largest_threshold(logits: torch.Tensor, k: int,
                          iters: int = BISECT_ITERS) -> torch.Tensor:
    """Per-row threshold [..., 1] whose kept set {x >= t} is the k largest
    of the f32 rows logits [..., V], ties at the k-th included: `iters`
    bisections of [row min, row max + 1e-6], keeping
    count(x >= lo) >= k > count(x >= hi)."""
    lo = logits.amin(dim=-1)
    hi = logits.amax(dim=-1) + 1e-6
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        take = (logits >= mid[..., None]).sum(dim=-1) >= k
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    return lo[..., None]


def cutoff_topk_logits(logits: torch.Tensor,
                       k: Optional[int]) -> torch.Tensor:
    """Logits [..., V] below the k-th largest set to -inf (ties at the
    k-th survive); unchanged for k None or k >= V."""
    if k is None or min(k, logits.shape[-1]) == logits.shape[-1]:
        return logits
    threshold = kth_largest_threshold(logits, k)
    return torch.where(logits < threshold, float('-inf'), logits)


def cutoff_topp_probs(probs: torch.Tensor,
                      p: Optional[float]) -> torch.Tensor:
    """Nucleus filtering of probabilities [..., V]: in descending order
    (ties by index), drop every token after the cumulative mass has reached
    p, keep the first, renormalise. Unchanged for p None."""
    if p is None:
        return probs
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    cum = torch.cumsum(probs.gather(-1, order), dim=-1)
    keep_first = torch.zeros_like(cum[..., :1], dtype=torch.bool)
    remove_sorted = torch.cat([keep_first, (cum >= p)[..., :-1]], dim=-1)
    remove = torch.empty_like(remove_sorted).scatter_(-1, order,
                                                      remove_sorted)
    filtered = torch.where(remove, 0.0, probs)
    return filtered / filtered.sum(dim=-1, keepdim=True)


def nucleus_probs(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int], top_p: float) -> torch.Tensor:
    """The renormalised probabilities [N, V] that the top-p draw samples
    from: f32 logits over the temperature, top-k cutoff, softmax, nucleus
    filter."""
    x = cutoff_topk_logits(scaled_logits(logits, temperature), top_k)
    return cutoff_topp_probs(torch.softmax(x, dim=-1), top_p)


@tracing.span('ar.draw')
def sample_from_logits(generator: torch.Generator, logits: torch.Tensor, *,
                       temperature: float = 1.0,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None,
                       bisect3: bool = False,
                       shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """temperature -> top-k -> [softmax -> top-p] -> categorical draw over
    logits [..., V]. Draws one uniform per row from `generator` (on the
    logits' device). Without `top_p`, the sampling kernel (`bisect3`: its
    quartile search for the top-k threshold, see `sample_topk`); with it,
    the plain ops of the module docstring. Returns int32 codes [...].

    `shard` = (index, count): the logits are shard `index` of `count`
    equal, batch-major shards of the whole batch's rows (data
    parallelism); the uniforms of every shard are drawn and this one's
    taken, so the codes do not depend on how the batch is split."""
    shape = logits.shape[:-1]
    V = logits.shape[-1]
    flat = logits.reshape(-1, V)
    n = flat.shape[0]
    index, count = shard
    u = torch.rand(n * count, generator=generator, dtype=torch.float32,
                   device=logits.device)
    if count > 1:
        u = u[index * n:(index + 1) * n]
    if top_p is not None:
        probs = nucleus_probs(flat, temperature, top_k, top_p)
        return inverse_cdf_draw(probs, u).reshape(shape)
    k = V if top_k is None else min(int(top_k), V)
    return sample_topk(flat.contiguous(), u, k, temperature,
                       bisect3=bisect3).reshape(shape)
