"""Fused top-k filtered categorical sampling with one uniform per row.

`sample_topk` is the wrapper of the hand-written CUDA kernel
`csrc/sample_topk.cu`, the port of the TPU kernel
`hqtransformer_tpu/ops/pallas_sample.py::_sample_topk_2d`. On a CUDA tensor
it launches the kernel or raises; on a CPU tensor it runs
`sample_topk_plain`, which repeats the TPU kernel's arithmetic:

1. x = f32(logits) / temperature;
2. the k-th-largest threshold: for k < V, 26 bisection steps on
   [max - 44, max + 1e-6] that freeze a row on an exact count == k, so the
   kept set is exact top-k-with-ties; for k >= V, min(x). Logits more than
   44 below the row max have probability below 8e-20 of the max's. With
   `bisect3` (the TPU kernel's `threshold3`), 13 passes instead, each
   counting at the bracket's three quartile points, with the same freeze
   rule; its low bits differ from the binary search's, so near ties its
   kept set may too;
3. p = exp(x - max) on the kept set, 0 elsewhere;
4. inverse-CDF draw u * total, clamped to >= 1e-30, then snapped down to the
   nearest index with p > 0.

The plain version builds the CDF with `torch.cumsum`; the TPU kernel and the
CUDA kernel sum in other orders, so a draw within a few f32 ulps of a CDF
boundary may land on the neighbouring kept code. Nothing else differs.

The CUDA kernel reaches the bisection's threshold another way: it selects
the k-th largest logit exactly (a radix select over `radix_key`), takes the
(k+1)-th from its last histogram or one more reduction, divides both and
the row max by the temperature (IEEE division by a positive number keeps
order, so these are v_k, v_{k+1} and max of x) and replays the bisection
from those three numbers alone; `bisect3` replays the 13 quartile passes
the same way. Logits must not be NaN. `replay_threshold` is the plain
version of those steps (`kth_pair`, then `bisection_replay` or
`bisection3_replay`); the tests hold it bit for bit to `topk_threshold`
and `topk_threshold3`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..utils import tracing
from . import cuda_build

BISECT_RANGE = 44.0
BISECT_ITERS = 26
BISECT3_ITERS = 13  # 44 / 4**13 == 44 / 2**26
MAX_VOCAB = 16384  # 256 threads x 64 values per thread; the configs' largest

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def scaled_logits(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """f32(logits) / temperature with IEEE division: dividing by a Python
    float may become a multiply by its reciprocal on the card, so the
    divisor is a device scalar (filled on the device, no host copy)."""
    t = torch.full((), temperature, dtype=torch.float32,
                   device=logits.device)
    return logits.float() / t


def topk_threshold(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row threshold [N, 1] whose kept set {x >= thr} is the exact
    top-k-with-ties of the f32 rows x [N, V], for rows whose k-th value
    lies within BISECT_RANGE of their max."""
    if k >= x.shape[-1]:
        return x.amin(dim=-1, keepdim=True)
    row_max = x.amax(dim=-1, keepdim=True)
    lo = row_max - BISECT_RANGE
    hi = row_max + 1e-6
    done = torch.zeros_like(lo, dtype=torch.bool)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ge = (x >= mid).sum(dim=-1, keepdim=True)
        live = ~done
        take = (ge >= k) & live
        lo = torch.where(take, mid, lo)
        hi = torch.where((ge < k) & live, mid, hi)
        done = done | (take & (ge == k))
    return lo


def _quartile_pass(lo, hi, done, probe):
    """One pass of `threshold3` on the brackets [lo, hi] of the live rows:
    `probe(m)` gives, per row, (count(x >= m) >= k, count == k). lo goes
    to the largest probe point with the first, hi to the smallest without
    it (cascaded selects), and a row freezes where a point has the
    second."""
    live = ~done
    d = hi - lo
    points = [lo + 0.25 * d, lo + 0.5 * d, lo + 0.75 * d]
    found = [probe(m) for m in points]
    lo2, hi2, exact = lo, hi, torch.zeros_like(done)
    for m, (ge, eq) in zip(points, found):
        lo2 = torch.where(ge, m, lo2)
        exact = exact | eq
    for m, (ge, _) in zip(points[::-1], found[::-1]):
        hi2 = torch.where(ge, hi2, m)
    return (torch.where(live, lo2, lo), torch.where(live, hi2, hi),
            done | (exact & live))


def topk_threshold3(x: torch.Tensor, k: int) -> torch.Tensor:
    """`topk_threshold` by the TPU kernel's `threshold3`: 13 passes over
    [max - 44, max + 1e-6], each counting at the bracket's quartile
    points lo + {0.25, 0.5, 0.75} (hi - lo) in f32; a row freezes on an
    exact count == k at any probe. The kept set is the exact top-k with
    ties for rows whose k-th value lies within BISECT_RANGE of their max;
    the threshold's low bits are those of the quartile search."""
    if k >= x.shape[-1]:
        return x.amin(dim=-1, keepdim=True)
    row_max = x.amax(dim=-1, keepdim=True)
    lo, hi = row_max - BISECT_RANGE, row_max + 1e-6
    done = torch.zeros_like(lo, dtype=torch.bool)

    def probe(m):
        count = (x >= m).sum(dim=-1, keepdim=True)
        return count >= k, count == k
    for _ in range(BISECT3_ITERS):
        lo, hi, done = _quartile_pass(lo, hi, done, probe)
    return lo


def radix_key(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's order-preserving key of f32 values, as int64 in
    [0, 2^32): the sign bit flipped for x >= +0, every bit for negatives.
    x < y implies key(x) < key(y); -0 sorts just below +0."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    return torch.where(bits >= 2**31, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)


def _from_key(key: torch.Tensor) -> torch.Tensor:
    bits = torch.where(key >= 2**31, key ^ 0x80000000, key ^ 0xFFFFFFFF)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def kth_pair(a: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k-th and (k+1)-th largest values [N, 1] of the rows a [N, V]
    (1 <= k < V), in f32, as the CUDA kernel finds them: the values of the
    k-th and (k+1)-th largest keys (for bf16 rows the kernel's 16-bit key
    is this key's upper half). The kernel reads the tie (k+1)-th = k-th
    from its last radix histogram and otherwise takes the largest key
    below the k-th."""
    keys = torch.topk(radix_key(a.float()), k + 1, dim=-1).values
    return _from_key(keys[:, k - 1:k]), _from_key(keys[:, k:k + 1])


def bisection_replay(row_max: torch.Tensor, v_k: torch.Tensor,
                     v_k1: torch.Tensor) -> torch.Tensor:
    """`topk_threshold`'s bisection replayed from three numbers a row, in
    the same f32 arithmetic: count(x >= mid) >= k is mid <= v_k, and
    count == k is, besides, v_{k+1} < mid."""
    lo = row_max - BISECT_RANGE
    hi = row_max + 1e-6
    done = torch.zeros_like(lo, dtype=torch.bool)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ge = mid <= v_k
        live = ~done
        lo = torch.where(ge & live, mid, lo)
        hi = torch.where(~ge & live, mid, hi)
        done = done | (ge & live & (v_k1 < mid))
    return lo


def bisection3_replay(row_max: torch.Tensor, v_k: torch.Tensor,
                      v_k1: torch.Tensor) -> torch.Tensor:
    """`topk_threshold3` replayed from three numbers a row, in the same f32
    arithmetic: count(x >= m) >= k is m <= v_k, and count == k is, besides,
    v_{k+1} < m."""
    lo, hi = row_max - BISECT_RANGE, row_max + 1e-6
    done = torch.zeros_like(lo, dtype=torch.bool)

    def probe(m):
        ge = m <= v_k
        return ge, ge & (v_k1 < m)
    for _ in range(BISECT3_ITERS):
        lo, hi, done = _quartile_pass(lo, hi, done, probe)
    return lo


def replay_threshold(logits: torch.Tensor, k: int, temperature: float,
                     bisect3: bool = False) -> torch.Tensor:
    """The CUDA kernel's threshold [N, 1] for k < V: the select on the
    logits as stored, three divisions by the temperature, the replay of
    the binary or (`bisect3`) the quartile search."""
    def scaled(a):
        return scaled_logits(a, temperature)

    v_k, v_k1 = kth_pair(logits, k)
    replay = bisection3_replay if bisect3 else bisection_replay
    return replay(scaled(logits.float().amax(-1, keepdim=True)),
                  scaled(v_k), scaled(v_k1))


def select_threshold(x: torch.Tensor, k: int, bisect3: bool = False
                     ) -> torch.Tensor:
    """The kernel's threshold [N, 1] of the scaled rows x [N, V]:
    `topk_threshold3` with `bisect3`, else `topk_threshold`."""
    return (topk_threshold3 if bisect3 else topk_threshold)(x, k)


def sample_topk_plain(logits: torch.Tensor, u: torch.Tensor, k: int,
                      temperature: float,
                      bisect3: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the sampling kernel. logits: [N, V] (any
    float dtype); u: [N] uniforms in [0, 1); `bisect3` takes the quartile
    search's threshold. Returns int32 codes [N]."""
    x = scaled_logits(logits, temperature)
    thr = select_threshold(x, k, bisect3)
    row_max = x.amax(dim=-1, keepdim=True)
    return inverse_cdf_draw(
        torch.where(x >= thr, torch.exp(x - row_max), 0.0), u)


def inverse_cdf_draw(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row of the non-negative weights p [N, V]
    (not necessarily normalised) from the uniforms u [N], in vocabulary
    order: u * total, clamped to >= 1e-30, against the running sum
    (`torch.cumsum`), snapped down to the nearest index with p > 0.
    Returns int32 codes [N]."""
    cdf = torch.cumsum(p, dim=-1)
    draw = torch.clamp_min(u.float()[:, None] * cdf[:, -1:], 1e-30)
    idx0 = (cdf < draw).sum(dim=-1, keepdim=True)
    iota = torch.arange(p.shape[-1], device=p.device)
    valid = (p > 0) & (iota <= idx0)
    return torch.where(valid, iota, 0).amax(dim=-1).int()


@functools.cache
def _kernel():
    fn = cuda_build.load('sample_topk').hqt_sample_topk
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, ptr, ptr, ptr, ptr, i32, i32, i32, ctypes.c_float,
                   i32, ptr]
    fn.restype = i32
    return fn


def sample_topk(logits: torch.Tensor, u: torch.Tensor, k: int,
                temperature: float, threshold: Optional[torch.Tensor] = None,
                bisect3: bool = False) -> torch.Tensor:
    """Top-k filtered categorical draw per row: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. logits: [N, V] float32 or
    bfloat16; u: [N] float32 uniforms; 1 <= k (k >= V keeps every logit).
    `threshold`, a contiguous float32 [N] tensor on the kernel's device,
    receives each row's threshold (the kept set is x >= threshold) where
    given; the sampler passes none. `bisect3` finds the threshold by the
    TPU kernel's quartile search (`topk_threshold3`) instead of its binary
    one. Returns int32 codes [N]."""
    if logits.device.type == 'cpu':
        if threshold is not None:
            threshold.copy_(select_threshold(
                scaled_logits(logits, temperature), k, bisect3)[:, 0])
        return sample_topk_plain(logits, u, k, temperature, bisect3)
    if logits.device.type != 'cuda':
        raise ValueError(f'no top-k sampling for device {logits.device}')
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError('logits must be a contiguous [N, V] tensor')
    N, V = logits.shape
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f'sampling kernel takes float32 or bfloat16 logits, '
                        f'got {logits.dtype}')
    if not 1 <= V <= MAX_VOCAB or N < 1:
        raise ValueError(f'need 1 <= N and 1 <= V <= {MAX_VOCAB}, got '
                         f'[{N}, {V}]')
    if (u.shape != (N,) or u.dtype != torch.float32 or not u.is_contiguous()
            or u.device != logits.device):
        raise ValueError(f'u must be a contiguous float32 [{N}] tensor on '
                         f'{logits.device}')
    if k < 1:
        raise ValueError(f'top-k needs k >= 1, got {k}')
    if not 0.0 < temperature < float('inf'):
        # the kernel selects on the logits as stored: dividing by the
        # temperature must keep their order
        raise ValueError(f'need a positive finite temperature, got '
                         f'{temperature}')
    if threshold is not None and (
            threshold.shape != (N,) or threshold.dtype != torch.float32
            or not threshold.is_contiguous()
            or threshold.device != logits.device):
        raise ValueError(f'threshold must be a contiguous float32 [{N}] '
                         f'tensor on {logits.device}')
    out = torch.empty(N, dtype=torch.int32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    rc = _kernel()(_DTYPE_CODES[logits.dtype], logits.data_ptr(),
                   u.data_ptr(), out.data_ptr(),
                   None if threshold is None else threshold.data_ptr(), N, V,
                   int(k), float(temperature), int(bool(bisect3)), stream)
    if rc != 0:
        raise RuntimeError(f'sample_topk kernel launch failed: CUDA error '
                           f'{rc}')
    tracing.count('k2.launches')
    tracing.count('k2.bisect3_launches', bool(bisect3))
    return out
