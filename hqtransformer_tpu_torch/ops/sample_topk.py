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
   44 below the row max have probability below 8e-20 of the max's;
3. p = exp(x - max) on the kept set, 0 elsewhere;
4. inverse-CDF draw u * total, clamped to >= 1e-30, then snapped down to the
   nearest index with p > 0.

The plain version builds the CDF with `torch.cumsum`; the TPU kernel and the
CUDA kernel sum in other orders, so a draw within a few f32 ulps of a CDF
boundary may land on the neighbouring kept code. Nothing else differs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import cuda_build

BISECT_RANGE = 44.0
BISECT_ITERS = 26
MAX_VOCAB = 16384  # 512 threads x 32 values per thread; the configs' largest

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def scaled_logits(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """f32(logits) / temperature with IEEE division: dividing by a Python
    float may become a multiply by its reciprocal on the card, so the
    divisor is a device scalar (filled on the device, no host copy)."""
    t = torch.full((), temperature, dtype=torch.float32,
                   device=logits.device)
    return logits.float() / t


def topk_threshold(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Per-row threshold [N, 1] whose kept set {x >= thr} is the exact
    top-k-with-ties of the f32 rows x [N, V], and the number of bisection
    steps [N] each row ran before it froze (0 when k >= V)."""
    N, V = x.shape
    iters = torch.zeros(N, dtype=torch.int32, device=x.device)
    if k >= V:
        return x.amin(dim=-1, keepdim=True), iters
    row_max = x.amax(dim=-1, keepdim=True)
    lo = row_max - BISECT_RANGE
    hi = row_max + 1e-6
    done = torch.zeros_like(lo, dtype=torch.bool)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ge = (x >= mid).sum(dim=-1, keepdim=True)
        live = ~done
        iters += live[:, 0].int()
        take = (ge >= k) & live
        lo = torch.where(take, mid, lo)
        hi = torch.where((ge < k) & live, mid, hi)
        done = done | (take & (ge == k))
    return lo, iters


def sample_topk_plain(logits: torch.Tensor, u: torch.Tensor, k: int,
                      temperature: float) -> torch.Tensor:
    """Plain PyTorch version of the sampling kernel. logits: [N, V] (any
    float dtype); u: [N] uniforms in [0, 1). Returns int32 codes [N]."""
    x = scaled_logits(logits, temperature)
    thr, _ = topk_threshold(x, k)
    row_max = x.amax(dim=-1, keepdim=True)
    p = torch.where(x >= thr, torch.exp(x - row_max), 0.0)
    cdf = torch.cumsum(p, dim=-1)
    draw = torch.clamp_min(u.float()[:, None] * cdf[:, -1:], 1e-30)
    idx0 = (cdf < draw).sum(dim=-1, keepdim=True)
    iota = torch.arange(x.shape[-1], device=x.device)
    valid = (p > 0) & (iota <= idx0)
    return torch.where(valid, iota, 0).amax(dim=-1).int()


@functools.cache
def _kernel():
    fn = cuda_build.load('sample_topk').hqt_sample_topk
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32, ctypes.c_float, ptr]
    fn.restype = i32
    return fn


def sample_topk(logits: torch.Tensor, u: torch.Tensor, k: int,
                temperature: float) -> torch.Tensor:
    """Top-k filtered categorical draw per row: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. logits: [N, V] float32 or
    bfloat16; u: [N] float32 uniforms; 1 <= k (k >= V keeps every logit).
    Returns int32 codes [N]."""
    if logits.device.type == 'cpu':
        return sample_topk_plain(logits, u, k, temperature)
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
    out = torch.empty(N, dtype=torch.int32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    rc = _kernel()(_DTYPE_CODES[logits.dtype], logits.data_ptr(),
                   u.data_ptr(), out.data_ptr(), N, V, int(k),
                   float(temperature), stream)
    if rc != 0:
        raise RuntimeError(f'sample_topk kernel launch failed: CUDA error '
                           f'{rc}')
    sample_topk.launches += 1
    return out


sample_topk.launches = 0
