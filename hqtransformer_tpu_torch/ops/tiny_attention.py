"""Multi-head attention over the depth chains' few tokens, in the flat
[B, T, D] layout.

`tiny_attention` is the wrapper of the hand-written CUDA kernel
`csrc/tiny_attention.cu` (no TPU counterpart: the JAX package's
`tiny_attention` is plain jnp, which XLA fuses into one loop). It takes q
[B, Tq, D] and k, v [B, Tk, D] in float32 or bfloat16 with Tq, Tk <= 32,
heads of a multiple of 8 channels up to 128, and a mask of None or bool
[Tq, Tk] read through its strides. On a CUDA tensor it launches the kernel
(`ta.launches` counts each launch) or raises on what the kernel does not
take (`check`); on a CPU tensor it runs `tiny_attention_plain`.

`tiny_attention_plain` is the port's arithmetic as it stood before the
kernel: stock PyTorch that writes the [B, Tq, Tk, D] products to memory
and reads them back. The kernel reads q, k and v once and writes y once,
and rounds at the same points; only the order of the f32 sums differs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ..utils import tracing
from . import cuda_build

NEG_INF = -1e10        # the score of a blocked (query, key) pair
MAX_T = 32             # Tq and Tk at most
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# How the kernel cuts the work: a block a (batch row, group of heads), two
# threads a (head, query) pair (each scoring half the keys), up to PAIRS
# pairs a block, and at least BLOCKS_PER_SM blocks an SM where the batch
# allows; at most MAX_SMEM bytes of shared memory a block (the H100's
# opt-in limit).
PAIRS = 128
BLOCKS_PER_SM = 2
MAX_SMEM = 232448


def tiny_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_heads: int,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention over the short depth chains (Tq, Tk <= 21) in
    the flat [B, T, D] layout, with the JAX package's `tiny_attention`
    roundings: the products q * k in the activation dtype, summed per head
    in f32, scaled and masked (`mask` bool [Tq, Tk], True = attend), the
    softmax over the keys in f32; the weights cast to q's dtype, broadcast
    over each head's channels, and sum(weight * v) over the keys in f32
    (XLA fuses that product into the sum: it is not rounded), cast to q's
    dtype. In bf16 this gives the JAX function's output bit for bit."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    hd = D // n_heads
    P = q[:, :, None, :] * k[:, None, :, :]                 # [B, Tq, Tk, D]
    s = P.reshape(B, Tq, Tk, n_heads, hd).sum(-1, dtype=torch.float32)
    s = s * (1.0 / math.sqrt(hd))
    if mask is not None:
        s = s.masked_fill(~mask[None, :, :, None], NEG_INF)
    att = torch.softmax(s, dim=2).to(q.dtype).float()       # [B, Tq, Tk, nh]
    y = att[..., None] * v.float().reshape(B, 1, Tk, n_heads, hd)
    return y.sum(2).reshape(B, Tq, D).to(q.dtype)


def _padded_row(heads: int, hd: int, dtype: torch.dtype) -> int:
    """Bytes of one row of a block's copy of k or v: each head's columns
    and the row padded by 16 bytes (`csrc/tiny_attention.cu`)."""
    vec = 16 // dtype.itemsize
    return (heads * (hd + vec) + vec) * dtype.itemsize


def smem_bytes(heads: int, hd: int, tq: int, tk: int,
               dtype: torch.dtype) -> int:
    """Shared memory of a block of `heads` heads: k's rows or, over them
    after the scores, the f32 weights [heads, tk, tq rounded up to 4],
    whichever is larger, then v's rows."""
    row = _padded_row(heads, hd, dtype)
    weights = heads * tk * (-(-tq // 4) * 4) * 4
    return max(tk * row, weights) + tk * row


def launch_plan(b: int, tq: int, tk: int, d: int, n_heads: int,
                dtype: torch.dtype, n_sms: int) -> Tuple[int, int, int]:
    """(heads a block, threads a block, shared-memory bytes) of the
    kernel's launch for these shapes: two threads a (head, query) pair,
    the most heads (a divisor of n_heads) whose pairs stay within
    PAIRS and whose copy fits MAX_SMEM, fewer while the grid would hold
    under BLOCKS_PER_SM blocks an SM and fewer heads remain."""
    hd = d // n_heads
    fits = [g for g in range(n_heads, 0, -1) if n_heads % g == 0 and (
        g == 1 or (g * tq <= PAIRS and
                   smem_bytes(g, hd, tq, tk, dtype) <= MAX_SMEM))]
    heads = next((g for g in fits
                  if b * (n_heads // g) >= BLOCKS_PER_SM * n_sms), fits[-1])
    threads = -(-2 * heads * tq // 32) * 32
    return heads, threads, smem_bytes(heads, hd, tq, tk, dtype)


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int,
          mask: Optional[torch.Tensor] = None) -> None:
    """Raise on what the kernel does not take: q [B, Tq, D] and k, v
    [B, Tk, D] of one float32 or bfloat16 dtype and device, Tq and Tk in
    1..MAX_T, heads of a multiple of 8 channels up to MAX_HEAD_DIM,
    channels contiguous and rows 16-byte aligned, a mask of None or bool
    [Tq, Tk]. Launches nothing."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f'need q [B, Tq, D], k and v [B, Tk, D], got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    B, Tq, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, D) or v.shape != (B, Tk, D):
        raise ValueError(f'k and v must be [{B}, Tk, {D}], got '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f'tiny_attention kernel takes float32 or bfloat16 '
                        f'q, k and v of one dtype, got {q.dtype}, {k.dtype}, '
                        f'{v.dtype}')
    if not (1 <= Tq <= MAX_T and 1 <= Tk <= MAX_T) or B < 1:
        raise ValueError(f'need B >= 1 and Tq, Tk in 1..{MAX_T}, got B {B}, '
                         f'Tq {Tq}, Tk {Tk}')
    if n_heads < 1 or D % n_heads:
        raise ValueError(f'{n_heads} heads do not divide D {D}')
    hd = D // n_heads
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f'need a head of a multiple of 8 channels up to '
                         f'{MAX_HEAD_DIM}, got {hd}')
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device != q.device:
            raise ValueError(f'{name} is on {t.device}, q on {q.device}')
        if t.stride(2) != 1 or t.data_ptr() % 16 or any(
                t.stride(i) * t.element_size() % 16 for i in (0, 1)):
            raise ValueError(f'{name} needs contiguous channels and 16-byte '
                             f'aligned rows, got strides {t.stride()}')
    if mask is not None and (mask.dtype != torch.bool or
                             mask.shape != (Tq, Tk) or
                             mask.device != q.device):
        raise ValueError(f'mask must be None or bool [{Tq}, {Tk}] on '
                         f'{q.device}, got {mask.dtype} '
                         f'{tuple(mask.shape)} on {mask.device}')


@functools.cache
def _kernel():
    fn = cuda_build.load('tiny_attention').hqt_tiny_attention
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64,
                   i64, i64, i64, i32, i32, i32, i32, i32, i32, i32, i32,
                   ctypes.c_float, ptr]
    fn.restype = i32
    return fn


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int,
           mask: Optional[torch.Tensor],
           plan: Tuple[int, int, int]) -> torch.Tensor:
    """The kernel on checked CUDA tensors under the launch `plan`
    (`launch_plan`'s triple); the output is a new contiguous [B, Tq, D]."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    y = torch.empty((B, Tq, D), dtype=q.dtype, device=q.device)
    heads, threads, smem = plan
    m_ptr, m_s0, m_s1 = ((None, 0, 0) if mask is None else
                         (mask.data_ptr(), mask.stride(0), mask.stride(1)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), y.data_ptr(), m_ptr, q.stride(0),
                   q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                   v.stride(1), m_s0, m_s1, B, Tq, Tk, D, n_heads, heads,
                   threads, smem, 1.0 / math.sqrt(D // n_heads), stream)
    if rc != 0:
        raise RuntimeError(f'tiny_attention kernel launch failed: CUDA '
                           f'error {rc}')
    tracing.count('ta.launches')
    return y


def tiny_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   n_heads: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q [B, Tq, D] over k, v [B, Tk, D] in n_heads heads,
    `mask` bool [Tq, Tk] (True = attend) or None: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns q's dtype, [B, Tq,
    D] contiguous."""
    if q.device.type == 'cpu':
        return tiny_attention_plain(q, k, v, n_heads, mask)
    if q.device.type != 'cuda':
        raise ValueError(f'no tiny_attention kernel for device {q.device}')
    check(q, k, v, n_heads, mask)
    B, Tq, D = q.shape
    plan = launch_plan(B, Tq, k.shape[1], D, n_heads, q.dtype,
                       _sm_count(q.device))
    return launch(q, k, v, n_heads, mask, plan)
