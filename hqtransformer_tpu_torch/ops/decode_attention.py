"""Single-token decode attention against the packed [L, T, B, D] KV cache.

`decode_attention_step` is the wrapper of the hand-written CUDA kernel
`csrc/decode_attention.cu`, the port of the TPU kernel
`hqtransformer_tpu/ops/pallas_attention.py::decode_attention_step`. On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
`decode_attention_step_plain`, the plain PyTorch version with the semantics
of the JAX oracle `decode_attention_step_xla`.

Both write the new K/V row into the caches IN PLACE (the JAX functions
return updated copies instead) and return y [B, D]. Scores are q.k/sqrt(hd)
in f32 over cache rows t <= pos (the new row included), the softmax is f32
and A.V accumulates in f32; y comes back in q's dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)  # the head dims of the repo's configs


def decode_attention_step_plain(q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, layer: int, pos: int,
                                n_heads: int) -> torch.Tensor:
    """Plain PyTorch decode attention. q/k_new/v_new: [B, D]; caches:
    [L, T, B, D], updated in place at [layer, pos]. Returns y [B, D].

    Rows beyond `pos` are not read: the JAX oracle masks them to a -1e10
    score, whose softmax weight is exactly zero."""
    B, D = q.shape
    hd = D // n_heads
    k_cache[layer, pos] = k_new.to(k_cache.dtype)
    v_cache[layer, pos] = v_new.to(v_cache.dtype)
    kl = k_cache[layer, :pos + 1].reshape(pos + 1, B, n_heads, hd).float()
    vl = v_cache[layer, :pos + 1].reshape(pos + 1, B, n_heads, hd).float()
    qh = q.reshape(B, n_heads, hd).float()
    att = torch.einsum('bhd,tbhd->bht', qh, kl) / math.sqrt(hd)
    att = torch.softmax(att, dim=-1)
    y = torch.einsum('bht,tbhd->bhd', att, vl).reshape(B, D)
    return y.to(q.dtype)


@functools.cache
def _kernel():
    fn = cuda_build.load('decode_attention').hqt_decode_attention_step
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [i32, ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr,
                   i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    return fn


def _check(q, k_new, v_new, k_cache, v_cache, layer, pos, n_heads):
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f'caches must be [L, T, B, D] of one shape, got '
                         f'{tuple(k_cache.shape)} and {tuple(v_cache.shape)}')
    L, T, B, D = k_cache.shape
    dtype = k_cache.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f'decode attention kernel takes float32 or bfloat16 '
                        f'caches, got {dtype}')
    if D % n_heads or D // n_heads not in _HEAD_DIMS:
        raise ValueError(f'head dim {D}/{n_heads} not in {_HEAD_DIMS}')
    if not (0 <= layer < L and 0 <= pos < T):
        raise IndexError(f'layer {layer} / pos {pos} outside cache [{L}, {T}]')
    ept = D // n_heads // 32
    for name, t in (('k_cache', k_cache), ('v_cache', v_cache)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    for name, t in (('q', q), ('k_new', k_new), ('v_new', v_new)):
        if t.shape != (B, D) or t.dtype != dtype:
            raise ValueError(f'{name} must be [{B}, {D}] {dtype}, got '
                             f'{tuple(t.shape)} {t.dtype}')
        if (t.stride(1) != 1 or t.stride(0) % ept
                or t.data_ptr() % (ept * t.element_size())):
            raise ValueError(f'{name} rows must be contiguous and aligned '
                             f'to {ept} elements')
    for t in (q, k_new, v_new, v_cache):
        if t.device != k_cache.device:
            raise ValueError('all tensors must be on one device')


def decode_attention_step(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, layer: int, pos: int,
                          n_heads: int) -> torch.Tensor:
    """Decode attention for one layer at time `pos`: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. q/k_new/v_new: [B, D]
    (rows may be strided, as slices of a fused qkv); caches: contiguous
    [L, T, B, D], all of one dtype. The caches are updated in place.
    Returns y [B, D]."""
    if k_cache.device.type == 'cpu':
        return decode_attention_step_plain(q, k_new, v_new, k_cache, v_cache,
                                           layer, pos, n_heads)
    if k_cache.device.type != 'cuda':
        raise ValueError(f'no decode attention for device {k_cache.device}')
    _check(q, k_new, v_new, k_cache, v_cache, layer, pos, n_heads)
    L, T, B, D = k_cache.shape
    y = torch.empty((B, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(_DTYPE_CODES[q.dtype], q.data_ptr(), k_new.data_ptr(),
                   v_new.data_ptr(), q.stride(0), k_new.stride(0),
                   v_new.stride(0), k_cache.data_ptr(), v_cache.data_ptr(),
                   y.data_ptr(), B, T, D, n_heads, layer, pos, stream)
    if rc != 0:
        raise RuntimeError(f'decode_attention kernel launch failed: CUDA '
                           f'error {rc}')
    decode_attention_step.launches += 1
    return y


decode_attention_step.launches = 0
