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

Caches are f32 or bf16, with q and the new rows of the same dtype, or int8
(the int8 KV cache of int8max serving), with an f32 or bf16 q and int8 new
rows the caller has already quantized; its scales are folded in by the
caller, K's into q and V's into y. The CUDA code runs int8 caches through
a kernel of their own (see the source's note), whose launch `_launch_plan`
plans; `q_fixed_point` and `widen_int8_words` are plain
mirrors of its fixed-point q and its widening of V, which the CPU tests
hold to their invariants.

`utils/tracing.py`'s counters `k1.launches` and `k1.int8_launches` count
every launch of the kernel and those on int8 caches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ..utils import tracing
from . import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FLOATS = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64)  # the head dims of the repo's configs

# The int8 kernel's launch: at most 24 heads (warps) a block, 4 when the
# blocks exceed one wave; 64 cache rows a round. The largest dynamic shared
# memory a block may opt in to on an H100 (227 KB).
_I8_HEADS, _I8_WAVE_HEADS, _I8_ROUND_ROWS = 24, 4, 64
SMEM_PER_BLOCK_MAX = 232448
# 2^23 + 128: the f32 whose low byte is k + 128 is 2^23 + 128 + k.
_I8_MAGIC_BITS, _I8_MAGIC = 0x4B000000, 8388736.0


def widen_int8_words(words: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's widening of V (`widen_cols`) in plain PyTorch: int32
    words [...], each four int8 values packed little-endian, to f32
    [..., 4] through the kernel's constants: XOR 0x80808080 (byte i becomes
    k_i + 128), byte i under the exponent byte 0x4B (the kernel's byte
    permute), minus 2^23 + 128. Equals `.float()` of the bytes for all 256
    values."""
    u = (words.to(torch.int64) & 0xFFFFFFFF) ^ 0x80808080
    shifts = torch.arange(0, 32, 8, device=words.device)
    low = (u[..., None] >> shifts) & 0xFF
    bits = (low | _I8_MAGIC_BITS).to(torch.int32)
    return bits.view(torch.float32) - _I8_MAGIC


def q_fixed_point(q: torch.Tensor, n_heads: int):
    """The int8 kernel's q in plain PyTorch: per (row, head), q * 2^shift
    rounded to the nearest integer (ties to even) = hi * 2^16 + lo, with
    -2^15 <= lo < 2^15 and shift = 156 - (biased exponent of the head's
    largest |q|), clamped to [-100, 100], so that |q| * 2^shift < 2^30.
    q [B, D] -> (hi, lo) int64 [B, heads, hd] and shift int64 [B, heads].
    The kernel scores a row as the exact integer sum of hi * k * 2^16 +
    lo * k over the head (16-bit by 8-bit products, `dp2a`), times
    2^-shift / sqrt(hd)."""
    B, D = q.shape
    qh = q.float().reshape(B, n_heads, D // n_heads)
    biased = (qh.abs().amax(-1).view(torch.int32) >> 23) & 0xFF
    shift = (156 - biased.long()).clamp(-100, 100)
    a = torch.round(qh * torch.pow(2.0, shift.float())[..., None]).long()
    hi = (a + 32768) >> 16
    return hi, a - hi * 65536, shift


class LaunchPlan(NamedTuple):
    """The int8 kernel's launch: `heads_per_block` warps a block, one a
    head, and `smem` bytes of dynamic shared memory a block. Both are 0 for
    float caches, whose kernel has a fixed launch."""
    heads_per_block: int
    smem: int


def _launch_plan(cache_dtype: torch.dtype, head_dim: int, n_heads: int,
                 batch: int, pos: int, sm_count: int) -> LaunchPlan:
    """The launch `hqt_decode_attention_step` takes at `pos` on a card of
    `sm_count` SMs. int8 caches: a whole batch row a block (up to 24 heads)
    while the blocks fit one wave, else 4 heads a block, so that blocks of
    several waves overlap on an SM; each warp gets 256 bytes of q words,
    then the K and V bytes and an f32 score of each of the round's rows
    (the new token and up to 64 cache rows), in whole 16-byte vectors."""
    if cache_dtype != torch.int8:
        return LaunchPlan(0, 0)
    hpb = min(n_heads, _I8_HEADS)
    if batch * -(-n_heads // hpb) > sm_count:
        hpb = min(n_heads, _I8_WAVE_HEADS)
    rows = min(pos, _I8_ROUND_ROWS) + 1
    warp = 256 + (rows * (2 * head_dim + 4) + 15) // 16 * 16
    return LaunchPlan(hpb, hpb * warp)


def decode_attention_step_plain(q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, layer: int, pos: int,
                                n_heads: int) -> torch.Tensor:
    """Plain PyTorch decode attention. q/k_new/v_new: [B, D]; caches:
    [L, T, B, D], updated in place at [layer, pos]. Returns y [B, D].

    Rows beyond `pos` are not read: the JAX oracle masks them to a -1e10
    score, whose softmax weight is exactly zero."""
    _check_dtypes(q, k_new, v_new, k_cache, v_cache)
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
    fn.argtypes = [i32, i32, ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr,
                   i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    return fn


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_dtypes(q, k_new, v_new, k_cache, v_cache):
    """Caches of one dtype: f32 or bf16 with q and the new rows alike, or
    int8 with int8 new rows and an f32 or bf16 q."""
    dtype = k_cache.dtype
    if v_cache.dtype != dtype or dtype not in _DTYPE_CODES:
        raise TypeError(f'decode attention takes float32, bfloat16 or int8 '
                        f'caches of one dtype, got {dtype} and '
                        f'{v_cache.dtype}')
    q_ok = q.dtype in _FLOATS if dtype == torch.int8 else q.dtype == dtype
    if not q_ok or k_new.dtype != dtype or v_new.dtype != dtype:
        raise TypeError(f'{dtype} caches take {dtype} new rows and a '
                        f'{"float" if dtype == torch.int8 else dtype} q, '
                        f'got q {q.dtype}, k_new {k_new.dtype}, v_new '
                        f'{v_new.dtype}')


def _check(q, k_new, v_new, k_cache, v_cache, layer, pos, n_heads):
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f'caches must be [L, T, B, D] of one shape, got '
                         f'{tuple(k_cache.shape)} and {tuple(v_cache.shape)}')
    L, T, B, D = k_cache.shape
    _check_dtypes(q, k_new, v_new, k_cache, v_cache)
    if D % n_heads or D // n_heads not in _HEAD_DIMS:
        raise ValueError(f'head dim {D}/{n_heads} not in {_HEAD_DIMS}')
    if not (0 <= layer < L and 0 <= pos < T):
        raise IndexError(f'layer {layer} / pos {pos} outside cache [{L}, {T}]')
    # The kernel loads, stores and copies (cp.async) 16-byte vectors.
    for name, t in (('k_cache', k_cache), ('v_cache', v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be contiguous and 16-byte aligned')
    for name, t in (('q', q), ('k_new', k_new), ('v_new', v_new)):
        if t.shape != (B, D):
            raise ValueError(f'{name} must be [{B}, {D}], got '
                             f'{tuple(t.shape)}')
        if (t.stride(1) != 1 or t.stride(0) * t.element_size() % 16
                or t.data_ptr() % 16):
            raise ValueError(f'{name} rows must be contiguous and 16-byte '
                             f'aligned')
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
    [L, T, B, D], float with q and the new rows of their dtype, or int8
    with int8 new rows and a float q. The caches are updated in place.
    Returns y [B, D] in q's dtype."""
    if k_cache.device.type == 'cpu':
        return decode_attention_step_plain(q, k_new, v_new, k_cache, v_cache,
                                           layer, pos, n_heads)
    if k_cache.device.type != 'cuda':
        raise ValueError(f'no decode attention for device {k_cache.device}')
    _check(q, k_new, v_new, k_cache, v_cache, layer, pos, n_heads)
    L, T, B, D = k_cache.shape
    plan = _launch_plan(k_cache.dtype, D // n_heads, n_heads, B, pos,
                        _sm_count(k_cache.device.index))
    if plan.smem > SMEM_PER_BLOCK_MAX:
        raise ValueError(f'the decode attention launch needs {plan.smem} '
                         f'bytes of shared memory a block, more than '
                         f'{SMEM_PER_BLOCK_MAX}')
    y = torch.empty((B, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(_DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype],
                   q.data_ptr(), k_new.data_ptr(),
                   v_new.data_ptr(), q.stride(0), k_new.stride(0),
                   v_new.stride(0), k_cache.data_ptr(), v_cache.data_ptr(),
                   y.data_ptr(), B, T, D, n_heads, layer, pos,
                   plan.heads_per_block, plan.smem, stream)
    if rc != 0:
        raise RuntimeError(f'decode_attention kernel launch failed: CUDA '
                           f'error {rc}')
    tracing.count('k1.launches')
    if k_cache.dtype == torch.int8:
        tracing.count('k1.int8_launches')
    return y
