"""GroupNorm (32 groups, affine), optionally followed by swish, of
channels-last maps.

`group_norm_swish` is the wrapper of the hand-written CUDA kernel pair
`csrc/group_norm.cu` (no TPU counterpart: the JAX package leaves GroupNorm
to XLA). It takes a [B, C, H, W] map in float32 or bfloat16 and returns
one of the same dtype, channels-last: an input in another layout costs
one copy (of the input on the card, of the output on the CPU, whose sums
then keep the plain version's order), and the counter `gn.layout_copies`
counts it. On a CUDA tensor it launches the kernel pair (`gn.launches`
counts each pair) or raises; on a CPU tensor it runs
`group_norm_swish_plain`.

`group_norm_swish_plain` is the stage-1 modules' arithmetic as it stood
before the kernel: F.group_norm on the map in float32, rounded back to its
dtype, then swish in that dtype (the sigmoid rounded, then the
product). The kernel rounds at the same points; only the order of the
statistics' sums differs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import cuda_build

GROUPS = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# How the kernel cuts a map: 256 threads a block, each a 16-byte column of
# the channels; a block's tile of pixels holds about BLOCK_ELEMENTS
# elements, fewer where the grid would otherwise hold under BLOCKS_PER_SM
# blocks an SM.
THREADS = 256
BLOCK_ELEMENTS = 1 << 17
BLOCKS_PER_SM = 4


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def is_channels_last(x: torch.Tensor) -> bool:
    return x.is_contiguous(memory_format=torch.channels_last)


def group_norm_swish_plain(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, eps: float,
                           with_swish: bool = False) -> torch.Tensor:
    """Plain PyTorch GroupNorm of 32 groups in float32, rounded to x's
    dtype, then swish if asked, in the layout F.group_norm returns (x's on
    the CPU, NCHW on CUDA)."""
    y = F.group_norm(x.float(), GROUPS, weight.float(), bias.float(),
                     eps).to(x.dtype)
    return _swish(y) if with_swish else y


def tile_plan(n: int, pixels: int, channels: int, dtype: torch.dtype,
              n_sms: int) -> Tuple[int, int]:
    """(pixels a tile, tiles a sample) of the kernels' grid for n maps of
    `pixels` pixels and `channels` channels: tiles of whole rows of threads
    (256 / (channels / values in 16 bytes) pixels each pass), about
    BLOCK_ELEMENTS elements each, halved while the grid holds fewer than
    BLOCKS_PER_SM blocks an SM."""
    rows = THREADS // (channels * dtype.itemsize // 16)
    tile = max(rows, BLOCK_ELEMENTS // channels // rows * rows)
    tile = min(tile, -(-pixels // rows) * rows)
    while tile > rows and n * -(-pixels // tile) < BLOCKS_PER_SM * n_sms:
        tile = max(rows, tile // 2 // rows * rows)
    return tile, -(-pixels // tile)


@functools.cache
def _kernel():
    fn = cuda_build.load('group_norm').hqt_group_norm
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                   i32, ctypes.c_float, i32, ptr]
    fn.restype = i32
    return fn


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f'need x [B, C, H, W], got {tuple(x.shape)}')
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'group_norm kernel takes float32 or bfloat16, got '
                        f'{x.dtype}')
    B, C, H, W = x.shape
    if C % GROUPS or C * x.dtype.itemsize // 16 > THREADS:
        raise ValueError(f'need C a multiple of {GROUPS} and at most '
                         f'{THREADS * 16 // x.dtype.itemsize}, got {C}')
    if B > 65535 or H * W * C >= 2**31:
        raise ValueError(f'map too large for the kernel: {tuple(x.shape)}')
    if x.data_ptr() % 16:
        raise ValueError('x must be 16-byte aligned')
    for name, t in (('weight', weight), ('bias', bias)):
        if t.shape != (C,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'{name} must be a contiguous [{C}] on '
                             f'{x.device}')
        if t.dtype not in _DTYPE_CODES or t.dtype != weight.dtype:
            raise TypeError(f'weight and bias must share float32 or '
                            f'bfloat16, got {weight.dtype}, {bias.dtype}')


def group_norm_swish(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float,
                     with_swish: bool = False) -> torch.Tensor:
    """GroupNorm of 32 groups of x [B, C, H, W] with weight and bias [C]
    (float32 or bfloat16), then swish if asked: the CUDA kernel pair for
    CUDA tensors, the plain version for CPU tensors. Returns x's dtype,
    channels-last. Takes B * tiles * 256 bytes of scratch (`tile_plan`)."""
    if not is_channels_last(x):
        tracing.count('gn.layout_copies')
        if x.device.type != 'cpu':
            x = x.contiguous(memory_format=torch.channels_last)
    if x.device.type == 'cpu':
        # on x as given, so that the CPU's sums keep the plain order
        return group_norm_swish_plain(x, weight, bias, eps, with_swish
                                      ).contiguous(
            memory_format=torch.channels_last)
    if x.device.type != 'cuda':
        raise ValueError(f'no group_norm kernel for device {x.device}')
    _check(x, weight, bias)
    B, C, H, W = x.shape
    y = torch.empty((B, H, W, C), dtype=x.dtype,
                    device=x.device).permute(0, 3, 1, 2)
    if y.numel() == 0:
        return y
    tile, tiles = tile_plan(B, H * W, C, x.dtype, _sm_count(x.device))
    part = torch.empty((B, tiles, GROUPS, 2), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(_DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype],
                   x.data_ptr(), y.data_ptr(), part.data_ptr(),
                   weight.data_ptr(), bias.data_ptr(), B, H * W, C, tile,
                   tiles, eps, int(with_swish), stream)
    if rc != 0:
        raise RuntimeError(f'group_norm kernel launch failed: CUDA error {rc}')
    tracing.count('gn.launches')
    return y
