"""Nearest-code search of vector quantization: codes[n] = argmin_k
|z_n - e_k|^2, ties to the lowest index.

`vq_argmin` is the wrapper of the hand-written CUDA kernel
`csrc/vq_argmin.cu`, the port of the TPU kernel
`hqtransformer_tpu/ops/pallas_vq.py::vq_argmin_pallas`. On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs `vq_argmin_plain`,
the plain PyTorch version with the semantics of the JAX package's XLA path
(`codebook_distances`, |z|^2 included, then argmin, in f32).

The kernel scores |e_k|^2 - 2 z_n.e_k in f32 (|z_n|^2 cannot change the
argmin) without writing the [N, K] score matrix anywhere: each block keeps a
running (min, argmin) for its rows over a slice of the codebook, and a
second pass reduces the slices' results in code order. |e|^2 is computed in
f32, as the JAX wrapper does, by a first pass of the same launch, so no f32
copy of the codebook is made. The kernel has two variants, picked from the
dtype pair by `kernel_variant`: bf16 z with a bf16 codebook (as served)
runs on the tensor cores (`wgmma`, fed by TMA), whose bf16 products are
exact in f32; every other pair runs the f32 SIMT variant, which keeps f32
operands f32-exact. The two versions round differently, so they may pick
different codes only where two distances tie to within f32 rounding.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class Tiling:
    """How a variant of the kernel cuts the search: rows of z per block,
    codes per tile of the codebook walk, the multiple D must be of, and the
    blocks one SM holds."""
    rows: int
    codes: int
    d_step: int
    blocks_per_sm: int


TILINGS = {'simt': Tiling(rows=128, codes=128, d_step=16, blocks_per_sm=2),
           'wgmma': Tiling(rows=128, codes=256, d_step=8, blocks_per_sm=1)}
CODE_PAD = 256   # |e|^2 scratch is padded to a multiple of this many codes


def kernel_variant(z_dtype: torch.dtype, e_dtype: torch.dtype) -> str:
    """The kernel variant for a dtype pair: 'wgmma' (bf16 tensor cores)
    when z and the codebook are both bf16, else 'simt' (f32 FMAs, which
    keep f32 operands exact)."""
    if z_dtype == torch.bfloat16 and e_dtype == torch.bfloat16:
        return 'wgmma'
    return 'simt'


def codebook_distances(z_flat: torch.Tensor,
                       embedding: torch.Tensor) -> torch.Tensor:
    """Expanded squared-L2 distances d[n, k] = |z|^2 + |e|^2 - 2 z.e in f32:
    z_flat [N, D], embedding [K, D] -> [N, K]."""
    z = z_flat.float()
    e = embedding.float()
    z_sq = (z * z).sum(dim=1, keepdim=True)
    e_sq = (e * e).sum(dim=1)
    return z_sq + e_sq[None, :] - 2.0 * (z @ e.T)


def vq_argmin_plain(z_flat: torch.Tensor,
                    embedding: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch nearest-code search: int64 codes [N]."""
    return torch.argmin(codebook_distances(z_flat, embedding), dim=1)


@functools.cache
def _kernel():
    fn = cuda_build.load('vq_argmin').hqt_vq_argmin
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                   i32, ptr]
    fn.restype = i32
    return fn


def codebook_splits(n: int, k: int, n_sms: int, variant: str) -> int:
    """How many slices of the codebook the kernel's grid walks in parallel.
    A block owns a tile of rows and one slice; few row tiles (the flagship
    top level at N = 8192, the 3-level top at batch 32) would leave most
    of the card's SMs idle, so the codebook is split into as many slices as
    one wave of blocks can hold, at most one per code tile, and then into
    as few as give each slice the same number of tiles."""
    tiling = TILINGS[variant]
    row_tiles = -(-n // tiling.rows)
    code_tiles = -(-k // tiling.codes)
    splits = max(1, min(code_tiles,
                        n_sms * tiling.blocks_per_sm // row_tiles))
    return -(-code_tiles // -(-code_tiles // splits))


def _check(z_flat: torch.Tensor, embedding: torch.Tensor) -> str:
    """Raise on what the kernel does not take; return its variant."""
    if z_flat.dim() != 2 or embedding.dim() != 2:
        raise ValueError(f'need z [N, D] and embedding [K, D], got '
                         f'{tuple(z_flat.shape)} and '
                         f'{tuple(embedding.shape)}')
    (n, d), (k, d_e) = z_flat.shape, embedding.shape
    if d != d_e:
        raise ValueError(f'z has dim {d}, the codebook {d_e}')
    for name, t in (('z_flat', z_flat), ('embedding', embedding)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f'vq_argmin kernel takes float32 or bfloat16, '
                            f'got {name} {t.dtype}')
    variant = kernel_variant(z_flat.dtype, embedding.dtype)
    step = TILINGS[variant].d_step
    if d % step or d == 0 or k == 0:
        # the TMA loads of the wgmma variant need rows of a multiple of 16
        # bytes; the SIMT variant stages D 16 columns at a time
        raise ValueError(f'need D a positive multiple of {step} ({variant} '
                         f'variant; row stride {d * z_flat.element_size()} '
                         f'bytes) and K >= 1, got D={d}, K={k}')
    if max(n, k, d) >= 2**31:
        raise ValueError(f'sizes too large for the kernel: N={n} K={k} D={d}')
    for name, t in (('z_flat', z_flat), ('embedding', embedding)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be contiguous and 16-byte aligned')
    if embedding.device != z_flat.device:
        raise ValueError('z_flat and embedding must be on one device')
    return variant


def vq_argmin(z_flat: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Nearest codes: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. z_flat [N, D] and embedding [K, D], each float32 or
    bfloat16, contiguous and 16-byte aligned; D a multiple of 8 when both
    are bf16 (the wgmma variant), else of 16. Returns int64 codes [N]."""
    if z_flat.device.type == 'cpu':
        return vq_argmin_plain(z_flat, embedding)
    if z_flat.device.type != 'cuda':
        raise ValueError(f'no nearest-code search for device {z_flat.device}')
    variant = _check(z_flat, embedding)
    (n, d), k = z_flat.shape, embedding.shape[0]
    dev = z_flat.device
    codes = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return codes
    esq = torch.empty(-(-k // CODE_PAD) * CODE_PAD, dtype=torch.float32,
                      device=dev)
    splits = codebook_splits(
        n, k, torch.cuda.get_device_properties(dev).multi_processor_count,
        variant)
    part_val = torch.empty((splits, n), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the kernel takes the same variant from the dtype pair
    rc = _kernel()(_DTYPE_CODES[z_flat.dtype],
                   _DTYPE_CODES[embedding.dtype], z_flat.data_ptr(),
                   embedding.data_ptr(), esq.data_ptr(), part_val.data_ptr(),
                   part_idx.data_ptr(), codes.data_ptr(), n, k, d, splits,
                   stream)
    if rc != 0:
        raise RuntimeError(f'vq_argmin kernel launch failed: CUDA error {rc}')
    vq_argmin.launches += 1
    return codes


vq_argmin.launches = 0
