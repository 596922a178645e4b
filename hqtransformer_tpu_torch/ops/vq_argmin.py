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
copy of the codebook is made. The two versions round differently,
so they may pick different codes only where two distances tie to within
f32 rounding.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE_ROWS = 128     # rows of z per block (kBM in the kernel)
TILE_CODES = 128    # codes per tile of the codebook walk (kBN)
D_STEP = 16         # D is staged through shared memory in this many (kBK)
BLOCKS_PER_SM = 2   # the kernel's __launch_bounds__ minimum


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


def codebook_splits(n: int, k: int, n_sms: int) -> int:
    """How many slices of the codebook the kernel's grid walks in parallel.
    A block owns TILE_ROWS rows and one slice; few row tiles (the top level
    at N = 8192 has 64, the 3-level top at batch 32 has 16) would leave
    most of the card's SMs idle, so the codebook is split into as many
    slices as one wave of blocks can hold, at most one per code tile, and
    then into as few as give each slice the same number of tiles."""
    row_tiles = -(-n // TILE_ROWS)
    code_tiles = -(-k // TILE_CODES)
    splits = max(1, min(code_tiles, n_sms * BLOCKS_PER_SM // row_tiles))
    return -(-code_tiles // -(-code_tiles // splits))


def _check(z_flat: torch.Tensor, embedding: torch.Tensor) -> None:
    if z_flat.dim() != 2 or embedding.dim() != 2:
        raise ValueError(f'need z [N, D] and embedding [K, D], got '
                         f'{tuple(z_flat.shape)} and '
                         f'{tuple(embedding.shape)}')
    (n, d), (k, d_e) = z_flat.shape, embedding.shape
    if d != d_e:
        raise ValueError(f'z has dim {d}, the codebook {d_e}')
    if d % D_STEP or d == 0 or k == 0:
        raise ValueError(f'need D a positive multiple of {D_STEP} and K >= 1,'
                         f' got D={d}, K={k}')
    if max(n, k, d) >= 2**31:
        raise ValueError(f'sizes too large for the kernel: N={n} K={k} D={d}')
    for name, t in (('z_flat', z_flat), ('embedding', embedding)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f'vq_argmin kernel takes float32 or bfloat16, '
                            f'got {name} {t.dtype}')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be contiguous and 16-byte aligned')
    if embedding.device != z_flat.device:
        raise ValueError('z_flat and embedding must be on one device')


def vq_argmin(z_flat: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Nearest codes: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. z_flat [N, D] and embedding [K, D], each float32 or
    bfloat16, contiguous, D a multiple of 16. Returns int64 codes [N]."""
    if z_flat.device.type == 'cpu':
        return vq_argmin_plain(z_flat, embedding)
    if z_flat.device.type != 'cuda':
        raise ValueError(f'no nearest-code search for device {z_flat.device}')
    _check(z_flat, embedding)
    (n, d), k = z_flat.shape, embedding.shape[0]
    dev = z_flat.device
    codes = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return codes
    esq = torch.empty(k, dtype=torch.float32, device=dev)
    splits = codebook_splits(
        n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_val = torch.empty((splits, n), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(_DTYPE_CODES[z_flat.dtype], _DTYPE_CODES[embedding.dtype],
                   z_flat.data_ptr(), embedding.data_ptr(), esq.data_ptr(),
                   part_val.data_ptr(), part_idx.data_ptr(), codes.data_ptr(),
                   n, k, d, splits, stream)
    if rc != 0:
        raise RuntimeError(f'vq_argmin kernel launch failed: CUDA error {rc}')
    vq_argmin.launches += 1
    return codes


vq_argmin.launches = 0
