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
f32 from the codebook as given, as the JAX wrapper does, by a first pass of
the same launch. Every dtype pair runs on the tensor cores (`wgmma`, fed by
TMA): an f32 operand is split into three bf16 pieces (`split3`), whose sum
is the f32 value exactly, a bf16 operand is its own single piece
(`kernel_variant` gives the piece counts), and the kernel sums the exact
bf16 products of the pairs `piece_pairs` lists: 6 for f32 x f32, 3 for a
mixed pair, 1 for bf16 x bf16. `split_scores` is the plain version of
those scores. The kernel and `vq_argmin_plain` round differently, so they
may pick different codes only where two distances tie to within f32
rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..utils import tracing
from . import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# How the kernel cuts the search: rows of z per block, codes per tile of
# the codebook walk (|e|^2 scratch is padded to a multiple of it), the
# multiple D must be of (16-byte rows for TMA), one block an SM.
ROWS_PER_BLOCK = 128
CODE_PAD = 256
D_STEP = 8
# (z piece, codebook piece) pairs in the order the kernel sums them; a dtype
# pair takes those whose pieces both exist, and the wrapper hands the kernel
# that list (`pack_pairs`). Dropped for f32 x f32: mid.lo, lo.mid and lo.lo,
# each at most ~2^-24 of |z_i e_i|.
PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def kernel_variant(z_dtype: torch.dtype,
                   e_dtype: torch.dtype) -> Tuple[int, int]:
    """The bf16 pieces (of z, of the codebook) the kernel runs for a dtype
    pair: three for an f32 operand, one for a bf16 operand."""
    return tuple(3 if dt == torch.float32 else 1 for dt in (z_dtype, e_dtype))


def piece_pairs(pieces: Tuple[int, int]) -> Tuple[Tuple[int, int], ...]:
    """The pairs of pieces whose products the kernel sums."""
    return tuple((p, q) for p, q in PAIRS if p < pieces[0] and q < pieces[1])


def pack_pairs(pairs: Tuple[Tuple[int, int], ...]) -> int:
    """The kernel's form of a pair list: pair i is bits 4i..4i+3, the z
    piece in the low two, the codebook piece in the high two."""
    return sum((p | q << 2) << 4 * i for i, (p, q) in enumerate(pairs))


def split3(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The three bf16 pieces of f32 x: hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid); hi + mid + lo == x for normal x."""
    hi = x.bfloat16()
    rest = x - hi.float()
    mid = rest.bfloat16()
    return hi, mid, (rest - mid.float()).bfloat16()


def split_scores(z_flat: torch.Tensor,
                 embedding: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's scores [N, K] in f32: |e|^2 - 2 times
    the sum over `piece_pairs` of the pieces' products."""
    pz, pe = ((split3(t) if t.dtype == torch.float32 else (t,))
              for t in (z_flat, embedding))
    dot = sum(pz[p].float() @ pe[q].float().T
              for p, q in piece_pairs((len(pz), len(pe))))
    e = embedding.float()
    return (e * e).sum(dim=1)[None, :] - 2.0 * dot


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
    fn.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                   i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    return fn


def codebook_splits(n: int, k: int, n_sms: int) -> int:
    """How many slices of the codebook the kernel's grid walks in parallel.
    A block owns a tile of rows and one slice; few row tiles (the flagship
    top level at N = 8192, the 3-level top at batch 32) would leave most
    of the card's SMs idle, so the codebook is split into as many slices as
    one wave of blocks can hold, at most one per code tile, and then into
    as few as give each slice the same number of tiles. The pieces do not
    change it: every pair list has the same tiles."""
    row_tiles = -(-n // ROWS_PER_BLOCK)
    code_tiles = -(-k // CODE_PAD)
    splits = max(1, min(code_tiles, n_sms // row_tiles))
    return -(-code_tiles // -(-code_tiles // splits))


def _check(z_flat: torch.Tensor,
           embedding: torch.Tensor) -> Tuple[int, int]:
    """Raise on what the kernel does not take; return its pieces."""
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
    pieces = kernel_variant(z_flat.dtype, embedding.dtype)
    if d % D_STEP or d == 0 or k == 0:
        # TMA loads bf16 rows of a multiple of 16 bytes; the split pass
        # reads 8 values at a time
        raise ValueError(f'need D a positive multiple of {D_STEP} (rows of '
                         f'16-byte multiples in bf16) and K >= 1, got D={d}, '
                         f'K={k}')
    if max(n, k, d) >= 2**31:
        raise ValueError(f'sizes too large for the kernel: N={n} K={k} D={d}')
    for name, t in (('z_flat', z_flat), ('embedding', embedding)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be contiguous and 16-byte aligned')
    if embedding.device != z_flat.device:
        raise ValueError('z_flat and embedding must be on one device')
    return pieces


def vq_argmin(z_flat: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Nearest codes: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. z_flat [N, D] and embedding [K, D], each float32 or
    bfloat16, contiguous and 16-byte aligned, D a multiple of 8. An f32
    operand takes 1.5x its bytes of scratch for its pieces. Returns int64
    codes [N]."""
    if z_flat.device.type == 'cpu':
        return vq_argmin_plain(z_flat, embedding)
    if z_flat.device.type != 'cuda':
        raise ValueError(f'no nearest-code search for device {z_flat.device}')
    pz, pe = _check(z_flat, embedding)
    (n, d), k = z_flat.shape, embedding.shape[0]
    dev = z_flat.device
    codes = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return codes
    esq = torch.empty(-(-k // CODE_PAD) * CODE_PAD, dtype=torch.float32,
                      device=dev)
    splits = codebook_splits(
        n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_val = torch.empty((splits, n), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, n), dtype=torch.int32, device=dev)
    z_pieces, e_pieces = (
        torch.empty((p, rows, d), dtype=torch.bfloat16, device=dev)
        if p > 1 else None for p, rows in ((pz, n), (pe, k)))
    pairs = piece_pairs((pz, pe))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(_DTYPE_CODES[z_flat.dtype],
                   _DTYPE_CODES[embedding.dtype], z_flat.data_ptr(),
                   embedding.data_ptr(),
                   None if z_pieces is None else z_pieces.data_ptr(),
                   None if e_pieces is None else e_pieces.data_ptr(),
                   esq.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
                   codes.data_ptr(), n, k, d, splits, len(pairs),
                   pack_pairs(pairs), stream)
    if rc != 0:
        raise RuntimeError(f'vq_argmin kernel launch failed: CUDA error {rc}')
    tracing.count('k3.launches')
    return codes
