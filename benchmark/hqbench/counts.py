"""The yardstick's counts: the card's peaks, the bytes and operations of
the port's three hand-written kernels, and the model's FLOPs per sample
and per training image.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, at the 700 W
limit): 3.35 TB/s of HBM3, 989 TFLOP/s in bf16 on the tensor cores,
67 TFLOP/s in float32 outside them. A kernel's bound is the larger of
its bytes over the memory rate and its operations over the rate of its
operands' type; each input byte is counted read once and each output
byte written once.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import stage1, stage2

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
K2_OPS_PER_LOGIT = 12


def bound_s(n_bytes: float, flops: float,
            flops_per_s: float = F32_FLOPS_PER_S) -> float:
    """The least time in seconds: bytes over the memory rate or operations
    over the peak, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / flops_per_s)


def k1_bytes(pos: int, batch: int, d: int, cache_bytes: int = 2) -> int:
    """K1 (decode attention) at cache row `pos` with a bf16 q of width d:
    q, k_new and v_new and the 2 pos cache rows read once, the two new
    rows and the output y written once; cache and new rows of
    `cache_bytes` a value."""
    c = cache_bytes
    return batch * d * (2 + 2 * c + 2 * pos * c + 2 * c + 2)


def k1_flops(pos: int, batch: int, d: int) -> int:
    """q.k and a.v over the pos + 1 rows."""
    return 2 * 2 * (pos + 1) * batch * d


def k1_bound_s(pos: int, batch: int, d: int) -> float:
    return bound_s(k1_bytes(pos, batch, d), k1_flops(pos, batch, d))


def k2_bytes(rows: int, vocab: int, logit_bytes: int = 2) -> int:
    """K2 (top-k sampling) over [rows, vocab] logits: the logits and one
    f32 uniform a row read once, one int32 code a row written once."""
    return rows * vocab * logit_bytes + rows * 8


def k2_ops(rows: int, vocab: int) -> int:
    """The select's and the draw's operations, K2_OPS_PER_LOGIT a logit."""
    return K2_OPS_PER_LOGIT * rows * vocab


def k2_bound_s(rows: int, vocab: int) -> float:
    return bound_s(k2_bytes(rows, vocab), k2_ops(rows, vocab))


def k3_bytes(n: int, k: int, d: int, z_bytes: int, e_bytes: int) -> int:
    """K3 (nearest code) of n rows of width d against k codes: z and the
    codebook read once, one int64 code a row written once."""
    return n * d * z_bytes + k * d * e_bytes + n * 8


def k3_flops(n: int, k: int, d: int) -> int:
    """One multiply and one add per (row, code, dim): one 2 N K D pass,
    bounded at the bf16 tensor-core rate whatever the operands' type."""
    return 2 * n * k * d


def k3_bound_s(n: int, k: int, d: int, z_bytes: int, e_bytes: int) -> float:
    return bound_s(k3_bytes(n, k, d, z_bytes, e_bytes), k3_flops(n, k, d),
                   BF16_FLOPS_PER_S)


def _meta(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(v.shape, device='meta') for k, v in state.items()}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def stage2_forward_flops(w2: Dict[str, torch.Tensor], cfg2: dict,
                         cells: int, code_lens: Sequence[int]) -> int:
    """FLOPs of the reference's teacher-forced stage-2 forward of one
    sample of `cells` cells, each with codes of `code_lens` per level
    (1, 4 or 1, 4, 16): every product of the spatial blocks, the depth
    blocks, attention and the heads, counted on shapes alone (meta
    tensors). Attention is counted over every position, masked or not."""
    w = _meta(w2)
    with torch.device('meta'):
        labels = torch.zeros(1, dtype=torch.long)
        codes = [torch.zeros((1, cells) + ((n,) if i else ()),
                             dtype=torch.long)
                 for i, n in enumerate(code_lens)]
    return _count(lambda: stage2.forward(w, cfg2, labels, codes))


def decode_flops(w1: Dict[str, torch.Tensor], code_sides: Sequence[int]
                 ) -> int:
    """FLOPs of the reference's stage-1 decode of one sample's code maps
    (their sides, top first): the convolutions and attention products."""
    w = _meta(w1)
    with torch.device('meta'):
        codes = [torch.zeros((1, s, s), dtype=torch.long)
                 for s in code_sides]
    return _count(lambda: stage1.decode(w, codes))


def encode_flops(w1: Dict[str, torch.Tensor], resolution: int) -> int:
    """FLOPs of the reference's 2-level stage-1 encode of one image: the
    encoder's products and both nearest-code searches."""
    w = _meta(w1)
    with torch.device('meta'):
        images = torch.zeros((1, resolution, resolution, 3))
    return _count(lambda: stage1.encode_2level(w, images))


def code_sides(w1: Dict[str, torch.Tensor], resolution: int):
    """The sides of the 2-level stage 1's top and bottom code maps of an
    image of `resolution` (the reference's encode on shapes alone)."""
    w = _meta(w1)
    with torch.device('meta'):
        images = torch.zeros((1, resolution, resolution, 3))
    top, bottom = stage1.encode_2level(w, images)
    return top.shape[1], bottom.shape[1]
