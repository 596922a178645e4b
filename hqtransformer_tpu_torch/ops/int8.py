"""A8W8 int8 arithmetic of int8max serving: static per-tensor activation
scales, per-output-channel weight scales, exact int32 accumulation.

Counterparts of the JAX helpers `_quant_per_tensor`, `_quant_weight_cols`,
`_int8_matmul` and `_quantize_rows`
(`hqtransformer_tpu/models/stage2/layers.py`), of the A8W8 branch of
`QuantizableConv` and of `int8_scales_from_calib`
(`hqtransformer_tpu/models/stage1/layers.py`).

Quantization divides by the scale (IEEE division: the divisor is always a
tensor on the operand's device, never a Python float, which CUDA would
turn into a multiply by the reciprocal), rounds half to even and clips to
[-127, 127]. The int8 x int8 -> int32 products are `torch._int_mm`
(cuBLASLt on a card; exact), as the JAX package leaves them to XLA's
`dot_general` and `conv_general_dilated`. `_int_mm` wants more than 16
rows and a depth and width that are multiples of 8: operands are padded
with zeros, which add nothing to an integer sum. There is no int8
convolution in PyTorch on CUDA, so a convolution is an `_int_mm` over an
im2col of the quantized input, built from per-tap shifted copies, in
bands of whole images that bound its extra memory.

Under tensor parallelism (`parallel/tp.py`) a row-parallel weight's
per-output-channel scale is the max over its whole input dim, which the
ranks share out (`quant_weight(group_max=...)`), so each rank's shard is
quantized as at tp 1; its product is the rank's int32 partial sum, summed
exactly over the group before the dequantization adds the bias once
(`int8_matmul(reduce=...)`), which makes it bit-equal to tp 1's. A
column-parallel or vocabulary-sharded weight's scales do not depend on the
cut.

`utils/tracing.py`'s counters `int8.matmul_launches` and
`int8.conv2d_launches` count the products, so a run can show that the int8
path was taken.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import tracing


@dataclass(frozen=True)
class Int8Serving:
    """The four switches of int8 serving, each off by default; int8max is
    all four on (`INT8MAX`). The JAX package reads them from the
    environment (HQT_INT8_DECODE, HQT_INT8_STAGE2, HQT_INT8_SPATIAL) and
    the sampler's cache_dtype; the port takes them as this argument.
    - kv_cache: the spatial KV cache in int8 (decode attention's int8
      variant), with calibrated per-channel scales;
    - depth_gemms: A8W8 gemms in the depth transformer: for the 2-level
      model in the `parallel` mode the depth-second chain and head_bot
      (the depth-first step and head_top stay float); in the
      `bidirectional` and `top2bot` modes nothing, as HQT_INT8_STAGE2
      changes nothing there in JAX (its int8 scope wraps the parallel
      chain alone); for the 3-level model every depth phase and every
      head_levels.<i>, except phase 0's K/V, which JAX computes with a
      float product (the JAX sampler wraps all three phases in its int8
      scope); the flat baselines have no depth transformer and take no
      gemm switch;
    - spatial_gemms: A8W8 gemms in the spatial prefill (a caption's
      too) and steps (the blocks.* gemms), and the 3-level cell
      embedding's `emb_blocks` (`transformerN`, N > 1), which the JAX
      sampler runs in the same scope; the 2-level `emb_blocks` stay float,
      as JAX embeds the 2-level cell outside that scope;
    - decode_convs: A8W8 convolutions in the stage-1 decoder.
    The gemm and conv switches need bf16 activations and raise otherwise,
    where JAX stays float silently. Spatial gemms come only with the depth
    ones, as HQT_INT8_SPATIAL acts only under HQT_INT8_STAGE2."""
    kv_cache: bool = False
    depth_gemms: bool = False
    spatial_gemms: bool = False
    decode_convs: bool = False

    def __post_init__(self):
        if self.spatial_gemms and not self.depth_gemms:
            raise ValueError('spatial int8 gemms need depth_gemms too, as '
                             'in the JAX package')


INT8MAX = Int8Serving(True, True, True, True)

QMAX = 127.0
# Extra device memory one band of an int8 convolution may hold: the im2col
# rows, their int32 products and the f32 dequantization.
CONV_BAND_BYTES = 1 << 30


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 scalar tensor on `like`'s device, so that dividing by it is
    an IEEE division on every device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _round_clip(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), -QMAX, QMAX).to(torch.int8)


def absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| as an f32 scalar tensor (exact in x's own dtype, without an
    f32 copy of x)."""
    lo, hi = torch.aminmax(x)
    return torch.maximum(hi, -lo).float()


def scale_from_absmax(m: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 scale max(m, 1e-8) / 127 (`int8_scales_from_calib`
    and the dynamic conv scale)."""
    return torch.clamp_min(m.float(), 1e-8) / _const(QMAX, m)


@contextlib.contextmanager
def recording_absmax(root: nn.Module, kind: type
                     ) -> Iterator[Dict[str, torch.Tensor]]:
    """Calibration: while the context is open, record max |input| of every
    `kind` module of `root` that runs, keyed by its name in `root`, as a
    running max over calls (forward pre-hooks, removed on exit; the JAX
    package sows the same into its 'int8_calib' collection)."""
    found: Dict[str, torch.Tensor] = {}

    def hook(name):
        def record(module, args):
            m = absmax(args[0])
            found[name] = m if name not in found else torch.maximum(
                found[name], m)
        return record

    handles = [m.register_forward_pre_hook(hook(name))
               for name, m in root.named_modules() if isinstance(m, kind)]
    try:
        yield found
    finally:
        for h in handles:
            h.remove()


def quant_per_tensor(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x / scale (f32 scalar tensor on x's device), rounded and clipped to
    int8."""
    return _round_clip(x.float() / scale)


def quantize_rows(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """Per-channel int8 of x [..., D] times inv_scale [D] (f32), as the JAX
    `_quantize_rows` multiplies by the reciprocal."""
    return _round_clip(x.float() * inv_scale)


Reduce = Callable[[torch.Tensor], torch.Tensor]


def quant_weight(w: torch.Tensor, group_max: Optional[Reduce] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a weight [O, ...] (a Linear's
    [O, I] or a conv's OIHW): (wq, w_scale [O] f32), the scale over every
    dim but the first. `group_max` (a row-parallel shard's: the max over
    the tp group) makes the absmax that of the whole input dim."""
    wf = w.float()
    dims = tuple(range(1, w.dim()))
    m = wf.abs().amax(dim=dims)
    if group_max is not None:
        m = group_max(m)
    w_scale = torch.clamp_min(m, 1e-8) / _const(QMAX, w)
    shape = (-1,) + (1,) * (w.dim() - 1)
    return _round_clip(wf / w_scale.reshape(shape)), w_scale


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _pad_cols(t: torch.Tensor, n: int) -> torch.Tensor:
    return t if t.shape[1] == n else F.pad(t, (0, n - t.shape[1]))


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Exact int32 product a [M, K] @ b_t.T of int8 a and int8 b_t [N, K]
    (K and N already multiples of 8). Rows are padded to a multiple of 8
    above 16, as `_int_mm` wants, and cut again."""
    M = a.shape[0]
    rows = max(24, _ceil8(M))
    if rows != M:
        a = F.pad(a, (0, 0, 0, rows - M))
    return torch._int_mm(a, b_t.t())[:M]


def _dequant(acc: torch.Tensor, out_scale: torch.Tensor,
             bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """int32 -> f32 x (x_scale * w_scale) [+ f32 bias] -> dtype."""
    y = acc.float() * out_scale
    if bias is not None:
        y = y + bias
    return y.to(dtype)


def int8_matmul(xq: torch.Tensor, w: 'Int8Weight', dtype: torch.dtype,
                reduce: Optional[Reduce] = None) -> torch.Tensor:
    """[..., I] int8 activations times a quantized weight -> [..., O] in
    `dtype`. `reduce` (a row-parallel shard's: the exact int32 sum over
    the tp group) sums the int32 partial products before the
    dequantization."""
    lead = xq.shape[:-1]
    a = _pad_cols(xq.reshape(-1, xq.shape[-1]), w.wq.shape[1])
    acc = int_mm(a, w.wq)[:, :w.out_features]
    if reduce is not None:
        acc = reduce(acc)
    y = _dequant(acc, w.out_scale, w.bias, dtype)
    tracing.count('int8.matmul_launches')
    return y.reshape(*lead, w.out_features)


@dataclass(frozen=True)
class Int8Weight:
    """A weight quantized once per serving call: wq [O', I'] int8 (a conv's
    taps flattened in (kh, kw, in) order; rows and columns padded with
    zeros to multiples of 8), w_scale [O] f32, the f32 bias, the static
    activation scale (None: a convolution takes max|x| / 127 per call) and
    then out_scale = x_scale * w_scale (the scales' product taken first, as
    in JAX)."""
    wq: torch.Tensor
    w_scale: torch.Tensor
    x_scale: Optional[torch.Tensor]
    out_scale: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    out_features: int

    @classmethod
    def from_float(cls, weight: torch.Tensor, bias: Optional[torch.Tensor],
                   x_scale: Optional[torch.Tensor],
                   group_max: Optional[Reduce] = None) -> 'Int8Weight':
        """`group_max`: a row-parallel shard's (see `quant_weight`)."""
        wq, w_scale = quant_weight(weight, group_max)
        if wq.dim() == 4:   # OIHW -> [O, kh * kw * I]
            wq = wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)
        O, I = wq.shape
        wq = F.pad(wq, (0, _ceil8(I) - I, 0, _ceil8(O) - O)).contiguous()
        out_scale = None
        if x_scale is not None:
            x_scale = x_scale.to(device=weight.device, dtype=torch.float32)
            out_scale = x_scale * w_scale
        return cls(wq, w_scale, x_scale, out_scale,
                   None if bias is None else bias.float(), O)

    def linear(self, x: torch.Tensor, reduce: Optional[Reduce] = None
               ) -> torch.Tensor:
        """A8W8 Linear of x [..., I] with the static activation scale;
        `reduce` as `int8_matmul`'s."""
        return int8_matmul(quant_per_tensor(x, self.x_scale), self, x.dtype,
                           reduce)


def int8_conv2d(x: torch.Tensor, w: Int8Weight, kernel: Tuple[int, int],
                stride: Tuple[int, int], padding: Tuple[int, int]
                ) -> torch.Tensor:
    """A8W8 dense 2-D convolution of x [B, C, H, W] (any layout) with a
    quantized OIHW weight; returns [B, O, Ho, Wo] in x's dtype,
    channels-last (the NHWC result as it is computed). The activation scale
    is the static one or else max|x| / 127 of this call. Each band of whole
    images is quantized, laid out NHWC, zero-padded, and multiplied as an
    im2col of its kh * kw shifted views."""
    B, C, H, Wd = x.shape
    kh, kw = kernel
    (sh, sw), (ph, pw) = stride, padding
    Ho = (H + 2 * ph - kh) // sh + 1
    Wo = (Wd + 2 * pw - kw) // sw + 1
    x_scale, out_scale = w.x_scale, w.out_scale
    if x_scale is None:
        x_scale = scale_from_absmax(absmax(x))
        out_scale = x_scale * w.w_scale
    K, O = w.wq.shape[1], w.out_features
    row_bytes = K + O * (4 + 4 + 4 + x.element_size())
    band = max(1, CONV_BAND_BYTES // (Ho * Wo * row_bytes))
    out = torch.empty((B, Ho, Wo, O), dtype=x.dtype, device=x.device)
    for b0 in range(0, B, band):
        xq = quant_per_tensor(x[b0:b0 + band], x_scale).permute(0, 2, 3, 1)
        xq = F.pad(xq, (0, 0, pw, pw, ph, ph))
        taps = [xq[:, i:i + sh * (Ho - 1) + 1:sh, j:j + sw * (Wo - 1) + 1:sw]
                for i in range(kh) for j in range(kw)]
        cols = torch.cat(taps, dim=-1) if len(taps) > 1 else taps[0]
        cols = _pad_cols(cols.reshape(-1, kh * kw * C), K)
        acc = int_mm(cols, w.wq)[:, :O]
        out[b0:b0 + band] = _dequant(acc, out_scale, w.bias, x.dtype).reshape(
            -1, Ho, Wo, O)
    tracing.count('int8.conv2d_launches')
    return out.permute(0, 3, 1, 2)
