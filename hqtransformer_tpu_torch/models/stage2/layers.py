"""Stage-2 transformer primitives: multi-head attention with explicit mask
arguments and the packed-cache decode path.

Counterparts of `hqtransformer_tpu/models/stage2/layers.py`. Parameter names
follow the PyTorch reference's key layout (`attn.query.weight`,
`mlp.0.weight`, `ln1.weight`, ...), so a state dict exported from the JAX
variables loads with `strict=True`.

Mixed precision follows the JAX modules: matrix weights may be stored in
bf16 and 1-D biases and norm scales in f32 (`serving_bf16_params`); every
projection runs in its input's dtype, LayerNorm computes in f32 and returns
the input dtype, and attention scores and softmax are f32.

The JAX `Block.step_stacked` tells prefill from decode by whether the cache
length is a static Python int. Here the position is always an int, so
`prefill` and `step` are separate methods.

int8max serving (the JAX package's `QuantizableDense`, the A8W8 branch of
`_fused_qkv_flat` and the int8 KV cache of `_PackedStepMixin`):
- `QuantizableLinear` runs A8W8 when its caller passes `int8=True`, with
  the weight quantized once per serving call (`q8`, set by
  `HierarchicalGPT.serving`); the fused QKV gemm runs A8W8 with the
  query's activation scale;
- an int8 cache ([L, T, B, D] int8) is written with rows quantized per
  channel by `1 / scale`; K's scales fold into q and V's into the
  attention output, around decode attention's int8 variant.
The serving state (`SelfAttention.serving`, `QuantizableLinear.q8`) also
hoists the per-call weight concatenations out of the decode loop; outside a
serving call the float paths concatenate on the fly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import masks as M
from ...ops.decode_attention import decode_attention_step
from ...ops.int8 import Int8Weight, quantize_rows

NEG_INF = -1e10
ACT_SCALES_NEEDED = ('int8 gemms need calibrated activation scales: run '
                     'TwoStageModel.calibrate_stage2_int8() and pass its '
                     'scales to the sampler')
KV_SCALES_NEEDED = ('int8 KV cache needs calibrated scales: run '
                    'TwoStageModel.calibrate_kv_scales() and pass its scales '
                    'to the sampler')


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class QuantizableLinear(Linear):
    """Linear with the A8W8 path of int8max serving: forward(x, int8=True)
    quantizes x by its static (calibrated) scale and multiplies by the
    weight quantized per output channel, both from `q8`, which a serving
    call sets. Without `q8`, int8=True raises."""

    q8: Optional[Int8Weight] = None

    def forward(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        if not int8:
            return super().forward(x)
        if self.q8 is None:
            raise ValueError(ACT_SCALES_NEEDED)
        return self.q8.linear(x)


def act_scale(scales: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
    """The calibrated activation scale of module `name`; raises if none."""
    if name not in scales:
        raise ValueError(f'{ACT_SCALES_NEEDED} ({name!r} has none)')
    return scales[name]


@dataclass(frozen=True)
class AttnServing:
    """What one serving call hoists out of its decode loop for one
    attention layer: the fused [3C, C] QKV weight and bias and the [2C, C]
    K/V ones, in the activation dtype; the A8W8 QKV weight (with the
    query's activation scale) when its gemms run int8; and the int8 KV
    cache's per-channel scales (k, v, 1 / k, 1 / v) when its cache is
    int8."""
    qkv: Tuple[torch.Tensor, Optional[torch.Tensor]]
    kv: Tuple[torch.Tensor, Optional[torch.Tensor]]
    qkv_q8: Optional[Int8Weight] = None
    kv_scales: Optional[Tuple[torch.Tensor, ...]] = None


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) computed in f32, returned in the input dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def gelu(x: torch.Tensor, use_approx: bool = False) -> torch.Tensor:
    """GELU. The approx variant is x*sigmoid(1.702x). Exact erf in f32;
    for bf16 activations the tanh form x*sigmoid(1.5957691x + 0.0713548x^3)
    computed in f32, as the JAX package does."""
    if use_approx:
        return x * torch.sigmoid(1.702 * x)
    if x.dtype == torch.bfloat16:
        x32 = x.float()
        z = 1.595769122 * x32 + 0.071354816 * (x32 * x32 * x32)
        return (x32 * torch.sigmoid(z)).to(torch.bfloat16)
    return F.gelu(x)


class GELU(nn.Module):
    def __init__(self, use_approx: bool = False):
        super().__init__()
        self.use_approx = use_approx

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x, self.use_approx)


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, T, C] -> [B, nh, T, hd]."""
    B, T, C = x.shape
    return x.reshape(B, T, n_heads, C // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, nh, T, hd] -> [B, T, C]."""
    B, nh, T, hd = x.shape
    return x.transpose(1, 2).reshape(B, T, nh * hd)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scaled dot-product attention over [B, nh, T, hd] tensors; `mask` is
    bool [Tq, Tk] (True = attend) or None. Scores and softmax in f32."""
    att = torch.matmul(q.float(), k.float().transpose(-1, -2))
    att = att * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        att = att.masked_fill(~mask, NEG_INF)
    att = torch.softmax(att, dim=-1)
    return torch.matmul(att.to(v.dtype), v)


class SelfAttention(nn.Module):
    """Multi-head self-attention with full-sequence, prefill and cached
    single-token entry points sharing one set of weights."""

    serving: Optional[AttnServing] = None

    def __init__(self, embed_dim: int, n_heads: int, attn_bias: bool = True):
        super().__init__()
        self.n_heads = n_heads
        self.query = QuantizableLinear(embed_dim, embed_dim, bias=attn_bias)
        self.key = QuantizableLinear(embed_dim, embed_dim, bias=attn_bias)
        self.value = QuantizableLinear(embed_dim, embed_dim, bias=attn_bias)
        self.proj = QuantizableLinear(embed_dim, embed_dim, bias=attn_bias)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = split_heads(self.query(x), self.n_heads)
        k = split_heads(self.key(x), self.n_heads)
        v = split_heads(self.value(x), self.n_heads)
        return self.proj(merge_heads(masked_attention(q, k, v, mask)))

    def _concat(self, linears, dtype: torch.dtype):
        w = torch.cat([m.weight for m in linears]).to(dtype)
        b = None
        if linears[0].bias is not None:
            b = torch.cat([m.bias for m in linears]).to(dtype)
        return w, b

    def prepare_serving(self, dtype: torch.dtype,
                        act_scales: Optional[Mapping[str, torch.Tensor]],
                        kv_scales: Optional[Mapping[str, torch.Tensor]],
                        name: str) -> AttnServing:
        """The hoisted state of one serving call: int8 QKV when
        `act_scales` is given (the query's scale, `<name>.query`), int8
        cache scales when `kv_scales` is (`<name>.k`, `<name>.v`)."""
        qkv = self._concat((self.query, self.key, self.value), dtype)
        q8 = kv = None
        if act_scales is not None:
            q8 = Int8Weight.from_float(
                torch.cat([self.query.weight, self.key.weight,
                           self.value.weight]),
                None if qkv[1] is None else torch.cat(
                    [self.query.bias, self.key.bias, self.value.bias]),
                act_scale(act_scales, f'{name}.query'))
        if kv_scales is not None:
            if f'{name}.k' not in kv_scales:
                raise ValueError(KV_SCALES_NEEDED)
            dev = self.query.weight.device
            k = kv_scales[f'{name}.k'].to(dev, torch.float32)
            v = kv_scales[f'{name}.v'].to(dev, torch.float32)
            kv = (k, v, 1.0 / k, 1.0 / v)
        return AttnServing(qkv, self._concat((self.key, self.value), dtype),
                           q8, kv)

    def fused_qkv(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        """One [C, 3C] projection -> [..., 3C] (q, k, v concatenated); A8W8
        with the query's scale when `int8`."""
        if int8:
            if self.serving is None or self.serving.qkv_q8 is None:
                raise ValueError(ACT_SCALES_NEEDED)
            return self.serving.qkv_q8.linear(x)
        w, b = (self.serving.qkv if self.serving is not None else
                self._concat((self.query, self.key, self.value), x.dtype))
        return F.linear(x, w, b)

    def fused_kv(self, x: torch.Tensor) -> torch.Tensor:
        """One [C, 2C] projection -> [..., 2C] (k, v concatenated)."""
        w, b = (self.serving.kv if self.serving is not None else
                self._concat((self.key, self.value), x.dtype))
        return F.linear(x, w, b)

    def _int8_cache_scales(self):
        if self.serving is None or self.serving.kv_scales is None:
            raise ValueError(KV_SCALES_NEEDED)
        return self.serving.kv_scales

    def prefill(self, x: torch.Tensor, k_caches: torch.Tensor,
                v_caches: torch.Tensor, layer: int,
                mask: Optional[torch.Tensor] = None,
                int8: bool = False) -> torch.Tensor:
        """Write rows [0, T_new) of layer `layer` of the [L, T, B, D] caches
        in place and attend among the new tokens (causal unless `mask`).
        An int8 cache gets the rows quantized; the attention uses the float
        k and v."""
        B, T_new, C = x.shape
        q, k, v = self.fused_qkv(x, int8).split(C, dim=-1)
        if k_caches.dtype == torch.int8:
            _, _, inv_k, inv_v = self._int8_cache_scales()
            k_rows, v_rows = quantize_rows(k, inv_k), quantize_rows(v, inv_v)
        else:
            k_rows, v_rows = k.to(k_caches.dtype), v.to(v_caches.dtype)
        k_caches[layer, :T_new] = k_rows.transpose(0, 1)
        v_caches[layer, :T_new] = v_rows.transpose(0, 1)
        if mask is None:
            mask = M.causal(T_new, x.device)
        y = masked_attention(split_heads(q, self.n_heads),
                             split_heads(k, self.n_heads),
                             split_heads(v, self.n_heads), mask)
        return self.proj(merge_heads(y), int8)

    def step(self, x: torch.Tensor, k_caches: torch.Tensor,
             v_caches: torch.Tensor, layer: int, pos: int,
             int8: bool = False) -> torch.Tensor:
        """Single-token decode at time `pos`: x [B, 1, C]. Writes the new
        K/V row into the caches in place (decode attention kernel). With an
        int8 cache, q is multiplied by K's scales, the new rows are
        quantized by 1 / scale, and the output is multiplied by V's
        scales."""
        C = x.shape[-1]
        q, k_new, v_new = self.fused_qkv(x[:, 0], int8).split(C, dim=-1)
        v_scale = None
        if k_caches.dtype == torch.int8:
            k_scale, v_scale, inv_k, inv_v = self._int8_cache_scales()
            q = q * k_scale.to(q.dtype)
            k_new = quantize_rows(k_new, inv_k)
            v_new = quantize_rows(v_new, inv_v)
        y = decode_attention_step(q, k_new, v_new, k_caches, v_caches,
                                  layer, pos, self.n_heads)
        if v_scale is not None:
            y = y * v_scale.to(y.dtype)
        return self.proj(y[:, None, :], int8)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(ln1 x); x + mlp(ln2 x)."""

    def __init__(self, embed_dim: int, n_heads: int, mlp_bias: bool = True,
                 attn_bias: bool = True, gelu_use_approx: bool = False):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim)
        self.ln2 = LayerNorm(embed_dim)
        self.attn = SelfAttention(embed_dim, n_heads, attn_bias)
        self.mlp = nn.Sequential(
            QuantizableLinear(embed_dim, 4 * embed_dim, bias=mlp_bias),
            GELU(gelu_use_approx),
            QuantizableLinear(4 * embed_dim, embed_dim, bias=mlp_bias))

    def mlp_forward(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        fc1, act, fc2 = self.mlp
        return fc2(act(fc1(x, int8)), int8)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        return x + self.mlp(self.ln2(x))

    def prefill(self, x: torch.Tensor, k_caches: torch.Tensor,
                v_caches: torch.Tensor, layer: int,
                mask: Optional[torch.Tensor] = None,
                int8: bool = False) -> torch.Tensor:
        x = x + self.attn.prefill(self.ln1(x), k_caches, v_caches, layer,
                                  mask, int8)
        return x + self.mlp_forward(self.ln2(x), int8)

    def step(self, x: torch.Tensor, k_caches: torch.Tensor,
             v_caches: torch.Tensor, layer: int, pos: int,
             int8: bool = False) -> torch.Tensor:
        x = x + self.attn.step(self.ln1(x), k_caches, v_caches, layer, pos,
                               int8)
        return x + self.mlp_forward(self.ln2(x), int8)
