"""Stage-2 transformer primitives: multi-head attention with explicit mask
arguments and the packed-cache decode path.

Counterparts of `hqtransformer_tpu/models/stage2/layers.py`. Parameter names
follow the PyTorch reference's key layout (`attn.query.weight`,
`mlp.0.weight`, `ln1.weight`, ...), so a state dict exported from the JAX
variables loads with `strict=True`.

Mixed precision follows the JAX modules: matrix weights may be stored in
bf16 and 1-D biases and norm scales in f32 (`serving_bf16_params`); every
projection runs in its input's dtype (in bf16 the product and then the
bias sum rounded, as flax `Dense` rounds them), LayerNorm computes in f32
and returns the input dtype, and attention scores and softmax are f32.
The depth chains attend with `tiny_attention`, the JAX package's
arithmetic for them.

The JAX `Block.step_stacked` tells prefill from decode by whether the cache
length is a static Python int. Here the position is always an int, so
`prefill` and `step` are separate methods. `step_heads` is the JAX
`Block.step` (its einsum path on per-head [B, nh, T, hd] caches), which the
causal depth chain of the `top2bot` mode runs.

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

Tensor parallelism (`parallel/tp.py::shard_module` sets it up on a model
built at full size): a SelfAttention holds its rank's heads (`n_heads` is
the local count, `width` the local q width, and its fused QKV concatenates
the rank's q, k and v shards) and passes its input through `tp.copy`;
`mlp.0` holds the rank's part of the MLP; `proj` and `mlp.2` are
row-parallel (`tp_mode` 'row': the partial products all-reduced, then the
bias), the heads vocabulary-sharded (`tp_mode` 'vocab': the logits
gathered). Without it (`tp` None) every path is unchanged. int8 serving
keeps these roles (`QuantizableLinear.forward`), and each attention layer
takes the span of its heads of the whole int8 cache scales.
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
from ...ops.tiny_attention import NEG_INF, tiny_attention  # noqa: F401

ACT_SCALES_NEEDED = ('int8 gemms need calibrated activation scales: run '
                     'TwoStageModel.calibrate_stage2_int8() and pass its '
                     'scales to the sampler')
KV_SCALES_NEEDED = ('int8 KV cache needs calibrated scales: run '
                    'TwoStageModel.calibrate_kv_scales() and pass its scales '
                    'to the sampler')


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ w.T + b in x's dtype, rounded where flax `Dense` rounds: on bf16
    activations the product is rounded to bf16 and then the bias sum (two
    launches); in f32 the bias goes into the one gemm call."""
    if b is not None and x.dtype == torch.bfloat16:
        return F.linear(x, w) + b.to(x.dtype)
    return F.linear(x, w, None if b is None else b.to(x.dtype))


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype (see `linear`); under
    tensor parallelism row-parallel (`tp_mode` 'row') or
    vocabulary-sharded ('vocab': its replicated input through `tp.copy`,
    its logits gathered)."""

    tp = None
    tp_mode: str = ''

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.tp is None:
            return linear(x, w, self.bias)
        if self.tp_mode == 'row':
            return self.tp.row_linear(x, w, self.bias)
        return self.tp.gather(linear(self.tp.copy(x), w, self.bias))


class QuantizableLinear(Linear):
    """Linear with the A8W8 path of int8max serving: forward(x, int8=True)
    quantizes x by its static (calibrated) scale and multiplies by the
    weight quantized per output channel, both from `q8`, which a serving
    call sets (`quantize`). Without `q8`, int8=True raises. Under tensor
    parallelism it keeps Linear's roles: row-parallel, the int32 partial
    products summed exactly over the group before the dequantization and
    the bias; vocabulary-sharded, the logits gathered."""

    q8: Optional[Int8Weight] = None

    def quantize(self, x_scale: torch.Tensor) -> Int8Weight:
        """The weight (this rank's shard) quantized for a serving call with
        the static activation scale `x_scale`; a row-parallel shard's
        per-output-channel scales are the whole input dim's (a max over
        the tp group: a collective)."""
        group_max = self.tp.max if self.tp_mode == 'row' else None
        return Int8Weight.from_float(self.weight, self.bias, x_scale,
                                     group_max)

    def forward(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        if not int8:
            return super().forward(x)
        if self.q8 is None:
            raise ValueError(ACT_SCALES_NEEDED)
        if self.tp is None:
            return self.q8.linear(x)
        if self.tp_mode == 'row':
            return self.q8.linear(x, self.tp.sum_int32)
        return self.tp.gather(self.q8.linear(self.tp.copy(x)))


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
    tp = None

    def __init__(self, embed_dim: int, n_heads: int, attn_bias: bool = True):
        super().__init__()
        self.n_heads = n_heads
        self.query = QuantizableLinear(embed_dim, embed_dim, bias=attn_bias)
        self.key = QuantizableLinear(embed_dim, embed_dim, bias=attn_bias)
        self.value = QuantizableLinear(embed_dim, embed_dim, bias=attn_bias)
        self.proj = QuantizableLinear(embed_dim, embed_dim, bias=attn_bias)

    @property
    def width(self) -> int:
        """The width of q (and of k and v): the rank's heads' under tensor
        parallelism."""
        return self.query.weight.shape[0]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                int8: bool = False) -> torch.Tensor:
        """Full-sequence attention; with `int8` the query, key, value and
        output projections each run A8W8 with their own scales, as the JAX
        `SelfAttention.__call__` does in its int8 scope."""
        if self.tp is not None:
            x = self.tp.copy(x)
        q = split_heads(self.query(x, int8), self.n_heads)
        k = split_heads(self.key(x, int8), self.n_heads)
        v = split_heads(self.value(x, int8), self.n_heads)
        return self.proj(merge_heads(masked_attention(q, k, v, mask)), int8)

    def _concat(self, linears, dtype: torch.dtype):
        w = torch.cat([m.weight for m in linears]).to(dtype)
        b = None
        if linears[0].bias is not None:
            b = torch.cat([m.bias for m in linears]).to(dtype)
        return w, b

    def _cache_scale(self, kv_scales: Mapping[str, torch.Tensor],
                     key: str) -> torch.Tensor:
        """The per-channel int8 cache scale `key` (whole, [C]) cut to this
        rank's K / V channels: the span of its heads under tensor
        parallelism. Raises ValueError if it is missing or not [C]."""
        if key not in kv_scales:
            raise ValueError(f'{KV_SCALES_NEEDED} ({key!r} has none)')
        s = kv_scales[key]
        size, rank = (1, 0) if self.tp is None else (self.tp.size,
                                                     self.tp.rank)
        if s.dim() != 1 or s.shape[0] != self.width * size:
            why = (f'tp {size} does not divide it' if s.shape[-1] % size
                   else f'the layer has {self.width * size}')
            raise ValueError(f'the int8 cache scale {key!r} has shape '
                             f'{tuple(s.shape)}: {why} (scales are whole, '
                             f'in the tp-1 layout, whatever the tp)')
        s = s[rank * self.width:(rank + 1) * self.width]
        return s.to(self.query.weight.device, torch.float32)

    def prepare_serving(self, dtype: torch.dtype,
                        act_scales: Optional[Mapping[str, torch.Tensor]],
                        kv_scales: Optional[Mapping[str, torch.Tensor]],
                        name: str) -> AttnServing:
        """The hoisted state of one serving call: int8 QKV when
        `act_scales` is given (the query's scale, `<name>.query`, for the
        rank's q, k and v rows: column-parallel, their scales do not
        depend on the cut), int8 cache scales when `kv_scales` is
        (`<name>.k`, `<name>.v`, whole, cut to the rank's channels). No
        collective."""
        qkv = self._concat((self.query, self.key, self.value), dtype)
        q8 = kv = None
        if kv_scales is not None:
            k, v = (self._cache_scale(kv_scales, f'{name}.{c}') for c in 'kv')
            kv = (k, v, 1.0 / k, 1.0 / v)
        if act_scales is not None:
            q8 = Int8Weight.from_float(
                torch.cat([self.query.weight, self.key.weight,
                           self.value.weight]),
                None if qkv[1] is None else torch.cat(
                    [self.query.bias, self.key.bias, self.value.bias]),
                act_scale(act_scales, f'{name}.query'))
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
        return linear(x, w, b)

    def fused_kv(self, x: torch.Tensor) -> torch.Tensor:
        """One [C, 2C] projection -> [..., 2C] (k, v concatenated)."""
        w, b = (self.serving.kv if self.serving is not None else
                self._concat((self.key, self.value), x.dtype))
        return linear(x, w, b)

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
        q, k, v = self.fused_qkv(x, int8).split(self.width, dim=-1)
        T_new = x.shape[1]
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
        q, k_new, v_new = self.fused_qkv(x[:, 0], int8).split(self.width,
                                                               dim=-1)
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

    def step_heads(self, x: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, pos: int) -> torch.Tensor:
        """One token x [B, 1, C] at row `pos` of the per-head caches
        [B, nh, T, hd] (the new K/V row written in place), attending over
        rows 0..pos: the fused QKV, then scores and softmax in f32 as
        `masked_attention` (rows past pos, which the JAX function masks to
        a -1e10 score, have weight 0 and are not read)."""
        q, k, v = self.fused_qkv(x).split(self.width, dim=-1)
        k_cache[:, :, pos:pos + 1] = split_heads(k, self.n_heads).to(
            k_cache.dtype)
        v_cache[:, :, pos:pos + 1] = split_heads(v, self.n_heads).to(
            v_cache.dtype)
        y = masked_attention(split_heads(q, self.n_heads),
                             k_cache[:, :, :pos + 1].to(x.dtype),
                             v_cache[:, :, :pos + 1].to(x.dtype), None)
        return self.proj(merge_heads(y))


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
        if self.attn.tp is not None:
            x = self.attn.tp.copy(x)
        return fc2(act(fc1(x, int8)), int8)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                int8: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask, int8)
        return x + self.mlp_forward(self.ln2(x), int8)

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

    def step_heads(self, x: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, pos: int) -> torch.Tensor:
        x = x + self.attn.step_heads(self.ln1(x), k_cache, v_cache, pos)
        return x + self.mlp_forward(self.ln2(x))
