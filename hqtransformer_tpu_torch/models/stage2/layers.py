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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import masks as M
from ...ops.decode_attention import decode_attention_step

NEG_INF = -1e10


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


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

    def __init__(self, embed_dim: int, n_heads: int, attn_bias: bool = True):
        super().__init__()
        self.n_heads = n_heads
        self.query = Linear(embed_dim, embed_dim, bias=attn_bias)
        self.key = Linear(embed_dim, embed_dim, bias=attn_bias)
        self.value = Linear(embed_dim, embed_dim, bias=attn_bias)
        self.proj = Linear(embed_dim, embed_dim, bias=attn_bias)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = split_heads(self.query(x), self.n_heads)
        k = split_heads(self.key(x), self.n_heads)
        v = split_heads(self.value(x), self.n_heads)
        return self.proj(merge_heads(masked_attention(q, k, v, mask)))

    def fused_qkv(self, x: torch.Tensor) -> torch.Tensor:
        """One [C, 3C] projection -> [..., 3C] (q, k, v concatenated)."""
        w = torch.cat([self.query.weight, self.key.weight,
                       self.value.weight]).to(x.dtype)
        b = None
        if self.query.bias is not None:
            b = torch.cat([self.query.bias, self.key.bias,
                           self.value.bias]).to(x.dtype)
        return F.linear(x, w, b)

    def prefill(self, x: torch.Tensor, k_caches: torch.Tensor,
                v_caches: torch.Tensor, layer: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Write rows [0, T_new) of layer `layer` of the [L, T, B, D] caches
        in place and attend among the new tokens (causal unless `mask`)."""
        B, T_new, C = x.shape
        q, k, v = self.fused_qkv(x).split(C, dim=-1)
        k_caches[layer, :T_new] = k.transpose(0, 1).to(k_caches.dtype)
        v_caches[layer, :T_new] = v.transpose(0, 1).to(v_caches.dtype)
        if mask is None:
            mask = M.causal(T_new, x.device)
        y = masked_attention(split_heads(q, self.n_heads),
                             split_heads(k, self.n_heads),
                             split_heads(v, self.n_heads), mask)
        return self.proj(merge_heads(y))

    def step(self, x: torch.Tensor, k_caches: torch.Tensor,
             v_caches: torch.Tensor, layer: int, pos: int) -> torch.Tensor:
        """Single-token decode at time `pos`: x [B, 1, C]. Writes the new
        K/V row into the float caches in place (decode attention kernel)."""
        C = x.shape[-1]
        q, k_new, v_new = self.fused_qkv(x[:, 0]).split(C, dim=-1)
        y = decode_attention_step(q, k_new, v_new, k_caches, v_caches,
                                  layer, pos, self.n_heads)
        return self.proj(y[:, None, :])


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(ln1 x); x + mlp(ln2 x)."""

    def __init__(self, embed_dim: int, n_heads: int, mlp_bias: bool = True,
                 attn_bias: bool = True, gelu_use_approx: bool = False):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim)
        self.ln2 = LayerNorm(embed_dim)
        self.attn = SelfAttention(embed_dim, n_heads, attn_bias)
        self.mlp = nn.Sequential(
            Linear(embed_dim, 4 * embed_dim, bias=mlp_bias),
            GELU(gelu_use_approx),
            Linear(4 * embed_dim, embed_dim, bias=mlp_bias))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        return x + self.mlp(self.ln2(x))

    def prefill(self, x: torch.Tensor, k_caches: torch.Tensor,
                v_caches: torch.Tensor, layer: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn.prefill(self.ln1(x), k_caches, v_caches, layer,
                                  mask)
        return x + self.mlp(self.ln2(x))

    def step(self, x: torch.Tensor, k_caches: torch.Tensor,
             v_caches: torch.Tensor, layer: int, pos: int) -> torch.Tensor:
        x = x + self.attn.step(self.ln1(x), k_caches, v_caches, layer, pos)
        return x + self.mlp(self.ln2(x))
