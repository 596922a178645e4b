"""CLIP (a ViT image encoder and a causal text transformer) for re-ranking
text-to-image candidates: the candidates of one caption sorted by the
cosine similarity of their image features with the caption's text
features, best first.

Counterpart of `hqtransformer_tpu/evaluation/clip_rerank.py` (`CLIPConfig`,
`CLIP`, `preprocess`, `clip_scores`, `clip_rerank`). The modules carry the
official `clip` package's names (`visual.conv1`, `visual.class_embedding`,
`visual.positional_embedding`, `visual.transformer.resblocks.<i>.attn.
in_proj_weight`, `token_embedding`, `positional_embedding`,
`text_projection`, `logit_scale`, ...), so an official state dict (ViT-B/32
and the like) loads with `load_state_dict(strict=True)` as it is, once the
three non-tensor entries of a JIT archive's dict (`input_resolution`,
`context_length`, `vocab_size`) are dropped (`official_state`), as `clip`
itself drops them. The weights are an outside asset, as the reference's
`clip.load("ViT-B/32")` download is; the repo holds none.

Everything is f32: QuickGELU MLPs, pre-LN residual blocks (LayerNorm eps
1e-5), attention scores and softmax by plain ops (a masked score is
-1e10, as JAX masks), the class token's features for images and the
features at each caption's <|endoftext|> (its largest id) for text.
Callers move the module to their device (the CLIs: the card unless
`--device cpu`); the functions below bring their inputs to it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# CLIP's preprocessing constants (clip.load's Normalize).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# Entries of a JIT archive's state dict that are no tensors of the model.
_NOT_WEIGHTS = ('input_resolution', 'context_length', 'vocab_size')


@dataclass(frozen=True)
class CLIPConfig:
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    patch_size: int = 32
    embed_dim: int = 512
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8


VIT_B32 = CLIPConfig()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class Attention(nn.Module):
    """Multi-head self-attention with `nn.MultiheadAttention`'s parameter
    names (one [3C, C] input projection), on [B, T, C]."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        B, T, C = x.shape
        hd = C // self.heads
        q, k, v = (t.reshape(B, T, self.heads, hd).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight,
                                     self.in_proj_bias).split(C, dim=-1))
        att = q @ k.transpose(-1, -2) / math.sqrt(hd)
        if causal:
            keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            att = att.masked_fill(~keep, -1e10)
        y = torch.softmax(att, dim=-1) @ v
        return self.out_proj(y.transpose(1, 2).reshape(B, T, C))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = Attention(width, heads)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module('c_fc', nn.Linear(width, 4 * width))
        self.mlp.add_module('c_proj', nn.Linear(4 * width, width))
        self.ln_2 = nn.LayerNorm(width)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp.c_proj(quick_gelu(self.mlp.c_fc(self.ln_2(x))))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads)
                                       for _ in range(layers))

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, causal)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, c: CLIPConfig):
        super().__init__()
        grid = c.image_resolution // c.patch_size
        self.conv1 = nn.Conv2d(3, c.vision_width, c.patch_size,
                               stride=c.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c.vision_width))
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1, c.vision_width))
        self.ln_pre = nn.LayerNorm(c.vision_width)
        self.transformer = Transformer(c.vision_width, c.vision_layers,
                                       c.vision_heads)
        self.ln_post = nn.LayerNorm(c.vision_width)
        self.proj = nn.Parameter(torch.empty(c.vision_width, c.embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] CLIP-normalized -> [B, embed_dim]."""
        x = self.conv1(images.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                     # [B, P, C]
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        x = self.transformer(x, causal=False)
        return self.ln_post(x[:, 0]) @ self.proj


class CLIP(nn.Module):
    """CLIP's image and text encoders, into one embedding space. Its
    parameters are uninitialised until a state dict is loaded (build it on
    the meta device and load with `assign=True` to allocate nothing
    twice)."""

    def __init__(self, cfg: CLIPConfig = VIT_B32):
        super().__init__()
        self.cfg = c = cfg
        self.visual = VisionTransformer(c)
        self.transformer = Transformer(c.text_width, c.text_layers,
                                       c.text_heads)
        self.token_embedding = nn.Embedding(c.vocab_size, c.text_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(c.context_length, c.text_width))
        self.ln_final = nn.LayerNorm(c.text_width)
        self.text_projection = nn.Parameter(
            torch.empty(c.text_width, c.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] CLIP-normalized (`preprocess`) ->
        [B, embed_dim]."""
        return self.visual(images)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, context_length] -> [B, embed_dim], the features at
        each row's largest id (its <|endoftext|>)."""
        x = self.token_embedding(tokens) + self.positional_embedding
        x = self.ln_final(self.transformer(x, causal=True))
        x = x[torch.arange(x.shape[0], device=x.device),
              tokens.argmax(dim=-1)]
        return x @ self.text_projection


def official_state(state: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """An official `clip` state dict (or a module's) as `CLIP` loads it:
    the JIT archive's non-tensor entries dropped, every tensor in f32 (the
    official weights are fp16)."""
    state = state.state_dict() if hasattr(state, 'state_dict') else state
    return {k: v.float() for k, v in state.items() if k not in _NOT_WEIGHTS}


def preprocess(pixels: torch.Tensor, resolution: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> CLIP-normalized [B, R, R, 3], f32: a
    bilinear resize of the square samples, antialiased when it shrinks
    them as JAX's `jax.image.resize(..., 'bilinear')` is, then CLIP's
    normalization."""
    x = pixels.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(resolution, resolution), mode='bilinear',
                      align_corners=False, antialias=True)
    mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
    return ((x - mean) / std).permute(0, 2, 3, 1)


@torch.inference_mode()
def clip_scores(model: CLIP, pixels: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """The cosine similarity [B] of each image of `pixels` ([B, H, W, 3]
    in [0, 1]) with the first caption of `tokens` ([n, context_length]),
    on the model's device."""
    device = model.positional_embedding.device
    img = model.encode_image(preprocess(pixels.to(device),
                                        model.cfg.image_resolution))
    txt = model.encode_text(tokens.to(device).long())
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    return (img * txt[:1]).sum(dim=-1)


def clip_rerank(model: CLIP, pixels: torch.Tensor, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the indices of `pixels` best first, their scores), by
    `clip_scores`."""
    scores = clip_scores(model, pixels, tokens)
    ranked = torch.argsort(scores, descending=True, stable=True)
    return ranked, scores[ranked]
