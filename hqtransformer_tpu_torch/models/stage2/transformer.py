"""The flat stage-2 baselines: the class-conditional iGPT over the top-code
raster and the text-to-image Transformer1d.

Counterparts of `hqtransformer_tpu/models/stage2/transformer.py::IGPT` and
`::Transformer1d`, with the JAX modules' parameter names, so a state dict
exported from their variables loads with strict=True. Both are one causal
GPT over a flat code sequence:
- `IGPT`: a one-token prefix (`sos`: a class embedding, or one learned
  [1, 1, D] token without class conditioning), then the image codes
  (`tok_emb_img` + `pos_emb_img`); logits `head(ln_f(.))`;
- `Transformer1d`: a text prefix of N tokens (`tok_emb_txt` +
  `pos_emb_txt`), then the image codes; image logits `head_img(ln_f(.))`
  and text logits `head_txt(ln_f(.))` (the released `bottom` config reads
  the top codes as its "text").
The prefix is `hierarchical.Conditioning`'s, and the packed-cache prefill
and decode steps (decode attention K1) are `SpatialDecoding`'s, which the
samplers (`sampling/engine.py::make_igpt_sampler`, `make_txt2img_sampler`)
drive through the 2-level models' loop. Both serve with a float or an
int8 KV cache; their gemms stay float, as the JAX flat samplers enter no
int8 scope.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ...config import Stage2Hparams
from ...ops import masks as M
from .hierarchical import Conditioning, SpatialDecoding
from .layers import Block, LayerNorm, Linear


class _FlatGPT(Conditioning, SpatialDecoding, nn.Module):
    """The GPT of both baselines: the prefix, `tok_emb_img`, `pos_emb_img`,
    the blocks and `ln_f`."""

    # no depth transformer: `SpatialDecoding.serving` prepares none
    depths: Tuple[nn.Module, ...] = ()

    def __init__(self, vocab_size_img: int, hparams: Stage2Hparams,
                 dtype: torch.dtype, use_cls_cond: bool, use_txt_cond: bool,
                 vocab_size_txt: int):
        super().__init__()
        hp = hparams
        D = hp.embed_dim
        self.hparams = hparams
        self.dtype = dtype
        self._build_prefix(use_cls_cond, use_txt_cond, vocab_size_txt)
        self.tok_emb_img = nn.Embedding(vocab_size_img, D)
        self.pos_emb_img = nn.Embedding(hp.ctx_len_img, D)
        self.blocks = nn.ModuleList(
            Block(D, hp.n_heads, hp.mlp_bias, hp.attn_bias,
                  hp.gelu_use_approx) for _ in range(hp.n_layers))
        self.ln_f = LayerNorm(D)

    def int8_heads(self) -> List[Tuple[str, nn.Module]]:
        return []

    def int8_embedding(self) -> List[Tuple[str, nn.Module]]:
        return []

    def embed_images(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T] -> tok_emb_img + pos_emb_img [B, T, D]."""
        pos = torch.arange(codes.shape[1], device=codes.device)
        return self._emb(self.tok_emb_img, codes) + \
            self._emb(self.pos_emb_img, pos)[None]

    def embed_cell_step(self, code: torch.Tensor, position: torch.Tensor,
                        int8: bool = False) -> torch.Tensor:
        """One generated code [B] at `position` [B] -> [B, 1, D], the next
        spatial step's input (float whatever `int8`)."""
        return (self._emb(self.tok_emb_img, code) +
                self._emb(self.pos_emb_img, position))[:, None, :]

    def _causal(self, x: torch.Tensor) -> torch.Tensor:
        mask = M.causal(x.shape[1], x.device)
        for blk in self.blocks:
            x = blk(x, mask)
        return self.ln_f(x)


class IGPT(_FlatGPT):
    """Class-conditional (or unconditional) GPT over the top-code raster."""

    def __init__(self, vocab_size_img: int, use_cls_cond: bool,
                 hparams: Stage2Hparams, dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size_img, hparams, dtype, use_cls_cond,
                         False, 0)
        self.head = Linear(hparams.embed_dim, vocab_size_img, bias=False)

    def image_logits(self, h: torch.Tensor) -> torch.Tensor:
        """h after ln_f [..., D] -> logits [..., V]."""
        return self.head(h)

    def forward(self, codes: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced logits [B, T, V] of codes [B, T] (labels: class
        ids [B], or a dummy [B] without class conditioning)."""
        B = codes.shape[0]
        h = torch.cat([self.sos_tokens(B, labels),
                       self.embed_images(codes)[:, :-1]], dim=1)
        return self.head(self._causal(h))


class Transformer1d(_FlatGPT):
    """Text-then-image GPT with an image head and a text head."""

    def __init__(self, vocab_size_txt: int, vocab_size_img: int,
                 hparams: Stage2Hparams, dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size_img, hparams, dtype, False, True,
                         vocab_size_txt)
        D = hparams.embed_dim
        self.head_img = Linear(D, vocab_size_img, bias=False)
        self.head_txt = Linear(D, vocab_size_txt, bias=False)

    def image_logits(self, h: torch.Tensor) -> torch.Tensor:
        """h after ln_f [..., D] -> image logits [..., V_img]."""
        return self.head_img(h)

    def forward(self, images: torch.Tensor, texts: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, T], texts [B, N] -> (image logits [B, T, V_img],
        text logits [B, N - 1, V_txt])."""
        N = texts.shape[1]
        x = self._causal(torch.cat([self.sos_tokens(images.shape[0], texts),
                                    self.embed_images(images)], dim=1))
        return self.head_img(x[:, N - 1:-1]), self.head_txt(x[:, :N - 1])
