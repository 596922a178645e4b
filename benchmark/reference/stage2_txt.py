"""Stage 2 of the text-to-image HQ-Transformer (2 levels, `parallel`),
teacher-forced, in plain float32 PyTorch.

As `stage2.py`'s 2-level forward, with a caption in the place of the
class token. The caption's ids [B, S] (S = ctx_len_txt, 64 in the released
model; padded with the tokenizer's pad id 0, and every row attended, as
the model does for real captions) are embedded as `tok_emb_txt(ids) +
pos_emb_txt(0..S-1)`. The spatial GPT's blocks (causal, exact GELU,
LayerNorm eps 1e-5) and `ln_f` run over [caption_0 .. caption_{S-1},
cell_0 .. cell_{N-2}], S + N - 1 rows; rows S - 1 .. S + N - 2 start the
depth transformer of cells 0 .. N - 1, whose tokens, mask and heads are
those of `stage2.forward_2level`.

Left out: the text head (`ln_txt`, `head_txt`) over rows 0 .. S - 2,
whose logits train the caption (`weight_txt`) and which serving never
computes.

Weights are a state dict in the reference key layout (any float dtype;
widened to float32 here); `cfg` is the configuration file's
`model.stage2` section. `rnd` rounds the operands of every product, as in
`stage2.py` (the control: `lowp.FP8`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .lowp import F32, Precision
from .stage2 import Weights, _emb, _w, block, depth, head, layer_norm


def caption(w: Weights, ids: torch.Tensor) -> torch.Tensor:
    """The caption's S rows [B, S, D]: token plus position embeddings."""
    pos = torch.arange(ids.shape[1], device=ids.device)
    return _emb(w, 'tok_emb_txt.weight', ids) + \
        _emb(w, 'pos_emb_txt.weight', pos)[None]


def spatial(w: Weights, cfg: dict, ids: torch.Tensor, cells: torch.Tensor,
            rnd: Precision) -> torch.Tensor:
    """The spatial GPT over the caption and the cell embeddings cells
    [B, N, D] (the last one unused): h [B, N, D] after `ln_f`, h[:, i] the
    state that predicts cell i (row S - 1 + i)."""
    hp = cfg['hparams']
    S = ids.shape[1]
    x = torch.cat([caption(w, ids), cells[:, :-1]], 1)
    T = x.shape[1]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for i in range(hp['n_layers']):
        x = block(w, f'blocks.{i}', x, hp['n_heads'], mask, rnd)
    return layer_norm(w, 'ln_f', x[:, S - 1:])


def forward_2level(w: Weights, cfg: dict, ids: torch.Tensor,
                   top: torch.Tensor, bots: torch.Tensor,
                   rnd: Precision = F32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits of every cell's top code [B, N, V] and of its bottoms
    [B, N, r, V], given the caption ids [B, S] and the cells' codes top
    [B, N] and bots [B, N, r]."""
    B, N = top.shape
    r = bots.shape[-1]
    pos = _emb(w, 'pos_emb_top.weight', torch.arange(N, device=top.device))
    toks = torch.cat([(_emb(w, 'tok_emb_top.weight', top) + pos)[:, :, None],
                      _emb(w, 'tok_emb_bot.weight', bots)], dim=2)
    cells = (toks + _w(w, 'pos_emb_emb.weight')[:r + 1]).mean(dim=2)
    h = spatial(w, cfg, ids, cells, rnd).reshape(B * N, 1, -1)
    e_top = _emb(w, 'tok_emb_top_depth.weight', top.reshape(B * N, 1))
    x = torch.cat([h + _w(w, 'sos_depth'),
                   e_top + _w(w, 'pos_emb_depth.weight')[:r]], dim=1)
    mask = torch.ones(r + 1, r + 1, dtype=torch.bool, device=x.device)
    mask[0, 1:] = False
    x = depth(w, cfg, x, mask, rnd)
    logits_top = head(w, 'ln_top', 'head_top', x[:, 0], rnd)
    logits_bot = head(w, 'ln_bot', 'head_bot', x[:, 1:], rnd)
    return logits_top.reshape(B, N, -1), logits_bot.reshape(B, N, r, -1)


def forward(w: Weights, cfg: dict, ids: torch.Tensor,
            codes: Sequence[torch.Tensor], rnd: Precision = F32
            ) -> List[torch.Tensor]:
    """The text model's forward: codes are (top, bots)."""
    if cfg['type'].startswith('multilevel-hq'):
        raise ValueError('the text reference has 2 code levels')
    return list(forward_2level(w, cfg, ids, *codes, rnd=rnd))
