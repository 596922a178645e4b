"""Stage 2 of HQ-Transformer, teacher-forced, in plain float32 PyTorch.

Weights are a state dict in the reference key layout (any float dtype;
widened to float32 here). `cfg` is the configuration file's `model.stage2`
section. Both models condition on class labels through `sos` and embed
each cell by `transformer1`: the cell's code embeddings (the top one plus
its spatial position) plus `pos_emb_emb`, averaged.

A spatial GPT of pre-LN blocks (causal, exact GELU, LayerNorm eps 1e-5)
runs over [sos, cell_0 .. cell_{N-2}]; its output at position i, plus
`sos_depth`, starts the depth transformer (by default 4 blocks at the
same width) of cell i, whose later tokens are the cell's codes:
- 2 levels (`parallel`): [h, top + pos_0 .. top + pos_3], token 0 seeing
  itself and tokens 1..4 seeing all five; `head_top` reads token 0,
  `head_bot` tokens 1..4, the bottoms of the cell in its local raster
  order;
- 3 levels (`parallel-add`): [h, top + pos_0..3 (level 0 positions), mid
  + top + pos_k (k the bottom's index) for the 16 bottoms], token 0
  seeing itself, tokens 1..4 tokens 0..4, the bottom tokens all 21;
  `head_levels.<l>` read token 0, tokens 1..4 and tokens 5..20.
Codes come as a cell's top [B, N], its mids [B, N, 4] and its bottoms
[B, N, r] in the cell's local raster order; logits come back the same way.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .lowp import F32, Precision

Weights = Dict[str, torch.Tensor]


def _w(w: Weights, name: str) -> torch.Tensor:
    return w[name].float()


def linear(w: Weights, name: str, x: torch.Tensor, rnd: Precision,
           bias: bool = True) -> torch.Tensor:
    y = rnd(x) @ rnd(_w(w, f'{name}.weight')).T
    return y + _w(w, f'{name}.bias') if bias else y


def layer_norm(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], _w(w, f'{name}.weight'),
                        _w(w, f'{name}.bias'), 1e-5)


def attention(w: Weights, name: str, x: torch.Tensor, n_heads: int,
              mask: torch.Tensor, rnd: Precision) -> torch.Tensor:
    """Multi-head self-attention over x [B, T, D]; mask bool [T, T], True
    where a query may see a key."""
    B, T, D = x.shape
    hd = D // n_heads

    def heads(t):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)
    q, k, v = (heads(linear(w, f'{name}.{p}', x, rnd))
               for p in ('query', 'key', 'value'))
    s = rnd(q) @ rnd(k).transpose(-1, -2) / math.sqrt(hd)
    s = s.masked_fill(~mask, float('-inf'))
    y = rnd(torch.softmax(s, dim=-1)) @ rnd(v)
    return linear(w, f'{name}.proj', y.transpose(1, 2).reshape(B, T, D), rnd)


def block(w: Weights, name: str, x: torch.Tensor, n_heads: int,
          mask: torch.Tensor, rnd: Precision) -> torch.Tensor:
    x = x + attention(w, f'{name}.attn', layer_norm(w, f'{name}.ln1', x),
                      n_heads, mask, rnd)
    h = F.gelu(linear(w, f'{name}.mlp.0', layer_norm(w, f'{name}.ln2', x),
                      rnd))
    return x + linear(w, f'{name}.mlp.2', h, rnd)


def _emb(w: Weights, name: str, idx: torch.Tensor) -> torch.Tensor:
    return F.embedding(idx.long(), _w(w, name))


def spatial(w: Weights, cfg: dict, labels: torch.Tensor,
            cells: torch.Tensor, rnd: Precision) -> torch.Tensor:
    """The spatial GPT over the cell embeddings cells [B, N, D] (the last
    one unused): h [B, N, D] after `ln_f`, h[:, i] the state that predicts
    cell i."""
    hp = cfg['hparams']
    B, N, _ = cells.shape
    x = torch.cat([_emb(w, 'sos.weight', labels)[:, None], cells[:, :-1]], 1)
    mask = torch.ones(N, N, dtype=torch.bool, device=x.device).tril()
    for i in range(hp['n_layers']):
        x = block(w, f'blocks.{i}', x, hp['n_heads'], mask, rnd)
    return layer_norm(w, 'ln_f', x)


def depth(w: Weights, cfg: dict, x: torch.Tensor, mask: torch.Tensor,
          rnd: Precision) -> torch.Tensor:
    """The depth transformer's blocks over x [M, T, D]: `hparams_dec`'s,
    by default 4 blocks of the spatial ones' width and heads."""
    hpd = {**cfg['hparams'], 'n_layers': 4, **(cfg.get('hparams_dec') or {})}
    for i in range(hpd['n_layers']):
        x = block(w, f'depths.{i}', x, hpd['n_heads'], mask, rnd)
    return x


def head(w: Weights, ln: str, lin: str, x: torch.Tensor,
         rnd: Precision) -> torch.Tensor:
    return linear(w, lin, layer_norm(w, ln, x), rnd, bias=False)


def forward_2level(w: Weights, cfg: dict, labels: torch.Tensor,
                   top: torch.Tensor, bots: torch.Tensor,
                   rnd: Precision = F32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logits of every cell's top code [B, N, V] and of its bottoms
    [B, N, r, V], given the cells' codes top [B, N] and bots [B, N, r]."""
    B, N = top.shape
    r = bots.shape[-1]
    pos = _emb(w, 'pos_emb_top.weight', torch.arange(N, device=top.device))
    toks = torch.cat([(_emb(w, 'tok_emb_top.weight', top) + pos)[:, :, None],
                      _emb(w, 'tok_emb_bot.weight', bots)], dim=2)
    cells = (toks + _w(w, 'pos_emb_emb.weight')[:r + 1]).mean(dim=2)
    h = spatial(w, cfg, labels, cells, rnd).reshape(B * N, 1, -1)
    e_top = _emb(w, 'tok_emb_top_depth.weight', top.reshape(B * N, 1))
    x = torch.cat([h + _w(w, 'sos_depth'),
                   e_top + _w(w, 'pos_emb_depth.weight')[:r]], dim=1)
    mask = torch.ones(r + 1, r + 1, dtype=torch.bool, device=x.device)
    mask[0, 1:] = False
    x = depth(w, cfg, x, mask, rnd)
    logits_top = head(w, 'ln_top', 'head_top', x[:, 0], rnd)
    logits_bot = head(w, 'ln_bot', 'head_bot', x[:, 1:], rnd)
    return logits_top.reshape(B, N, -1), logits_bot.reshape(B, N, r, -1)


def level3_mask(device) -> torch.Tensor:
    """The 21-token depth mask of `parallel-add`: token 0 sees itself, the
    mid tokens 1..4 see tokens 0..4, the bottom tokens all 21."""
    mask = torch.zeros(21, 21, dtype=torch.bool, device=device)
    mask[0, 0] = True
    mask[1:5, :5] = True
    mask[5:] = True
    return mask


def forward_3level(w: Weights, cfg: dict, labels: torch.Tensor,
                   top: torch.Tensor, mids: torch.Tensor, bots: torch.Tensor,
                   rnd: Precision = F32) -> List[torch.Tensor]:
    """Logits [B, N, V], [B, N, 4, V], [B, N, 16, V] of every cell's top,
    mids and bottoms (local raster order in the cell), given its codes
    top [B, N], mids [B, N, 4], bots [B, N, 16]."""
    B, N = top.shape
    dev = top.device
    pos = _emb(w, 'pos_emb_top.weight', torch.arange(N, device=dev))
    toks = torch.cat([
        (_emb(w, 'tok_emb_levels.0.weight', top) + pos)[:, :, None],
        _emb(w, 'tok_emb_levels.1.weight', mids),
        _emb(w, 'tok_emb_levels.2.weight', bots)], dim=2)
    cells = (toks + _w(w, 'pos_emb_emb.weight')[:21]).mean(dim=2)
    h = spatial(w, cfg, labels, cells, rnd).reshape(B * N, 1, -1)
    e_top = _emb(w, 'tok_emb_depth_levels.0.weight', top.reshape(B * N, 1))
    # bottom k of the 4x4 cell (row k // 4, column k % 4) lies under mid
    # (row // 2) * 2 + column // 2 of the 2x2 one
    k = torch.arange(16, device=dev)
    parent = (k // 8) * 2 + (k % 4) // 2
    e_mid = _emb(w, 'tok_emb_depth_levels.1.weight',
                 mids.reshape(B * N, 4)[:, parent])
    x = torch.cat([h + _w(w, 'sos_depth'),
                   e_top + _w(w, 'pos_emb_depths.0.weight')[:4],
                   e_mid + e_top + _w(w, 'pos_emb_depths.1.weight')[:16]],
                  dim=1)
    x = depth(w, cfg, x, level3_mask(dev), rnd)
    return [head(w, 'ln_levels.0', 'head_levels.0', x[:, 0], rnd)
            .reshape(B, N, -1),
            head(w, 'ln_levels.1', 'head_levels.1', x[:, 1:5], rnd)
            .reshape(B, N, 4, -1),
            head(w, 'ln_levels.2', 'head_levels.2', x[:, 5:], rnd)
            .reshape(B, N, 16, -1)]


def raster_to_cells(codes: torch.Tensor, side: int, win: int
                    ) -> torch.Tensor:
    """A raster code map [B, (side win)^2] -> [B, side^2, win^2], each
    cell's codes in its local raster order."""
    B = codes.shape[0]
    x = codes.reshape(B, side, win, side, win).permute(0, 1, 3, 2, 4)
    return x.reshape(B, side * side, win * win)


def cells_to_raster(cells: torch.Tensor, side: int, win: int
                    ) -> torch.Tensor:
    """The inverse of `raster_to_cells`: [B, side^2, win^2] -> a raster
    map [B, side win, side win]."""
    B = cells.shape[0]
    x = cells.reshape(B, side, side, win, win).permute(0, 1, 3, 2, 4)
    return x.reshape(B, side * win, side * win)


def forward(w: Weights, cfg: dict, labels: torch.Tensor,
            codes: Sequence[torch.Tensor], rnd: Precision = F32
            ) -> List[torch.Tensor]:
    """The model's forward by its type: codes are (top, bots) for 2
    levels, (top, mids, bots) for 3."""
    if cfg['type'].startswith('multilevel-hq'):
        return forward_3level(w, cfg, labels, *codes, rnd=rnd)
    return list(forward_2level(w, cfg, labels, *codes, rnd=rnd))
