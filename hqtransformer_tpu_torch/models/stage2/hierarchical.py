"""HQ-Transformer for two-level modeling: a spatial GPT over fused top-cell
embeddings plus a small depth transformer that emits each position's top
code and its bottom codes.

Counterpart of `hqtransformer_tpu/models/stage2/hierarchical.py::
HierarchicalGPT` for the configuration the slice serves: class-conditional,
`parallel` depth mode, `transformer1` cell embedding (zero embedding blocks:
a cell is the mean of its top and bottom embeddings), 1-d spatial position
embedding. Other configurations raise `NotImplementedError`.

Reproduced reference quirk: the parallel depth sampler embeds the codes of
the previous depth step with `tok_emb_top_depth`, whether they are the top
code or a bottom group.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...config import ModelTypeSpec, Stage2Hparams, parse_embedding_type
from ...ops import masks as M
from .layers import (Block, LayerNorm, Linear, masked_attention,
                     merge_heads, split_heads)

DepthKV = Tuple[List[torch.Tensor], List[torch.Tensor]]


def raster_to_cells(bot: torch.Tensor, h_top: int, win: int) -> torch.Tensor:
    """[B, (H win W win)] raster bottom codes -> [B, H*W, win*win] groups."""
    B = bot.shape[0]
    x = bot.reshape(B, h_top, win, h_top, win).permute(0, 1, 3, 2, 4)
    return x.reshape(B, h_top * h_top, win * win)


def cells_to_raster(bot_cells: torch.Tensor, h_top: int,
                    win: int) -> torch.Tensor:
    """Inverse of raster_to_cells: [B, H*W, win*win] -> [B, (H win W win)]."""
    B = bot_cells.shape[0]
    x = bot_cells.reshape(B, h_top, h_top, win, win).permute(0, 1, 3, 2, 4)
    return x.reshape(B, h_top * win * h_top * win)


class HierarchicalGPT(nn.Module):
    """Two-level hierarchical AR transformer (iHQGPT)."""

    def __init__(self, vocab_size_top: int, vocab_size_bot: int,
                 ratio_bot2top: int, use_cls_cond: bool,
                 model_type: ModelTypeSpec, hparams: Stage2Hparams,
                 hparams_dec: Optional[Stage2Hparams] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        emb = parse_embedding_type(hparams.embedding_type)
        if not use_cls_cond:
            raise NotImplementedError('only class conditioning is ported')
        if model_type.depth_mode != 'parallel':
            raise NotImplementedError(
                f'depth mode {model_type.depth_mode!r} is not ported')
        if emb.kind != 'transformer' or emb.n_layers_emb != 0:
            raise NotImplementedError(
                f'embedding type {hparams.embedding_type!r} is not ported')
        if hparams.position_embedding != '1d' or hparams.use_random_order:
            raise NotImplementedError('only 1-d, raster-order positions are '
                                      'ported')
        self.hparams = hparams
        self.hpd = hparams_dec or Stage2Hparams(
            **{**hparams.__dict__, 'n_layers': 4})
        self.ratio_bot2top = ratio_bot2top
        self.bot_win = model_type.bot_win
        self.num_bottom_pred = self.bot_win * self.bot_win
        self.len_seq_depth = 1 + ratio_bot2top // self.num_bottom_pred
        self.cell_win = int(math.isqrt(ratio_bot2top))
        self.dtype = dtype
        hp, hpd = hparams, self.hpd
        D, Dd = hp.embed_dim, hpd.embed_dim

        def blocks(h, n):
            return nn.ModuleList(
                Block(h.embed_dim, h.n_heads, h.mlp_bias, h.attn_bias,
                      h.gelu_use_approx) for _ in range(n))

        self.sos = nn.Embedding(hp.n_classes, D)
        self.tok_emb_top = nn.Embedding(vocab_size_top, D)
        self.tok_emb_bot = nn.Embedding(vocab_size_bot, D)
        self.pos_emb_emb = nn.Embedding(ratio_bot2top + 1, D)
        self.pos_emb_top = nn.Embedding(hp.ctx_len_img, D)
        self.blocks = blocks(hp, hp.n_layers)
        self.ln_f = LayerNorm(D)

        self.sos_depth = nn.Parameter(torch.zeros(1, 1, Dd))
        self.tok_emb_top_depth = nn.Embedding(vocab_size_top, Dd)
        self.tok_emb_bot_depth = nn.Embedding(vocab_size_bot, Dd)
        n_pos_depth = 16 if ratio_bot2top == 16 else max(self.len_seq_depth, 5)
        self.pos_emb_depth = nn.Embedding(n_pos_depth, Dd)
        self.depths = blocks(hpd, hpd.n_layers)
        self.ln_top = LayerNorm(Dd)
        self.head_top = Linear(Dd, vocab_size_top, bias=False)
        self.ln_bot = LayerNorm(Dd)
        self.head_bot = Linear(Dd, vocab_size_bot, bias=False)

    # ------------------------------------------------------------ embedding
    def _emb(self, table: nn.Embedding, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, table.weight).to(self.dtype)

    def embed_cells(self, codes_t: torch.Tensor, bot_cells: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
        """Fuse each top code with its bottom codes into one spatial token:
        the mean of [top + pos, bot_0..bot_{r-1}] after adding pos_emb_emb.
        codes_t: [B, L], bot_cells: [B, L, r], positions: [B, L] -> [B, L, D].
        """
        emb_top = self._emb(self.tok_emb_top, codes_t) + \
            self._emb(self.pos_emb_top, positions)
        emb_bot = self._emb(self.tok_emb_bot, bot_cells)           # [B,L,r,D]
        h = torch.cat([emb_top[:, :, None, :], emb_bot], dim=2)
        h = h + self.pos_emb_emb.weight[:self.ratio_bot2top + 1].to(self.dtype)
        return h.mean(dim=2)

    def sos_tokens(self, B: int, labels: torch.Tensor) -> torch.Tensor:
        """[B, 1, D] class-conditioning prefix."""
        return self._emb(self.sos, labels)[:, None, :]

    # -------------------------------------------------------------- forward
    def forward(self, codes_t: torch.Tensor, codes_b: torch.Tensor,
                labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward. codes_t: [B, Ttop], codes_b:
        [B, Ttop*ratio] raster order. Returns (logits_top [B, Ttop, Vt],
        logits_bot [B, Tbot, Vb])."""
        h = self.forward_main(codes_t, codes_b, labels)
        return self.forward_depth(h, codes_t)

    def forward_main(self, codes_t, codes_b, labels):
        B, Ttop = codes_t.shape
        bot_cells = raster_to_cells(codes_b, int(math.isqrt(Ttop)),
                                    self.cell_win)
        positions = torch.arange(Ttop, device=codes_t.device).expand(B, Ttop)
        h = self.embed_cells(codes_t, bot_cells, positions)
        h = torch.cat([self.sos_tokens(B, labels), h[:, :-1]], dim=1)
        mask = M.causal(h.shape[1], h.device)
        for blk in self.blocks:
            h = blk(h, mask)
        return self.ln_f(h)

    def forward_depth(self, h, codes_t):
        B, Ttop = codes_t.shape
        h_top = int(math.isqrt(Ttop))
        r = self.ratio_bot2top
        hs = h.reshape(B * Ttop, 1, -1) + self.sos_depth.to(self.dtype)
        emb_top = self._emb(self.tok_emb_top_depth, codes_t).reshape(
            B * Ttop, 1, -1)
        pos = self.pos_emb_depth.weight[:r].to(self.dtype)[None]
        x = torch.cat([hs, emb_top + pos], dim=1)
        mask = M.parallel_2level(1 + r, self.num_bottom_pred, h.device)
        for blk in self.depths:
            x = blk(x, mask)
        logits_top = self.head_top(self.ln_top(x[:, 0])).reshape(B, Ttop, -1)
        logits_bot = self.head_bot(self.ln_bot(x[:, 1:]))
        w = self.cell_win
        logits_bot = logits_bot.reshape(B, h_top, h_top, w, w, -1).permute(
            0, 1, 3, 2, 4, 5).reshape(B, Ttop * r, -1)
        return logits_top, logits_bot

    # --------------------------------------------------------- decode steps
    def spatial_prefill(self, x: torch.Tensor, k_caches: torch.Tensor,
                        v_caches: torch.Tensor) -> torch.Tensor:
        """Run the spatial transformer on the conditioning prefix x
        [B, S, D], writing cache rows [0, S) of every layer of the packed
        [L, T, B, D] caches in place. Returns h after ln_f [B, S, D]."""
        for i, blk in enumerate(self.blocks):
            x = blk.prefill(x, k_caches, v_caches, i)
        return self.ln_f(x)

    def spatial_step(self, x: torch.Tensor, k_caches: torch.Tensor,
                     v_caches: torch.Tensor, pos: int) -> torch.Tensor:
        """One token x [B, 1, D] at time `pos` against the packed caches
        (updated in place). Returns h after ln_f [B, 1, D]."""
        for i, blk in enumerate(self.blocks):
            x = blk.step(x, k_caches, v_caches, i, pos)
        return self.ln_f(x)

    def embed_cell_step(self, code_t: torch.Tensor, bot_cell: torch.Tensor,
                        position: torch.Tensor) -> torch.Tensor:
        """Embed one generated cell for the next spatial step. code_t: [B],
        bot_cell: [B, ratio], position: [B] -> [B, 1, D]."""
        return self.embed_cells(code_t[:, None], bot_cell[:, None, :],
                                position[:, None])

    def depth_first_logits(self, h: torch.Tensor
                           ) -> Tuple[torch.Tensor, DepthKV]:
        """Depth step 0: top-code logits [B, Vt] from sos_depth + h [B, D],
        and each depth layer's (k, v) [B, nh, 1, hd] of that one token.
        Softmax over a single key is 1, so the attention output is v and q
        is never computed."""
        x = h[:, None, :] + self.sos_depth.to(self.dtype)
        ks, vs = [], []
        for blk in self.depths:
            a = blk.attn
            xn = blk.ln1(x)
            w = torch.cat([a.key.weight, a.value.weight]).to(xn.dtype)
            b = None
            if a.key.bias is not None:
                b = torch.cat([a.key.bias, a.value.bias]).to(xn.dtype)
            k, v = F.linear(xn, w, b).split(xn.shape[-1], dim=-1)
            k = split_heads(k, a.n_heads)
            v = split_heads(v, a.n_heads)
            x = x + a.proj(merge_heads(v))
            x = x + blk.mlp(blk.ln2(x))
            ks.append(k)
            vs.append(v)
        return self.head_top(self.ln_top(x[:, 0])), (ks, vs)

    def depth_second_logits(self, codes: torch.Tensor, depth_kv: DepthKV,
                            group: int = 1) -> Tuple[torch.Tensor, DepthKV]:
        """Depth step `group`: logits [B, n, Vb] of the next group of n
        bottom codes, given the previous step's codes [B, 1] or [B, n]
        (embedded with tok_emb_top_depth) and the cached depth (k, v).
        Full attention over [cached; new] keys."""
        ks, vs = depth_kv
        n = self.num_bottom_pred
        pos = self.pos_emb_depth.weight[n * (group - 1):n * group]
        x = self._emb(self.tok_emb_top_depth, codes) + pos.to(self.dtype)
        new_ks, new_vs = [], []
        for i, blk in enumerate(self.depths):
            a = blk.attn
            C = x.shape[-1]
            q, k_new, v_new = a.fused_qkv(blk.ln1(x)).split(C, dim=-1)
            k = torch.cat([ks[i], split_heads(k_new, a.n_heads)], dim=2)
            v = torch.cat([vs[i], split_heads(v_new, a.n_heads)], dim=2)
            y = merge_heads(masked_attention(split_heads(q, a.n_heads), k, v,
                                             None))
            x = x + a.proj(y)
            x = x + blk.mlp(blk.ln2(x))
            new_ks.append(k)
            new_vs.append(v)
        return self.head_bot(self.ln_bot(x)), (new_ks, new_vs)
