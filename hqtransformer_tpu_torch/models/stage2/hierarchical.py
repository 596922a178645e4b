"""HQ-Transformer for two-level modeling: a spatial GPT over fused top-cell
embeddings plus a small depth transformer that emits each position's top
code and its bottom codes.

Counterpart of `hqtransformer_tpu/models/stage2/hierarchical.py::
HierarchicalGPT` in its three depth modes, with every conditioning and cell
embedding of the JAX module. The depth modes:
- `parallel` (any bottom window): step 0 gives the top code's logits,
  each later step those of a group of bot_win^2 bottom codes at once;
- `bidirectional`: one pass over [sos + h, Pos_0..r-1], unmasked, gives
  the logits of the top and of every bottom (`depth_bidirectional`);
- `top2bot` (the released `-causal` config; bot_win 1): a causal chain of
  1 + r single-token steps over per-head depth caches
  (`depth_causal_step`), the top code first.
The conditionings and cell embeddings:
- the conditioning prefix (`Conditioning`, shared with the 3-level
  model): class labels (`sos`, an embedding), text (`tok_emb_txt` +
  `pos_emb_txt` over the caption's ctx_len_txt tokens, 64 in the released
  config; the teacher-forced forward also returns the text logits
  `head_txt(ln_txt(.))`) or none (`sos`, one learned [1, 1, D] token);
- the cell embeddings `reduce` (the r bottom embeddings of width D / r
  packed K-major into one D-wide vector and added to the top's),
  `multiple` (the bottoms weighted per channel by `pos_emb_bot` and
  summed), `transformerN` and `bidirectionalN` (N - 1 unmasked
  `emb_blocks` over the r + 1 cell tokens, then their mean; the
  bidirectional kind adds the position after the mean);
- 1-d or 2-d (`pos_emb_top_h`, `pos_emb_top_w`) spatial positions, and
  `use_random_order`, whose `pred_emb_top` is added in `embed_cell_step`
  only: the reference's sampler-only quirk, which the training forward
  ignores.

Reproduced reference quirk: the parallel depth sampler embeds the codes of
the previous depth step with `tok_emb_top_depth`, whether they are the top
code or a bottom group.

int8max serving: `serving(int8, scales)` prepares one sampler call (see
`layers.py`); inside it `spatial_prefill`/`spatial_step` run their gemms
A8W8 when passed `int8=True` and `depth_second_logits` likewise, head_bot
included, as the JAX package's `int8_stage2_scope` does around them.
`depth_first_logits`, `embed_cell_step` (its `emb_blocks` too) and
`head_txt` stay float, as in JAX. In the `bidirectional` and `top2bot`
modes only the spatial side runs int8 (cache and gemms); their depth
passes and both heads stay float (`depth_int8`), as in JAX. Every switch
runs under tensor parallelism too (`SpatialDecoding.serving`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ...config import ModelTypeSpec, Stage2Hparams, parse_embedding_type
from ...ops import masks as M
from ...ops.int8 import Int8Serving
from .layers import (Block, LayerNorm, Linear, QuantizableLinear, act_scale,
                     merge_heads, split_heads, tiny_attention)

DepthKV = Tuple[List[torch.Tensor], List[torch.Tensor]]
EMBEDDINGS = ('reduce', 'multiple', 'transformer', 'bidirectional')
DEPTH_MODES = ('parallel', 'bidirectional', 'top2bot')


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


class Conditioning:
    """The conditioning prefix and the spatial position embedding of a
    stage-2 model with `hparams` and `dtype`; the 2-level and the 3-level
    models share them, as the JAX modules' `_sos_embedding` and
    `_spatial_pos_emb` are alike, and the flat baselines share the prefix
    (`transformer.py`). Labels are class ids [B] (class conditioning),
    caption token ids [B, N] (text; N = ctx_len_txt, or for `Transformer1d`
    any N up to it) or any [B] tensor (none: only B is read)."""

    def _build_prefix(self, use_cls_cond: bool, use_txt_cond: bool,
                      vocab_size_txt: int) -> None:
        """The prefix's embeddings: `sos` (class ids, or one learned
        [1, 1, D] token) or `tok_emb_txt` and `pos_emb_txt`."""
        hp = self.hparams
        D = hp.embed_dim
        self.use_cls_cond = use_cls_cond
        self.use_txt_cond = use_txt_cond and not use_cls_cond
        if use_cls_cond:
            self.sos = nn.Embedding(hp.n_classes, D)
        elif self.use_txt_cond:
            self.tok_emb_txt = nn.Embedding(vocab_size_txt, D)
            self.pos_emb_txt = nn.Embedding(hp.ctx_len_txt, D)
        else:
            self.sos = nn.Parameter(torch.zeros(1, 1, D))

    def _build_conditioning(self, use_cls_cond: bool, use_txt_cond: bool,
                            vocab_size_txt: int) -> None:
        """The prefix, the text head of a text model (`ln_txt`,
        `head_txt`) and the spatial positions."""
        hp = self.hparams
        D = hp.embed_dim
        self._build_prefix(use_cls_cond, use_txt_cond, vocab_size_txt)
        if self.use_txt_cond:
            self.ln_txt = LayerNorm(D)
            self.head_txt = Linear(D, vocab_size_txt, bias=False)
        if hp.position_embedding == '1d':
            self.pos_emb_top = nn.Embedding(hp.ctx_len_img, D)
        elif hp.position_embedding == '2d':
            H = math.isqrt(hp.ctx_len_img)
            self.pos_emb_top_h = nn.Embedding(H, D)
            self.pos_emb_top_w = nn.Embedding(H, D)
        else:
            raise ValueError(hp.position_embedding)

    def _emb(self, table: nn.Embedding, idx: torch.Tensor) -> torch.Tensor:
        """table(idx) in the activation dtype; a feature-sharded token
        table's rows gathered to full width (tensor parallelism)."""
        x = F.embedding(idx, table.weight)
        tp = getattr(table, 'tp', None)
        return (x if tp is None else tp.gather(x)).to(self.dtype)

    @property
    def sos_len(self) -> int:
        """The prefix's length: the caption's ctx_len_txt tokens, else 1."""
        return self.hparams.ctx_len_txt if self.use_txt_cond else 1

    def sos_tokens(self, B: int, labels: Optional[torch.Tensor]
                   ) -> torch.Tensor:
        """[B, S, D] conditioning prefix: S = 1, or a caption's N tokens."""
        if self.use_cls_cond:
            return self._emb(self.sos, labels)[:, None, :]
        if self.use_txt_cond:
            pos = torch.arange(labels.shape[1], device=labels.device)
            return self._emb(self.tok_emb_txt, labels) + \
                self._emb(self.pos_emb_txt, pos)[None]
        return self.sos.to(self.dtype).expand(B, -1, -1)

    def spatial_pos_emb(self, positions: torch.Tensor) -> torch.Tensor:
        """positions [B, L] -> [B, L, D]: `pos_emb_top`, or with 2-d
        positions `pos_emb_top_h(p // H) + pos_emb_top_w(p % H)`, H the
        side of ctx_len_img."""
        if self.hparams.position_embedding == '1d':
            return self._emb(self.pos_emb_top, positions)
        H = self.pos_emb_top_h.num_embeddings
        return self._emb(self.pos_emb_top_h, positions // H) + \
            self._emb(self.pos_emb_top_w, positions % H)

    def split_text(self, h: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The spatial output h [B, sos_len + N - 1, D] of the teacher-
        forced forward -> (its image part [B, N, D], the text logits
        [B, ctx_len_txt - 1, V_txt] or None)."""
        if not self.use_txt_cond:
            return h, None
        n = self.sos_len
        return h[:, n - 1:], self.head_txt(self.ln_txt(h[:, :n - 1]))


class SpatialDecoding:
    """The serving state and the spatial transformer's serving steps on
    the packed [L, T, B, D] KV caches, for a model with `blocks`, `depths`,
    `ln_f`, `dtype`, `int8_heads()` and `int8_embedding()`: the 2-level
    and the 3-level models and the flat baselines share them.
    `depth_int8` says whether `depth_gemms` quantizes the depth blocks and
    the `int8_heads()`: the models whose depth passes JAX runs in its
    int8 scope. `remat` (training) recomputes each main block's
    activations in the backward pass (`torch.utils.checkpoint`), as the
    JAX model's `nn.remat` blocks do; the gradients are the same."""

    depth_int8: bool = True
    remat: bool = False

    def run_blocks(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The main transformer's blocks over h under `mask`."""
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(blk, h, mask,
                                                      use_reentrant=False)
            else:
                h = blk(h, mask)
        return h

    @contextlib.contextmanager
    def serving(self, int8: Int8Serving = Int8Serving(),
                scales: Optional[Mapping[str, Mapping[str, torch.Tensor]]]
                = None) -> Iterator[None]:
        """Prepare the modules for one serving call and undo it on exit:
        every attention layer's fused QKV and K/V weights concatenated in
        the activation dtype; with `int8.spatial_gemms` / `depth_gemms`
        the spatial / depth blocks' gemms (and the `int8_heads()`; the
        depth ones only where `depth_int8`) quantized, with the static
        activation scales of
        `scales['stage2/act_scales']`, and with `spatial_gemms` the
        `int8_embedding()` gemms too; with `int8.kv_cache` the spatial
        layers' cache scales from `scales['stage2/kv_scales']`. Raises on a
        missing scale before any module changes, and on int8 gemms for
        activations that are not bf16. Under tensor parallelism every
        switch runs: the scales are whole (the tp-1 layout, one artifact
        for every tp), each attention layer takes its heads' span of the
        cache scales, and the row-parallel weights' scales are maxed over
        the tp group, the only collectives here, made after every scale
        was found (so a rank raises before any of them)."""
        scales = scales or {}
        if (int8.spatial_gemms or int8.depth_gemms) and \
                self.dtype != torch.bfloat16:
            raise ValueError(f'int8 gemms run on bf16 activations; this '
                             f'model computes in {self.dtype}')
        act = scales.get('stage2/act_scales', {})
        kv = scales.get('stage2/kv_scales', {}) if int8.kv_cache else None
        depth8 = int8.depth_gemms and self.depth_int8
        attn, quantized = [], []
        for prefix, blocks, gemms in (('blocks', self.blocks,
                                       int8.spatial_gemms),
                                      ('depths', self.depths, depth8)):
            for i, blk in enumerate(blocks):
                name = f'{prefix}.{i}'
                attn.append(blk.attn.prepare_serving(
                    self.dtype, act if gemms else None,
                    kv if prefix == 'blocks' else None, f'{name}.attn'))
                if gemms:
                    quantized += [(f'{name}.attn.proj', blk.attn.proj),
                                  (f'{name}.mlp.0', blk.mlp[0]),
                                  (f'{name}.mlp.2', blk.mlp[2])]
        if int8.spatial_gemms:
            quantized += self.int8_embedding()
        if depth8:
            quantized += self.int8_heads()
        x_scales = [act_scale(act, name) for name, _ in quantized]
        q8 = [lin.quantize(x) for (_, lin), x in zip(quantized, x_scales)]
        # every scale was found: only now does any module change
        try:
            for blk, state in zip((*self.blocks, *self.depths), attn):
                blk.attn.serving = state
            for (_, lin), w in zip(quantized, q8):
                lin.q8 = w
            yield
        finally:
            for blk in (*self.blocks, *self.depths):
                blk.attn.serving = None
            for _, lin in quantized:
                lin.q8 = None

    def spatial_prefill(self, x: torch.Tensor, k_caches: torch.Tensor,
                        v_caches: torch.Tensor,
                        int8: bool = False) -> torch.Tensor:
        """Run the spatial transformer on the conditioning prefix x
        [B, S, D], causal among its S tokens, writing cache rows [0, S) of
        every layer of the packed [L, T, B, D] caches in place. Returns h
        after ln_f [B, S, D]."""
        for i, blk in enumerate(self.blocks):
            x = blk.prefill(x, k_caches, v_caches, i, int8=int8)
        return self.ln_f(x)

    def spatial_step(self, x: torch.Tensor, k_caches: torch.Tensor,
                     v_caches: torch.Tensor, pos: int,
                     int8: bool = False) -> torch.Tensor:
        """One token x [B, 1, D] at time `pos` against the packed caches
        (updated in place, decode attention K1). Returns h after ln_f
        [B, 1, D]."""
        for i, blk in enumerate(self.blocks):
            x = blk.step(x, k_caches, v_caches, i, pos, int8)
        return self.ln_f(x)


class HierarchicalGPT(Conditioning, SpatialDecoding, nn.Module):
    """Two-level hierarchical AR transformer (iHQGPT)."""

    def __init__(self, vocab_size_top: int, vocab_size_bot: int,
                 ratio_bot2top: int, use_cls_cond: bool,
                 model_type: ModelTypeSpec, hparams: Stage2Hparams,
                 hparams_dec: Optional[Stage2Hparams] = None,
                 dtype: torch.dtype = torch.float32,
                 use_txt_cond: bool = False, vocab_size_txt: int = 16384):
        super().__init__()
        self.emb = parse_embedding_type(hparams.embedding_type)
        if model_type.depth_mode not in DEPTH_MODES:
            raise ValueError(f'depth mode {model_type.depth_mode!r}')
        if self.emb.kind not in EMBEDDINGS:
            raise ValueError(hparams.embedding_type)
        self.hparams = hparams
        self.hpd = hparams_dec or Stage2Hparams(
            **{**hparams.__dict__, 'n_layers': 4})
        self.depth_mode = model_type.depth_mode
        self.ratio_bot2top = ratio_bot2top
        self.bot_win = 1 if self.depth_mode == 'top2bot' else \
            model_type.bot_win
        self.num_bottom_pred = self.bot_win * self.bot_win
        self.len_seq_depth = 1 + ratio_bot2top // self.num_bottom_pred
        self.cell_win = int(math.isqrt(ratio_bot2top))
        self.dtype = dtype
        hp, hpd = hparams, self.hpd
        D, Dd = hp.embed_dim, hpd.embed_dim
        r = ratio_bot2top

        def blocks(h, n):
            return nn.ModuleList(
                Block(h.embed_dim, h.n_heads, h.mlp_bias, h.attn_bias,
                      h.gelu_use_approx) for _ in range(n))

        self._build_conditioning(use_cls_cond, use_txt_cond, vocab_size_txt)
        self.tok_emb_top = nn.Embedding(vocab_size_top, D)
        self.tok_emb_bot = nn.Embedding(
            vocab_size_bot, D // r if self.emb.kind == 'reduce' else D)
        if self.emb.kind == 'multiple':
            self.pos_emb_bot = nn.Parameter(
                torch.zeros(1, 1, D, self.num_bottom_pred))
        if self.emb.kind in ('transformer', 'bidirectional'):
            self.pos_emb_emb = nn.Embedding(r + 1, D)
            self.emb_blocks = blocks(hp, self.emb.n_layers_emb)
        if hp.use_random_order:
            self.pred_emb_top = nn.Embedding(hp.ctx_len_img, D)
        self.blocks = blocks(hp, hp.n_layers)
        self.ln_f = LayerNorm(D)

        self.sos_depth = nn.Parameter(torch.zeros(1, 1, Dd))
        self.tok_emb_top_depth = nn.Embedding(vocab_size_top, Dd)
        self.tok_emb_bot_depth = nn.Embedding(vocab_size_bot, Dd)
        n_pos_depth = 16 if self.depth_mode == 'parallel' and r == 16 else \
            max(self.len_seq_depth, 5)
        self.pos_emb_depth = nn.Embedding(n_pos_depth, Dd)
        self.depths = blocks(hpd, hpd.n_layers)
        self.ln_top = LayerNorm(Dd)
        self.head_top = Linear(Dd, vocab_size_top, bias=False)
        self.ln_bot = LayerNorm(Dd)
        self.head_bot = QuantizableLinear(Dd, vocab_size_bot, bias=False)

    # ------------------------------------------------------------ embedding
    def embed_cells(self, codes_t: torch.Tensor, bot_cells: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
        """Fuse each top code with its bottom codes into one spatial token,
        by the model's cell embedding (see the module docstring).
        codes_t: [B, L], bot_cells: [B, L, r] (local raster order),
        positions: [B, L] -> [B, L, D]."""
        B, L = codes_t.shape
        pos = self.spatial_pos_emb(positions)
        emb_top = self._emb(self.tok_emb_top, codes_t)
        emb_bot = self._emb(self.tok_emb_bot, bot_cells)
        kind = self.emb.kind
        if kind == 'reduce':       # channel c: element c // r of bottom c % r
            return emb_top + pos + emb_bot.transpose(2, 3).reshape(B, L, -1)
        if kind == 'multiple':
            w = self.pos_emb_bot.to(self.dtype)
            return emb_top + pos + (emb_bot.transpose(2, 3) * w).sum(-1)
        if kind == 'transformer':
            emb_top = emb_top + pos
        n = self.ratio_bot2top + 1
        h = torch.cat([emb_top[:, :, None, :], emb_bot], dim=2)
        h = h + self.pos_emb_emb.weight[:n].to(self.dtype)
        if len(self.emb_blocks):
            x = h.reshape(B * L, n, -1)
            for blk in self.emb_blocks:
                x = blk(x)
            h = x.reshape(B, L, n, -1)
        h = h.mean(dim=2)
        return h + pos if kind == 'bidirectional' else h

    # -------------------------------------------------------------- forward
    def forward(self, codes_t: torch.Tensor, codes_b: torch.Tensor,
                labels: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
        """Teacher-forced forward. codes_t: [B, Ttop], codes_b:
        [B, Ttop*ratio] raster order, labels as `Conditioning` says.
        Returns (logits_top [B, Ttop, Vt], logits_bot [B, Tbot, Vb]), and
        with text conditioning the text logits [B, ctx_len_txt - 1, V_txt]
        third."""
        h = self.forward_main(codes_t, codes_b, labels)
        h, logits_txt = self.split_text(h)
        logits = self.forward_depth(h, codes_t, codes_b)
        return logits if logits_txt is None else (*logits, logits_txt)

    def forward_main(self, codes_t, codes_b, labels):
        B, Ttop = codes_t.shape
        bot_cells = raster_to_cells(codes_b, int(math.isqrt(Ttop)),
                                    self.cell_win)
        positions = torch.arange(Ttop, device=codes_t.device).expand(B, Ttop)
        h = self.embed_cells(codes_t, bot_cells, positions)
        h = torch.cat([self.sos_tokens(B, labels), h[:, :-1]], dim=1)
        return self.ln_f(self.run_blocks(h, M.causal(h.shape[1], h.device)))

    def forward_depth(self, h, codes_t, codes_b):
        """The depth transformer over every position at once, by the depth
        mode: `parallel` [sos + h, Top + Pos_0..r-1] under the parallel
        mask; `bidirectional` [sos + h, Pos_0..r-1], unmasked; `top2bot`
        [sos + h, Top + Pos_0, Bot_j + Pos_j+1 (j < r - 1)], causal."""
        B, Ttop = codes_t.shape
        h_top = int(math.isqrt(Ttop))
        r = self.ratio_bot2top
        hs = h.reshape(B * Ttop, 1, -1) + self.sos_depth.to(self.dtype)
        emb_top = self._emb(self.tok_emb_top_depth, codes_t).reshape(
            B * Ttop, 1, -1)
        pos = self.pos_emb_depth.weight[:r].to(self.dtype)[None]
        if self.depth_mode == 'parallel':
            x = torch.cat([hs, emb_top + pos], dim=1)
            mask = M.parallel_2level(1 + r, self.num_bottom_pred, h.device)
        elif self.depth_mode == 'bidirectional':
            x = torch.cat([hs, pos.expand(B * Ttop, -1, -1)], dim=1)
            mask = None
        else:
            cells = raster_to_cells(codes_b, h_top, self.cell_win)
            emb_bot = self._emb(self.tok_emb_bot_depth,
                                cells[:, :, :r - 1]).reshape(B * Ttop, r - 1,
                                                             -1)
            x = torch.cat([hs, emb_top + pos[:, :1], emb_bot + pos[:, 1:]],
                          dim=1)
            mask = M.causal(1 + r, h.device)
        for blk in self.depths:
            x = blk(x, mask)
        logits_top = self.head_top(self.ln_top(x[:, 0])).reshape(B, Ttop, -1)
        logits_bot = self.head_bot(self.ln_bot(x[:, 1:]))
        w = self.cell_win
        logits_bot = logits_bot.reshape(B, h_top, h_top, w, w, -1).permute(
            0, 1, 3, 2, 4, 5).reshape(B, Ttop * r, -1)
        return logits_top, logits_bot

    # --------------------------------------------------------- decode steps
    @property
    def depth_int8(self) -> bool:
        """`depth_gemms` quantizes the depth chain in the `parallel` mode
        only: JAX enters its int8 scope around the parallel depth-second
        chain alone, and runs the `bidirectional` pass and the `top2bot`
        chain (head_bot included) in float."""
        return self.depth_mode == 'parallel'

    def int8_heads(self) -> List[Tuple[str, nn.Module]]:
        """The heads that run A8W8 under `depth_gemms`: head_bot (the
        depth-second chain's; head_top stays float, as in JAX)."""
        return [('head_bot', self.head_bot)]

    def int8_embedding(self) -> List[Tuple[str, nn.Module]]:
        """None: the JAX sampler embeds the 2-level cell outside its
        spatial int8 scope, so the `emb_blocks` stay float."""
        return []

    def embed_cell_step(self, code_t: torch.Tensor, bot_cell: torch.Tensor,
                        position: torch.Tensor,
                        int8: bool = False) -> torch.Tensor:
        """Embed one generated cell for the next spatial step. code_t: [B],
        bot_cell: [B, ratio], position: [B] -> [B, 1, D]; with random
        order, plus `pred_emb_top(position + 1)`. Float whatever `int8`
        (see `int8_embedding`)."""
        x = self.embed_cells(code_t[:, None], bot_cell[:, None, :],
                             position[:, None])
        if self.hparams.use_random_order:
            x = x + self._emb(self.pred_emb_top, position[:, None] + 1)
        return x

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
            k, v = a.fused_kv(xn).split(a.width, dim=-1)
            k = split_heads(k, a.n_heads)
            v = split_heads(v, a.n_heads)
            x = x + a.proj(merge_heads(v))
            x = x + blk.mlp_forward(blk.ln2(x))
            ks.append(k)
            vs.append(v)
        return self.head_top(self.ln_top(x[:, 0])), (ks, vs)

    def depth_second_logits(self, codes: torch.Tensor, depth_kv: DepthKV,
                            group: int = 1, int8: bool = False
                            ) -> Tuple[torch.Tensor, DepthKV]:
        """Depth step `group`: logits [B, n, Vb] of the next group of n
        bottom codes, given the previous step's codes [B, 1] or [B, n]
        (embedded with tok_emb_top_depth) and the cached depth (k, v).
        Full attention over [cached; new] keys, with the JAX package's
        roundings (`tiny_attention`). With `int8` every gemm, head_bot
        included, runs A8W8."""
        ks, vs = depth_kv
        n = self.num_bottom_pred
        pos = self.pos_emb_depth.weight[n * (group - 1):n * group]
        x = self._emb(self.tok_emb_top_depth, codes) + pos.to(self.dtype)
        new_ks, new_vs = [], []
        for i, blk in enumerate(self.depths):
            a = blk.attn
            q, k_new, v_new = a.fused_qkv(blk.ln1(x), int8).split(a.width,
                                                                  dim=-1)
            k = torch.cat([merge_heads(ks[i]), k_new], dim=1)
            v = torch.cat([merge_heads(vs[i]), v_new], dim=1)
            x = x + a.proj(tiny_attention(q, k, v, a.n_heads), int8)
            x = x + blk.mlp_forward(blk.ln2(x), int8)
            new_ks.append(split_heads(k, a.n_heads))
            new_vs.append(split_heads(v, a.n_heads))
        return self.head_bot(self.ln_bot(x), int8), (new_ks, new_vs)

    def depth_bidirectional(self, h: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bidirectional depth pass: [sos_depth + h, Pos_0..r-1] (h
        [B, D]) through the depth blocks unmasked. Returns (logits_top
        [B, 1, Vt], logits_bot [B, r, Vb])."""
        x0 = h[:, None, :] + self.sos_depth.to(self.dtype)
        pos = self.pos_emb_depth.weight[:self.ratio_bot2top].to(self.dtype)
        x = torch.cat([x0, pos.expand(x0.shape[0], -1, -1)], dim=1)
        for blk in self.depths:
            x = blk(x)
        return (self.head_top(self.ln_top(x[:, :1])),
                self.head_bot(self.ln_bot(x[:, 1:])))

    def depth_caches(self, batch: int, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed per-head K and V caches of the causal depth chain,
        [Ld, B, nh, len_seq_depth, hd] in the activation dtype (nh the
        rank's heads under tensor parallelism)."""
        hpd = self.hpd
        shape = (hpd.n_layers, batch, self.depths[0].attn.n_heads,
                 self.len_seq_depth, hpd.embed_dim // hpd.n_heads)
        kc = torch.zeros(shape, dtype=self.dtype, device=device)
        return kc, torch.zeros_like(kc)

    def depth_causal_step(self, x: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: int
                          ) -> torch.Tensor:
        """One token x [B, 1, Dd] of the causal (`top2bot`) depth chain at
        row `cache_len` of the per-head caches [Ld, B, nh, len_seq_depth,
        hd] (`depth_caches`, updated in place), attending over rows
        0..cache_len. Returns the depth stack's output [B, 1, Dd]."""
        for i, blk in enumerate(self.depths):
            x = blk.step_heads(x, k_cache[i], v_cache[i], cache_len)
        return x
