"""HQ-Transformer for three code levels ('multilevel-hq'): a spatial GPT
over cells that fuse one top code with its 4 mid and 16 bottom codes, and a
depth transformer that decodes a cell's 21 codes in three phases (1 top,
then 4 mids, then 16 bottoms), or fully causally ('top2mid2bot').

Counterpart of `hqtransformer_tpu/models/stage2/multilevel.py::
MultiLevelHQTransformer` for the decoding types 'parallel', 'parallel-add'
and 'top2mid2bot', with class, text or no conditioning (`Conditioning`,
shared with the 2-level model; the teacher-forced forward returns the text
logits fourth), 1-d or 2-d spatial positions, and the `transformerN` cell
embedding: N - 1 unmasked `emb_blocks` over a cell's 21 token embeddings
plus `pos_emb_emb`, then their mean. `use_random_order` is accepted and
ignored, as the JAX module ignores it (it creates no `pred_emb_top`). The
constructor raises `NotImplementedError` for the rest:
- the `reduce` embedding, which the JAX module cannot run: its
  `embed_cells` concatenates level embeddings of widths D, D/4 and D/16
  along the cell axis (a `TypeError`) and reads a `pos_emb_emb` that
  `reduce` never creates;
- 'tree', whose JAX module reads its 4-row `pos_emb_depths_1` at 16
  positions, which `jnp.take` fills with NaN, so its forward and its
  bottom phase give NaN logits there;
- the 'reduce' depth inputs and other than 3 levels.
'top2mid2bot-add' raises `ValueError`, as the JAX forward does.

'top2mid2bot' has the teacher-forced forward (`forward_causal`) and no
serving path: the JAX package has no sampler for it (its depth phases take
the level-3 mask, which has no 'top2mid2bot' form, and read
`pos_emb_depths_1`, which that type lacks), so `serving`, the depth phases
and the sampler refuse it with a `ValueError`.

Parameter names follow the JAX module (`tok_emb_levels.<i>`,
`tok_emb_depth_levels.<i>`, `pos_emb_depths.<i>`, `ln_levels.<i>`,
`head_levels.<i>`), so `convert.convert_variables` loads it with
`strict=True`.

Depth-sequence order: [sos + h, 4 top inputs, 16 mid inputs]; the bottoms
are in the reference's pyramid order (h1, h2, w1, w2), which is the local
raster order of a 4x4 cell. Mids and bottoms of a cell are in local raster
order everywhere (`level_cells`), but for the mid inputs of
`forward_causal` (the reference's layout quirk, see there).

The serving path: `spatial_prefill` / `spatial_step` run the spatial blocks
on the packed [L, T, B, D] caches through decode attention (K1), and
`depth_phase_cached` runs each phase's new tokens against the cached K/V of
the earlier phases with `tiny_attention` under `masks.level3_decode`. The
recompute path `depth_phase` is the JAX module's reference behaviour; the
tests hold the two equal.

int8max serving: `serving(int8, scales)` (shared with the 2-level model)
quantizes the spatial blocks' gemms and the `emb_blocks`' under
`spatial_gemms` (the JAX sampler embeds each cell inside its spatial int8
scope; `embed_cell_step(..., int8=True)` runs them A8W8), and every depth
block's gemms and `head_levels.<i>` under `depth_gemms`. The JAX sampler
wraps all three depth phases in `int8_stage2_scope`, so with
`depth_phase_cached(..., int8=True)` every phase runs A8W8 but for phase
0's K/V, which JAX computes with a float `jnp.dot` on the concatenated
key and value kernels (not a `QuantizableDense`); `tiny_attention` holds no
gemm and stays in the activation dtype. `head_txt` stays float.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ...config import Stage2Hparams, parse_embedding_type
from ...ops import masks as M
from ...ops.int8 import Int8Serving
from .hierarchical import (Conditioning, SpatialDecoding, cells_to_raster,
                           raster_to_cells)
from .layers import Block, LayerNorm, QuantizableLinear, tiny_attention

DepthKV = Tuple[List[torch.Tensor], List[torch.Tensor]]

CODE_LEVELS = 3
CODE_LEN = M.LEVEL3_LEN          # 1 top + 4 mid + 16 bottom codes a cell
DECODING_TYPES = ('parallel', 'parallel-add', 'top2mid2bot')
NO_PHASES = ("'top2mid2bot' decodes its 21 depth tokens fully causally and "
             "has no phase decode, sampler or serving path, nor has it in "
             "the JAX package (its depth phases take the level-3 mask, which "
             "has no 'top2mid2bot' form, and read pos_emb_depths_1, which "
             "this type lacks); only its teacher-forced forward is ported")


# The JAX module's names for the cell layout: raster [B, (H win W win)] <->
# per-top-cell groups [B, H*W, win*win] in local raster order.
level_cells = raster_to_cells
cells_to_level = cells_to_raster


def _logits_to_raster(x: torch.Tensor, B: int, h_top: int,
                      win: int) -> torch.Tensor:
    """Per-cell logits [(B H W), win*win, K] -> raster [B, (H win W win),
    K]."""
    K = x.shape[-1]
    x = x.reshape(B, h_top, h_top, win, win, K).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, h_top * win * h_top * win, K)


def _mid_positions(pos: torch.Tensor) -> torch.Tensor:
    """pos_emb_depths_1's 16 rows, in (h1 h2 w1 w2) order -> [4 (h1 w1),
    4 (h2 w2), D]: the position of each of a mid's four bottoms."""
    D = pos.shape[-1]
    return pos.reshape(2, 2, 2, 2, D).permute(0, 2, 1, 3, 4).reshape(4, 4, D)


def _pyramid(x: torch.Tensor) -> torch.Tensor:
    """[N, 4 (h1 w1), 4 (h2 w2), D] -> [N, 16 (h1 h2 w1 w2), D]."""
    N, D = x.shape[0], x.shape[-1]
    return x.reshape(N, 2, 2, 2, 2, D).permute(0, 1, 3, 2, 4, 5).reshape(
        N, 16, D)


class MultiLevelHQTransformer(Conditioning, SpatialDecoding, nn.Module):
    """Three-level hierarchical AR transformer."""

    def __init__(self, vocab_sizes: Sequence[int], decoding_type: str,
                 use_cls_cond: bool, hparams: Stage2Hparams,
                 hparams_dec: Optional[Stage2Hparams] = None,
                 use_txt_cond: bool = False,
                 dtype: torch.dtype = torch.float32,
                 vocab_size_txt: int = 16384):
        super().__init__()
        emb = parse_embedding_type(hparams.embedding_type)
        if len(vocab_sizes) != CODE_LEVELS:
            raise NotImplementedError(
                f'{len(vocab_sizes)} code levels: only 3 are ported')
        if decoding_type == 'top2mid2bot-add':
            raise ValueError("decoding_type 'top2mid2bot' does not support "
                             "'-add' (broken in the reference as well)")
        if decoding_type not in DECODING_TYPES:
            raise NotImplementedError(
                f'decoding type {decoding_type!r} is not ported')
        if emb.kind == 'reduce':
            raise NotImplementedError(
                "the 3-level 'reduce' embedding: the JAX module cannot run "
                "it (its embed_cells concatenates widths D, D/4 and D/16)")
        if emb.kind != 'transformer':
            raise ValueError(hparams.embedding_type)
        self.hparams = hparams
        self.hpd = hparams_dec or Stage2Hparams(
            **{**hparams.__dict__, 'n_layers': 4})
        self.decoding_type = decoding_type
        self.parallel_type = decoding_type.split('-')[0]
        self.is_causal_depth = decoding_type == 'top2mid2bot'
        self.dtype = dtype
        hp, hpd = hparams, self.hpd
        D, Dd = hp.embed_dim, hpd.embed_dim

        def blocks(h, n):
            return nn.ModuleList(
                Block(h.embed_dim, h.n_heads, h.mlp_bias, h.attn_bias,
                      h.gelu_use_approx) for _ in range(n))

        self.tok_emb_levels = nn.ModuleList(
            nn.Embedding(v, D) for v in vocab_sizes)
        self.pos_emb_emb = nn.Embedding(CODE_LEN, D)
        self.emb_blocks = blocks(hp, emb.n_layers_emb)
        self._build_conditioning(use_cls_cond, use_txt_cond, vocab_size_txt)
        self.blocks = blocks(hp, hp.n_layers)
        self.ln_f = LayerNorm(D)

        self.sos_depth = nn.Parameter(torch.zeros(1, 1, Dd))
        self.tok_emb_depth_levels = nn.ModuleList(
            nn.Embedding(v, D) for v in vocab_sizes)
        self.pos_emb_depths = nn.ModuleList(
            [nn.Embedding(CODE_LEN, Dd)] if self.is_causal_depth else
            [nn.Embedding(4, Dd), nn.Embedding(16, Dd)])
        self.depths = blocks(hpd, hpd.n_layers)
        self.ln_levels = nn.ModuleList(LayerNorm(Dd)
                                       for _ in range(CODE_LEVELS))
        self.head_levels = nn.ModuleList(
            QuantizableLinear(Dd, v, bias=False) for v in vocab_sizes)

    # ------------------------------------------------------------ embedding
    def _rows(self, table: nn.Embedding, n: int) -> torch.Tensor:
        return table.weight[:n].to(self.dtype)

    def embed_cells(self, cells: Sequence[torch.Tensor],
                    positions: torch.Tensor,
                    int8: bool = False) -> torch.Tensor:
        """Fuse each cell's top code [B, L, 1], mids [B, L, 4] and bottoms
        [B, L, 16] (local raster) into one spatial token: [top + pos, mids,
        bottoms] plus pos_emb_emb, through the `emb_blocks` (A8W8 with
        `int8`), then their mean. positions: [B, L] -> [B, L, D]."""
        B, L = cells[0].shape[:2]
        e0 = self._emb(self.tok_emb_levels[0], cells[0].reshape(B, L)) + \
            self.spatial_pos_emb(positions)
        hs = [e0[:, :, None, :]] + [self._emb(self.tok_emb_levels[li], c)
                                    for li, c in enumerate(cells) if li]
        h = torch.cat(hs, dim=2) + self._rows(self.pos_emb_emb, CODE_LEN)
        if len(self.emb_blocks):
            x = h.reshape(B * L, CODE_LEN, -1)
            for blk in self.emb_blocks:
                x = blk(x, None, int8)
            h = x.reshape(B, L, CODE_LEN, -1)
        return h.mean(dim=2)

    # -------------------------------------------------------------- forward
    def forward(self, codes: Sequence[torch.Tensor],
                labels: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """Teacher-forced forward. codes: raster maps top [B, L], mid
        [B, 4L], bottom [B, 16L]; labels as `Conditioning` says. Returns
        per-level logits [B, L, V0], [B, 4L, V1], [B, 16L, V2] in raster
        order, and with text conditioning the text logits
        [B, ctx_len_txt - 1, V_txt] fourth."""
        h_top = math.isqrt(codes[0].shape[1])
        cells = [codes[0][:, :, None]] + [
            level_cells(c, h_top, 2 ** li) for li, c in enumerate(codes)
            if li]
        h, logits_txt = self.split_text(self.forward_embeddings(cells,
                                                                labels))
        if self.is_causal_depth:
            logits = self.forward_causal(h, codes, h_top)
        else:
            logits = self.forward_hierarchy(h, cells, h_top)
        return logits if logits_txt is None else logits + [logits_txt]

    def forward_embeddings(self, cells, labels):
        B, L = cells[0].shape[:2]
        positions = torch.arange(L, device=cells[0].device).expand(B, L)
        h = self.embed_cells(cells, positions)
        h = torch.cat([self.sos_tokens(B, labels), h[:, :-1]], dim=1)
        return self.ln_f(self.run_blocks(h, M.causal(h.shape[1], h.device)))

    def forward_hierarchy(self, h, cells, h_top):
        B, L = cells[0].shape[:2]
        x = torch.cat([
            self._phase_inputs(h.reshape(B * L, -1), None, None, 0),
            self._phase_inputs(None, cells[0].reshape(B * L), None, 1),
            self._phase_inputs(None, cells[0].reshape(B * L),
                               cells[1].reshape(B * L, 4), 2)], dim=1)
        return self._depth_logits(x, M.level3(self.parallel_type, x.device),
                                  B, h_top)

    def forward_causal(self, h, codes, h_top):
        """'top2mid2bot': the 21 depth tokens [sos + h, top, 4 mids,
        15 bottoms] under a causal mask, one `pos_emb_depths.0` row each
        after the first. The reference's layout quirk, reproduced: cell
        (h, w) takes its mid inputs from the mid raster factorised as
        (H h1 h2 W), that is rows 2h and 2h + 1 at columns w and w + H, in
        (h1, h2) order, not from its raster children; its mid logits map to
        the true children, as the bottoms do."""
        B, L = codes[0].shape
        N = B * L
        e0, e1, e2 = (self._emb(self.tok_emb_depth_levels[li], c)
                      for li, c in enumerate((
                          codes[0], codes[1], level_cells(codes[2], h_top,
                                                          4))))
        D = e0.shape[-1]
        # B (H h1 h2 W) D -> (B H W) (h1 h2) D
        e1 = e1.reshape(B, h_top, 4, h_top, D).transpose(2, 3)
        e0, e1, e2 = (e.reshape(N, -1, D) for e in (e0, e1, e2))
        x = torch.cat([h.reshape(N, 1, -1), e0, e1, e2[:, :-1]], dim=1)
        x = x + torch.cat([self.sos_depth.to(self.dtype),
                           self._rows(self.pos_emb_depths[0],
                                      CODE_LEN - 1)[None]], dim=1)
        return self._depth_logits(x, M.causal(CODE_LEN, x.device), B, h_top)

    def _depth_logits(self, x, mask, B, h_top):
        """The depth blocks over the 21-token inputs x [(B L), 21, D] under
        `mask`, and each level's logits in raster order."""
        for blk in self.depths:
            x = blk(x, mask)
        return [self._phase_head(x[:, 0], 0).reshape(B, h_top * h_top, -1),
                _logits_to_raster(self._phase_head(x[:, 1:5], 1), B, h_top,
                                  2),
                _logits_to_raster(self._phase_head(x[:, 5:], 2), B, h_top,
                                  4)]

    # --------------------------------------------------------- decode steps
    def serving(self, int8: Int8Serving = Int8Serving(),
                scales: Optional[Mapping[str, Mapping[str, torch.Tensor]]]
                = None):
        """`SpatialDecoding.serving`; refused for 'top2mid2bot'."""
        if self.is_causal_depth:
            raise ValueError(NO_PHASES)
        return super().serving(int8, scales)

    def int8_heads(self) -> List[Tuple[str, nn.Module]]:
        """The heads that run A8W8 under `depth_gemms`: every level's."""
        return [(f'head_levels.{i}', head)
                for i, head in enumerate(self.head_levels)]

    def int8_embedding(self) -> List[Tuple[str, nn.Module]]:
        """The gemms that run A8W8 with the spatial ones: every
        `emb_blocks` projection (the JAX sampler embeds each cell inside
        its spatial int8 scope)."""
        return [(f'emb_blocks.{i}.{name}', lin)
                for i, blk in enumerate(self.emb_blocks)
                for name, lin in (('attn.query', blk.attn.query),
                                  ('attn.key', blk.attn.key),
                                  ('attn.value', blk.attn.value),
                                  ('attn.proj', blk.attn.proj),
                                  ('mlp.0', blk.mlp[0]),
                                  ('mlp.2', blk.mlp[2]))]

    def embed_cell_step(self, top: torch.Tensor, mid: torch.Tensor,
                        bot: torch.Tensor, position: torch.Tensor,
                        int8: bool = False) -> torch.Tensor:
        """Embed one generated cell for the next spatial step: top [B], mid
        [B, 4], bot [B, 16] (local raster), position [B] -> [B, 1, D]; the
        `emb_blocks` A8W8 with `int8` (in an int8 serving call)."""
        return self.embed_cells([top[:, None, None], mid[:, None, :],
                                 bot[:, None, :]], position[:, None], int8)

    def _phase_inputs(self, h: Optional[torch.Tensor],
                      top: Optional[torch.Tensor],
                      mid_local: Optional[torch.Tensor],
                      phase: int) -> torch.Tensor:
        """The depth tokens entering at `phase`: 0 -> [B, 1, D] (sos + h,
        h [B, D]); 1 -> [B, 4, D] (the top code's embedding at 4
        positions, top [B]); 2 -> [B, 16, D] (each mid's embedding at its
        four bottoms' positions, plus the top's under 'parallel-add';
        mid_local [B, 4])."""
        if self.is_causal_depth:
            raise ValueError(NO_PHASES)
        if phase == 0:
            return h[:, None, :] + self.sos_depth.to(self.dtype)
        e_top = self._emb(self.tok_emb_depth_levels[0], top)[:, None, :]
        if phase == 1:
            return e_top + self._rows(self.pos_emb_depths[0], 4)[None]
        e1 = self._emb(self.tok_emb_depth_levels[1], mid_local)  # [B, 4, D]
        pos1 = _mid_positions(self._rows(self.pos_emb_depths[1], 16))
        e1 = _pyramid(e1[:, :, None, :] + pos1[None])
        if self.decoding_type.endswith('-add'):
            e1 = e1 + e_top
        return e1

    def _phase_head(self, x: torch.Tensor, phase: int,
                    int8: bool = False) -> torch.Tensor:
        """The level head of `phase` over its new tokens' outputs."""
        return self.head_levels[phase](self.ln_levels[phase](x), int8)

    def depth_phase(self, h: torch.Tensor, top: Optional[torch.Tensor],
                    mid_local: Optional[torch.Tensor],
                    phase: int) -> torch.Tensor:
        """Depth phase by recomputing its whole prefix (1, 5 or 21 tokens)
        under the level-3 mask: the logits of the top [B, V0], the mids
        [B, 4, V1] or the bottoms [B, 16, V2] (local raster). h: [B, D];
        top: [B]; mid_local: [B, 4]."""
        xs = [self._phase_inputs(h, None, None, 0)]
        if phase >= 1:
            xs.append(self._phase_inputs(None, top, None, 1))
        if phase == 2:
            xs.append(self._phase_inputs(None, top, mid_local, 2))
        x = torch.cat(xs, dim=1)
        T = x.shape[1]
        mask = M.level3(self.parallel_type, x.device)[:T, :T]
        for blk in self.depths:
            x = blk(x, mask)
        return self._phase_head(x[:, 0] if phase == 0 else
                                x[:, (1, 5)[phase - 1]:], phase)

    def depth_phase_cached(self, h: Optional[torch.Tensor],
                           top: Optional[torch.Tensor],
                           mid_local: Optional[torch.Tensor],
                           depth_kv: Optional[DepthKV],
                           phase: int, int8: bool = False
                           ) -> Tuple[torch.Tensor, DepthKV]:
        """Depth phase on the serving path: only the tokens entering at
        `phase`, against the flat [B, t, D] K/V that the earlier phases
        cached. Returns (this level's logits, the K/V extended by this
        phase's tokens). A phase-p token sees the same columns of the
        level-3 mask here as in `depth_phase`, so the two agree. With
        `int8` (inside an int8 serving call) the phase's gemms and its
        level's head run A8W8, but for phase 0's K/V (the module
        docstring says why).

        Phase 0 is one token: the softmax over its one key is 1, so the
        attention output is its v, and q is never computed."""
        if phase == 0:
            x = self._phase_inputs(h, None, None, 0)
            ks, vs = [], []
            for blk in self.depths:
                k, v = blk.attn.fused_kv(blk.ln1(x)).split(blk.attn.width,
                                                           dim=-1)
                x = x + blk.attn.proj(v, int8)
                x = x + blk.mlp_forward(blk.ln2(x), int8)
                ks.append(k)
                vs.append(v)
            return self._phase_head(x[:, 0], 0, int8), (ks, vs)

        x = self._phase_inputs(None, top, mid_local, phase)
        t_past, t_new = (1, 5)[phase - 1], x.shape[1]
        mask = M.level3_decode(self.parallel_type, t_past, t_new, x.device)
        ks, vs = depth_kv
        new_ks, new_vs = [], []
        for i, blk in enumerate(self.depths):
            a = blk.attn
            q, k_new, v_new = a.fused_qkv(blk.ln1(x), int8).split(
                a.width, dim=-1)
            k = torch.cat([ks[i], k_new], dim=1)
            v = torch.cat([vs[i], v_new], dim=1)
            x = x + a.proj(tiny_attention(q, k, v, a.n_heads, mask), int8)
            x = x + blk.mlp_forward(blk.ln2(x), int8)
            new_ks.append(k)
            new_vs.append(v)
        return self._phase_head(x, phase, int8), (new_ks, new_vs)
