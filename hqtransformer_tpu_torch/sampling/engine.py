"""Sampling engine for the two-level HQ-Transformer, parallel depth mode.

Counterpart of `hqtransformer_tpu/sampling/engine.py::
make_hierarchical_sampler` on its packed-cache path. Where the JAX package
compiles the whole loop into one `lax.scan`, the port runs it eagerly: one
spatial step per position (12 launches of the decode attention kernel at
the flagship depth), then the depth draws (2 launches of the sampling
kernel).

Loop order, as in the JAX sampler: prefill the conditioning prefix at cache
row 0; then for each spatial step i in 1..N-1 embed the previous cell at
position i-1, run the spatial step at cache row sos_len + i - 1, and draw the
top code and its bottom group.

Random numbers: every draw takes one uniform per row from the caller's
`torch.Generator`, the top codes' first and then the bottom group's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from ..models.stage2.hierarchical import HierarchicalGPT
from ..ops.topk_topp import sample_from_logits


@dataclass(frozen=True)
class SamplingParams:
    """Per-level filtering knobs."""
    top_k_top: Optional[int] = None
    top_p_top: Optional[float] = None
    top_k_bot: Optional[int] = None
    top_p_bot: Optional[float] = None
    temperature_top: float = 1.0
    temperature_bot: float = 1.0


def _depth_sample_parallel(model: HierarchicalGPT, h: torch.Tensor,
                           generator: torch.Generator, sp: SamplingParams
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth decode, parallel mode: step 0 draws the top code, steps
    1..len_seq_depth-1 draw groups of num_bottom_pred bottom codes at once.
    h: [B, D]. Returns (top [B], bottom [B, ratio])."""
    logits_top, kv = model.depth_first_logits(h)
    top = sample_from_logits(generator, logits_top,
                             temperature=sp.temperature_top,
                             top_k=sp.top_k_top, top_p=sp.top_p_top)
    bots = []
    prev_codes = top[:, None]
    for g in range(1, model.ratio_bot2top // model.num_bottom_pred + 1):
        logits_bot, kv = model.depth_second_logits(prev_codes, kv, g)
        group = sample_from_logits(generator, logits_bot,
                                   temperature=sp.temperature_bot,
                                   top_k=sp.top_k_bot, top_p=sp.top_p_bot)
        bots.append(group)
        prev_codes = group  # reference quirk: embedded as top codes
    return top, torch.cat(bots, dim=1)


def make_hierarchical_sampler(model: HierarchicalGPT, max_seq_len: int = 64,
                              params: SamplingParams = SamplingParams()
                              ) -> Callable:
    """Build the sampler for the 2-level model. Returns
    fn(generator, labels [B]) -> (codes_t [B, N], codes_b [B, N, ratio]),
    int32, with N = max_seq_len spatial positions.

    The packed [L, T, B, D] KV cache (T = sos_len + N - 1), in the
    activation dtype, is allocated once per call. The JAX sampler's
    `n_segments` and `t_compute` are not needed: they bound the
    static-shape compute of the TPU kernel, while the CUDA kernel's loop
    already stops at the current position."""
    hp = model.hparams
    sos_len = 1

    @torch.inference_mode()
    def sample(generator: torch.Generator, labels: torch.Tensor):
        B = labels.shape[0]
        sos = model.sos_tokens(B, labels)
        shape = (hp.n_layers, sos_len + max_seq_len - 1, B, hp.embed_dim)
        kc = torch.zeros(shape, dtype=sos.dtype, device=sos.device)
        vc = torch.zeros_like(kc)
        h = model.spatial_prefill(sos, kc, vc)
        top, bot = _depth_sample_parallel(model, h[:, -1], generator, params)
        tops, bots = [top], [bot]
        for i in range(1, max_seq_len):
            position = torch.full((B,), i - 1, dtype=torch.long,
                                  device=sos.device)
            x = model.embed_cell_step(top, bot, position)
            h = model.spatial_step(x, kc, vc, sos_len + i - 1)
            top, bot = _depth_sample_parallel(model, h[:, -1], generator,
                                              params)
            tops.append(top)
            bots.append(bot)
        return torch.stack(tops, dim=1), torch.stack(bots, dim=1)

    return sample
