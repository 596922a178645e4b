"""Sampling engine for the two-level HQ-Transformer, parallel depth mode.

Counterpart of `hqtransformer_tpu/sampling/engine.py::
make_hierarchical_sampler` and `make_hierarchical_scorer` on their
packed-cache path. Where the JAX package
compiles the whole loop into one `lax.scan`, the port runs it eagerly: one
spatial step per position (12 launches of the decode attention kernel at
the flagship depth), then the depth draws (2 launches of the sampling
kernel).

Loop order, as in the JAX sampler: prefill the conditioning prefix at cache
row 0; then for each spatial step i in 1..N-1 embed the previous cell at
position i-1, run the spatial step at cache row sos_len + i - 1, and draw the
top code and its bottom group. The sampler and the scorer share this loop
(`_serving_loop`) and the depth chain (`_depth_chain`); they differ only in
where each step's codes come from (drawn or given).

Random numbers: every draw takes one uniform per row from the caller's
`torch.Generator`, the top codes' first and then the bottom group's.

int8 serving: `int8` (an `Int8Serving`) and `scales` (the calibrated
collections, see `models/twostage.py`) choose the int8 KV cache and the
A8W8 gemms of the spatial steps and of the depth-second chain, as the JAX
sampler's cache_dtype and HQT_INT8_* switches do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Mapping, Optional, Tuple

import torch

from ..models.stage2.hierarchical import HierarchicalGPT
from ..ops.int8 import Int8Serving
from ..ops.topk_topp import sample_from_logits

Scales = Mapping[str, Mapping[str, torch.Tensor]]


@dataclass(frozen=True)
class SamplingParams:
    """Per-level filtering knobs."""
    top_k_top: Optional[int] = None
    top_p_top: Optional[float] = None
    top_k_bot: Optional[int] = None
    top_p_bot: Optional[float] = None
    temperature_top: float = 1.0
    temperature_bot: float = 1.0


def _depth_chain(model: HierarchicalGPT, h: torch.Tensor,
                 pick: Callable[[int, torch.Tensor], torch.Tensor],
                 int8: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Depth decode, parallel mode: step 0 gives the top code's logits,
    steps 1..len_seq_depth-1 those of groups of num_bottom_pred bottom
    codes at once. `pick(step, logits)` returns the step's codes: drawn by
    the sampler, given by the scorer. h: [B, D]. Returns (top [B], bottom
    [B, ratio], the logits of every step)."""
    logits_top, kv = model.depth_first_logits(h)
    top = pick(0, logits_top)
    bots, logits = [], [logits_top]
    prev_codes = top[:, None]
    for g in range(1, model.ratio_bot2top // model.num_bottom_pred + 1):
        logits_bot, kv = model.depth_second_logits(prev_codes, kv, g, int8)
        prev_codes = pick(g, logits_bot)  # reference quirk: embedded as top
        bots.append(prev_codes)
        logits.append(logits_bot)
    return top, torch.cat(bots, dim=1), logits


def _draws(generator: torch.Generator, sp: SamplingParams) -> Callable:
    """The sampler's `pick`: one draw per depth step from `generator`."""
    def pick(step: int, logits: torch.Tensor) -> torch.Tensor:
        if step == 0:
            return sample_from_logits(generator, logits,
                                      temperature=sp.temperature_top,
                                      top_k=sp.top_k_top, top_p=sp.top_p_top)
        return sample_from_logits(generator, logits,
                                  temperature=sp.temperature_bot,
                                  top_k=sp.top_k_bot, top_p=sp.top_p_bot)
    return pick


def _caches(model: HierarchicalGPT, sos: torch.Tensor, max_seq_len: int,
            int8: Int8Serving) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed [L, T, B, D] caches (T = sos_len + N - 1), int8 or in
    the activation dtype."""
    hp = model.hparams
    shape = (hp.n_layers, sos.shape[1] + max_seq_len - 1, sos.shape[0],
             hp.embed_dim)
    dtype = torch.int8 if int8.kv_cache else sos.dtype
    kc = torch.zeros(shape, dtype=dtype, device=sos.device)
    return kc, torch.zeros_like(kc)


def _serving_loop(model: HierarchicalGPT, labels: torch.Tensor,
                  max_seq_len: int, int8: Int8Serving,
                  scales: Optional[Scales], depth: Callable
                  ) -> Tuple[list, Tuple[torch.Tensor, torch.Tensor]]:
    """The AR loop of the sampler and the scorer, in one serving call:
    prefill the conditioning prefix, then for each spatial position i run
    `depth(i, h [B, D]) -> (top [B], bot [B, ratio], out)`, which gives the
    position's codes, and embed them for the next spatial step. Returns
    ([out of every position], (k_caches, v_caches))."""
    sos_len = 1
    B = labels.shape[0]
    with model.serving(int8, scales):
        sos = model.sos_tokens(B, labels)
        kc, vc = _caches(model, sos, max_seq_len, int8)
        h = model.spatial_prefill(sos, kc, vc, int8.spatial_gemms)
        outs = []
        for i in range(max_seq_len):
            if i:
                position = torch.full((B,), i - 1, dtype=torch.long,
                                      device=sos.device)
                x = model.embed_cell_step(top, bot, position)
                h = model.spatial_step(x, kc, vc, sos_len + i - 1,
                                       int8.spatial_gemms)
            top, bot, out = depth(i, h[:, -1])
            outs.append(out)
    return outs, (kc, vc)


def make_hierarchical_sampler(model: HierarchicalGPT, max_seq_len: int = 64,
                              params: SamplingParams = SamplingParams(),
                              int8: Int8Serving = Int8Serving(),
                              scales: Optional[Scales] = None,
                              return_caches: bool = False) -> Callable:
    """Build the sampler for the 2-level model. Returns
    fn(generator, labels [B]) -> (codes_t [B, N], codes_b [B, N, ratio]),
    int32, with N = max_seq_len spatial positions; with `return_caches`,
    ((codes_t, codes_b), (k_caches, v_caches)), the calibration hook of
    `TwoStageModel.calibrate_kv_scales`.

    The packed [L, T, B, D] KV cache (T = sos_len + N - 1), int8 with
    `int8.kv_cache` and else in the activation dtype, is allocated once
    per call, and the weights' concatenations and quantizations are done
    once per call (`HierarchicalGPT.serving`). The JAX sampler's
    `n_segments` and `t_compute` are not needed: they bound the
    static-shape compute of the TPU kernel, while the CUDA kernel's loop
    already stops at the current position."""

    @torch.inference_mode()
    def sample(generator: torch.Generator, labels: torch.Tensor):
        pick = _draws(generator, params)

        def depth(i, h):
            top, bot, _ = _depth_chain(model, h, pick, int8.depth_gemms)
            return top, bot, (top, bot)

        outs, caches = _serving_loop(model, labels, max_seq_len, int8,
                                     scales, depth)
        tops, bots = zip(*outs)
        codes = torch.stack(tops, dim=1), torch.stack(bots, dim=1)
        return (codes, caches) if return_caches else codes

    return sample


def make_hierarchical_scorer(model: HierarchicalGPT, max_seq_len: int = 64,
                             int8: Int8Serving = Int8Serving(),
                             scales: Optional[Scales] = None) -> Callable:
    """Teacher-forced per-step logits through the serving decode path.
    Returns fn(labels [B], codes_t [B, N], codes_b_cells [B, N, ratio]) ->
    (logits_top [B, N, Vt], logits_bot [B, N, ratio, Vb]).

    The sampler's loop (prefill, the packed-cache spatial steps, the
    depth-first and depth-second chain, and with `int8` the int8 KV cache
    and A8W8 gemms), with the given codes in place of draws: the logits of
    two serving modes on the same codes measure what the serving path's
    numerics do (per-step agreement and KL), as the JAX scorer does."""
    n = model.num_bottom_pred

    @torch.inference_mode()
    def score(labels: torch.Tensor, codes_t: torch.Tensor,
              codes_b_cells: torch.Tensor):
        def depth(i, h):
            def given(step, _):
                return codes_t[:, i] if step == 0 else \
                    codes_b_cells[:, i, (step - 1) * n:step * n]
            top, bot, logits = _depth_chain(model, h, given,
                                            int8.depth_gemms)
            return top, bot, (logits[0], torch.cat(logits[1:], dim=1))

        outs, _ = _serving_loop(model, labels, max_seq_len, int8, scales,
                                depth)
        lts, lbs = zip(*outs)
        return torch.stack(lts, dim=1), torch.stack(lbs, dim=1)

    return score
