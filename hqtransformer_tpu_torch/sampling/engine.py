"""Sampling engine for the two-level HQ-Transformer (every depth mode),
the three-level one and the flat baselines.

Counterpart of every sampler of `hqtransformer_tpu/sampling/engine.py`
(`make_hierarchical_sampler`, `make_hierarchical_scorer`,
`make_multilevel_sampler`, `make_igpt_sampler`, `make_txt2img_sampler`)
on their packed-cache path. Where the JAX package compiles the whole loop
into one `lax.scan`, the port runs it eagerly: one spatial step per
position (12 launches of the decode attention kernel at the flagship
depth), then the depth draws (2 launches of the sampling kernel in the
`parallel` depth mode). The 2-level sampler replays each position's
depth call from a CUDA graph on the card (`_DepthGraphs`), with the
eager call's codes.

Loop order, as in the JAX sampler: prefill the conditioning prefix (its
sos_len tokens: 1, or a caption's ctx_len_txt) at cache rows [0, sos_len),
causal among them; then for each spatial step i in 1..N-1 embed the
previous cell at position i-1, run the spatial step at cache row
sos_len + i - 1, and draw the top code and its bottom group (2 levels), or
the top code, its 4 mids and its 16 bottoms in three depth phases (3
levels); the flat baselines draw one code a position, from the spatial
step's logits. All share this loop (`_serving_loop`); the 2-level sampler
and scorer share the parallel depth chain (`_depth_chain`) and differ only
in where each step's codes come from (drawn or given).

The 2-level depth modes (`_DEPTH_SAMPLERS`, as in JAX): `parallel`, two
draws a position (the top, then its bottom group); `bidirectional`, one
joint draw of the top and its r bottoms, every position with `top_k_bot`,
`top_p_bot` and `temperature_top` (the reference's quirk); `top2bot`,
1 + r draws in a causal chain of single-token depth steps, the first
step's code embedded by `tok_emb_top_depth`, later ones by
`tok_emb_bot_depth`. With `use_given_top` the sampler takes the top codes:
it still draws each top code (so the generator's stream and the kernel's
launches are those of the unforced sampler), then puts the given one in
its place, as JAX does.

Random numbers: every draw takes one uniform per row from the caller's
`torch.Generator`, in depth order: the top codes' first, then the bottom
group's (2 levels), or the mids' and then the bottoms' (3 levels).

Parallel serving: on a model with a `layout` (`parallel/tp.py::
shard_module`), every sampler and the scorer take the whole batch's
labels (and given codes) and serve this process's dp shard of them,
returning its rows. Each draw takes the uniforms of the whole batch from
the generator and uses its shard's (`sample_from_logits(shard=)`), so,
for one generator seed, the codes do not depend on dp or tp; the tp ranks
of a dp group draw the same codes from the same gathered logits, so
their caches stay in step.

`bisect3` (in `SamplingParams` and per level in `LevelSampling`) has the
sampling kernel find its top-k threshold by the TPU kernel's quartile
search instead of its binary one; it is off by default, as in JAX.

int8 serving: `int8` (an `Int8Serving`) and `scales` (the calibrated
collections, see `models/twostage.py`) choose the int8 KV cache and the
A8W8 gemms of the spatial steps and of the depth chain (the 2-level
`parallel` depth-second chain; every 3-level depth phase), as the JAX
samplers' cache_dtype and HQT_INT8_* switches do; the spatial gemms
include the text prefix's prefill and the 3-level cell embedding's
`emb_blocks`. The 2-level `bidirectional` and `top2bot` modes take every
switch, and run their depth passes in float, as JAX does. The flat
baselines take the int8 KV cache alone: JAX's flat samplers enter no int8
scope, and the port refuses a gemm switch for them. Every switch runs on a
model with a layout too, with the same whole scales as at tp 1: each rank
serves with its heads' span of them (an int8 cache [L, T, B / dp, D / tp]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from ..models.stage2.hierarchical import HierarchicalGPT
from ..models.stage2.multilevel import NO_PHASES, MultiLevelHQTransformer
from ..models.stage2.transformer import IGPT, Transformer1d
from ..ops.int8 import Int8Serving
from ..ops.topk_topp import sample_from_logits
from ..utils import tracing

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
    bisect3: bool = False


@dataclass(frozen=True)
class LevelSampling:
    """The filtering knobs of one code level of the 3-level sampler."""
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    temperature: float = 1.0
    bisect3: bool = False

    def draw(self, generator: torch.Generator, logits: torch.Tensor,
             shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        return sample_from_logits(generator, logits,
                                  temperature=self.temperature,
                                  top_k=self.top_k, top_p=self.top_p,
                                  bisect3=self.bisect3, shard=shard)


def _shard(model) -> Tuple[int, int]:
    """(dp rank, dp size) of a model's layout; (0, 1) without one."""
    layout = getattr(model, 'layout', None)
    return (0, 1) if layout is None else (layout.dp_rank, layout.dp)


def _rows(model, x: torch.Tensor) -> torch.Tensor:
    """This process's dp shard of a whole batch x [B, ...] (x without a
    layout)."""
    layout = getattr(model, 'layout', None)
    return x if layout is None else layout.rows(x)


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


def _draw(generator: torch.Generator, sp: SamplingParams, level: str,
          logits: torch.Tensor,
          shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """One draw with the knobs of `level` ('top' or 'bot')."""
    if level == 'top':
        return sample_from_logits(generator, logits,
                                  temperature=sp.temperature_top,
                                  top_k=sp.top_k_top, top_p=sp.top_p_top,
                                  bisect3=sp.bisect3, shard=shard)
    return sample_from_logits(generator, logits,
                              temperature=sp.temperature_bot,
                              top_k=sp.top_k_bot, top_p=sp.top_p_bot,
                              bisect3=sp.bisect3, shard=shard)


def _draws(generator: torch.Generator, sp: SamplingParams,
           given_top: Optional[torch.Tensor] = None,
           shard: Tuple[int, int] = (0, 1)) -> Callable:
    """The sampler's `pick` for `_depth_chain`: one draw per depth step
    from `generator`; step 0's with the top's knobs, then replaced by
    `given_top` where given."""
    def pick(step: int, logits: torch.Tensor) -> torch.Tensor:
        codes = _draw(generator, sp, 'bot' if step else 'top', logits,
                      shard)
        return given_top if step == 0 and given_top is not None else codes
    return pick


def _depth_sample_parallel(model: HierarchicalGPT, h: torch.Tensor,
                           generator: torch.Generator, sp: SamplingParams,
                           given_top: Optional[torch.Tensor], int8: bool,
                           shard: Tuple[int, int] = (0, 1)
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `parallel` depth draws: (top [B], bottoms [B, ratio])."""
    top, bot, _ = _depth_chain(model, h, _draws(generator, sp, given_top,
                                                shard), int8)
    return top, bot


def _depth_sample_bidirectional(model: HierarchicalGPT, h: torch.Tensor,
                                generator: torch.Generator,
                                sp: SamplingParams,
                                given_top: Optional[torch.Tensor], int8: bool,
                                shard: Tuple[int, int] = (0, 1)
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `bidirectional` depth pass and its one joint draw of the top
    and the r bottoms ([B (1 + r), V] rows), all with `top_k_bot`,
    `top_p_bot` and `temperature_top`."""
    logits = torch.cat(model.depth_bidirectional(h), dim=1)
    outs = sample_from_logits(generator, logits,
                              temperature=sp.temperature_top,
                              top_k=sp.top_k_bot, top_p=sp.top_p_bot,
                              bisect3=sp.bisect3, shard=shard)
    return (outs[:, 0] if given_top is None else given_top), outs[:, 1:]


def _depth_sample_top2bot(model: HierarchicalGPT, h: torch.Tensor,
                          generator: torch.Generator, sp: SamplingParams,
                          given_top: Optional[torch.Tensor], int8: bool,
                          shard: Tuple[int, int] = (0, 1)
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `top2bot` causal depth chain: sos_depth + h, then the previous
    code's embedding (the top's by `tok_emb_top_depth`, a bottom's by
    `tok_emb_bot_depth`) plus `pos_emb_depth(step - 1)`, one token a step
    over the per-head depth caches; the top's draw, then r bottoms'."""
    kc, vc = model.depth_caches(h.shape[0], h.device)
    x = model.depth_causal_step(h[:, None] + model.sos_depth.to(h.dtype),
                                kc, vc, 0)
    top = _draw(generator, sp, 'top', model.head_top(model.ln_top(x[:, 0])),
                shard)
    codes = [top if given_top is None else given_top]
    pos = model.pos_emb_depth.weight
    for step in range(1, model.len_seq_depth):
        table = model.tok_emb_top_depth if step == 1 else \
            model.tok_emb_bot_depth
        x = model._emb(table, codes[-1]) + pos[step - 1].to(h.dtype)
        x = model.depth_causal_step(x[:, None], kc, vc, step)
        codes.append(_draw(generator, sp, 'bot',
                           model.head_bot(model.ln_bot(x[:, 0])), shard))
    return codes[0], torch.stack(codes[1:], dim=1)


_DEPTH_SAMPLERS = {
    'parallel': _depth_sample_parallel,
    'bidirectional': _depth_sample_bidirectional,
    'top2bot': _depth_sample_top2bot,
}

Model = Union[HierarchicalGPT, MultiLevelHQTransformer, IGPT, Transformer1d]
MAX_DEPTH_GRAPHS = 8     # captured depth calls a sampler keeps


class _DepthGraphs:
    """The 2-level sampler's depth call, replayed as a CUDA graph.

    A position's depth call is some 300 small launches whose shapes and
    arguments do not change from one position to the next, so at batch 512
    the host, not the card, sets the pace of an eager AR loop. One graph per
    (h's shape and dtype, generator) holds them, and a replay runs them
    from one host call. A key's first call runs eagerly (every kernel
    loaded before a capture); its second is captured and then replayed,
    as are all later ones.

    What a graph reads is fixed at its capture: h is copied into the
    graph's input, and the model's tensors are read where they lie, so
    `start` drops every graph when one of them moved (another weights
    dict). The depth layers' fused QKV and K/V weights, which
    `HierarchicalGPT.serving` makes anew for each call, are made inside
    the graph instead, from the same weights by the same concatenation.
    The generator is registered with its graphs, so a replay draws the
    uniforms the eager call would have drawn and advances the generator as
    far. The counters a capture counted (the draws' `k2.launches`) are
    taken back and counted at each replay instead.

    Eager whenever a graph cannot hold the call or should not: off the
    card, while spans record (`tracing.active()`: a replay records none),
    with given top codes, under any int8 switch, or on a model with a
    layout (its collectives). A function patched into the depth path is
    captured with it and not called at a replay: one that reads a tensor
    on the host or draws from another generator has to run inside
    `tracing.recording()`."""

    def __init__(self, model: HierarchicalGPT, depth_fn: Callable,
                 params: SamplingParams, int8: Int8Serving,
                 shard: Tuple[int, int]):
        self.model, self.depth_fn = model, depth_fn
        self.params, self.int8, self.shard = params, int8, shard
        self.enabled = (int8 == Int8Serving() and
                        getattr(model, 'layout', None) is None)
        self.graphs = {}      # key -> None (run once) or a captured entry
        self.tensors = None   # where the model's tensors lay at capture

    def start(self) -> None:
        """Before a sampler call's loop."""
        if not self.enabled:
            return
        tensors = tuple(t.data_ptr() for t in (*self.model.parameters(),
                                               *self.model.buffers()))
        if tensors != self.tensors:
            self.graphs.clear()
            self.tensors = tensors

    def _eager(self, h: torch.Tensor, generator: torch.Generator,
               given_top: Optional[torch.Tensor] = None):
        return self.depth_fn(self.model, h, generator, self.params,
                             given_top, self.int8.depth_gemms, self.shard)

    def __call__(self, h: torch.Tensor, generator: torch.Generator,
                 given_top: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not (self.enabled and h.is_cuda and given_top is None) or \
                tracing.active():
            return self._eager(h, generator, given_top)
        key = (tuple(h.shape), h.dtype, id(generator))
        if key not in self.graphs:
            if len(self.graphs) >= MAX_DEPTH_GRAPHS:
                self.graphs.clear()
            self.graphs[key] = None
            return self._eager(h, generator)
        entry = self.graphs[key] or self._capture(key, h, generator)
        graph, h_in, out, counted, _ = entry
        h_in.copy_(h)
        graph.replay()
        for name, n in counted.items():
            tracing.count(name, n)
        return out[0].clone(), out[1].clone()

    def _capture(self, key, h, generator):
        depths = self.model.depths
        live = [blk.attn.serving for blk in depths]
        h_in = h.clone()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        before = tracing.counts()
        try:
            for blk in depths:
                blk.attn.serving = None
            with torch.cuda.graph(graph):
                out = self._eager(h_in, generator)
        finally:
            for blk, s in zip(depths, live):
                blk.attn.serving = s
        counted = {name: n - before.get(name, 0)
                   for name, n in tracing.counts().items()
                   if n != before.get(name, 0)}
        for name, n in counted.items():    # counted again at each replay
            tracing.count(name, -n)
        entry = (graph, h_in, out, counted, generator)
        self.graphs[key] = entry
        return entry


def _caches(model: Model, sos: torch.Tensor, max_seq_len: int,
            int8: Int8Serving) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed [L, T, B, D] caches (T = sos_len + N - 1, sos_len the
    prefix's length; D the rank's heads' width under tensor parallelism),
    int8 or in the activation dtype."""
    hp = model.hparams
    shape = (hp.n_layers, sos.shape[1] + max_seq_len - 1, sos.shape[0],
             model.blocks[0].attn.width)
    dtype = torch.int8 if int8.kv_cache else sos.dtype
    kc = torch.zeros(shape, dtype=dtype, device=sos.device)
    return kc, torch.zeros_like(kc)


def _serving_loop(model: Model, labels: torch.Tensor, max_seq_len: int,
                  int8: Int8Serving, scales: Optional[Scales],
                  depth: Callable
                  ) -> Tuple[list, Tuple[torch.Tensor, torch.Tensor]]:
    """The AR loop of the samplers and the scorer, in one serving call:
    prefill the conditioning prefix (labels: class ids [B], caption ids
    [B, N] or a dummy [B]), then for each spatial position i run
    `depth(i, h [B, D]) -> (codes, out)`, where `codes` is the tuple of the
    position's codes that `model.embed_cell_step` takes ((top [B],
    bottoms [B, ratio]) for 2 levels, (top, mids [B, 4], bottoms
    [B, 16]) for 3, (code [B],) for the flat baselines), and embed them
    for the next spatial step. Returns ([out of every position],
    (k_caches, v_caches)). The prefix's embedding, the caches and the
    prefill are the span `ar.prefill`, which counts the prefix rows it
    prefilled in `ar.prefill_rows`; each position's spatial step and depth
    call are the spans `ar.spatial` and `ar.depth` (`utils/tracing.py`)."""
    B = labels.shape[0]
    with model.serving(int8, scales):
        with tracing.span('ar.prefill'):
            sos = model.sos_tokens(B, labels)
            sos_len = sos.shape[1]
            kc, vc = _caches(model, sos, max_seq_len, int8)
            h = model.spatial_prefill(sos, kc, vc, int8.spatial_gemms)
        tracing.count('ar.prefill_rows', B * sos_len)
        outs = []
        for i in range(max_seq_len):
            if i:
                with tracing.span('ar.spatial'):
                    position = torch.full((B,), i - 1, dtype=torch.long,
                                          device=sos.device)
                    x = model.embed_cell_step(*codes, position,
                                              int8=int8.spatial_gemms)
                    h = model.spatial_step(x, kc, vc, sos_len + i - 1,
                                           int8.spatial_gemms)
            with tracing.span('ar.depth'):
                codes, out = depth(i, h[:, -1])
            outs.append(out)
    return outs, (kc, vc)


def make_hierarchical_sampler(model: HierarchicalGPT, max_seq_len: int = 64,
                              params: SamplingParams = SamplingParams(),
                              int8: Int8Serving = Int8Serving(),
                              scales: Optional[Scales] = None,
                              return_caches: bool = False,
                              use_given_top: bool = False) -> Callable:
    """Build the sampler for the 2-level model, in its depth mode. Returns
    fn(generator, labels) -> (codes_t [B, N], codes_b [B, N, ratio]),
    int32, with N = max_seq_len spatial positions (labels: see
    `_serving_loop`); with `return_caches`,
    ((codes_t, codes_b), (k_caches, v_caches)), the calibration hook of
    `TwoStageModel.calibrate_kv_scales`. With `use_given_top`,
    fn(generator, labels, given_top_codes [B, N]): codes_t are the given
    codes and the bottoms are drawn under them (see the module docstring).
    Every depth mode takes every `int8` switch; outside `parallel`,
    `depth_gemms` changes nothing (see the module docstring).

    The packed [L, T, B, D] KV cache (T = sos_len + N - 1), int8 with
    `int8.kv_cache` and else in the activation dtype, is allocated once
    per call, and the weights' concatenations and quantizations are done
    once per call (`HierarchicalGPT.serving`). On the card each
    position's depth call is replayed from a CUDA graph (`_DepthGraphs`),
    with the codes and the generator's stream of the eager call. The JAX
    sampler's
    `n_segments` and `t_compute` are not needed: they bound the
    static-shape compute of the TPU kernel, while the CUDA kernel's loop
    already stops at the current position."""
    depth_fn = _DepthGraphs(model, _DEPTH_SAMPLERS[model.depth_mode],
                            params, int8, _shard(model))

    @torch.inference_mode()
    def sample(generator: torch.Generator, labels: torch.Tensor,
               given_top_codes: Optional[torch.Tensor] = None):
        if use_given_top != (given_top_codes is not None):
            raise ValueError('given_top_codes go with use_given_top, and '
                             'only with it')
        labels = _rows(model, labels)
        if use_given_top:
            given_top_codes = _rows(model, given_top_codes).to(
                labels.device, torch.int32)
        depth_fn.start()

        def depth(i, h):
            given = given_top_codes[:, i] if use_given_top else None
            top, bot = depth_fn(h, generator, given)
            return (top, bot), (top, bot)

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
    Returns fn(labels, codes_t [B, N], codes_b_cells [B, N, ratio]) ->
    (logits_top [B, N, Vt], logits_bot [B, N, ratio, Vb]).

    The sampler's loop (prefill, the packed-cache spatial steps, the
    depth-first and depth-second chain, and with `int8` the int8 KV cache
    and A8W8 gemms), with the given codes in place of draws: the logits of
    two serving modes on the same codes measure what the serving path's
    numerics do (per-step agreement and KL), as the JAX scorer does. The
    `parallel` depth mode only, as in JAX: others raise ValueError."""
    if model.depth_mode != 'parallel':
        raise ValueError(f'the scorer takes the parallel depth mode, not '
                         f'{model.depth_mode!r}')
    n = model.num_bottom_pred

    @torch.inference_mode()
    def score(labels: torch.Tensor, codes_t: torch.Tensor,
              codes_b_cells: torch.Tensor):
        labels, codes_t, codes_b_cells = (
            _rows(model, x) for x in (labels, codes_t, codes_b_cells))

        def depth(i, h):
            def given(step, _):
                return codes_t[:, i] if step == 0 else \
                    codes_b_cells[:, i, (step - 1) * n:step * n]
            top, bot, logits = _depth_chain(model, h, given,
                                            int8.depth_gemms)
            return (top, bot), (logits[0], torch.cat(logits[1:], dim=1))

        outs, _ = _serving_loop(model, labels, max_seq_len, int8, scales,
                                depth)
        lts, lbs = zip(*outs)
        return torch.stack(lts, dim=1), torch.stack(lbs, dim=1)

    return score


def make_multilevel_sampler(model: MultiLevelHQTransformer,
                            max_seq_len: int = 64,
                            params: Sequence[LevelSampling] = (
                                LevelSampling(),) * 3,
                            int8: Int8Serving = Int8Serving(),
                            scales: Optional[Scales] = None,
                            return_caches: bool = False) -> Callable:
    """Build the sampler for the 3-level model, one `LevelSampling` a
    level (top, mid, bottom). Returns fn(generator, labels) -> (tops
    [B, N], mids [B, N, 4], bots [B, N, 16]), int32, mids and bottoms in
    each top cell's local raster order, N = max_seq_len; with
    `return_caches`, (codes, (k_caches, v_caches)), the calibration hook of
    `TwoStageModel.calibrate_kv_scales`.

    Per position: depth phase 0 (the top's logits), one draw [B]; phase 1
    (the 4 mids' logits), one draw [B, 4]; phase 2 (the 16 bottoms'),
    one draw [B, 16]; each phase runs only its new tokens against the
    depth K/V the earlier phases cached (`depth_phase_cached`). The
    spatial steps run on the packed cache, as the 2-level sampler's do.
    `int8` and `scales` choose int8 serving as for the 2-level sampler;
    `depth_gemms` covers all three depth phases, as the JAX sampler's
    `int8_stage2_scope` does. A 'top2mid2bot' model has no sampler (nor
    has it in JAX) and raises ValueError."""
    if len(params) != 3:
        raise ValueError(f'one LevelSampling a level: got {len(params)}')
    if model.is_causal_depth:
        raise ValueError(NO_PHASES)
    depth8 = int8.depth_gemms
    shard = _shard(model)

    @torch.inference_mode()
    def sample(generator: torch.Generator, labels: torch.Tensor):
        labels = _rows(model, labels)

        def depth(i, h):
            logits, kv = model.depth_phase_cached(h, None, None, None, 0,
                                                  depth8)
            top = params[0].draw(generator, logits, shard)
            logits, kv = model.depth_phase_cached(None, top, None, kv, 1,
                                                  depth8)
            mids = params[1].draw(generator, logits, shard)
            logits, _ = model.depth_phase_cached(None, top, mids, kv, 2,
                                                 depth8)
            codes = (top, mids, params[2].draw(generator, logits, shard))
            return codes, codes

        outs, caches = _serving_loop(model, labels, max_seq_len, int8,
                                     scales, depth)
        codes = tuple(torch.stack(c, dim=1) for c in zip(*outs))
        return (codes, caches) if return_caches else codes

    return sample


def _flat_sampler(model: Union[IGPT, Transformer1d], max_seq_len: int,
                  top_k: Optional[int], top_p: Optional[float],
                  temperature: float, int8: Int8Serving,
                  scales: Optional[Scales],
                  return_caches: bool = False) -> Callable:
    """fn(generator, labels) -> codes [B, max_seq_len], int32: one draw a
    position from the spatial step's image logits; with `return_caches`,
    (codes, (k_caches, v_caches)). `int8` may ask for the int8 KV cache
    alone (its scales: `scales['stage2/kv_scales']`, the rows
    `blocks.<l>.attn.{k,v}`); a gemm switch raises ValueError, as JAX's
    flat samplers run no int8 gemm. `decode_convs` belongs to the pixel
    decode and is not read here."""
    if int8.depth_gemms or int8.spatial_gemms:
        raise ValueError(f'the flat {type(model).__name__} sampler takes '
                         f'the int8 KV cache alone (Int8Serving(kv_cache='
                         f'True)), not int8 gemms')

    shard = _shard(model)

    @torch.inference_mode()
    def sample(generator: torch.Generator, labels: torch.Tensor):
        labels = _rows(model, labels)

        def depth(i, h):
            code = sample_from_logits(generator, model.image_logits(h),
                                      temperature=temperature, top_k=top_k,
                                      top_p=top_p, shard=shard)
            return (code,), code

        outs, caches = _serving_loop(model, labels, max_seq_len, int8,
                                     scales, depth)
        codes = torch.stack(outs, dim=1)
        return (codes, caches) if return_caches else codes

    return sample


def make_igpt_sampler(model: IGPT, max_seq_len: int = 256,
                      top_k: Optional[int] = None,
                      top_p: Optional[float] = None,
                      temperature: float = 1.0,
                      int8: Int8Serving = Int8Serving(),
                      scales: Optional[Scales] = None) -> Callable:
    """The sampler of the flat iGPT baseline: fn(generator, labels) ->
    codes [B, N], int32, N = max_seq_len (labels: class ids [B], or a dummy
    [B] without class conditioning). One sos token, then N - 1 spatial
    steps (decode attention at pos 1..N-1), a draw after each. `int8` and
    `scales`: the int8 KV cache (`_flat_sampler`)."""
    return _flat_sampler(model, max_seq_len, top_k, top_p, temperature,
                         int8, scales)


def make_txt2img_sampler(model: Transformer1d, max_seq_len: int = 256,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None,
                         temperature: float = 1.0,
                         int8: Int8Serving = Int8Serving(),
                         scales: Optional[Scales] = None) -> Callable:
    """The sampler of the text-to-image Transformer1d: fn(generator,
    texts [B, N_txt]) -> codes [B, N], int32, N = max_seq_len. The N_txt
    prefix tokens are prefilled, then N - 1 spatial steps (decode
    attention at pos N_txt..N_txt + N - 2), a draw after each. `int8` and
    `scales`: the int8 KV cache (`_flat_sampler`)."""
    return _flat_sampler(model, max_seq_len, top_k, top_p, temperature,
                         int8, scales)
