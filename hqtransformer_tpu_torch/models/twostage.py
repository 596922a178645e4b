"""Two-stage model: the stage-1 HQ-VAE plus the stage-2 HQ-Transformer.

Counterpart of `hqtransformer_tpu/models/twostage.py` for the ported paths:
- `TwoStageModel(cfg).make_pixel_sampler(...)(weights, generator, labels)`
  gives pixels [B, 256, 256, 3] in [0, 1] at the flagship config (every
  depth mode of the 2-level family), `make_pixel_sampler_multilevel(...)`
  the same for the 3-level family (stage-2 type 'multilevel-hq', the
  3-level HQ-VAE) and `make_pixel_sampler_igpt(...)` for the flat iGPT
  baseline (stage-2 type 'top'), whose top codes are decoded alone;
- stage-2 type 'bottom' builds the text-to-image `Transformer1d`, which
  `sampling/engine.py::make_txt2img_sampler` samples;
- `extract_codes(weights, images)` encodes images [B, 256, 256, 3] in
  [-1, 1] to raster codes (with `temp_soft_labels`, also the soft code
  maps of soft-label training), and `forward(weights, images, labels)`
  runs the teacher-forced stage-2 forward on them, giving its logits.

Labels, the conditioning of every entry point, are per the config's
`stage2`: class ids [B] under `use_cls_cond`; caption token ids
[B, ctx_len_txt] under `use_txt_cond` (`data/tokenizers.py`,
`encode_padded(caption, ctx_len_txt)` per caption); with neither, any [B]
tensor, of which only B is read (the JAX package's dummy labels,
`zeros(B)`). A text model's teacher-forced `forward` returns the text
logits after the image ones.

Weights are state dicts in the PyTorch reference's key layout,
{'stage1': {...}, 'stage2': {...}}: from `TwoStageModel.init_weights` (a
seeded random init; the repo holds no trained weights), from a reference
Lightning checkpoint by `load_reference_checkpoint`, or converted from
JAX variables by `convert.py`.

int8max serving: the samplers take `int8` (an `ops.int8.Int8Serving`; all
four switches on is `INT8MAX`) and `scales`, the calibrated collections
{'stage1/act_scales' | 'stage2/kv_scales' | 'stage2/act_scales': {module
name: f32 tensor}}, kept apart from the weights. `calibrate_kv_scales`,
`calibrate_stage2_int8` and `calibrate_int8_decode` each return one
collection (merge them with `{**a, **b, **c}`); `save_serving_scales` and
`load_serving_scales` write and read them in the JAX package's artifact
format, so that calibration and serving can run in separate processes.
`make_pipelined_sampler` decodes the previous batch on a second CUDA
stream while the current batch's AR loop runs. The 3-level family serves
through `make_pixel_sampler_multilevel`, in bf16, f32 and int8max, and
calibrates with the same three functions (their arguments per family as in
the JAX package); `extract_codes`, `forward` and the two 2-level samplers
are the 2-level HQ family's only, as in the JAX package, and raise for the
other families.

Tensor parallelism: `TwoStageModel(cfg, layout=...)` (a
`parallel/tp.py::ParallelLayout`) holds this rank's shards of stage 2
(`shard_module`) and stage 1 whole. Weights stay full, reference-layout
state dicts: `init_weights` and `load_reference_checkpoint` work on the
full shapes, `load_weights` cuts stage 2 with `shard_state`. The samplers
take the whole batch's labels and return this rank's dp shard of the
codes and pixels (`sampling/engine.py`). int8 serving runs under it with
the same scales: the calibrations return whole scales in the tp-1 layout
on every rank, and the serving call cuts them to the rank's shards.
"""

from __future__ import annotations

import contextlib
import math
import pickle
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.distributed as dist
from torch import nn

from ..checkpoint import (check_reference_path, load_torch_checkpoint,
                          split_reference_state, widen)
from ..config import TwoStageConfig, parse_model_type
from ..convert import convert_scales, export_scales
from ..device import resolve_device
from ..ops.int8 import Int8Serving, recording_absmax, scale_from_absmax
from ..parallel.tp import (ParallelLayout, all_reduce, shard_module,
                           shard_state)
from ..sampling.engine import (LevelSampling, SamplingParams, Scales,
                               _flat_sampler, make_hierarchical_sampler,
                               make_igpt_sampler, make_multilevel_sampler)
from ..utils import tracing
from .stage1.generator import build_generator
from .stage1.layers import QuantizableConv2d
from .stage1.quantizer import EMAVectorQuantizer, VectorQuantizer
from .stage2.hierarchical import HierarchicalGPT, cells_to_raster
from .stage2.layers import QuantizableLinear
from .stage2.multilevel import MultiLevelHQTransformer
from .stage2.transformer import IGPT, Transformer1d

Weights = Dict[str, Dict[str, torch.Tensor]]
Codes = Tuple[torch.Tensor, torch.Tensor]


def build_stage2(config: TwoStageConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False) -> nn.Module:
    """Stage-2 model for `stage2.type`: 'top' (IGPT), 'bottom'
    (Transformer1d over a "text" of the image vocabulary, as in JAX),
    hq-transformer (2-level) and multilevel-hq (3-level). `remat`
    (training) recomputes the main blocks' activations in the backward
    pass of the hierarchical models; the flat baselines refuse it, as JAX
    builds them without it."""
    model = _build_stage2(config, dtype)
    if remat:
        if not isinstance(model, (HierarchicalGPT, MultiLevelHQTransformer)):
            raise ValueError(f'remat is for the hierarchical models, not '
                             f'{type(model).__name__}')
        model.remat = True
    return model


def _build_stage2(config: TwoStageConfig, dtype: torch.dtype) -> nn.Module:
    s2 = config.stage2
    spec = parse_model_type(s2.type)
    if spec.family == 'top':
        return IGPT(vocab_size_img=s2.vocab_size_img,
                    use_cls_cond=bool(s2.use_cls_cond), hparams=s2.hparams,
                    dtype=dtype)
    if spec.family == 'bottom':
        return Transformer1d(vocab_size_txt=s2.vocab_size_img,
                             vocab_size_img=s2.vocab_size_img,
                             hparams=s2.hparams, dtype=dtype)
    if spec.family == 'multilevel-hq':
        return MultiLevelHQTransformer(
            vocab_sizes=tuple(s2.vocab_sizes_img),
            decoding_type=s2.decoding_type or 'tree',
            use_cls_cond=bool(s2.use_cls_cond), hparams=s2.hparams,
            hparams_dec=s2.hparams_dec, use_txt_cond=bool(s2.use_txt_cond),
            dtype=dtype, vocab_size_txt=s2.vocab_size_txt)
    return HierarchicalGPT(vocab_size_top=s2.vocab_size_img,
                           vocab_size_bot=s2.vocab_size_img,
                           ratio_bot2top=s2.ratio_bot2top,
                           use_cls_cond=bool(s2.use_cls_cond),
                           model_type=spec, hparams=s2.hparams,
                           hparams_dec=s2.hparams_dec, dtype=dtype,
                           use_txt_cond=bool(s2.use_txt_cond),
                           vocab_size_txt=s2.vocab_size_txt)


def serving_bf16_params(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The bf16 serving convention: f32 tensors with ndim >= 2 are stored
    as bf16; 1-D biases, norm scales and codebook counts stay as they are."""
    return {k: v.to(torch.bfloat16)
            if v.dtype == torch.float32 and v.dim() >= 2 else v
            for k, v in state.items()}


def _on_device(args: Any, device: torch.device,
               samples: slice = slice(None)) -> Any:
    """The `samples` of every tensor in `args` (tensors, None and lists of
    them), moved to `device`."""
    if isinstance(args, (list, tuple)):
        return type(args)(_on_device(a, device, samples) for a in args)
    return None if args is None else args[samples].to(device)


def _decode_chunked(dec1: Callable, arrays: Sequence[torch.Tensor],
                    chunk: int) -> torch.Tensor:
    """Run `dec1(*slices)` over `chunk`-sample slices of the leading axis
    and concatenate: the conv decoder's 256^2 activations at large batch
    would not fit in device memory at once."""
    B = arrays[0].shape[0]
    return torch.cat([dec1(*(a[i:i + chunk] for a in arrays))
                      for i in range(0, B, chunk)])


def save_serving_scales(scales: Scales, path: str) -> None:
    """Write the calibration collections of `scales` to `path` in the JAX
    package's artifact format (`twostage.save_serving_scales`): a pickle of
    {'stage/collection': numpy tree with flax names}."""
    with open(path, 'wb') as f:
        pickle.dump(export_scales(scales), f)


def load_serving_scales(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """Read an artifact written by `save_serving_scales`, here or by the
    JAX package, into the port's collections (only those it holds). The
    artifact is a pickle: load only files you wrote."""
    with open(path, 'rb') as f:
        return convert_scales(pickle.load(f))


def _kv_scales(caches: Tuple[torch.Tensor, torch.Tensor],
               layout: Optional[ParallelLayout] = None) -> Scales:
    """The int8 KV-cache scales of a float sampling run's final packed
    caches [L, T, B, D]: each layer's per-channel absmax over (T, B), a
    prefix's rows included, as max(m, 1e-6) / 127 (the JAX function's
    default margin of 1). Under a `layout` the caches are the rank's
    [L, T, B / dp, D / tp]: the absmax is gathered over the tp group on
    the channel dim and maxed over the dp group, so every rank returns the
    whole batch's scales in the tp-1 layout. Returns {'stage2/kv_scales':
    {'blocks.<l>.attn.k' | '.v': [D]}}."""
    out = {}
    for which, c in zip('kv', caches):
        m = torch.maximum(c.amax(dim=(1, 2)), -c.amin(dim=(1, 2)))
        m = torch.clamp_min(_whole_absmax(m.float(), layout), 1e-6)
        s = m / torch.tensor(127.0, device=m.device)
        for i in range(s.shape[0]):
            out[f'blocks.{i}.attn.{which}'] = s[i]
    return {'stage2/kv_scales': out}


def _whole_absmax(m: torch.Tensor, layout: Optional[ParallelLayout]
                  ) -> torch.Tensor:
    """Per-channel absmax m [..., D / tp] of this rank's shard of the
    rows -> the whole batch's [..., D] (a collective under a layout)."""
    if layout is None:
        return m
    if layout.tp_group is not None:
        m = layout.tp_group.gather(m)
    if layout.dp > 1:
        m = all_reduce(m, layout.dp_group, dist.ReduceOp.MAX)
    return m


@torch.inference_mode()
def _flat_kv_scales(model: Union[IGPT, Transformer1d],
                    generator: torch.Generator, labels: torch.Tensor,
                    max_seq_len: int, top_k: Optional[int] = None) -> Scales:
    """The int8 KV-cache scales of a flat baseline (its loaded weights):
    one float sampling run on `labels` (top-k `top_k`, temperature 1),
    its caches reduced by `_kv_scales`, as `calibrate_kv_scales` reduces
    the hierarchical models'. The JAX package has no flat calibration (its
    `calibrate_kv_scales` refuses these models and its flat samplers take
    the scales as given), so this stays private: the tests and the GPU
    smoke make the flat samplers' scales with it."""
    sampler = _flat_sampler(model, max_seq_len, top_k, None, 1.0,
                            Int8Serving(), None, return_caches=True)
    _, caches = sampler(generator, labels)
    return _kv_scales(caches, getattr(model, 'layout', None))


def random_state(module: nn.Module, generator: torch.Generator
                 ) -> Dict[str, torch.Tensor]:
    """Seeded random weights for every entry of module's state dict, f32 on
    the generator's device, at the JAX initialisers' scales: lecun-normal
    projections and convolutions, zero biases, unit norm scales, N(0, 0.02)
    embeddings, N(0, 1) EMA codebooks and uniform(-1/K, 1/K) learned
    ones."""
    dev = generator.device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    state = {}
    for prefix, m in module.named_modules():
        p = f'{prefix}.' if prefix else ''
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            # lecun-normal over the fan-in flax reads from its kernel: all
            # axes but the output's. A conv-transpose kernel keeps torch's
            # layout [Cin, Cout, k, k] there, so its fan-in is Cin Cout k.
            w = m.weight.shape
            fan_in = (w[0] * w[1] * w[2] if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0].numel())
            state[p + 'weight'] = normal(w, fan_in ** -0.5)
            if m.bias is not None:
                state[p + 'bias'] = torch.zeros(m.bias.shape, device=dev)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            state[p + 'weight'] = torch.ones(m.weight.shape, device=dev)
            state[p + 'bias'] = torch.zeros(m.bias.shape, device=dev)
        elif isinstance(m, EMAVectorQuantizer):
            emb = normal((m.n_embed, m.dim), 1.0)
            state[p + 'embedding'] = emb
            state[p + 'embedding_avg'] = emb.clone()
            state[p + 'cluster_size'] = torch.zeros(m.n_embed, device=dev)
        elif isinstance(m, VectorQuantizer):
            u = torch.rand((m.n_embed, m.dim), generator=generator,
                           device=dev)
            state[p + 'embedding.weight'] = (2 * u - 1) / m.n_embed
    for name, t in module.state_dict().items():
        if name not in state:   # embeddings and sos_depth
            state[name] = normal(t.shape, 0.02)
    return state


class TwoStageModel:
    """The stage-1 generator and the stage-2 AR model on one device.

    `device` defaults to 'cuda' and raises when no card is present; pass
    device='cpu' to run on the CPU, where every kernel takes its plain
    version. `dtype` is the activation dtype; `remat` is `build_stage2`'s
    (training). The modules hold no weights until `load_weights` (which
    every sampler call does) gives them some; a trainer loads them once
    and then owns the modules' parameters (`train/stage2.py`). With a
    `layout` stage 2 holds this rank's tensor-parallel shards (the module
    docstring)."""

    def __init__(self, config: TwoStageConfig,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[str] = None, remat: bool = False,
                 layout: Optional[ParallelLayout] = None):
        self.config = config
        self.device = resolve_device(device)
        self.layout = layout
        with torch.device('meta'):
            stage1 = build_generator(config.stage1, dtype)
            stage2 = build_stage2(config, dtype, remat)
            # the full shapes, for seeded weights and checkpoint checks
            self.full_stage2 = build_stage2(config, dtype, remat) \
                if layout is not None and layout.tp > 1 else stage2
        if layout is not None:
            shard_module(stage2, layout)
        self.stage1 = stage1.to_empty(device=self.device).eval()
        self.stage2 = stage2.to_empty(device=self.device).eval()
        # top code grid: the stage-1 latent over the bottom-group window (2
        # levels) or over 2 per level below the top (N levels)
        self.cell_win = int(math.isqrt(config.stage2.ratio_bot2top or 4))
        latent = config.stage1.hparams.attn_resolutions[0]
        if isinstance(self.stage2, MultiLevelHQTransformer):
            self.code_levels = len(config.stage2.vocab_sizes_img)
            self.top_res = latent // 2 ** (self.code_levels - 1)
        else:
            self.code_levels = 2
            self.top_res = latent // self.cell_win

    def _two_levels(self, entry: str) -> None:
        """Raise unless the stage-2 model is the 2-level HQ-Transformer."""
        if not isinstance(self.stage2, HierarchicalGPT):
            raise NotImplementedError(
                f'{entry} takes the 2-level HQ-Transformer, not '
                f'{type(self.stage2).__name__}')

    def init_weights(self, seed: int) -> Weights:
        """Seeded random f32 weights on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return {'stage1': random_state(self.stage1, gen),
                'stage2': random_state(self.full_stage2, gen)}

    def load_reference_checkpoint(self, path_or_sd: Union[
            str, Mapping[str, torch.Tensor]]) -> Weights:
        """The weights of a reference checkpoint: a Lightning `.ckpt` (or
        `.pth`, `.pt`) path, read by `checkpoint.load_torch_checkpoint`
        (trusted files only: it unpickles), or its state dict with
        'stage1.' / 'stage2.' keys. Every key and shape must match the
        modules' (JAX's strict=True): raises KeyError naming the
        unmatched and the missing keys. Returns {'stage1': ...,
        'stage2': ...} of f32 CPU tensors, for `load_weights` and the
        samplers."""
        sd = (load_torch_checkpoint(check_reference_path(path_or_sd))
              if isinstance(path_or_sd, str) else widen(path_or_sd))
        weights = split_reference_state(sd)
        problems = []
        for name, module in (('stage1', self.stage1),
                             ('stage2', self.full_stage2)):
            want = {k: t.shape for k, t in module.state_dict().items()}
            got = weights[name]
            unmatched = sorted(f'{name}.{k}' for k in got
                               if k not in want or got[k].shape != want[k])
            missing = sorted(f'{name}.{k}' for k in want if k not in got)
            if unmatched:
                problems.append(f'unmatched checkpoint keys (absent or of '
                                f'another shape) {unmatched[:10]} '
                                f'(+{max(0, len(unmatched) - 10)} more)')
            if missing:
                problems.append(f'keys missing from the checkpoint '
                                f'{missing[:10]} '
                                f'(+{max(0, len(missing) - 10)} more)')
        if problems:
            raise KeyError('; '.join(problems))
        return weights

    def load_weights(self, weights: Weights) -> None:
        """Make `weights` the modules' tensors (strict key match, no copy
        for tensors already on the model's device; stage 2 cut to this
        rank's shards under tensor parallelism)."""
        for name, module in (('stage1', self.stage1),
                             ('stage2', self.stage2)):
            state = weights[name]
            if name == 'stage2':
                state = shard_state(state, self.layout)
            state = {k: v.to(self.device) for k, v in state.items()}
            module.load_state_dict(state, strict=True, assign=True)

    @torch.inference_mode()
    def extract_codes(self, weights: Weights, images: torch.Tensor,
                      temp_soft_labels: Optional[float] = None,
                      generator: Optional[torch.Generator] = None):
        """Stage-1 codes of images [B, H, W, 3] in [-1, 1]: ((codes_t
        [B, Ttop], codes_b [B, Tbot]) in raster order, (soft_t, soft_b)).
        The soft codes are None unless `temp_soft_labels` is given; then
        they are [B, T, K], each level's softmax(-d / temp_soft_labels) over
        its codebook, and the codes are the nearest (the JAX package's
        extract_codes) or, given a `generator`, drawn from them."""
        self._two_levels('extract_codes')
        self.load_weights(weights)
        B = images.shape[0]
        images = images.to(self.device)
        if temp_soft_labels is None:
            code_t, code_b = self.stage1.get_codes(images)
            return (code_t.reshape(B, -1), code_b.reshape(B, -1)), \
                (None, None)
        codes, softs = self.stage1.get_soft_codes(
            images, temp_soft_labels, generator is not None, generator)
        return (tuple(c.reshape(B, -1) for c in codes),
                tuple(s.reshape(B, -1, s.shape[-1]) for s in softs))

    @torch.inference_mode()
    def forward(self, weights: Weights, images: torch.Tensor,
                labels: torch.Tensor):
        """Teacher-forced forward: the stage-2 logits on the images' codes.
        Returns ((logits_top [B, Ttop, V], logits_bot [B, Tbot, V][,
        logits_txt]), (codes_t, codes_b), (None, None))."""
        codes, softs = self.extract_codes(weights, images)
        logits = self.stage2(*codes, labels.to(self.device))
        return logits, codes, softs

    # ----------------------------------------------------- int8 calibration
    @torch.inference_mode()
    def calibrate_kv_scales(self, weights: Weights,
                            generator: torch.Generator, labels: torch.Tensor,
                            params: Union[SamplingParams,
                                          Sequence[LevelSampling], None]
                            = None,
                            max_seq_len: Optional[int] = None) -> Scales:
        """Per-channel scales of the int8 KV cache: one float sampling run
        on `labels` in the model's own depth mode (`params`: the family's
        sampling knobs, by default the JAX function's, no top-k at
        temperature 1), whose final caches `_kv_scales` reduces as JAX
        does. The flat baselines raise, as in JAX. Under a layout every
        rank returns the whole batch's scales in the tp-1 layout (a
        collective: `_kv_scales`).
        Returns {'stage2/kv_scales': {'blocks.<l>.attn.k' | '.v': [D]}}."""
        if not isinstance(self.stage2, MultiLevelHQTransformer):
            self._two_levels('calibrate_kv_scales')
        self.load_weights(weights)
        n_top = max_seq_len or self.top_res * self.top_res
        if self.code_levels == 2:
            sampler = make_hierarchical_sampler(
                self.stage2, n_top, params or SamplingParams(),
                return_caches=True)
        else:
            sampler = make_multilevel_sampler(
                self.stage2, n_top, params or (LevelSampling(),) * 3,
                return_caches=True)
        _, caches = sampler(generator, labels.to(self.device))
        return _kv_scales(caches, self.layout)

    @torch.inference_mode()
    def calibrate_stage2_int8(self, weights: Weights, *forward_args) -> Scales:
        """Static activation scales of the A8W8 gemms: the absmax of every
        quantizable Linear's input over the teacher-forced stage-2 forward,
        as max(m, 1e-8) / 127. `forward_args` are the forward's: (codes_t
        [B, Ttop], codes_b [B, Tbot] raster, labels) for 2 levels, ([top,
        mid, bottom] raster maps [B, T_l], labels) for 3. The 3-level
        logits are [B, 21 Ttop, V]: the JAX package calibrates on 32
        samples (64 for 2 levels). The 2-level forward runs the model's
        own depth mode. A text model's forward also runs
        `head_txt`, which is not quantizable, so no scale is recorded for
        it. Under tensor parallelism every rank runs the whole batch and
        the absmaxes are maxed over the tp group (one collective), so the
        sharded inputs' (`proj`, `mlp.2`) are the whole inputs' and every
        rank returns tp 1's layout. Returns {'stage2/act_scales': {name:
        scale}}."""
        self.load_weights(weights)
        args = _on_device(forward_args, self.device)
        with recording_absmax(self.stage2, QuantizableLinear) as found:
            self.stage2(*args)
        tp = None if self.layout is None else self.layout.tp_group
        if tp is not None and found:
            names = sorted(found)
            found = dict(zip(names, tp.max(torch.stack(
                [found[n] for n in names]))))
        return {'stage2/act_scales': {n: scale_from_absmax(m)
                                      for n, m in found.items()}}

    @torch.inference_mode()
    def calibrate_int8_decode(self, weights: Weights, *decode_args,
                              chunk: int = 128) -> Scales:
        """Static activation scales of the A8W8 decoder convolutions:
        `decode_code(*decode_args)` in `chunk`-sample slices, each conv's
        input absmax merged by max over the slices, as max(m, 1e-8) / 127.
        `decode_args` are the stage-1 decode's: code maps code_t
        [B, Ht, Wt], code_b [B, Hb, Wb] for 2 levels (code_b None for the
        IGPT's top-only decode), the list of the levels' maps, top first,
        for N. Returns {'stage1/act_scales': {name: scale}}."""
        self.load_weights(weights)
        first = decode_args[0]
        batch = (first[0] if isinstance(first, (list, tuple))
                 else first).shape[0]
        with recording_absmax(self.stage1, QuantizableConv2d) as found:
            for i in range(0, batch, chunk):
                self.stage1.decode_code(*_on_device(
                    decode_args, self.device, slice(i, i + chunk)))
        return {'stage1/act_scales': {n: scale_from_absmax(m)
                                      for n, m in found.items()}}

    # ------------------------------------------------------------- sampling
    def _pixel_decoder(self, n_top: int, decode_chunk: int,
                       int8: Int8Serving, scales: Optional[Scales]
                       ) -> Callable:
        """fn(*codes) -> pixels [B, H, W, 3] in [0, 1] of a sampler's codes
        (codes_t [B, N], codes_b [B, N, ratio] for 2 levels; tops [B, N],
        mids [B, N, 4], bots [B, N, 16] for 3), the stage-1 decode of their
        raster maps in `decode_chunk`-sample chunks, with A8W8
        convolutions under `int8.decode_convs`."""
        top_res = int(math.isqrt(n_top))
        wins = (self.cell_win,) if self.code_levels == 2 else (2, 4)
        act = (scales or {}).get('stage1/act_scales', {})

        def dec1(*maps):
            pixels = (self.stage1.decode_code(*maps) if self.code_levels == 2
                      else self.stage1.decode_code(list(maps)))
            return torch.clamp(pixels * 0.5 + 0.5, 0.0, 1.0)

        @tracing.span('decode')
        def decode(top, *groups):
            maps = [top.reshape(-1, top_res, top_res)] + [
                cells_to_raster(g, top_res, w).reshape(-1, top_res * w,
                                                       top_res * w)
                for g, w in zip(groups, wins)]
            with (self.stage1.int8_decode(act) if int8.decode_convs
                  else contextlib.nullcontext()):
                return _decode_chunked(dec1, maps, decode_chunk)

        return decode

    def make_pixel_sampler(self, max_seq_len: Optional[int] = None,
                           params: SamplingParams = SamplingParams(),
                           decode_chunk: int = 128,
                           int8: Int8Serving = Int8Serving(),
                           scales: Optional[Scales] = None) -> Callable:
        """End-to-end sampler: fn(weights, generator, labels) ->
        (pixels [B, H, W, 3] in [0, 1], (codes_t [B, N], codes_b
        [B, N, ratio])). `generator` lives on the model's device. The
        stage-1 decode runs in `decode_chunk`-sample chunks. `int8` and
        `scales` choose int8 serving (see the module docstring)."""
        self._two_levels('make_pixel_sampler')
        n_top = max_seq_len or self.top_res * self.top_res
        sampler = make_hierarchical_sampler(self.stage2, n_top, params, int8,
                                            scales)
        decode = self._pixel_decoder(n_top, decode_chunk, int8, scales)

        @torch.inference_mode()
        @tracing.span('sample')
        def sample_pixels(weights: Weights, generator: torch.Generator,
                          labels: torch.Tensor):
            self.load_weights(weights)
            codes = sampler(generator, labels)
            return decode(*codes), codes

        return sample_pixels

    def make_pipelined_sampler(self, max_seq_len: Optional[int] = None,
                               params: SamplingParams = SamplingParams(),
                               decode_chunk: int = 128,
                               int8: Int8Serving = Int8Serving(),
                               scales: Optional[Scales] = None) -> Callable:
        """Software-pipelined sampler for steady-state throughput:
        fn(weights, generator, labels, prev_codes=None) -> (codes,
        pixels), codes = (codes_t, codes_b) of this call's AR loop and
        pixels the decode of `prev_codes` (the previous call's codes), or
        of this call's codes when prev_codes is None (the pipeline's fill).

        On a card the decode of prev_codes is queued first on a second
        CUDA stream, which waits for the current stream (where prev_codes
        and the weights were made); then the AR loop runs on the current
        stream, which waits for the decode before returning its pixels.
        Tensors that cross streams are recorded on the stream that uses
        them. On the CPU the two parts run one after the other."""
        self._two_levels('make_pipelined_sampler')
        n_top = max_seq_len or self.top_res * self.top_res
        sampler = make_hierarchical_sampler(self.stage2, n_top, params, int8,
                                            scales)
        decode = self._pixel_decoder(n_top, decode_chunk, int8, scales)
        streams = []

        @torch.inference_mode()
        @tracing.span('sample')
        def step(weights: Weights, generator: torch.Generator,
                 labels: torch.Tensor, prev_codes: Optional[Codes] = None):
            self.load_weights(weights)
            if prev_codes is None:
                codes = sampler(generator, labels)
                return codes, decode(*codes)
            if self.device.type != 'cuda':
                pixels = decode(*prev_codes)
                return sampler(generator, labels), pixels
            main = torch.cuda.current_stream(self.device)
            if not streams:
                streams.append(torch.cuda.Stream(self.device))
            side = streams[0]
            side.wait_stream(main)
            with torch.cuda.stream(side):
                pixels = decode(*prev_codes)
            for t in prev_codes:
                t.record_stream(side)
            codes = sampler(generator, labels)
            main.wait_stream(side)
            pixels.record_stream(main)
            return codes, pixels

        return step

    def make_pixel_sampler_multilevel(
            self, max_seq_len: Optional[int] = None,
            top_k: Sequence[Optional[int]] = (None, None, None),
            temperature: Sequence[float] = (1.0, 1.0, 1.0),
            bisect3: bool = False, decode_chunk: int = 128,
            int8: Int8Serving = Int8Serving(),
            scales: Optional[Scales] = None,
            top_p: Sequence[Optional[float]] = (None, None, None)
            ) -> Callable:
        """End-to-end sampler of the 3-level family: fn(weights, generator,
        labels) -> (pixels [B, H, W, 3] in [0, 1], (tops [B, N], mids
        [B, N, 4], bots [B, N, 16])), with per-level (top, mid, bottom)
        `top_k`, `top_p` and `temperature`, and `bisect3` for every draw
        (see `engine.LevelSampling`). The codes go to the stage-1 decode as
        raster maps, in `decode_chunk`-sample chunks. `int8` and `scales`
        choose int8 serving (see the module docstring)."""
        if self.code_levels != 3:
            raise ValueError('make_pixel_sampler_multilevel needs a 3-level '
                             'model; use make_pixel_sampler')
        n_top = max_seq_len or self.top_res * self.top_res
        sampler = make_multilevel_sampler(
            self.stage2, n_top, tuple(
                LevelSampling(top_k=k, top_p=p, temperature=t,
                              bisect3=bisect3)
                for k, p, t in zip(top_k, top_p, temperature)), int8, scales)
        decode = self._pixel_decoder(n_top, decode_chunk, int8, scales)

        @torch.inference_mode()
        @tracing.span('sample')
        def sample_pixels(weights: Weights, generator: torch.Generator,
                          labels: torch.Tensor):
            self.load_weights(weights)
            codes = sampler(generator, labels)
            return decode(*codes), codes

        return sample_pixels

    def make_pixel_sampler_igpt(self, max_seq_len: Optional[int] = None,
                                top_k: Optional[int] = 256,
                                top_p: Optional[float] = None,
                                temperature: float = 1.0,
                                decode_chunk: int = 128,
                                int8: Int8Serving = Int8Serving(),
                                scales: Optional[Scales] = None) -> Callable:
        """End-to-end sampler of the flat iGPT baseline (stage-2 type
        'top'): fn(weights, generator, labels) -> (pixels [B, H, W, 3] in
        [0, 1], codes [B, N]), the top codes decoded alone (the bottom
        level zeros), in `decode_chunk`-sample chunks. `int8` may ask for
        the int8 KV cache (scales from `_flat_kv_scales`) and the A8W8
        decode convolutions (`calibrate_int8_decode` on the top maps, the
        bottom None), as JAX decodes inside `int8_decode_scope`; its gemm
        switches raise (`engine.make_igpt_sampler`)."""
        if not isinstance(self.stage2, IGPT):
            raise NotImplementedError(
                f'make_pixel_sampler_igpt takes the IGPT baseline, not '
                f'{type(self.stage2).__name__}')
        n_top = max_seq_len or self.top_res * self.top_res
        res = int(math.isqrt(n_top))
        sampler = make_igpt_sampler(self.stage2, n_top, top_k=top_k,
                                    top_p=top_p, temperature=temperature,
                                    int8=int8, scales=scales)
        act = (scales or {}).get('stage1/act_scales', {})

        def dec1(codes):
            pixels = self.stage1.decode_code(codes.reshape(-1, res, res),
                                             None)
            return torch.clamp(pixels * 0.5 + 0.5, 0.0, 1.0)

        @torch.inference_mode()
        @tracing.span('sample')
        def sample_pixels(weights: Weights, generator: torch.Generator,
                          labels: torch.Tensor):
            self.load_weights(weights)
            codes = sampler(generator, labels)
            with tracing.span('decode'), (
                    self.stage1.int8_decode(act) if int8.decode_convs
                    else contextlib.nullcontext()):
                pixels = _decode_chunked(dec1, [codes], decode_chunk)
            return pixels, codes

        return sample_pixels
