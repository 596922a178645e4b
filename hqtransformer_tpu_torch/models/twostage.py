"""Two-stage model: the stage-1 HQ-VAE plus the stage-2 HQ-Transformer.

Counterpart of `hqtransformer_tpu/models/twostage.py` for the ported paths:
- `TwoStageModel(cfg).make_pixel_sampler(...)(weights, generator, labels)`
  gives pixels [B, 256, 256, 3] in [0, 1] at the flagship config;
- `extract_codes(weights, images)` encodes images [B, 256, 256, 3] in
  [-1, 1] to raster codes, and `forward(weights, images, labels)` runs the
  teacher-forced stage-2 forward on them, giving its logits.

Weights are state dicts in the PyTorch reference's key layout,
{'stage1': {...}, 'stage2': {...}}: from `TwoStageModel.init_weights` (a
seeded random init; the repo holds no trained weights) or converted from
JAX variables by `convert.py`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..config import TwoStageConfig, parse_model_type
from ..device import resolve_device
from ..sampling.engine import SamplingParams, make_hierarchical_sampler
from .stage1.generator import build_generator
from .stage1.quantizer import EMAVectorQuantizer
from .stage2.hierarchical import HierarchicalGPT, cells_to_raster

Weights = Dict[str, Dict[str, torch.Tensor]]


def build_stage2(config: TwoStageConfig,
                 dtype: torch.dtype = torch.float32) -> HierarchicalGPT:
    """Stage-2 model for `stage2.type`; the slice ports the hq-transformer
    family."""
    s2 = config.stage2
    spec = parse_model_type(s2.type)
    if spec.family != 'hq-transformer':
        raise NotImplementedError(f'stage-2 type {s2.type!r} is not ported')
    return HierarchicalGPT(vocab_size_top=s2.vocab_size_img,
                           vocab_size_bot=s2.vocab_size_img,
                           ratio_bot2top=s2.ratio_bot2top,
                           use_cls_cond=bool(s2.use_cls_cond),
                           model_type=spec, hparams=s2.hparams,
                           hparams_dec=s2.hparams_dec, dtype=dtype)


def serving_bf16_params(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The bf16 serving convention: f32 tensors with ndim >= 2 are stored
    as bf16; 1-D biases, norm scales and codebook counts stay as they are."""
    return {k: v.to(torch.bfloat16)
            if v.dtype == torch.float32 and v.dim() >= 2 else v
            for k, v in state.items()}


def _decode_chunked(dec1: Callable, arrays: Sequence[torch.Tensor],
                    chunk: int) -> torch.Tensor:
    """Run `dec1(*slices)` over `chunk`-sample slices of the leading axis
    and concatenate: the conv decoder's 256^2 activations at large batch
    would not fit in device memory at once."""
    B = arrays[0].shape[0]
    return torch.cat([dec1(*(a[i:i + chunk] for a in arrays))
                      for i in range(0, B, chunk)])


def random_state(module: nn.Module, generator: torch.Generator
                 ) -> Dict[str, torch.Tensor]:
    """Seeded random weights for every entry of module's state dict, f32 on
    the generator's device: lecun-normal projections and convolutions, zero
    biases, unit norm scales, N(0, 0.02) embeddings and N(0, 1) codebooks."""
    dev = generator.device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    state = {}
    for prefix, m in module.named_modules():
        p = f'{prefix}.' if prefix else ''
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            state[p + 'weight'] = normal(m.weight.shape,
                                         m.weight[0].numel() ** -0.5)
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
    for name, t in module.state_dict().items():
        if name not in state:   # embeddings and sos_depth
            state[name] = normal(t.shape, 0.02)
    return state


class TwoStageModel:
    """The stage-1 generator and the stage-2 AR model on one device.

    `device` defaults to 'cuda' and raises when no card is present; pass
    device='cpu' to run on the CPU, where every kernel takes its plain
    version. `dtype` is the activation dtype. The modules hold no weights
    until `load_weights` (which every sampler call does) gives them some."""

    def __init__(self, config: TwoStageConfig,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[str] = None):
        self.config = config
        self.device = resolve_device(device)
        with torch.device('meta'):
            stage1 = build_generator(config.stage1, dtype)
            stage2 = build_stage2(config, dtype)
        self.stage1 = stage1.to_empty(device=self.device).eval()
        self.stage2 = stage2.to_empty(device=self.device).eval()
        # top code grid: the stage-1 latent over the bottom-group window
        self.cell_win = int(math.isqrt(config.stage2.ratio_bot2top or 4))
        self.top_res = config.stage1.hparams.attn_resolutions[0] // \
            self.cell_win

    def init_weights(self, seed: int) -> Weights:
        """Seeded random f32 weights on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return {'stage1': random_state(self.stage1, gen),
                'stage2': random_state(self.stage2, gen)}

    def load_weights(self, weights: Weights) -> None:
        """Make `weights` the modules' tensors (strict key match, no copy
        for tensors already on the model's device)."""
        for name, module in (('stage1', self.stage1),
                             ('stage2', self.stage2)):
            state = {k: v.to(self.device) for k, v in weights[name].items()}
            module.load_state_dict(state, strict=True, assign=True)

    @torch.inference_mode()
    def extract_codes(self, weights: Weights, images: torch.Tensor):
        """Stage-1 codes of images [B, H, W, 3] in [-1, 1]: ((codes_t
        [B, Ttop], codes_b [B, Tbot]) in raster order, (None, None)); the
        second pair stands for the soft codes, which are not ported."""
        self.load_weights(weights)
        B = images.shape[0]
        code_t, code_b = self.stage1.get_codes(images.to(self.device))
        return (code_t.reshape(B, -1), code_b.reshape(B, -1)), (None, None)

    @torch.inference_mode()
    def forward(self, weights: Weights, images: torch.Tensor,
                labels: torch.Tensor):
        """Teacher-forced forward: the stage-2 logits on the images' codes.
        Returns ((logits_top [B, Ttop, V], logits_bot [B, Tbot, V]),
        (codes_t, codes_b), (None, None))."""
        codes, softs = self.extract_codes(weights, images)
        logits = self.stage2(*codes, labels.to(self.device))
        return logits, codes, softs

    def make_pixel_sampler(self, max_seq_len: Optional[int] = None,
                           params: SamplingParams = SamplingParams(),
                           decode_chunk: int = 128) -> Callable:
        """End-to-end sampler: fn(weights, generator, labels [B]) ->
        (pixels [B, H, W, 3] in [0, 1], (codes_t [B, N], codes_b
        [B, N, ratio])). `generator` lives on the model's device. The
        stage-1 decode runs in `decode_chunk`-sample chunks."""
        n_top = max_seq_len or self.top_res * self.top_res
        sampler = make_hierarchical_sampler(self.stage2, n_top, params)
        top_res = int(math.isqrt(n_top))
        bot_res = top_res * self.cell_win

        def decode(ct, cb):
            pixels = self.stage1.decode_code(ct, cb)
            return torch.clamp(pixels * 0.5 + 0.5, 0.0, 1.0)

        @torch.inference_mode()
        def sample_pixels(weights: Weights, generator: torch.Generator,
                          labels: torch.Tensor):
            self.load_weights(weights)
            codes_t, codes_b = sampler(generator, labels)
            ct = codes_t.reshape(-1, top_res, top_res)
            cb = cells_to_raster(codes_b, top_res, self.cell_win).reshape(
                -1, bot_res, bot_res)
            pixels = _decode_chunked(decode, [ct, cb], decode_chunk)
            return pixels, (codes_t, codes_b)

        return sample_pixels
